// Greedy NMS for Hopper: the keep mask of boxes already sorted by descending
// score, lane by lane (the leading dimensions of rlod::nms_sorted_mask
// flattened), bit for bit the mask of the op's plain body
// (ops/nms.py::_nms_sorted_mask).
//
// Replaces no TPU kernel: the JAX package's NMS is XLA (it retired both of
// its Pallas variants). On the card the plain body is Jacobi sweeps of small
// ATen kernels with a blocking host read after every sweep and tile; this is
// the reference's nms_cuda scheme (faster-rcnn.pytorch,
// lib/model/nms/src/nms_cuda.c) with the greedy walk on the card too, so a
// call is one or two launches and no host read.
//
// What bounds it on the H100: neither bytes nor operations but the walk in
// score order, sequential in each lane on one SM (a 64-box chunk's later
// words, up to ~100 KB, come from L2 a chunk ahead of their use), and the
// issue rate of the IoU tests. A train step's 2 x 72M upper-triangle
// pairs are ~2 GFLOP (~32 us on the f32 ALUs), their suppression words
// ~18 MB written once (~5 us), the boxes 384 KB. The design:
//  - suppression words: bit j of word w of row i is set iff box 64w + j
//    comes after box i and box i would suppress it (IoU above the
//    threshold). Validity is applied in the walk, not in the words. A thread
//    computes a word's 64 tests unrolled, from column boxes broadcast out of
//    shared memory, and masks the bits outside the triangle after;
//  - the walk takes 64-box chunks in score order. Warp 0 holds a chunk's
//    diagonal words (rows lane and lane + 32) in registers and resolves it
//    by Jacobi steps (keep = candidates not suppressed by a kept box, each
//    step two warp OR-reductions) to the greedy result, which a DAG in score
//    order reaches in its longest suppression chain, a few steps;
//  - N <= SMALL_MAX (per-class NMS, 300 boxes a class; a small RPN): one
//    CTA a lane builds its words in shared memory (at most 512 x 8 words,
//    32 KB) and walks them in the same launch, so thousands of tiny lanes
//    take one launch and no global scratch;
//  - N > SMALL_MAX (the RPN's 6000 and 12000): nms_mask, one 64-thread CTA
//    for each upper-triangle pair of 64-box blocks of each lane, writes the
//    words to global memory word-major, [L, ceil(N / 64), N], so that word w
//    of 64 consecutive rows is one coalesced 512-byte access, for its writes
//    and for the walk's reads; nms_walk, one CTA a lane. Its warp 0 resolves
//    chunk c and ORs the kept rows' word c + 1 (loaded with the chunk, ahead)
//    into the "removed" words in shared memory, while each other warp takes
//    words c + 1 on in turn and ORs chunk c - 1's kept rows into each (the
//    kept ones selected by bit from the 64 rows' word, which it read during
//    the chunk before, then a warp OR-reduction): one barrier a chunk, and
//    the next chunk's words and valid marks are in flight meanwhile. The
//    kept bits stay in shared memory; the keep mask is written once, at
//    the end;
//  - with max_keep a lane stops at its max_keep-th survivor: it and every
//    earlier position equal the body's, every later position is false (the
//    body stops only at a tile boundary once every lane is done, so it may
//    mark more there; nms_select reads only the first max_keep survivors).
//
// Exactness: suppression is IoU > thr with the +1 convention in the body's
// own f32 forms, inter > thr * union where the body takes one tile
// (_inter_union) and inter / union > thr where it tiles (bbox_overlaps),
// union = (area_i + area_j) - inter, thr the f32 PyTorch rounds the scalar
// to. Every step is an explicit round-to-nearest op, so no FMA contraction
// decides a tie at the threshold differently from the body, and min, max
// and the clamp at 0 pass a NaN on as torch.minimum / maximum / clamp_min do
// (PTX min.NaN / max.NaN).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int SMALL_MAX = 512;
constexpr int SMALL_WORDS = SMALL_MAX / 64;
constexpr int SMALL_THREADS = 512;
constexpr int WALK_THREADS = 1024;
constexpr int PRELOAD = 7;                // words a walk worker warp reads a chunk ahead
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float tmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float tmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.f), __fadd_rn(__fsub_rn(b.w, b.y), 1.f));
}

__device__ __forceinline__ float4 load_box(const float* p) {
  return make_float4(p[0], p[1], p[2], p[3]);
}

// IoU(a, b) > thr in the body's form: MUL inter > thr * union, else
// inter / union > thr. Symmetric in a and b, to the bit.
template <bool MUL>
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b, float area_b,
                                           float thr) {
  const float iw = tmax(__fadd_rn(__fsub_rn(tmin(a.z, b.z), tmax(a.x, b.x)), 1.f), 0.f);
  const float ih = tmax(__fadd_rn(__fsub_rn(tmin(a.w, b.w), tmax(a.y, b.y)), 1.f), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  if (MUL) return inter > __fmul_rn(thr, uni);
  // With thr >= 0 a pair that does not intersect (inter 0, or NaN) never
  // passes the divided test (0 / union is 0, -0 or NaN), so it skips the
  // division. The product form has no such shortcut: a degenerate box's
  // union may be negative.
  if (thr >= 0.f && !(inter > 0.f)) return false;
  return __fdiv_rn(inter, uni) > thr;
}

// Bits after bit k.
__device__ __forceinline__ u64 above(int k) { return k >= 63 ? 0ull : ~0ull << (k + 1); }

// Word w of box a (index i): the boxes of block w (in shared memory) after
// box i that a suppresses; n boxes in all.
template <bool MUL>
__device__ __forceinline__ u64 row_word(float4 a, float area_a, int i, const float4* cols,
                                        const float* areas, int w, int n, float thr) {
  u64 bits = 0;
#pragma unroll
  for (int k = 0; k < 64; ++k)
    bits |= (u64)suppresses<MUL>(a, area_a, cols[k], areas[k], thr) << k;
  const int j0 = w * 64;
  if (n - j0 < 64) bits &= (1ull << (n - j0)) - 1;
  if (i >= j0) bits &= above(i - j0);
  return bits;
}

__device__ __forceinline__ u64 warp_or(u64 v) {
  return __reduce_or_sync(FULL, (unsigned)v)
         | (u64)__reduce_or_sync(FULL, (unsigned)(v >> 32)) << 32;
}

// *p |= v on a shared word, as two 32-bit atomics (native in shared memory)
__device__ __forceinline__ void or_shared(u64* p, u64 v) {
  unsigned* half = reinterpret_cast<unsigned*>(p);
  atomicOr(half, (unsigned)v);
  atomicOr(half + 1, (unsigned)(v >> 32));
}

__device__ __forceinline__ u64 ballot64(bool lo, bool hi) {
  return __ballot_sync(FULL, lo) | (u64)__ballot_sync(FULL, hi) << 32;
}

// The greedy keep bits of a 64-box chunk (warp-wide): `avail` the valid boxes
// no earlier chunk removed, d0 / d1 the diagonal words of rows lane and
// lane + 32. Jacobi steps from avail: box i's bit is final once every box
// before it is, so the steps end at the fixpoint, the greedy result.
__device__ __forceinline__ u64 resolve(u64 avail, u64 d0, u64 d1, int lane) {
  u64 kept = avail;
  while (true) {
    const u64 sup = warp_or(((kept >> lane) & 1 ? d0 : 0)
                            | ((kept >> (lane + 32)) & 1 ? d1 : 0));
    const u64 next = avail & ~sup;
    if (next == kept) return kept;
    kept = next;
  }
}

// The max_keep stop, warp-wide: `count` boxes kept before chunk c, `kept`
// its bits. Past the stop keeps the first max_keep - count of them and
// returns true, stop_at one past the last.
__device__ __forceinline__ bool stop_here(u64& kept, int& count, int max_keep, int c, int lane,
                                          int& stop_at) {
  const int total = count + __popcll(kept);
  if (max_keep < 0 || total < max_keep) {
    count = total;
    return false;
  }
  const int need = max_keep - count;
  const u64 below0 = (1ull << lane) - 1, below1 = (1ull << (lane + 32)) - 1;
  kept = ballot64((kept >> lane) & 1 && __popcll(kept & below0) < need,
                  (kept >> (lane + 32)) & 1 && __popcll(kept & below1) < need);
  count = max_keep;
  stop_at = c * 64 + 64 - __clzll(kept);
  return true;
}

// One lane's boxes, N <= SMALL_MAX: the words in shared memory, then warp 0
// walks the chunks. Lane w of the warp holds the removed word w.
template <bool MUL>
__global__ void __launch_bounds__(SMALL_THREADS)
nms_small(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
          uint8_t* __restrict__ keep, int* __restrict__ walked, int n, float thr,
          int max_keep) {
  __shared__ float4 sb[SMALL_MAX];
  __shared__ float sa[SMALL_MAX];
  __shared__ u64 sw[SMALL_MAX * SMALL_WORDS];
  const size_t lane_id = blockIdx.x;
  boxes += lane_id * n * 4;
  valid += lane_id * n;
  keep += lane_id * n;
  const int nw = (n + 63) / 64;
  for (int i = threadIdx.x; i < nw * 64; i += blockDim.x) {
    const float4 b = i < n ? load_box(boxes + 4 * i) : make_float4(0.f, 0.f, 0.f, 0.f);
    sb[i] = b;
    sa[i] = area_of(b);
  }
  __syncthreads();
  // word w of row i for i < 64 (w + 1) (the lower words are never read);
  // a warp's rows share w, so the column boxes are broadcast reads
  for (int it = threadIdx.x; it < n * nw; it += blockDim.x) {
    const int w = it / n, i = it - w * n;
    if (i < 64 * (w + 1))
      sw[i * nw + w] = row_word<MUL>(sb[i], sa[i], i, sb + 64 * w, sa + 64 * w, w, n, thr);
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  u64 rem = 0;
  int count = 0, stop_at = n, c = 0;
  for (; c < nw; ++c) {
    const int i0 = c * 64 + lane, i1 = i0 + 32;
    const u64 vbits = ballot64(i0 < n && valid[i0], i1 < n && valid[i1]);
    const u64 d0 = i0 < n ? sw[i0 * nw + c] : 0, d1 = i1 < n ? sw[i1 * nw + c] : 0;
    u64 kept = resolve(vbits & ~__shfl_sync(FULL, rem, c), d0, d1, lane);
    const bool stop = stop_here(kept, count, max_keep, c, lane, stop_at);
    if (i0 < n) keep[i0] = (kept >> lane) & 1;
    if (i1 < n) keep[i1] = (kept >> (lane + 32)) & 1;
    if (stop) break;
    for (int w = c + 1; w < nw; ++w) {
      const u64 v = warp_or(((kept >> lane) & 1 ? sw[i0 * nw + w] : 0)
                            | ((kept >> (lane + 32)) & 1 ? sw[i1 * nw + w] : 0));
      if (lane == w) rem |= v;
    }
  }
  for (int i = (c + 1) * 64 + lane; i < n; i += 32) keep[i] = 0;
  if (walked != nullptr && lane == 0) walked[lane_id] = stop_at;
}

// First row block of the upper-triangle pair t of an nw x nw block grid,
// pairs numbered row by row: the largest r with r * nw - r (r - 1) / 2 <= t.
__device__ __forceinline__ int tri_row(long long t, int nw) {
  auto off = [nw](long long r) { return r * nw - r * (r - 1) / 2; };
  const double b = 2.0 * nw + 1.0;
  long long r = (long long)((b - sqrt(b * b - 8.0 * (double)t)) / 2.0);
  r = max(0ll, min(r, (long long)nw - 1));
  while (r > 0 && off(r) > t) --r;
  while (r + 1 < nw && off(r + 1) <= t) ++r;
  return (int)r;
}

// One upper-triangle pair (row block rb, column block cb >= rb) of lane
// blockIdx.y: thread r writes word cb of row 64 rb + r (word-major).
template <bool MUL>
__global__ void __launch_bounds__(64)
nms_mask(const float* __restrict__ boxes, u64* __restrict__ mask, int n, int nw, float thr) {
  __shared__ float4 cols[64];
  __shared__ float areas[64];
  const size_t lane_id = blockIdx.y;
  boxes += lane_id * n * 4;
  mask += lane_id * n * nw;
  const long long t = blockIdx.x;
  const int rb = tri_row(t, nw);
  const int cb = rb + (int)(t - ((long long)rb * nw - (long long)rb * (rb - 1) / 2));
  const int j = cb * 64 + threadIdx.x;
  const float4 b = j < n ? load_box(boxes + 4 * (size_t)j) : make_float4(0.f, 0.f, 0.f, 0.f);
  cols[threadIdx.x] = b;
  areas[threadIdx.x] = area_of(b);
  __syncthreads();
  const int i = rb * 64 + threadIdx.x;
  if (i >= n) return;
  const float4 a = load_box(boxes + 4 * (size_t)i);
  mask[(size_t)cb * n + i] = row_word<MUL>(a, area_of(a), i, cols, areas, cb, n, thr);
}

// The walk of lane blockIdx.x over nms_mask's words.
__global__ void __launch_bounds__(WALK_THREADS, 1)
nms_walk(const u64* __restrict__ mask, const uint8_t* __restrict__ valid,
         uint8_t* __restrict__ keep, int* __restrict__ walked, int n, int nw, int max_keep) {
  extern __shared__ u64 removed[];       // nw words, then each chunk's kept bits
  u64* kept_bits = removed + nw;
  __shared__ int s_stop;
  const size_t lane_id = blockIdx.x;
  mask += lane_id * n * nw;
  valid += lane_id * n;
  keep += lane_id * n;
  const int tid = threadIdx.x, lane = tid & 31;
  for (int w = tid; w < 2 * nw; w += blockDim.x) removed[w] = 0;
  if (tid == 0) s_stop = 0;

  // warp 0's registers for the next chunk: rows chunk * 64 + lane and + 32,
  // their words chunk (d) and chunk + 1 (e) and valid marks, loaded a chunk
  // ahead (they depend on nothing). Predicated loads into zeroed registers,
  // nothing computed from them here: the warp waits for them only where the
  // next chunk reads them.
  u64 d0 = 0, d1 = 0, e0 = 0, e1 = 0;
  uint8_t v0 = 0, v1 = 0;
  auto fetch = [&](int chunk) {
    const int i0 = chunk * 64 + lane, i1 = i0 + 32;
    const u64* d = mask + (size_t)chunk * n;
    d0 = d1 = e0 = e1 = 0;
    v0 = v1 = 0;
    if (i0 < n) {
      d0 = d[i0];
      v0 = valid[i0];
      if (chunk + 1 < nw) e0 = d[n + i0];
    }
    if (i1 < n) {
      d1 = d[i1];
      v1 = valid[i1];
      if (chunk + 1 < nw) e1 = d[n + i1];
    }
  };
  if (tid < 32) fetch(0);
  __syncthreads();

  u64 p0[PRELOAD], p1[PRELOAD];          // a worker warp's preloaded words
#pragma unroll
  for (int m = 0; m < PRELOAD; ++m) p0[m] = p1[m] = 0;
  int count = 0, stop_at = n, c = 0;     // count and stop_at: warp 0's
  for (; c < nw; ++c) {
    if (tid < 32) {
      u64 kept = resolve(ballot64(v0 != 0, v1 != 0) & ~removed[c], d0, d1, lane);
      const bool stop = stop_here(kept, count, max_keep, c, lane, stop_at);
      if (lane == 0) {
        kept_bits[c] = kept;
        if (stop) s_stop = 1;
      }
      if (!stop && c + 1 < nw) {
        const u64 v = warp_or(((kept >> lane) & 1 ? e0 : 0)
                              | ((kept >> (lane + 32)) & 1 ? e1 : 0));
        if (lane == 0 && v) or_shared(&removed[c + 1], v);
        fetch(c + 1);
      }
    } else {
      // worker warp k ORs chunk c - 1's kept rows into words c + k,
      // c + k + 31, ... The first PRELOAD of them were read last chunk, all
      // 64 rows' word in one read before warp 0 knew which rows it keeps,
      // so only the selection by kept bit and the warp OR-reduction wait here
      const int k = tid / 32, warps = blockDim.x / 32 - 1;
      if (c > 0) {
        const u64 kept = kept_bits[c - 1];
        const bool k0 = (kept >> lane) & 1, k1 = (kept >> (lane + 32)) & 1;
#pragma unroll
        for (int m = 0; m < PRELOAD; ++m) {
          const int w = c + k + m * warps;
          const u64 sup = warp_or((k0 ? p0[m] : 0) | (k1 ? p1[m] : 0));
          if (lane == 0 && w < nw && sup) or_shared(&removed[w], sup);
        }
        if (kept) {                      // words past the preload, read now
          const u64* rows = mask + (size_t)(c - 1) * 64 + lane;
          for (int w = c + k + PRELOAD * warps; w < nw; w += warps) {
            u64 v = 0;
            if (k0) v = rows[(size_t)w * n];
            if (k1) v |= rows[(size_t)w * n + 32];
            const u64 sup = warp_or(v);
            if (lane == 0 && sup) or_shared(&removed[w], sup);
          }
        }
      }
      const int r0 = c * 64 + lane;      // chunk c's rows, for the next chunk
#pragma unroll
      for (int m = 0; m < PRELOAD; ++m) {
        const int w = c + 1 + k + m * warps;
        p0[m] = p1[m] = 0;
        if (w < nw) {
          if (r0 < n) p0[m] = mask[(size_t)w * n + r0];
          if (r0 + 32 < n) p1[m] = mask[(size_t)w * n + r0 + 32];
        }
      }
    }
    __syncthreads();
    if (s_stop) break;
  }
  for (int i = tid; i < n; i += blockDim.x) keep[i] = (kept_bits[i / 64] >> (i % 64)) & 1;
  if (walked != nullptr && tid == 0) walked[lane_id] = stop_at;
}

template <bool MUL>
cudaError_t launch(const float* boxes, const uint8_t* valid, uint8_t* keep, u64* mask,
                   int* walked, int lanes, int n, float thr, int max_keep, cudaStream_t s) {
  if (n <= SMALL_MAX) {
    nms_small<MUL><<<lanes, SMALL_THREADS, 0, s>>>(boxes, valid, keep, walked, n, thr, max_keep);
    return cudaGetLastError();
  }
  if (mask == nullptr || lanes > 65535) return cudaErrorInvalidValue;
  const int nw = (n + 63) / 64;
  const long long pairs = (long long)nw * (nw + 1) / 2;
  nms_mask<MUL><<<dim3((unsigned)pairs, lanes), 64, 0, s>>>(boxes, mask, n, nw, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = 2 * (size_t)nw * sizeof(u64);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_walk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  nms_walk<<<lanes, WALK_THREADS, smem, s>>>(mask, valid, keep, walked, n, nw, max_keep);
  return cudaGetLastError();
}

}  // namespace

// The 64-bit words of global scratch rlod_nms needs for `lanes` lanes of n
// boxes: 0 where one launch takes them (n <= SMALL_MAX, no scratch), else
// lanes * ceil(n / 64) * n; -1 where the kernels cannot take the lanes.
extern "C" long long rlod_nms_scratch_words(int lanes, int n) {
  if (n <= SMALL_MAX) return 0;
  if (lanes > 65535) return -1;
  return (long long)lanes * ((n + 63) / 64) * n;
}

// boxes [lanes, n, 4] f32, valid and keep [lanes, n] bool, mask
// rlod_nms_scratch_words(lanes, n) words (null where that is 0), walked
// [lanes] int32 or null; max_keep < 0 for none. Launches on `stream`; never
// synchronises.
extern "C" int rlod_nms(const void* boxes, const void* valid, void* keep, void* mask,
                        void* walked, int lanes, int n, float thr, int mul_form, int max_keep,
                        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = mul_form ? launch<true> : launch<false>;
  return f(static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
           static_cast<uint8_t*>(keep), static_cast<u64*>(mask), static_cast<int*>(walked),
           lanes, n, thr, max_keep, s);
}

// registers a thread, static shared memory bytes a CTA, spill bytes a thread
// of each kernel (small and mask in the product form, walk), as the runtime
// reports them
extern "C" int rlod_nms_info(int* out) {
  const void* fns[3] = {(const void*)nms_small<true>, (const void*)nms_mask<true>,
                        (const void*)nms_walk};
  for (int k = 0; k < 3; ++k) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, fns[k]);
    if (err != cudaSuccess) return err;
    out[3 * k] = a.numRegs;
    out[3 * k + 1] = (int)a.sharedSizeBytes;
    out[3 * k + 2] = (int)a.localSizeBytes;
  }
  return cudaSuccess;
}
