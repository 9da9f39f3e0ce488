// Fused ResNet residual stage for Hopper (layer2 / layer3): one launch
// computes one frozen caffe-flavour Bottleneck(W) on the already-strided
// grid, BN folded into the weights,
//   relu(conv3(relu(conv2(relu(conv1(x) + b1)) + b2)) + b3 + shortcut(x)),
// the shortcut being x itself or, for block0, the folded 1x1 downsample
// (its sum stays in f32 until the block's one rounding). A stage of n
// blocks is n launches that ping-pong two [B, Ho, Wo, 4W] buffers.
//
// Replaces the TPU kernel rlobjectdetection_tpu/ops/res_stage_pallas.py::
// fused_res_stage (_stage_kernel), which keeps the whole stage's activation
// resident in VMEM across the blocks. No SM's shared memory holds that
// (layer2's slab is 15.6 MB per image); on this card the counterpart is the
// 50 MB L2, which holds layer3's 7.8 MB ping-pong buffers at batch 1. The
// TPU kernel's [3w, 3w] dy/dx band packing and its rolls serve the MXU and
// VMEM and have no counterpart here.
//
// What bounds it on the H100: per image at 800x1216 an identity block is
// 8.47 GFLOP over a few MB, so the stage is bound by operations (layer3:
// 198 GFLOP, 0.2 ms at the bf16 tensor-core peak). Both paths own an 8x8
// output tile (conv1 over its 10x10 extent, a one-pixel halo recomputed by
// the neighbours; conv1 outputs outside the image stored as literal zeros,
// conv2's padding; conv2 as nine shifted GEMMs; conv3 + shortcut + ReLU to
// device memory).
//
// bf16 (bottleneck_wgmma), for Hopper's tensor cores:
//  - a cluster of two CTAs a tile. CTA r computes half of every conv's
//    output channels (conv1/conv2 channels r*W/2 .., conv3 r*2W ..) and so
//    reads only that half of the weights. It writes its half of T1 (conv1
//    over the extent) and of T2 (conv2 over the tile) into its own shared
//    memory, then copies it into its partner's (mapa + st.shared::cluster,
//    16 bytes a store); barrier.cluster orders those writes before the next
//    conv reads them. A cluster is one tile, so the grid (2 x tiles) always
//    divides by the cluster size and no CTA pads it;
//  - a CTA is one consumer warpgroup and one producer warp. The producer
//    streams the weights through a ring of S = 6 shared-memory stages of 64
//    output x 64 input channels (8 KB), each one bulk copy (cp.async.bulk,
//    completion counted on the stage's full mbarrier), as soon as every
//    consumer warp has freed the slot (empty mbarrier). The host packs each
//    CTA's weights as the byte image of its stages in stream order, in
//    wgmma's 128-byte-swizzled K-major layout (wgmma.cuh), so B is read
//    through a descriptor and no weight passes through registers;
//  - products on wgmma.mma_async, m64n128k16 (two adjacent stages) or
//    m64n64k16, A in registers: each warp holds 16 rows in mma.sync's
//    A-fragment layout, gathered from x in device memory (conv1 over the
//    extent's 100 rows as two 64-row M tiles in turn, which stream conv1's
//    weights twice; the downsample) or from the shifted windows of T1
//    (conv2) and from T2 (conv3), which no descriptor could address; f32
//    sums. One step's products stay in flight while the A fragments of the
//    step after next load (three register buffers) and the next stages
//    land;
//  - T2 reuses T1's space once both CTAs have read T1, which keeps a CTA at
//    103,072 bytes of shared memory (layer3; layer2 77,472) and two CTAs on
//    an SM: layer3's 70 tiles at batch 1 are 140 CTAs, more than the 132
//    SMs, in one wave of the 264 CTA slots.
// f32 (bottleneck_fma, held against the plain version at 1e-4), unchanged
// from the first port: a CTA of 8 warps a tile, each warp owning W/8
// (conv1, conv2) or 32 (a conv3 pass) output channels and all rows, k steps
// of 4 on the FMA pipes through mma.cuh's fragments, weights read from
// device memory.
#include "wgmma.cuh"

namespace {

constexpr int TH = 8, TW = 8;                 // output tile
constexpr int EH = TH + 2, EW = TW + 2;       // conv1 extent (3x3 halo)
constexpr int NE = EH * EW, NP = TH * TW;     // 100, 64

// ---- bf16: wgmma, weights streamed, a cluster of two CTAs a tile ----

constexpr int S = 6;                          // weight stages in the ring (even: see step)
constexpr int WG_THREADS = 128;               // the consumer warpgroup
constexpr int CTA_THREADS = WG_THREADS + 32;  // and the producer warp
constexpr int CLUSTER = 2;                    // CTAs a tile
constexpr int N3P = 2 * wg::NS;               // conv3 output channels a pass
static_assert(S % 2 == 0, "a step's two stages must sit in adjacent slots");

// Weight stages of one CTA's stream, in the order the kernel consumes them
// (ops/res_stage_kernel.py::pack_res_stage_stream writes them so):
//   conv1: for each 64-wide k slice of cin, the W/128 stages of its W/2 channels;
//   conv2: for each tap, each 64-wide k slice of W, the W/128 stages;
//   conv3: for each pass of 128 of its 2W channels, each k slice of W (then,
//          with the downsample, of cin), the two stages of the pass.
__host__ __device__ constexpr int stream_stages(int W, int cin, bool down) {
  return (cin / 64) * (W / 128) + 9 * (W / 64) * (W / 128) +
         (W / 64) * 2 * (W / 64 + (down ? cin / 64 : 0));
}

template <int W>
struct WgPlan {
  static constexpr int WH = W / 2;                 // conv1 / conv2 channels of a CTA
  static constexpr int NB = WH / wg::NS;           // stages side by side there (1, 2)
  static constexpr int C3 = 2 * W;                 // conv3 channels of a CTA
  static constexpr int LDT = W + 8;                // T1 / T2 row, bf16 (16 bytes padding)
  // byte offsets from the 1024-byte aligned base: the ring, T1 (T2 on top
  // of it), the full and empty mbarriers
  static constexpr int T1 = S * wg::STAGE_BYTES;
  static constexpr int BARS = T1 + NE * LDT * 2;
  static constexpr int BYTES = 1024 + BARS + 2 * S * 8;   // + slack to align the base
};

// The CTA's weight ring, in consumption order: conv1's stages twice (once
// for each 64-row M tile of the extent), then conv2's and conv3's. Stage c
// of that order sits in slot c % S and is stream stage c (c < S1) or
// c - S1, S1 the conv1 stages.
struct Ring {
  uint32_t slots, full, empty;   // shared addresses: slot 0, full[0], empty[0]
  const unsigned char* src;      // this CTA's stream of stages
  int s1;                        // conv1's stages in the stream

  // producer lane: copy consumption stages c0 .. c1-1, each once its slot
  // is free (every consumer warp has arrived on empty for stage c - S)
  __device__ __forceinline__ void produce(int c0, int c1) const {
    for (int c = c0; c < c1; ++c) {
      const int s = c % S;
      if (c >= S) wg::mbar_wait(empty + 8 * s, ((c / S) - 1) & 1);
      wg::mbar_expect_tx(full + 8 * s, wg::STAGE_BYTES);
      wg::bulk_load(slots + s * wg::STAGE_BYTES,
                    src + static_cast<size_t>(c < s1 ? c : c - s1) * wg::STAGE_BYTES,
                    wg::STAGE_BYTES, full + 8 * s);
    }
  }
};

// A consumer's cursor on the ring: `head` the next stage to wait for,
// `tail` the next to free.
struct Cursor {
  int head = 0, tail = 0;

  template <int N>
  __device__ __forceinline__ void acquire(const Ring& r, uint32_t (&slot)[N]) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int c = head + j;
      wg::mbar_wait(r.full + 8 * (c % S), (c / S) & 1);
      slot[j] = r.slots + (c % S) * wg::STAGE_BYTES;
    }
    head += N;
  }

  // once the products that read them have completed: every consumer warp
  // frees the oldest N stages
  template <int N>
  __device__ __forceinline__ void release(const Ring& r) {
#pragma unroll
    for (int j = 0; j < N; ++j) wg::mbar_arrive_warp(r.empty + 8 * ((tail + j) % S));
    tail += N;
  }
};

// One step of a GEMM: acc[j] += A (64 rows x 64 k: cur[kk] for the four k16
// steps) x the next N stages (stage j: 64 output channels x the same 64 k).
// Two stages of a step sit in adjacent slots (steps of two start at even
// consumption indices and S is even), one 128-row B tile for m64n128k16.
// The step's products stay in flight: once the previous step's have
// completed, its stages are freed and `load` fills its A registers (nxt)
// with step s + 2's fragments, two steps ahead of their use (x's rows come
// from L2).
template <int N, typename Load>
__device__ __forceinline__ void step(float (&acc)[N][32], FragBf16A (&cur)[4],
                                     FragBf16A (&nxt)[4], int s, int steps, Load& load,
                                     const Ring& ring, Cursor& cur_r) {
  uint32_t slot[N];
  cur_r.acquire(ring, slot);
  wg::fence();
  static_assert(N == 1 || N == 2, "a step is one or two stages");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (N == 2)
      wg::mma_m64n128k16(acc, cur[kk], wg::desc_sw128(slot[0] + kk * 32));
    else
      wg::mma_m64n64k16(acc[0], cur[kk], wg::desc_sw128(slot[0] + kk * 32));
  }
  wg::commit();
  if (s > 0) {
    wg::wait<1>();
    cur_r.release<N>(ring);
  }
  if (s + 2 < steps) load(s + 2, nxt);
}

// acc += the GEMM of `steps` steps; load(i, a) fills a with step i's A
// fragments (64-wide k slice i). Three A buffers rotate.
template <int N, typename Load>
__device__ __forceinline__ void gemm_stream(float (&acc)[N][32], int steps, Load load,
                                            const Ring& ring, Cursor& cur_r) {
  FragBf16A a0[4], a1[4], a2[4];
  load(0, a0);
  if (steps > 1) load(1, a1);
#pragma unroll 1
  for (int s = 0; s < steps; s += 3) {
    step(acc, a0, a2, s, steps, load, ring, cur_r);
    if (s + 1 < steps) step(acc, a1, a0, s + 1, steps, load, ring, cur_r);
    if (s + 2 < steps) step(acc, a2, a1, s + 2, steps, load, ring, cur_r);
  }
  wg::wait<0>();
  cur_r.release<N>(ring);
}

// the A fragments of a 64-wide k slice: rows r0 (fragment row g) and r1
// (g + 8), each at the slice's first k
__device__ __forceinline__ void load_slice(FragBf16A (&a)[4], const __nv_bfloat16* r0,
                                           const __nv_bfloat16* r1, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) load_a(a[kk], r0 + 16 * kk, r1 + 16 * kk, t);
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// the consumer warpgroup alone (named barrier 1; the producer warp is not in it)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(WG_THREADS) : "memory");
}

// This CTA's half of rows 0 .. rows-1 of T (channels rank*W/2 ..), written
// by the consumer threads, into the same place of the partner's T, 16 bytes
// a store.
template <int W>
__device__ __forceinline__ void copy_half_to_peer(const __nv_bfloat16* t, uint32_t t_peer,
                                                  int rows, uint32_t rank) {
  using P = WgPlan<W>;
  constexpr int CH = P::WH / 8;   // 16-byte chunks of a half row
  consumer_sync();
  for (int i = threadIdx.x; i < rows * CH; i += WG_THREADS) {
    const int off = ((i / CH) * P::LDT + rank * P::WH) * 2 + (i % CH) * 16;
    wg::st_cluster(t_peer + off,
                   *reinterpret_cast<const uint4*>(reinterpret_cast<const char*>(t) + off));
  }
}

template <int W, bool DOWN>
__global__ void __launch_bounds__(CTA_THREADS, 2) bottleneck_wgmma(
    const __nv_bfloat16* __restrict__ x,        // [B][H][Wd][cin]
    const unsigned char* __restrict__ stream,   // [2][stages][8192]: each CTA's weight stages
    const float* __restrict__ b1,               // [W]
    const float* __restrict__ b2,               // [W]
    const float* __restrict__ b3,               // [4W] (plus the downsample BN add for block0)
    __nv_bfloat16* __restrict__ out,            // [B][H][Wd][4W]
    int H, int Wd, int cin, int tiles_x, int tiles_img) {
  using P = WgPlan<W>;
  constexpr int NB = P::NB, LDT = P::LDT, C4 = 4 * W, KW = W / wg::KS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (wg::smem_addr(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* t1 = reinterpret_cast<__nv_bfloat16*>(base + P::T1);   // [NE][LDT]
  __nv_bfloat16* t2 = t1;   // [NP][LDT], once both CTAs have read T1

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t rank = wg::cluster_rank();
  const int tile = blockIdx.x / CLUSTER;
  const int b = tile / tiles_img, rt = tile % tiles_img;
  const int y0 = (rt / tiles_x) * TH, x0 = (rt % tiles_x) * TW;
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * H * Wd * cin;
  const uint32_t t1_peer = wg::map_to(wg::smem_addr(t1), rank ^ 1);

  const int total = stream_stages(W, cin, DOWN);
  Ring ring;
  ring.slots = wg::smem_addr(base);
  ring.full = ring.slots + P::BARS;
  ring.empty = ring.full + 8 * S;
  ring.src = stream + static_cast<size_t>(rank) * total * wg::STAGE_BYTES;
  ring.s1 = (cin / wg::KS) * NB;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      wg::mbar_init(ring.full + 8 * s, 1);
      wg::mbar_init(ring.empty + 8 * s, WG_THREADS / 32);
    }
    wg::mbar_init_fence();
  }
  wg::cluster_sync();   // barriers initialised; the partner's shared memory is live

  // The producer warp: at each cluster barrier the consumers have consumed
  // conv1's stages (c1), then conv2's (c2); it copies every stage it can
  // before each barrier without waiting on a stage consumed after it.
  const int c1 = 2 * ring.s1, c2 = c1 + 9 * KW * NB, end = total + ring.s1;
  if (warp == WG_THREADS / 32) {
    if (lane == 0) ring.produce(0, min(c1 + S, end));
    __syncwarp();
    wg::cluster_sync();   // T1
    if (lane == 0) ring.produce(min(c1 + S, end), min(c2 + S, end));
    __syncwarp();
    wg::cluster_sync();   // conv2 has read T1
    wg::cluster_sync();   // T2
    if (lane == 0) ring.produce(min(c2 + S, end), end);
    return;
  }
  Cursor cursor;

  // 1. conv1 + b1 + ReLU over the extent (rows y0-1 .. y0+TH, cols x0-1 ..
  // x0+TW) as two 64-row M tiles, one after the other; warp w holds rows
  // 16w + g (+8) of each. A row outside the image (or past the extent)
  // reads a clamped in-image pixel; its result is dropped: stored as a
  // literal zero
#pragma unroll 1
  for (int m = 0; m < 2; ++m) {
    const __nv_bfloat16* xr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = min(m * 64 + warp * 16 + g + 8 * h, NE - 1);
      const int gy = min(max(y0 - 1 + e / EW, 0), H - 1);
      const int gx = min(max(x0 - 1 + e % EW, 0), Wd - 1);
      xr[h] = xb + static_cast<size_t>(gy * Wd + gx) * cin;
    }
    float acc[NB][32] = {};
    auto load = [=](int i, FragBf16A (&a)[4]) {
      load_slice(a, xr[0] + i * wg::KS, xr[1] + i * wg::KS, t);
    };
    gemm_stream(acc, cin / wg::KS, load, ring, cursor);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = m * 64 + warp * 16 + g + 8 * h;
      if (e >= NE) continue;
      const int gy = y0 - 1 + e / EW, gx = x0 - 1 + e % EW;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < Wd;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int c = rank * P::WH + j * 64 + n * 8 + 2 * t;
          const float v0 = acc[j][4 * n + 2 * h], v1 = acc[j][4 * n + 2 * h + 1];
          store_bf16x2(t1 + e * LDT + c, inside ? fmaxf(v0 + b1[c], 0.f) : 0.f,
                       inside ? fmaxf(v1 + b1[c + 1], 0.f) : 0.f);
        }
    }
  }
  copy_half_to_peer<W>(t1, t1_peer, NE, rank);
  wg::cluster_sync();   // T1: both halves are in both CTAs

  // 2. conv2 (3x3) + b2 + ReLU over the tile: nine shifted GEMMs from T1,
  // step i = tap i / KW, k slice i % KW
  {
    float acc[NB][32] = {};
    auto load = [=](int i, FragBf16A (&a)[4]) {
      const int tap = i / KW, k0 = (i % KW) * wg::KS;
      const __nv_bfloat16* tr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = warp * 16 + g + 8 * h;
        tr[h] = t1 + ((p / TW + tap / 3) * EW + p % TW + tap % 3) * LDT + k0;
      }
      load_slice(a, tr[0], tr[1], t);
    };
    gemm_stream(acc, 9 * KW, load, ring, cursor);
    wg::cluster_sync();   // conv2 has read T1 in both CTAs: T2 may overwrite it
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = warp * 16 + g + 8 * h;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int c = rank * P::WH + j * 64 + n * 8 + 2 * t;
          store_bf16x2(t2 + p * LDT + c, fmaxf(acc[j][4 * n + 2 * h] + b2[c], 0.f),
                       fmaxf(acc[j][4 * n + 2 * h + 1] + b2[c + 1], 0.f));
        }
    }
    copy_half_to_peer<W>(t2, t1_peer, NP, rank);
  }
  wg::cluster_sync();   // T2: both halves are in both CTAs; no remote access after

  // 3. conv3 (+ downsample) + b3 + shortcut + ReLU → device memory, this
  // CTA's 2W channels in passes of N3P; step i < KW reads T2, the rest x
  {
    const __nv_bfloat16* tr[2];
    const __nv_bfloat16* xr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = warp * 16 + g + 8 * h;
      tr[h] = t2 + p * LDT;
      const int gy = min(y0 + p / TW, H - 1), gx = min(x0 + p % TW, Wd - 1);
      xr[h] = xb + static_cast<size_t>(gy * Wd + gx) * cin;
    }
    auto load = [=](int i, FragBf16A (&a)[4]) {
      if (!DOWN || i < KW)
        load_slice(a, tr[0] + i * wg::KS, tr[1] + i * wg::KS, t);
      else
        load_slice(a, xr[0] + (i - KW) * wg::KS, xr[1] + (i - KW) * wg::KS, t);
    };
    const int steps = KW + (DOWN ? cin / wg::KS : 0);
#pragma unroll 1
    for (int n0 = rank * P::C3; n0 < (rank + 1) * P::C3; n0 += N3P) {
      float acc[2][32] = {};
      gemm_stream(acc, steps, load, ring, cursor);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = warp * 16 + g + 8 * h;
        const int gy = y0 + p / TW, gx = x0 + p % TW;
        if (gy >= H || gx >= Wd) continue;
        __nv_bfloat16* o = out + ((static_cast<size_t>(b) * H + gy) * Wd + gx) * C4;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int c = n0 + j * 64 + n * 8 + 2 * t;
            float v0 = acc[j][4 * n + 2 * h] + b3[c];
            float v1 = acc[j][4 * n + 2 * h + 1] + b3[c + 1];
            if (!DOWN) {  // identity shortcut: cin == 4W
              const float2 s = load2(xr[h] + c);
              v0 += s.x;
              v1 += s.y;
            }
            store2(o + c, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          }
      }
    }
  }
}

// The launch of a cluster kernel: CLUSTER CTAs a tile, one warpgroup each.
inline void cluster_launch(int smem, int tiles, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(CLUSTER * tiles);
  cfg->blockDim = dim3(CTA_THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Sets the kernel's shared-memory attribute and asks how many of its
// clusters the card holds at once; refuses a kernel of which none fits.
template <typename K>
cudaError_t clusters_on_card(K kernel, int smem, int* clusters) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_launch(smem, 1, nullptr, &cfg, &attr);
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  return *clusters < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <int W, bool DOWN>
cudaError_t launch_wgmma(const void* x, const void* stream_w, const float* b1, const float* b2,
                         const float* b3, void* out, int B, int H, int Wd, int cin,
                         cudaStream_t stream) {
  auto kernel = bottleneck_wgmma<W, DOWN>;
  constexpr int smem = WgPlan<W>::BYTES;
  static int clusters = 0;   // asked at the first launch of the instantiation
  cudaError_t err;
  if (clusters == 0 && (err = clusters_on_card(kernel, smem, &clusters)) != cudaSuccess)
    return err;
  const int tiles_x = (Wd + TW - 1) / TW, tiles_img = tiles_x * ((H + TH - 1) / TH);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_launch(smem, B * tiles_img, stream, &cfg, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x),
                           static_cast<const unsigned char*>(stream_w), b1, b2, b3,
                           static_cast<__nv_bfloat16*>(out), H, Wd, cin, tiles_x, tiles_img);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- f32: the FMA kernel ----

constexpr int NTHREADS = 256, NWARPS = NTHREADS / 32;
constexpr int MT1 = (NE + 15) / 16;           // 16-row M tiles over the extent (7)
constexpr int MT = NP / 16;                   // 16-row M tiles over the tile (4)
constexpr int N3 = 256;                       // conv3 output channels per pass
constexpr int NT3 = N3 / (8 * NWARPS);        // 8-wide N tiles of a warp per pass (4)

// padded shared-memory row: 16-byte aligned, and its banks shift from row
// to row
template <int W>
constexpr int fma_smem_bytes() {
  return (NE + NP) * (W + 4) * 4;
}

template <int W, bool DOWN>
__global__ void __launch_bounds__(NTHREADS, 1) bottleneck_fma(
    const float* __restrict__ x,   // [B][H][Wd][cin]
    const float* __restrict__ w1,  // [W][cin]
    const float* __restrict__ b1,  // [W]
    const float* __restrict__ w2,  // [9][W][W]  (tap dy*3+dx, co, ci)
    const float* __restrict__ b2,  // [W]
    const float* __restrict__ w3,  // [4W][W]
    const float* __restrict__ b3,  // [4W] (plus the downsample BN add for block0)
    const float* __restrict__ wd,  // [4W][cin] (block0 only)
    float* __restrict__ out,       // [B][H][Wd][4W]
    int H, int Wd, int cin) {
  constexpr int LDT = W + 4;
  constexpr int NT = W / (8 * NWARPS);  // 8-wide N tiles of a warp in conv1, conv2
  constexpr int C4 = 4 * W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* t1 = reinterpret_cast<float*>(smem_raw);  // [NE][LDT] conv1 output over the extent
  float* t2 = t1 + NE * LDT;                       // [NP][LDT] conv2 output over the tile

  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* xb = x + static_cast<size_t>(b) * H * Wd * cin;

  // 1. conv1 + b1 + ReLU over the extent (rows y0-1 .. y0+TH, cols x0-1 ..
  // x0+TW). An A row outside the image (or past the extent) reads a clamped
  // in-image pixel; its result is dropped: stored as a literal zero
  {
    int ro[MT1][2];
#pragma unroll
    for (int m = 0; m < MT1; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = min(m * 16 + g + 8 * h, NE - 1);
        const int gy = min(max(y0 - 1 + e / EW, 0), H - 1);
        const int gx = min(max(x0 - 1 + e % EW, 0), Wd - 1);
        ro[m][h] = (gy * Wd + gx) * cin;
      }
    const int n0 = warp * NT * 8;
    float acc[MT1][NT][4] = {};
    gemm<true, float, MT1, NT>(acc, xb, ro, w1 + static_cast<size_t>(n0) * cin, cin, cin, g, t);
#pragma unroll
    for (int m = 0; m < MT1; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = m * 16 + g + 8 * h;
        if (e >= NE) continue;
        const int gy = y0 - 1 + e / EW, gx = x0 - 1 + e % EW;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < Wd;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int c = n0 + n * 8 + 2 * t;
          const float v0 = inside ? fmaxf(acc[m][n][2 * h] + __ldg(b1 + c), 0.f) : 0.f;
          const float v1 = inside ? fmaxf(acc[m][n][2 * h + 1] + __ldg(b1 + c + 1), 0.f) : 0.f;
          store2(t1 + e * LDT + c, v0, v1);
        }
      }
  }
  __syncthreads();

  // 2. conv2 (3x3) + b2 + ReLU over the tile: nine shifted GEMMs from T1
  {
    const int n0 = warp * NT * 8;
    float acc[MT][NT][4] = {};
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      int ro[MT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = m * 16 + g + 8 * h;
          ro[m][h] = ((p / TW + dy) * EW + p % TW + dx) * LDT;
        }
      gemm<true, float, MT, NT>(acc, t1, ro, w2 + (static_cast<size_t>(tap) * W + n0) * W, W, W, g, t);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = m * 16 + g + 8 * h;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int c = n0 + n * 8 + 2 * t;
          store2(t2 + p * LDT + c, fmaxf(acc[m][n][2 * h] + __ldg(b2 + c), 0.f),
                 fmaxf(acc[m][n][2 * h + 1] + __ldg(b2 + c + 1), 0.f));
        }
      }
  }
  __syncthreads();

  // 3. conv3 (+ downsample) + b3 + shortcut + ReLU → device memory, N3
  // output channels per pass
  {
    int ro[MT][2], rx[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = m * 16 + g + 8 * h;
        ro[m][h] = p * LDT;
        const int gy = min(y0 + p / TW, H - 1), gx = min(x0 + p % TW, Wd - 1);
        rx[m][h] = (gy * Wd + gx) * cin;
      }
#pragma unroll 1
    for (int pass = 0; pass < C4 / N3; ++pass) {
      const int n0 = pass * N3 + warp * NT3 * 8;
      float acc[MT][NT3][4] = {};
      gemm<true, float, MT, NT3>(acc, t2, ro, w3 + static_cast<size_t>(n0) * W, W, W, g, t);
      if (DOWN)
        gemm<true, float, MT, NT3>(acc, xb, rx, wd + static_cast<size_t>(n0) * cin, cin, cin, g, t);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = m * 16 + g + 8 * h;
          const int gy = y0 + p / TW, gx = x0 + p % TW;
          if (gy >= H || gx >= Wd) continue;
          float* o = out + ((static_cast<size_t>(b) * H + gy) * Wd + gx) * C4;
#pragma unroll
          for (int n = 0; n < NT3; ++n) {
            const int c = n0 + n * 8 + 2 * t;
            float v0 = acc[m][n][2 * h] + __ldg(b3 + c);
            float v1 = acc[m][n][2 * h + 1] + __ldg(b3 + c + 1);
            if (!DOWN) {  // identity shortcut: cin == 4W
              const float2 s = load2(xb + rx[m][h] + c);
              v0 += s.x;
              v1 += s.y;
            }
            store2(o + c, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          }
        }
    }
  }
}

template <int W, bool DOWN>
cudaError_t launch_fma(const void* x, const void* w1, const float* b1, const void* w2,
                       const float* b2, const void* w3, const float* b3, const void* wd,
                       void* out, int B, int H, int Wd, int cin, cudaStream_t stream) {
  constexpr int smem = fma_smem_bytes<W>();
  cudaError_t err = cudaFuncSetAttribute(bottleneck_fma<W, DOWN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Wd + TW - 1) / TW, (H + TH - 1) / TH, B);
  bottleneck_fma<W, DOWN><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), b1,
      static_cast<const float*>(w2), b2, static_cast<const float*>(w3), b3,
      static_cast<const float*>(wd), static_cast<float*>(out), H, Wd, cin);
  return cudaGetLastError();
}

// Launch resources of one instantiation as the runtime reports them, and
// its grid for a [B, H, Wd] output: out[0] registers a thread, out[1]
// shared memory bytes a CTA, out[2] CTAs an SM, out[3] local (spill) bytes
// a thread, out[4..6] grid dims, out[7] CTAs a cluster, out[8] CTAs the card
// runs at once.
template <int W, bool DOWN>
cudaError_t info(bool bf16, int B, int H, int Wd, int* out) {
  const int tiles_x = (Wd + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (bf16) {
    int clusters = 0;
    err = clusters_on_card(bottleneck_wgmma<W, DOWN>, WgPlan<W>::BYTES, &clusters);
    if (err == cudaSuccess)
      err = kernel_info(bottleneck_wgmma<W, DOWN>, CTA_THREADS, WgPlan<W>::BYTES, out);
    out[4] = CLUSTER * B * tiles_x * tiles_y;
    out[5] = out[6] = 1;
    out[7] = CLUSTER;
    out[8] = CLUSTER * clusters;
    return err;
  }
  err = kernel_info(bottleneck_fma<W, DOWN>, NTHREADS, fma_smem_bytes<W>(), out);
  out[4] = tiles_x;
  out[5] = tiles_y;
  out[6] = B;
  out[7] = 1;
  out[8] = out[2] * sms;
  return err;
}

template <bool DOWN>
cudaError_t info_width(int width, bool bf16, int B, int H, int Wd, int* out) {
  if (width == 128) return info<128, DOWN>(bf16, B, H, Wd, out);
  if (width == 256) return info<256, DOWN>(bf16, B, H, Wd, out);
  return cudaErrorInvalidValue;
}

}  // namespace

// One bottleneck of a residual stage in bf16 on the wgmma kernel: width 128
// (layer2) or 256 (layer3); cin a multiple of 64, with the downsample (down
// 1, block0) or 4 * width with the identity shortcut (down 0). `wstream` is
// the block's weight image, [2][stream_stages][8192] bytes
// (ops/res_stage_kernel.py::pack_res_stage_stream); biases are f32.
extern "C" int rlod_res_stage_block_bf16(const void* x, const void* wstream, const void* b1,
                                         const void* b2, const void* b3, int down, void* out,
                                         int B, int H, int Wd, int cin, int width,
                                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  const float* b3f = static_cast<const float*>(b3);
  if (cin % 64 != 0 || (!down && cin != 4 * width))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (width == 128)
    err = down ? launch_wgmma<128, true>(x, wstream, b1f, b2f, b3f, out, B, H, Wd, cin, s)
               : launch_wgmma<128, false>(x, wstream, b1f, b2f, b3f, out, B, H, Wd, cin, s);
  else if (width == 256)
    err = down ? launch_wgmma<256, true>(x, wstream, b1f, b2f, b3f, out, B, H, Wd, cin, s)
               : launch_wgmma<256, false>(x, wstream, b1f, b2f, b3f, out, B, H, Wd, cin, s);
  return static_cast<int>(err);
}

// The same bottleneck in f32 on the FMA kernel: cin a multiple of 16 with a
// downsample (wd, block0) or 4 * width with the identity shortcut (wd
// null). Weights are [N][K]: w1 [W][cin], w2 [9][W][W] (tap, co, ci), w3
// [4W][W], wd [4W][cin].
extern "C" int rlod_res_stage_block_f32(const void* x, const void* w1, const void* b1,
                                        const void* w2, const void* b2, const void* w3,
                                        const void* b3, const void* wd, void* out, int B,
                                        int H, int Wd, int cin, int width, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  const float* b3f = static_cast<const float*>(b3);
  const bool down = wd != nullptr;
  if (cin % 16 != 0 || (!down && cin != 4 * width))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (width == 128)
    err = down ? launch_fma<128, true>(x, w1, b1f, w2, b2f, w3, b3f, wd, out, B, H, Wd, cin, s)
               : launch_fma<128, false>(x, w1, b1f, w2, b2f, w3, b3f, wd, out, B, H, Wd, cin, s);
  else if (width == 256)
    err = down ? launch_fma<256, true>(x, w1, b1f, w2, b2f, w3, b3f, wd, out, B, H, Wd, cin, s)
               : launch_fma<256, false>(x, w1, b1f, w2, b2f, w3, b3f, wd, out, B, H, Wd, cin, s);
  return static_cast<int>(err);
}

// Launch resources and grid of the instantiation for (width, down, dtype)
// at a [B, H, Wd] output; see info() for out[0..8].
extern "C" int rlod_res_stage_info(int width, int down, int dtype, int B, int H, int Wd,
                                   int* out) {
  if (dtype != RLOD_F32 && dtype != RLOD_BF16) return static_cast<int>(cudaErrorInvalidValue);
  const bool bf16 = dtype == RLOD_BF16;
  const cudaError_t err = down ? info_width<true>(width, bf16, B, H, Wd, out)
                               : info_width<false>(width, bf16, B, H, Wd, out);
  return static_cast<int>(err);
}
