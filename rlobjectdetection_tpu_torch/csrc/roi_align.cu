// RoIAlignAvg for Hopper, forward and backward. The forward is single-sample
// bilinear RoIAlign at an 8x8 grid per roi, then the stride-1 2x2 mean,
// giving [R, 7, 7, C]; the backward (rlod_roi_align_avg_bwd, its kernel
// described where it is defined below) gives the features' gradient.
//
// Replaces the TPU kernel rlobjectdetection_tpu/ops/roi_align_pallas.py::
// roi_align_fwd_pallas (its _make_kernel) together with the 2x2 mean of
// roi_align_avg_pallas, fused. The TPU kernel recast the gather as a one-hot
// matrix product over the image's whole feature map, held in VMEM, which is
// why it needed rois sorted by image in groups; this kernel gathers directly
// and assumes nothing about roi order.
//
// What bounds it on the H100: bytes. At the serving shape (feats
// [1, 50, 76, 1024] bf16, 300 rois) it reads 7.8 MB of features at most once
// from device memory (the map fits the 50 MB L2, which serves the repeats)
// and writes 30 MB of output, with 16 loads and ~28 FLOPs per output
// element. The design keeps many 16-byte accesses in flight:
//  - a work item is (roi, output row py, 8 channels): a thread computes its
//    two sample rows (py, py + 1) column by column, each sample from four
//    16-byte corner loads (8 bf16 channels; f32 takes two 16-byte loads a
//    corner), and writes its 7 outputs as 16-byte stores as soon as the
//    second sample column of each is done. A column's eight loads carry no
//    branch (the indices are clamped into the map; an outside sample is
//    weighted 0), so they are all in flight at once: with a branch around
//    each sample the loads went out four at a time;
//  - a CTA is one roi x 256 channels: warp w is output row w (7 warps) and
//    its 32 lanes cover 256 contiguous channels of each corner row, so every
//    warp access is 512 contiguous bytes. The grid is R x ceil(C / 256):
//    2,100 warps at the RL refine's 64 rois and C = 1024, where one thread a
//    channel gave 256 CTAs;
//  - the first 16 threads compute the 8 row and 8 column sample coordinates
//    once a CTA into shared memory, exactly as roi_align_coords does (f32,
//    corner start clamped to H-2 / W-2, inside mask, with explicit
//    round-to-nearest ops so no FMA contraction moves a sample across a
//    pixel edge); the batch index is clamped to [0, B) so no read leaves the
//    map;
//  - C % 8 != 0 (or a map not 16-byte aligned) takes the same loop with
//    scalar loads and stores, channels past C masked.
// Interpolation weights and sums are f32; the output is in the feature type.

#include "common.cuh"

namespace {

constexpr int P = 7, A = P + 1;
constexpr int VEC = 8;                 // channels a thread
constexpr int CHUNK = 32 * VEC;        // channels a CTA (one warp's row)
constexpr int NTHREADS = 32 * P;       // warp w: output row w

// 8 channels from c on, as f32: 16-byte loads when VEC_OK, else scalar
// loads of the channels below C (0 past it)
template <typename T, bool VEC_OK>
__device__ __forceinline__ void load_ch(const T* p, int c, int C, float* v) {
  if constexpr (VEC_OK) {
    load8(p, v);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = c + j < C ? to_f(p[j]) : 0.f;
  }
}

template <typename T, bool VEC_OK>
__device__ __forceinline__ void store_ch(T* p, int c, int C, const float* v) {
  if constexpr (VEC_OK) {
    store8(p, v);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (c + j < C) p[j] = from_f<T>(v[j]);
  }
}

// Sample-point geometry, exactly as roi_align_coords computes it (f32,
// corner start clamped to size - 2, inside mask), with explicit
// round-to-nearest ops so no FMA contraction moves a sample across a pixel
// edge. One axis of one roi: its start `lo` and bin, then sample i of it.
__device__ __forceinline__ void axis_span(const float* roi, int axis, float spatial_scale,
                                          float& lo, float& bin) {
  lo = __fmul_rn(roi[axis == 0 ? 2 : 1], spatial_scale);
  const float hi = __fmul_rn(roi[axis == 0 ? 4 : 3], spatial_scale);
  const float len = fmaxf(__fadd_rn(__fsub_rn(hi, lo), 1.0f), 0.0f);
  bin = __fdiv_rn(len, static_cast<float>(A - 1));
}

struct AxisSample {
  int idx;       // first corner, in [0, size - 2]
  float ratio;   // coord - clamped start: >= 1 for a coord in [size - 1, size)
  bool inside;   // coord in [0, size)
};

__device__ __forceinline__ AxisSample axis_sample(float lo, float bin, int i, int size) {
  const float coord = __fadd_rn(__fmul_rn(static_cast<float>(i), bin), lo);
  const float start = fminf(floorf(coord), static_cast<float>(size - 2));
  return {min(max(static_cast<int>(start), 0), size - 2), __fsub_rn(coord, start),
          coord >= 0.f && coord < static_cast<float>(size)};
}

__device__ __forceinline__ int clamp_batch(const float* roi, int B) {
  return min(max(static_cast<int>(roi[0]), 0), B - 1);
}

// The geometry of one roi for a CTA; the batch index is clamped to [0, B)
// so no access leaves the map. Threads 0..2A-1 fill it; the caller syncs
// before reading.
struct RoiCoords {
  int idx[2][A];     // [0]: rows, [1]: cols
  float ratio[2][A];
  int inside[2][A];
  int b;
};

__device__ __forceinline__ void roi_coords(RoiCoords& s, const float* roi, float spatial_scale,
                                           int B, int H, int W) {
  if (threadIdx.x < 2 * A) {
    const int axis = threadIdx.x / A, i = threadIdx.x % A;  // 0: rows, 1: cols
    float lo, bin;
    axis_span(roi, axis, spatial_scale, lo, bin);
    const AxisSample a = axis_sample(lo, bin, i, axis == 0 ? H : W);
    s.ratio[axis][i] = a.ratio;
    s.inside[axis][i] = a.inside;
    s.idx[axis][i] = a.idx;
  }
  if (threadIdx.x == 0) s.b = clamp_batch(roi, B);
}

template <typename T, bool VEC_OK>
__global__ void __launch_bounds__(NTHREADS) roi_align_avg_kernel(
    const T* __restrict__ feat,     // [B][H][W][C]
    const float* __restrict__ rois, // [R][5] (batch_idx, x1, y1, x2, y2)
    T* __restrict__ out,            // [R][P][P][C]
    int B, int H, int W, int C, float spatial_scale) {
  __shared__ RoiCoords s;
  const int r = blockIdx.x;
  roi_coords(s, rois + static_cast<size_t>(r) * 5, spatial_scale, B, H, W);
  __syncthreads();

  const int py = threadIdx.x >> 5;
  const int c = blockIdx.y * CHUNK + (threadIdx.x & 31) * VEC;
  if (c >= C) return;
  const size_t row_stride = static_cast<size_t>(W) * C;
  const T* fb = feat + static_cast<size_t>(s.b) * H * row_stride + c;
  T* ob = out + (static_cast<size_t>(r) * P + py) * P * C + c;

  // sample rows py and py + 1: their corner rows, ratios, inside flags
  const T* row[2][2];
  float hr[2];
  bool yin[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    row[k][0] = fb + s.idx[0][py + k] * row_stride;
    row[k][1] = row[k][0] + row_stride;
    hr[k] = s.ratio[0][py + k];
    yin[k] = s.inside[0][py + k];
  }

  float prev[VEC];  // the column sum (both sample rows) of column sx - 1
#pragma unroll
  for (int sx = 0; sx < A; ++sx) {
    const float wr = s.ratio[1][sx];
    const bool xin = s.inside[1][sx];
    const size_t o = static_cast<size_t>(s.idx[1][sx]) * C;
    float col[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) col[j] = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (!(yin[k] && xin)) continue;
      float ul[VEC], ur[VEC], dl[VEC], dr[VEC];
      load_ch<T, VEC_OK>(row[k][0] + o, c, C, ul);
      load_ch<T, VEC_OK>(row[k][0] + o + C, c, C, ur);
      load_ch<T, VEC_OK>(row[k][1] + o, c, C, dl);
      load_ch<T, VEC_OK>(row[k][1] + o + C, c, C, dr);
      const float h = hr[k];
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        col[j] += ul[j] * ((1.f - h) * (1.f - wr)) + ur[j] * ((1.f - h) * wr) +
                  dl[j] * (h * (1.f - wr)) + dr[j] * (h * wr);
    }
    if (sx > 0) {
      float out_v[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) out_v[j] = 0.25f * (prev[j] + col[j]);
      store_ch<T, VEC_OK>(ob + static_cast<size_t>(sx - 1) * C, c, C, out_v);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) prev[j] = col[j];
  }
}

template <typename T>
cudaError_t launch(const void* feat, const float* rois, void* out, int R, int B, int H,
                   int W, int C, float spatial_scale, cudaStream_t stream) {
  const dim3 grid(R, (C + CHUNK - 1) / CHUNK);
  const bool vec = C % VEC == 0 && reinterpret_cast<uintptr_t>(feat) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    roi_align_avg_kernel<T, true><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const T*>(feat), rois, static_cast<T*>(out), B, H, W, C, spatial_scale);
  else
    roi_align_avg_kernel<T, false><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const T*>(feat), rois, static_cast<T*>(out), B, H, W, C, spatial_scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Backward: d features [B, H, W, C] from d pooled [R, 7, 7, C], the same
// geometry. Replaces no Pallas kernel: the JAX package computes it in XLA
// (rlobjectdetection_tpu/ops/roi_align_vjp.py::_bwd, a sorted scatter-add
// behind the 2x2 mean of roi_align_avg_cvjp); the reference's own op had a
// CUDA backward of this shape (atomicAdd into the features' gradient).
//
// What bounds it: bytes. Each input read once and each output written once
// is d pooled and d features (at the flagship's train shape, 2 x 128 rois at
// C = 1024 on a 50 x 76 map in bf16: 25.7 MB + 15.6 MB, 0.0123 ms at
// 3.35 TB/s). The design is a gather by destination row: the thread that
// owns an output element computes it, so there are no atomics, no f32
// scratch of the map and no cast pass, and every element sums its
// contributions in an order fixed by the inputs alone (two launches give the
// same bits):
//  - a CTA is one feature row (b, y) x 256 channels x a band of 80 columns
//    (grid B*H x ceil(C/256) x ceil(W/80); one band up to W = 80, wider
//    maps take more bands), 16 warps. Lane l of every warp holds channels
//    8l .. 8l + 7 of the CTA's 256, so a warp's control flow is the same in
//    all its lanes;
//  - entries: the CTA walks the rois in index order, 512 a round, one a
//    thread, the next round's roi prefetched. A roi of image b takes an
//    entry (slot, sy, w_y) for each inside sample row sy whose corner rows
//    idx_y(sy) or idx_y(sy) + 1 are y, w_y = 1 - h for the upper corner row
//    and h for the lower: at most one a sample row, 8 a roi. A block-wide
//    prefix sum of the per-roi counts appends them in (roi, sy) order (no
//    shared atomic counter, whose order would vary), and the roi's column
//    geometry goes into its slot. Entries gather over rounds until the 512
//    slots would overflow, so the batches below stay full;
//  - samples: 16 entries at a time, warp w takes entry w and computes its 8
//    sample gradients from the two pooled rows sy - 1 and sy (14 16-byte
//    loads of d pooled a lane, all issued before any is used; 512
//    contiguous bytes a warp, from L2): 1/4 of the up to four pooled cells a
//    sample feeds, summed in the plain version's order, into f32 shared
//    memory;
//  - accumulate: warp w owns the band's columns w, w + 16, .., w + 64 and
//    keeps their 40 sums a lane in registers. Interleaved, so the few
//    columns under a hot box (the same box drawn 16 times) spread over all
//    16 warps. Each sample's two corner columns are adjacent, so at most one
//    is the warp's. Lanes k and k + 16 first work out, for 4 samples each
//    of entry k, whether the sample's corner is the warp's, which of its 5
//    columns, and its weight w_y * w_x. The warp then visits the entries
//    with a hit in order, takes those from lanes k and k + 16 by shuffles,
//    and adds w * g for each hit in sample order (one fused multiply-add an
//    element). The column is the same in every lane, so a branch tree picks
//    it (no predicated copies for the other 4). No two warps own one sum;
//  - write: each warp stores its columns once in the feature type with
//    16-byte stores, zeros where no sample reached.
// Products and sums are f32, rounded once to bf16.
constexpr int BWD_THREADS = 512;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_CH = 32 * VEC;                  // channels a CTA: 8 a lane
constexpr int BWD_ENTRIES = BWD_WARPS;            // entries a batch, one a warp
constexpr int BWD_ROIS = BWD_THREADS;             // rois a round, one a thread; slots
constexpr int BWD_XPT = 5;                        // columns a warp owns
constexpr int BWD_BAND = BWD_XPT * BWD_WARPS;     // columns a CTA (80)

// dynamic shared memory of a CTA, in 4-byte words
struct BwdSmem {
  static constexpr int STAGE = 0;                                  // [16][A][2][32][4] f32
  static constexpr int XIDX = STAGE + BWD_ENTRIES * A * BWD_CH;     // [512 slots][A] int
  static constexpr int XRATIO = XIDX + BWD_ROIS * A;                // [512][A] f32
  static constexpr int XIN = XRATIO + BWD_ROIS * A;                 // [512] bit mask
  static constexpr int ROI = XIN + BWD_ROIS;                        // [512] roi index
  static constexpr int ENT = ROI + BWD_ROIS;                        // [512 A] slot | sy << 16
  static constexpr int ENT_WY = ENT + BWD_ROIS * A;                 // [512 A] f32
  static constexpr int WARP_SUM = ENT_WY + BWD_ROIS * A;            // [16] + total
  static constexpr int WORDS = WARP_SUM + BWD_WARPS + 1;
  static constexpr int BYTES = WORDS * 4;
};

// the 4 f32 at half `half` of lane `lane` in a [2][32][4] row of 256 channels
__device__ __forceinline__ float4* lane_half(float* row, int half, int lane) {
  return reinterpret_cast<float4*>(row) + half * 32 + lane;
}

__device__ __forceinline__ void fma8(float (&acc)[VEC], float w, const float (&g)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = fmaf(w, g[j], acc[j]);
}

// acc[i] += w * g for a warp-uniform i in [0, BWD_XPT), by branches (not
// predicated copies of the five updates)
__device__ __forceinline__ void add_column(float (&acc)[BWD_XPT][VEC], int i, float w,
                                           const float (&g)[VEC]) {
  static_assert(BWD_XPT == 5, "one branch per column");
  if (i < 2) {
    if (i == 0) fma8(acc[0], w, g);
    else fma8(acc[1], w, g);
  } else if (i == 2) {
    fma8(acc[2], w, g);
  } else if (i == 3) {
    fma8(acc[3], w, g);
  } else {
    fma8(acc[4], w, g);
  }
}

template <typename T, bool VEC_OK>
__global__ void __launch_bounds__(BWD_THREADS, 1) roi_align_avg_bwd_kernel(
    const T* __restrict__ grad,      // [R][P][P][C]
    const float* __restrict__ rois,  // [R][5]
    T* __restrict__ dfeat,           // [B][H][W][C], every element written
    int R, int B, int H, int W, int C, float spatial_scale) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem + BwdSmem::STAGE;
  int* xidx = reinterpret_cast<int*>(smem + BwdSmem::XIDX);
  float* xratio = smem + BwdSmem::XRATIO;
  int* xin = reinterpret_cast<int*>(smem + BwdSmem::XIN);
  int* roi_of = reinterpret_cast<int*>(smem + BwdSmem::ROI);
  int* ent = reinterpret_cast<int*>(smem + BwdSmem::ENT);
  float* ent_wy = smem + BwdSmem::ENT_WY;
  int* warp_sum = reinterpret_cast<int*>(smem + BwdSmem::WARP_SUM);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x / H, y = blockIdx.x % H;
  const int c = blockIdx.y * BWD_CH + lane * VEC;                 // the lane's 8 channels
  const int x0 = blockIdx.z * BWD_BAND;   // the band; the warp's columns x0 + warp + 16 j
  const size_t pooled_row = static_cast<size_t>(P) * C;

  float acc[BWD_XPT][VEC];
#pragma unroll
  for (int i = 0; i < BWD_XPT; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[i][j] = 0.f;

  // the entries gathered so far, in batches of 16: sample gradients, then
  // each warp's columns
  auto process = [&](int n_entries) {
    for (int e0 = 0; e0 < n_entries; e0 += BWD_ENTRIES) {
      const int n_batch = min(BWD_ENTRIES, n_entries - e0);
      // 1. sample gradients of entry e0 + warp
      if (warp < n_batch && c < C) {
        const int info = ent[e0 + warp], sy = info >> 16;
        const T* g = grad + static_cast<size_t>(roi_of[info & 0xffff]) * P * pooled_row + c;
        const T* g_up = g + max(sy - 1, 0) * pooled_row;  // pooled row sy - 1 (sy > 0)
        const T* g_dn = g + sy * pooled_row;              // pooled row sy (sy < P)
        // pooled columns -1 .. 7 of both rows, 0 outside
        float up[A + 1][VEC], dn[A + 1][VEC];
#pragma unroll
        for (int i = 0; i <= A; ++i) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) up[i][j] = dn[i][j] = 0.f;
          if (i >= 1 && i <= P && sy < P) load_ch<T, VEC_OK>(g_dn + (i - 1) * C, c, C, dn[i]);
          if (i >= 1 && i <= P && sy > 0) load_ch<T, VEC_OK>(g_up + (i - 1) * C, c, C, up[i]);
        }
#pragma unroll
        for (int sx = 0; sx < A; ++sx) {
          // cells (sy, sx), (sy, sx-1), (sy-1, sx), (sy-1, sx-1), in the
          // plain version's order; a missing cell adds 0
          float v[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            v[j] = 0.25f * __fadd_rn(__fadd_rn(__fadd_rn(dn[sx + 1][j], dn[sx][j]),
                                               up[sx + 1][j]), up[sx][j]);
          float* row = stage + (warp * A + sx) * BWD_CH;
          *lane_half(row, 0, lane) = make_float4(v[0], v[1], v[2], v[3]);
          *lane_half(row, 1, lane) = make_float4(v[4], v[5], v[6], v[7]);
        }
      }
      // 2. lanes k and k + 16: samples 4 h .. 4 h + 3 of entry k (h = lane / 16).
      // Bit s of `hits`: the sample's left or right corner column is the
      // warp's, its column slot j in bits 4 + 3 s, its weight w_y * w_x in w[s]
      int hits = 0;
      float w[4] = {0.f, 0.f, 0.f, 0.f};
      const int k = lane & 15, h = lane >> 4;
      if (k < n_batch) {
        const int slot = ent[e0 + k] & 0xffff, in = xin[slot] >> 4 * h;
        const float w_y = ent_wy[e0 + k];
        const int4 xi = reinterpret_cast<const int4*>(xidx + slot * A)[h];
        const float4 xf = reinterpret_cast<const float4*>(xratio + slot * A)[h];
        const int xs[4] = {xi.x, xi.y, xi.z, xi.w};
        const float xr[4] = {xf.x, xf.y, xf.z, xf.w};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          // left corner column xs, right xs + 1: the warp's if 16 j away
          const int dl = xs[s] - x0 - warp, dr = dl + 1;
          const bool left = (dl & (BWD_WARPS - 1)) == 0 && dl >= 0 && dl < BWD_BAND;
          const bool right = (dr & (BWD_WARPS - 1)) == 0 && dr >= 0 && dr < BWD_BAND;
          if ((in >> s & 1) && (left || right)) {
            hits |= 1 << s | ((left ? dl : dr) / BWD_WARPS) << (4 + 3 * s);
            w[s] = __fmul_rn(w_y, left ? __fsub_rn(1.f, xr[s]) : xr[s]);
          }
        }
      }
      const unsigned any = __ballot_sync(0xffffffffu, hits != 0);
      unsigned reach = (any | any >> 16) & 0xffffu;
      __syncthreads();

      // 3. accumulate: the reaching entries in order, their hits in order
      while (reach) {
        const int kk = __ffs(reach) - 1;
        reach &= reach - 1;
        const int hk[2] = {__shfl_sync(0xffffffffu, hits, kk),
                           __shfl_sync(0xffffffffu, hits, kk + 16)};
        float wk[A];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          wk[s] = __shfl_sync(0xffffffffu, w[s], kk);
          wk[s + 4] = __shfl_sync(0xffffffffu, w[s], kk + 16);
        }
#pragma unroll
        for (int sx = 0; sx < A; ++sx) {
          const int hw = hk[sx >> 2], s = sx & 3;
          if (!(hw >> s & 1)) continue;
          float* gr = stage + (kk * A + sx) * BWD_CH;
          const float4 lo = *lane_half(gr, 0, lane), hi = *lane_half(gr, 1, lane);
          const float g[VEC] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
          add_column(acc, hw >> (4 + 3 * s) & 7, wk[sx], g);
        }
      }
      __syncthreads();
    }
  };

  // the entry walk, one roi a thread a round, the next round's roi prefetched
  float next[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) next[i] = t < R ? rois[static_cast<size_t>(t) * 5 + i] : 0.f;
  int n_slots = 0, n_entries = 0;  // gathered so far (the same in every thread)
  for (int r0 = 0; r0 < R; r0 += BWD_ROIS) {
    const int r = r0 + t;
    float roi[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) roi[i] = next[i];
    if (r + BWD_ROIS < R)
#pragma unroll
      for (int i = 0; i < 5; ++i) next[i] = rois[static_cast<size_t>(r + BWD_ROIS) * 5 + i];
    unsigned mask = 0;
    float wy[A];
    if (r < R && clamp_batch(roi, B) == b) {
      float lo, bin;
      axis_span(roi, 0, spatial_scale, lo, bin);
#pragma unroll
      for (int sy = 0; sy < A; ++sy) {
        const AxisSample s = axis_sample(lo, bin, sy, H);
        wy[sy] = s.idx == y ? __fsub_rn(1.f, s.ratio) : s.ratio;
        if (s.inside && (s.idx == y || s.idx + 1 == y)) mask |= 1u << sy;
      }
    }
    // inclusive prefix sums over the block, in thread order, of (takes a
    // slot) << 16 | entries
    const int mine = (mask != 0) << 16 | __popc(mask);
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (t == 0) {
      int run = 0;
      for (int w = 0; w < BWD_WARPS; ++w) {
        const int v = warp_sum[w];
        warp_sum[w] = run;
        run += v;
      }
      warp_sum[BWD_WARPS] = run;
    }
    __syncthreads();
    const int total = warp_sum[BWD_WARPS], before = warp_sum[warp] + incl - mine;
    if (n_slots + (total >> 16) > BWD_ROIS) {   // the slots would overflow: use them first
      process(n_entries);
      n_slots = n_entries = 0;
    }
    if (mask) {
      const int slot = n_slots + (before >> 16);
      int e = n_entries + (before & 0xffff);
#pragma unroll
      for (int sy = 0; sy < A; ++sy)
        if (mask >> sy & 1u) {
          ent[e] = slot | sy << 16;
          ent_wy[e] = wy[sy];
          ++e;
        }
      float lo, bin;
      axis_span(roi, 1, spatial_scale, lo, bin);
      int in = 0;
#pragma unroll
      for (int sx = 0; sx < A; ++sx) {
        const AxisSample s = axis_sample(lo, bin, sx, W);
        xidx[slot * A + sx] = s.idx;
        xratio[slot * A + sx] = s.ratio;
        in |= s.inside << sx;
      }
      xin[slot] = in;
      roi_of[slot] = r;
    }
    n_slots += total >> 16;
    n_entries += total & 0xffff;
    __syncthreads();
  }
  process(n_entries);

  // 4. write the warp's columns once, in the feature type
  if (c >= C) return;
  T* row = dfeat + (static_cast<size_t>(b) * H + y) * W * C + c;
#pragma unroll
  for (int i = 0; i < BWD_XPT; ++i) {
    const int x = x0 + warp + BWD_WARPS * i;
    if (x < W) store_ch<T, VEC_OK>(row + static_cast<size_t>(x) * C, c, C, acc[i]);
  }
}

template <typename T, bool VEC_OK>
cudaError_t launch_bwd_as(const void* grad, const float* rois, void* dfeat, int R, int B, int H,
                          int W, int C, float spatial_scale, cudaStream_t stream) {
  const auto kernel = roi_align_avg_bwd_kernel<T, VEC_OK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         BwdSmem::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (C + BWD_CH - 1) / BWD_CH, (W + BWD_BAND - 1) / BWD_BAND);
  kernel<<<grid, BWD_THREADS, BwdSmem::BYTES, stream>>>(
      static_cast<const T*>(grad), rois, static_cast<T*>(dfeat), R, B, H, W, C, spatial_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* grad, const float* rois, void* dfeat, int R, int B, int H,
                       int W, int C, float spatial_scale, cudaStream_t stream) {
  const bool vec = C % VEC == 0 && reinterpret_cast<uintptr_t>(grad) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dfeat) % 16 == 0;
  return vec ? launch_bwd_as<T, true>(grad, rois, dfeat, R, B, H, W, C, spatial_scale, stream)
             : launch_bwd_as<T, false>(grad, rois, dfeat, R, B, H, W, C, spatial_scale, stream);
}

}  // namespace

extern "C" int rlod_roi_align_avg_fwd(const void* feat, const void* rois, void* out,
                                      int R, int B, int H, int W, int C,
                                      float spatial_scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(rois);
  if (R == 0) return 0;
  cudaError_t err;
  if (dtype == RLOD_F32)
    err = launch<float>(feat, rf, out, R, B, H, W, C, spatial_scale, s);
  else if (dtype == RLOD_BF16)
    err = launch<__nv_bfloat16>(feat, rf, out, R, B, H, W, C, spatial_scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// d features of RoIAlignAvg, [B, H, W, C] in the type of grad, every
// element written by the kernel (zeros where no sample reaches; R == 0 gives
// zeros). No scratch, no atomics: two launches give the same bits.
extern "C" int rlod_roi_align_avg_bwd(const void* grad, const void* rois, void* dfeat, int R,
                                      int B, int H, int W, int C, float spatial_scale,
                                      int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(rois);
  if (B * H == 0 || W == 0 || C == 0) return 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == RLOD_F32)
    err = launch_bwd<float>(grad, rf, dfeat, R, B, H, W, C, spatial_scale, s);
  else if (dtype == RLOD_BF16)
    err = launch_bwd<__nv_bfloat16>(grad, rf, dfeat, R, B, H, W, C, spatial_scale, s);
  return static_cast<int>(err);
}

// Launch resources of the backward kernel for dtype (16-byte path): out[0]
// registers a thread, out[1] shared memory bytes a CTA, out[2] CTAs an SM,
// out[3] local (spill) bytes a thread.
extern "C" int rlod_roi_align_avg_bwd_info(int dtype, int* out) {
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == RLOD_F32)
    err = kernel_info(roi_align_avg_bwd_kernel<float, true>, BWD_THREADS, BwdSmem::BYTES, out);
  else if (dtype == RLOD_BF16)
    err = kernel_info(roi_align_avg_bwd_kernel<__nv_bfloat16, true>, BWD_THREADS,
                      BwdSmem::BYTES, out);
  return static_cast<int>(err);
}
