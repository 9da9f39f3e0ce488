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

#include <algorithm>

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

// Sample-point geometry of one roi, exactly as roi_align_coords computes it
// (f32, corner start clamped to H-2 / W-2, inside mask), with explicit
// round-to-nearest ops so no FMA contraction moves a sample across a pixel
// edge; the batch index is clamped to [0, B) so no access leaves the map.
// Threads 0..2A-1 fill it; the caller syncs before reading.
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
    const float lo = __fmul_rn(roi[axis == 0 ? 2 : 1], spatial_scale);
    const float hi = __fmul_rn(roi[axis == 0 ? 4 : 3], spatial_scale);
    const float len = fmaxf(__fadd_rn(__fsub_rn(hi, lo), 1.0f), 0.0f);
    const float bin = __fdiv_rn(len, static_cast<float>(A - 1));
    const float coord = __fadd_rn(__fmul_rn(static_cast<float>(i), bin), lo);
    const int size = axis == 0 ? H : W;
    const float start = fminf(floorf(coord), static_cast<float>(size - 2));
    s.ratio[axis][i] = __fsub_rn(coord, start);
    s.inside[axis][i] = coord >= 0.f && coord < static_cast<float>(size);
    s.idx[axis][i] = min(max(static_cast<int>(start), 0), size - 2);
  }
  if (threadIdx.x == 0) s.b = min(max(static_cast<int>(roi[0]), 0), B - 1);
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
// 3.35 TB/s). This first design is simple and right rather than fast:
//  - a CTA is one roi x 256 channels; warp w is sample row w (8 warps) and
//    lane l takes channels l, l + 32, ..., l + 224 of the chunk, so each
//    warp access, load or atomic, is 32 consecutive elements;
//  - walking the 8 sample columns, a thread keeps the pooled column sums of
//    the previous column (the sliding form of the forward's 2x2 mean): a
//    sample's gradient is 1/4 of the up to four pooled cells it feeds, 0
//    outside the image;
//  - it adds that gradient times its four bilinear weights into its four
//    corners with f32 atomicAdd (fire-and-forget reductions in L2) into a
//    zeroed f32 scratch of the whole map; bf16 then takes one cast pass.
// The scratch is the design's overhead above the bound: 4 bytes an element
// zeroed, reduced into and (bf16) read back, 31.1 MB at that shape.
// Atomics add in whatever order the CTAs reach L2, so the f32 sums differ
// from run to run in their last bits: checks hold it to a tolerance.
constexpr int BWD_THREADS = 32 * A;   // warp w: sample row w

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS) roi_align_avg_bwd_kernel(
    const T* __restrict__ grad,      // [R][P][P][C]
    const float* __restrict__ rois,  // [R][5]
    float* __restrict__ dfeat,       // [B][H][W][C], zeroed
    int B, int H, int W, int C, float spatial_scale) {
  __shared__ RoiCoords s;
  const int r = blockIdx.x;
  roi_coords(s, rois + static_cast<size_t>(r) * 5, spatial_scale, B, H, W);
  __syncthreads();

  const int sy = threadIdx.x >> 5;
  if (!s.inside[0][sy]) return;
  const int c0 = blockIdx.y * CHUNK + (threadIdx.x & 31);
  const size_t row_stride = static_cast<size_t>(W) * C;
  float* d_up = dfeat + (static_cast<size_t>(s.b) * H + s.idx[0][sy]) * row_stride + c0;
  float* d_dn = d_up + row_stride;
  const float h = s.ratio[0][sy];
  // the pooled rows this sample row feeds: sy - 1 and sy, where in [0, P)
  const bool up = sy > 0, dn = sy < P;
  const T* g_up = grad + (static_cast<size_t>(r) * P + max(sy - 1, 0)) * P * C + c0;
  const T* g_dn = grad + (static_cast<size_t>(r) * P + min(sy, P - 1)) * P * C + c0;

  float prev[VEC];  // pooled column sum of column sx - 1 (0 before column 0)
#pragma unroll
  for (int j = 0; j < VEC; ++j) prev[j] = 0.f;
#pragma unroll
  for (int sx = 0; sx < A; ++sx) {
    float col[VEC];  // pooled column sum of column sx (0 past column P - 1)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      col[j] = 0.f;
      if (sx < P && c0 + 32 * j < C) {
        const size_t o = static_cast<size_t>(sx) * C + 32 * j;
        if (up) col[j] += to_f(g_up[o]);
        if (dn) col[j] += to_f(g_dn[o]);
      }
    }
    if (s.inside[1][sx]) {
      const float wr = s.ratio[1][sx];
      const float w_ul = (1.f - h) * (1.f - wr), w_ur = (1.f - h) * wr;
      const float w_dl = h * (1.f - wr), w_dr = h * wr;
      const size_t o = static_cast<size_t>(s.idx[1][sx]) * C;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (c0 + 32 * j >= C) continue;
        const float g = 0.25f * (prev[j] + col[j]);
        const size_t oj = o + 32 * j;
        atomicAdd(d_up + oj, g * w_ul);
        atomicAdd(d_up + oj + C, g * w_ur);
        atomicAdd(d_dn + oj, g * w_dl);
        atomicAdd(d_dn + oj + C, g * w_dr);
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) prev[j] = col[j];
  }
}

// f32 -> bf16, 8 elements a thread when VEC_OK (n % 8 == 0, 16-byte aligned)
template <bool VEC_OK>
__global__ void cast_bf16_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                                 size_t n) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  if constexpr (VEC_OK) {
    for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n / VEC;
         i += stride) {
      float v[VEC];
      load8(src + i * VEC, v);
      store8(dst + i * VEC, v);
    }
  } else {
    for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
         i += stride)
      dst[i] = __float2bfloat16_rn(src[i]);
  }
}

template <typename T>
cudaError_t launch_bwd(const void* grad, const float* rois, float* scratch, int R, int B, int H,
                       int W, int C, float spatial_scale, cudaStream_t stream) {
  const dim3 grid(R, (C + CHUNK - 1) / CHUNK);
  roi_align_avg_bwd_kernel<T><<<grid, BWD_THREADS, 0, stream>>>(
      static_cast<const T*>(grad), rois, scratch, B, H, W, C, spatial_scale);
  return cudaGetLastError();
}

cudaError_t cast_bf16(const float* src, void* dst, size_t n, cudaStream_t stream) {
  const bool vec = n % VEC == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  const size_t items = vec ? n / VEC : n;
  const int threads = 256;
  const int blocks = static_cast<int>(std::min<size_t>((items + threads - 1) / threads, 132 * 16));
  if (blocks == 0) return cudaSuccess;
  if (vec)
    cast_bf16_kernel<true><<<blocks, threads, 0, stream>>>(
        src, static_cast<__nv_bfloat16*>(dst), n);
  else
    cast_bf16_kernel<false><<<blocks, threads, 0, stream>>>(
        src, static_cast<__nv_bfloat16*>(dst), n);
  return cudaGetLastError();
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

// d features of RoIAlignAvg. `scratch` is an f32 [B, H, W, C] buffer, zeroed
// here; for f32 features it is the output itself (dfeat == scratch), for
// bf16 the sums are cast into dfeat at the end. R == 0 gives zeros.
extern "C" int rlod_roi_align_avg_bwd(const void* grad, const void* rois, void* scratch,
                                      void* dfeat, int R, int B, int H, int W, int C,
                                      float spatial_scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(rois);
  float* acc = static_cast<float*>(scratch);
  const size_t n = static_cast<size_t>(B) * H * W * C;
  if (dtype != RLOD_F32 && dtype != RLOD_BF16) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == RLOD_F32 && dfeat != scratch) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(acc, 0, n * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0) {
    err = dtype == RLOD_F32
              ? launch_bwd<float>(grad, rf, acc, R, B, H, W, C, spatial_scale, s)
              : launch_bwd<__nv_bfloat16>(grad, rf, acc, R, B, H, W, C, spatial_scale, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dtype == RLOD_BF16) err = cast_bf16(acc, dfeat, n, s);
  return static_cast<int>(err);
}
