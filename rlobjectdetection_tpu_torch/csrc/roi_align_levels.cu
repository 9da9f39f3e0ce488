// Multi-level RoIAlignV2 for Hopper, forward and backward: the pooler of a
// Feature Pyramid Network's box head (Detectron2's ROIPooler with
// POOLER_TYPE ROIAlignV2 over P2-P5), level assignment included.
//
// Each roi (batch_idx, x1, y1, x2, y2 in image pixels) goes to level
//   k = floor(4 + log2(sqrt(area) / 224 + 1e-8)) clamped to [2, 5],
// area = (x2 - x1)(y2 - y1), computed as 2 + [v >= 1/2] + [v >= 1] + [v >= 2]
// with v = sqrt(area) / 224 + 1e-8 in round-to-nearest f32: the same integer
// wherever log2 is monotonic and exact at powers of two, and the same bits
// as the plain version, which compares the same way. It is pooled from
// level k's map (stride 2^k) with ROIAlign aligned=True (a -0.5 pixel
// offset, no minimum size) into a 7x7 grid, each bin the mean of an
// adaptive ceil(roi_h / 7) x ceil(roi_w / 7) grid of bilinear samples
// (sampling_ratio 0), samples outside [-1, size] being 0, as torchvision's
// roi_align computes it.
//
// No TPU kernel has this: the JAX package pools one stride-16 map
// (roi_align_pallas.py, RoIAlignAvg, one sample a bin on an 8x8 grid).
//
// What bounds it on the H100: the gathers. At the training cell (2 images
// at 800x1216: P2 [2, 200, 304, 256] bf16 ... P5 [2, 25, 38, 256], 1024
// rois) the four maps are 83 MB, read at most once from device memory
// (each roi reads the few rows of one map it covers), and the output is
// 26 MB. The forward's layout is that of RoIAlignAvg's kernel:
//  - a CTA is one roi x 256 channels: warp w is output row w (7 warps), its
//    32 lanes cover 256 contiguous channels of each corner, 8 a lane, so
//    each warp access is 512 contiguous bytes (16-byte loads of 8 bf16);
//  - every thread computes the roi's level and geometry itself (a few
//    dozen flops, uniform over the CTA, no shared memory, no barrier);
//  - sample coordinates use explicit round-to-nearest ops, so no FMA
//    contraction moves a sample across a pixel edge against the plain
//    version; interpolation and sums are f32, the output is the feature
//    type.
// The backward (rlod_roi_align_levels_bwd) walks the same samples and adds
// each sample's share of the bin's gradient into its four corners with f32
// atomics, into one zeroed f32 map a level; the caller casts those to the
// feature type. There a lane owns every 32nd channel (not 8 consecutive
// ones), so a warp's atomic add covers 32 consecutive floats, and a bin's
// samples are summed into the map's rows and columns they touch before any
// add (see MAXR below). Its sums are taken in an order that varies from
// launch to launch (atomics), so two launches agree to f32 rounding, not to
// the bit.

#include "common.cuh"

namespace {

constexpr int P = 7;
constexpr int VEC = 8;                 // channels a thread
constexpr int CHUNK = 32 * VEC;        // channels a CTA (one warp's row)
constexpr int NTHREADS = 32 * P;       // warp w: output row w
constexpr int LEVELS = 4;              // P2..P5
constexpr int MIN_LEVEL = 2;

struct Levels {
  const void* feat[LEVELS];  // [B][H][W][C] each, the feature type
  float* grad[LEVELS];       // [B][H][W][C] f32 each (backward)
  int H[LEVELS], W[LEVELS];
};

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

// The roi's level index (0 for P2) from its box in image pixels.
__device__ __forceinline__ int roi_level(const float* roi) {
  const float area = __fmul_rn(__fsub_rn(roi[3], roi[1]), __fsub_rn(roi[4], roi[2]));
  const float v = __fadd_rn(__fdiv_rn(__fsqrt_rn(area), 224.f), 1e-8f);
  return (v >= 0.5f) + (v >= 1.f) + (v >= 2.f);
}

// One roi's geometry on its level: start, bin size and samples a bin along
// each axis, and the samples' count (at least 1).
struct Geometry {
  float start_y, start_x, bin_h, bin_w;
  int grid_h, grid_w, level, b;
  float count;
};

__device__ __forceinline__ Geometry roi_geometry(const float* roi, int B) {
  Geometry g;
  g.level = roi_level(roi);
  const float scale = 1.f / static_cast<float>(1 << (g.level + MIN_LEVEL));
  g.start_x = __fsub_rn(__fmul_rn(roi[1], scale), 0.5f);
  g.start_y = __fsub_rn(__fmul_rn(roi[2], scale), 0.5f);
  const float roi_w = __fsub_rn(__fsub_rn(__fmul_rn(roi[3], scale), 0.5f), g.start_x);
  const float roi_h = __fsub_rn(__fsub_rn(__fmul_rn(roi[4], scale), 0.5f), g.start_y);
  g.bin_h = __fdiv_rn(roi_h, static_cast<float>(P));
  g.bin_w = __fdiv_rn(roi_w, static_cast<float>(P));
  g.grid_h = static_cast<int>(ceilf(__fdiv_rn(roi_h, static_cast<float>(P))));
  g.grid_w = static_cast<int>(ceilf(__fdiv_rn(roi_w, static_cast<float>(P))));
  g.count = static_cast<float>(max(g.grid_h * g.grid_w, 1));
  g.b = min(max(static_cast<int>(roi[0]), 0), B - 1);
  return g;
}

// Sample i of bin p along one axis: start + p·bin + (i + 0.5)·bin / grid.
__device__ __forceinline__ float sample_at(float start, float bin, int p, int i, int grid) {
  return __fadd_rn(__fadd_rn(start, __fmul_rn(static_cast<float>(p), bin)),
                   __fdiv_rn(__fmul_rn(static_cast<float>(i) + 0.5f, bin),
                             static_cast<float>(grid)));
}

// torchvision's bilinear_interpolate along one axis: false where the
// sample lies outside [-1, size]; else the low and high corner and the
// high corner's weight.
__device__ __forceinline__ bool axis_corners(float c, int size, int& lo, int& hi, float& l) {
  if (c < -1.f || c > static_cast<float>(size)) return false;
  if (c <= 0.f) c = 0.f;
  lo = static_cast<int>(c);
  if (lo >= size - 1) {
    hi = lo = size - 1;
    c = static_cast<float>(lo);
  } else {
    hi = lo + 1;
  }
  l = __fsub_rn(c, static_cast<float>(lo));
  return true;
}

template <typename T, bool VEC_OK>
__global__ void __launch_bounds__(NTHREADS) roi_align_levels_kernel(
    Levels lv, const float* __restrict__ rois, T* __restrict__ out, int B, int C) {
  const int r = blockIdx.x;
  const int py = threadIdx.x >> 5;
  const int c = blockIdx.y * CHUNK + (threadIdx.x & 31) * VEC;
  if (c >= C) return;
  const Geometry g = roi_geometry(rois + static_cast<size_t>(r) * 5, B);
  const int H = lv.H[g.level], W = lv.W[g.level];
  const T* fb = static_cast<const T*>(lv.feat[g.level]) + static_cast<size_t>(g.b) * H * W * C + c;
  T* ob = out + (static_cast<size_t>(r) * P + py) * P * C + c;
  for (int px = 0; px < P; ++px) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    for (int iy = 0; iy < g.grid_h; ++iy) {
      int y0, y1;
      float ly;
      if (!axis_corners(sample_at(g.start_y, g.bin_h, py, iy, g.grid_h), H, y0, y1, ly)) continue;
      const float hy = 1.f - ly;
      for (int ix = 0; ix < g.grid_w; ++ix) {
        int x0, x1;
        float lx;
        if (!axis_corners(sample_at(g.start_x, g.bin_w, px, ix, g.grid_w), W, x0, x1, lx))
          continue;
        const float hx = 1.f - lx;
        float v1[VEC], v2[VEC], v3[VEC], v4[VEC];
        load_ch<T, VEC_OK>(fb + (static_cast<size_t>(y0) * W + x0) * C, c, C, v1);
        load_ch<T, VEC_OK>(fb + (static_cast<size_t>(y0) * W + x1) * C, c, C, v2);
        load_ch<T, VEC_OK>(fb + (static_cast<size_t>(y1) * W + x0) * C, c, C, v3);
        load_ch<T, VEC_OK>(fb + (static_cast<size_t>(y1) * W + x1) * C, c, C, v4);
        const float w1 = hy * hx, w2 = hy * lx, w3 = ly * hx, w4 = ly * lx;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[j] += w1 * v1[j] + w2 * v2[j] + w3 * v3[j] + w4 * v4[j];
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = __fdiv_rn(acc[j], g.count);
    store_ch<T, VEC_OK>(ob + static_cast<size_t>(px) * C, c, C, acc);
  }
}

// The backward's channel layout: lane l of a warp owns channels l, l + 32,
// ..., l + 224 of the CTA's 256, so each of a thread's eight atomic adds is,
// across the warp, one add to 32 consecutive floats (128 bytes): the L2
// takes it as one request, where eight channels a lane made it 32.
template <typename T>
__device__ __forceinline__ void load_strided(const T* p, int c, int C, float* v) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = c + 32 * j < C ? to_f(p[32 * j]) : 0.f;
}

__device__ __forceinline__ void add_strided(float* p, int c, int C, float w, const float* v) {
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    if (c + 32 * j < C) atomicAdd(p + 32 * j, w * v[j]);
}

// The bin's gradient spreads over its samples' corners as an outer
// product: corner (y, x) of output row py takes g · Wy[y] · Wx[x], Wy the
// summed bilinear weights of the row's y samples on map row y and Wx those
// of the x samples on column x. So a thread (an output row, its channels)
// builds Wy over the few rows its samples touch (MAXR at most: a roi up to
// 7 · (MAXR - 1) map pixels tall), then walks its 7 bins' x samples left to
// right holding two columns' sums of g · Wx, and adds each finished column
// into every touched row: rows x columns atomic adds, against 4 a sample.
// Taller rois take the sample-by-sample walk.
constexpr int MAXR = 8;

__device__ __forceinline__ void flush_column(float* db, int W, int C, int c, int col,
                                             int y_lo, const float* wy, float* a) {
#pragma unroll
  for (int k = 0; k < MAXR; ++k)
    if (wy[k] != 0.f) add_strided(db + (static_cast<size_t>(y_lo + k) * W + col) * C, c, C,
                                  wy[k], a);
#pragma unroll
  for (int j = 0; j < VEC; ++j) a[j] = 0.f;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) roi_align_levels_bwd_kernel(
    Levels lv, const T* __restrict__ grad, const float* __restrict__ rois, int B, int C) {
  const int r = blockIdx.x;
  const int py = threadIdx.x >> 5;
  const int c = blockIdx.y * CHUNK + (threadIdx.x & 31);
  if (c >= C) return;
  const Geometry g = roi_geometry(rois + static_cast<size_t>(r) * 5, B);
  if (g.grid_h <= 0 || g.grid_w <= 0) return;
  const int H = lv.H[g.level], W = lv.W[g.level];
  float* db = lv.grad[g.level] + static_cast<size_t>(g.b) * H * W * C + c;
  const T* gb = grad + (static_cast<size_t>(r) * P + py) * P * C + c;

  // the rows this output row's samples touch: from the first valid one's
  // low corner to the last one's high corner
  int y_lo = -1, y_hi = -1;
  for (int iy = 0; iy < g.grid_h; ++iy) {
    int y0, y1;
    float ly;
    if (axis_corners(sample_at(g.start_y, g.bin_h, py, iy, g.grid_h), H, y0, y1, ly)) {
      if (y_lo < 0) y_lo = y0;
      y_hi = y1;
    }
  }
  if (y_lo < 0) return;

  if (y_hi - y_lo < MAXR) {
    float wy[MAXR];
#pragma unroll
    for (int k = 0; k < MAXR; ++k) wy[k] = 0.f;
    for (int iy = 0; iy < g.grid_h; ++iy) {
      int y0, y1;
      float ly;
      if (!axis_corners(sample_at(g.start_y, g.bin_h, py, iy, g.grid_h), H, y0, y1, ly)) continue;
#pragma unroll
      for (int k = 0; k < MAXR; ++k) {
        if (y0 == y_lo + k) wy[k] += 1.f - ly;
        if (y1 == y_lo + k) wy[k] += ly;
      }
    }
    float a0[VEC], a1[VEC], gv[VEC];  // columns col and col + 1
#pragma unroll
    for (int j = 0; j < VEC; ++j) a0[j] = a1[j] = 0.f;
    int col = -2;
    for (int px = 0; px < P; ++px) {
      load_strided(gb + static_cast<size_t>(px) * C, c, C, gv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) gv[j] = __fdiv_rn(gv[j], g.count);
      for (int ix = 0; ix < g.grid_w; ++ix) {
        int x0, x1;
        float lx;
        if (!axis_corners(sample_at(g.start_x, g.bin_w, px, ix, g.grid_w), W, x0, x1, lx))
          continue;
        if (x0 != col) {           // x0 only grows: finish the columns left of it
          if (col >= 0) flush_column(db, W, C, c, col, y_lo, wy, a0);
          if (x0 == col + 1) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              a0[j] = a1[j];
              a1[j] = 0.f;
            }
          } else if (col >= 0) {
            flush_column(db, W, C, c, col + 1, y_lo, wy, a1);
          }
          col = x0;
        }
        const float hx = 1.f - lx;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          a0[j] += hx * gv[j];
          if (x1 == x0) a0[j] += lx * gv[j];
          else a1[j] += lx * gv[j];
        }
      }
    }
    if (col >= 0) {
      flush_column(db, W, C, c, col, y_lo, wy, a0);
      if (col + 1 < W) flush_column(db, W, C, c, col + 1, y_lo, wy, a1);
    }
    return;
  }

  // a tall roi: each sample into its four corners
  for (int px = 0; px < P; ++px) {
    float gv[VEC];
    load_strided(gb + static_cast<size_t>(px) * C, c, C, gv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) gv[j] = __fdiv_rn(gv[j], g.count);
    for (int iy = 0; iy < g.grid_h; ++iy) {
      int y0, y1;
      float ly;
      if (!axis_corners(sample_at(g.start_y, g.bin_h, py, iy, g.grid_h), H, y0, y1, ly)) continue;
      const float hy = 1.f - ly;
      for (int ix = 0; ix < g.grid_w; ++ix) {
        int x0, x1;
        float lx;
        if (!axis_corners(sample_at(g.start_x, g.bin_w, px, ix, g.grid_w), W, x0, x1, lx))
          continue;
        const float hx = 1.f - lx;
        add_strided(db + (static_cast<size_t>(y0) * W + x0) * C, c, C, hy * hx, gv);
        add_strided(db + (static_cast<size_t>(y0) * W + x1) * C, c, C, hy * lx, gv);
        add_strided(db + (static_cast<size_t>(y1) * W + x0) * C, c, C, ly * hx, gv);
        add_strided(db + (static_cast<size_t>(y1) * W + x1) * C, c, C, ly * lx, gv);
      }
    }
  }
}

Levels make_levels(const void* const* feat, float* const* grad, const int* hw) {
  Levels lv;
  for (int k = 0; k < LEVELS; ++k) {
    lv.feat[k] = feat == nullptr ? nullptr : feat[k];
    lv.grad[k] = grad == nullptr ? nullptr : grad[k];
    lv.H[k] = hw[2 * k];
    lv.W[k] = hw[2 * k + 1];
  }
  return lv;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t launch_fwd(const Levels& lv, const float* rois, void* out, int R, int B, int C,
                       cudaStream_t stream) {
  const dim3 grid(R, (C + CHUNK - 1) / CHUNK);
  bool vec = C % VEC == 0 && aligned16(out);
  for (int k = 0; k < LEVELS; ++k) vec = vec && aligned16(lv.feat[k]);
  if (vec)
    roi_align_levels_kernel<T, true><<<grid, NTHREADS, 0, stream>>>(lv, rois,
                                                                     static_cast<T*>(out), B, C);
  else
    roi_align_levels_kernel<T, false><<<grid, NTHREADS, 0, stream>>>(lv, rois,
                                                                      static_cast<T*>(out), B, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const Levels& lv, const void* grad, const float* rois, int R, int B,
                       int C, cudaStream_t stream) {
  const dim3 grid(R, (C + CHUNK - 1) / CHUNK);
  roi_align_levels_bwd_kernel<T><<<grid, NTHREADS, 0, stream>>>(
      lv, static_cast<const T*>(grad), rois, B, C);
  return cudaGetLastError();
}

}  // namespace

// Pooled features [R, 7, 7, C] in the feature type from the four maps
// feat[k] [B, hw[2k], hw[2k+1], C] (P2..P5, one type) and rois [R, 5] f32.
extern "C" int rlod_roi_align_levels_fwd(const void* f2, const void* f3, const void* f4,
                                         const void* f5, const void* rois, void* out, int R,
                                         int B, int C, const int* hw, int dtype, void* stream) {
  if (R == 0 || C == 0) return 0;
  const void* feat[LEVELS] = {f2, f3, f4, f5};
  const Levels lv = make_levels(feat, nullptr, hw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(rois);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == RLOD_F32)
    err = launch_fwd<float>(lv, rf, out, R, B, C, s);
  else if (dtype == RLOD_BF16)
    err = launch_fwd<__nv_bfloat16>(lv, rf, out, R, B, C, s);
  return static_cast<int>(err);
}

// Adds the features' gradient of the forward into the f32 maps g2..g5
// (zeroed by the caller; [B, hw[2k], hw[2k+1], C]) from grad [R, 7, 7, C]
// in the feature type.
extern "C" int rlod_roi_align_levels_bwd(const void* grad, const void* rois, float* g2,
                                         float* g3, float* g4, float* g5, int R, int B, int C,
                                         const int* hw, int dtype, void* stream) {
  if (R == 0 || C == 0) return 0;
  float* dst[LEVELS] = {g2, g3, g4, g5};
  const Levels lv = make_levels(nullptr, dst, hw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(rois);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == RLOD_F32)
    err = launch_bwd<float>(lv, grad, rf, R, B, C, s);
  else if (dtype == RLOD_BF16)
    err = launch_bwd<__nv_bfloat16>(lv, grad, rf, R, B, C, s);
  return static_cast<int>(err);
}
