// A served image's blob in one pass: the pixel means subtracted, OpenCV's
// INTER_LINEAR resize by `scale` and the zero pad up to the blob's shape,
// `rlod::image_blob` (ops/image_blob.py).
//
// It replaces no TPU kernel. The JAX package, like the port until this
// kernel, builds a request's blob on the host (data/blob.py's numpy resize)
// and copies the ~10 MB f32 blob to the device. Here the decoded image
// (f32 or uint8, a third or a twelfth of those bytes) crosses instead, and
// the blob is built where the model reads it.
//
// The result equals data/blob.py's `prep_im_for_blob` + the zero pad to
// the bit, so the arithmetic is `_resize`'s, rounded where numpy rounds:
//   taps   src = (i + 0.5) / scale - 0.5 in f64; i0 = floor(src);
//          frac = (float)(src - i0); i0 < 0 → (0, frac 0);
//          i0 ≥ n - 1 → (n - 1, frac 0); i1 = min(i0 + 1, n - 1)
//   pixel  p = (float)im - mean, in f32
//   rows   r(x) = p(y0, x)·(1 − fy) + p(y1, x)·fy
//   cols   out = r(x0)·(1 − fx) + r(x1)·fx
// every product and sum rounded on its own (__fmul_rn / __fadd_rn: no FMA
// contraction).
//
// Bound: bytes, the image read once and the blob written once (480×640 f32
// → 800×1088: 3.69 + 10.44 MB, 4.2 µs at 3.35 TB/s). Each thread owns one
// 16-byte vector of a blob row (4 of the row's W·3 floats, W a multiple of
// 4, so a row is whole vectors) over kRows rows: neighbouring threads store
// neighbouring 16 bytes, every byte of the blob is stored once (the pad's
// zeros too, so the output needs no memset), and the x taps of the
// vector's two pixels are computed once for its rows. The image (≤ 4.5 MB
// in the serve pool) is read through L1 and L2, where a pixel's
// neighbouring outputs find it again.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;

struct Tap {
  int i0, i1;
  float f;
};

__device__ __forceinline__ Tap linear_tap(int i, int n_in, double scale) {
  const double src = __dsub_rn(__ddiv_rn(__dadd_rn(static_cast<double>(i), 0.5), scale), 0.5);
  const double fl = floor(src);
  Tap t;
  t.i0 = static_cast<int>(fl);
  t.f = __double2float_rn(__dsub_rn(src, fl));
  if (t.i0 < 0) {
    t.i0 = 0;
    t.f = 0.f;
  }
  if (t.i0 >= n_in - 1) {
    t.i0 = n_in - 1;
    t.f = 0.f;
  }
  t.i1 = min(t.i0 + 1, n_in - 1);
  return t;
}

__device__ __forceinline__ float value(const float* im, long long i) { return __ldg(im + i); }
__device__ __forceinline__ float value(const uint8_t* im, long long i) {
  return static_cast<float>(__ldg(im + i));
}

// a·(1 − f) + b·f, each step rounded to f32
__device__ __forceinline__ float blend(float a, float b, float f) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, f)), __fmul_rn(b, f));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
image_blob_kernel(const T* __restrict__ im, const float* __restrict__ means, double scale,
                  int h, int w, int oh, int ow, int ph, int pw, float* __restrict__ out) {
  const int vecs = pw * 3 / 4;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int groups = (ph + kRows - 1) / kRows;
  if (t >= static_cast<long long>(groups) * vecs) return;
  const int g = static_cast<int>(t / vecs);
  const int v = static_cast<int>(t - static_cast<long long>(g) * vecs);
  const int e0 = 4 * v;           // the vector's first element of the row
  const int px0 = e0 / 3;         // its elements lie on pixels px0 and px0 + 1
  const Tap tx0 = linear_tap(min(px0, ow - 1), w, scale);
  const Tap tx1 = linear_tap(min(px0 + 1, ow - 1), w, scale);
  const float m0 = __ldg(means), m1 = __ldg(means + 1), m2 = __ldg(means + 2);
  for (int r = 0; r < kRows; ++r) {
    const int y = g * kRows + r;
    if (y >= ph) break;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    if (y < oh) {
      const Tap ty = linear_tap(y, h, scale);
      const long long row0 = static_cast<long long>(ty.i0) * w;
      const long long row1 = static_cast<long long>(ty.i1) * w;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = e0 + k;
        const int px = e / 3;
        const int c = e - 3 * px;
        if (px < ow) {
          const Tap x = px == px0 ? tx0 : tx1;
          const float m = c == 0 ? m0 : (c == 1 ? m1 : m2);
          const float a0 = __fsub_rn(value(im, (row0 + x.i0) * 3 + c), m);
          const float b0 = __fsub_rn(value(im, (row1 + x.i0) * 3 + c), m);
          const float a1 = __fsub_rn(value(im, (row0 + x.i1) * 3 + c), m);
          const float b1 = __fsub_rn(value(im, (row1 + x.i1) * 3 + c), m);
          o[k] = blend(blend(a0, b0, ty.f), blend(a1, b1, ty.f), x.f);
        }
      }
    }
    *reinterpret_cast<float4*>(out + static_cast<long long>(y) * pw * 3 + e0) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace

// im: [h, w, 3] contiguous, f32 (u8 = 0) or uint8 (u8 = 1); means: [3] f32;
// out: [1, ph, pw, 3] f32, 16-byte aligned, pw a multiple of 4; the resized
// image (oh, ow) lies in its top-left corner, zeros around it.
extern "C" int rlod_image_blob(const void* im, int u8, const float* means, double scale, int h,
                               int w, int oh, int ow, int ph, int pw, float* out,
                               void* stream) {
  const long long threads = static_cast<long long>((ph + kRows - 1) / kRows) * (pw * 3 / 4);
  if (threads == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u8)
    image_blob_kernel<uint8_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(im), means, scale, h, w, oh, ow, ph, pw, out);
  else
    image_blob_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(im), means, scale, h, w, oh, ow, ph, pw, out);
  return static_cast<int>(cudaGetLastError());
}
