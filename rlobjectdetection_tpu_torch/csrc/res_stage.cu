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
// 198 GFLOP, 0.2 ms at the bf16 tensor-core peak). The design, a simple one:
//  - a CTA owns 8x8 output positions x all channels;
//  - conv1 over the 10x10 extent (a one-pixel halo, recomputed by the
//    neighbours) into shared memory T1, rounded to the storage type;
//    positions outside the image are stored as literal zeros, which is
//    conv2's zero padding (relu(b1) there would be wrong);
//  - conv2 as nine shifted GEMMs from T1 into T2 (rounded);
//  - conv3 (+ the downsample for block0) + b3 + shortcut + ReLU to device
//    memory, 256 output channels per pass.
// Products are implicit GEMMs over mma.sync fragments. bf16: m16n8k16 on
// the tensor cores with f32 sums; A fragments come from T1/T2 in shared
// memory or, for conv1 and the downsample, from x in device memory (through
// L1), B fragments straight from the weights, packed [N][K] (output
// channel, input channel) so a lane reads two 4-byte words. Each warp owns
// W/8 (conv1, conv2) or 32 (a conv3 pass) output channels and all rows.
// f32 (held against the plain version at 1e-4): the same warp and fragment
// ownership on the FMA pipes, k steps of 4. The fragments and the GEMM
// helper are mma.cuh's, shared with layer1.cu.
// Later work: wgmma/TMA with weights staged through shared memory, more
// CTAs per image at batch 1 (layer3 has 70 tiles for 132 SMs).
#include "mma.cuh"

namespace {

constexpr int TH = 8, TW = 8;                 // output tile
constexpr int EH = TH + 2, EW = TW + 2;       // conv1 extent (3x3 halo)
constexpr int NE = EH * EW, NP = TH * TW;     // 100, 64
constexpr int NTHREADS = 256, NWARPS = NTHREADS / 32;
constexpr int MT1 = (NE + 15) / 16;           // 16-row M tiles over the extent (7)
constexpr int MT = NP / 16;                   // 16-row M tiles over the tile (4)
constexpr int N3 = 256;                       // conv3 output channels per pass
constexpr int NT3 = N3 / (8 * NWARPS);        // 8-wide N tiles of a warp per pass (4)

// padded shared-memory row: 16-byte aligned, and its banks shift from row
// to row (bf16 at W = 256: 132 words, so the 8 rows x 4 words of a fragment
// load hit 32 banks)
template <typename T, int W>
__host__ __device__ constexpr int row_stride() {
  return W + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int W>
__host__ __device__ constexpr int smem_bytes() {
  return (NE + NP) * row_stride<T, W>() * static_cast<int>(sizeof(T));
}

template <typename T, int W, bool DOWN>
__global__ void __launch_bounds__(NTHREADS, 1) bottleneck_kernel(
    const T* __restrict__ x,       // [B][H][Wd][cin]
    const T* __restrict__ w1,      // [W][cin]
    const float* __restrict__ b1,  // [W]
    const T* __restrict__ w2,      // [9][W][W]  (tap dy*3+dx, co, ci)
    const float* __restrict__ b2,  // [W]
    const T* __restrict__ w3,      // [4W][W]
    const float* __restrict__ b3,  // [4W] (plus the downsample BN add for block0)
    const T* __restrict__ wd,      // [4W][cin] (block0 only)
    T* __restrict__ out,           // [B][H][Wd][4W]
    int H, int Wd, int cin) {
  constexpr int LDT = row_stride<T, W>();
  constexpr int NT = W / (8 * NWARPS);  // 8-wide N tiles of a warp in conv1, conv2
  constexpr int C4 = 4 * W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* t1 = reinterpret_cast<T*>(smem_raw);  // [NE][LDT] conv1 output over the extent
  T* t2 = t1 + NE * LDT;                   // [NP][LDT] conv2 output over the tile

  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* xb = x + static_cast<size_t>(b) * H * Wd * cin;

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
    gemm<true, T, MT1, NT>(acc, xb, ro, w1 + static_cast<size_t>(n0) * cin, cin, cin, g, t);
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
      gemm<true, T, MT, NT>(acc, t1, ro, w2 + (static_cast<size_t>(tap) * W + n0) * W, W, W, g, t);
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
      gemm<true, T, MT, NT3>(acc, t2, ro, w3 + static_cast<size_t>(n0) * W, W, W, g, t);
      if (DOWN)
        gemm<true, T, MT, NT3>(acc, xb, rx, wd + static_cast<size_t>(n0) * cin, cin, cin, g, t);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = m * 16 + g + 8 * h;
          const int gy = y0 + p / TW, gx = x0 + p % TW;
          if (gy >= H || gx >= Wd) continue;
          T* o = out + ((static_cast<size_t>(b) * H + gy) * Wd + gx) * C4;
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

template <typename T, int W, bool DOWN>
cudaError_t launch(const void* x, const void* w1, const float* b1, const void* w2,
                   const float* b2, const void* w3, const float* b3, const void* wd, void* out,
                   int B, int H, int Wd, int cin, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, W>();
  cudaError_t err = cudaFuncSetAttribute(bottleneck_kernel<T, W, DOWN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Wd + TW - 1) / TW, (H + TH - 1) / TH, B);
  bottleneck_kernel<T, W, DOWN><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2,
      static_cast<const T*>(w3), b3, static_cast<const T*>(wd), static_cast<T*>(out), H, Wd,
      cin);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int width, const void* x, const void* w1, const float* b1, const void* w2,
                     const float* b2, const void* w3, const float* b3, const void* wd, void* out,
                     int B, int H, int Wd, int cin, cudaStream_t s) {
  const bool down = wd != nullptr;
  if (cin % 16 != 0 || (!down && cin != 4 * width)) return cudaErrorInvalidValue;
  if (width == 128)
    return down ? launch<T, 128, true>(x, w1, b1, w2, b2, w3, b3, wd, out, B, H, Wd, cin, s)
                : launch<T, 128, false>(x, w1, b1, w2, b2, w3, b3, wd, out, B, H, Wd, cin, s);
  if (width == 256)
    return down ? launch<T, 256, true>(x, w1, b1, w2, b2, w3, b3, wd, out, B, H, Wd, cin, s)
                : launch<T, 256, false>(x, w1, b1, w2, b2, w3, b3, wd, out, B, H, Wd, cin, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// One bottleneck of a residual stage: width 128 (layer2) or 256 (layer3);
// cin a multiple of 16 with a downsample (wd, block0) or 4 * width with the
// identity shortcut (wd null). dtype RLOD_F32 or RLOD_BF16 for activations
// and weights alike; biases are f32. Weights are [N][K]: w1 [W][cin], w2
// [9][W][W] (tap, co, ci), w3 [4W][W], wd [4W][cin].
extern "C" int rlod_res_stage_block(const void* x, const void* w1, const void* b1,
                                    const void* w2, const void* b2, const void* w3,
                                    const void* b3, const void* wd, void* out, int B, int H,
                                    int Wd, int cin, int width, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  const float* b3f = static_cast<const float*>(b3);
  cudaError_t err;
  if (dtype == RLOD_F32)
    err = dispatch<float>(width, x, w1, b1f, w2, b2f, w3, b3f, wd, out, B, H, Wd, cin, s);
  else if (dtype == RLOD_BF16)
    err = dispatch<__nv_bfloat16>(width, x, w1, b1f, w2, b2f, w3, b3f, wd, out, B, H, Wd, cin,
                                  s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
