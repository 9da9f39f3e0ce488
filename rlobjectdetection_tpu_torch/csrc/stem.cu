// Fused ResNet stem for Hopper: conv1 (7x7, stride 2, pad 3, no bias,
// 3 -> 64) + frozen-BN mul/add + ReLU + ceil-mode 3x3/2 max-pool, one pass.
//
// Replaces the TPU kernel rlobjectdetection_tpu/ops/stem_pallas.py::fused_stem
// (_stem_kernel, and the _deinterleave layout step that fed it: this kernel
// reads the NHWC image directly and its own input-tile load does that work).
//
// What bounds it on the H100: at 800x1216 the stem is 2.3 GMAC over an input
// of 2.9 M pixels. With only 3 input channels the contraction (K = 147) is
// too narrow for the tensor cores' shapes without padding, so this simple
// version runs it on the f32 FMA pipes, where it is bounded by the shared
// memory loads that feed the FMAs (one per FMA, broadcast across a warp).
// The design keeps what the TPU kernel bought: the unpooled 400x608x64
// activation never reaches device memory. Each block owns TPH x TPW pooled
// cells x 64 channels; it stages the (4*TPH+7) x (4*TPW+7) x 3 input patch
// in shared memory, computes the (2*TPH+1) x (2*TPW+1) conv cells the pool
// windows need (the one-row/one-column pool halo is recomputed by the
// neighbouring block), applies BN + ReLU, and pools from shared memory.
// Conv cells past the conv output read as 0, the pool identity after ReLU
// (as in the TPU kernel). A tensor-core im2col version is later work.
#include "common.cuh"

namespace {

constexpr int TPH = 4, TPW = 8;                 // pooled cells per block
constexpr int CH = 2 * TPH + 1, CW = 2 * TPW + 1;  // conv cells per block
constexpr int IH = 2 * CH + 5, IW = 2 * CW + 5;    // input rows / cols
constexpr int NPOS = CH * CW;
constexpr int NTHREADS = 256;                   // 4 groups x 64 channels
constexpr int GROUPS = NTHREADS / 64;
constexpr int PPT = (NPOS + GROUPS - 1) / GROUPS;  // conv cells per thread
constexpr int SMEM_BYTES = (IH * IW * 3 + NPOS * 64) * sizeof(float);

template <typename TOut>
__global__ void __launch_bounds__(NTHREADS) stem_kernel(
    const void* __restrict__ x, int x_dtype, int round_bf16,
    const float* __restrict__ w,    // [7][7][3][64] (HWIO), compute-dtype values
    const float* __restrict__ mul,  // [64]
    const float* __restrict__ add,  // [64]
    TOut* __restrict__ out,         // [B][PH][PW][64]
    int H, int W, int OH, int OW, int PH, int PW) {
  extern __shared__ __align__(16) float smem[];
  float* xin = smem;               // [IH][IW][3]
  float* conv = smem + IH * IW * 3;  // [CH][CW][64]

  const int b = blockIdx.z;
  const int py0 = blockIdx.y * TPH, px0 = blockIdx.x * TPW;
  const int cy0 = 2 * py0, cx0 = 2 * px0;          // first conv cell
  const int iy0 = 2 * cy0 - 3, ix0 = 2 * cx0 - 3;  // first input pixel
  const int tid = threadIdx.x;

  // input patch, zero outside the image (the conv's own padding); the cast
  // to the compute dtype happens here, as the TPU kernel's flatten-pad did
  for (int i = tid; i < IH * IW * 3; i += NTHREADS) {
    const int ci = i % 3, t = i / 3;
    const int iy = iy0 + t / IW, ix = ix0 + t % IW;
    float v = 0.f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
      v = load_pixel(x, x_dtype, ((static_cast<size_t>(b) * H + iy) * W + ix) * 3 + ci);
      if (round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
    }
    xin[i] = v;
  }
  __syncthreads();

  // conv: thread (g, c) accumulates channel c of conv cells g, g+4, ...
  // A warp shares g, so its input reads are one broadcast address.
  const int c = tid & 63, g = tid / 64;
  float acc[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) acc[p] = 0.f;
  for (int ky = 0; ky < 7; ++ky) {
    float wr[21];  // taps (kx, ci) of row ky for channel c
#pragma unroll
    for (int k = 0; k < 21; ++k) wr[k] = __ldg(&w[(ky * 21 + k) * 64 + c]);
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int pos = min(g + GROUPS * p, NPOS - 1);
      const int cyl = pos / CW, cxl = pos % CW;
      const float* src = xin + ((2 * cyl + ky) * IW + 2 * cxl) * 3;
      float s = acc[p];
#pragma unroll
      for (int k = 0; k < 21; ++k) s = fmaf(wr[k], src[k], s);
      acc[p] = s;
    }
  }

  const float m = mul[c], a = add[c];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int pos = g + GROUPS * p;
    if (pos < NPOS) {
      const int cyl = pos / CW, cxl = pos % CW;
      float v = fmaxf(acc[p] * m + a, 0.f);
      if (cy0 + cyl >= OH || cx0 + cxl >= OW) v = 0.f;  // ceil-mode pool edge
      conv[pos * 64 + c] = v;
    }
  }
  __syncthreads();

  // 3x3/2 max-pool from shared memory; 0 is the identity after ReLU
  for (int q = g; q < TPH * TPW; q += GROUPS) {
    const int pyl = q / TPW, pxl = q % TPW;
    const int py = py0 + pyl, px = px0 + pxl;
    if (py >= PH || px >= PW) continue;
    float mx = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        mx = fmaxf(mx, conv[((2 * pyl + dy) * CW + 2 * pxl + dx) * 64 + c]);
    out[((static_cast<size_t>(b) * PH + py) * PW + px) * 64 + c] = from_f<TOut>(mx);
  }
}

template <typename TOut>
cudaError_t launch(const void* x, int x_dtype, int round_bf16, const float* w,
                   const float* mul, const float* add, void* out, int B, int H,
                   int W, int OH, int OW, int PH, int PW, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel<TOut>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((PW + TPW - 1) / TPW, (PH + TPH - 1) / TPH, B);
  stem_kernel<TOut><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      x, x_dtype, round_bf16, w, mul, add, static_cast<TOut*>(out), H, W, OH, OW, PH, PW);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rlod_stem_fwd(const void* x, int x_dtype, int round_bf16,
                             const void* w, const void* mul, const void* add,
                             void* out, int out_dtype, int B, int H, int W,
                             int OH, int OW, int PH, int PW, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* mf = static_cast<const float*>(mul);
  const float* af = static_cast<const float*>(add);
  cudaError_t err;
  if (out_dtype == RLOD_F32)
    err = launch<float>(x, x_dtype, round_bf16, wf, mf, af, out, B, H, W, OH, OW, PH, PW, s);
  else
    err = launch<__nv_bfloat16>(x, x_dtype, round_bf16, wf, mf, af, out, B, H, W, OH, OW, PH, PW, s);
  return static_cast<int>(err);
}
