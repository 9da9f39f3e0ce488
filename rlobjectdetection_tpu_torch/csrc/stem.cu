// Fused ResNet stem for Hopper: conv1 (7x7, stride 2, pad 3, no bias,
// 3 -> 64) + frozen-BN mul/add + ReLU + ceil-mode 3x3/2 max-pool, one pass.
//
// Replaces the TPU kernel rlobjectdetection_tpu/ops/stem_pallas.py::fused_stem
// (_stem_kernel, and the _deinterleave layout step that fed it: this kernel
// reads the NHWC image directly and its own input-tile load does that work).
//
// What bounds it on the H100: at 800x1216 the stem is 4.58 GFLOP over an
// 11.7 MB f32 image in and 7.8 MB bf16 out: bytes, 0.0058 ms at 3.35 TB/s.
// Both versions keep what the TPU kernel bought: the unpooled 400x608x64
// activation never reaches device memory. A CTA owns a tile of pooled cells
// x 64 channels; it stages the input patch in shared memory (zeros outside
// the image, cast to the compute dtype on the way), computes the conv cells
// the pool windows need (the one-row/one-column pool halo is recomputed by
// the neighbouring tile), applies the f32 BN mul/add and ReLU, and pools
// from shared memory. Conv cells past the conv output read as 0, the pool
// identity after ReLU (as in the TPU kernel). Each output is rounded once.
//
// bf16: the conv is an im2col GEMM on the tensor cores (mma.sync m16n8k16,
// bf16 x bf16 -> f32), M = the tile's 17x17 conv cells (19 M tiles), N = 64,
// K = 7 kernel rows x 32 taps. The patch is staged as bf16 rows [IH][IWP]
// holding (pixel, channel) pairs, so the 21 taps (kx, ci) of kernel row ky
// for conv cell (cy, cx) are the 21 values from (2cy + ky) * IWP + 6cx on,
// 32-bit aligned; taps 21..31 read the next finite values of the row
// (zero-padded to IWP) against zero weights. The weights, packed [64][224]
// (tap ky * 32 + kx * 3 + ci), are staged once per persistent CTA with
// cp.async in rows padded to 232 values (a B fragment load hits 32 banks).
// A warp owns one M tile x 32 channels at a time. Conv results are rounded
// to bf16 before the max (rounding is monotonic, so max then round is the
// same), which halves their shared memory: 81,920 bytes a CTA, two CTAs an
// SM. The 34% of MACs on zero taps cost nothing here: the kernel is bound by
// its loads.
// f32 (held against the plain version at 1e-4): the FMA pipes, one thread a
// channel, weights [7][7][3][64] from device memory, 4x8 pooled cells a CTA.
#include "mma.cuh"

namespace {

constexpr int NTHREADS = 256, NWARPS = NTHREADS / 32;

namespace tcore {  // the bf16 tensor-core kernel
constexpr int TPH = 8, TPW = 8;                     // pooled cells per tile
constexpr int CH = 2 * TPH + 1, CW = 2 * TPW + 1;   // conv cells per tile (17 x 17)
constexpr int IH = 2 * CH + 5, IW = 2 * CW + 5;     // input rows / cols (39 x 39)
constexpr int NPOS = CH * CW, MT = (NPOS + 15) / 16;
constexpr int KROW = 32, K = 7 * KROW;              // taps a kernel row (21 used), all taps
constexpr int IWP = 136;                            // patch row: IW * 3 values + zeros
constexpr int LDW = K + 8, LDC = 64 + 8;            // padded weight and conv rows
constexpr int SMEM_BYTES = (64 * LDW + IH * IWP + NPOS * LDC) * 2;
static_assert(IWP >= IW * 3 && IWP >= 6 * (CW - 1) + KROW && IWP % 2 == 0,
              "a conv cell's taps stay inside its zero-padded patch row");

__global__ void __launch_bounds__(NTHREADS, 2) stem_kernel(
    const void* __restrict__ x, int x_dtype,
    const __nv_bfloat16* __restrict__ w,  // [64][K]
    const float* __restrict__ mul,        // [64]
    const float* __restrict__ add,        // [64]
    __nv_bfloat16* __restrict__ out,      // [B][PH][PW][64]
    int B, int H, int W, int OH, int OW, int PH, int PW) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][LDW]
  __nv_bfloat16* xin = ws + 64 * LDW;                                // [IH][IWP]
  __nv_bfloat16* conv = xin + IH * IWP;                              // [NPOS][LDC]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int i = tid; i < 64 * (K / 8); i += NTHREADS) {
    const int r = i / (K / 8), c = (i % (K / 8)) * 8;
    cp_async16(ws + r * LDW + c, w + r * K + c);
  }
  cp_async_commit();

  const int tiles_x = (PW + TPW - 1) / TPW;
  const int tiles_img = tiles_x * ((PH + TPH - 1) / TPH);
#pragma unroll 1
  for (int tile = blockIdx.x; tile < B * tiles_img; tile += gridDim.x) {
    const int b = tile / tiles_img, r = tile % tiles_img;
    const int py0 = (r / tiles_x) * TPH, px0 = (r % tiles_x) * TPW;
    const int cy0 = 2 * py0, cx0 = 2 * px0;          // first conv cell
    const int iy0 = 2 * cy0 - 3, ix0 = 2 * cx0 - 3;  // first input pixel
    __syncthreads();  // the last tile's GEMM and pool are done with xin and conv

    // input patch, zero outside the image (the conv's own padding) and past
    // the row's IW pixels; the cast to bf16 happens here, as the TPU
    // kernel's flatten-pad did
    for (int i = tid; i < IH * IWP; i += NTHREADS) {
      const int row = i / IWP, col = i % IWP;
      const int iy = iy0 + row, ix = ix0 + col / 3;
      float v = 0.f;
      if (col < IW * 3 && iy >= 0 && iy < H && ix >= 0 && ix < W)
        v = load_pixel(x, x_dtype, (static_cast<size_t>(b) * H + iy) * W * 3 + ix0 * 3 + col);
      xin[i] = __float2bfloat16_rn(v);
    }
    cp_async_wait_all();
    __syncthreads();

    // conv + BN + ReLU: work item (M tile, 32-channel half)
    for (int item = warp; item < 2 * MT; item += NWARPS) {
      const int m = item >> 1, n0 = (item & 1) * 32;
      int ro[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = min(m * 16 + g + 8 * h, NPOS - 1);
        ro[h] = 2 * (e / CW) * IWP + 6 * (e % CW);
      }
      float acc[4][4] = {};
#pragma unroll
      for (int ky = 0; ky < 7; ++ky)
#pragma unroll
        for (int ks = 0; ks < KROW; ks += 16) {
          FragBf16A fa;
          load_a(fa, xin + ro[0] + ky * IWP + ks, xin + ro[1] + ky * IWP + ks, t);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            FragBf16B fb;
            load_b<false>(fb, ws + (n0 + n * 8) * LDW + ky * KROW + ks, LDW, g, t);
            mma(acc[n], fa, fb);
          }
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = m * 16 + g + 8 * h;
        if (e >= NPOS) continue;
        const bool past = cy0 + e / CW >= OH || cx0 + e % CW >= OW;  // ceil-mode pool edge
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = n0 + n * 8 + 2 * t;
          const float v0 = fmaxf(acc[n][2 * h] * __ldg(mul + c) + __ldg(add + c), 0.f);
          const float v1 = fmaxf(acc[n][2 * h + 1] * __ldg(mul + c + 1) + __ldg(add + c + 1), 0.f);
          store2(conv + e * LDC + c, past ? 0.f : v0, past ? 0.f : v1);
        }
      }
    }
    __syncthreads();

    // 3x3/2 max-pool from shared memory, two channels a thread; 0 is the
    // identity after ReLU
    for (int i = tid; i < TPH * TPW * 32; i += NTHREADS) {
      const int q = i >> 5, c = 2 * (i & 31);
      const int pyl = q / TPW, pxl = q % TPW;
      const int py = py0 + pyl, px = px0 + pxl;
      if (py >= PH || px >= PW) continue;
      __nv_bfloat162 mx = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          mx = __hmax2(mx, *reinterpret_cast<const __nv_bfloat162*>(
                               conv + ((2 * pyl + dy) * CW + 2 * pxl + dx) * LDC + c));
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((static_cast<size_t>(b) * PH + py) * PW + px) * 64 + c) = mx;
    }
  }
}
}  // namespace tcore

namespace f32fma {  // the f32 kernel
constexpr int TPH = 4, TPW = 8;                     // pooled cells per block
constexpr int CH = 2 * TPH + 1, CW = 2 * TPW + 1;   // conv cells per block
constexpr int IH = 2 * CH + 5, IW = 2 * CW + 5;     // input rows / cols
constexpr int NPOS = CH * CW;
constexpr int GROUPS = NTHREADS / 64;               // 4 groups x 64 channels
constexpr int PPT = (NPOS + GROUPS - 1) / GROUPS;   // conv cells per thread
constexpr int SMEM_BYTES = (IH * IW * 3 + NPOS * 64) * sizeof(float);

__global__ void __launch_bounds__(NTHREADS) stem_kernel(
    const void* __restrict__ x, int x_dtype,
    const float* __restrict__ w,    // [7][7][3][64] (HWIO)
    const float* __restrict__ mul,  // [64]
    const float* __restrict__ add,  // [64]
    float* __restrict__ out,        // [B][PH][PW][64]
    int H, int W, int OH, int OW, int PH, int PW) {
  extern __shared__ __align__(16) float smem[];
  float* xin = smem;                 // [IH][IW][3]
  float* conv = smem + IH * IW * 3;  // [CH][CW][64]

  const int b = blockIdx.z;
  const int py0 = blockIdx.y * TPH, px0 = blockIdx.x * TPW;
  const int cy0 = 2 * py0, cx0 = 2 * px0;          // first conv cell
  const int iy0 = 2 * cy0 - 3, ix0 = 2 * cx0 - 3;  // first input pixel
  const int tid = threadIdx.x;

  for (int i = tid; i < IH * IW * 3; i += NTHREADS) {
    const int ci = i % 3, p = i / 3;
    const int iy = iy0 + p / IW, ix = ix0 + p % IW;
    float v = 0.f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = load_pixel(x, x_dtype, ((static_cast<size_t>(b) * H + iy) * W + ix) * 3 + ci);
    xin[i] = v;
  }
  __syncthreads();

  // thread (g, c) accumulates channel c of conv cells g, g+4, ...; a warp
  // shares g, so its input reads are one broadcast address
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
      const float* src = xin + ((2 * (pos / CW) + ky) * IW + 2 * (pos % CW)) * 3;
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
      float v = fmaxf(acc[p] * m + a, 0.f);
      if (cy0 + pos / CW >= OH || cx0 + pos % CW >= OW) v = 0.f;  // ceil-mode pool edge
      conv[pos * 64 + c] = v;
    }
  }
  __syncthreads();

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
    out[((static_cast<size_t>(b) * PH + py) * PW + px) * 64 + c] = mx;
  }
}
}  // namespace f32fma

cudaError_t launch_bf16(const void* x, int x_dtype, const void* w, const float* mul,
                        const float* add, void* out, int B, int H, int W, int OH, int OW,
                        int PH, int PW, cudaStream_t stream) {
  using namespace tcore;
  const int tiles = B * ((PH + TPH - 1) / TPH) * ((PW + TPW - 1) / TPW);
  int grid = 0;
  cudaError_t err = persistent_grid(stem_kernel, NTHREADS, SMEM_BYTES, tiles, &grid);
  if (err != cudaSuccess || grid == 0) return err;
  stem_kernel<<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      x, x_dtype, static_cast<const __nv_bfloat16*>(w), mul, add,
      static_cast<__nv_bfloat16*>(out), B, H, W, OH, OW, PH, PW);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* x, int x_dtype, const void* w, const float* mul,
                       const float* add, void* out, int B, int H, int W, int OH, int OW,
                       int PH, int PW, cudaStream_t stream) {
  using namespace f32fma;
  cudaError_t err =
      cudaFuncSetAttribute(stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((PW + TPW - 1) / TPW, (PH + TPH - 1) / TPH, B);
  stem_kernel<<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      x, x_dtype, static_cast<const float*>(w), mul, add, static_cast<float*>(out), H, W, OH,
      OW, PH, PW);
  return cudaGetLastError();
}

}  // namespace

// x [B][H][W][3] f32 or bf16 (x_dtype); out [B][PH][PW][64] in the compute
// dtype (out_dtype). w: bf16 [64][224] (RLOD_BF16) or f32 [7][7][3][64]
// (RLOD_F32), 16-byte aligned; mul, add f32 [64].
extern "C" int rlod_stem_fwd(const void* x, int x_dtype, const void* w, const void* mul,
                             const void* add, void* out, int out_dtype, int B, int H, int W,
                             int OH, int OW, int PH, int PW, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(mul);
  const float* af = static_cast<const float*>(add);
  cudaError_t err;
  if (out_dtype == RLOD_BF16)
    err = launch_bf16(x, x_dtype, w, mf, af, out, B, H, W, OH, OW, PH, PW, s);
  else if (out_dtype == RLOD_F32)
    err = launch_f32(x, x_dtype, w, mf, af, out, B, H, W, OH, OW, PH, PW, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Launch resources of the kernel for dtype: out[0] registers a thread,
// out[1] shared memory bytes a CTA, out[2] CTAs an SM, out[3] local (spill)
// bytes a thread.
extern "C" int rlod_stem_info(int dtype, int* out) {
  cudaError_t err;
  if (dtype == RLOD_BF16)
    err = kernel_info(tcore::stem_kernel, NTHREADS, tcore::SMEM_BYTES, out);
  else if (dtype == RLOD_F32)
    err = kernel_info(f32fma::stem_kernel, NTHREADS, f32fma::SMEM_BYTES, out);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
