// Fused VGG-16 block 1 for Hopper: conv1_1 (3x3, pad 1, 3 -> 64, bias) +
// ReLU + conv1_2 (3x3, pad 1, 64 -> 64, bias) + ReLU + 2x2/2 max-pool, one
// pass. conv1_2's zero padding is literal: a conv1_1 output outside the
// image is 0, not relu(b1).
//
// Replaces the TPU kernel rlobjectdetection_tpu/ops/vgg_stem_pallas.py::
// fused_vgg_block1 (_block1_kernel, and the _deinterleave layout step that
// fed it: this kernel reads the NHWC image directly and its own input-tile
// load does that work). The TPU kernel's channel-on-sublane layout, its
// double-buffered row-window DMA and its selection matmul for the stride-2
// compaction have no reason here and are not carried over.
//
// What bounds it on the H100: at 800x1216 the block is 75 GFLOP (96% of it
// conv1_2, K = 576) over 11.7 MB in and 31 MB out, so it is bound by
// operations. What the design keeps from the TPU kernel is the fusion: the
// two full-resolution 64-channel activations never reach device memory.
// Each block owns 8x8 pooled cells x 64 channels. It stages the 20x20x3
// input patch in shared memory (cast to the compute dtype on load), computes
// the 18x18 conv1_1 outputs the tile needs into shared memory (a one-pixel
// halo recomputed by the neighbours; f32 FMAs, K = 27 is too narrow to pay
// for tensor-core fragments), rounded to the compute dtype, then conv1_2 +
// bias + ReLU + the 2x2 max in registers:
//  - bf16: an implicit GEMM on the tensor cores (mma.sync m16n8k16, f32
//    sums). Warp w owns conv rows 2w and 2w+1 (two 16-pixel M tiles) x 64
//    channels (eight 8-wide N tiles); A fragments come from the conv1_1 tile
//    in shared memory (rows padded so the 32 lanes hit 32 banks), B
//    fragments are pre-packed by the wrapper so each lane reads one 8-byte
//    word. The vertical max pairs the warp's two rows, the horizontal one a
//    lane shuffle.
//  - f32 (held against the plain version at 1e-4): the same tile on the f32
//    FMA pipes; each thread owns two pool windows x 8 channels.
// Later work: conv1_1 on the tensor cores, wgmma/TMA for conv1_2.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int TP = 8;            // pooled cells per block side
constexpr int CT = 2 * TP;       // conv1_2 outputs per side (16)
constexpr int ET = CT + 2;       // conv1_1 outputs per side (18)
constexpr int IT = ET + 2;       // input pixels per side (20)
constexpr int NE = ET * ET;      // conv1_1 outputs per block
constexpr int NTHREADS = 256;    // 8 warps
constexpr int XIN_BYTES = IT * IT * 3 * sizeof(float);  // a multiple of 16

// padded conv1_1 row: 16-byte aligned, and its banks shift from row to row
template <typename T>
__host__ __device__ constexpr int row_stride() {
  return 64 + 16 / static_cast<int>(sizeof(T));
}

template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return XIN_BYTES + NE * row_stride<T>() * static_cast<int>(sizeof(T));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// conv1_2 + b2 + ReLU + 2x2 max on the tensor cores. y1: [NE][LDA] bf16;
// w2p: B fragments [36 k-steps][8 N tiles][32 lanes] x 4 bf16, where k-step
// s covers tap s / 4 and input channels 16 * (s % 4) .. +15 (ops/
// vgg_block1_kernel.py::pack_w2 builds it).
__device__ __forceinline__ void conv12_mma(const __nv_bfloat16* y1, const uint2* w2p,
                                           const float* b2, __nv_bfloat16* out, int b,
                                           int py0, int px0, int PH, int PW) {
  constexpr int LDA = row_stride<__nv_bfloat16>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  const uint2* wl = w2p + lane;
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    // A row g of M tile m is conv pixel (2 * warp + m, g); at this tap it
    // reads conv1_1 output (2 * warp + m + ky, g + kx), and row g + 8 the
    // output 8 columns further on
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint2 bf[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) bf[j] = __ldg(wl + ((tap * 4 + kk) * 8 + j) * 32);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const __nv_bfloat16* pa =
            y1 + ((2 * warp + m + ky) * ET + g + kx) * LDA + kk * 16 + 2 * t;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(pa);
        a[1] = *reinterpret_cast<const uint32_t*>(pa + 8 * LDA);
        a[2] = *reinterpret_cast<const uint32_t*>(pa + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(pa + 8 * LDA + 8);
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_bf16(acc[m][j], a, bf[j]);
      }
    }
  }

  // accumulator e of N tile j: conv pixel column g (e < 2) or g + 8, channel
  // 8j + 2t + (e & 1). Rows 2w and 2w+1 pair in the thread; columns g and
  // g + 1 pair across lanes lane and lane ^ 4.
  const int py = py0 + warp;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float bias = __ldg(b2 + j * 8 + 2 * t + (e & 1));
      v[e] = fmaxf(fmaxf(acc[0][j][e] + bias, 0.f), fmaxf(acc[1][j][e] + bias, 0.f));
      v[e] = fmaxf(v[e], __shfl_xor_sync(0xffffffffu, v[e], 4));
    }
    if ((g & 1) || py >= PH) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int px = px0 + 4 * half + (g >> 1);
      if (px >= PW) continue;
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((static_cast<size_t>(b) * PH + py) * PW + px) * 64 + j * 8 + 2 * t) =
          __floats2bfloat162_rn(v[2 * half], v[2 * half + 1]);
    }
  }
}

// conv1_2 + b2 + ReLU + 2x2 max on the f32 FMA pipes. y1: [NE][LDA] f32;
// w2: [9][64][64] (tap, ci, co). Thread (tm, tn) owns pool windows tm and
// tm + 32 of the 8x8 tile, channels 8 tn .. 8 tn + 7.
__device__ __forceinline__ void conv12_fma(const float* y1, const float* w2,
                                           const float* b2, float* out, int b,
                                           int py0, int px0, int PH, int PW) {
  constexpr int LDA = row_stride<float>();
  const int tn = threadIdx.x & 7, tm = threadIdx.x >> 3;
  float acc[2][4][8];
  int pos[2][4];  // conv1_1 position each window pixel reads at tap (0, 0)
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int cell = tm + 32 * q, qy = cell / TP, qx = cell % TP;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      pos[q][d] = (2 * qy + (d >> 1)) * ET + 2 * qx + (d & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[q][d][j] = 0.f;
    }
  }
  for (int tap = 0; tap < 9; ++tap) {
    const int off = (tap / 3) * ET + tap % 3;
    const float* wt = w2 + tap * 64 * 64 + tn * 8;
#pragma unroll 4
    for (int k = 0; k < 64; ++k) {
      float wv[8];
      ldg8(wt + k * 64, wv);
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const float a = y1[(pos[q][d] + off) * LDA + k];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[q][d][j] = fmaf(a, wv[j], acc[q][d][j]);
        }
    }
  }
  float bias[8];
  load8(b2 + tn * 8, bias);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int cell = tm + 32 * q;
    const int py = py0 + cell / TP, px = px0 + cell % TP;
    if (py >= PH || px >= PW) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = 0.f;  // the max of ReLU outputs
#pragma unroll
      for (int d = 0; d < 4; ++d) v[j] = fmaxf(v[j], acc[q][d][j] + bias[j]);
    }
    store8(out + ((static_cast<size_t>(b) * PH + py) * PW + px) * 64 + tn * 8, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 2) vgg_block1_kernel(
    const void* __restrict__ x, int x_dtype,
    const float* __restrict__ w1,  // [27][64]: tap (ky*3 + kx)*3 + ci, co; T-exact values
    const float* __restrict__ b1,  // [64]
    const void* __restrict__ w2,   // bf16: packed B fragments; f32: [9][64][64]
    const float* __restrict__ b2,  // [64]
    T* __restrict__ out,           // [B][H/2][W/2][64]
    int H, int W) {
  constexpr int LDA = row_stride<T>();
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xin = reinterpret_cast<float*>(smem_raw);       // [IT][IT][3]
  T* y1 = reinterpret_cast<T*>(smem_raw + XIN_BYTES);    // [NE][LDA]

  const int b = blockIdx.z, tid = threadIdx.x;
  const int PH = H / 2, PW = W / 2;
  const int py0 = blockIdx.y * TP, px0 = blockIdx.x * TP;
  const int cy0 = 2 * py0, cx0 = 2 * px0;  // first conv1_2 output of the tile
  // xin (0, 0) is image pixel (cy0 - 2, cx0 - 2); y1 (0, 0) is conv1_1
  // output (cy0 - 1, cx0 - 1)

  // 1. input patch, zero outside the image (conv1_1's own padding), rounded
  // to the compute dtype as the TPU kernel's flatten-pad did
  for (int i = tid; i < IT * IT * 3; i += NTHREADS) {
    const int ci = i % 3, p = i / 3;
    const int iy = cy0 - 2 + p / IT, ix = cx0 - 2 + p % IT;
    float v = 0.f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
      v = load_pixel(x, x_dtype, ((static_cast<size_t>(b) * H + iy) * W + ix) * 3 + ci);
      if (kBf16) v = __bfloat162float(__float2bfloat16_rn(v));
    }
    xin[i] = v;
  }
  __syncthreads();

  // 2. conv1_1 + b1 + ReLU over the 18x18 extent, rounded to T; outputs
  // outside the image are conv1_2's zero padding
  {
    const int tn = tid & 7, tm = tid >> 3;  // 8 channels x positions tm + 32i
    float bias[8];
    load8(b1 + tn * 8, bias);
    for (int e0 = 0; e0 < NE; e0 += 128) {
      float acc[4][8];
      int base[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = min(e0 + tm + 32 * i, NE - 1);
        base[i] = ((e / ET) * IT + e % ET) * 3;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < 27; ++k) {
        const int off = ((k / 9) * IT + (k / 3) % 3) * 3 + k % 3;  // (ky, kx, ci)
        float wv[8];
        ldg8(w1 + k * 64 + tn * 8, wv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = xin[base[i] + off];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = e0 + tm + 32 * i;
        if (e >= NE) continue;
        const int gy = cy0 - 1 + e / ET, gx = cx0 - 1 + e % ET;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = inside ? fmaxf(acc[i][j] + bias[j], 0.f) : 0.f;
        store8(y1 + e * LDA + tn * 8, v);
      }
    }
  }
  __syncthreads();

  // 3. conv1_2 + b2 + ReLU + 2x2/2 max → device memory
  if constexpr (kBf16)
    conv12_mma(y1, static_cast<const uint2*>(w2), b2, out, b, py0, px0, PH, PW);
  else
    conv12_fma(y1, static_cast<const float*>(w2), b2, out, b, py0, px0, PH, PW);
}

template <typename T>
cudaError_t launch(const void* x, int x_dtype, const float* w1, const float* b1,
                   const void* w2, const float* b2, void* out, int B, int H, int W,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      vgg_block1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W / 2 + TP - 1) / TP, (H / 2 + TP - 1) / TP, B);
  vgg_block1_kernel<T><<<grid, NTHREADS, smem, stream>>>(
      x, x_dtype, w1, b1, w2, b2, static_cast<T*>(out), H, W);
  return cudaGetLastError();
}

}  // namespace

// x [B][H][W][3] f32 or bf16 (x_dtype), H and W even; dtype (RLOD_F32 or
// RLOD_BF16) is the compute and output type. w1 [27][64] and the biases are
// f32; w2 is [9][64][64] f32, or the packed bf16 B fragments for bf16.
extern "C" int rlod_vgg_block1_fwd(const void* x, int x_dtype, const void* w1,
                                   const void* b1, const void* w2, const void* b2,
                                   void* out, int dtype, int B, int H, int W,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  cudaError_t err;
  if (dtype == RLOD_F32)
    err = launch<float>(x, x_dtype, w1f, b1f, w2, b2f, out, B, H, W, s);
  else if (dtype == RLOD_BF16)
    err = launch<__nv_bfloat16>(x, x_dtype, w1f, b1f, w2, b2f, out, B, H, W, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
