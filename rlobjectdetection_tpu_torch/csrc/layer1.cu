// ResNet layer1 bottleneck for Hopper: one launch computes one frozen
// Bottleneck(64) at stride 1 with BN folded into the weights,
//   relu(conv3(relu(conv2(relu(conv1(x) + b1)) + b2)) + b3 + shortcut(x)),
// where the shortcut is x itself, or for block0 the folded 1x1 downsample.
// Three launches (block0 64 -> 256, block1 and block2 256 -> 256) make the
// stage.
//
// Replaces the TPU kernel rlobjectdetection_tpu/ops/layer1_pallas.py::
// fused_layer1 (_l1_kernel), which runs all three blocks in one kernel over
// row bands with a 3-row halo.
//
// What bounds it on the H100: at 200x304 the stage is 13 GMAC over 7.8 MB of
// input and 31 MB of output (bf16), so it is bound by operations. This simple
// version runs the products on the f32 FMA pipes with register tiles (each
// thread owns a strip of pixels x 8 output channels, weights read as 16-byte
// vectors, activations broadcast from shared memory), well below the tensor
// cores' rate. What the design keeps from the TPU kernel is the fusion inside
// a block: each block owns an 8x8 output tile, stages the 10x10 input tile
// (one-pixel halo, recomputed by the neighbours) in shared memory, and keeps
// the conv1 and conv2 activations in shared memory, so per block only the
// input and the 256-channel output cross device memory. Intermediates are
// rounded to the storage type, as the JAX path rounds them to the compute
// dtype; accumulation is f32.
//
// Later work: tensor-core products (mma.sync / wgmma on bf16 fragments), and
// folding the three blocks into one launch with a 3-pixel halo as the TPU
// kernel does, which keeps the 256-channel block outputs on chip too.
#include "common.cuh"

namespace {

constexpr int TH = 8, TW = 8;              // output tile
constexpr int EH = TH + 2, EW = TW + 2;    // conv1 extent (3x3 halo)
constexpr int NE = EH * EW, NP = TH * TW;
constexpr int NTHREADS = 256;
constexpr int WIDTH = 64, COUT = 256;      // planes, planes * 4

template <typename T, int CIN>
constexpr int smem_bytes() {
  return (NE * (CIN + 16 / static_cast<int>(sizeof(T))) +
          (NE + NP) * (WIDTH + 16 / static_cast<int>(sizeof(T)))) *
         static_cast<int>(sizeof(T));
}

template <typename T, int CIN, bool DOWN>
__global__ void __launch_bounds__(NTHREADS, 2) bottleneck_kernel(
    const T* __restrict__ x,      // [B][H][W][CIN]
    const T* __restrict__ w1,     // [CIN][64]
    const float* __restrict__ b1, // [64]
    const T* __restrict__ w2,     // [9][64][64]  (tap dy*3+dx, ci, co)
    const float* __restrict__ b2, // [64]
    const T* __restrict__ w3,     // [64][256]
    const float* __restrict__ b3, // [256] (plus the downsample BN add for block0)
    const T* __restrict__ wd,     // [CIN][256] (block0 only)
    T* __restrict__ out,          // [B][H][W][256]
    int H, int W) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LDX = CIN + VEC;    // padded row strides: 16-byte aligned rows
  constexpr int LDA = WIDTH + VEC;  // whose banks shift from row to row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [NE][LDX] input tile with halo
  T* a1 = xs + NE * LDX;                   // [NE][LDA] conv1 output
  T* a2 = a1 + NE * LDA;                   // [NP][LDA] conv2 output

  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;

  // 1. input tile (rows y0-1 .. y0+TH, cols x0-1 .. x0+TW), zeros outside
  constexpr int CHUNKS = CIN / VEC;
  for (int i = tid; i < NE * CHUNKS; i += NTHREADS) {
    const int e = i / CHUNKS, ch = i % CHUNKS;
    const int gy = y0 - 1 + e / EW, gx = x0 - 1 + e % EW;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = __ldg(reinterpret_cast<const uint4*>(
          x + ((static_cast<size_t>(b) * H + gy) * W + gx) * CIN + ch * VEC));
    *reinterpret_cast<uint4*>(xs + e * LDX + ch * VEC) = v;
  }
  __syncthreads();

  // 2. conv1 (1x1, CIN -> 64) + b1 + ReLU over the 10x10 extent; pixels
  // outside the image become the 3x3 conv's zero padding
  {
    const int tn = tid & 7, tm = tid >> 3;  // 8 channels x pixels tm + 32i
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    int e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = min(tm + 32 * i, NE - 1);
    for (int k = 0; k < CIN; ++k) {
      float wv[8];
      ldg8(w1 + k * WIDTH + tn * 8, wv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = to_f(xs[e[i] * LDX + k]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
      }
    }
    float bias[8];
    load8(b1 + tn * 8, bias);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ei = tm + 32 * i;
      if (ei >= NE) continue;
      const int gy = y0 - 1 + ei / EW, gx = x0 - 1 + ei % EW;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = inside ? fmaxf(acc[i][j] + bias[j], 0.f) : 0.f;
      store8(a1 + ei * LDA + tn * 8, v);
    }
  }
  __syncthreads();

  // 3. conv2 (3x3, 64 -> 64) + b2 + ReLU over the 8x8 tile
  {
    const int tn = tid & 7, tm = tid >> 3;  // 8 channels x pixels tm, tm + 32
    float acc[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const int e0 = ((tm >> 3) + dy) * EW + (tm & 7) + dx;
      const int e1 = e0 + 4 * EW;  // pixel tm + 32 is four rows further down
      const T* wt = w2 + tap * WIDTH * WIDTH + tn * 8;
      for (int k = 0; k < WIDTH; ++k) {
        float wv[8];
        ldg8(wt + k * WIDTH, wv);
        const float a0 = to_f(a1[e0 * LDA + k]);
        const float a1v = to_f(a1[e1 * LDA + k]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[0][j] = fmaf(a0, wv[j], acc[0][j]);
          acc[1][j] = fmaf(a1v, wv[j], acc[1][j]);
        }
      }
    }
    float bias[8];
    load8(b2 + tn * 8, bias);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = fmaxf(acc[i][j] + bias[j], 0.f);
      store8(a2 + (tm + 32 * i) * LDA + tn * 8, v);
    }
  }
  __syncthreads();

  // 4. conv3 (1x1, 64 -> 256) + b3 + shortcut + ReLU → device memory
  {
    const int tn = tid & 31, tm = tid >> 5;  // 8 channels x pixels tm + 8i
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < WIDTH; ++k) {
      float wv[8];
      ldg8(w3 + k * COUT + tn * 8, wv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = to_f(a2[(tm + 8 * i) * LDA + k]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
      }
    }
    // the tile pixel p = tm + 8i sits at (p / 8 + 1, p % 8 + 1) of the extent
    if (DOWN) {
      for (int k = 0; k < CIN; ++k) {
        float wv[8];
        ldg8(wd + k * COUT + tn * 8, wv);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int p = tm + 8 * i;
          const float a = to_f(xs[((p >> 3) + 1) * EW * LDX + ((p & 7) + 1) * LDX + k]);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
        }
      }
    }
    float bias[8];
    load8(b3 + tn * 8, bias);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = tm + 8 * i;
      const int gy = y0 + (p >> 3), gx = x0 + (p & 7);
      if (gy >= H || gx >= W) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = acc[i][j] + bias[j];
      if (!DOWN) {
        float sc[8];
        load8(xs + ((p >> 3) + 1) * EW * LDX + ((p & 7) + 1) * LDX + tn * 8, sc);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] += sc[j];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = fmaxf(v[j], 0.f);
      store8(out + ((static_cast<size_t>(b) * H + gy) * W + gx) * COUT + tn * 8, v);
    }
  }
}

template <typename T, int CIN, bool DOWN>
cudaError_t launch(const void* x, const void* w1, const float* b1, const void* w2,
                   const float* b2, const void* w3, const float* b3, const void* wd,
                   void* out, int B, int H, int W, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, CIN>();
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel<T, CIN, DOWN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  bottleneck_kernel<T, CIN, DOWN><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, static_cast<const T*>(w2),
      b2, static_cast<const T*>(w3), b3, static_cast<const T*>(wd), static_cast<T*>(out),
      H, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int cin, const void* x, const void* w1, const float* b1,
                     const void* w2, const float* b2, const void* w3, const float* b3,
                     const void* wd, void* out, int B, int H, int W, cudaStream_t s) {
  if (cin == 64 && wd != nullptr)
    return launch<T, 64, true>(x, w1, b1, w2, b2, w3, b3, wd, out, B, H, W, s);
  if (cin == 256 && wd == nullptr)
    return launch<T, 256, false>(x, w1, b1, w2, b2, w3, b3, wd, out, B, H, W, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// One bottleneck of layer1. cin 64 with a downsample (block0) or cin 256
// with the identity shortcut (block1, block2); dtype RLOD_F32 or RLOD_BF16
// for activations and weights alike. Biases are f32.
extern "C" int rlod_layer1_block(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* w3,
                                 const void* b3, const void* wd, void* out, int B,
                                 int H, int W, int cin, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  const float* b3f = static_cast<const float*>(b3);
  cudaError_t err;
  if (dtype == RLOD_F32)
    err = dispatch<float>(cin, x, w1, b1f, w2, b2f, w3, b3f, wd, out, B, H, W, s);
  else if (dtype == RLOD_BF16)
    err = dispatch<__nv_bfloat16>(cin, x, w1, b1f, w2, b2f, w3, b3f, wd, out, B, H, W, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
