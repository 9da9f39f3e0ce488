// ResNet layer1 bottleneck for Hopper: one launch computes one frozen
// Bottleneck(64) at stride 1 with BN folded into the weights,
//   relu(conv3(relu(conv2(relu(conv1(x) + b1)) + b2)) + b3 + shortcut(x)),
// where the shortcut is x itself, or for block0 the folded 1x1 downsample
// (its sum stays in f32 until the block's one rounding). Three launches
// (block0 64 -> 256, block1 and block2 256 -> 256) make the stage.
//
// Replaces the TPU kernel rlobjectdetection_tpu/ops/layer1_pallas.py::
// fused_layer1 (_l1_kernel), which runs all three blocks in one kernel over
// row bands with a 3-row halo. Here the blocks stay separate launches: at
// 8x8 tiles a 3-block halo recomputes about 1.6x the MACs to save 4 x 31 MB
// of block-output traffic per image, and this kernel is bound by operations.
//
// What bounds it on the H100: at 200x304 the stage is 25.9 GFLOP over 7.8 MB
// of input, 31 MB of output and 0.4 MB of weights (bf16): operations, 0.026
// ms at the bf16 tensor-core peak. The design:
//  - persistent CTAs, as many as the card holds at once, each walking over
//    8x8 output tiles of all images (tile, tile + gridDim.x, ...);
//  - bf16: each CTA stages the block's packed weights in shared memory once,
//    with cp.async, rows padded by 16 bytes so a B fragment load hits 32
//    banks: block0 w1 9 KB + w2 81 KB + w3 36 KB + wd 36 KB, blocks 1-2
//    w1 33 KB + w2 81 KB + w3 36 KB. f32 reads them from device memory
//    (twice the bytes would not fit);
//  - the 10x10 x cin input tile (one-pixel halo, recomputed by the
//    neighbours; pixels outside the image clamped, their conv1 results
//    dropped) comes in by cp.async. The next tile's is prefetched while the
//    current one computes: into a second buffer where the budget allows
//    (block0, cin 64), else into the same buffer once conv1 has read it
//    (blocks 1-2, cin 256, whose identity shortcut is then read from device
//    memory, where the tile was just fetched);
//  - conv1 over the 10x10 extent into shared memory T1, rounded to the
//    storage type; positions outside the image are stored as literal zeros,
//    conv2's padding (relu(b1) there would be wrong);
//  - conv2 as nine shifted GEMMs from T1 into T2 (rounded);
//  - conv3 (+ the downsample from the input tile for block0) + b3 +
//    shortcut + ReLU to device memory, all 256 channels in one pass.
// Products are mma.cuh's implicit GEMMs: bf16 m16n8k16 mma.sync on the
// tensor cores with f32 sums; f32 (held against the plain version at 1e-4)
// on the FMA pipes with the same warp and fragment ownership. Each warp owns
// 8 output channels of conv1 and conv2 and 32 of conv3, over all rows.
// Shared memory a CTA (bf16): block0 218,304 bytes, blocks 1-2 230,016; one
// CTA an SM. Registers and spills: chip_smoke.py prints what the runtime
// reports for each instantiation.
#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int TH = 8, TW = 8;                 // output tile
constexpr int EH = TH + 2, EW = TW + 2;       // conv1 extent (3x3 halo)
constexpr int NE = EH * EW, NP = TH * TW;     // 100, 64
constexpr int NTHREADS = 256, NWARPS = NTHREADS / 32;
constexpr int WIDTH = 64, C4 = 256;           // planes, planes * 4
constexpr int MT1 = (NE + 15) / 16;           // 16-row M tiles over the extent (7)
constexpr int MT = NP / 16;                   // 16-row M tiles over the tile (4)
constexpr int NT3 = C4 / (8 * NWARPS);        // 8-wide conv3 N tiles of a warp (4)
static_assert(WIDTH == 8 * NWARPS, "a warp owns one 8-wide N tile of conv1 and conv2");

// Shared-memory plan of one instantiation, in elements of T. Rows are
// padded by 16 bytes: 16-byte aligned, and their banks shift from row to
// row (bf16 rows of 72 and 264 values are 36 and 132 words).
template <typename T, int CIN, bool DOWN>
struct Plan {
  static constexpr bool STAGE_W = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int NBUF = DOWN ? 2 : 1;    // input-tile buffers
  static constexpr int LDX = CIN + VEC, LDA = WIDTH + VEC;
  // B row strides: the padded rows when staged, the packed [N][K] rows else
  static constexpr int LD1 = STAGE_W ? LDX : CIN, LD2 = STAGE_W ? LDA : WIDTH;
  static constexpr int W1 = 0;                                       // [64][LDX]
  static constexpr int W2 = W1 + (STAGE_W ? WIDTH * LDX : 0);        // [9 * 64][LDA]
  static constexpr int W3 = W2 + (STAGE_W ? 9 * WIDTH * LDA : 0);    // [256][LDA]
  static constexpr int WD = W3 + (STAGE_W ? C4 * LDA : 0);           // [256][LDX]
  static constexpr int XS = WD + (STAGE_W && DOWN ? C4 * LDX : 0);   // NBUF x [NE][LDX]
  static constexpr int T1 = XS + NBUF * NE * LDX;                    // [NE][LDA]
  static constexpr int T2 = T1 + NE * LDA;                           // [NP][LDA]
  static constexpr int BYTES = (T2 + NP * LDA) * static_cast<int>(sizeof(T));
};

// rows x k values of a packed [rows][k] weight into shared rows of stride ld
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, int rows, int k) {
  constexpr int VEC = 16 / sizeof(T);
  const int chunks = k / VEC;
  for (int i = threadIdx.x; i < rows * chunks; i += NTHREADS) {
    const int r = i / chunks, c = (i % chunks) * VEC;
    cp_async16(dst + r * ld + c, src + static_cast<size_t>(r) * k + c);
  }
}

// the input tile of `tile`: rows y0-1 .. y0+TH, cols x0-1 .. x0+TW, clamped
// into the image
template <typename T, int CIN>
__device__ __forceinline__ void load_tile(T* xs, const T* x, int tile, int tiles_x,
                                          int tiles_img, int H, int W) {
  constexpr int VEC = 16 / sizeof(T), CHUNKS = CIN / VEC, LDX = CIN + VEC;
  const int b = tile / tiles_img, r = tile % tiles_img;
  const int y0 = (r / tiles_x) * TH, x0 = (r % tiles_x) * TW;
  const T* xb = x + static_cast<size_t>(b) * H * W * CIN;
  for (int i = threadIdx.x; i < NE * CHUNKS; i += NTHREADS) {
    const int e = i / CHUNKS, c = (i % CHUNKS) * VEC;
    const int gy = min(max(y0 - 1 + e / EW, 0), H - 1);
    const int gx = min(max(x0 - 1 + e % EW, 0), W - 1);
    cp_async16(xs + e * LDX + c, xb + (static_cast<size_t>(gy) * W + gx) * CIN + c);
  }
}

template <typename T, int CIN, bool DOWN>
__global__ void __launch_bounds__(NTHREADS, 1) bottleneck_kernel(
    const T* __restrict__ x,       // [B][H][W][CIN]
    const T* __restrict__ w1,      // [64][CIN]
    const float* __restrict__ b1,  // [64]
    const T* __restrict__ w2,      // [9][64][64]  (tap dy*3+dx, co, ci)
    const float* __restrict__ b2,  // [64]
    const T* __restrict__ w3,      // [256][64]
    const float* __restrict__ b3,  // [256] (plus the downsample BN add for block0)
    const T* __restrict__ wd,      // [256][CIN] (block0 only)
    T* __restrict__ out,           // [B][H][W][256]
    int B, int H, int W) {
  using P = Plan<T, CIN, DOWN>;
  constexpr bool BG = !P::STAGE_W;   // B fragments from device memory
  constexpr int LDX = P::LDX, LDA = P::LDA, LD1 = P::LD1, LD2 = P::LD2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* t1 = sm + P::T1;
  T* t2 = sm + P::T2;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_img = tiles_x * ((H + TH - 1) / TH);
  const int ntiles = B * tiles_img;

  if (P::STAGE_W) {
    stage_rows(sm + P::W1, LDX, w1, WIDTH, CIN);
    stage_rows(sm + P::W2, LDA, w2, 9 * WIDTH, WIDTH);
    stage_rows(sm + P::W3, LDA, w3, C4, WIDTH);
    if (DOWN) stage_rows(sm + P::WD, LDX, wd, C4, CIN);
  }
  const T* w1s = P::STAGE_W ? sm + P::W1 : w1;
  const T* w2s = P::STAGE_W ? sm + P::W2 : w2;
  const T* w3s = P::STAGE_W ? sm + P::W3 : w3;
  const T* wds = P::STAGE_W ? sm + P::WD : wd;
  if (blockIdx.x < ntiles)
    load_tile<T, CIN>(sm + P::XS, x, blockIdx.x, tiles_x, tiles_img, H, W);
  cp_async_commit();

  int buf = 0;
#pragma unroll 1
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();  // this tile's input (and the weights) landed; the last tile is done
    const T* xs = sm + P::XS + buf * NE * LDX;
    const int next = tile + gridDim.x;
    if (P::NBUF == 2 && next < ntiles) {
      load_tile<T, CIN>(sm + P::XS + (buf ^ 1) * NE * LDX, x, next, tiles_x, tiles_img, H, W);
      cp_async_commit();
    }
    const int b = tile / tiles_img, r = tile % tiles_img;
    const int y0 = (r / tiles_x) * TH, x0 = (r % tiles_x) * TW;

    // 1. conv1 + b1 + ReLU over the extent (rows y0-1 .. y0+TH, cols x0-1 ..
    // x0+TW). A row past the extent repeats the last one; outside the image
    // the result is dropped: stored as a literal zero
    {
      int ro[MT1][2];
#pragma unroll
      for (int m = 0; m < MT1; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) ro[m][h] = min(m * 16 + g + 8 * h, NE - 1) * LDX;
      const int n0 = warp * 8;
      float acc[MT1][1][4] = {};
      gemm<BG, T, MT1, 1>(acc, xs, ro, w1s + n0 * LD1, LD1, CIN, g, t);
      const int c = n0 + 2 * t;
      const float bias0 = __ldg(b1 + c), bias1 = __ldg(b1 + c + 1);
#pragma unroll
      for (int m = 0; m < MT1; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = m * 16 + g + 8 * h;
          if (e >= NE) continue;
          const int gy = y0 - 1 + e / EW, gx = x0 - 1 + e % EW;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
          store2(t1 + e * LDA + c, inside ? fmaxf(acc[m][0][2 * h] + bias0, 0.f) : 0.f,
                 inside ? fmaxf(acc[m][0][2 * h + 1] + bias1, 0.f) : 0.f);
        }
    }
    __syncthreads();
    // one buffer: conv1 was its last reader, so the next tile comes in now
    if (P::NBUF == 1 && next < ntiles) {
      load_tile<T, CIN>(sm + P::XS, x, next, tiles_x, tiles_img, H, W);
      cp_async_commit();
    }

    // 2. conv2 (3x3) + b2 + ReLU over the tile: nine shifted GEMMs from T1
    {
      const int n0 = warp * 8;
      float acc[MT][1][4] = {};
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        int ro[MT][2];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = m * 16 + g + 8 * h;
            ro[m][h] = ((p / TW + dy) * EW + p % TW + dx) * LDA;
          }
        gemm<BG, T, MT, 1>(acc, t1, ro, w2s + (tap * WIDTH + n0) * LD2, LD2, WIDTH, g, t);
      }
      const int c = n0 + 2 * t;
      const float bias0 = __ldg(b2 + c), bias1 = __ldg(b2 + c + 1);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = m * 16 + g + 8 * h;
          store2(t2 + p * LDA + c, fmaxf(acc[m][0][2 * h] + bias0, 0.f),
                 fmaxf(acc[m][0][2 * h + 1] + bias1, 0.f));
        }
    }
    __syncthreads();

    // 3. conv3 (+ downsample) + b3 + shortcut + ReLU → device memory. The
    // tile pixel p sits at (p / TW + 1, p % TW + 1) of the extent.
    {
      int ro[MT][2], rx[MT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = m * 16 + g + 8 * h;
          ro[m][h] = p * LDA;
          if (DOWN) {
            rx[m][h] = ((p / TW + 1) * EW + p % TW + 1) * LDX;
          } else {
            const int gy = min(y0 + p / TW, H - 1), gx = min(x0 + p % TW, W - 1);
            rx[m][h] = ((b * H + gy) * W + gx) * CIN;
          }
        }
      const int n0 = warp * NT3 * 8;
      float acc[MT][NT3][4] = {};
      gemm<BG, T, MT, NT3>(acc, t2, ro, w3s + n0 * LD2, LD2, WIDTH, g, t);
      if (DOWN) gemm<BG, T, MT, NT3>(acc, xs, rx, wds + n0 * LD1, LD1, CIN, g, t);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = m * 16 + g + 8 * h;
          const int gy = y0 + p / TW, gx = x0 + p % TW;
          if (gy >= H || gx >= W) continue;
          T* o = out + ((static_cast<size_t>(b) * H + gy) * W + gx) * C4;
#pragma unroll
          for (int n = 0; n < NT3; ++n) {
            const int c = n0 + n * 8 + 2 * t;
            float v0 = acc[m][n][2 * h] + __ldg(b3 + c);
            float v1 = acc[m][n][2 * h + 1] + __ldg(b3 + c + 1);
            if (!DOWN) {  // identity shortcut (CIN == 256), from device memory
              const float2 s = load2(x + static_cast<size_t>(rx[m][h]) + c);
              v0 += s.x;
              v1 += s.y;
            }
            store2(o + c, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          }
        }
    }
    buf ^= P::NBUF - 1;
  }
}

template <typename T, int CIN, bool DOWN>
cudaError_t launch(const void* x, const void* w1, const float* b1, const void* w2,
                   const float* b2, const void* w3, const float* b3, const void* wd,
                   void* out, int B, int H, int W, cudaStream_t stream) {
  constexpr int smem = Plan<T, CIN, DOWN>::BYTES;
  const int tiles = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  int grid = 0;
  cudaError_t err =
      persistent_grid(bottleneck_kernel<T, CIN, DOWN>, NTHREADS, smem, tiles, &grid);
  if (err != cudaSuccess || grid == 0) return err;
  bottleneck_kernel<T, CIN, DOWN><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, static_cast<const T*>(w2),
      b2, static_cast<const T*>(w3), b3, static_cast<const T*>(wd), static_cast<T*>(out),
      B, H, W);
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

template <typename T>
cudaError_t info(int cin, int* out) {
  if (cin == 64)
    return kernel_info(bottleneck_kernel<T, 64, true>, NTHREADS, Plan<T, 64, true>::BYTES, out);
  if (cin == 256)
    return kernel_info(bottleneck_kernel<T, 256, false>, NTHREADS, Plan<T, 256, false>::BYTES,
                       out);
  return cudaErrorInvalidValue;
}

}  // namespace

// One bottleneck of layer1. cin 64 with a downsample (block0) or cin 256
// with the identity shortcut (block1, block2); dtype RLOD_F32 or RLOD_BF16
// for activations and weights alike. Biases are f32. Weights are [N][K]:
// w1 [64][cin], w2 [9][64][64] (tap, co, ci), w3 [256][64], wd [256][cin];
// every pointer 16-byte aligned.
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

// Launch resources of the instantiation for cin and dtype: out[0] registers
// a thread, out[1] shared memory bytes a CTA, out[2] CTAs an SM, out[3]
// local (spill) bytes a thread.
extern "C" int rlod_layer1_info(int cin, int dtype, int* out) {
  cudaError_t err;
  if (dtype == RLOD_F32)
    err = info<float>(cin, out);
  else if (dtype == RLOD_BF16)
    err = info<__nv_bfloat16>(cin, out);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
