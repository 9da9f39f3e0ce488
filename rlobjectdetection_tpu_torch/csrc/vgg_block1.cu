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
// operations (0.076 ms at the bf16 tensor-core peak). What the design keeps
// from the TPU kernel is the fusion: the two full-resolution 64-channel
// activations never reach device memory.
//
// bf16 (vgg_block1_wgmma), for Hopper's tensor cores:
//  - persistent CTAs (the grid is the CTAs the card holds, from the
//    occupancy API: one an SM), each walking tiles of 4x16 pooled cells
//    (8x32 conv1_2 outputs, a 10x34 conv1_1 extent, a 12x36 input patch);
//  - the weights are staged once a CTA by bulk copies on one mbarrier, as
//    the byte image ops/vgg_block1_kernel.py::pack_vgg_block1 writes: nine
//    8 KB tiles of conv1_2 (one a tap: 64 output x 64 input channels) and
//    one of conv1_1 (64 output channels x K = 27 taps (ky, kx, ci), zero to
//    64), each in wgmma's 128-byte-swizzled K-major layout (wgmma.cuh), so B
//    is read through a descriptor and no weight passes through registers;
//  - warp-specialised: two producer warpgroups compute conv1_1 of tile k + 1
//    while two consumer warpgroups compute conv1_2 of tile k, through two
//    conv1_1 tile buffers handed over on named barriers (full: producers
//    arrive, consumers wait; empty: the reverse). With both phases in turn
//    on the same warps, conv1_1 (4.5% of the operations) took 31% of a
//    tile's cycles (tools/probe_vgg_block1.py);
//  - producers: the next tile's input patch is in flight (cp.async into the
//    second of two patch buffers, zero-filled outside the image: conv1_1's
//    padding) while this one's conv1_1 runs on wgmma, an im2col GEMM: M =
//    the extent's 340 positions in six 64-row tiles, N = 64, K = 32 (two k16
//    steps; taps 27..31 carry zero weights and zero A values). Each thread
//    builds its A fragments straight from the patch (rounded to bf16), the
//    next M tile's while this one's products run; bias + ReLU in f32,
//    rounded to bf16 into the conv1_1 tile, positions outside the image as
//    literal zeros;
//  - consumers: conv1_2 on wgmma m64n64k16, 36 k16 steps (9 taps x 4 channel
//    chunks) a 64-row M tile. An M tile is conv rows 2m and 2m + 1 x the
//    tile's 32 columns; warp w of a warpgroup holds columns 8w .. 8w + 7 of
//    both rows (rows g and g + 8 of its A fragment), so each 2x2 pool window
//    lies in one lane pair. The tap-shifted windows are no affine tile for a
//    descriptor, so A is in registers, loaded with ldmatrix from the conv1_1
//    tile (rows padded to 144 bytes, so a matrix's 8 rows hit distinct
//    banks). Each consumer warpgroup runs its two M tiles one after the
//    other, a tap's four products in flight while the next tap's A
//    fragments load;
//  - epilogue: the 2x2 max in registers (the vertical pair in one thread,
//    the horizontal one a lane shuffle; max before bias + ReLU, which are
//    monotonic, so the result is the same), rounded once to bf16 into one
//    of two staged pooled tiles (every lane writes), then 16-byte coalesced
//    stores by the consumers while the next tile's products run.
//    512 threads at 128 registers, no spills. A launch error raises, a
//    kernel that fits no SM is refused, and a weight wait that spins for
//    seconds traps.
// f32 (vgg_block1_fma, held against the plain version at 1e-4): the f32 FMA
// pipes, a CTA an 8x8-cell tile: the 20x20x3 patch, conv1_1 over the 18x18
// extent into shared memory, each thread two pool windows x 8 channels of
// conv1_2.
#include "wgmma.cuh"

namespace {

// ---- bf16: persistent, weights resident, warp-specialised wgmma ----
namespace tc {

constexpr int TPH = 4, TPW = 16;            // pooled cells a tile
constexpr int CH = 2 * TPH, CW = 2 * TPW;   // conv1_2 outputs (8 x 32)
constexpr int EH = CH + 2, EW = CW + 2;     // conv1_1 extent (10 x 34)
constexpr int IH = EH + 2, IW = EW + 2;     // input patch (12 x 36)
constexpr int NE = EH * EW;                 // 340
constexpr int MT1 = (NE + 63) / 64;         // conv1_1 M tiles (6)
constexpr int MT2 = CH / 2;                 // conv1_2 M tiles (4)
constexpr int NPROD = 2, NCONS = 2;         // producer (conv1_1), consumer (conv1_2) warpgroups
constexpr int PROD_THREADS = NPROD * 128, CONS_THREADS = NCONS * 128;
constexpr int NTHREADS = PROD_THREADS + CONS_THREADS;
constexpr int ROW = IW * 3;                 // patch elements a row (108)
constexpr int LDA = 64 + 8;                 // conv1_1 tile row, bf16 (144 bytes)
constexpr int LDO = 64 + 8;                 // staged pooled cell, bf16 (144 bytes)
constexpr int TAPS1 = 27;                   // conv1_1's K before padding
constexpr int WTILES = 10;                  // 9 conv1_2 taps, then conv1_1
constexpr int Y1_BYTES = NE * LDA * 2;      // one conv1_1 tile
constexpr int OUT_BYTES = TPH * TPW * LDO * 2;
static_assert(MT1 % NPROD == 0 && MT2 % NCONS == 0, "M tiles split evenly");
static_assert(ROW % 2 == 0, "patch rows are whole 2-element chunks");

// named barriers (0 is __syncthreads): a conv1_1 tile buffer b is full
// (producers arrive, consumers wait) or empty (the reverse); the producers
// alone; the consumers alone
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_PROD = 5, BAR_CONS = 6;

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// byte offsets from the 1024-byte aligned base of dynamic shared memory
template <typename TIn>
struct Smem {
  static constexpr int PATCH = (IH * ROW * static_cast<int>(sizeof(TIn)) + 15) / 16 * 16;
  static constexpr int W = 0;                              // WTILES x 8192
  static constexpr int Y1 = WTILES * wg::STAGE_BYTES;      // two [NE][LDA] bf16
  static constexpr int OUT = Y1 + 2 * Y1_BYTES;            // two [TPH * TPW][LDO] bf16
  static constexpr int X = OUT + 2 * OUT_BYTES;            // two patches [IH][ROW]
  static constexpr int BIAS = X + 2 * PATCH;               // b1, b2: 128 f32
  static constexpr int BAR = BIAS + 128 * 4;               // the weights' mbarrier
  static constexpr int BYTES = 1024 + BAR + 8;             // + slack to align the base
};

struct Tile {
  int b, py0, px0;
  __device__ Tile(int tile, int tiles_x, int tiles_img)
      : b(tile / tiles_img),
        py0(((tile % tiles_img) / tiles_x) * TPH),
        px0(((tile % tiles_img) % tiles_x) * TPW) {}
};

// The tile's input patch (image rows 2 py0 - 2 .., columns 2 px0 - 2 ..)
// into xs by the producer threads, two elements a cp.async; chunks outside
// the image are zeros. Chunks start at even elements of an image row and 3W
// is even (W is), so a chunk is wholly inside or outside.
template <typename TIn>
__device__ __forceinline__ void load_patch(TIn* xs, const TIn* x, const Tile& tl, int H,
                                           int W) {
  constexpr int CHUNKS = ROW / 2;
  const int iy0 = 2 * tl.py0 - 2, e0 = (2 * tl.px0 - 2) * 3;
  for (int i = threadIdx.x; i < IH * CHUNKS; i += PROD_THREADS) {
    const int r = i / CHUNKS, e = e0 + 2 * (i % CHUNKS), iy = iy0 + r;
    const bool ok = iy >= 0 && iy < H && e >= 0 && e < 3 * W;
    const TIn* src = ok ? x + (static_cast<size_t>(tl.b) * H + iy) * W * 3 + e : x;
    cp_async_zfill<static_cast<int>(2 * sizeof(TIn))>(xs + r * ROW + (e - e0), src, ok);
  }
  cp_async_commit();
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// conv1_1's A fragments of M tile mt (extent positions 64 mt ..) for both
// k16 steps, from the patch: row g + 8h of warp w is position
// 64 mt + 16 w + g + 8h (clamped to the extent; rows past it are dropped),
// k = 16 kk + 2t + (q & 1) + 8 (q >> 1) reads patch element base + off[4kk + q]
// (off < 0: a padded tap, value 0); k = ky 9 + kx 3 + ci lies ky rows and
// kx 3 + ci elements from the position's first.
template <typename TIn>
__device__ __forceinline__ void conv11_a(FragBf16A (&a)[2], const TIn* xs, int mt) {
  const int warp = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  int off[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = 16 * (i >> 2) + 2 * t + (i & 1) + 8 * ((i >> 1) & 1);
    off[i] = k < TAPS1 ? (k / 9) * ROW + k % 9 : -1;
  }
  int base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = min(mt * 64 + warp * 16 + g + 8 * h, NE - 1);
    base[h] = (e / EW) * ROW + (e % EW) * 3;
  }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {   // r[reg]: row g + 8 (reg & 1), k pair reg >> 1
      const int h = reg & 1, q = 2 * (reg >> 1);
      const int o0 = off[4 * kk + q], o1 = off[4 * kk + q + 1];
      const float v0 = o0 < 0 ? 0.f : to_f(xs[base[h] + o0]);
      const float v1 = o1 < 0 ? 0.f : to_f(xs[base[h] + o1]);
      a[kk].r[reg] = pack_bf16(v0, v1);
    }
}

// The producers: conv1_1 + b1 + ReLU over the tile's extent → y1 (bf16);
// warpgroup pw takes M tiles pw, pw + 2, pw + 4, the next one's A fragments
// built while this one's two products run. Positions outside the image are
// stored as literal zeros.
template <typename TIn>
__device__ __forceinline__ void conv11(const TIn* xs, __nv_bfloat16* y1, uint32_t w1_s,
                                       const float* b1, const Tile& tl, int H, int W) {
  const int pw = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int cy0 = 2 * tl.py0 - 1, cx0 = 2 * tl.px0 - 1;   // extent (0, 0) in the image
  constexpr int STEPS = MT1 / NPROD;
  FragBf16A a[2][2];
  conv11_a(a[0], xs, pw);
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const int mt = pw + NPROD * i;
    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wg::mma_m64n64k16(acc, a[i & 1][kk], wg::desc_sw128(w1_s + 32 * kk));
    wg::commit();
    if (i + 1 < STEPS) conv11_a(a[(i + 1) & 1], xs, mt + NPROD);
    wg::wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = mt * 64 + warp * 16 + g + 8 * h;
      if (e >= NE) continue;
      const int gy = cy0 + e / EW, gx = cx0 + e % EW;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = 8 * n + 2 * t;
        const float v0 = inside ? fmaxf(acc[4 * n + 2 * h] + b1[c], 0.f) : 0.f;
        const float v1 = inside ? fmaxf(acc[4 * n + 2 * h + 1] + b1[c + 1], 0.f) : 0.f;
        *reinterpret_cast<uint32_t*>(y1 + e * LDA + c) = pack_bf16(v0, v1);
      }
    }
  }
}

// The consumers: conv1_2 + b2 + ReLU + 2x2 max of M tiles 2 cw and 2 cw + 1
// (conv rows 2m, 2m + 1) from y1 → the staged pooled tile os. a_lane: this
// lane's ldmatrix row in y1 at M tile 0, tap (0, 0).
__device__ __forceinline__ void conv12(uint32_t a_lane, uint32_t w2_s, const float* b2,
                                       __nv_bfloat16* os) {
  const int cw = (threadIdx.x >> 7) - NPROD, warp = (threadIdx.x >> 5) & 3;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll 1
  for (int m = 2 * cw; m < 2 * cw + 2; ++m) {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    // a tap's four k16 steps run while the next tap's A fragments load into
    // the other buffer
    FragBf16A a[2][4];   // [buffer][k16 step]
    auto load = [&](int tap, FragBf16A (&buf)[4]) {
      const uint32_t at = a_lane + ((m * 2 * EW + (tap / 3) * EW + tap % 3) * LDA) * 2;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wg::ldmatrix_a(buf[kk], at + 32 * kk);
    };
    load(0, a[0]);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_m64n64k16(acc, a[tap & 1][kk],
                          wg::desc_sw128(w2_s + tap * wg::STAGE_BYTES + 32 * kk));
      wg::commit();
      if (tap + 1 < 9) {
        wg::wait<1>();   // the last tap's products, which read the other buffer, are done
        load(tap + 1, a[(tap + 1) & 1]);
      }
    }
    wg::wait<0>();
    // acc[4n + 2h + i]: conv (2m + h, 8 warp + g), channel 8n + 2t + i.
    // Lane pairs (g, g ^ 1) hold a pool window; the even lane writes
    // channels 0..31 of it, the odd one 32..63.
    __nv_bfloat16* cell = os + (m * TPW + warp * 4 + (g >> 1)) * LDO;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float v[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        v[i] = fmaxf(acc[4 * n + i], acc[4 * n + 2 + i]);
        v[i] = fmaxf(v[i], __shfl_xor_sync(0xffffffffu, v[i], 4));
        v[i] = fmaxf(v[i] + b2[8 * n + 2 * t + i], 0.f);
      }
      if ((n >> 2) == (g & 1))
        *reinterpret_cast<uint32_t*>(cell + 8 * n + 2 * t) = pack_bf16(v[0], v[1]);
    }
  }
}

template <typename TIn>
__global__ void __launch_bounds__(NTHREADS, 1) vgg_block1_wgmma(
    const TIn* __restrict__ x,                     // [B][H][W][3]
    const unsigned char* __restrict__ wimg,        // [WTILES][8192] (pack_vgg_block1)
    const float* __restrict__ b1,                  // [64]
    const float* __restrict__ b2,                  // [64]
    __nv_bfloat16* __restrict__ out,               // [B][H/2][W/2][64]
    int H, int W, int tiles, int tiles_x, int tiles_img) {
  using S = Smem<TIn>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (wg::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t w_s = wg::smem_addr(base + S::W);
  float* bias = reinterpret_cast<float*>(base + S::BIAS);   // b1 [0, 64), b2 [64, 128)
  const uint32_t bar = wg::smem_addr(base + S::BAR);
  auto y1 = [&](int k) {       // the conv1_1 tile buffer of the k-th tile
    return reinterpret_cast<__nv_bfloat16*>(base + S::Y1 + (k & 1) * Y1_BYTES);
  };
  const int tid = threadIdx.x;

  if (tid == 0) {
    wg::mbar_init(bar, 1);
    wg::mbar_init_fence();
  }
  if (tid < 128) bias[tid] = tid < 64 ? b1[tid] : b2[tid - 64];
  __syncthreads();
  if (tid == 0) {
    wg::mbar_expect_tx(bar, WTILES * wg::STAGE_BYTES);
    for (int i = 0; i < WTILES; ++i)
      wg::bulk_load(w_s + i * wg::STAGE_BYTES, wimg + i * wg::STAGE_BYTES, wg::STAGE_BYTES,
                    bar);
  }
  const int stride = gridDim.x;

  if (tid < PROD_THREADS) {
    // producers: the patches (one in flight ahead) and conv1_1 into y1(k)
    // once the consumers have freed it (from the third tile on)
    auto patch = [&](int k) {
      return reinterpret_cast<TIn*>(base + S::X + (k & 1) * S::PATCH);
    };
    load_patch(patch(0), x, Tile(blockIdx.x, tiles_x, tiles_img), H, W);
    wg::mbar_wait(bar, 0);
#pragma unroll 1
    for (int tile = blockIdx.x, k = 0; tile < tiles; tile += stride, ++k) {
      const Tile tl(tile, tiles_x, tiles_img);
      cp_async_wait_all();
      bar_sync(BAR_PROD, PROD_THREADS);   // patch k landed; patch k - 1 is read
      if (tile + stride < tiles)
        load_patch(patch(k + 1), x, Tile(tile + stride, tiles_x, tiles_img), H, W);
      if (k >= 2) bar_sync(BAR_EMPTY + (k & 1), NTHREADS);
      conv11(patch(k), y1(k), w_s + 9 * wg::STAGE_BYTES, bias, tl, H, W);
      bar_arrive(BAR_FULL + (k & 1), NTHREADS);
    }
    return;
  }

  // consumers: conv1_2 from y1(k), the pooled tile staged in os(k), then
  // stored 16 bytes a thread
  const int ct = tid - PROD_THREADS, lane = tid & 31, warp = (tid >> 5) & 3;
  const int PH = H / 2, PW = W / 2;
  // this lane's ldmatrix row in an M tile at tap (0, 0): conv row
  // (l >> 3) & 1 of the pair, column 8 warp + (l & 7); its 8-column half
  const uint32_t a_lane = ((((lane >> 3) & 1) * EW + warp * 8 + (lane & 7)) * LDA +
                           8 * (lane >> 4)) * 2;
  wg::mbar_wait(bar, 0);
#pragma unroll 1
  for (int tile = blockIdx.x, k = 0; tile < tiles; tile += stride, ++k) {
    const Tile tl(tile, tiles_x, tiles_img);
    __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(base + S::OUT + (k & 1) * OUT_BYTES);
    bar_sync(BAR_FULL + (k & 1), NTHREADS);   // y1(k) is written
    conv12(wg::smem_addr(y1(k)) + a_lane, w_s, bias + 64, os);
    if (tile + 2 * stride < tiles) bar_arrive(BAR_EMPTY + (k & 1), NTHREADS);
    bar_sync(BAR_CONS, CONS_THREADS);   // the pooled tile is staged
    for (int q = ct; q < TPH * TPW * 8; q += CONS_THREADS) {
      const int cell = q >> 3, part = q & 7;
      const int py = tl.py0 + cell / TPW, px = tl.px0 + cell % TPW;
      if (py < PH && px < PW)
        *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(tl.b) * PH + py) * PW + px) * 64
                                  + part * 8) =
            *reinterpret_cast<const uint4*>(os + cell * LDO + part * 8);
    }
  }
}

template <typename TIn>
cudaError_t launch(const void* x, const void* wimg, const float* b1, const float* b2,
                   void* out, int B, int H, int W, cudaStream_t stream) {
  auto kernel = vgg_block1_wgmma<TIn>;
  constexpr int smem = Smem<TIn>::BYTES;
  const int tiles_x = (W / 2 + TPW - 1) / TPW, tiles_img = tiles_x * ((H / 2 + TPH - 1) / TPH);
  const int tiles = B * tiles_img;
  int grid = 0;
  cudaError_t err = persistent_grid(kernel, NTHREADS, smem, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const TIn*>(x), static_cast<const unsigned char*>(wimg), b1, b2,
      static_cast<__nv_bfloat16*>(out), H, W, tiles, tiles_x, tiles_img);
  return cudaGetLastError();
}

}  // namespace tc

// ---- f32: the FMA kernel ----
namespace f32fma {

constexpr int TP = 8;            // pooled cells per block side
constexpr int CT = 2 * TP;       // conv1_2 outputs per side (16)
constexpr int ET = CT + 2;       // conv1_1 outputs per side (18)
constexpr int IT = ET + 2;       // input pixels per side (20)
constexpr int NE = ET * ET;      // conv1_1 outputs per block
constexpr int NTHREADS = 256;    // 8 warps
constexpr int XIN_BYTES = IT * IT * 3 * sizeof(float);  // a multiple of 16
constexpr int LDA = 64 + 4;      // padded conv1_1 row: its banks shift from row to row
constexpr int SMEM_BYTES = XIN_BYTES + NE * LDA * sizeof(float);

// conv1_2 + b2 + ReLU + 2x2 max. y1: [NE][LDA]; w2: [9][64][64] (tap, ci,
// co). Thread (tm, tn) owns pool windows tm and tm + 32 of the 8x8 tile,
// channels 8 tn .. 8 tn + 7.
__device__ __forceinline__ void conv12(const float* y1, const float* w2, const float* b2,
                                       float* out, int b, int py0, int px0, int PH, int PW) {
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

__global__ void __launch_bounds__(NTHREADS, 2) vgg_block1_fma(
    const void* __restrict__ x, int x_dtype,
    const float* __restrict__ w1,  // [27][64]: tap (ky*3 + kx)*3 + ci, co
    const float* __restrict__ b1,  // [64]
    const float* __restrict__ w2,  // [9][64][64]
    const float* __restrict__ b2,  // [64]
    float* __restrict__ out,       // [B][H/2][W/2][64]
    int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xin = reinterpret_cast<float*>(smem_raw);              // [IT][IT][3]
  float* y1 = reinterpret_cast<float*>(smem_raw + XIN_BYTES);   // [NE][LDA]

  const int b = blockIdx.z, tid = threadIdx.x;
  const int PH = H / 2, PW = W / 2;
  const int py0 = blockIdx.y * TP, px0 = blockIdx.x * TP;
  const int cy0 = 2 * py0, cx0 = 2 * px0;  // first conv1_2 output of the tile
  // xin (0, 0) is image pixel (cy0 - 2, cx0 - 2); y1 (0, 0) is conv1_1
  // output (cy0 - 1, cx0 - 1)

  // 1. input patch, zero outside the image (conv1_1's own padding)
  for (int i = tid; i < IT * IT * 3; i += NTHREADS) {
    const int ci = i % 3, p = i / 3;
    const int iy = cy0 - 2 + p / IT, ix = cx0 - 2 + p % IT;
    float v = 0.f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = load_pixel(x, x_dtype, ((static_cast<size_t>(b) * H + iy) * W + ix) * 3 + ci);
    xin[i] = v;
  }
  __syncthreads();

  // 2. conv1_1 + b1 + ReLU over the 18x18 extent; outputs outside the image
  // are conv1_2's zero padding
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
  conv12(y1, w2, b2, out, b, py0, px0, PH, PW);
}

cudaError_t launch(const void* x, int x_dtype, const float* w1, const float* b1,
                   const float* w2, const float* b2, void* out, int B, int H, int W,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      vgg_block1_fma, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((W / 2 + TP - 1) / TP, (H / 2 + TP - 1) / TP, B);
  vgg_block1_fma<<<grid, NTHREADS, SMEM_BYTES, stream>>>(x, x_dtype, w1, b1, w2, b2,
                                                         static_cast<float*>(out), H, W);
  return cudaGetLastError();
}

}  // namespace f32fma

}  // namespace

// x [B][H][W][3] f32 or bf16 (x_dtype), H and W even, 16-byte aligned;
// dtype (RLOD_F32 or RLOD_BF16) is the compute and output type. bf16: w1 is
// null and w2 the packed weight image [10][8192 bytes]; f32: w1 [27][64],
// w2 [9][64][64]. Biases are f32.
extern "C" int rlod_vgg_block1_fwd(const void* x, int x_dtype, const void* w1,
                                   const void* b1, const void* w2, const void* b2,
                                   void* out, int dtype, int B, int H, int W,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  if (H % 2 || W % 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == RLOD_F32)
    err = f32fma::launch(x, x_dtype, static_cast<const float*>(w1), b1f,
                      static_cast<const float*>(w2), b2f, out, B, H, W, s);
  else if (dtype == RLOD_BF16 && x_dtype == RLOD_F32)
    err = tc::launch<float>(x, w2, b1f, b2f, out, B, H, W, s);
  else if (dtype == RLOD_BF16 && x_dtype == RLOD_BF16)
    err = tc::launch<__nv_bfloat16>(x, w2, b1f, b2f, out, B, H, W, s);
  return static_cast<int>(err);
}

// Launch resources of the kernel for dtype (the bf16 kernel for an f32
// image, as the main path runs it): out[0] registers a thread, out[1] shared
// memory bytes a CTA, out[2] CTAs an SM, out[3] local (spill) bytes a
// thread.
extern "C" int rlod_vgg_block1_info(int dtype, int* out) {
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == RLOD_BF16)
    err = kernel_info(tc::vgg_block1_wgmma<float>, tc::NTHREADS, tc::Smem<float>::BYTES, out);
  else if (dtype == RLOD_F32)
    err = kernel_info(f32fma::vgg_block1_fma, f32fma::NTHREADS, f32fma::SMEM_BYTES, out);
  return static_cast<int>(err);
}
