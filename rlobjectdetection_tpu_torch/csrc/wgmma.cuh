// Hopper building blocks for the warpgroup kernels (res_stage.cu, vgg_block1.cu): wgmma
// with A in registers and B in shared memory, the B descriptor of a
// 128-byte-swizzled K-major tile, ldmatrix A fragments, mbarriers, bulk
// copies into shared memory and thread-block-cluster helpers. sm_90a only.
//
// B tiles. A weight stage is NS = 64 output channels (rows n) x KS = 64
// input channels (k) of bf16, 128 bytes a row, laid out as wgmma's canonical
// K-major layout with the 128-byte swizzle: row n at byte n * 128, its
// 16-byte chunk c (k / 8) stored at chunk c ^ (n % 8). Eight rows form a
// 1024-byte swizzle atom, so a tile starts 1024-byte aligned. The host packs
// each weight as the exact byte image of these tiles
// (ops/res_stage_kernel.py::pack_res_stage_stream), so a stage is one
// contiguous bulk copy. For the k16 step kk the descriptor starts 32 * kk
// bytes into the tile; the hardware forms address = start + (n / 8) * SBO +
// (n % 8) * 128 + 2 * k and XORs its bits [4, 7) with bits [7, 10)
// (tests/test_torch_res_stage_packing.py decodes the packed image with that
// arithmetic).
//
// A in registers: each warp of the warpgroup holds 16 rows of the 64-row
// tile in exactly mma.sync m16n8k16's A-fragment layout (FragBf16A), so A
// rows can be gathered from anywhere. The f32 accumulator of m64n64 is, per
// warp, 16 rows x 64 columns: d[4n + 2h + i] is row g + 8h, column
// 8n + 2t + i (g = lane / 4, t = lane % 4), mma.sync's C fragment of each
// 8-wide column block n in turn.
#pragma once

#include "mma.cuh"

namespace wg {

constexpr int NS = 64, KS = 64;                 // a weight stage: 64 rows x 64 k
constexpr int STAGE_BYTES = NS * KS * 2;        // 8192
constexpr int SBO = 1024;                       // bytes between 8-row groups

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Descriptor of a 128-byte-swizzled K-major B tile whose k16 step starts at
// shared address `addr` (the tile itself 1024-byte aligned): start >> 4,
// LBO 1 (unused by swizzled K-major layouts), SBO 1024 bytes, layout 1
// (SWIZZLE_128B), base offset 0.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(SBO >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warp are still running
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64 x 64] += A[64 x 16] (registers) x B[16 x 64] (descriptor); bf16 in,
// f32 sums
__device__ __forceinline__ void mma_m64n64k16(float (&d)[32], const FragBf16A& a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "l"(b), "r"(1));
}

// d[64 x 128] += A[64 x 16] (registers) x B[16 x 128] (descriptor of 128
// rows: two 64-row tiles one after the other); d[j] holds columns
// 64j .. 64j + 63 in the m64n64 layout
__device__ __forceinline__ void mma_m64n128k16(float (&d)[2][32], const FragBf16A& a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[0][4]), "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]),
        "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]),
        "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]),
        "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]),
        "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]),
        "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]),
        "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]),
        "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]),
        "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]),
        "+f"(d[1][16]), "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]),
        "+f"(d[1][20]), "+f"(d[1][21]), "+f"(d[1][22]), "+f"(d[1][23]),
        "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]), "+f"(d[1][27]),
        "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "l"(b), "r"(1));
}

// The A fragment of a 16 x 16 bf16 tile from shared memory: lane l gives
// the address of row (l & 7) + 8 * ((l >> 3) & 1), columns 8 * (l >> 4) ..
// +7 (16 bytes, 16-byte aligned); the four 8x8 matrices land in r[0..3] in
// mma.sync's A-fragment order.
__device__ __forceinline__ void ldmatrix_a(FragBf16A& a, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
               : "r"(addr));
}

// mbarriers in shared memory (addresses from smem_addr)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// one arrive for the calling warp, from a lane elect.sync picks (a
// predicated arrive, no divergent branch)
__device__ __forceinline__ void mbar_arrive_warp(uint32_t bar) {
  asm volatile(
      "{\n.reg .pred p;\nelect.sync _|p, 0xffffffff;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar)
      : "memory");
}
// Wait until the phase of parity `parity` has completed. A wait that spins
// for seconds traps (an unspecified launch failure the wrapper's caller
// sees at its next synchronise) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// `bytes` (a multiple of 16) from device memory into this CTA's shared
// memory; completion is counted on `bar` (complete_tx)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// thread-block clusters
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every CTA of the cluster; orders shared::cluster writes
// before the barrier against reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the shared::cluster address of `addr` (own CTA) in CTA `rank`'s memory
__device__ __forceinline__ uint32_t map_to(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

}  // namespace wg
