// Implicit-GEMM building blocks shared by the bottleneck kernels
// (res_stage.cu, layer1.cu): mma.sync fragments, their loaders, a GEMM
// over shifted A rows, and cp.async copies into shared memory.
//
// bf16: m16n8k16 on the tensor cores with f32 sums. f32: the same warp and
// C-fragment ownership on the FMA pipes, k steps of 4 (f32 results are held
// at 1e-4, which TF32 would break). Weights are [N][K] (output channel,
// input channel), so a bf16 B fragment is two 4-byte words a lane.
#pragma once

#include "common.cuh"

// Operands of one 16x8 product step: C rows g and g+8, columns 2t and 2t+1
// of the 8-wide N tile (g = lane / 4, t = lane % 4), as mma.sync lays out
// its accumulators.
struct FragBf16A { uint32_t r[4]; };   // m16n8k16 A: rows g, g+8 x k 2t.., 2t+8..
struct FragBf16B { uint32_t r[2]; };   // m16n8k16 B: column g x k 2t.., 2t+8..
struct FragF32 { float4 r[2]; };       // f32: two rows (A) or two columns (B) x 4 k

template <typename T> struct Frags;
template <> struct Frags<__nv_bfloat16> {
  using A = FragBf16A;
  using B = FragBf16B;
  static constexpr int K = 16;
};
template <> struct Frags<float> {
  using A = FragF32;
  using B = FragF32;
  static constexpr int K = 4;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A rows r0 (fragment row g) and r1 (row g + 8), each at the step's first k
__device__ __forceinline__ void load_a(FragBf16A& f, const __nv_bfloat16* r0,
                                       const __nv_bfloat16* r1, int t) {
  f.r[0] = ld32(r0 + 2 * t);
  f.r[1] = ld32(r1 + 2 * t);
  f.r[2] = ld32(r0 + 2 * t + 8);
  f.r[3] = ld32(r1 + 2 * t + 8);
}

__device__ __forceinline__ void load_a(FragF32& f, const float* r0, const float* r1, int) {
  f.r[0] = *reinterpret_cast<const float4*>(r0);
  f.r[1] = *reinterpret_cast<const float4*>(r1);
}

// B of an 8-wide N tile: rows n0 .. n0 + 7 of a [N][K] weight (ldb = K),
// bt at row n0 and the step's first k. GLOBAL: the weight is in device
// memory and read through the read-only cache; else it is in shared memory.
template <bool GLOBAL>
__device__ __forceinline__ void load_b(FragBf16B& f, const __nv_bfloat16* bt, int ldb, int g,
                                       int t) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(bt + g * ldb + 2 * t);
  f.r[0] = GLOBAL ? __ldg(p) : p[0];
  f.r[1] = GLOBAL ? __ldg(p + 4) : p[4];
}

template <bool GLOBAL>
__device__ __forceinline__ void load_b(FragF32& f, const float* bt, int ldb, int, int t) {
  const float4* p0 = reinterpret_cast<const float4*>(bt + 2 * t * ldb);
  const float4* p1 = reinterpret_cast<const float4*>(bt + (2 * t + 1) * ldb);
  f.r[0] = GLOBAL ? __ldg(p0) : *p0;
  f.r[1] = GLOBAL ? __ldg(p1) : *p1;
}

__device__ __forceinline__ void mma(float* c, const FragBf16A& a, const FragBf16B& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
}

__device__ __forceinline__ float dot4(float c, float4 a, float4 b) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}

__device__ __forceinline__ void mma(float* c, const FragF32& a, const FragF32& b) {
  c[0] = dot4(c[0], a.r[0], b.r[0]);
  c[1] = dot4(c[1], a.r[0], b.r[1]);
  c[2] = dot4(c[2], a.r[1], b.r[0]);
  c[3] = dot4(c[3], a.r[1], b.r[1]);
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// acc[m][n] += A(M tile m) x B(N tile n) over K. Row g + 8h of M tile m
// starts at a + ro[m][h]; bt is the warp's first B row ([N][K], ldb).
template <bool B_GLOBAL, typename T, int M, int NT>
__device__ __forceinline__ void gemm(float (&acc)[M][NT][4], const T* a, const int (&ro)[M][2],
                                     const T* bt, int ldb, int K, int g, int t) {
  using F = Frags<T>;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += F::K) {
    typename F::B fb[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) load_b<B_GLOBAL>(fb[n], bt + n * 8 * ldb + k0, ldb, g, t);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      typename F::A fa;
      load_a(fa, a + ro[m][0] + k0, a + ro[m][1] + k0, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma(acc[m][n], fa, fb[n]);
    }
  }
}

// 16 bytes from device memory into shared memory, asynchronously (sm_80+);
// cp_async_wait_all() waits for every copy this thread issued.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// BYTES (4, 8 or 16) from device memory into shared memory, asynchronously;
// with `valid` false nothing is read and the destination is zero-filled
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem),
               "n"(BYTES), "r"(valid ? BYTES : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Grid of a persistent kernel: as many CTAs as the card holds at once (all
// SMs x CTAs per SM), at most one per tile. Refuses a kernel that fits no
// SM, which a launch would otherwise leave unreported until it is checked.
template <typename K>
cudaError_t persistent_grid(K kernel, int threads, int dyn_smem, int tiles, int* grid) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, dyn_smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  return cudaSuccess;
}
