// Helpers shared by the port's kernels: element conversion between the
// storage type (float or bf16) and the f32 the kernels compute in, and
// 16-byte vector loads/stores of 8 consecutive elements.
//
// Every kernel file exposes plain C entry points (bound with ctypes, see
// ops/_build.py) that launch on the caller's stream and return
// cudaGetLastError(), so a launch the runtime refuses is reported to Python.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed from Python (ops/_build.py DTYPE_CODES)
enum { RLOD_F32 = 0, RLOD_BF16 = 1 };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// element i of an image that is f32 or bf16 (x_dtype), as f32
__device__ __forceinline__ float load_pixel(const void* x, int x_dtype, size_t i) {
  return x_dtype == RLOD_F32 ? static_cast<const float*>(x)[i]
                             : __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
}

// 8 consecutive elements at a 16-byte aligned address → f32 registers
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// read-only-cache variants for weights in device memory
__device__ __forceinline__ void ldg8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void ldg8(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// The kernel's launch resources as the runtime reports them, for the
// callers' info entry points: registers a thread, shared memory a CTA
// (static + `dyn_smem` dynamic), CTAs an SM can hold, local bytes a thread
// (spills).
template <typename K>
cudaError_t kernel_info(K kernel, int threads, int dyn_smem, int* info) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, dyn_smem);
  info[0] = a.numRegs;
  info[1] = static_cast<int>(a.sharedSizeBytes) + dyn_smem;
  info[2] = per_sm;
  info[3] = static_cast<int>(a.localSizeBytes);
  return err;
}
