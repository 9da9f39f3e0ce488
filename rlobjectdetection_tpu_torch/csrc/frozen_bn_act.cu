// The frozen BatchNorm's epilogue of a ResNet bottleneck in one pass, forward
// and backward: `rlod::frozen_bn_act` and `rlod::frozen_bn_act_bwd`
// (ops/frozen_bn_act.py).
//
// It replaces no TPU kernel. In the JAX package XLA fuses a frozen BN's
// affine, the residual add and the ReLU into the convolution's output
// fusion. The port's convolutions are cuDNN's, and before this kernel the
// epilogue was a chain of ATen elementwise kernels: two passes a BN (the
// multiply, the add), one the residual add, one each ReLU, and about eight
// tiny kernels a BN that rebuilt the constants. Here the constants come
// cached from the wrapper, and each site is one pass.
//
// The NHWC memory behind a channels-last NCHW tensor is [rows, C] with C
// contiguous. Three site forms, each ending in a ReLU:
//   0  y = relu(x·mul + add)                          bn1, bn2 (and the plain stem's BN)
//   1  y = relu(x·mul + add + r)                      bn3 of an identity block
//   2  y = relu(x·mul + add + (d·mul_d + add_d))      bn3 of block 0 with its downsample BN
// mul and add are in the storage type, and every product and sum is rounded
// to it where ATen's chain rounds it (__fmul_rn / __fadd_rn: no FMA
// contraction), so y equals the chain's to the bit in f32 and bf16.
// Backward, one pass: g_s = (y <= 0 ? 0 : g) (ATen's threshold_backward on
// the ReLU's result), g_x = g_s·mul, and at a residual site g_r = g_s
// (form 1) or g_s·mul_d (form 2); it reads g and the saved y only.
//
// Bound: bytes (an operation or two an element against ~300 a byte before
// the tensor cores bind). Each thread owns one 16-byte column of channels
// (4 f32 or 8 bf16), keeps their mul/add in registers, and walks the rows
// with a grid stride over a grid of the CTAs the card holds at once, with
// UNROLL rows' 16-byte loads in flight before any arithmetic or store.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// 16 bytes of T as 16/sizeof(T) floats, and back (rounded to nearest even)
template <typename T> __device__ __forceinline__ void unpack(const uint4& u, float* v);
template <> __device__ __forceinline__ void unpack<float>(const uint4& u, float* v) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <typename T> __device__ __forceinline__ uint4 pack(const float* v);
template <> __device__ __forceinline__ uint4 pack<float>(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return u;
}

// v rounded to T and read back as f32
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void st16(void* p, const uint4& u) {
  *reinterpret_cast<uint4*>(p) = u;
}

// ATen's ReLU (clamp_min 0): a NaN passes
__device__ __forceinline__ float relu(float v) { return v > 0.f || v != v ? v : 0.f; }

// A thread's place: its column of 16-byte vectors (`vecs` a row) and its
// lane of rows; threads past the last whole lane idle. False where idle.
struct Place {
  long long lane, lanes;
  int col;
};

__device__ __forceinline__ bool place(int vecs, Place& p) {
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  p.lanes = static_cast<long long>(gridDim.x) * kThreads / vecs;
  p.lane = tid / vecs;
  p.col = static_cast<int>(tid - p.lane * vecs);
  return p.lane < p.lanes;
}

template <typename T, int FORM>
__global__ void __launch_bounds__(kThreads)
frozen_bn_act_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                         const T* __restrict__ mul, const T* __restrict__ add,
                         const T* __restrict__ mul_r, const T* __restrict__ add_r,
                         T* __restrict__ y, long long rows, int vecs) {
  constexpr int N = 16 / sizeof(T);
  Place p;
  if (!place(vecs, p)) return;
  float m[N], a[N], mr[N], ar[N];
  unpack<T>(ld16(mul + p.col * N), m);
  unpack<T>(ld16(add + p.col * N), a);
  if (FORM == 2) {
    unpack<T>(ld16(mul_r + p.col * N), mr);
    unpack<T>(ld16(add_r + p.col * N), ar);
  }
  const long long c = static_cast<long long>(vecs) * N;
  const long long at = static_cast<long long>(p.col) * N;
  for (long long row = p.lane; row < rows; row += p.lanes * kUnroll) {
    uint4 xv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = row + u * p.lanes;
      if (rr < rows) {
        xv[u] = ld16(x + rr * c + at);
        if (FORM > 0) rv[u] = ld16(r + rr * c + at);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = row + u * p.lanes;
      if (rr < rows) {
        float v[N], w[N];
        unpack<T>(xv[u], v);
        if (FORM > 0) unpack<T>(rv[u], w);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          float s = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(v[i], m[i])), a[i]));
          if (FORM == 2) w[i] = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(w[i], mr[i])), ar[i]));
          if (FORM > 0) s = rnd<T>(__fadd_rn(s, w[i]));
          v[i] = relu(s);
        }
        st16(y + rr * c + at, pack<T>(v));
      }
    }
  }
}

// FORM 0: g_x only; 1: g_r = g_s; 2: g_r = g_s·mul_r
template <typename T, int FORM>
__global__ void __launch_bounds__(kThreads)
frozen_bn_act_bwd_kernel(const T* __restrict__ g, const T* __restrict__ y,
                         const T* __restrict__ mul, const T* __restrict__ mul_r,
                         T* __restrict__ gx, T* __restrict__ gr, long long rows, int vecs) {
  constexpr int N = 16 / sizeof(T);
  Place p;
  if (!place(vecs, p)) return;
  float m[N], mr[N];
  unpack<T>(ld16(mul + p.col * N), m);
  if (FORM == 2) unpack<T>(ld16(mul_r + p.col * N), mr);
  const long long c = static_cast<long long>(vecs) * N;
  const long long at = static_cast<long long>(p.col) * N;
  for (long long row = p.lane; row < rows; row += p.lanes * kUnroll) {
    uint4 gv[kUnroll], yv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = row + u * p.lanes;
      if (rr < rows) {
        gv[u] = ld16(g + rr * c + at);
        yv[u] = ld16(y + rr * c + at);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = row + u * p.lanes;
      if (rr < rows) {
        float gs[N], yy[N], ox[N], orr[N];
        unpack<T>(gv[u], gs);
        unpack<T>(yv[u], yy);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          gs[i] = yy[i] <= 0.f ? 0.f : gs[i];
          ox[i] = __fmul_rn(gs[i], m[i]);
          if (FORM == 2) orr[i] = __fmul_rn(gs[i], mr[i]);
        }
        st16(gx + rr * c + at, pack<T>(ox));
        if (FORM == 1) st16(gr + rr * c + at, pack<T>(gs));
        if (FORM == 2) st16(gr + rr * c + at, pack<T>(orr));
      }
    }
  }
}

// The grid: enough CTAs for every row lane to take kUnroll rows, at most the
// CTAs the card holds at once (from the occupancy API, once a kernel), at
// least one whole lane.
template <typename K>
int grid_of(K kernel, long long rows, int vecs, int* resident) {
  if (*resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    *resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long lanes = (rows + kUnroll - 1) / kUnroll;
  long long grid = (lanes * vecs + kThreads - 1) / kThreads;
  if (grid > *resident) grid = *resident;
  const long long least = (vecs + kThreads - 1) / kThreads;
  return static_cast<int>(grid < least ? least : grid);
}

template <typename T, int FORM>
void fwd(const void* x, const void* r, const void* mul, const void* add, const void* mul_r,
         const void* add_r, void* y, long long rows, int vecs, cudaStream_t stream) {
  static int resident = 0;
  auto k = frozen_bn_act_fwd_kernel<T, FORM>;
  k<<<grid_of(k, rows, vecs, &resident), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const T*>(mul),
      static_cast<const T*>(add), static_cast<const T*>(mul_r), static_cast<const T*>(add_r),
      static_cast<T*>(y), rows, vecs);
}

template <typename T, int FORM>
void bwd(const void* g, const void* y, const void* mul, const void* mul_r, void* gx, void* gr,
         long long rows, int vecs, cudaStream_t stream) {
  static int resident = 0;
  auto k = frozen_bn_act_bwd_kernel<T, FORM>;
  k<<<grid_of(k, rows, vecs, &resident), kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(y), static_cast<const T*>(mul),
      static_cast<const T*>(mul_r), static_cast<T*>(gx), static_cast<T*>(gr), rows, vecs);
}

template <typename T>
void fwd_form(int form, const void* x, const void* r, const void* mul, const void* add,
              const void* mul_r, const void* add_r, void* y, long long rows, int vecs,
              cudaStream_t s) {
  if (form == 0) fwd<T, 0>(x, r, mul, add, mul_r, add_r, y, rows, vecs, s);
  else if (form == 1) fwd<T, 1>(x, r, mul, add, mul_r, add_r, y, rows, vecs, s);
  else fwd<T, 2>(x, r, mul, add, mul_r, add_r, y, rows, vecs, s);
}

template <typename T>
void bwd_form(int form, const void* g, const void* y, const void* mul, const void* mul_r,
              void* gx, void* gr, long long rows, int vecs, cudaStream_t s) {
  if (form == 0) bwd<T, 0>(g, y, mul, mul_r, gx, gr, rows, vecs, s);
  else if (form == 1) bwd<T, 1>(g, y, mul, mul_r, gx, gr, rows, vecs, s);
  else bwd<T, 2>(g, y, mul, mul_r, gx, gr, rows, vecs, s);
}

int vector_width(int dtype) { return dtype == RLOD_F32 ? 4 : 8; }

}  // namespace

// y = relu(x·mul + add [+ r | + (r·mul_r + add_r)]) over `rows` rows of `c`
// channels; r null: form 0; r given, mul_r null: form 1; both: form 2.
// Every pointer 16-byte aligned, c a multiple of 16 bytes' elements.
extern "C" int rlod_frozen_bn_act_fwd(const void* x, const void* r, const void* mul,
                                      const void* add, const void* mul_r, const void* add_r,
                                      void* y, long long rows, int c, int dtype, void* stream) {
  const int n = vector_width(dtype);
  if (c <= 0 || c % n != 0 || rows < 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaGetLastError();
  const int form = r == nullptr ? 0 : (mul_r == nullptr ? 1 : 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RLOD_F32)
    fwd_form<float>(form, x, r, mul, add, mul_r, add_r, y, rows, c / n, s);
  else
    fwd_form<__nv_bfloat16>(form, x, r, mul, add, mul_r, add_r, y, rows, c / n, s);
  return cudaGetLastError();
}

// g_x = (y <= 0 ? 0 : g)·mul; with gr given, g_r = (y <= 0 ? 0 : g), times
// mul_r where that is given.
extern "C" int rlod_frozen_bn_act_bwd(const void* g, const void* y, const void* mul,
                                      const void* mul_r, void* gx, void* gr, long long rows,
                                      int c, int dtype, void* stream) {
  const int n = vector_width(dtype);
  if (c <= 0 || c % n != 0 || rows < 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaGetLastError();
  const int form = gr == nullptr ? 0 : (mul_r == nullptr ? 1 : 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RLOD_F32)
    bwd_form<float>(form, g, y, mul, mul_r, gx, gr, rows, c / n, s);
  else
    bwd_form<__nv_bfloat16>(form, g, y, mul, mul_r, gx, gr, rows, c / n, s);
  return cudaGetLastError();
}
