// SwiGLU + Add for Hopper (sm_90a), serial and interleaved: the paper's
// §6.1 microbenchmark.
//
// Replaces the TPU kernels of src/repro/kernels/swiglu_add.py:
//   swiglu_add_serial      (_swiglu_kernel, then _add_kernel): two passes,
//                          g = silu(h[:, :F]) * h[:, F:] stored to device
//                          memory in h's dtype, then read back for g + y;
//   swiglu_add_interleaved (_swiglu_add_kernel): one pass,
//                          silu(h[:, :F]) * h[:, F:] + y in fp32, one store.
// h [M, 2F], y [M, F] -> out [M, F], float32 or bfloat16, fp32 arithmetic.
//
// What bounds it: about 5 operations per output element against 8 (bf16) or
// 16 (fp32) bytes moved, far below the ~295 operations per byte the card
// needs before arithmetic is the limit, so every kernel here is bound by
// device-memory bytes. Interleaved moves h, y and out once (4 elements per
// output); serial also writes g and reads it back (6).
//
// What the design does about it: each thread owns 16 bytes of a row (8 bf16
// or 4 fp32 elements) and moves a, b, y and out with one 16-byte load or
// store each, neighbouring threads on neighbouring addresses, in a
// grid-stride loop. The vector kernel runs when F is a multiple of the vector
// width and every base pointer is 16-byte aligned, so every row is aligned;
// otherwise the scalar kernel runs, one element a thread. Rows need no tile
// size, so any M and any even 2F are masked by the loop bound alone. The two
// serial kernels are deliberately not fused: the HBM round trip of g is what
// the benchmark measures.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace swa {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;   // 32 CTAs of 256 per SM

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as XLA's convert
}

// N elements from p into r: one 16-byte access when N * sizeof(T) == 16.
template <typename T, int N>
__device__ __forceinline__ void ld(T (&r)[N], const T* p) {
  if constexpr (N * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(r) = *reinterpret_cast<const uint4*>(p);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) r[k] = p[k];
  }
}
template <typename T, int N>
__device__ __forceinline__ void st(T* p, const T (&r)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(r);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = r[k];
  }
}

// silu(a) * b with jax.nn.sigmoid's form, in fp32.
__device__ __forceinline__ float swiglu(float a, float b) {
  return a * (1.0f / (1.0f + expf(-a))) * b;
}

enum Op { kSwiGLU = 0, kAdd = 1, kSwiGLUAdd = 2 };

// One kernel body for the three passes over rows of width F:
//   kSwiGLU    in0 = h [M, 2F]          -> out = swiglu(a, b)
//   kAdd       in0 = g [M, F], in1 = y  -> out = g + y
//   kSwiGLUAdd in0 = h [M, 2F], in1 = y -> out = swiglu(a, b) + y
// N elements a thread: 16 / sizeof(T) on the vector path, 1 on the scalar.
template <typename T, int OP, int N>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const T* __restrict__ in0, const T* __restrict__ in1,
            T* __restrict__ out, int M, int F) {
  const int64_t per_row = F / N;
  const int64_t total = static_cast<int64_t>(M) * per_row;
  const int64_t in0_width = OP == kAdd ? F : 2 * static_cast<int64_t>(F);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t m = i / per_row;
    const int64_t c = (i - m * per_row) * N;
    __align__(16) T a[N];
    __align__(16) T o[N];
    ld<T, N>(a, in0 + m * in0_width + c);
    if constexpr (OP == kAdd) {
      __align__(16) T y[N];
      ld<T, N>(y, in1 + m * F + c);
#pragma unroll
      for (int k = 0; k < N; ++k) o[k] = from_f<T>(to_f(a[k]) + to_f(y[k]));
    } else {
      __align__(16) T b[N];
      ld<T, N>(b, in0 + m * in0_width + F + c);
      if constexpr (OP == kSwiGLU) {
#pragma unroll
        for (int k = 0; k < N; ++k)
          o[k] = from_f<T>(swiglu(to_f(a[k]), to_f(b[k])));
      } else {
        __align__(16) T y[N];
        ld<T, N>(y, in1 + m * F + c);
#pragma unroll
        for (int k = 0; k < N; ++k)
          o[k] = from_f<T>(swiglu(to_f(a[k]), to_f(b[k])) + to_f(y[k]));
      }
    }
    st<T, N>(out + m * F + c, o);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int OP, int N>
int launch_n(const void* in0, const void* in1, void* out, int M, int F,
             cudaStream_t s) {
  const int64_t total = static_cast<int64_t>(M) * (F / N);
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  rows_kernel<T, OP, N><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(in0), static_cast<const T*>(in1),
      static_cast<T*>(out), M, F);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int OP>
int launch(const void* in0, const void* in1, void* out, int M, int F,
           cudaStream_t s) {
  if (M <= 0 || F <= 0) return 0;
  constexpr int V = 16 / sizeof(T);
  const bool vec = F % V == 0 && aligned16(in0) && aligned16(out) &&
                   (OP == kSwiGLU || aligned16(in1));
  return vec ? launch_n<T, OP, V>(in0, in1, out, M, F, s)
             : launch_n<T, OP, 1>(in0, in1, out, M, F, s);
}

template <int OP>
int dispatch(const void* in0, const void* in1, void* out, int M, int F,
             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, OP>(in0, in1, out, M, F, s);
  if (dtype == 1) return launch<__nv_bfloat16, OP>(in0, in1, out, M, F, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace swa

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after
// its launch (0 on success).

// Serial, first kernel: h [M, 2F] -> g [M, F] in h's dtype.
extern "C" int swiglu_launch(const void* h, void* g, int M, int F, int dtype,
                             void* stream) {
  return swa::dispatch<swa::kSwiGLU>(h, nullptr, g, M, F, dtype, stream);
}

// Serial, second kernel: g [M, F] + y [M, F] -> out [M, F].
extern "C" int add_launch(const void* g, const void* y, void* out, int M,
                          int F, int dtype, void* stream) {
  return swa::dispatch<swa::kAdd>(g, y, out, M, F, dtype, stream);
}

// Interleaved: h [M, 2F], y [M, F] -> out [M, F] in one pass.
extern "C" int swiglu_add_launch(const void* h, const void* y, void* out,
                                 int M, int F, int dtype, void* stream) {
  return swa::dispatch<swa::kSwiGLUAdd>(h, y, out, M, F, dtype, stream);
}
