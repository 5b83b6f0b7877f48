// Fused GMM1 + SwiGLU for Hopper (sm_90a): y = silu(x·Wg) * (x·Wu).
//
// Replaces the TPU kernel src/repro/kernels/gmm_swiglu.py::gmm_swiglu (body
// _gmm_swiglu_kernel): x [E, C, K] x w_in [E, K, 2F] -> y [E, C, F], where
// columns [0, F) of w_in are the gate and [F, 2F) the up projection. Like the
// Pallas kernel it keeps two fp32 accumulators for the same F columns and
// applies SwiGLU to them before the one store, so the [E, C, 2F]
// intermediate never reaches device memory.
//
// What bounds it: every call reads all E experts' gate and up weights
// (granite: 48 x 1536 x 1024 bf16 = 151 MB) for C = 1, 2 (decode) or 27
// (prefill) rows, about 2 x C operations per weight byte: the kernel is bound
// by reading w_in once from device memory.
//
// What the design does about it (gmm_common.cuh): each CTA owns 64 output
// columns of one expert and reads the matching gate and up columns once, in
// full 128-byte lines, for every row of that expert; small C splits K across
// the CTA's lanes so all 256 threads stream weights. fp32 FMAs on the
// registers; the Tensor-Core (wgmma/TMA) version is later work.

#include "gmm_common.cuh"

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int gmm_swiglu_launch(const void* x, const void* w_in, void* y,
                                 int E, int C, int K, int F, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gmmk::launch<float, true>(x, w_in, y, E, C, K, F, 2 * F, s);
  if (dtype == 1)
    return gmmk::launch<__nv_bfloat16, true>(x, w_in, y, E, C, K, F, 2 * F,
                                             s);
  return static_cast<int>(cudaErrorInvalidValue);
}
