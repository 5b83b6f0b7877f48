// Grouped GEMM for Hopper (sm_90a): y[e] = x[e] · w[e], fp32 sums.
//
// Replaces the TPU kernel src/repro/kernels/gmm.py::gmm (body _gmm_kernel):
// x [E, C, K] x w [E, K, N] -> y [E, C, N] in x's dtype. In the MoE block it
// is GMM2, the down projection (ops.moe_expert_ffn).
//
// What bounds it: on the serving path C is the per-expert capacity — 1 or 2
// rows in a decode step, 27 in a 128-token prefill — while all E experts'
// weights are read on every call (granite: 48 x 512 x 1536 bf16 = 75.5 MB).
// That is about 2 x C operations per weight byte, far below the ~295 the
// card needs before its arithmetic is the limit, so the kernel is bound by
// reading w once from device memory.
//
// What the design does about it (gmm_common.cuh): one CTA per (expert,
// 64-column tile) holds every row of its expert, so each weight byte is read
// once per call, in full 128-byte lines by half-warps; with few rows the 16
// lanes of a column group split K instead, so even C = 1 keeps 256 threads
// streaming weights. Plain fp32 FMAs are enough at these row counts; the
// Tensor-Core (wgmma/TMA) version is later work.

#include "gmm_common.cuh"

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int gmm_launch(const void* x, const void* w, void* y, int E, int C,
                          int K, int N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gmmk::launch<float, false>(x, w, y, E, C, K, N, N, s);
  if (dtype == 1)
    return gmmk::launch<__nv_bfloat16, false>(x, w, y, E, C, K, N, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
