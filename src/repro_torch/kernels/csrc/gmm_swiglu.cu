// Fused GMM1 + SwiGLU for Hopper (sm_90a): y = silu(x·Wg) * (x·Wu).
//
// Replaces the TPU kernel src/repro/kernels/gmm_swiglu.py::gmm_swiglu (body
// _gmm_swiglu_kernel): x [E, C, K] x w_in [E, K, 2F] -> y [E, C, F], where
// columns [0, F) of w_in are the gate and [F, 2F) the up projection. Like the
// Pallas kernel it keeps two fp32 accumulators for the same F columns and
// applies SwiGLU to them before the one store, so the [E, C, 2F]
// intermediate never reaches device memory.
//
// What bounds it (granite, bf16, E = 48, K = 1536, F = 512): in decode
// (C = 1, 2) and prefill (C = 27) each call reads all 151 MB of gate and up
// weights for about 2 C operations per weight byte, so the bytes bound it
// (0.045-0.047 ms at 3.35 TB/s). At the training shape (C = 854) it does
// 129 GFLOP on 0.32 GB: the operations bound it (0.130 ms at 989 TFLOP/s,
// against 0.095 ms of bytes), which only the tensor cores can approach.
//
// What the design does about it (gmm_tc.cuh, bf16): each CTA owns 64 or 128
// rows x 64 output columns of one expert and keeps its K reduction whole.
// Each 64-deep K step, a producer warp loads by TMA the x slice, the gate
// box w_in[:, k, n0:n0+64] and the up box w_in[:, k, F+n0:F+n0+64] into a
// 4-stage shared-memory ring (96-128 KB in flight per SM, enough for decode's
// bytes); one or two consumer warpgroups multiply x by both boxes with one
// m64n128 wgmma, so each thread holds the gate and the up sums of the same
// outputs in fp32 registers, and the epilogue forms silu(g)·u there and
// stores bf16 once. fp32 calls, and bf16 calls
// whose bases or row strides a tensor map cannot take (F = 18 in the ragged
// checks), run the first design's FMA body (gmm_common.cuh). Decode takes
// the tensor-core body too: at C = 1 and 2 it runs in about half the FMA
// body's time (PERF.md).

#include "gmm_common.cuh"
#include "gmm_tc.cuh"

// x [E, C, K] and w_in [E, K, 2F] contiguous. dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gmm_swiglu_launch(const void* x, const void* w_in, void* y,
                                 int E, int C, int K, int F, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && gmmtc::usable(x, w_in, y, C, K, F, 2 * F, 0, 0))
    return gmmtc::launch<true>(x, w_in, y, E, C, K, F, 0, 0, s);
  if (dtype == 0)
    return gmmk::launch<float, true>(x, w_in, y, E, C, K, F, 2 * F, 0, 0, s);
  if (dtype == 1)
    return gmmk::launch<__nv_bfloat16, true>(x, w_in, y, E, C, K, F, 2 * F, 0,
                                             0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
