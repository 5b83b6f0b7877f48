// Grouped GEMM for Hopper (sm_90a): y[e] = x[e] · w[e], fp32 sums.
//
// Replaces the TPU kernel src/repro/kernels/gmm.py::gmm (body _gmm_kernel):
// x [E, C, K] x w [E, K, N] -> y [E, C, N] in x's dtype. In the MoE block it
// is GMM2, the down projection (ops.moe_expert_ffn); training also runs it
// twice in GMM2's backward, dx = dy·wᵀ and dW = xᵀ·dy, on transposed views.
//
// What bounds it (granite, bf16, E = 48, K = 512, N = 1536): in decode
// (C = 1, 2) and prefill (C = 27) each call reads all 75.5 MB of weights for
// about 2 C operations per weight byte, far below the ~295 the card needs
// before arithmetic is the limit, so the bytes bound it (0.023-0.024 ms at
// 3.35 TB/s). At the training shape (C = 854, and the backward's two calls)
// it does 64.5 GFLOP on 0.24 GB: 0.065 ms of tensor-core work at 989 TFLOP/s
// against 0.073 ms of bytes, so both limits are close and only a tensor-core
// kernel that streams its operands can approach them.
//
// What the design does about it (gmm_tc.cuh, bf16): each CTA owns an output
// tile of one expert, 64 x 128 for C <= 64, else 128 x 128, or 128 x 256 from
// N = 1024 on, and keeps its K reduction whole. A
// producer warp streams 64-deep slices of x and w by TMA through a 4-stage
// shared-memory ring (96-128 KB in flight per SM; decode needs about 25 KB
// per SM to reach 3.35 TB/s), and one or two consumer warpgroups multiply
// them with wgmma into fp32 registers. The backward's operands stay views:
// the layout codes tell the tensor maps and wgmma's transpose bits how to
// read them, so nothing is copied. Decode takes the tensor-core body too: at
// C = 1 and 2 it runs in about half the FMA body's time (PERF.md).
//
// fp32 calls: the wrapper picks the body (kernels/gmm.py, fp32_tile). The
// dropless fragment's tiles (E = 1, fp32) that fill the card
// (gmm.tiled_takes) run the register-blocked tiled body (gmm_fp32.cuh) at
// the tile the wrapper names; smaller ones run the narrow body
// (gmm_fp32_narrow.cuh: 8-column CTAs fed by TMA through an mbarrier ring)
// at the configuration the wrapper names, where TMA can describe the call;
// the rest (x a transposed view in the narrow body's range, widths or
// bases neither body takes) run the small-row body (gmm_fp32_small.cuh). All three sum
// each output in one fmaf chain over ascending k, so an fp32 row's bits do
// not depend on the call's row count or on the body. bf16 calls whose
// bases or row strides a tensor map cannot take (N = 18 in the ragged
// checks) run the first design's FMA body (gmm_common.cuh). All the bodies
// read the same layouts.

#include "gmm_common.cuh"
#include "gmm_fp32.cuh"
#include "gmm_fp32_narrow.cuh"
#include "gmm_fp32_small.cuh"
#include "gmm_tc.cuh"

// a_layout: 0 = x is [E, C, K]; 1 = x is stored [E, K, C] (a transposed
// view). b_layout: 0 = w is [E, K, N]; 1 = w is stored [E, N, K]. body:
// 0 = for bf16 the tensor cores (where a tensor map fits) or the FMA body,
// for fp32 the small-row body (gmms::launch); 1-3 = the fp32 tiled body at
// that tile (gmmf::launch); 4 and up = the fp32 narrow body at that
// configuration (gmmn::launch). A tiled or narrow code is refused with an
// error for bf16 or a call its body cannot take. dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gmm_launch(const void* x, const void* w, void* y, int E, int C,
                          int K, int N, int a_layout, int b_layout, int body,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body >= 4)
    return dtype == 0 ? gmmn::launch(x, w, y, E, C, K, N, a_layout, b_layout,
                                     body, s)
                      : static_cast<int>(cudaErrorInvalidValue);
  if (body != 0)
    return dtype == 0 ? gmmf::launch(x, w, y, E, C, K, N, a_layout, b_layout,
                                     body, s)
                      : static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 &&
      gmmtc::usable(x, w, y, C, K, N, b_layout ? K : N, a_layout, b_layout))
    return gmmtc::launch<false>(x, w, y, E, C, K, N, a_layout, b_layout, s);
  if (dtype == 0)
    return gmms::launch(x, w, y, E, C, K, N, a_layout, b_layout, s);
  if (dtype == 1)
    return gmmk::launch<__nv_bfloat16, false>(x, w, y, E, C, K, N, N,
                                              a_layout, b_layout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
