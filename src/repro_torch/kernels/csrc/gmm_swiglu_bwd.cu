// Backward of the fused GMM1 + SwiGLU for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gmm_swiglu_bwd.py::
// gmm_swiglu_bwd (bodies _dx_kernel and _dw_kernel). With x [E, C, K],
// w_in [E, K, 2F] (gate columns [0, F), up columns [F, 2F)) and dout
// [E, C, F], it recomputes g = x·Wg and u = x·Wu, forms
//   dg = dout * u * silu'(g),   du = dout * silu(g),
// and returns fp32 sums, stored as fp32 or rounded once to bf16:
//   dx  [E, C, K]  = dg·Wgᵀ + du·Wuᵀ          (summed over F)
//   dw  [E, K, 2F] = xᵀ·dg ‖ xᵀ·du            (summed over C)
// dw in w_in's layout is the JAX [E, K, 2, F] dw4.
//
// What bounds it: at the training shape (granite, E = 48, C = 854,
// K = 1536, F = 512) the recompute, dx and dW are three products of
// 2·E·C·K·2F operations each, 386.8 GFLOP against 873 MB of inputs and
// fp32 outputs: the work is bound by operations, 0.39 ms at the card's
// bf16 tensor-core rate.
//
// What the design does about it: three launches of one tensor-core body
// (namespace gsbtc, bf16 operands; the mainloop of gmm_tc.cuh: a persistent
// CTA per SM, one TMA producer warp, a 4-stage ring of 128-byte-swizzled
// 64 x 64 boxes, two wgmma consumer warpgroups, 128-row tiles). As the
// paper's GMM rule asks (gmm.py), each CTA keeps its whole reduction: no
// split-K, no atomics, repeat calls are bit-equal.
//   1. GU: [g ‖ u] = x·[Wg ‖ Wu] over K, as gmm_swiglu's product (64 f a
//      tile: the gate and up boxes form one n128 product). The epilogue
//      reads the tile's dout (loaded into registers before the mainloop),
//      forms dg and du in fp32 with _silu_grads' formulas, and stores each
//      value v as hi = bf16(v) and lo = bf16(v - hi) (v - hi is exact in
//      fp32) into bf16 scratch dgu_hi, dgu_lo [E, C, 2F] in w_in's column
//      layout, through swizzled shared memory and TMA stores.
//   2. DX: dx = dgu_hi·w_inᵀ over 2F, 128 x 256 tiles, w_in read K-major
//      in place. wgmma takes both operands in one type, so dgu reaches the
//      products as bf16: hi alone keeps dx within 2e-2 (+ 2e-2·|dx|) of
//      the fp32 sums.
//   3. DW: dw = xᵀ·dgu_hi + xᵀ·dgu_lo over C, 128 x 128 tiles, x read
//      M-major in place; each stage carries the x boxes and both B pairs,
//      and both products accumulate into one set of registers. dW sums ~C
//      terms that cancel, which a single bf16 rounding of dgu moves past
//      that limit; the hi + lo pair keeps about 16 bits of each value.
//   TMA zero-fills past C, K and 2F, which masks every ragged reduction.
//   bf16 outputs go through swizzled shared memory and a TMA store; fp32
//   outputs (the JAX contract) are stored from registers, since their
//   staging would not fit beside four stages.
// bf16 calls whose operands a tensor map cannot describe (F or K not a
// multiple of 8, bases not 16-byte aligned) and fp32 calls run the first
// design below (namespace gsb, fp32 FMAs): 18.3 ms at the training shape on
// an H100, where the tensor-core body's time is in PERF.md.

#include "gmm_common.cuh"
#include "gmm_tc.cuh"

// The first design, fp32 FMAs on CUDA cores: the three products as three
// tiled GEMMs of one shape of CTA, small enough for several CTAs per SM to
// hide each other's load latency:
//   1. gu_kernel: [g ‖ u] = x·[Wg ‖ Wu] over K, then dg and du in the
//      epilogue, written to the fp32 scratch dgu [E, C, 2F];
//   2. dx_kernel: dx = dgu·w_inᵀ over 2F;
//   3. dw_kernel: dw = xᵀ·dgu over C.
// A CTA owns a 64 x 64 output tile of one expert (4 x 4 per thread) and
// loops over the reduction itself, 16 at a time through shared memory.
// Ragged C, K and F are masked; nothing needs to divide a tile size. (An
// earlier design fused 1 and 2 in one CTA per 16 rows with a [16, K] fp32
// accumulator in shared memory, as the Pallas dx body keeps its [bm, K]
// block. At one CTA per SM its loads stalled: 79.1 ms at the training
// shape on an H100, against 18.3 ms for these three kernels.)
namespace gsb {

using gmmk::to_f;

constexpr int THREADS = 256;
constexpr int TM = 64;              // output tile rows
constexpr int TN = 64;              // output tile columns
constexpr int TR = 16;              // reduction step staged in shared memory
constexpr int LD = TN + 4;          // padded shared-memory row
static_assert(THREADS == (TM / 4) * (TN / 4), "4 x 4 outputs per thread");
static_assert(TM == TN, "one staging loop serves both operands");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// s[r][c] = val(r0 + r, c) for the TR x TN stage. RED_FAST: the reduction
// index is the contiguous one in memory, so neighbouring threads take
// neighbouring r; otherwise neighbouring c.
template <bool RED_FAST, class Val>
__device__ __forceinline__ void stage(float (*s)[LD], int r0, Val val) {
  for (int i = threadIdx.x; i < TR * TN; i += THREADS) {
    const int r = RED_FAST ? i % TR : i / TN;
    const int c = RED_FAST ? i / TR : i % TN;
    s[r][c] = val(r0 + r, c);
  }
}

// acc[i][j] = sum over r < red of A(4·ty + i, r) · B(r, 4·tx + j), for the
// thread (tx, ty) = (tid % 16, tid / 16). A and B return 0 outside the
// operands, so the ragged edges add nothing.
template <bool A_RED_FAST, bool B_RED_FAST, class AVal, class BVal>
__device__ __forceinline__ void tile_gemm(float (&acc)[4][4], int red,
                                          AVal a_val, BVal b_val) {
  __shared__ __align__(16) float as[TR][LD];   // as[r][m]
  __shared__ __align__(16) float bs[TR][LD];   // bs[r][n]
  const int tx = threadIdx.x % (TN / 4), ty = threadIdx.x / (TN / 4);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int r0 = 0; r0 < red; r0 += TR) {
    __syncthreads();
    stage<A_RED_FAST>(as, r0, a_val);
    stage<B_RED_FAST>(bs, r0, b_val);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const float4 a = ld4(&as[r][ty * 4]);
      const float4 b = ld4(&bs[r][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// 1. Grid (ceil(F / 32), ceil(C / 64), E). Tile column n = 4p + q holds
// gate (q < 2) or up (q >= 2) of f = f0 + 2p + q % 2, so each thread has the
// gate and up sums of the same two f.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gu_kernel(const T* __restrict__ x, const T* __restrict__ w,
          const T* __restrict__ dout, float* __restrict__ dgu, int C, int K,
          int F) {
  const int e = blockIdx.z, m0 = blockIdx.y * TM, f0 = blockIdx.x * TN / 2;
  const int twoF = 2 * F;
  const T* xe = x + (size_t)e * C * K;
  const T* we = w + (size_t)e * K * twoF;
  float acc[4][4];
  tile_gemm<true, false>(
      acc, K,
      [&](int k, int m) {
        return m0 + m < C && k < K ? to_f(xe[(size_t)(m0 + m) * K + k]) : 0.f;
      },
      [&](int k, int n) {
        const int f = f0 + n / 4 * 2 + n % 2;
        return k < K && f < F
                   ? to_f(we[(size_t)k * twoF + (n % 4 < 2 ? f : F + f)])
                   : 0.f;
      });
  const int tx = threadIdx.x % (TN / 4), ty = threadIdx.x / (TN / 4);
  const T* de = dout + (size_t)e * C * F;
  float* ge = dgu + (size_t)e * C * twoF;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int f = f0 + tx * 2 + q;
      if (row >= C || f >= F) continue;
      const float g = acc[i][q], u = acc[i][2 + q];
      const float sig = 1.f / (1.f + expf(-g));
      const float dsilu = sig * (1.f + g * (1.f - sig));
      const float d = to_f(de[(size_t)row * F + f]);
      ge[(size_t)row * twoF + f] = d * u * dsilu;
      ge[(size_t)row * twoF + F + f] = d * (g * sig);
    }
  }
}

// 2. Grid (ceil(K / 64), ceil(C / 64), E): dx[c, k] = sum_j dgu[c, j] w[k, j].
template <typename T>
__global__ void __launch_bounds__(THREADS)
dx_kernel(const float* __restrict__ dgu, const T* __restrict__ w,
          float* __restrict__ dx, int C, int K, int F) {
  const int e = blockIdx.z, m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int twoF = 2 * F;
  const float* ge = dgu + (size_t)e * C * twoF;
  const T* we = w + (size_t)e * K * twoF;
  float acc[4][4];
  tile_gemm<true, true>(
      acc, twoF,
      [&](int j, int m) {
        return m0 + m < C && j < twoF ? ge[(size_t)(m0 + m) * twoF + j] : 0.f;
      },
      [&](int j, int n) {
        return n0 + n < K && j < twoF ? to_f(we[(size_t)(n0 + n) * twoF + j])
                                      : 0.f;
      });
  const int tx = threadIdx.x % (TN / 4), ty = threadIdx.x / (TN / 4);
  float* dxe = dx + (size_t)e * C * K;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = n0 + tx * 4 + j;
      if (row < C && k < K) dxe[(size_t)row * K + k] = acc[i][j];
    }
  }
}

// 3. Grid (ceil(2F / 64), ceil(K / 64), E): dw[k, j] = sum_c x[c, k] dgu[c, j].
template <typename T>
__global__ void __launch_bounds__(THREADS)
dw_kernel(const T* __restrict__ x, const float* __restrict__ dgu,
          float* __restrict__ dw, int C, int K, int F) {
  const int e = blockIdx.z, m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int twoF = 2 * F;
  const T* xe = x + (size_t)e * C * K;
  const float* ge = dgu + (size_t)e * C * twoF;
  float acc[4][4];
  tile_gemm<false, false>(
      acc, C,
      [&](int c, int m) {
        return c < C && m0 + m < K ? to_f(xe[(size_t)c * K + m0 + m]) : 0.f;
      },
      [&](int c, int n) {
        return c < C && n0 + n < twoF ? ge[(size_t)c * twoF + n0 + n] : 0.f;
      });
  const int tx = threadIdx.x % (TN / 4), ty = threadIdx.x / (TN / 4);
  float* dwe = dw + (size_t)e * K * twoF;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (k < K && n < twoF) dwe[(size_t)k * twoF + n] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* x, const void* w_in, const void* dout, void* dx,
           void* dw, void* dgu, int E, int C, int K, int F,
           cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w_in);
  float* gp = static_cast<float*>(dgu);
  const int cm = (C + TM - 1) / TM;
  gu_kernel<T><<<dim3((2 * F + TN - 1) / TN, cm, E), THREADS, 0, stream>>>(
      xp, wp, static_cast<const T*>(dout), gp, C, K, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dx_kernel<T><<<dim3((K + TN - 1) / TN, cm, E), THREADS, 0, stream>>>(
      gp, wp, static_cast<float*>(dx), C, K, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_kernel<T><<<dim3((2 * F + TN - 1) / TN, (K + TM - 1) / TM, E), THREADS,
                 0, stream>>>(xp, gp, static_cast<float*>(dw), C, K, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gsb

namespace gsbtc {

using gmmtc::BK;
using gmmtc::BOX;
using gmmtc::BOX_BYTES;
using gmmtc::STAGES;
using gmmtc::PRODUCER_THREADS;
using gmmtc::smem_u32;
using gmmtc::mbar_init;
using gmmtc::mbar_expect_tx;
using gmmtc::mbar_arrive;
using gmmtc::mbar_wait;
using gmmtc::tma_load;
using gmmtc::tma_store;
using gmmtc::bar_sync;
using gmmtc::smem_desc;
using gmmtc::wg_fence;
using gmmtc::wg_commit;
using gmmtc::wg_wait;
using gmmtc::fence_acc;
using gmmtc::wgmma_m64n128k16;

enum Mode { GU = 0, DX = 1, DW = 2 };
constexpr int NWG = 2;                      // consumer warpgroups: 128 rows
constexpr int THREADS = NWG * 128 + PRODUCER_THREADS;

// Per mode and output type: A M-major (TA) or K-major; B K-major (TB) or
// N-major; B boxes a stage; n128 accumulators a warpgroup; output columns a
// tile; output staging, boxes a warpgroup (GU's dg, du for hi and lo; a
// bf16 product's two, reused for each accumulator; none for fp32 stores);
// dynamic shared memory.
template <int MODE, bool F32>
struct Cfg {
  static constexpr int TA = MODE == DW;
  static constexpr int TB = MODE == DX;
  static constexpr int NB = MODE == GU ? 2 : 4;
  static constexpr int NACC = MODE == DX ? 2 : 1;
  static constexpr int BN = MODE == GU ? BOX : 128 * NACC;
  static constexpr int STAGE = (NWG + NB) * BOX_BYTES;
  static constexpr int OUTB = MODE == GU ? 4 : (F32 ? 0 : 2);
  static constexpr int SMEM =
      STAGES * STAGE + NWG * OUTB * BOX_BYTES + 1024 + 2 * STAGES * 8;
};

// Tensor maps of one launch (gmm_tc.cuh's encode): A, B, GU's and DW's
// second B (dgu_lo), and the bf16 outputs: y0 for a product; dg_hi, du_hi,
// dg_lo, du_lo for GU.
struct Maps {
  CUtensorMap a, b, b2, y0, y1, y2, y3;
};

// y [E, M, N] fp32 (F32) or through maps.y*; dout [E, M, F] (GU). red: the
// reduction's extent (K, 2F or C).
template <int MODE, bool F32>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_kernel(const __grid_constant__ Maps maps,
               const __nv_bfloat16* __restrict__ dout, float* __restrict__ y,
               int M, int N, int red, int F, int tiles_m, int tiles_n,
               int tiles) {
  using C = Cfg<MODE, F32>;
  constexpr int TA = C::TA, TB = C::TB, NB = C::NB, NACC = C::NACC;
  constexpr int BM = 64 * NWG, BN = C::BN, STAGE = C::STAGE;
  constexpr int A_BYTES = NWG * BOX_BYTES;
  constexpr int OUTB = C::OUTB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t out = base + STAGES * STAGE;   // output staging
  const uint32_t bars = out + NWG * OUTB * BOX_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const int nk = (red + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= NWG * 128) {
    // Producer: one thread issues every load.
    if (tid != NWG * 128) return;
    const CUtensorMap* in[3] = {&maps.a, &maps.b, &maps.b2};
#pragma unroll
    for (int i = 0; i < (MODE == DW ? 3 : 2); ++i)
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(in[i]))
                   : "memory");
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const gmmtc::Tile tl = gmmtc::tile_of(t, tiles_m, tiles_n, BM, BN);
      for (int kb = 0; kb < nk; ++kb) {
        const int k0 = kb * BK;
        mbar_wait(empty(s), ph ^ 1);
        mbar_expect_tx(full(s), STAGE);
        const uint32_t st = base + s * STAGE;
#pragma unroll
        for (int w = 0; w < NWG; ++w) {
          if (TA == 0)
            tma_load(st + w * BOX_BYTES, &maps.a, full(s), k0,
                     tl.m0 + w * BOX, tl.e);
          else
            tma_load(st + w * BOX_BYTES, &maps.a, full(s), tl.m0 + w * BOX,
                     k0, tl.e);
        }
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          const uint32_t dst = st + A_BYTES + q * BOX_BYTES;
          if (MODE == GU)   // the gate box, then the up box of the same f
            tma_load(dst, &maps.b, full(s), q ? F + tl.n0 : tl.n0, k0, tl.e);
          else if (MODE == DX)
            tma_load(dst, &maps.b, full(s), k0, tl.n0 + q * BOX, tl.e);
          else              // dgu_hi's pair, then dgu_lo's
            tma_load(dst, q < 2 ? &maps.b : &maps.b2, full(s),
                     tl.n0 + (q % 2) * BOX, k0, tl.e);
        }
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile.
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int warp = (tid % 128) / 32;
  const bool signals = tid % 128 == 0;
  constexpr uint32_t LBO_A = TA ? BOX_BYTES : 16;
  constexpr uint32_t LBO_B = TB ? 16 : BOX_BYTES;
  // Fragment of m64nNk16: register 4 j + 2 h + i holds row
  // 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + i.
  const int cl = 2 * (lane % 4);
  const int rl = warp * 16 + lane / 4;   // row within the warpgroup's 64
  int s = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const gmmtc::Tile tl = gmmtc::tile_of(t, tiles_m, tiles_n, BM, BN);
    // GU: this thread's dout pairs, read before the mainloop so that the
    // loads overlap it; dv[2 j + h] holds row rl + 8 h, columns 8 j + cl
    // and + 1 (F is even, so a pair never straddles a row).
    uint32_t dv[MODE == GU ? 16 : 1];
    if constexpr (MODE == GU) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = tl.m0 + wg * 64 + rl + 8 * h;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tl.n0 + 8 * j + cl;
          dv[2 * j + h] =
              row < M && c < F
                  ? __ldg(reinterpret_cast<const unsigned int*>(
                        dout + (static_cast<size_t>(tl.e) * M + row) * F +
                        c))
                  : 0u;
        }
      }
    }
    float acc[NACC][64];
#pragma unroll
    for (int p = 0; p < NACC; ++p) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[p][i] = 0.f;
      fence_acc(acc[p]);
    }
    int prev = -1;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(full(s), ph);
      const uint32_t st = base + s * STAGE;
      const uint32_t a = st + wg * BOX_BYTES;
      const uint32_t b = st + A_BYTES;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // 16 more of the reduction: 32 bytes along a K-major row, or 16
        // rows (2 KB) of an MN-major box.
        const uint64_t da =
            smem_desc(a + (TA ? kk * 2048 : kk * 32), LBO_A);
        const uint32_t boff = TB ? kk * 32 : kk * 2048;
        if (MODE == DW) {
          // hi, then lo, into the same sums.
          wgmma_m64n128k16<TA, TB>(acc[0], da, smem_desc(b + boff, LBO_B));
          wgmma_m64n128k16<TA, TB>(
              acc[0], da, smem_desc(b + 2 * BOX_BYTES + boff, LBO_B));
        } else {
#pragma unroll
          for (int p = 0; p < NACC; ++p)
            wgmma_m64n128k16<TA, TB>(
                acc[p], da, smem_desc(b + 2 * p * BOX_BYTES + boff, LBO_B));
        }
      }
      wg_commit();
      wg_wait<1>();   // the products of the previous stage are done
      if (prev >= 0 && signals) mbar_arrive(empty(prev));
      prev = s;
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    wg_wait<0>();
#pragma unroll
    for (int p = 0; p < NACC; ++p) fence_acc(acc[p]);
    if (prev >= 0 && signals) mbar_arrive(empty(prev));

    if constexpr (F32) {
      // fp32 from registers: 8 bytes a store, rows and columns past M and
      // N left out (N is even).
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = tl.m0 + wg * 64 + rl + 8 * h;
        if (row >= M) continue;
        float* yr = y + (static_cast<size_t>(tl.e) * M + row) * N;
#pragma unroll
        for (int p = 0; p < NACC; ++p)
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int c = tl.n0 + 128 * p + 8 * j + cl;
            const int i = 4 * j + 2 * h;
            if (c < N)
              *reinterpret_cast<float2*>(yr + c) =
                  make_float2(acc[p][i], acc[p][i + 1]);
          }
      }
      continue;
    }
    // Through shared memory: the warpgroup writes its boxes in the 128-byte
    // swizzle, then one thread hands them to TMA, which stores them while
    // the next tile's products run (and drops what falls outside the
    // tensor). Before reusing the staging, that thread waits until TMA has
    // read the last boxes.
    const uint32_t ob = out + wg * OUTB * BOX_BYTES;
    auto put = [&](int box, int j8, int h, __nv_bfloat162 v) {
      const int r = rl + 8 * h;
      const uint32_t addr =
          ob + box * BOX_BYTES + r * 128 + ((j8 ^ (r % 8)) << 4) + cl * 2;
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr),
                   "r"(*reinterpret_cast<const uint32_t*>(&v))
                   : "memory");
    };
    const int m = tl.m0 + wg * 64;
    if constexpr (MODE == GU) {
      if (signals)
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      bar_sync(1 + wg, 128);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // Columns [0, 64) of the product are the gate, [64, 128) the up.
          const int i = 4 * j + 2 * h;
          // A bf16 is the top half of the fp32 of the same value; the
          // lower column sits in the low 16 bits.
          const float dd[2] = {__uint_as_float(dv[2 * j + h] << 16),
                               __uint_as_float(dv[2 * j + h] & 0xffff0000u)};
          float dg[2], du[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float g = acc[0][i + e], u = acc[0][i + 32 + e];
            const float d = dd[e];
            const float sig = 1.f / (1.f + expf(-g));
            const float dsilu = sig * (1.f + g * (1.f - sig));
            dg[e] = d * u * dsilu;
            du[e] = d * (g * sig);
          }
          const __nv_bfloat162 dg_hi = __floats2bfloat162_rn(dg[0], dg[1]);
          const __nv_bfloat162 du_hi = __floats2bfloat162_rn(du[0], du[1]);
          put(0, j, h, dg_hi);
          put(1, j, h, du_hi);
          put(2, j, h,
              __floats2bfloat162_rn(dg[0] - __low2float(dg_hi),
                                    dg[1] - __high2float(dg_hi)));
          put(3, j, h,
              __floats2bfloat162_rn(du[0] - __low2float(du_hi),
                                    du[1] - __high2float(du_hi)));
        }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_sync(1 + wg, 128);
      if (signals) {
        tma_store(&maps.y0, ob, tl.n0, m, tl.e);
        tma_store(&maps.y1, ob + BOX_BYTES, tl.n0, m, tl.e);
        tma_store(&maps.y2, ob + 2 * BOX_BYTES, tl.n0, m, tl.e);
        tma_store(&maps.y3, ob + 3 * BOX_BYTES, tl.n0, m, tl.e);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    } else {
#pragma unroll
      for (int p = 0; p < NACC; ++p) {
        if (signals)
          asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        bar_sync(1 + wg, 128);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int i = 4 * j + 2 * h;
            put(j / 8, j % 8, h,
                __floats2bfloat162_rn(acc[p][i], acc[p][i + 1]));
          }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        bar_sync(1 + wg, 128);
        if (signals) {
          tma_store(&maps.y0, ob, tl.n0 + 128 * p, m, tl.e);
          tma_store(&maps.y0, ob + BOX_BYTES, tl.n0 + 128 * p + BOX, m,
                    tl.e);
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        }
      }
    }
  }
  // The staging must outlive the last TMA store.
  if (OUTB && signals)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int MODE, bool F32>
int run(const Maps& maps, const __nv_bfloat16* dout, float* y, int E,
        int M, int N, int red, int F, cudaStream_t stream) {
  using C = Cfg<MODE, F32>;
  constexpr int SMEM = C::SMEM;
  static_assert(SMEM <= 232448, "shared memory of one CTA");
  static int cached[gmmtc::MAX_DEV][2];
  int per_sm = 0, sms = 0;
  const cudaError_t err = gmmtc::occupancy(
      reinterpret_cast<const void*>(bwd_kernel<MODE, F32>), THREADS, SMEM,
      cached, &per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_m = (M + 64 * NWG - 1) / (64 * NWG);
  const int tiles_n = (N + C::BN - 1) / C::BN;
  const long long tiles = static_cast<long long>(E) * tiles_m * tiles_n;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(
      tiles < static_cast<long long>(per_sm) * sms ? tiles : per_sm * sms);
  bwd_kernel<MODE, F32><<<grid, THREADS, SMEM, stream>>>(
      maps, dout, y, M, N, red, F, tiles_m, tiles_n,
      static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

// Whether tensor maps can describe the call: 16-byte aligned tensors, and
// K and F multiples of 8 (so every row stride, and dgu's du half, is
// 16-byte aligned).
inline bool usable(const void* const (&ptrs)[6], int K, int F) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return K % 8 == 0 && F % 8 == 0;
}

// dgu: scratch of E·C·2F bf16 hi values, then as many lo values. out_f32:
// dx and dw are fp32, else bf16. Call only where usable() holds.
inline int launch(const void* x, const void* w_in, const void* dout,
                  void* dx, void* dw, void* dgu, int E, int C, int K, int F,
                  bool out_f32, cudaStream_t stream) {
  const cudaError_t bound = gmmtc::bind_context(dx);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  using gmmtc::encode;
  const int F2 = 2 * F;
  auto* hi = static_cast<__nv_bfloat16*>(dgu);
  __nv_bfloat16* lo = hi + static_cast<size_t>(E) * C * F2;
  // x [E, C, K], w_in [E, K, 2F] and dgu's halves [E, C, 2F] as 64 x 64
  // boxes; each map serves both products that read the tensor (the box's
  // coordinates say which dimension is the reduction).
  CUtensorMap mx, mw, mhi, mlo;
  Maps gu{}, pdx{}, pdw{};
  bool ok = encode(&mx, x, K, C, E) && encode(&mw, w_in, F2, K, E) &&
            encode(&mhi, hi, F2, C, E) && encode(&mlo, lo, F2, C, E) &&
            // GU's outputs: the dg and du halves of each row, F columns
            // each, so a ragged F never spills into the other half.
            encode(&gu.y0, hi, F, C, E, F2) &&
            encode(&gu.y1, hi + F, F, C, E, F2) &&
            encode(&gu.y2, lo, F, C, E, F2) &&
            encode(&gu.y3, lo + F, F, C, E, F2);
  if (!out_f32)
    ok = ok && encode(&pdx.y0, dx, K, C, E) && encode(&pdw.y0, dw, F2, K, E);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  gu.a = mx;
  gu.b = mw;
  pdx.a = mhi;
  pdx.b = mw;
  pdw.a = mx;
  pdw.b = mhi;
  pdw.b2 = mlo;
  const auto* dp = static_cast<const __nv_bfloat16*>(dout);
  int rc = run<GU, false>(gu, dp, nullptr, E, C, F, K, F, stream);
  if (rc) return rc;
  if (out_f32) {
    rc = run<DX, true>(pdx, dp, static_cast<float*>(dx), E, C, K, F2, F,
                       stream);
    if (rc) return rc;
    return run<DW, true>(pdw, dp, static_cast<float*>(dw), E, K, F2, C, F,
                         stream);
  }
  rc = run<DX, false>(pdx, dp, nullptr, E, C, K, F2, F, stream);
  if (rc) return rc;
  return run<DW, false>(pdw, dp, nullptr, E, K, F2, C, F, stream);
}

}  // namespace gsbtc

// tensor_cores: 1 = the tensor-core body (bf16 only; refused where tensor
// maps cannot describe the call), 0 = the FMA body (fp32 outputs only).
// dgu: scratch of 4·E·C·2F bytes (the FMA body's fp32 dgu, or the
// tensor-core body's bf16 hi and lo halves). out_dtype and dtype: 0 =
// float32, 1 = bfloat16 (dx and dw; x, w_in and dout). Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int gmm_swiglu_bwd_launch(const void* x, const void* w_in,
                                     const void* dout, void* dx, void* dw,
                                     void* dgu, int E, int C, int K, int F,
                                     int tensor_cores, int out_dtype,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype != 0 && out_dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tensor_cores) {
    const void* const ptrs[6] = {x, w_in, dout, dx, dw, dgu};
    if (dtype != 1 || !gsbtc::usable(ptrs, K, F))
      return static_cast<int>(cudaErrorInvalidValue);
    return gsbtc::launch(x, w_in, dout, dx, dw, dgu, E, C, K, F,
                         out_dtype == 0, s);
  }
  if (out_dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return gsb::launch<float>(x, w_in, dout, dx, dw, dgu, E, C, K, F, s);
  if (dtype == 1)
    return gsb::launch<__nv_bfloat16>(x, w_in, dout, dx, dw, dgu, E, C, K, F,
                                      s);
  return static_cast<int>(cudaErrorInvalidValue);
}
