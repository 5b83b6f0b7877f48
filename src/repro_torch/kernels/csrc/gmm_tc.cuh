// Tensor-core body of the grouped-GEMM kernels gmm.cu and gmm_swiglu.cu for
// Hopper (sm_90a): bf16 operands, fp32 sums in registers, bf16 output.
//
// y[e, m, n] = sum_k a[e, m, k] * b[e, k, n]                    (gmm)
// y[e, m, n] = silu(g) * u, g = a·b[:, :, n], u = a·b[:, :, n_up + n]
//                                                                (SwiGLU)
//
// The paper's GMM rule holds (§4.2, src/repro/kernels/gmm.py): tiles split
// only along experts, rows and output columns. One CTA computes a whole
// BM x BN output tile and loops over all of K itself, so there is no split-K,
// no atomics, and every output is summed in the same order on every run.
//
// One CTA (persistent: it walks tiles blockIdx.x, + gridDim.x, ...):
//   * NWG consumer warpgroups (BM = 64 * NWG rows: NWG = 1 for M <= 64,
//     else 2) and one producer warp;
//   * a ring of STAGES stages in dynamic shared memory. A stage holds K = 64
//     of the A tile (NWG boxes of 64 x 64) and NB boxes (64 x 64) of B: 64 NB
//     output columns for gmm, or the gate and up columns of 64 outputs for
//     SwiGLU (NB = 2). Every box is one TMA load with the 128-byte swizzle,
//     completion reported to the stage's "full" mbarrier;
//   * the producer's one thread keeps the ring full, running ahead into the
//     CTA's next tile while the consumers store the last one;
//   * each consumer warpgroup runs wgmma.mma_async m64n128k16 (bf16 x bf16 ->
//     fp32) on its 64 rows against each pair of B boxes, keeps one group of
//     products in flight, and frees a stage (its "empty" mbarrier) when the
//     products that read it are done;
//   * the epilogue reads the fp32 accumulators, applies SwiGLU in registers
//     (the [E, M, 2F] intermediate never reaches device memory) and stores
//     bf16: 128-row tiles through swizzled shared memory and a TMA store,
//     which overlaps the next tile's products; 64-row tiles (decode) from
//     registers. Both leave out the rows and columns past M and N.
// NB = 4 (128 x 256 tiles) halves how often A is read from L2 for gmm's wide
// calls; decode's single warpgroup keeps NB = 2, so two CTAs fit an SM.
// Layouts: A is K-major ([E, M, K], ta = 0) or M-major ([E, K, M], ta = 1);
// B is N-major ([E, K, N], tb = 0) or K-major ([E, N, K], tb = 1). wgmma
// reads all four from shared memory (its transpose bits), so the backward's
// transposed operands need no copy. TMA zero-fills boxes past the edges of
// each expert's [M, K] and [K, N] blocks, which masks ragged M and K.
//
// TMA needs 16-byte aligned bases and row strides: usable() says whether a
// call qualifies; the launchers send the others to the FMA body
// (gmm_common.cuh).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gmmtc {

constexpr int BK = 64;                    // K per stage: one 128-byte row
constexpr int BOX = 64;                   // rows x columns of a TMA box
constexpr int BOX_BYTES = BOX * BK * 2;   // 8 KB of bf16
constexpr int STAGES = 4;
constexpr int PRODUCER_THREADS = 32;

__host__ __device__ constexpr int stage_bytes(int nwg, int nb) {
  return (nwg + nb) * BOX_BYTES;
}
// Output staging of a 128-row tile: two boxes a warpgroup (see the
// epilogue); 64-row tiles store from registers.
__host__ __device__ constexpr int out_bytes(int nwg) {
  return nwg == 2 ? nwg * 2 * BOX_BYTES : 0;
}
// The ring, the output staging, 1 KB to align them (the 128-byte swizzle
// repeats every 1 KB), and a full and an empty barrier per stage.
__host__ __device__ constexpr int smem_bytes(int nwg, int nb) {
  return STAGES * stage_bytes(nwg, nb) + out_bytes(nwg) + 1024 +
         2 * STAGES * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-d tensor map (innermost coordinate first) into shared
// memory; its bytes are credited to `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// One box of shared memory to a 3-d tensor map; TMA drops the elements that
// fall outside the tensor.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Barrier `id` among the `n` threads of one warpgroup.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout 1 = 128B swizzle.
// Every box is 64 elements wide in its contiguous dimension, one swizzle
// atom, so the stride between 8-row groups (SBO) is 1 KB. The leading offset
// is unused by K-major tiles (16 B, as CUTLASS sets it); an MN-major tile
// steps by it from one 64-wide atom to the next: `lbo`, the box stride.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma boundary.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] * B[16 x 128]. TA = 1: A is M-major; TB = 1: B
// is K-major. (wgmma's transpose bits mean MN-major for both operands.)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(1 - TB));
}

// Output tile t -> (expert, first row, first column); rows vary fastest, so
// CTAs that run together share their B (weight) boxes in L2.
struct Tile {
  int e, m0, n0;
};
__device__ __forceinline__ Tile tile_of(int t, int tiles_m, int tiles_n,
                                        int bm, int bn) {
  const int mt = t % tiles_m;
  const int rest = t / tiles_m;
  return {rest / tiles_n, mt * bm, (rest % tiles_n) * bn};
}

// map_a, map_b, map_y: tensor maps of A, B and y [E, M, N] bf16 (see
// launch()). n_up: the up columns' offset in B (SwiGLU only).
template <int NWG, int NB, int TA, int TB, bool SWIGLU>
__global__ void __launch_bounds__(NWG * 128 + PRODUCER_THREADS, 1)
    gmm_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const __grid_constant__ CUtensorMap map_y,
                  __nv_bfloat16* __restrict__ y, int M, int K, int N,
                  int n_up, int tiles_m, int tiles_n, int tiles) {
  static_assert(NB == 2 || (NB == 4 && !SWIGLU), "NB: 2, or 4 for gmm");
  constexpr int BM = 64 * NWG;
  constexpr int BN = SWIGLU ? BOX : NB * BOX;   // output columns a tile
  constexpr int NP = NB / 2;                    // n128 products a K step
  constexpr int A_BYTES = NWG * BOX_BYTES;
  constexpr int STAGE = stage_bytes(NWG, NB);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t out = base + STAGES * STAGE;   // output staging
  const uint32_t bars = out + out_bytes(NWG);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const int nk = (K + BK - 1) / BK;
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
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(&map_a))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(&map_b))
                 : "memory");
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tl = tile_of(t, tiles_m, tiles_n, BM, BN);
      for (int kb = 0; kb < nk; ++kb) {
        const int k0 = kb * BK;
        mbar_wait(empty(s), ph ^ 1);
        mbar_expect_tx(full(s), STAGE);
        const uint32_t st = base + s * STAGE;
#pragma unroll
        for (int w = 0; w < NWG; ++w) {
          if (TA == 0)
            tma_load(st + w * BOX_BYTES, &map_a, full(s), k0,
                     tl.m0 + w * BOX, tl.e);
          else
            tma_load(st + w * BOX_BYTES, &map_a, full(s), tl.m0 + w * BOX,
                     k0, tl.e);
        }
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          // SwiGLU's second box is the up projection of the same columns.
          const int nq = SWIGLU && q ? n_up + tl.n0 : tl.n0 + q * BOX;
          const uint32_t dst = st + A_BYTES + q * BOX_BYTES;
          if (TB == 0)
            tma_load(dst, &map_b, full(s), nq, k0, tl.e);
          else
            tma_load(dst, &map_b, full(s), k0, nq, tl.e);
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
  // A box: K-major rows of 128 B, or MN-major (one atom, lbo unused). B pair
  // of boxes: K-major 128 rows of 128 B (lbo unused), or MN-major two atoms
  // one box apart.
  constexpr uint32_t LBO_A = TA ? BOX_BYTES : 16;
  constexpr uint32_t LBO_B = TB ? 16 : BOX_BYTES;
  int s = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tl = tile_of(t, tiles_m, tiles_n, BM, BN);
    float acc[NP][64];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
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
        // 16 more of K: 32 bytes along a K-major row, or 16 rows (2 KB) of
        // an MN-major tile.
        const uint64_t da =
            smem_desc(a + (TA ? kk * 2048 : kk * 32), LBO_A);
        const uint32_t boff = TB ? kk * 32 : kk * 2048;
#pragma unroll
        for (int p = 0; p < NP; ++p)
          wgmma_m64n128k16<TA, TB>(
              acc[p], da, smem_desc(b + 2 * p * BOX_BYTES + boff, LBO_B));
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
    for (int p = 0; p < NP; ++p) fence_acc(acc[p]);
    if (prev >= 0 && signals) mbar_arrive(empty(prev));

    // Fragment of m64nNk16: register 4 j + 2 h + i holds row
    // 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + i.
    const int cl = 2 * (lane % 4);
    if constexpr (NWG == 2) {
      // Through shared memory: the warpgroup writes 128 columns of its 64
      // rows as two 64 x 64 boxes in the 128-byte swizzle (the 8 rows of a
      // store land in 8 different 16-byte bank groups), then one thread
      // hands them to TMA, which stores them while the next tile's products
      // run. Before reusing the staging, that thread waits until TMA has
      // read the last boxes.
      const uint32_t ob = out + wg * 2 * BOX_BYTES;
      const int rl = warp * 16 + lane / 4;   // row within the 64
      auto put = [&](int box, int j8, int h, float v0, float v1) {
        const int r = rl + 8 * h;
        const uint32_t addr = ob + box * BOX_BYTES + r * 128 +
                              ((j8 ^ (r % 8)) << 4) + cl * 2;
        const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr),
                     "r"(*reinterpret_cast<const uint32_t*>(&v))
                     : "memory");
      };
#pragma unroll
      for (int p = 0; p < (SWIGLU ? 1 : NP); ++p) {
        if (signals)
          asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        bar_sync(1 + wg, 128);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < (SWIGLU ? 8 : 16); ++j) {
            const int i = 4 * j + 2 * h;
            float v0 = acc[p][i], v1 = acc[p][i + 1];
            if (SWIGLU) {
              v0 = v0 * (1.f / (1.f + expf(-v0))) * acc[p][i + 32];
              v1 = v1 * (1.f / (1.f + expf(-v1))) * acc[p][i + 33];
            }
            put(j / 8, j % 8, h, v0, v1);
          }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        bar_sync(1 + wg, 128);
        if (signals) {
          const int m = tl.m0 + wg * 64;
          tma_store(&map_y, ob, tl.n0 + 128 * p, m, tl.e);
          if (!SWIGLU)
            tma_store(&map_y, ob + BOX_BYTES, tl.n0 + 128 * p + BOX, m,
                      tl.e);
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        }
      }
      continue;
    }
    const int r0 = tl.m0 + wg * 64 + warp * 16 + lane / 4;
    __nv_bfloat16* ye = y + static_cast<size_t>(tl.e) * M * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= M) continue;
      __nv_bfloat16* yr = ye + static_cast<size_t>(row) * N;
      if (SWIGLU) {
        // Columns [0, 64) of the product are the gate, [64, 128) the up.
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tl.n0 + 8 * j + cl;
          const int i = 4 * j + 2 * h;
          if (c >= N) continue;
          const float g0 = acc[0][i], g1 = acc[0][i + 1];
          const float v0 = g0 * (1.f / (1.f + expf(-g0))) * acc[0][i + 32];
          const float v1 = g1 * (1.f / (1.f + expf(-g1))) * acc[0][i + 33];
          *reinterpret_cast<__nv_bfloat162*>(yr + c) =
              __floats2bfloat162_rn(v0, v1);
        }
      } else {
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int c = tl.n0 + 128 * p + 8 * j + cl;
            const int i = 4 * j + 2 * h;
            if (c < N)
              *reinterpret_cast<__nv_bfloat162*>(yr + c) =
                  __floats2bfloat162_rn(acc[p][i], acc[p][i + 1]);
          }
      }
    }
  }
  // The staging must outlive the last TMA store.
  if (NWG == 2 && signals)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// Whether TMA can describe the call: 16-byte aligned bases, and every row
// stride (the contiguous dimension of A, B and y) a multiple of 8 elements.
// ldb: B's contiguous extent (N or 2F if tb = 0, K if tb = 1).
inline bool usable(const void* a, const void* b, const void* y, int M, int K,
                   int N, int ldb, int ta, int tb) {
  auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int lda = ta ? M : K;
  return al(a) && al(b) && al(y) && lda % 8 == 0 && ldb % 8 == 0 &&
         N % 8 == 0 && (ta == 0 || ta == 1) && (tb == 0 || tb == 1);
}

// cuTensorMapEncodeTiled needs a current context. A thread that has not
// reached the card through the runtime yet (autograd's worker thread, where
// the backward runs) has none: bind the primary context of the device that
// holds `p` (cudaSetDevice makes it current).
inline cudaError_t bind_context(const void* p) {
  CUcontext ctx = nullptr;
  if (cuCtxGetCurrent(&ctx) == CUDA_SUCCESS && ctx != nullptr)
    return cudaSuccess;
  cudaPointerAttributes attr;
  const cudaError_t err = cudaPointerGetAttributes(&attr, p);
  if (err != cudaSuccess) return err;
  return cudaSetDevice(attr.device);
}

// A 3-d bf16 tensor map [d2][d1][d0] (d0 contiguous) read in 64 x 64 boxes
// with the 128-byte swizzle; out-of-bounds elements read as zero. Rows are
// `ld` elements apart (default d0), so a map may cover some of each row's
// columns.
inline bool encode(CUtensorMap* map, const void* p, int d0, int d1, int d2,
                   int ld = 0) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t row = static_cast<cuuint64_t>(ld ? ld : d0) * 2;
  const cuuint64_t strides[2] = {row, row * dims[1]};
  const cuuint32_t box[3] = {BOX, BOX, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// CTAs per SM of kernel `kern` (`threads` threads, `smem` bytes of dynamic
// shared memory) and SMs of the current device, looked up once per device
// into the caller's `cached` (one per kernel; the shared-memory opt-in is
// set then too).
constexpr int MAX_DEV = 64;
inline cudaError_t occupancy(const void* kern, int threads, int smem,
                             int (&cached)[MAX_DEV][2], int* per_sm,
                             int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEV) return cudaErrorInvalidDevice;
  if (cached[dev][0] == 0) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int occ = 0, n_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads,
                                                        smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    cached[dev][1] = n_sm;
    cached[dev][0] = occ;
  }
  *per_sm = cached[dev][0];
  *sms = cached[dev][1];
  return cudaSuccess;
}

// CTAs per SM and SMs of the current device for one instantiation.
template <int NWG, int NB, int TA, int TB, bool SWIGLU>
cudaError_t residency(int* per_sm, int* sms) {
  static int cached[MAX_DEV][2];
  return occupancy(
      reinterpret_cast<const void*>(gmm_tc_kernel<NWG, NB, TA, TB, SWIGLU>),
      NWG * 128 + PRODUCER_THREADS, smem_bytes(NWG, NB), cached, per_sm, sms);
}

template <int NWG, int NB, int TA, int TB, bool SWIGLU>
int run(const CUtensorMap& ma, const CUtensorMap& mb, const CUtensorMap& my,
        __nv_bfloat16* y, int E, int M, int K, int N, int n_up,
        cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t err = residency<NWG, NB, TA, TB, SWIGLU>(&per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bn = SWIGLU ? BOX : NB * BOX;
  const int tiles_m = (M + 64 * NWG - 1) / (64 * NWG);
  const int tiles_n = (N + bn - 1) / bn;
  const long long tiles = static_cast<long long>(E) * tiles_m * tiles_n;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(
      tiles < static_cast<long long>(per_sm) * sms ? tiles
                                                   : per_sm * sms);
  gmm_tc_kernel<NWG, NB, TA, TB, SWIGLU>
      <<<grid, NWG * 128 + PRODUCER_THREADS, smem_bytes(NWG, NB), stream>>>(
          ma, mb, my, y, M, K, N, n_up, tiles_m, tiles_n,
          static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

// The tile for M and N: 64 rows (one consumer warpgroup) up to M = 64, else
// 128; gmm's 128-row tiles are 256 columns wide from N = WIDE_N on.
constexpr int WIDE_N = 1024;

template <int TA, int TB, bool SWIGLU>
int run_tile(const CUtensorMap& ma, const CUtensorMap& mb,
             const CUtensorMap& my, __nv_bfloat16* y, int E, int M, int K,
             int N, int n_up, cudaStream_t stream) {
  if (M <= 64)
    return run<1, 2, TA, TB, SWIGLU>(ma, mb, my, y, E, M, K, N, n_up,
                                     stream);
  if constexpr (!SWIGLU) {
    if (N >= WIDE_N)
      return run<2, 4, TA, TB, false>(ma, mb, my, y, E, M, K, N, n_up,
                                      stream);
  }
  return run<2, 2, TA, TB, SWIGLU>(ma, mb, my, y, E, M, K, N, n_up, stream);
}

// y [E, M, N] = A·B (gmm) or SwiGLU of A·B (B [E, K, 2N], tb = 0, N = F).
// Call only where usable() holds.
template <bool SWIGLU>
int launch(const void* a, const void* b, void* y, int E, int M, int K, int N,
           int ta, int tb, cudaStream_t stream) {
  const cudaError_t bound = bind_context(y);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  CUtensorMap ma, mb, my;
  const int ldb = SWIGLU ? 2 * N : N;
  const bool ok =
      (ta ? encode(&ma, a, M, K, E) : encode(&ma, a, K, M, E)) &&
      (tb ? encode(&mb, b, K, ldb, E) : encode(&mb, b, ldb, K, E)) &&
      encode(&my, y, N, M, E);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  if constexpr (SWIGLU) {
    if (ta || tb) return static_cast<int>(cudaErrorInvalidValue);
    return run_tile<0, 0, true>(ma, mb, my, yp, E, M, K, N, N, stream);
  } else {
    switch (2 * ta + tb) {
      case 0:
        return run_tile<0, 0, false>(ma, mb, my, yp, E, M, K, N, 0, stream);
      case 1:
        return run_tile<0, 1, false>(ma, mb, my, yp, E, M, K, N, 0, stream);
      case 2:
        return run_tile<1, 0, false>(ma, mb, my, yp, E, M, K, N, 0, stream);
      default:
        return run_tile<1, 1, false>(ma, mb, my, yp, E, M, K, N, 0, stream);
    }
  }
}

}  // namespace gmmtc
