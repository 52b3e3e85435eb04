// split_matmul for Hopper (sm_90a): y = x @ w with x (M,K), w (K,N), both
// row-major and contiguous, y (M,N) in x's type, fp32 accumulation, K
// walked in slices of `kslice` (the paper's operator-splitting
// granularity K/kslice), no slice overlapping the next.
//
// Replaces the TPU kernel src/repro/kernels/split_matmul.py::split_matmul
// (body `_kernel`), where K is a sequential grid axis carried in a VMEM
// accumulator, so one (bk, bn) weight slice is resident at a time.  CUDA
// blocks run in no order, so here a block walks its K range itself.  The
// wrapper (kernels/split_matmul.py::plan_launch) picks one of four
// designs by shape and role; every choice is explicit in the plan it
// returns.
//
// (a) "stream", decode rows (M <= 64).  Every product is a stream of the
//     weight: K*N*2 bytes against 2*M*K*N operations, 8 FLOP a byte at
//     M = 8, far below the card's ~295 FLOP/byte ridge, so bytes bound it
//     (0.37 ms for the phi4 head (8, 3072, 200192), 15 us for
//     (8, 8192, 3072)), and at the small products the launch itself.  To
//     reach the memory rate the weight must be read by many blocks with
//     many bytes in flight: the grid is N tiles of 128, 64, 32 or 16
//     columns times split-K, K cut at whole `kslice` slices into `splits`
//     ranges, so that at least 2 blocks land on each SM where the slices
//     allow it.  Each block streams its (K range x N tile) of w, with the
//     matching x columns, through a 4-stage cp.async ring (16-byte copies;
//     8 KB of weight a stage at 64 columns), and multiplies on the tensor
//     cores as y^T = w^T x^T: mma.sync m16n8k16 with w^T as the A operand
//     (ldmatrix.trans from rows padded by 16 bytes, 16 weight columns a
//     warp) and x^T as B, whose n = 8 is exactly 8 decode slots.  Warps
//     split the stage's 64 rows of K when the tile is narrower than 64
//     columns and add their partials in a fixed order at the end.  With
//     splits > 1 each block writes fp32 partials to a workspace
//     (splits, M, N) and a second small kernel sums them in split order
//     and casts: no atomics, so results are identical from run to run.
// (b) "wgmma", prefill rows (M > 64).  At a few hundred rows the large
//     products reach the ridge (operations), and every block takes in its
//     x and w tiles at each 64-deep K step, so wide tiles do more work a
//     byte: the tile is 128 rows by 256, 192, 128 or 64 columns (the
//     planner's choice, by tile count against the 132 SMs), fed by TMA into
//     a ring of up to 200 KB with full/empty mbarriers.  One producer
//     thread (its own warpgroup, registers handed to the consumers with
//     setmaxnreg) issues the loads; two consumer warpgroups issue
//     wgmma.m64nBNk16 with x as a K-major A tile and w (K, N) row-major as
//     the MN-major ("transposed") B operand, both in the 128-byte swizzle
//     TMA writes, one step's wgmmas kept in flight while the previous
//     step's stage is released.  Row tiles are the grid's fastest axis,
//     so the blocks that share a weight tile run together and read it
//     from memory once.  All slices of a block's K range add into the
//     same fp32 registers; split-K (as in (a)) where the tiles alone
//     leave SMs idle.
// (d) "persistent", the accumulating form, dgrad and wgrad at prefill
//     rows: (b)'s roles and tiles in one block a SM that walks output
//     tiles in a grouped raster, its epilogue through shared memory and
//     TMA stores (below, before the split-K reduction).
// (c) "general", the first version (64x64 tiles, WMMA, no pipeline),
//     kept for what (a), (b) and (d) cannot take: K or N not a multiple of 8
//     (TMA and 16-byte copies need 16-byte row strides) or a base pointer
//     not 16-byte aligned.  float32 inputs take a CUDA-core fp32 kernel
//     (no TF32).
//
// Training.  The TPU kernel has no backward (the JAX package trains through
// its jnp twin, x @ w), so the backward is new here: design (d) in two more
// operand layouts (`Layout` below), dgrad dx = dy w^T ("NT", w read as
// stored, the transpose in the load) and wgrad dw = x^T dy ("TN",
// contracted over the rows); the tied head's forward x emb^T is NT too
// (design (b)), so the embedding is never copied transposed.  What bounds
// them at qwen1.5-0.5b's training shapes (B*S = 32768 rows, bf16):
// operations.  A layer's six products are 2 * 32768 * (4 * 1024^2 + 1024
// * 5632 + 2816 * 1024) = 829 GFLOP for each of forward, dgrad and
// wgrad, 0.84 ms at 989 TFLOP/s; w13's dgrad (32768 x 5632 -> 1024) is 378 GFLOP, 0.382 ms,
// against 448 MB of bytes, 0.134 ms.  A dimension not a multiple of 8, a
// misaligned pointer or float32 takes a strided CUDA-core kernel instead.
//
// Accumulating form, y_f32 = acc + x @ w (forward layout only): the TPU
// kernel's fp32 K-slice accumulator carried across calls, which is §3.3's
// slice-and-sum as `core/operator_split.py` runs it (a chunked FFN adds each
// chunk's h_j @ w2_j into one fp32 sum and casts once at the end).  (a),
// (c) and (d) take it in their epilogues ((b) never does: the wrapper
// sends every accumulating call at prefill rows to (d)): where they would
// cast the fp32 sum to bf16 they read the fp32 tile of `acc` and write
// acc + sum as fp32 instead; the split-K reduce adds `acc` to the sum of
// its partials the same way.  The
// products are unchanged, so it costs the fp32 tile read and the wider
// write: 8 bytes an output element more than a bf16 product.
//
// In (a) and (b) each slice is walked in steps of 64 from its start
// (rounded down to a multiple of 8 for 16-byte aligned copies); a step's
// columns outside the slice are cut (weight rows zero in (a), x columns
// zeroed in shared memory in (b)), so no step sums across a slice
// boundary (`Steps`).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// --- (c) the general kernels ---------------------------------------------------

namespace general {

using namespace nvcuda;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;     // 4 warps, each a 32x32 quarter of the tile
constexpr int A_LD = BK + 8;     // bf16 elements; multiple of 8 for WMMA
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;     // floats; multiple of 4 for WMMA

// Loads 8 consecutive bf16 of row `r` starting at column `c` of a
// row-major matrix with leading dimension `ld` into `dst`, zero-filling
// entries outside rows [0, rows) and columns [0, cols).
__device__ __forceinline__ void load8(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int r,
                                      int c, int rows, int cols, int ld,
                                      bool vec) {
  if (r < rows && vec && c + 8 <= cols) {
    *reinterpret_cast<uint4*>(dst) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    dst[i] = (r < rows && c + i < cols) ? src[(size_t)r * ld + c + i]
                                        : __float2bfloat16(0.0f);
  }
}

__global__ void __launch_bounds__(THREADS)
split_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w, void* y,
                         const float* c_in, int M, int N, int K, int kslice,
                         int vec_x, int vec_w) {
  __shared__ __align__(32) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(32) float Cs[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;   // warp's row offset in the tile
  const int wn = (warp % 2) * 32;   // warp's column offset in the tile
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // operator splitting: K in slices of `kslice`, each slice in BK steps
  for (int s0 = 0; s0 < K; s0 += kslice) {
    const int s1 = min(K, s0 + kslice);
    for (int k0 = s0; k0 < s1; k0 += BK) {
      // x tile (BM, BK): 256 chunks of 8, two per thread; columns past
      // the slice end are zero so slices never overlap
      for (int c = tid; c < BM * BK / 8; c += THREADS) {
        const int r = c / (BK / 8);
        const int kk = (c % (BK / 8)) * 8;
        load8(&As[r * A_LD + kk], x, row0 + r, k0 + kk, M, s1, K, vec_x);
      }
      // w tile (BK, BN): rows past the slice end are zero
      for (int c = tid; c < BK * BN / 8; c += THREADS) {
        const int r = c / (BN / 8);
        const int nn = (c % (BN / 8)) * 8;
        load8(&Bs[r * B_LD + nn], w, k0 + r, col0 + nn, s1, N, N, vec_w);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], &As[(wm + 16 * i) * A_LD + kk], A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], &Bs[kk * B_LD + wn + 16 * j], B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm + 16 * i) * C_LD + wn + 16 * j],
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN;
    const int c = e % BN;
    if (row0 + r >= M || col0 + c >= N) continue;
    const size_t o = (size_t)(row0 + r) * N + col0 + c;
    if (c_in)   // accumulating form: fp32 out
      reinterpret_cast<float*>(y)[o] = c_in[o] + Cs[r * C_LD + c];
    else
      reinterpret_cast<__nv_bfloat16*>(y)[o] = __float2bfloat16(Cs[r * C_LD + c]);
  }
}

// float32 inputs: CUDA-core FMAs in full fp32 (no TF32), each thread a
// 4x4 patch of the 64x64 tile.
__global__ void __launch_bounds__(256)
split_matmul_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w, float* y,
                        const float* c_in, int M, int N, int K, int kslice) {
  constexpr int FK = 16;
  __shared__ float As[FK][BM + 1];   // transposed x tile
  __shared__ float Bs[FK][BN];
  const int tid = threadIdx.x;
  const int tr = (tid / 16) * 4;
  const int tc = (tid % 16) * 4;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float acc[4][4] = {};
  for (int s0 = 0; s0 < K; s0 += kslice) {
    const int s1 = min(K, s0 + kslice);
    for (int k0 = s0; k0 < s1; k0 += FK) {
      for (int e = tid; e < BM * FK; e += 256) {
        const int r = e / FK, kk = e % FK;
        const int gr = row0 + r, gk = k0 + kk;
        As[kk][r] = (gr < M && gk < s1) ? x[(size_t)gr * K + gk] : 0.0f;
      }
      for (int e = tid; e < FK * BN; e += 256) {
        const int kk = e / BN, c = e % BN;
        const int gk = k0 + kk, gc = col0 + c;
        Bs[kk][c] = (gk < s1 && gc < N) ? w[(size_t)gk * N + gc] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][tr + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tc + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = row0 + tr + i, gc = col0 + tc + j;
      if (gr >= M || gc >= N) continue;
      const size_t o = (size_t)gr * N + gc;
      y[o] = c_in ? c_in[o] + acc[i][j] : acc[i][j];
    }
}

}  // namespace general

// --- K ranges: a split is `sps` whole slices.  Each slice is walked in
// steps of 64 from its start rounded down to a multiple of 8 (TMA and
// 16-byte copies need 16-byte aligned rows); a step's columns outside
// the slice, [0, lo) and [hi, 64), are zeroed, so no step sums across a
// slice boundary.  With kslice % 8 == 0 (the serve path) lo is 0. ------

constexpr int KSTEP = 64;
constexpr int STAGES = 4;

struct Steps {
  int kb, ke, kslice, per_slice, n;
  __device__ Steps(int split, int K, int kslice_, int sps) : kslice(kslice_) {
    const long long span = (long long)sps * kslice;
    kb = (int)min((long long)K, split * span);
    ke = (int)min((long long)K, kb + span);
    per_slice = (kslice + (kslice % 8 ? 7 : 0) + KSTEP - 1) / KSTEP;
    if (ke <= kb) {
      n = 0;
      return;
    }
    const int n_slices = (ke - kb + kslice - 1) / kslice;
    const int s0 = kb + (n_slices - 1) * kslice;
    n = (n_slices - 1) * per_slice + (ke - (s0 & ~7) + KSTEP - 1) / KSTEP;
  }
  // step i -> its first k (a multiple of 8) and the range [lo, hi) of its
  // 64 columns that lie in the slice (empty when hi <= lo)
  __device__ void at(int i, int& k0, int& lo, int& hi) const {
    const int s0 = kb + (i / per_slice) * kslice;
    const int s1 = min(ke, s0 + kslice);
    k0 = (s0 & ~7) + (i % per_slice) * KSTEP;
    lo = max(0, s0 - k0);
    hi = min(KSTEP, s1 - k0);
  }
};

// --- (a) decode rows: split-K weight streaming on mma.sync ---------------------

template <int BN, int MT>
struct Stream {
  static constexpr int MP = MT * 8;        // x rows, padded
  static constexpr int LDW = BN + 8;       // padded rows: ldmatrix without
  static constexpr int LDX = KSTEP + 8;    // bank conflicts
  static constexpr int W_ELEMS = KSTEP * LDW;
  static constexpr int STAGE = W_ELEMS + MP * LDX;
  static constexpr int NG = BN / 16;       // warps along N
  static constexpr int KG = NG < 4 ? 4 / NG : 1;   // warps along K
  static constexpr int THREADS = NG * KG * 32;
  static constexpr int SMEM = STAGES * STAGE * 2;
  static_assert(KG * BN * MP * 4 <= SMEM, "epilogue does not fit");
};

template <int BN, int MT>
__global__ void __launch_bounds__(Stream<BN, MT>::THREADS)
split_matmul_stream_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ w, void* y,
                           float* __restrict__ ws, const float* c_in, int M,
                           int N, int K, int kslice, int sps) {
  using namespace hopper;
  using P = Stream<BN, MT>;
  extern __shared__ __align__(16) bf16 smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ng = warp % P::NG;
  const int kg = warp / P::NG;
  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  const Steps st(split, K, kslice, sps);

  auto load = [&](int i, int buf) {
    bf16* wsm = smem + buf * P::STAGE;
    bf16* xsm = wsm + P::W_ELEMS;
    int k0, lo, hi;
    st.at(i, k0, lo, hi);
    // w rows [k0 + lo, k0 + hi); the others zero, so the x columns there
    // add nothing
    for (int c = tid; c < KSTEP * BN / 8; c += P::THREADS) {
      const int r = c / (BN / 8), cc = c % (BN / 8);
      const int n = n0 + cc * 8;
      const bool ok = r >= lo && r < hi && n < N;
      cp_async16(wsm + r * P::LDW + cc * 8,
                 ok ? w + (size_t)(k0 + r) * N + n : w, ok ? 16 : 0);
    }
    for (int c = tid; c < P::MP * (KSTEP / 8); c += P::THREADS) {
      const int m = c / (KSTEP / 8), cc = c % (KSTEP / 8);
      const int k = k0 + cc * 8;
      const bool ok = m < M && k < K;
      cp_async16(xsm + m * P::LDX + cc * 8, ok ? x + (size_t)m * K + k : x,
                 ok ? 16 : 0);
    }
  };

  float acc[MT][4];
#pragma unroll
  for (int t = 0; t < MT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < st.n) load(s, s);
    cp_async_commit();
  }
  const int mi = lane >> 3, r8 = lane & 7;
  for (int i = 0; i < st.n; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();               // step i landed; step i - 1 consumed
    const int nx = i + STAGES - 1;
    if (nx < st.n) load(nx, nx % STAGES);
    cp_async_commit();
    const bf16* wsm = smem + (i % STAGES) * P::STAGE;
    const bf16* xsm = wsm + P::W_ELEMS;
#pragma unroll
    for (int q = 0; q < KSTEP / 16 / P::KG; ++q) {
      const int kk = (q * P::KG + kg) * 16;
      uint32_t a[4];               // w^T: 16 columns of w x 16 rows of K
      ldmatrix_x4_trans(a, wsm + (kk + r8 + 8 * (mi >> 1)) * P::LDW +
                               ng * 16 + 8 * (mi & 1));
#pragma unroll
      for (int t = 0; t < MT; t += 2) {
        if (t + 1 < MT) {          // x^T for two groups of 8 rows of x
          uint32_t b[4];
          ldmatrix_x4(b, xsm + (8 * t + r8 + 8 * (mi >> 1)) * P::LDX + kk +
                             8 * (mi & 1));
          mma_bf16(acc[t], a, b[0], b[1]);
          mma_bf16(acc[t + 1], a, b[2], b[3]);
        } else {
          uint32_t b[2];
          ldmatrix_x2(b, xsm + (8 * t + r8) * P::LDX + kk + 8 * (mi & 1));
          mma_bf16(acc[t], a, b[0], b[1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // partials of the KG warp groups -> shared memory [KG][BN][MP], then each
  // (m, n) summed over them in order and stored (n fastest: coalesced)
  float* red = reinterpret_cast<float*>(smem);
  const int qr = lane >> 2, qc = lane & 3;
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    const int n = ng * 16 + qr, m = 8 * t + 2 * qc;
    float* base = red + (size_t)kg * BN * P::MP;
    base[n * P::MP + m] = acc[t][0];
    base[n * P::MP + m + 1] = acc[t][1];
    base[(n + 8) * P::MP + m] = acc[t][2];
    base[(n + 8) * P::MP + m + 1] = acc[t][3];
  }
  __syncthreads();
  for (int e = tid; e < P::MP * BN; e += P::THREADS) {
    const int m = e / BN, n = e % BN;
    if (m >= M || n0 + n >= N) continue;
    float s = 0.0f;
#pragma unroll
    for (int g = 0; g < P::KG; ++g) s += red[((size_t)g * BN + n) * P::MP + m];
    const size_t o = (size_t)m * N + n0 + n;
    if (ws) ws[(size_t)split * M * N + o] = s;
    else if (c_in) reinterpret_cast<float*>(y)[o] = c_in[o] + s;
    else reinterpret_cast<bf16*>(y)[o] = __float2bfloat16(s);
  }
}

// --- (b) prefill rows: TMA + wgmma ------------------------------------------------

constexpr int WG_BM = 128;                      // two consumer warpgroups
constexpr int A_BYTES = WG_BM * KSTEP * 2;      // 16 KB, 128-byte rows
constexpr int B_BOX = 64 * KSTEP * 2;           // one 64-column box, 8 KB

// ring depth by tile width: up to 200 KB of stages, so 2-3 stages' loads
// stay in flight while one is multiplied (64 columns: 4 stages, 96 KB, two
// blocks a SM)
template <int BN>
struct Wg {
  static constexpr int STAGE_BYTES = A_BYTES + BN / 64 * B_BOX;
  static constexpr int STAGES = BN == 64 ? 4 : (200 * 1024) / STAGE_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
};

// The three operand layouts of one kernel, for out(R, C) = A(R, Kc) .
// B(Kc, C), with the transpose flags each gives wgmma:
//   NN (the forward, y = x w): A = x (R, Kc) row-major, K-major; B = w
//      (Kc, C) row-major, MN-major;
//   NT (dgrad, dx = dy w^T; also the tied head, x emb^T): A as in NN; B
//      is w stored (C, Kc) row-major, so B is K-major: its tile is loaded
//      like A's, BN rows of 128 bytes;
//   TN (wgrad, dw = x^T dy): A is x stored (Kc, R) row-major, MN-major:
//      each warpgroup's 64 rows are one 64-column box of x, loaded like a
//      box of w in NN; B as in NN.
enum Layout { NN = 0, NT = 1, TN = 2 };
template <int L>
struct Flags {
  static constexpr int TA = L == TN ? 1 : 0;
  static constexpr int TB = L == NT ? 0 : 1;
};

template <int BN, int L>
__device__ __forceinline__ void wgmma_step(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  constexpr int TA = Flags<L>::TA, TB = Flags<L>::TB;
  if constexpr (BN == 256) hopper::wgmma_m64n256k16<TA, TB>(d, da, db, scale_d);
  else if constexpr (BN == 192) hopper::wgmma_m64n192k16<TA, TB>(d, da, db, scale_d);
  else if constexpr (BN == 128) hopper::wgmma_m64n128k16<TA, TB>(d, da, db, scale_d);
  else hopper::wgmma_m64n64k16<TA, TB>(d, da, db, scale_d);
}

// The consumer warpgroups' loop and epilogue: warpgroup wg owns rows
// [64 wg, 64 wg + 64) of the tile.
template <int BN, int L>
__device__ __forceinline__ void consume(uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, const Steps& st,
                                        int tid, int m0, int n0, int split,
                                        void* y, float* __restrict__ ws,
                                        int M, int N, int K) {
  using namespace hopper;
  constexpr int STAGE_BYTES = Wg<BN>::STAGE_BYTES;
  constexpr int STAGES = Wg<BN>::STAGES;
  const int wg = tid / 128;
  float d[BN / 2];                  // first written by a wgmma (scale_d 0)
  const int t128 = tid % 128;
  int stage = 0, phase = 0, prev = -1;
  for (int i = 0; i < st.n; ++i) {
    mbar_wait(&full[stage], phase);
    uint8_t* a = smem + stage * STAGE_BYTES;
    int k0, lo, hi;
    st.at(i, k0, lo, hi);
    // zero x outside the slice (NN only: the NT wrapper cuts K at
    // multiples of KSTEP, so only the tensor's end is ragged, where TMA
    // fills zeros)
    if (L == NN && (lo > 0 || hi < min(KSTEP, K - k0))) {
      for (int e = t128; e < 64 * KSTEP; e += 128) {
        const int r = e / KSTEP, kk = e % KSTEP;
        if (kk < lo || kk >= hi) {
          const int row = wg * 64 + r;          // 128-byte swizzled rows
          *reinterpret_cast<bf16*>(a + row * 128 +
                                   (((kk >> 3) ^ (row & 7)) << 4) +
                                   (kk & 7) * 2) = __float2bfloat16(0.0f);
        }
      }
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
    }
    // K-major tiles advance 32 bytes a k16 step within their 128-byte
    // rows; MN-major ones 16 rows of 128 bytes, their 64-wide boxes
    // B_BOX apart.  Each warpgroup's A is 64 rows: 8 KB.
    const uint32_t a_addr = smem_u32(a) + wg * 64 * 128;
    const uint32_t b_addr = smem_u32(a + A_BYTES);
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEP / 16; ++kk) {
      const uint64_t da = wgmma_desc_sw128(a_addr + kk * 32, 16, 1024);
      const uint64_t db =
          L == NT ? wgmma_desc_sw128(b_addr + kk * 32, 16, 1024)
                  : wgmma_desc_sw128(b_addr + kk * 16 * 128, B_BOX, 1024);
      wgmma_step<BN, L>(d, da, db, i > 0 || kk > 0);
    }
    wgmma_commit();
    // keep this step's products in flight; the previous step's are done,
    // so its stage goes back to the producer
    wgmma_wait<1>();
    fence_regs(d);
    if (prev >= 0 && t128 == 0) mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_regs(d);
  if (st.n == 0) {                  // an empty K range adds nothing
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) d[j] = 0.0f;
  }

  // accumulator layout: warp w4 of the group holds rows 16 w4 + (lane/4)
  // and + 8; n-chunk j holds columns 8 j + 2 (lane % 4) and + 1
  const int lane = t128 & 31;
  const int row_a = m0 + wg * 64 + (t128 >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_a + 8 * h;
      if (row >= M) continue;
      const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      const size_t o = (size_t)row * N + col;
      if (ws) {
        *reinterpret_cast<float2*>(ws + (size_t)split * M * N + o) =
            make_float2(v0, v1);
      } else {
        *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(y) + o) =
            pack_bf16(v0, v1);
      }
    }
  }
}

template <int BN, int L>
__global__ void __launch_bounds__(384, 1)
split_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                          const __grid_constant__ CUtensorMap tw,
                          void* y, float* __restrict__ ws, int M, int N,
                          int K, int kslice, int sps) {
  using namespace hopper;
  constexpr int STAGE_BYTES = Wg<BN>::STAGE_BYTES;
  constexpr int STAGES = Wg<BN>::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the ring to it
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m0 = blockIdx.x * WG_BM;   // row tiles fastest: the blocks
  const int n0 = blockIdx.y * BN;      // that share a weight tile run
  const int split = blockIdx.z;        // together, so it is read once
  const Steps st(split, K, kslice, sps);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);      // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  // one if/else that never rejoins, so setmaxnreg can move registers from
  // the producer's warpgroup to the consumers' (the accumulators)
  if (wg == 2) {                    // producer: one thread issues TMA
    setmaxnreg_dec<40>();
    if (tid == 256) {
      int stage = 0, phase = 0;
      for (int i = 0; i < st.n; ++i) {
        mbar_wait(&empty[stage], phase ^ 1);
        int k0, lo, hi;
        st.at(i, k0, lo, hi);
        uint8_t* a = smem + stage * STAGE_BYTES;
        mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);
        tma_load_2d(a, &tx, &full[stage], k0, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
          if (L == NT)               // 64 rows of w, K-major
            tma_load_2d(a + A_BYTES + j * B_BOX, &tw, &full[stage], k0,
                        n0 + 64 * j);
          else
            tma_load_2d(a + A_BYTES + j * B_BOX, &tw, &full[stage],
                        n0 + 64 * j, k0);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    consume<BN, L>(smem, full, empty, st, tid, m0, n0, split, y, ws, M, N, K);
  }
}

// --- (d) "persistent": the accumulating form and dgrad at prefill rows -----
//
// At 32,768 rows the row operand is the large one (dy 64 MiB, a w2 chunk's
// hidden 44 MiB, both above the 50 MB L2; the tied head's wgrad reads dy^T
// of a CE chunk, 1.25 GB) and the epilogue is heavy (the accumulating form
// reads and writes 8 bytes an output element against K = 704; wgrad at
// the calibration chain writes a 64 KB tile after one k-step).  Design (b)
// pays for both: its grid runs row tiles fastest, so x is streamed once
// per column tile, and each block writes its tile from registers, then
// exits with its ring empty.  On the card that epilogue took 0.25 of 0.34
// ms at the accumulating w2 chunk and 0.056 of 0.167 ms at the attention
// dgrad (tools/split_matmul_phases.py).
//
// Here one block a SM (the grid is the plan's `blocks`, the device's SM
// count or fewer) walks output tiles t = blockIdx.x, + gridDim.x, ... in
// a grouped raster (`TileOrder`, the wrapper's `tile_order` in Python):
// `group` row tiles at a time, each group's column tiles walked with its
// row tiles fastest, so the blocks that share a row tile run together and
// read it from memory about once, and the small weight stays in L2.  The
// roles are (b)'s: one TMA producer thread, two consumer warpgroups of
// 64 rows each with wgmma, registers moved by setmaxnreg.  The producer's
// ring runs across tile boundaries, so the next tile's loads fill while
// the consumers finish the last.  The consumers write their sums one
// 128-byte box at a time (64 bf16 or 32 fp32 columns) into two staging
// buffers in shared memory (128-byte swizzled boxes of 64 rows), and one
// thread of each warpgroup sends each chunk out with a TMA store that
// drains while the next chunk is written and the next tile's products
// run; the buffers alternate chunk by chunk across tiles, and a buffer is
// rewritten once its store two chunks back has left it.  Two one-box
// buffers (32 KB) instead of a whole output tile leave room for a 4th
// ring stage at bn 256, split-K's fp32 partials included.  In TN the A
// tile is two 64-row boxes of x^T, MN-major, as NN's B.  In the
// accumulating form the staging area holds the tile of `acc` instead:
// the producer TMA-loads it during the mainloop, as soon as the
// consumers have read the last one (barrier `acc_empty`), and the
// consumers add their sums to it and store y from registers, so no acc
// load waits for a store to drain (an output tile beside the acc tile
// left 3 stages at bn 128, and was slower on the card).  Split-K writes
// fp32 partials (a 3-D store into the (splits, M, N) workspace) summed
// by the reduce kernel below.
// Each output element is summed over K in (b)'s order, so repeats are
// bit-identical; there are no atomics.  K slices are whole k-steps (a
// multiple of 64, as "nt" and "tn" always cut them) or one slice is all
// of K, so no step is zeroed in shared memory: the wrapper plans a slice
// that is neither as one slice of all of K.

constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory a block may use
constexpr int C_BOX = 64 * 128;        // one box of the output tile: 64 rows
                                       // of 128 bytes

enum Out { OUT_BF16 = 0, OUT_F32 = 1, OUT_ACC = 2 };

// Shared memory: the ring, the staging buffers (in the accumulating form
// the acc tile), the barriers (the wrapper's `persistent_smem` in Python
// computes the same stages and bytes).
template <int BN, int OUT>
struct Ps {
  static constexpr int STAGE_BYTES = A_BYTES + BN / 64 * B_BOX;
  static constexpr int ESIZE = OUT == OUT_BF16 ? 2 : 4;
  static constexpr int BOX_W = 128 / ESIZE;          // columns a box
  static constexpr int BOXES = BN / BOX_W;           // boxes a 64-row half
  // the acc tile, or two staging buffers of 128 rows by one box (64
  // bf16 or 32 fp32 columns), 32 KB either way
  static constexpr int C_BYTES =
      OUT == OUT_ACC ? WG_BM * BN * ESIZE : 2 * WG_BM * 128;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - C_BYTES - 256) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + C_BYTES + 256;
  static_assert(STAGES >= 2 && SMEM <= SMEM_LIMIT, "ring does not fit");
};

// Output tile t of the walk -> (row tile, column tile, split): splits
// outermost; within a split, groups of `group` row tiles, each group's
// tiles with the row tile fastest.
struct TileOrder {
  int tiles_m, tiles_n, tiles, items, group;
  __device__ TileOrder(int M, int N, int bn, int splits, int group_)
      : group(group_) {
    tiles_m = (M + WG_BM - 1) / WG_BM;
    tiles_n = (N + bn - 1) / bn;
    tiles = tiles_m * tiles_n;
    items = tiles * splits;
  }
  __device__ void at(int t, int& mt, int& nt, int& split) const {
    split = t / tiles;
    const int r = t - split * tiles;
    const int span = group * tiles_n;
    const int g = r / span;
    const int first = g * group;
    const int gm = min(group, tiles_m - first);
    const int rr = r - g * span;
    mt = first + rr % gm;
    nt = rr / gm;
  }
};

// The producer's A tile of a stage: in NN and NT a (128 rows, 64 of K)
// box of x (M, K); in TN, x stored (K, M), two (64 of K, 64 rows) boxes
// of x^T, one for each consumer warpgroup, as B's boxes load in NN
template <int L>
__device__ __forceinline__ void load_a(uint8_t* a, const CUtensorMap* tx,
                                       uint64_t* bar, int k0, int m0) {
  using namespace hopper;
  if constexpr (L == TN) {
    tma_load_2d(a, tx, bar, m0, k0);
    tma_load_2d(a + B_BOX, tx, bar, m0 + 64, k0);
  } else {
    tma_load_2d(a, tx, bar, k0, m0);
  }
}

template <int BN, int L, int OUT>
__global__ void __launch_bounds__(384, 1)
split_matmul_persistent_kernel(const __grid_constant__ CUtensorMap tx,
                               const __grid_constant__ CUtensorMap tw,
                               const __grid_constant__ CUtensorMap ty,
                               const __grid_constant__ CUtensorMap tacc,
                               float* __restrict__ yacc, int M, int N,
                               int K, int kslice, int sps, int splits,
                               int group) {
  using namespace hopper;
  using P = Ps<BN, OUT>;
  constexpr int STAGES = P::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ctile = smem + STAGES * P::STAGE_BYTES;   // output or acc tile
  uint64_t* full = reinterpret_cast<uint64_t*>(ctile + P::C_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* acc_full = empty + STAGES;   // the acc tile landed
  uint64_t* acc_empty = acc_full + 1;    // the consumers have read it
  const TileOrder ord(M, N, BN, splits, group);
  const int tid = threadIdx.x;
  const int wg = tid / 128;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);      // one arrival per consumer warpgroup
    }
    mbar_init(acc_full, 1);
    mbar_init(acc_empty, 2);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {                    // producer: one thread issues TMA
    setmaxnreg_dec<40>();
    if (tid == 256) {
      int stage = 0, phase = 0, a_phase = 0;
      for (int t = blockIdx.x; t < ord.items; t += gridDim.x) {
        int mt, nt, split;
        ord.at(t, mt, nt, split);
        const int m0 = mt * WG_BM, n0 = nt * BN;
        const Steps st(split, K, kslice, sps);
        // the acc tile, once the ring holds this tile's first stages and
        // the consumers have read the last one
        auto load_acc = [&]() {
          mbar_wait(acc_empty, a_phase ^ 1);
          a_phase ^= 1;
          mbar_arrive_expect_tx(acc_full, P::C_BYTES);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int b = 0; b < P::BOXES; ++b)
              tma_load_3d(ctile + (h * P::BOXES + b) * C_BOX, &tacc, acc_full,
                          n0 + b * P::BOX_W, m0 + 64 * h, 0);
        };
        const int acc_after = min(STAGES, st.n) - 1;
        if (OUT == OUT_ACC && st.n == 0) load_acc();
        for (int i = 0; i < st.n; ++i) {
          mbar_wait(&empty[stage], phase ^ 1);
          int k0, lo, hi;
          st.at(i, k0, lo, hi);
          uint8_t* a = smem + stage * P::STAGE_BYTES;
          mbar_arrive_expect_tx(&full[stage], P::STAGE_BYTES);
          load_a<L>(a, &tx, &full[stage], k0, m0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) {
            if (L == NT)             // 64 rows of w, K-major
              tma_load_2d(a + A_BYTES + j * B_BOX, &tw, &full[stage], k0,
                          n0 + 64 * j);
            else
              tma_load_2d(a + A_BYTES + j * B_BOX, &tw, &full[stage],
                          n0 + 64 * j, k0);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
          if (OUT == OUT_ACC && i == acc_after) load_acc();
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  // shared memory by 32-bit address from one base: no 64-bit pointer and
  // no second address stays live beside the sums (with three, bn 256
  // spilled a register)
  const int t128 = tid % 128;
  const int lane = t128 & 31;
  const uint32_t ring = smem_u32(smem);
  // the staging buffers and the barriers lie at fixed offsets from it
  constexpr uint32_t CTILE = STAGES * P::STAGE_BYTES;
  constexpr uint32_t FULL = CTILE + P::C_BYTES, EMPTY = FULL + 8 * STAGES;
  // the sums' layout: warp w4 of the group holds rows 16 w4 + (lane/4)
  // and + 8 of its half; n-chunk j holds columns 8 j + 2 (lane % 4) and
  // + 1.  In a box, 16-byte chunk c of row r sits at chunk c ^ (r % 8)
  // (the 128-byte swizzle).
  const int r0 = (t128 >> 5) * 16 + (lane >> 2);
  int stage = 0, phase = 0, acc_phase = 0;
  uint32_t buf = 0;                 // the staging buffer of the next chunk
  float d[BN / 2];                  // first written by a wgmma (scale_d 0)
  for (int t = blockIdx.x; t < ord.items; t += gridDim.x) {
    // the mainloop needs only the tile's step count (its slices are
    // whole k-steps: nothing to zero); the coordinates are found again
    // for the epilogue, so they hold no registers beside the sums
    int n_steps;
    {
      int mt, nt, split;
      ord.at(t, mt, nt, split);
      n_steps = Steps(split, K, kslice, sps).n;
    }
    int prev = -1;
    for (int i = 0; i < n_steps; ++i) {
      mbar_wait(ring + FULL + 8 * stage, phase);
      const uint32_t a_addr = ring + stage * P::STAGE_BYTES + wg * 64 * 128;
      const uint32_t b_addr = ring + stage * P::STAGE_BYTES + A_BYTES;
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEP / 16; ++kk) {
        // K-major tiles advance 32 bytes a k16 step within their 128-byte
        // rows; MN-major ones (TN's A, NN's and TN's B) 16 rows of 128
        // bytes, their 64-wide boxes B_BOX apart
        const uint64_t da =
            L == TN ? wgmma_desc_sw128(a_addr + kk * 16 * 128, B_BOX, 1024)
                    : wgmma_desc_sw128(a_addr + kk * 32, 16, 1024);
        const uint64_t db =
            L == NT ? wgmma_desc_sw128(b_addr + kk * 32, 16, 1024)
                    : wgmma_desc_sw128(b_addr + kk * 16 * 128, B_BOX, 1024);
        wgmma_step<BN, L>(d, da, db, i > 0 || kk > 0);
      }
      wgmma_commit();
      // keep this step's products in flight; the previous step's are
      // done, so its stage goes back to the producer
      wgmma_wait<1>();
      fence_regs(d);
      if (prev >= 0 && t128 == 0) mbar_arrive(ring + EMPTY + 8 * prev);
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(d);
    if (prev >= 0 && t128 == 0) mbar_arrive(ring + EMPTY + 8 * prev);
    if (n_steps == 0) {             // an empty K range adds nothing
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) d[j] = 0.0f;
    }
    int mt, nt, split;
    ord.at(t, mt, nt, split);
    const int m0 = mt * WG_BM, n0 = nt * BN;
    if constexpr (OUT == OUT_ACC) {
      // y = acc + sum: acc from its tile (this warpgroup's boxes), y from
      // registers
      mbar_wait(smem_u32(acc_full), acc_phase);
      acc_phase ^= 1;
      const uint32_t ahalf = smem_u32(ctile) + wg * P::BOXES * C_BOX;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * (lane & 3), cc = col % 32;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          const int gr = m0 + 64 * wg + r, gc = n0 + col;
          if (gr < M && gc < N) {
            const float2 a = ld_shared_f2(ahalf + (col / 32) * C_BOX + r * 128 +
                                          (((cc >> 2) ^ (r & 7)) << 4) +
                                          (cc & 3) * 4);
            *reinterpret_cast<float2*>(yacc + (size_t)gr * N + gc) =
                make_float2(a.x + d[4 * j + 2 * h], a.y + d[4 * j + 2 * h + 1]);
          }
        }
      }
      named_bar_sync(1 + wg, 128);
      if (t128 == 0) mbar_arrive(acc_empty);    // this half was read
    } else {
#pragma unroll
      for (int c = 0; c < P::BOXES; ++c) {
        // one box (64 bf16 or 32 fp32 columns) a chunk; the buffers
        // alternate chunk by chunk across tiles (a tile of bn 192 has 3
        // bf16 chunks), so this one's store is two chunks back and
        // bulk_wait_read<1> sees it leave
        const uint32_t cb = ring + CTILE + (wg + 2 * buf) * C_BOX;
        buf ^= 1;
        if (t128 == 0) bulk_wait_read<1>();
        named_bar_sync(1 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < P::BOX_W / 8; ++jj) {
          const int j = P::BOX_W / 8 * c + jj, col = 8 * jj + 2 * (lane & 3);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
            if constexpr (OUT == OUT_BF16) {
              st_shared(cb + r * 128 + (((col >> 3) ^ (r & 7)) << 4) +
                            (col & 7) * 2,
                        pack_bf16(v0, v1));
            } else {                // col < 32: one box
              st_shared(cb + r * 128 + (((col >> 2) ^ (r & 7)) << 4) +
                            (col & 3) * 4,
                        v0, v1);
            }
          }
        }
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);
        if (t128 == 0) {
          tma_store_3d(&ty, cb, n0 + P::BOX_W * c, m0 + 64 * wg,
                       OUT == OUT_F32 ? split : 0);
          bulk_commit();
        }
      }
    }
  }
  if (t128 == 0) bulk_wait_all();
}

// --- split-K reduction: y = sum over splits, in split order, cast; in the
// accumulating form y = acc + that sum, in fp32 ----------------------------

__global__ void split_matmul_reduce_kernel(const float4* __restrict__ ws,
                                           void* y, const float4* c_in,
                                           long long n4, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 s = ws[i];
    for (int p = 1; p < splits; ++p) {
      const float4 t = ws[p * n4 + i];
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    if (c_in) {
      const float4 a = c_in[i];
      reinterpret_cast<float4*>(y)[i] =
          make_float4(a.x + s.x, a.y + s.y, a.z + s.z, a.w + s.w);
    } else {
      reinterpret_cast<uint2*>(y)[i] = make_uint2(
          hopper::pack_bf16(s.x, s.y), hopper::pack_bf16(s.z, s.w));
    }
  }
}

int launch_reduce(const float* ws, void* y, const float* acc, int M, int N,
                  int splits, cudaStream_t stream) {
  const long long n4 = (long long)M * N / 4;   // N % 8 == 0
  const int blocks = (int)min((n4 + 255) / 256, (long long)132 * 8);
  split_matmul_reduce_kernel<<<blocks, 256, 0, stream>>>(
      (const float4*)ws, y, (const float4*)acc, n4, splits);
  return (int)cudaGetLastError();
}

template <int BN, int MT>
int launch_stream(const void* x, const void* w, void* y, float* ws,
                  const float* acc, int M, int N, int K, int kslice,
                  int splits, int sps, cudaStream_t stream) {
  using P = Stream<BN, MT>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_matmul_stream_kernel<BN, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const dim3 grid((N + BN - 1) / BN, splits);
  split_matmul_stream_kernel<BN, MT><<<grid, P::THREADS, P::SMEM, stream>>>(
      (const bf16*)x, (const bf16*)w, y, splits > 1 ? ws : nullptr, acc, M, N,
      K, kslice, sps);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_stream_m(const void* x, const void* w, void* y, float* ws,
                    const float* acc, int M, int N, int K, int kslice,
                    int splits, int sps, cudaStream_t st) {
  const int mt = (M + 7) / 8;
  if (mt <= 1) return launch_stream<BN, 1>(x, w, y, ws, acc, M, N, K, kslice, splits, sps, st);
  if (mt <= 2) return launch_stream<BN, 2>(x, w, y, ws, acc, M, N, K, kslice, splits, sps, st);
  if (mt <= 4) return launch_stream<BN, 4>(x, w, y, ws, acc, M, N, K, kslice, splits, sps, st);
  if (mt <= 8) return launch_stream<BN, 8>(x, w, y, ws, acc, M, N, K, kslice, splits, sps, st);
  return (int)cudaErrorInvalidValue;
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// a row-major bf16 (outer, inner) matrix, read in (box_outer, box_inner)
// tiles with the 128-byte swizzle; out-of-range elements read as zero
bool tensor_map(CUtensorMap* map, const void* ptr, int inner, int outer,
                int box_inner, int box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// out (M, N) = x (M, K) . B (K, N) in layout L (NN or NT): w is B as
// stored ((K, N), or (N, K) for NT)
template <int BN, int L>
int launch_wgmma(const void* x, const void* w, void* y, float* ws, int M,
                 int N, int K, int kslice, int splits, int sps,
                 cudaStream_t stream) {
  CUtensorMap tx, tw;
  const bool ok_x = tensor_map(&tx, x, K, M, KSTEP, WG_BM);
  const bool ok_w = L == NT ? tensor_map(&tw, w, K, N, KSTEP, 64)
                            : tensor_map(&tw, w, N, K, 64, KSTEP);
  if (!ok_x || !ok_w) return (int)cudaErrorInvalidValue;
  constexpr int smem = Wg<BN>::SMEM;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_matmul_wgmma_kernel<BN, L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const dim3 grid((M + WG_BM - 1) / WG_BM, (N + BN - 1) / BN, splits);
  split_matmul_wgmma_kernel<BN, L><<<grid, 384, smem, stream>>>(
      tx, tw, y, splits > 1 ? ws : nullptr, M, N, K, kslice, sps);
  return (int)cudaGetLastError();
}

// an output (S, M, N) of fp32 or bf16, written (or, for acc, read) in
// boxes of 64 rows by 128 bytes with the 128-byte swizzle
bool out_map(CUtensorMap* map, const void* ptr, bool f32, int N, int M,
             int S) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const int esize = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)M, (cuuint64_t)S};
  const cuuint64_t strides[2] = {(cuuint64_t)N * esize,
                                 (cuuint64_t)M * N * esize};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / esize), 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// out (M, N) = A (M, K) . B (K, N) in layout L into `out`: bf16 y, fp32
// partials (S = splits, M, N), or the fp32 acc + x . w.  x is A as stored
// ((M, K), or (K, M) for TN), w is B as stored ((K, N), or (N, K) for NT)
template <int BN, int L, int OUT>
int launch_persistent(const void* x, const void* w, void* out,
                      const float* acc, int M, int N, int K, int kslice,
                      int splits, int sps, int blocks, int group,
                      cudaStream_t stream) {
  using P = Ps<BN, OUT>;
  CUtensorMap tx, tw, ty, tacc;
  const bool ok =
      (L == TN ? tensor_map(&tx, x, M, K, 64, KSTEP)
               : tensor_map(&tx, x, K, M, KSTEP, WG_BM)) &&
      (L == NT ? tensor_map(&tw, w, K, N, KSTEP, 64)
               : tensor_map(&tw, w, N, K, 64, KSTEP)) &&
      (OUT == OUT_ACC ? out_map(&tacc, acc, true, N, M, 1)
                      : out_map(&ty, out, OUT != OUT_BF16, N, M,
                                OUT == OUT_F32 ? splits : 1));
  if (!ok) return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_matmul_persistent_kernel<BN, L, OUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  split_matmul_persistent_kernel<BN, L, OUT><<<blocks, 384, P::SMEM, stream>>>(
      tx, tw, OUT == OUT_ACC ? tacc : ty, OUT == OUT_ACC ? tacc : ty,
      OUT == OUT_ACC ? (float*)out : nullptr, M, N, K, kslice, sps, splits,
      group);
  return (int)cudaGetLastError();
}

template <int L, int OUT>
int launch_persistent_bn(const void* x, const void* w, void* out,
                         const float* acc, int M, int N, int K, int kslice,
                         int bn, int splits, int sps, int blocks, int group,
                         cudaStream_t st) {
  if (bn == 256) return launch_persistent<256, L, OUT>(x, w, out, acc, M, N, K, kslice, splits, sps, blocks, group, st);
  if (bn == 192) return launch_persistent<192, L, OUT>(x, w, out, acc, M, N, K, kslice, splits, sps, blocks, group, st);
  if (bn == 128) return launch_persistent<128, L, OUT>(x, w, out, acc, M, N, K, kslice, splits, sps, blocks, group, st);
  return (int)cudaErrorInvalidValue;
}

template <int L>
int launch_wgmma_bn(const void* x, const void* w, void* y, float* ws, int M,
                    int N, int K, int kslice, int bn, int splits, int sps,
                    cudaStream_t st) {
  if (bn == 256) return launch_wgmma<256, L>(x, w, y, ws, M, N, K, kslice, splits, sps, st);
  if (bn == 192) return launch_wgmma<192, L>(x, w, y, ws, M, N, K, kslice, splits, sps, st);
  if (bn == 128) return launch_wgmma<128, L>(x, w, y, ws, M, N, K, kslice, splits, sps, st);
  if (bn == 64) return launch_wgmma<64, L>(x, w, y, ws, M, N, K, kslice, splits, sps, st);
  return (int)cudaErrorInvalidValue;
}

// --- any layout, any shape, bf16 or float32: strided CUDA-core kernel ------
// out (R, C) = sum_k A(r, k) B(k, c), A(r, k) = a[r * sar + k * sak],
// B(k, c) = b[k * sbk + c * sbc], fp32 sums in k order, each thread a 4x4
// patch of a 64x64 tile.  For what the wgmma design cannot take in the
// backward layouts (float32; a row stride not a multiple of 8; a base
// pointer not 16-byte aligned).

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(256)
split_matmul_strided_kernel(const T* __restrict__ a, const T* __restrict__ b,
                            T* __restrict__ y, int R, int C, int Kc,
                            long long sar, long long sak, long long sbk,
                            long long sbc) {
  constexpr int FK = 16, TR = 64, TCOL = 64;
  __shared__ float As[FK][TR + 1];
  __shared__ float Bs[FK][TCOL];
  const int tid = threadIdx.x;
  const int tr = (tid / 16) * 4, tc = (tid % 16) * 4;
  const int r0 = blockIdx.y * TR, c0 = blockIdx.x * TCOL;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < Kc; k0 += FK) {
    for (int e = tid; e < TR * FK; e += 256) {
      const int r = e % TR, kk = e / TR;
      const int gr = r0 + r, gk = k0 + kk;
      As[kk][r] = (gr < R && gk < Kc) ? to_f(a[gr * sar + gk * sak]) : 0.0f;
    }
    for (int e = tid; e < FK * TCOL; e += 256) {
      const int c = e % TCOL, kk = e / TCOL;
      const int gk = k0 + kk, gc = c0 + c;
      Bs[kk][c] = (gk < Kc && gc < C) ? to_f(b[gk * sbk + gc * sbc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][tr + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tc + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = r0 + tr + i, gc = c0 + tc + j;
      if (gr < R && gc < C) from_f(y + (size_t)gr * C + gc, acc[i][j]);
    }
}

}  // namespace

// (a): bn in {16, 32, 64, 128}, M <= 64; (b): bn in {64, 128, 192, 256}.  `ws` holds
// (splits, M, N) fp32 when splits > 1.  kslice <= K; splits * sps slices
// cover K.  `acc`, when not null, is an fp32 (M, N) tensor and y is then
// fp32 = acc + x @ w (the accumulating form; y may be acc itself).  Each
// returns a cudaError_t code.
extern "C" int split_matmul_stream_bf16(const void* x, const void* w, void* y,
                                        void* ws, const void* acc, int M,
                                        int N, int K, int kslice, int bn,
                                        int splits, int sps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* wsf = (float*)ws;
  const float* af = (const float*)acc;
  int rc;
  if (bn == 128) rc = launch_stream_m<128>(x, w, y, wsf, af, M, N, K, kslice, splits, sps, st);
  else if (bn == 64) rc = launch_stream_m<64>(x, w, y, wsf, af, M, N, K, kslice, splits, sps, st);
  else if (bn == 32) rc = launch_stream_m<32>(x, w, y, wsf, af, M, N, K, kslice, splits, sps, st);
  else if (bn == 16) rc = launch_stream_m<16>(x, w, y, wsf, af, M, N, K, kslice, splits, sps, st);
  else return (int)cudaErrorInvalidValue;
  if (rc != 0 || splits <= 1) return rc;
  return launch_reduce(wsf, y, af, M, N, splits, st);
}

// layout 0 = NN (x (M,K) . w (K,N)) or 1 = NT (x (M,K) . w^T, w stored
// (N,K)); bf16 out (M, N).  NT needs kslice % 64 == 0 (the wrapper's
// plan gives it).  The accumulating form, dgrad and wgrad (layout 2) at
// these rows are the persistent design's, below.
extern "C" int split_matmul_wgmma_bf16(const void* x, const void* w, void* y,
                                       void* ws, int layout, int M, int N,
                                       int K, int kslice, int bn, int splits,
                                       int sps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* wsf = (float*)ws;
  if (layout != NN && kslice % KSTEP) return (int)cudaErrorInvalidValue;
  int rc;
  if (layout == NN) rc = launch_wgmma_bn<NN>(x, w, y, wsf, M, N, K, kslice, bn, splits, sps, st);
  else if (layout == NT) rc = launch_wgmma_bn<NT>(x, w, y, wsf, M, N, K, kslice, bn, splits, sps, st);
  else return (int)cudaErrorInvalidValue;
  if (rc != 0 || splits <= 1) return rc;
  return launch_reduce(wsf, y, nullptr, M, N, splits, st);
}

// (d): layout 0 = NN, 1 = NT or 2 = TN (x^T . w, x stored (K, M), w
// (K, N)), bn in {128, 192, 256} (128 with acc and one split), kslice a
// multiple of 64 or all of K; the grid is `blocks` persistent blocks
// walking the tiles in groups of `group` row tiles (`TileOrder`).  With
// splits > 1 the partials go to `ws` and the reduce sums them (adding
// `acc`); else with `acc` (NN only) y is the fp32 acc + x @ w, else bf16.
extern "C" int split_matmul_persistent_bf16(const void* x, const void* w,
                                            void* y, void* ws,
                                            const void* acc, int layout,
                                            int M, int N, int K, int kslice,
                                            int bn, int splits, int sps,
                                            int blocks, int group,
                                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* wsf = (float*)ws;
  const float* af = (const float*)acc;
  if (layout < NN || layout > TN || (kslice % KSTEP && kslice < K) ||
      (layout != NN && af) || blocks < 1 || group < 1 || (splits > 1 && !wsf))
    return (int)cudaErrorInvalidValue;
  int rc;
  if (splits > 1) {
    rc = layout == NN ? launch_persistent_bn<NN, OUT_F32>(x, w, wsf, nullptr, M, N, K, kslice, bn, splits, sps, blocks, group, st)
       : layout == NT ? launch_persistent_bn<NT, OUT_F32>(x, w, wsf, nullptr, M, N, K, kslice, bn, splits, sps, blocks, group, st)
                      : launch_persistent_bn<TN, OUT_F32>(x, w, wsf, nullptr, M, N, K, kslice, bn, splits, sps, blocks, group, st);
    if (rc != 0) return rc;
    return launch_reduce(wsf, y, af, M, N, splits, st);
  }
  if (af)   // the fp32 acc tile leaves 4 or more ring stages at bn 128 only
    return bn == 128 ? launch_persistent<128, NN, OUT_ACC>(x, w, y, af, M, N, K, kslice, 1, sps, blocks, group, st)
                     : (int)cudaErrorInvalidValue;
  if (layout == NN) return launch_persistent_bn<NN, OUT_BF16>(x, w, y, nullptr, M, N, K, kslice, bn, 1, sps, blocks, group, st);
  if (layout == NT) return launch_persistent_bn<NT, OUT_BF16>(x, w, y, nullptr, M, N, K, kslice, bn, 1, sps, blocks, group, st);
  return launch_persistent_bn<TN, OUT_BF16>(x, w, y, nullptr, M, N, K, kslice, bn, 1, sps, blocks, group, st);
}

// out (R, C) = A . B with A(r, k) = a[r sar + k sak], B(k, c) = b[k sbk +
// c sbc]; dtype 0 = float32, 1 = bfloat16.
extern "C" int split_matmul_strided(const void* a, const void* b, void* y,
                                    int R, int C, int Kc, long long sar,
                                    long long sak, long long sbk,
                                    long long sbc, int dtype, void* stream) {
  const dim3 grid((C + 63) / 64, (R + 63) / 64);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    split_matmul_strided_kernel<bf16><<<grid, 256, 0, st>>>(
        (const bf16*)a, (const bf16*)b, (bf16*)y, R, C, Kc, sar, sak, sbk,
        sbc);
  else
    split_matmul_strided_kernel<float><<<grid, 256, 0, st>>>(
        (const float*)a, (const float*)b, (float*)y, R, C, Kc, sar, sak, sbk,
        sbc);
  return (int)cudaGetLastError();
}

extern "C" int split_matmul_bf16(const void* x, const void* w, void* y,
                                 const void* acc, int M, int N, int K,
                                 int kslice, void* stream) {
  using namespace general;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const int ks = (((kslice > 1 ? kslice : 1) + BK - 1) / BK) * BK;
  const int vec_x = (K % 8 == 0) && ((uintptr_t)x % 16 == 0);
  const int vec_w = (N % 8 == 0) && ((uintptr_t)w % 16 == 0);
  split_matmul_bf16_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, y, (const float*)acc,
      M, N, K, ks, vec_x, vec_w);
  return (int)cudaGetLastError();
}

extern "C" int split_matmul_f32(const void* x, const void* w, void* y,
                                const void* acc, int M, int N, int K,
                                int kslice, void* stream) {
  using namespace general;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  split_matmul_f32_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)y, (const float*)acc, M, N, K,
      kslice > 1 ? kslice : 1);
  return (int)cudaGetLastError();
}
