// flash_attention for Hopper (sm_90a): online-softmax GQA attention with
// causal and sliding-window masks, in the model layout
//   q: (B, S, KV, G, hd)   k, v: (B, T, KV, hd)   out: like q
// all contiguous, bf16 or float32, hd in {64, 128}.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body `_kernel`).  Same contract: fp32 running max m,
// sum l and accumulator, scores scaled by `scale` (1/sqrt(hd)), masks
// from positions (query position = q_offset + s, key position = t),
// NEG_INF = -1e30, output acc / max(l, 1e-30).  As there, G folds into
// the score rows: a block owns consecutive (s, g) rows of one (batch, kv
// head) pair, so a K/V tile loaded once serves every query head of the
// group.  Unlike the TPU kernel it needs no transposes, takes ragged S and
// T, and skips key tiles that are masked for every row of the block.  A
// masked entry contributes p = 0 explicitly, so no row ever sums a masked
// entry; rows with no valid key at all (which the model path never
// produces) come out 0, where the plain version averages v.
//
// What bounds it on an H100: at the path's prefill shapes ((1, 333..512,
// 8, 3, 128), causal) the work is 4*hd*H*S*(S+1)/2 operations over a few
// MB of q/k/v/out: about 1.6 GFLOP against 3 MB at S = 512, so the bound
// is a couple of microseconds either way and what decides the time is how
// fast the tensor cores are fed and how evenly the causal triangle is
// spread over the 132 SMs.
//
// bf16 design (the serve path).  A block of 4 warps owns 64 (s, g) rows;
// each warp owns 16 of them and keeps their q fragments in registers for
// the whole key walk.  K and V tiles of 64 keys stay bf16 in shared memory
// with rows padded by 16 bytes (hd + 8 elements), so the 8 row addresses
// of every ldmatrix fall in distinct banks; they are double-buffered with
// cp.async, the next tile's copy in flight while the current one is used.
// q.k^T and p.v run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate).  The online softmax runs on the score fragments in
// registers (log2 domain, exp2), row max and row sum by shuffles within
// the quad of lanes that holds a row; p is packed to bf16 in registers and
// is directly the A operand of p.v (the accumulator layout of two n8 tiles
// is the A layout of one k16 step), with no trip through shared memory.
// Masks are evaluated only on tiles that touch the causal diagonal, the
// window edge or the end of T.  Causal row tiles are issued longest first
// (the last rows see the most keys), kv heads fastest, so the triangle
// balances over the SMs: (1, 512, 8, 3, 128) is a 8 x 24 grid.
//
// float32 inputs (off the serve path) take a CUDA-core kernel: 32 rows a
// block, one lane per key for the scores and one lane per output column
// for p.v, all in fp32.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
constexpr float LN2 = 0.6931471805599453f;
// logsumexp of a row from its running max (log2 units) and sum; +inf for
// a row with no valid key, so that a recomputed exp(s - lse) is 0
__device__ __forceinline__ float row_lse(float m_log2, float l) {
  return l > 0.0f ? (m_log2 + log2f(l)) * LN2 : INFINITY;
}

// --- bf16: tensor cores ------------------------------------------------------

constexpr int BR = 64;        // (s, g) rows per block, 16 per warp
constexpr int BC = 64;        // keys per K/V tile
constexpr int TC_THREADS = 128;

template <int HD>
constexpr int tc_smem_bytes() {
  return 5 * BR * (HD + 8) * 2;   // q, 2 x k, 2 x v
}

template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  float* __restrict__ lse, int S,
                  int T_, int KV, int G, int causal, int window,
                  int q_offset, float scale_log2) {
  using namespace hopper;
  constexpr int LD = HD + 8;       // padded row, elements
  constexpr int TILE = BR * LD;
  constexpr int CH = HD / 8;       // 16-byte chunks in a row
  constexpr int KD = HD / 16;      // k16 steps over hd
  extern __shared__ __align__(16) bf16 smem[];
  bf16* qs = smem;
  bf16* ks = smem + TILE;          // [2][BC][LD]
  bf16* vs = ks + 2 * TILE;        // [2][BC][LD]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int n_rows = S * G;
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int row0 = tile * BR;
  const int last_row = min(n_rows - 1, row0 + BR - 1);
  const int qpos_lo = q_offset + row0 / G;
  const int qpos_hi = q_offset + last_row / G;
  const int k_end = causal ? min(T_, qpos_hi + 1) : T_;
  const int k_begin = window > 0 ? max(0, qpos_lo - window + 1) : 0;
  const int kb0 = (k_begin / BC) * BC;
  const int n_kt = k_end > kb0 ? (k_end - kb0 + BC - 1) / BC : 0;

  // q rows of the block, row i at (((b*S + s)*KV + h)*G + g)*HD
  for (int c = tid; c < BR * CH; c += TC_THREADS) {
    const int r = c / CH, cc = c % CH;
    const int i = row0 + r;
    const bf16* src = q;
    int bytes = 0;
    if (i < n_rows) {
      src = q + ((((size_t)b * S + i / G) * KV + h) * G + i % G) * HD +
            cc * 8;
      bytes = 16;
    }
    cp_async16(qs + r * LD + cc * 8, src, bytes);
  }
  cp_async_commit();
  auto load_kv = [&](int kt, int buf) {
    const int kb = kb0 + kt * BC;
    for (int c = tid; c < BC * CH; c += TC_THREADS) {
      const int r = c / CH, cc = c % CH;
      const int key = kb + r;
      size_t off = 0;
      int bytes = 0;
      if (key < T_) {
        off = (((size_t)b * T_ + key) * KV + h) * HD + cc * 8;
        bytes = 16;
      }
      cp_async16(ks + buf * TILE + r * LD + cc * 8, k + off, bytes);
      cp_async16(vs + buf * TILE + r * LD + cc * 8, v + off, bytes);
    }
  };
  if (n_kt > 0) load_kv(0, 0);
  cp_async_commit();

  // this lane's two rows of the warp's 16: qr and qr + 8
  const int qr = lane >> 2, qc = lane & 3;
  const int ra = row0 + warp * 16 + qr;
  const int rb = ra + 8;
  const int qpa = q_offset + ra / G;
  const int qpb = q_offset + rb / G;

  cp_async_wait<1>();              // q has landed
  __syncthreads();
  uint32_t qf[KD][4];
  {
    const int mi = lane >> 3, r = lane & 7;
#pragma unroll
    for (int d = 0; d < KD; ++d)
      ldmatrix_x4(qf[d], qs + (warp * 16 + r + 8 * (mi & 1)) * LD + d * 16 +
                             8 * (mi >> 1));
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float m_a = NEG_INF, m_b = NEG_INF;   // running max, log2 units
  float l_a = 0.0f, l_b = 0.0f;         // this lane's share of the row sum

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) load_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kst = ks + buf * TILE;
    const bf16* vst = vs + buf * TILE;

    // scores: 16 rows x 64 keys a warp, fp32 fragments
    float sc[BC / 8][4];
#pragma unroll
    for (int j = 0; j < BC / 8; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
    {
      const int mi = lane >> 3, r = lane & 7;
#pragma unroll
      for (int d = 0; d < KD; ++d) {
#pragma unroll
        for (int np = 0; np < BC / 16; ++np) {
          uint32_t bb[4];
          ldmatrix_x4(bb, kst + (np * 16 + r + 8 * (mi >> 1)) * LD + d * 16 +
                              8 * (mi & 1));
          mma_bf16(sc[2 * np], qf[d], bb[0], bb[1]);
          mma_bf16(sc[2 * np + 1], qf[d], bb[2], bb[3]);
        }
      }
    }

    // masks (edge tiles only) and the online softmax in registers
    const int kb = kb0 + kt * BC;
    const bool edge = kb + BC > T_ || (causal && kb + BC - 1 > qpos_lo) ||
                      (window > 0 && qpos_hi - kb >= window);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[j][e] * scale_log2;
        if (edge) {
          const int key = kb + 8 * j + 2 * qc + (e & 1);
          const int qp = e < 2 ? qpa : qpb;
          const bool ok = key < T_ && (!causal || key <= qp) &&
                          (window <= 0 || qp - key < window);
          s = ok ? s : -INFINITY;
        }
        sc[j][e] = s;
        if (e < 2) mx_a = fmaxf(mx_a, s);
        else mx_b = fmaxf(mx_b, s);
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float corr_a = exp2f(m_a - mn_a);
    const float corr_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
      sc[j][0] = exp2f(sc[j][0] - m_a);
      sc[j][1] = exp2f(sc[j][1] - m_a);
      sc[j][2] = exp2f(sc[j][2] - m_b);
      sc[j][3] = exp2f(sc[j][3] - m_b);
      ps_a += sc[j][0] + sc[j][1];
      ps_b += sc[j][2] + sc[j][3];
    }
    l_a = l_a * corr_a + ps_a;
    l_b = l_b * corr_b + ps_b;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[j][0] *= corr_a;
      acc[j][1] *= corr_a;
      acc[j][2] *= corr_b;
      acc[j][3] *= corr_b;
    }

    // acc += p . v, p from registers as the A operand
    {
      const int mi = lane >> 3, r = lane & 7;
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
        pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
        pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
        for (int dn = 0; dn < HD / 16; ++dn) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, vst + (kk * 16 + r + 8 * (mi & 1)) * LD +
                                    dn * 16 + 8 * (mi >> 1));
          mma_bf16(acc[2 * dn], pa, bb[0], bb[1]);
          mma_bf16(acc[2 * dn + 1], pa, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();   // this buffer is refilled two tiles on
  }

  const float sum_a = quad_sum(l_a), sum_b = quad_sum(l_b);
  const float inv_a = 1.0f / fmaxf(sum_a, 1e-30f);
  const float inv_b = 1.0f / fmaxf(sum_b, 1e-30f);
  if (lse != nullptr && qc == 0) {   // natural-log logsumexp of the scores
    const size_t base = ((size_t)b * S) * KV * G;
    if (ra < n_rows)
      lse[base + ((size_t)(ra / G) * KV + h) * G + ra % G] = row_lse(m_a, sum_a);
    if (rb < n_rows)
      lse[base + ((size_t)(rb / G) * KV + h) * G + rb % G] = row_lse(m_b, sum_b);
  }
  if (ra < n_rows) {
    bf16* dst = o + ((((size_t)b * S + ra / G) * KV + h) * G + ra % G) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * qc) =
          pack_bf16(acc[j][0] * inv_a, acc[j][1] * inv_a);
  }
  if (rb < n_rows) {
    bf16* dst = o + ((((size_t)b * S + rb / G) * KV + h) * G + rb % G) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * qc) =
          pack_bf16(acc[j][2] * inv_b, acc[j][3] * inv_b);
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int T_, int KV, int G, int causal,
                int window, int q_offset, float scale, cudaStream_t stream) {
  const int smem = tc_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * KV, (S * G + BR - 1) / BR);
  flash_bf16_kernel<HD><<<grid, TC_THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, S, T_, KV,
      G, causal, window, q_offset, scale * LOG2E);
  return (int)cudaGetLastError();
}

// --- float32: CUDA cores -----------------------------------------------------

constexpr int ROWS = 32;      // (s, g) rows per block
constexpr int TK = 32;        // keys per tile: one per lane
constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = ROWS / WARPS;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S,
                 int T_, int KV, int G, int causal, int window, int q_offset,
                 float scale) {
  constexpr int PER_LANE = HD / 32;     // output columns per lane
  extern __shared__ float fsmem[];
  float* qs = fsmem;                    // (ROWS, HD)
  float* ks = qs + ROWS * HD;           // (TK, HD + 1): padded, no conflicts
  float* vs = ks + TK * (HD + 1);       // (TK, HD)

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int bh = blockIdx.y;
  const int b = bh / KV;
  const int h = bh % KV;
  const int n_rows = S * G;
  const int row0 = blockIdx.x * ROWS;

  for (int e = tid; e < ROWS * HD; e += WARPS * 32) {
    const int r = e / HD, d = e % HD;
    const int i = row0 + r;
    float val = 0.0f;
    if (i < n_rows) {
      const int s = i / G, g = i % G;
      val = q[((((size_t)b * S + s) * KV + h) * G + g) * HD + d];
    }
    qs[e] = val;
  }

  const int last_row = min(n_rows - 1, row0 + ROWS - 1);
  const int qpos_lo = q_offset + row0 / G;
  const int qpos_hi = q_offset + last_row / G;
  const int k_end = causal ? min(T_, qpos_hi + 1) : T_;
  const int k_begin = window > 0 ? max(0, qpos_lo - window + 1) : 0;

  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], acc[ROWS_PER_WARP][PER_LANE];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) acc[i][j] = 0.0f;
  }

  for (int kb = (k_begin / TK) * TK; kb < k_end; kb += TK) {
    __syncthreads();   // previous tile fully consumed (and qs written)
    for (int e = tid; e < TK * HD; e += WARPS * 32) {
      const int t = e / HD, d = e % HD;
      const int key = kb + t;
      float kv_k = 0.0f, kv_v = 0.0f;
      if (key < T_) {
        const size_t off = (((size_t)b * T_ + key) * KV + h) * HD + d;
        kv_k = k[off];
        kv_v = v[off];
      }
      ks[t * (HD + 1) + d] = kv_k;
      vs[t * HD + d] = kv_v;
    }
    __syncthreads();

    const int key = kb + lane;
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp * ROWS_PER_WARP + i;
      const int row = row0 + r;
      if (row >= n_rows) continue;            // uniform across the warp
      const int qpos = q_offset + row / G;
      const float* qrow = qs + r * HD;
      const float* krow = ks + lane * (HD + 1);
      float sc = 0.0f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) sc = fmaf(qrow[d], krow[d], sc);
      sc *= scale;
      const bool valid = key < T_ && (!causal || key <= qpos) &&
                         (window <= 0 || qpos - key < window);
      const float m_new = fmaxf(m[i], warp_max(valid ? sc : NEG_INF));
      const float p = valid ? expf(sc - m_new) : 0.0f;
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) acc[i][j] *= corr;
#pragma unroll 8
      for (int t = 0; t < TK; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t);
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j)
          acc[i][j] = fmaf(pt, vs[t * HD + j * 32 + lane], acc[i][j]);
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int row = row0 + warp * ROWS_PER_WARP + i;
    if (row >= n_rows) continue;
    const int s = row / G, g = row % G;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && lane == 0)
      lse[((size_t)b * S + s) * KV * G + h * G + g] =
          l[i] > 0.0f ? m[i] + logf(l[i]) : INFINITY;
    float* dst = o + ((((size_t)b * S + s) * KV + h) * G + g) * HD;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) dst[j * 32 + lane] = acc[i][j] / denom;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int T_, int KV, int G, int causal,
               int window, int q_offset, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (ROWS * HD + TK * (HD + 1) + TK * HD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S * G + ROWS - 1) / ROWS, B * KV);
  flash_f32_kernel<HD><<<grid, WARPS * 32, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, S,
      T_, KV, G, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

// --- backward -----------------------------------------------------------------
//
// dq, dk, dv of the forward above from q, k, v, its output o, the saved
// row logsumexp `lse` (natural log, fp32, (B, S, KV, G)) and dO, all bf16
// (training on the card is bf16; the wrapper refuses float32).  The TPU
// kernel src/repro/kernels/flash_attention.py::flash_attention has no
// backward: the JAX package trains through the jnp twin's autodiff
// (src/repro/models/attention.py::flash_attention).  This answers to that
// gradient.
//
// What bounds it at the training shape ((8, 4096, 16, 1, 64), causal):
// five products of hd x (visible pairs) each, 10 hd S(S+1)/2 operations a
// (batch, head), 0.687 TFLOP in all, 0.695 ms at 989 TFLOP/s, against
// 539 MB (q, o, dO, dq, k, v, dk, dv, lse once each), 0.161 ms: the tensor
// cores.  The exp of each visible pair (2.1 G) is the next resource.
//
// Design: a row pass, one key-major kernel, a dq pass.
//  1. flash_bwd_stats_kernel, hd/8 lanes a row: D = rowsum(dO o) in fp32,
//     lse * log2(e) and the row's query position, into a (B*KV, query
//     tile, 3, BQ) array, so each step below takes its row values in one
//     bulk copy; the pad rows of a tile get lse = +inf, D = 0.
//  2. flash_bwd_kernel: a block owns BK = 128 keys of one (batch, kv
//     head), two warpgroups of 64 keys each, and walks every query tile
//     that sees them, the G heads of the group as rows, so the sum over
//     the group is the walk itself.  K and V stay in shared memory for the
//     whole walk; dK and dV accumulate in registers.  Thread 0 keeps a
//     3-stage ring of Q, dO (TMA, 128-byte swizzle, a 5-D box of BQ/G
//     positions x G heads, so any G <= BQ) and row values (bulk copy) in
//     flight on mbarriers, refilling a stage after the barrier that ends
//     the step that read it.  No producer warp: its registers would come
//     out of the consumers' (an SM sub-partition's 16K registers hold two
//     warps of 255, three of 168), and a step needs about 200.  A step of
//     BQ rows (128 at hd 64, 64 at hd 128), in two chunks of BQ/2 rows:
//       S^T = K Q^T and dP^T = V dO^T  (wgmma, both from shared memory)
//       P^T = exp2(S^T scale log2e - lse2), dS^T = P^T (dP^T - D)  (regs)
//       dV += P^T dO, dK += dS^T Q     (wgmma, P^T / dS^T as bf16
//                                       register A operands, in flight
//                                       under the next chunk's S^T, dP^T)
//     then dS^T (stored to shared memory as bf16) gives each warpgroup's
//     64 x 64 block of dQ_tile = dS K (wgmma, both operands transposed
//     reads of shared memory).  Five products and one exp a visible pair,
//     where the three-kernel design it replaced did seven and two; the
//     chunks keep one chunk's S^T and dP^T, dK and dV within the
//     registers at either head dim.
//  3. flash_bwd_dq_store_kernel: dq = bf16(dq_acc * scale), zeros for a
//     query tile that no key sees.
//  Masks: a (query tile, key tile) pair is full, or an edge pair (it
//  touches the causal diagonal, the window edge or the end of T), decided
//  once per pair from the tile's first and last positions; only edge
//  pairs test each element, against positions from the row array (no
//  per-element division).  Rows past S (and a tile's pad rows, when G does
//  not divide BQ) need no mask: their q and dO are zero and lse +inf.
//  dq without atomics in the order of the sum.  Each key tile adds its
//  dQ_tile into an fp32 scratch `dq_acc` in a fixed order, gated by one
//  int counter per (batch, kv head, query tile): the block stages the
//  tile in shared memory and thread 0 hands it to the copy engine, a bulk
//  copy for the first key tile of the order (so the scratch needs no
//  memset) and a bulk fp32 add (performed in L2) for the others; it
//  releases the counter once its copy has completed, a step later, so no
//  thread waits on device memory in the step.  Each element's add is
//  atomic and the adds into it come in a fixed order, so the sum's bits
//  are fixed.  The order is decreasing in the key tile (dq_rank): causal
//  key tile j reaches query tile i at step i - j of its walk (at hd 64),
//  so key tile j + 1 has reached it a step earlier and no block waits.
//  Blocks take their (batch, kv head, key tile) items by head (bwd_item):
//  all key tiles of a head together, the highest first, so they share
//  their q, dO and dq_acc tiles in L2.  So a head's causal key tiles are
//  issued shortest walk first: key tile 0, which sees the most rows, is
//  last, as the dq order needs.  (tools/flash_bwd_phases.py builds the
//  increasing order and tickets by key tile as variants and times them.)
//  Forward progress: a block takes its item from a ticket counter
//  (atomicAdd on the plan's counter 0, at its start), never from
//  blockIdx, and the ticket order puts every item after the one it waits
//  for (key tile j + 1 of the same head takes the ticket before key tile
//  j).  A block holding ticket t is running; the unfinished item with the
//  least ticket waits on nothing unfinished, so it finishes, and by
//  induction every item does, however few blocks are resident.  The waits themselves trap after
//  about 10 s, as mbar_wait does, so a broken plan fails the launch
//  instead of hanging the card.

constexpr int BWD_BK = 128;       // keys a block: 64 a warpgroup
constexpr int BWD_THREADS = 256;  // two warpgroups
constexpr int BWD_STAGES = 3;

template <int HD>
struct Bwd {
  // query rows a step: 128 at hd 64 (each warpgroup takes 64 rows of
  // dQ_tile), 64 at hd 128 (each takes 64 columns), so that dK, dV and
  // the step's S^T and dP^T fit the registers either way
  static constexpr int BQ = HD == 64 ? 128 : 64;
  static constexpr int NB = HD / 64;              // 64-column boxes a row
  static constexpr int NQ = BQ * HD / 256;        // dQ floats a thread
  // a step's rows are taken in two chunks (S^T, dP^T, P^T, dS^T and their
  // products), so that one chunk's accumulators, dK and dV fit at once
  static constexpr int CN = BQ / 2;
  static constexpr int KV_BYTES = NB * BWD_BK * 128;   // K or V
  static constexpr int DS_BYTES = BWD_BK * BQ * 2;     // dS^T
  static constexpr int DQ_BYTES = BQ * HD * 4;         // dQ_tile, fp32
  static constexpr int Q_BYTES = NB * BQ * 128;        // Q or dO of a step
  static constexpr int ROW_BYTES = 3 * BQ * 4;         // lse2, D, position
  static constexpr int STAGE_BYTES = 2 * Q_BYTES + (ROW_BYTES + 1023) / 1024 * 1024;
  static constexpr int BAR_BYTES = 1024;               // mbarriers, ticket
  // the ring aligned to 1024 bytes (the swizzle's period) in the launch
  static constexpr int SMEM = 2 * KV_BYTES + DS_BYTES + DQ_BYTES +
                              BWD_STAGES * STAGE_BYTES + BAR_BYTES + 1024;
};

// The tiles of one call.  kernels/flash_attention.py::BwdPlan mirrors
// these formulas; the CPU tests check them there.
struct BwdGeom {
  int S, T, G, causal, window, q_offset;
  int n_rows;   // S * G: (position, head) rows
  int rows;     // real rows a query tile: (BQ / G) * G
  int bk;       // keys a key tile
  int n_qt, n_kt;

  __host__ __device__ int row_end(int qt) const {
    return min(n_rows, (qt + 1) * rows);
  }
  __host__ __device__ int pos_lo(int qt) const {
    return q_offset + qt * rows / G;
  }
  __host__ __device__ int pos_hi(int qt) const {
    return q_offset + (row_end(qt) - 1) / G;
  }
  // key tiles that some row of query tile qt sees: [kt_lo, kt_hi], empty
  // when kt_lo > kt_hi
  __host__ __device__ int kt_lo(int qt) const {
    return (window > 0 ? max(0, pos_lo(qt) - window + 1) : 0) / bk;
  }
  __host__ __device__ int kt_hi(int qt) const {
    const int lo = window > 0 ? max(0, pos_lo(qt) - window + 1) : 0;
    const int hi = causal ? min(T - 1, pos_hi(qt)) : T - 1;
    return hi >= lo ? hi / bk : lo / bk - 1;
  }
  // query tiles that some key of key tile kt is seen by: [qb, qe)
  __host__ __device__ void walk(int kt, int& qb, int& qe) const {
    const int k0 = kt * bk, k1 = min(T, k0 + bk) - 1;
    const int s_lo = causal ? min(S, max(0, k0 - q_offset)) : 0;
    const int s_hi = window > 0 ? min(S, max(0, k1 + window - q_offset)) : S;
    qb = s_lo * G / rows;
    qe = s_hi > s_lo ? (s_hi * G + rows - 1) / rows : qb;
  }
  // every (row, key) pair of the tile pair visible: no mask needed
  __host__ __device__ bool full(int qt, int kt) const {
    const int k0 = kt * bk, k1 = k0 + bk - 1;
    return k1 < T && (!causal || k1 <= pos_lo(qt)) &&
           (window <= 0 || pos_hi(qt) - k0 < window);
  }
};

// The launch plan as kernels/flash_attention.py::BwdPlan.c_plan lays it
// out: int64 fields in this order.
struct BwdPlanC {
  long long bq, rows, bk, stages, n_qt, n_kt, items, smem, row_floats,
      acc_floats, counter_ints, row_blocks, store_blocks;
};

struct BwdArgs {
  BwdGeom g;
  int KV;
  float scale, scale_log2;
};

__device__ __forceinline__ bool bwd_visible(int key, int pos, const BwdGeom& g) {
  return key < g.T && (!g.causal || key <= pos) &&
         (g.window <= 0 || pos - key < g.window);
}

template <int HD>
__global__ void flash_bwd_stats_kernel(const bf16* __restrict__ o,
                                       const bf16* __restrict__ dout,
                                       const float* __restrict__ lse,
                                       float* __restrict__ rowv,
                                       const BwdGeom g, int KV,
                                       long long slots) {
  constexpr int BQ = Bwd<HD>::BQ;
  constexpr int L = HD / 8;                 // lanes a row, 16 bytes each
  const long long slot = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / L;
  const int part = threadIdx.x % L;
  if (slot >= slots) return;                // whole rows leave together
  const int r = (int)(slot % BQ);
  const long long tile = slot / BQ;                 // bh * n_qt + qt
  const int qt = (int)(tile % g.n_qt);
  const int bh = (int)(tile / g.n_qt);
  const int b = bh / KV, kh = bh % KV;
  const int row = qt * g.rows + r;
  const bool real = r < g.rows && row < g.n_rows;
  const int s = real ? row / g.G : 0, gg = real ? row % g.G : 0;
  const size_t at = (((size_t)b * g.S + s) * KV + kh) * g.G + gg;
  float acc = 0.0f;
  if (real) {
    const uint4 ov = reinterpret_cast<const uint4*>(o + at * HD)[part];
    const uint4 dv = reinterpret_cast<const uint4*>(dout + at * HD)[part];
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(op[e]);
      const float2 y = __bfloat1622float2(dp[e]);
      acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
    }
  }
#pragma unroll
  for (int m = L / 2; m > 0; m >>= 1)       // within the row's lanes
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (part == 0) {
    float* t = rowv + tile * 3 * BQ;
    t[r] = real ? lse[at] * LOG2E : INFINITY;
    t[BQ + r] = acc;
    reinterpret_cast<int*>(t)[2 * BQ + r] = g.q_offset + s;
  }
}

// dq = bf16(dq_acc * scale) in the model layout: one thread a float4 of
// the scratch, which holds each warpgroup's block of a query tile in the
// accumulator's order (see flash_bwd_kernel); a query tile that no key
// tile sees gets zeros.
template <int HD>
__global__ void flash_bwd_dq_store_kernel(const float4* __restrict__ acc,
                                          bf16* __restrict__ dq,
                                          const BwdGeom g, int KV,
                                          float scale, long long n4) {
  using C = Bwd<HD>;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int t128 = (int)(i % 128);
  const int v = (int)(i / 128 % (C::NQ / 4));
  const long long blk = i / (128 * (C::NQ / 4));    // (bh * n_qt + qt) * 2 + wg
  const int wg = (int)(blk % 2);
  const int qt = (int)(blk / 2 % g.n_qt);
  const int bh = (int)(blk / 2 / g.n_qt);
  const int b = bh / KV, kh = bh % KV;
  const int lane = t128 & 31;
  const int r0 = (C::BQ == 128 ? 64 * wg : 0) + 16 * (t128 >> 5) + (lane >> 2);
  const int col = (C::BQ == 128 ? 0 : HD / 2 * wg) + 8 * v + 2 * (lane & 3);
  const bool keys = g.kt_lo(qt) <= g.kt_hi(qt);
  const float4 x = keys ? acc[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int row = qt * g.rows + r;
    if (r >= g.rows || row >= g.n_rows) continue;
    bf16* dst = dq + ((((size_t)b * g.S + row / g.G) * KV + kh) * g.G +
                      row % g.G) * HD + col;
    *reinterpret_cast<uint32_t*>(dst) =
        hopper::pack_bf16((h ? x.z : x.x) * scale, (h ? x.w : x.y) * scale);
  }
}

// 2^x on the special-function unit alone (exp2f adds range handling the
// backward does not need: x <= 0 but for rounding, -inf where masked)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A step's row values from shared memory, read where they are used: as
// volatile loads the compiler does not hoist all of them ahead, which
// would hold 32 more registers through the step.
__device__ __forceinline__ float2 lds_f2(const float* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(hopper::smem_u32(p)));
  return v;
}
__device__ __forceinline__ int2 lds_i2(const int* p) {
  int2 v;
  asm volatile("ld.shared.v2.s32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(hopper::smem_u32(p)));
  return v;
}

// The products of a step (the names let tools/flash_bwd_phases.py build
// variants without them).
// S^T or dP^T (64 keys x a chunk of rows) = A . B^T over hd, both K-major
__device__ __forceinline__ void mma_s(float (&d)[32], uint64_t da,
                                      uint64_t db, int scale_d) {
  hopper::wgmma_m64n64k16<0, 0>(d, da, db, scale_d);
}
__device__ __forceinline__ void mma_s(float (&d)[16], uint64_t da,
                                      uint64_t db, int scale_d) {
  hopper::wgmma_m64n32k16<0, 0>(d, da, db, scale_d);
}
// dV or dK (64 keys x hd) += P^T or dS^T (registers) . dO or Q (MN-major)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  hopper::wgmma_m64n64k16_rs<1>(d, a, db, 1);
}
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t db) {
  hopper::wgmma_m64n128k16_rs<1>(d, a, db, 1);
}
// a 64 x 64 (or 64 x 32) block of dQ_tile = dS (stored as dS^T) . K,
// both MN-major
__device__ __forceinline__ void mma_dq(float (&d)[16], uint64_t da,
                                       uint64_t db, int scale_d) {
  hopper::wgmma_m64n32k16<1, 1>(d, da, db, scale_d);
}
__device__ __forceinline__ void mma_dq(float (&d)[32], uint64_t da,
                                       uint64_t db, int scale_d) {
  hopper::wgmma_m64n64k16<1, 1>(d, da, db, scale_d);
}

// Keeps A fragments that an in-flight wgmma reads alive until its wait.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Waits until `rank` key tiles have added into this query tile's dq_acc.
__device__ __forceinline__ void dq_wait(const int* cnt, int rank) {
  const long long t0 = clock64();
  while (hopper::ld_acquire(cnt) != rank) {
    if (clock64() - t0 > 20000000000LL) __trap();
    __nanosleep(32);
  }
  hopper::fence_proxy_async_global();   // before the bulk add it gates
}

// Adds a key tile's dQ_tile (both warpgroups' blocks, staged in shared
// memory at `src`) into the query tile's fp32 sum `dst`, by one bulk copy
// that the copy engine performs: rank 0 writes, a later rank adds
// (element by element in L2, sum + this tile).
__device__ __forceinline__ void dq_add(float* dst, const void* src,
                                       uint32_t bytes, int rank) {
  if (rank == 0)
    hopper::bulk_store(dst, src, bytes);
  else
    hopper::bulk_reduce_add_f32(dst, src, bytes);
  hopper::bulk_commit();
}

// After this thread's last dq_add has completed: lets the next key tile
// of the order add into that query tile.
__device__ __forceinline__ void dq_release(int* cnt, int rank) {
  hopper::bulk_wait_all();
  hopper::fence_proxy_async_global();
  __threadfence();
  hopper::st_release(cnt, rank + 1);
}

// The item (batch * KV + kv head, key tile) of ticket t: the key tiles of
// a head together, the highest first (see the note above).
__device__ __forceinline__ int2 bwd_item(int t, int n_kt, int BH) {
  return make_int2(t / n_kt, n_kt - 1 - t % n_kt);
}

// Key tile kt's place in the dq order of a query tile that key tiles
// [lo, hi] see: decreasing key tile.
__device__ __forceinline__ int dq_rank(int kt, int lo, int hi) {
  return hi - kt;
}

// flash_bwd_phases: variant macros go here

template <int HD>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const float* __restrict__ rowv, float* __restrict__ dq_acc,
                 int* __restrict__ counters, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, const BwdArgs a) {
  using namespace hopper;
  using C = Bwd<HD>;
  constexpr int BQ = C::BQ, NB = C::NB, CN = C::CN, BK = BWD_BK;
  const BwdGeom g = a.g;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* vs = ks + C::KV_BYTES;
  uint8_t* dss = vs + C::KV_BYTES;
  float4* dqs = reinterpret_cast<float4*>(dss + C::DS_BYTES);
  uint8_t* ring = dss + C::DS_BYTES + C::DQ_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + BWD_STAGES * C::STAGE_BYTES);
  uint64_t* kv_bar = full + BWD_STAGES;
  int* item_s = reinterpret_cast<int*>(kv_bar + 1);

  const int tid = threadIdx.x, wg = tid / 128, t128 = tid % 128;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < BWD_STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init(kv_bar, 1);
    mbar_fence_init();
    *item_s = atomicAdd(counters, 1);   // the ticket: see the note above
  }
  // a tile's pad rows (G not dividing BQ) are never written by TMA: zero
  if (g.rows < BQ) {
    const int per = (BQ - g.rows) * 8;          // 16-byte chunks a box
    for (int c = tid; c < BWD_STAGES * 2 * NB * per; c += BWD_THREADS) {
      const int box = c / per, e = c % per;
      uint8_t* at = ring + (box / (2 * NB)) * C::STAGE_BYTES +
                    (box % (2 * NB)) * BQ * 128 + g.rows * 128 + e * 16;
      *reinterpret_cast<uint4*>(at) = make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();
  }
  __syncthreads();

  const int2 item = bwd_item(*item_s, g.n_kt, gridDim.x / g.n_kt);
  const int bh = item.x, kt = item.y;
  const int b = bh / a.KV, kh = bh % a.KV;
  int qb, qe;
  g.walk(kt, qb, qe);
  const int n = qe - qb;

  // thread 0 issues every copy: Q, dO (TMA) and the row values (bulk) of
  // step i into stage i % BWD_STAGES, once the step that used the stage
  // before is done (after the step's last barrier below), and the dq adds
  const uint32_t tile_bytes = 2 * NB * g.rows * 128 + C::ROW_BYTES;
  auto load_step = [&](int i) {
    const int qt = qb + i, stage = i % BWD_STAGES;
    uint8_t* st = ring + stage * C::STAGE_BYTES;
    mbar_arrive_expect_tx(&full[stage], tile_bytes);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load_5d(st + nb * BQ * 128, &tq, &full[stage], 64 * nb, 0, kh,
                  qt * (BQ / g.G), b);
      tma_load_5d(st + C::Q_BYTES + nb * BQ * 128, &tdo, &full[stage],
                  64 * nb, 0, kh, qt * (BQ / g.G), b);
    }
    bulk_load(st + 2 * C::Q_BYTES,
              rowv + ((size_t)bh * g.n_qt + qt) * 3 * BQ, C::ROW_BYTES,
              &full[stage]);
  };
  if (tid == 0 && n > 0) {
    mbar_arrive_expect_tx(kv_bar, 2 * C::KV_BYTES);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load_4d(ks + nb * BK * 128, &tk, kv_bar, 64 * nb, kh, kt * BK, b);
      tma_load_4d(vs + nb * BK * 128, &tv, kv_bar, 64 * nb, kh, kt * BK, b);
    }
    for (int i = 0; i < BWD_STAGES && i < n; ++i) load_step(i);
  }

  const int lane = tid & 31, warp = t128 >> 5, c4 = lane & 3;
  const int kr = 64 * wg + 16 * warp + (lane >> 2);   // key row (and + 8)
  const int key_a = kt * BK + kr;
  float dva[HD / 2], dka[HD / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) dva[j] = dka[j] = 0.0f;
  if (n > 0) mbar_wait(kv_bar, 0);
  const uint32_t k_addr = smem_u32(ks), v_addr = smem_u32(vs);
  const uint32_t ds_addr = smem_u32(dss);
  // this warpgroup's 64 x 64 block of dQ_tile: rows of dS^T's box a_box
  // (hd 64: rows 64 wg..), columns of K's box b_box (hd 128: 64 wg..)
  const int a_box = BQ == 128 ? wg : 0, b_box = BQ == 128 ? 0 : wg;
  int phase = 0, prev_rank = -1;
  int* prev_cnt = nullptr;
  for (int i = 0; i < n; ++i) {
    const int qt = qb + i, stage = i % BWD_STAGES;
    mbar_wait(&full[stage], phase);
    if (stage == BWD_STAGES - 1) phase ^= 1;
    uint8_t* st = ring + stage * C::STAGE_BYTES;
    const uint32_t q_addr = smem_u32(st), do_addr = q_addr + C::Q_BYTES;
    const float* lse2 = reinterpret_cast<const float*>(st + 2 * C::Q_BYTES);
    const float* dsum = lse2 + BQ;
    const int* pos = reinterpret_cast<const int*>(dsum + BQ);

    // per chunk of CN rows: S^T = K Q^T, dP^T = V dO^T (K-major tiles
    // step 32 bytes a k16 step within their 128-byte rows, a box of 64
    // columns every 4 steps); P^T = exp2(S^T scale log2e - lse2) while
    // dP^T is in flight; dS^T = P^T (dP^T - D); dV += P^T dO and
    // dK += dS^T Q with P^T, dS^T as bf16 register A operands (MN-major
    // B, 16 rows of 128 bytes a k16 step, boxes BQ rows apart), left in
    // flight while the next chunk's S^T and dP^T are multiplied
    const bool edge = !g.full(qt, kt);
    uint32_t pa[CN / 16][4], da[CN / 16][4];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float s[CN / 2], dp[CN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t ko = (kk / 4) * BK * 128 + 64 * wg * 128 + (kk % 4) * 32;
        const uint32_t qo = (kk / 4) * BQ * 128 + c * CN * 128 + (kk % 4) * 32;
        mma_s(s, wgmma_desc_sw128(k_addr + ko, 16, 1024),
              wgmma_desc_sw128(q_addr + qo, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t ko = (kk / 4) * BK * 128 + 64 * wg * 128 + (kk % 4) * 32;
        const uint32_t qo = (kk / 4) * BQ * 128 + c * CN * 128 + (kk % 4) * 32;
        mma_s(dp, wgmma_desc_sw128(v_addr + ko, 16, 1024),
              wgmma_desc_sw128(do_addr + qo, 16, 1024), kk > 0);
      }
      wgmma_commit();
      // element 4 j + 2 h + e is key kr + 8 h, row c CN + 8 j + 2 c4 + e
      wgmma_wait<1>();               // S^T (and the last chunk's products)
      fence_regs(s);
      fence_regs(dva);
      fence_regs(dka);
      if (c > 0) {                   // which read these until now
        fence_frags(pa);
        fence_frags(da);
      }
      const int r0 = c * CN + 2 * c4;
#pragma unroll
      for (int j = 0; j < CN / 8; ++j) {
        const float2 l2 = lds_f2(lse2 + r0 + 8 * j);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x0 = fmaf(s[4 * j + 2 * h], a.scale_log2, -l2.x);
          float x1 = fmaf(s[4 * j + 2 * h + 1], a.scale_log2, -l2.y);
          if (edge) {
            const int2 p2 = lds_i2(pos + r0 + 8 * j);
            const int key = key_a + 8 * h;
            if (!bwd_visible(key, p2.x, g)) x0 = -INFINITY;
            if (!bwd_visible(key, p2.y, g)) x1 = -INFINITY;
          }
          s[4 * j + 2 * h] = ex2(x0);
          s[4 * j + 2 * h + 1] = ex2(x1);
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // the k16 step kk is n-chunks 2 kk and 2 kk + 1 of the accumulator,
      // so n-chunk j, half h is fragment register 2 (j % 2) + h of step
      // j / 2; dS^T also into shared memory for dQ, [key][row] in 64-row
      // boxes of BK keys of 128 bytes, 128-byte swizzle (chunk q of key
      // row r at q ^ (r & 7))
#pragma unroll
      for (int j = 0; j < CN / 8; ++j) {
        const float2 d2 = lds_f2(dsum + r0 + 8 * j);
        const int row = c * CN + 8 * j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * j + 2 * h;
          const uint32_t ds2 = pack_bf16(s[e] * (dp[e] - d2.x),
                                         s[e + 1] * (dp[e + 1] - d2.y));
          pa[j / 2][2 * (j % 2) + h] = pack_bf16(s[e], s[e + 1]);
          da[j / 2][2 * (j % 2) + h] = ds2;
          const int r = kr + 8 * h;
          *reinterpret_cast<uint32_t*>(
              dss + (row / 64) * BK * 128 + r * 128 +
              ((((row % 64) / 8) ^ (r & 7)) << 4) + c4 * 4) = ds2;
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CN / 16; ++kk)
        mma_rs(dva, pa[kk],
               wgmma_desc_sw128(do_addr + (c * CN + kk * 16) * 128, BQ * 128,
                                1024));
#pragma unroll
      for (int kk = 0; kk < CN / 16; ++kk)
        mma_rs(dka, da[kk],
               wgmma_desc_sw128(q_addr + (c * CN + kk * 16) * 128, BQ * 128,
                                1024));
      wgmma_commit();
      if (HD == 128) {               // no registers to spare at hd 128 for
        wgmma_wait<0>();             // P^T, dS^T beside the next chunk's
        fence_regs(dva);
        fence_regs(dka);
        fence_frags(pa);
        fence_frags(da);
      }
    }
    fence_proxy_async();             // dS^T, for the dQ product

    // the previous step's dq add has completed by now (a step's work
    // after it was issued): the next key tile may add after it; and the
    // staging buffer is free again
    if (tid == 0 && prev_rank >= 0) dq_release(prev_cnt, prev_rank);
    named_bar_sync(1, BWD_THREADS);  // both warpgroups' dS^T are stored

    // this warpgroup's block of dQ_tile = dS K over the block's 128 keys,
    // at hd 128 in two halves of 32 columns (registers again), each half
    // starting 64 bytes into K's 128-byte rows (the swizzle is a function
    // of the address, so a descriptor may start there as the K-major ones
    // start 32 bytes in); staged for the copy engine in the accumulator's
    // order (thread t's float4 v at v * 128 + t of the warpgroup's 16 KB)
    constexpr int DH = HD == 128 ? 2 : 1;
#pragma unroll
    for (int h2 = 0; h2 < DH; ++h2) {
      float dqa[32 / DH];
      if (h2 == 0 || HD == 128) wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_dq(dqa,
               wgmma_desc_sw128(ds_addr + a_box * BK * 128 + kk * 16 * 128,
                                BK * 128, 1024),
               wgmma_desc_sw128(k_addr + b_box * BK * 128 + 64 * h2 +
                                kk * 16 * 128, BK * 128, 1024),
               kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(dqa);
      fence_frags(pa);               // the products read them until here
      fence_frags(da);
#pragma unroll
      for (int v = 0; v < 8 / DH; ++v)
        dqs[wg * 1024 + (8 / DH * h2 + v) * 128 + t128] =
            make_float4(dqa[4 * v], dqa[4 * v + 1], dqa[4 * v + 2],
                        dqa[4 * v + 3]);
    }
    fence_proxy_async();
    // the block is staged, both dQ products have read dS^T, and the
    // stage's Q, dO and row values are read
    named_bar_sync(1, BWD_THREADS);
    if (tid == 0) {
      // dq: add into the query tile's sum in the order of key tiles
      prev_rank = dq_rank(kt, g.kt_lo(qt), g.kt_hi(qt));
      prev_cnt = counters + 1 + (size_t)bh * g.n_qt + qt;
      if (prev_rank > 0) dq_wait(prev_cnt, prev_rank);
      dq_add(dq_acc + ((size_t)bh * g.n_qt + qt) * BQ * HD, dqs,
             C::DQ_BYTES, prev_rank);
      if (i + BWD_STAGES < n) load_step(i + BWD_STAGES);
    }
  }
  if (tid == 0 && prev_rank >= 0) dq_release(prev_cnt, prev_rank);

  // dK (scaled) and dV of this block's keys
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_a + 8 * h;
    if (key >= g.T) continue;
    const size_t at = (((size_t)b * g.T + key) * a.KV + kh) * HD + 2 * c4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * j) =
          pack_bf16(dka[4 * j + 2 * h] * a.scale, dka[4 * j + 2 * h + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * j) =
          pack_bf16(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
    }
  }
}

// cuTensorMapEncodeTiled from the CUDA driver, found through the runtime (no
// link against libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiledFn)p;
  }
  return fn;
}

// a bf16 tensor of `rank` dims (dims[0] contiguous; strides in bytes of
// dims 1..), read in `box` tiles with the 128-byte swizzle; out-of-range
// elements read as zero
bool bf16_map(CUtensorMap* map, const void* ptr, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_fn();
  if (!fn) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, void* dq, void* dk,
               void* dv, float* rowv, float* acc, int* counters, int B,
               int S, int T, int KV, int G, int causal, int window,
               int q_offset, float scale, const BwdPlanC& p,
               cudaStream_t stream) {
  using C = Bwd<HD>;
  BwdArgs a;
  BwdGeom& g = a.g;
  g.S = S;
  g.T = T;
  g.G = G;
  g.causal = causal;
  g.window = window;
  g.q_offset = q_offset;
  g.n_rows = S * G;
  g.rows = (C::BQ / G) * G;
  g.bk = BWD_BK;
  g.n_qt = (g.n_rows + g.rows - 1) / g.rows;
  g.n_kt = (T + BWD_BK - 1) / BWD_BK;
  a.KV = KV;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  const long long items = (long long)B * KV * g.n_kt;
  const long long tiles = (long long)B * KV * g.n_qt;
  // the plan must be the one these formulas give (kernels/
  // flash_attention.py::plan_launch computes it; this checks the copy)
  if (G < 1 || G > C::BQ || p.bq != C::BQ || p.rows != g.rows ||
      p.bk != BWD_BK || p.stages != BWD_STAGES || p.n_qt != g.n_qt ||
      p.n_kt != g.n_kt || p.items != items || p.smem != C::SMEM ||
      p.row_floats != tiles * 3 * C::BQ ||
      p.acc_floats != tiles * C::BQ * HD || p.counter_ints != tiles + 1 ||
      p.row_blocks != (tiles * C::BQ * HD / 8 + 255) / 256 ||
      p.store_blocks != (tiles * C::BQ * HD / 4 + 255) / 256 ||
      items > 0x7fffffffLL || p.row_blocks > 0x7fffffffLL ||
      p.store_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;

  CUtensorMap tq, tdo, tk, tv;
  const cuuint64_t e = 2;   // bytes an element
  const cuuint64_t qdims[5] = {(cuuint64_t)HD, (cuuint64_t)G, (cuuint64_t)KV,
                               (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t qstr[4] = {HD * e, G * HD * e, KV * G * HD * e,
                              (cuuint64_t)S * KV * G * HD * e};
  const cuuint32_t qbox[5] = {64, (cuuint32_t)G, 1,
                              (cuuint32_t)(C::BQ / G), 1};
  const cuuint64_t kdims[4] = {(cuuint64_t)HD, (cuuint64_t)KV, (cuuint64_t)T,
                               (cuuint64_t)B};
  const cuuint64_t kstr[3] = {HD * e, KV * HD * e,
                              (cuuint64_t)T * KV * HD * e};
  const cuuint32_t kbox[4] = {64, 1, BWD_BK, 1};
  if (!bf16_map(&tq, q, 5, qdims, qstr, qbox) ||
      !bf16_map(&tdo, dout, 5, qdims, qstr, qbox) ||
      !bf16_map(&tk, k, 4, kdims, kstr, kbox) ||
      !bf16_map(&tv, v, 4, kdims, kstr, kbox))
    return (int)cudaErrorInvalidValue;

  flash_bwd_stats_kernel<HD><<<(unsigned)p.row_blocks, 256, 0, stream>>>(
      (const bf16*)o, (const bf16*)dout, lse, rowv, g, KV, tiles * C::BQ);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  static bool attr = false;
  if (!attr) {
    err = cudaFuncSetAttribute(flash_bwd_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  flash_bwd_kernel<HD><<<(unsigned)items, BWD_THREADS, C::SMEM, stream>>>(
      tq, tdo, tk, tv, rowv, acc, counters, (bf16*)dk, (bf16*)dv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_store_kernel<HD><<<(unsigned)p.store_blocks, 256, 0, stream>>>(
      (const float4*)acc, (bf16*)dq, g, KV, scale, tiles * C::BQ * HD / 4);
  return (int)cudaGetLastError();
}

}  // namespace


// dtype: 0 = float32, 1 = bfloat16.  `lse` (fp32, (B, S, KV, G)) is
// written when not null.  Returns a cudaError_t code.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int S, int T, int KV, int G, int hd,
                                   int causal, int window, int q_offset,
                                   float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (dtype == 1 && hd == 128)
    return launch_bf16<128>(q, k, v, o, l, B, S, T, KV, G, causal, window,
                            q_offset, scale, st);
  if (dtype == 1 && hd == 64)
    return launch_bf16<64>(q, k, v, o, l, B, S, T, KV, G, causal, window,
                           q_offset, scale, st);
  if (dtype == 0 && hd == 128)
    return launch_f32<128>(q, k, v, o, l, B, S, T, KV, G, causal, window,
                           q_offset, scale, st);
  if (dtype == 0 && hd == 64)
    return launch_f32<64>(q, k, v, o, l, B, S, T, KV, G, causal, window,
                          q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The backward: dq, dk, dv (shaped and typed like q, k, v) from q, k, v,
// o, lse and dout, all bf16, launched as `plan` (kernels/
// flash_attention.py::BwdPlan.c_plan, checked here against the shapes):
// `rowv` (plan row_floats fp32), `acc` (acc_floats fp32) are scratch the
// kernels overwrite, `counters` (counter_ints int32) must be zero.  Three
// kernels: the row pass, the key-major kernel, the dq pass.  Returns a
// cudaError_t code.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* lse, const void* dout,
                                   void* dq, void* dk, void* dv, void* rowv,
                                   void* acc, void* counters, int B, int S,
                                   int T, int KV, int G, int hd, int causal,
                                   int window, int q_offset, float scale,
                                   const long long* plan, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const BwdPlanC& p = *reinterpret_cast<const BwdPlanC*>(plan);
  if (hd == 64)
    return launch_bwd<64>(q, k, v, o, (const float*)lse, dout, dq, dk, dv,
                          (float*)rowv, (float*)acc, (int*)counters, B, S, T,
                          KV, G, causal, window, q_offset, scale, p, st);
  if (hd == 128)
    return launch_bwd<128>(q, k, v, o, (const float*)lse, dout, dq, dk, dv,
                           (float*)rowv, (float*)acc, (int*)counters, B, S,
                           T, KV, G, causal, window, q_offset, scale, p, st);
  return (int)cudaErrorInvalidValue;
}
