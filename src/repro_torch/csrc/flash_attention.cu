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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
// row logsumexp `lse` (natural log, fp32, (B, S, KV, G)) and dO, in three
// kernels and no atomics, so a repeated backward is bit-identical:
//   1. D = rowsum(dO * o) in fp32, one warp a row;
//   2. dq: a block owns 64 (s, g) rows of one (batch, kv head), as in the
//      forward, and walks the key tiles: P = exp(q.k^T * scale - lse)
//      recomputed (0 where masked), dP = dO.v^T, dS = P * (dP - D),
//      dq += dS.k, scaled once at the end;
//   3. dk, dv: a block owns 64 keys of one (batch, kv head) and walks the
//      query rows that can see them, all G heads of the group as rows, so
//      the sum over the group is the walk itself: dv += P^T.dO,
//      dk += dS^T.q.
// What bounds it at the training shape ((8, 4096, 16, 1, 64), causal):
// 10 hd S(S+1)/2 operations a (batch, head), 0.687 TFLOP in all, 0.695 ms
// at 989 TFLOP/s, against 539 MB (q, o, dO, dq, k, v, dk, dv, lse once
// each), 0.161 ms: the tensor cores.  The TPU kernel has no backward (the
// JAX package trains through its jnp twin).  This first design recomputes
// P in both kernels (5 products where a fused kernel does 4) and walks
// one tile at a time, double-buffering only its copies.
// bf16: mma.sync m16n8k16 with fp32 accumulators, dS and P rounded to
// bf16 as the A operands of the second products (the forward rounds P
// the same way).  bf16 only: training on the card is bf16, and the
// wrapper refuses float32.

__global__ void flash_bwd_dot_kernel(const bf16* __restrict__ o,
                                     const bf16* __restrict__ dout,
                                     float* __restrict__ dsum,
                                     long long rows, int hd) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  float acc = 0.0f;
  for (int d = lane; d < hd; d += 32) {
    acc = fmaf(__bfloat162float(o[row * hd + d]),
               __bfloat162float(dout[row * hd + d]), acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) dsum[row] = acc;
}

// whether query row i (position q_offset + i / G) sees key `key`
__device__ __forceinline__ bool visible(int key, int i, int T_, int n_rows,
                                        int G, int causal, int window,
                                        int q_offset) {
  const int qp = q_offset + i / G;
  return key < T_ && i < n_rows && (!causal || key <= qp) &&
         (window <= 0 || qp - key < window);
}

// `nr` (s, g) rows from row0 of q or dO into a bf16 tile, rows padded to
// HD + 8; rows past the end are zero
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int b,
                                          int S, int KV, int G, int h,
                                          int row0, int n_rows, int nr,
                                          int tid) {
  constexpr int LD = HD + 8, CH = HD / 8;
  for (int c = tid; c < nr * CH; c += TC_THREADS) {
    const int r = c / CH, cc = c % CH;
    const int i = row0 + r;
    const bf16* p = src;
    int bytes = 0;
    if (i < n_rows) {
      p = src + ((((size_t)b * S + i / G) * KV + h) * G + i % G) * HD + cc * 8;
      bytes = 16;
    }
    hopper::cp_async16(dst + r * LD + cc * 8, p, bytes);
  }
}

// BC keys from kb of k or v into a padded tile; keys past T are zero
template <int HD>
__device__ __forceinline__ void load_keys(bf16* dst, const bf16* src, int b,
                                          int T_, int KV, int h, int kb,
                                          int tid) {
  constexpr int LD = HD + 8, CH = HD / 8;
  for (int c = tid; c < BC * CH; c += TC_THREADS) {
    const int r = c / CH, cc = c % CH;
    const int key = kb + r;
    size_t off = 0;
    int bytes = 0;
    if (key < T_) {
      off = (((size_t)b * T_ + key) * KV + h) * HD + cc * 8;
      bytes = 16;
    }
    hopper::cp_async16(dst + r * LD + cc * 8, src + off, bytes);
  }
}

// c[NT][4] (NT tiles of 16 x 8) += A . B^T: A the 16 rows at `a`, B the
// 8 NT rows at `bm`, both row-major and padded, hd deep: the score-like
// products q.k^T, dO.v^T, k.q^T and v.dO^T
template <int HD, int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const bf16* a,
                                        const bf16* bm, int lane) {
  using namespace hopper;
  constexpr int LD = HD + 8;
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int d = 0; d < HD / 16; ++d) {
    uint32_t af[4];
    ldmatrix_x4(af, a + (r + 8 * (mi & 1)) * LD + d * 16 + 8 * (mi >> 1));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bb[4];
      ldmatrix_x4(bb, bm + (np * 16 + r + 8 * (mi >> 1)) * LD + d * 16 +
                          8 * (mi & 1));
      mma_bf16(c[2 * np], af, bb[0], bb[1]);
      mma_bf16(c[2 * np + 1], af, bb[2], bb[3]);
    }
  }
}

// acc[HD/8][4] += P . V: P 16 x 8 NT in the accumulator layout, rounded
// to bf16 as the A operand; V the 8 NT rows at `vm` (row-major, padded)
template <int HD, int NT>
__device__ __forceinline__ void mma_pv(float (&acc)[HD / 8][4],
                                       const float (&p)[NT][4],
                                       const bf16* vm, int lane) {
  using namespace hopper;
  constexpr int LD = HD + 8;
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int dn = 0; dn < HD / 16; ++dn) {
      uint32_t bb[4];
      ldmatrix_x4_trans(bb, vm + (kk * 16 + r + 8 * (mi & 1)) * LD + dn * 16 +
                                8 * (mi >> 1));
      mma_bf16(acc[2 * dn], pa, bb[0], bb[1]);
      mma_bf16(acc[2 * dn + 1], pa, bb[2], bb[3]);
    }
  }
}

// one row's saved value (lse or D) of the (B, S, KV, G) row layout
__device__ __forceinline__ float row_value(const float* t, int b, int S,
                                           int KV, int G, int h, int i,
                                           int n_rows, float fill) {
  return i < n_rows ? t[((size_t)b * S + i / G) * KV * G + h * G + i % G]
                    : fill;
}

template <int HD>
constexpr int dq_smem_bytes() {
  return 6 * BR * (HD + 8) * 2;   // q, dO, 2 x k, 2 x v
}

template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    const bf16* __restrict__ dout, bf16* __restrict__ dq,
                    int S, int T_, int KV, int G, int causal, int window,
                    int q_offset, float scale, float scale_log2) {
  using namespace hopper;
  constexpr int LD = HD + 8;
  constexpr int TILE = BR * LD;
  extern __shared__ __align__(16) bf16 smem[];
  bf16* qs = smem;
  bf16* dos = qs + TILE;
  bf16* ks = dos + TILE;           // [2][BC][LD]
  bf16* vs = ks + 2 * TILE;        // [2][BC][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / KV, h = blockIdx.x % KV;
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

  load_rows<HD>(qs, q, b, S, KV, G, h, row0, n_rows, BR, tid);
  load_rows<HD>(dos, dout, b, S, KV, G, h, row0, n_rows, BR, tid);
  cp_async_commit();
  if (n_kt > 0) {
    load_keys<HD>(ks, k, b, T_, KV, h, kb0, tid);
    load_keys<HD>(vs, v, b, T_, KV, h, kb0, tid);
  }
  cp_async_commit();

  const int qr = lane >> 2, qc = lane & 3;
  const int ra = row0 + warp * 16 + qr, rb = ra + 8;
  const float lse_a = row_value(lse, b, S, KV, G, h, ra, n_rows, 0.0f) * LOG2E;
  const float lse_b = row_value(lse, b, S, KV, G, h, rb, n_rows, 0.0f) * LOG2E;
  const float d_a = row_value(dsum, b, S, KV, G, h, ra, n_rows, 0.0f);
  const float d_b = row_value(dsum, b, S, KV, G, h, rb, n_rows, 0.0f);

  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) {
      load_keys<HD>(ks + (buf ^ 1) * TILE, k, b, T_, KV, h,
                    kb0 + (kt + 1) * BC, tid);
      load_keys<HD>(vs + (buf ^ 1) * TILE, v, b, T_, KV, h,
                    kb0 + (kt + 1) * BC, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kst = ks + buf * TILE;
    const bf16* vst = vs + buf * TILE;
    const int kb = kb0 + kt * BC;

    float p[BC / 8][4], dp[BC / 8][4];
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
      p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.0f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
    }
    mma_abt<HD, BC / 8>(p, qs + warp * 16 * LD, kst, lane);    // q k^T
    mma_abt<HD, BC / 8>(dp, dos + warp * 16 * LD, vst, lane);  // dO v^T
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + 8 * j + 2 * qc + (e & 1);
        const int i = e < 2 ? ra : rb;
        const float pe =
            visible(key, i, T_, n_rows, G, causal, window, q_offset)
                ? exp2f(p[j][e] * scale_log2 - (e < 2 ? lse_a : lse_b))
                : 0.0f;
        p[j][e] = pe * (dp[j][e] - (e < 2 ? d_a : d_b));   // dS
      }
    }
    mma_pv<HD, BC / 8>(acc, p, kst, lane);                     // dS k
    __syncthreads();   // this buffer is refilled two tiles on
  }

  if (ra < n_rows) {
    bf16* dst = dq + ((((size_t)b * S + ra / G) * KV + h) * G + ra % G) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * qc) =
          pack_bf16(acc[j][0] * scale, acc[j][1] * scale);
  }
  if (rb < n_rows) {
    bf16* dst = dq + ((((size_t)b * S + rb / G) * KV + h) * G + rb % G) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * qc) =
          pack_bf16(acc[j][2] * scale, acc[j][3] * scale);
  }
}

// query rows a step of the dk/dv walk: fewer at hd 128, where the dk and
// dv accumulators take 128 registers a thread
template <int HD>
struct Dkv {
  static constexpr int BQ = HD == 64 ? 64 : 32;
  // k, v, 2 x q, 2 x dO (bf16, padded); 2 x lse, 2 x D (fp32)
  static constexpr int SMEM = (2 * BC + 4 * BQ) * (HD + 8) * 2 + 4 * BQ * 4;
};

template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum,
                      const bf16* __restrict__ dout, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int S, int T_, int KV, int G,
                      int causal, int window, int q_offset, float scale,
                      float scale_log2) {
  using namespace hopper;
  constexpr int LD = HD + 8;
  constexpr int BQ = Dkv<HD>::BQ;
  constexpr int QT = BQ * LD;
  extern __shared__ __align__(16) bf16 smem[];
  bf16* ks = smem;
  bf16* vs = ks + BC * LD;
  bf16* qs = vs + BC * LD;         // [2][BQ][LD]
  bf16* dos = qs + 2 * QT;         // [2][BQ][LD]
  float* ls = reinterpret_cast<float*>(dos + 2 * QT);   // [2][BQ] lse*log2e
  float* dsm = ls + 2 * BQ;                             // [2][BQ] D

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / KV, h = blockIdx.x % KV;
  const int n_rows = S * G;
  // causal: the first key tiles are seen by the most rows, and go first
  const int kb = blockIdx.y * BC;
  const int k_last = min(T_, kb + BC) - 1;
  // the query positions that see some key of this tile
  const int s_lo = causal ? min(S, max(0, kb - q_offset)) : 0;
  const int s_hi =
      window > 0 ? min(S, max(0, k_last + window - q_offset)) : S;
  const int r_begin = (s_lo * G / BQ) * BQ;
  const int r_end = s_hi * G;
  const int n_qt = r_end > r_begin ? (r_end - r_begin + BQ - 1) / BQ : 0;

  load_keys<HD>(ks, k, b, T_, KV, h, kb, tid);
  load_keys<HD>(vs, v, b, T_, KV, h, kb, tid);
  auto load_q = [&](int qt, int buf) {
    const int r0 = r_begin + qt * BQ;
    load_rows<HD>(qs + buf * QT, q, b, S, KV, G, h, r0, n_rows, BQ, tid);
    load_rows<HD>(dos + buf * QT, dout, b, S, KV, G, h, r0, n_rows, BQ, tid);
    for (int r = tid; r < BQ; r += TC_THREADS) {
      ls[buf * BQ + r] =
          row_value(lse, b, S, KV, G, h, r0 + r, n_rows, INFINITY) * LOG2E;
      dsm[buf * BQ + r] =
          row_value(dsum, b, S, KV, G, h, r0 + r, n_rows, 0.0f);
    }
  };
  if (n_qt > 0) load_q(0, 0);
  cp_async_commit();

  const int qr = lane >> 2, qc = lane & 3;
  const int key_a = kb + warp * 16 + qr, key_b = key_a + 8;
  float acc_k[HD / 8][4], acc_v[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    acc_k[j][0] = acc_k[j][1] = acc_k[j][2] = acc_k[j][3] = 0.0f;
    acc_v[j][0] = acc_v[j][1] = acc_v[j][2] = acc_v[j][3] = 0.0f;
  }

  for (int qt = 0; qt < n_qt; ++qt) {
    const int buf = qt & 1;
    __syncthreads();   // the other buffer's last readers are done
    if (qt + 1 < n_qt) load_q(qt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // this tile's copies and plain stores have landed
    const bf16* qst = qs + buf * QT;
    const bf16* dost = dos + buf * QT;
    const float* lst = ls + buf * BQ;
    const float* dtile = dsm + buf * BQ;
    const int r0 = r_begin + qt * BQ;

    float p[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.0f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
    }
    mma_abt<HD, BQ / 8>(p, ks + warp * 16 * LD, qst, lane);    // k q^T
    mma_abt<HD, BQ / 8>(dp, vs + warp * 16 * LD, dost, lane);  // v dO^T
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * qc + (e & 1);
        const int key = e < 2 ? key_a : key_b;
        p[j][e] = visible(key, r0 + col, T_, n_rows, G, causal, window,
                          q_offset)
                      ? exp2f(p[j][e] * scale_log2 - lst[col])
                      : 0.0f;
        dp[j][e] = p[j][e] * (dp[j][e] - dtile[col]);   // dS^T
      }
    }
    mma_pv<HD, BQ / 8>(acc_v, p, dost, lane);   // dv += P^T dO
    mma_pv<HD, BQ / 8>(acc_k, dp, qst, lane);   // dk += dS^T q
  }

  if (key_a < T_) {
    const size_t at = (((size_t)b * T_ + key_a) * KV + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * j + 2 * qc) =
          pack_bf16(acc_k[j][0] * scale, acc_k[j][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * j + 2 * qc) =
          pack_bf16(acc_v[j][0], acc_v[j][1]);
    }
  }
  if (key_b < T_) {
    const size_t at = (((size_t)b * T_ + key_b) * KV + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * j + 2 * qc) =
          pack_bf16(acc_k[j][2] * scale, acc_k[j][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * j + 2 * qc) =
          pack_bf16(acc_v[j][2], acc_v[j][3]);
    }
  }
}

template <int HD>
int launch_bwd_bf16(const void* q, const void* k, const void* v,
                    const float* lse, const float* dsum, const void* dout,
                    void* dq, void* dk, void* dv, int B, int S, int T_,
                    int KV, int G, int causal, int window, int q_offset,
                    float scale, cudaStream_t stream) {
  const int s1 = dq_smem_bytes<HD>(), s2 = Dkv<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s2);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<HD>
      <<<dim3(B * KV, (S * G + BR - 1) / BR), TC_THREADS, s1, stream>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, lse, dsum,
          (const bf16*)dout, (bf16*)dq, S, T_, KV, G, causal, window,
          q_offset, scale, scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<HD>
      <<<dim3(B * KV, (T_ + BC - 1) / BC), TC_THREADS, s2, stream>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, lse, dsum,
          (const bf16*)dout, (bf16*)dk, (bf16*)dv, S, T_, KV, G, causal,
          window, q_offset, scale, scale * LOG2E);
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
// o, lse and dout, all bf16; `dsum` is fp32 scratch of B*S*KV*G floats
// (D).  Three kernels.  Returns a cudaError_t code.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* lse, const void* dout,
                                   void* dq, void* dk, void* dv, void* dsum,
                                   int B, int S, int T, int KV, int G, int hd,
                                   int causal, int window, int q_offset,
                                   float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)B * S * KV * G;
  const int blocks = (int)((rows + 7) / 8);
  if (hd != 64 && hd != 128)
    return (int)cudaErrorInvalidValue;
  flash_bwd_dot_kernel<<<blocks, 256, 0, st>>>(
      (const bf16*)o, (const bf16*)dout, (float*)dsum, rows, hd);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* l = (const float*)lse;
  const float* d = (const float*)dsum;
  if (hd == 128)
    return launch_bwd_bf16<128>(q, k, v, l, d, dout, dq, dk, dv, B, S, T, KV,
                                G, causal, window, q_offset, scale, st);
  return launch_bwd_bf16<64>(q, k, v, l, d, dout, dq, dk, dv, B, S, T, KV, G,
                             causal, window, q_offset, scale, st);
}
