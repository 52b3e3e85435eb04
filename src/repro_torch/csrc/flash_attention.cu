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
                  const bf16* __restrict__ v, bf16* __restrict__ o, int S,
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

  const float inv_a = 1.0f / fmaxf(quad_sum(l_a), 1e-30f);
  const float inv_b = 1.0f / fmaxf(quad_sum(l_b), 1e-30f);
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
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int T_, int KV, int G, int causal, int window,
                int q_offset, float scale, cudaStream_t stream) {
  const int smem = tc_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * KV, (S * G + BR - 1) / BR);
  flash_bf16_kernel<HD><<<grid, TC_THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, S, T_, KV, G,
      causal, window, q_offset, scale * LOG2E);
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
                 const float* __restrict__ v, float* __restrict__ o, int S,
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
    float* dst = o + ((((size_t)b * S + s) * KV + h) * G + g) * HD;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) dst[j * 32 + lane] = acc[i][j] / denom;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int T_, int KV, int G, int causal, int window,
               int q_offset, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (ROWS * HD + TK * (HD + 1) + TK * HD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S * G + ROWS - 1) / ROWS, B * KV);
  flash_f32_kernel<HD><<<grid, WARPS * 32, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, T_,
      KV, G, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t code.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int T, int KV, int G, int hd, int causal,
                                   int window, int q_offset, float scale,
                                   int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1 && hd == 128)
    return launch_bf16<128>(q, k, v, o, B, S, T, KV, G, causal, window,
                            q_offset, scale, st);
  if (dtype == 1 && hd == 64)
    return launch_bf16<64>(q, k, v, o, B, S, T, KV, G, causal, window,
                           q_offset, scale, st);
  if (dtype == 0 && hd == 128)
    return launch_f32<128>(q, k, v, o, B, S, T, KV, G, causal, window,
                           q_offset, scale, st);
  if (dtype == 0 && hd == 64)
    return launch_f32<64>(q, k, v, o, B, S, T, KV, G, causal, window,
                          q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}
