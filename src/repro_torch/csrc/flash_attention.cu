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
// the score rows: one block owns 32 consecutive (s, g) rows of one
// (batch, kv head) pair, so a K/V tile loaded once serves every query
// head of the group.  Unlike the TPU kernel it needs no transposes, takes
// ragged S and T, and skips key tiles that are masked for every row of
// the block.  Key tiles are visited in ascending order, and a masked
// entry contributes p = 0 explicitly, so no row ever sums a masked
// entry.  Rows with no valid key at all (which the model path never
// produces) come out 0, where the plain version averages v.
//
// What bounds it on an H100: at the path's prefill shapes (S a few
// hundred, hd 128, G 3) the work is 4*S*T/2*hd*H operations over a
// few MB of q/k/v, so operations bound it in principle.  This first
// version computes the scores and the p @ v product on CUDA cores in
// fp32 (one lane per key for the scores, one lane per output column for
// p @ v), far from the tensor-core rate; a wgmma version is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 32;      // (s, g) rows per block
constexpr int TK = 32;        // keys per tile: one per lane
constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = ROWS / WARPS;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

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

template <typename T, int HD>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int T_,
                 int KV, int G, int causal, int window, int q_offset,
                 float scale) {
  constexpr int PER_LANE = HD / 32;     // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;                     // (ROWS, HD)
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

  // q rows of this block, flattened (s, g); row i sits at
  // (((b*S + s)*KV + h)*G + g)*HD
  for (int e = tid; e < ROWS * HD; e += WARPS * 32) {
    const int r = e / HD, d = e % HD;
    const int i = row0 + r;
    float val = 0.0f;
    if (i < n_rows) {
      const int s = i / G, g = i % G;
      val = to_f(q[((((size_t)b * S + s) * KV + h) * G + g) * HD + d]);
    }
    qs[e] = val;
  }

  // the key range any row of the block can see
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
        kv_k = to_f(k[off]);
        kv_v = to_f(v[off]);
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
      const float* qr = qs + r * HD;
      const float* kr = ks + lane * (HD + 1);
      float sc = 0.0f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) sc = fmaf(qr[d], kr[d], sc);
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
    T* dst = o + ((((size_t)b * S + s) * KV + h) * G + g) * HD;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      dst[j * 32 + lane] = from_f<T>(acc[i][j] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int T_, int KV, int G, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (ROWS * HD + TK * (HD + 1) + TK * HD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S * G + ROWS - 1) / ROWS, B * KV);
  flash_fwd_kernel<T, HD><<<grid, WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, T_, KV, G, causal,
      window, q_offset, scale);
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
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, S, T, KV, G, causal,
                                      window, q_offset, scale, st);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, S, T, KV, G, causal,
                                     window, q_offset, scale, st);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, o, B, S, T, KV, G, causal, window,
                              q_offset, scale, st);
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, o, B, S, T, KV, G, causal, window,
                             q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}
