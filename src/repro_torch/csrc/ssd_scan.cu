// ssd_scan: the Mamba2 SSD chunk scan (state-space duality) for Hopper
// (sm_90a), in the chunk-parallel form, every product on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (`_kernel`), and computes the JAX model path's
// models/ssm.py::ssd_chunk_scan: fp32 y and the final fp32 state.
//
//   dA = dt * (-exp(a_log)),  csum = cumsum of dA within a chunk
//   y_i = sum_{j<=i} exp(csum_i - csum_j) (c_i . b_j) dt_j x_j      (intra)
//       + exp(csum_i) (c_i . S_prev)                                (carried)
//   S   = S_prev exp(csum_last) + sum_j b_j (x) exp(csum_last - csum_j) dt_j x_j
//
// Layouts: x (B,S,nh,hd) bf16|f32 with batch/sequence strides given (heads
// and head dim dense), dt (B,S,nh) f32 dense, a_log (nh,) f32, b/c (B,S,ns)
// like x with their own strides, init (B,nh,hd,ns) f32 or null;
// y (B,S,nh,hd) f32 dense, fin (B,nh,hd,ns) f32 dense.  Ragged S: the last
// chunk is shorter, and with S < chunk the chunk is S.  Rows past the end
// read dt = 0 and x = b = c = 0, so csum stays flat there (csum_last is the
// csum of the last real row) and they add nothing, as the reference's
// padding does.  Every exponent has the form csum_i - csum_j with j <= i,
// csum_last - csum_j or csum_i, all <= 0; the causal mask is applied before
// the exp.
//
// Bound on an H100 at the serve path's shapes, (1, 512, 80, 64) with ns 128
// and chunk 256: about 19 MB must move (bf16 x, b, c; fp32 dt, y and the
// final state) against about 2 GFLOP, so bytes bound it at about 5.6 us
// (0.0448 ms at batch 8, 0.0039 ms at (1, 333)).  The workspace (chunk
// states, c b^T tiles, csum and dt, the carried states) is not counted.
//
// Passes (three kernels a call; the TPU grid walks the chunks in order with
// the state in VMEM, here only the small state recurrence is sequential):
//  1. ssd_scan_states_kernel, grid (nh + CB tiles, chunks, B), 256 threads.
//     A block (b, chunk, head) gathers the chunk's dt, and one thread adds
//     dt A row by row: the fp32 cumsum of the plain version on the card,
//     bit for bit, so exp(csum_i - csum_j) of the two sides agree (a
//     parallel scan put f32 inputs at 9e-5 of the 1e-4 tolerance).  It
//     writes csum and dt to the workspace, then S_loc = (x w)^T b with
//     w_j = exp(csum_last - csum_j) dt_j, an (hd x ns) product over the
//     chunk's 64-row tiles, three tiles of b and raw x in flight by
//     cp.async.  The other blocks compute c b^T once for each (b, chunk,
//     64 x 64 tile pair I >= J), for all heads, into an fp32 workspace
//     (B, chunks, Qp, Qp).  160 + 20 blocks at (1, 512).
//  2. ssd_scan_pass_kernel, grid (hd ns / 1024, nh, B): walks the chunks in
//     order from init (or 0): S_prev[c] = S, S = S exp(csum_last[c]) +
//     S_loc[c], in fp32, float4 a thread; S_prev is written as the bf16
//     terms pass 3 multiplies with, and the last S to fin.  640 blocks.
//  3. ssd_scan_chunk_kernel, grid (row tiles x head groups, chunks, B):
//     4 warps (16 rows each) per head of a group of hg heads.  The carried
//     term C_I S_prev^T scaled by exp(csum_i); then for each column tile
//     J <= I the c b^T tile (read once for the group) becomes
//     G = mask * exp(csum_i - csum_j) * CB * dt_j in registers, already in
//     the A-fragment layout, and y += G x_J, while tile J + 1 is copied
//     by cp.async.  Left of the diagonal the decay is exp(csum_i -
//     csum_r) exp(csum_r - csum_j), r the tile's last row (both <= 1),
//     its column half made once per tile and head.  Longest row tiles
//     first.  hg 2 (320 blocks at (1, 512), two a SM) was the fastest in
//     a sweep on the card, ahead of hg 1, hg 4 and of two warp groups
//     walking one head's column tiles.
//
// Precision.  The tensor cores take bf16, and rounding the fp32 operands to
// bf16 once misses the 1e-3 tolerance (4.8e-3 of 1 + |y| at (1, 512, 8,
// 64), CPU emulation); TF32 once gives 8.3e-4.  So every fp32 factor is
// folded into one side of its product and that side is cut into bf16
// terms hi = bf16(v), lo = bf16(v - hi), summed in fp32: x, b and c arrive
// in bf16 on the model path and are exact, so each product is two mmas
// (emulated error 1.0e-5: G x, (x w)^T b, C S_prev^T; c b^T is one exact
// mma).  With f32 inputs every operand is three bf16 terms (24 bits, an
// f32 exactly) and the term pairs whose indices sum to at most 2 are
// summed: six mmas a product, emulated error 1.5e-6 at (1, 512, 80, 64)
// against 1e-4 (two terms a side gave 6e-5).  `ref.ssd_scan_split_ref` is
// this arithmetic in plain PyTorch.  mma.sync m16n8k16 throughout; bf16
// input tiles with 16-byte aligned rows are cp.async copies, other layouts
// (hymba's 50-wide heads) and f32 go through registers.
//
// Launch plan: grids, threads, shared memory, workspace layout and head
// group come from the wrapper (kernels/ssd_scan.py::plan_launch, their one
// owner); the entry checks them against the kernels' limits and the
// workspace it is given.  Deterministic: no atomics; every sum runs in a
// fixed order.  Built with -DSSD_TRACE (tools/ssd_scan_phases.py), thread 0
// of each block of passes 1 and 3 stamps %globaltimer at its phase
// boundaries; without it the stamps are empty.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

#ifdef SSD_TRACE
__device__ unsigned long long g_ssd_trace[2][1 << 18];   // [pass][block][32]
#define SSD_STAMP(K, P)                                                    \
  do {                                                                     \
    if (threadIdx.x == 0) {                                                \
      const unsigned bl_ =                                                 \
          blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);  \
      unsigned long long t_;                                               \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));               \
      if (bl_ < 8192 && (P) < 32) g_ssd_trace[K][bl_ * 32 + (P)] = t_;     \
    }                                                                      \
  } while (0)
// a stamp after the whole block has reached it
#define SSD_STAMP_ALL(K, P) \
  do {                      \
    __syncthreads();        \
    SSD_STAMP(K, P);        \
  } while (0)
// The backward's chunk-term kernels (K: 0, 1, 2) add up, a block, the
// time of thread 0 between laps into a category S: 0 start, 1 end, 2
// waiting for tiles, 3 products, 4 stores, 5 work items; 8192 blocks x 8
__device__ unsigned long long g_ssd_btrace[3][8192 * 8];
__device__ __forceinline__ unsigned long long ssd_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned long long* ssd_bslot(int k, int s) {
  const unsigned bl = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *
                                                blockIdx.z);
  return bl < 8192 ? &g_ssd_btrace[k][bl * 8 + s] : nullptr;
}
#define SSD_BT_BEGIN(K, TID, t)                                 \
  unsigned long long t = ssd_now();                             \
  if (threadIdx.x == (TID) && ssd_bslot(K, 0)) *ssd_bslot(K, 0) = t
#define SSD_BT_LAP(K, TID, S, t)                                \
  do {                                                          \
    if (threadIdx.x == (TID)) {                                 \
      const unsigned long long n_ = ssd_now();                  \
      if (ssd_bslot(K, S)) *ssd_bslot(K, S) += n_ - t;          \
      if (ssd_bslot(K, 1)) *ssd_bslot(K, 1) = n_;               \
      t = n_;                                                   \
    }                                                           \
  } while (0)
#define SSD_BT_COUNT(K, TID)                                    \
  do {                                                          \
    if (threadIdx.x == (TID) && ssd_bslot(K, 5)) ++*ssd_bslot(K, 5); \
  } while (0)
#else
#define SSD_STAMP(K, P) \
  do {                  \
  } while (0)
#define SSD_STAMP_ALL(K, P) SSD_STAMP(K, P)
#define SSD_BT_BEGIN(K, TID, t) \
  do {                          \
  } while (0)
#define SSD_BT_LAP(K, TID, S, t) \
  do {                           \
  } while (0)
#define SSD_BT_COUNT(K, TID) \
  do {                       \
  } while (0)
#endif

namespace {

using bf16 = __nv_bfloat16;
using hopper::ldmatrix_x4;
using hopper::ldmatrix_x4_trans;
using hopper::mma_bf16;

constexpr int T = 64;          // rows of a tile: chunk rows, state rows
constexpr int NT1 = 256;       // threads of the states / CB blocks
constexpr int NT2 = 256;       // threads of the state pass
constexpr int LDX = 8;         // row padding of bf16 tiles (16 bytes)
constexpr int LDCB = T + 8;    // row of the fp32 CB tile
constexpr int MAX_HD = 128;
constexpr int MAX_NS = 128;
constexpr int MAX_Q = 1024;
constexpr int MAX_SMEM = 232448;
constexpr int MAX_GROUP = 2;   // heads a chunk-scan block
constexpr int STAGES = 3;      // tiles in flight in pass 1

// bf16 terms of an input (x, b, c) and of a derived fp32 factor (x w, G,
// S_prev), and the highest term-index sum a product keeps
template <typename Tin>
struct Prec {
  static constexpr int NI = 1, ND = 2, ORD = 1;
  static constexpr bool EXACT = true;     // an input tile is a copy
};
template <>
struct Prec<float> {
  static constexpr int NI = 3, ND = 3, ORD = 2;
  static constexpr bool EXACT = false;
};

// chunk-parallel shapes: Q rows a chunk, nc chunks, Q padded to the tile,
// head dim and state padded to 16
struct Dims {
  int Q, nc, QP, ntq, HDP, NSP;
  __host__ __device__ Dims(int S, int hd, int ns, int chunk) {
    Q = chunk < S ? chunk : S;
    nc = (S + Q - 1) / Q;
    QP = (Q + T - 1) / T * T;
    ntq = QP / T;
    HDP = (hd + 15) / 16 * 16;
    NSP = (ns + 15) / 16 * 16;
  }
};

struct Args {
  const void* x;
  const float* dt;
  const float* a_log;
  const void* b;
  const void* c;
  const float* init;
  float* y;
  float* fin;
  float* ws_state;   // (B, nc, nh, hd, ns): S_loc
  float* ws_cb;      // (B, nc, QP, QP): c b^T of each chunk
  float* ws_cs;      // (B, nc, nh, QP): csum of each chunk, flat past its end
  float* ws_dt;      // (B, nc, nh, QP): dt of each chunk, 0 past its end
  bf16* ws_sp;       // (B, nc, nh, ND, hd, NSP): S_prev as ND bf16 terms
  int B, S, nh, hd, ns, chunk, hg;
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
  int vec_x, vec_b, vec_c, vec_init;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// (v0, v1) as N packed bf16 pairs: term t holds bf16 of what terms < t
// left over (v0 in the low half, as the mma fragments want it)
template <int N>
__device__ __forceinline__ void split2(float v0, float v1,
                                       uint32_t (&out)[N]) {
#pragma unroll
  for (int t = 0; t < N; ++t) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    out[t] = *reinterpret_cast<const uint32_t*>(&h);
    v0 -= __low2float(h);
    v1 -= __high2float(h);
  }
}

// d += sum over term pairs (i, j), i + j <= ORD, of a_i b_j (smallest first)
template <int NA, int NB, int ORD>
__device__ __forceinline__ void mma_terms(float (&d)[4],
                                          const uint32_t (&a)[NA][4],
                                          const uint32_t (&b)[NB][2]) {
#pragma unroll
  for (int i = NA - 1; i >= 0; --i)
#pragma unroll
    for (int j = NB - 1; j >= 0; --j)
      if (i + j <= ORD) mma_bf16(d, a[i], b[j][0], b[j][1]);
}

// Rows [0, rows) x columns [0, cols) of a row-major source (element (r, k)
// at src[r * rs + k]; rows >= nrow and columns >= ncol read as 0), each
// value times scale[r] when scale is given, cut into N bf16 terms: term t
// goes to dst + t * plane + r * ld + k.  cols and ld are multiples of 8;
// `vec` says 16-byte loads are aligned.  All `nthr` threads take part, each
// issuing the loads of 4 chunks of 8 before it stores any.
template <typename Src, int N>
__device__ __forceinline__ void load_planes(bf16* dst, int plane, int ld,
                                            const Src* src, long long rs,
                                            int rows, int cols, int nrow,
                                            int ncol, bool vec,
                                            const float* scale, int tid,
                                            int nthr) {
  constexpr int U = 4;
  const int c8 = cols / 8, total = rows * c8;
  for (int e0 = tid; e0 < total; e0 += U * nthr) {
    float v[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * nthr;
      const int r = e / c8, k0 = (e - r * c8) * 8;
      const bool in = e < total && r < nrow;
      if (in && vec && k0 + 8 <= ncol) {
        load8(src + r * rs + k0, v[u]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[u][i] = (in && k0 + i < ncol) ? to_f(src[r * rs + k0 + i]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * nthr;
      if (e >= total) continue;
      const int r = e / c8, k0 = (e - r * c8) * 8;
      if (scale != nullptr) {
        const float s = scale[r];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[u][i] *= s;
      }
      uint32_t pk[4][N];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split2<N>(v[u][2 * i], v[u][2 * i + 1], pk[i]);
#pragma unroll
      for (int t = 0; t < N; ++t)
        *reinterpret_cast<uint4*>(dst + t * plane + r * ld + k0) =
            make_uint4(pk[0][t], pk[1][t], pk[2][t], pk[3][t]);
    }
  }
}

// ldmatrix row address of lane `lane` for an A fragment (16 x 16 at
// (m0, k0)) or a pair of B fragments (k16 x n16 at (k0, n0)):
//   a_mk: A stored [m][k];  a_km: A stored [k][m] (trans);
//   b_nk: B stored [n][k];  b_kn: B stored [k][n] (trans).
__device__ __forceinline__ int a_mk(int lane, int m0, int k0, int ld) {
  const int mat = lane >> 3, r = lane & 7;
  return (m0 + r + ((mat & 1) << 3)) * ld + k0 + ((mat & 2) << 2);
}
__device__ __forceinline__ int a_km(int lane, int m0, int k0, int ld) {
  const int mat = lane >> 3, r = lane & 7;
  return (k0 + r + ((mat & 2) << 2)) * ld + m0 + ((mat & 1) << 3);
}
__device__ __forceinline__ int b_nk(int lane, int k0, int n0, int ld) {
  const int mat = lane >> 3, r = lane & 7;
  return (n0 + r + ((mat & 2) << 2)) * ld + k0 + ((mat & 1) << 3);
}
__device__ __forceinline__ int b_kn(int lane, int k0, int n0, int ld) {
  const int mat = lane >> 3, r = lane & 7;
  return (k0 + r + ((mat & 1) << 3)) * ld + n0 + ((mat & 2) << 2);
}

template <int N>
__device__ __forceinline__ void ld_a(uint32_t (&f)[N][4], const bf16* base,
                                     int plane, int off, bool trans) {
#pragma unroll
  for (int t = 0; t < N; ++t) {
    if (trans)
      ldmatrix_x4_trans(f[t], base + t * plane + off);
    else
      ldmatrix_x4(f[t], base + t * plane + off);
  }
}
// two B fragments (n8 tiles n0 and n0 + 8) of N terms each
template <int N>
__device__ __forceinline__ void ld_b(uint32_t (&f0)[N][2],
                                     uint32_t (&f1)[N][2], const bf16* base,
                                     int plane, int off, bool trans) {
#pragma unroll
  for (int t = 0; t < N; ++t) {
    uint32_t r[4];
    if (trans)
      ldmatrix_x4_trans(r, base + t * plane + off);
    else
      ldmatrix_x4(r, base + t * plane + off);
    f0[t][0] = r[0];
    f0[t][1] = r[1];
    f1[t][0] = r[2];
    f1[t][1] = r[3];
  }
}

// cp.async copy of rows [0, rows) x columns [0, cols) of a row-major
// source (row stride rs) to dst (row stride ld); rows >= nrow and columns
// >= ncol are zero-filled.  Rows start 16-byte aligned on both sides, cols
// fills whole 16-byte chunks.  Not waited for here.
template <typename E>
__device__ __forceinline__ void copy_async(E* dst, int ld, const E* src,
                                           long long rs, int rows, int cols,
                                           int nrow, int ncol, int tid,
                                           int nthr) {
  constexpr int V = 16 / sizeof(E);
  const int cv = cols / V;
  for (int e = tid; e < rows * cv; e += nthr) {
    const int r = e / cv, k0 = (e - r * cv) * V;
    const int left = r < nrow ? ncol - k0 : 0;
    const int bytes =
        left <= 0 ? 0 : (left >= V ? 16 : left * (int)sizeof(E));
    hopper::cp_async16(dst + r * ld + k0,
                       bytes ? static_cast<const void*>(src + r * rs + k0)
                             : static_cast<const void*>(src),
                       bytes);
  }
}

// An input tile (x, b or c rows) as the NI bf16 planes the products read:
// bf16 with 16-byte aligned rows is a copy (cp.async, waited for by the
// caller); other layouts and f32 inputs go through registers.
template <typename Tin>
__device__ __forceinline__ void fill_input(bf16* dst, int plane, int ld,
                                           const Tin* src, long long rs,
                                           int rows, int cols, int nrow,
                                           int ncol, bool vec, int tid,
                                           int nthr) {
  if constexpr (Prec<Tin>::EXACT) {
    if (vec) {
      copy_async<bf16>(dst, ld, reinterpret_cast<const bf16*>(src), rs, rows,
                       cols, nrow, ncol, tid, nthr);
      return;
    }
  }
  load_planes<Tin, Prec<Tin>::NI>(dst, plane, ld, src, rs, rows, cols, nrow,
                                  ncol, vec, nullptr, tid, nthr);
}

// --- pass 1: chunk states and c b^T ----------------------------------------

// CB tile (I, J) of chunk c: C_I B_J^T over the state, 8 warps of 16 rows
// x 32 columns.
template <typename Tin>
__device__ __forceinline__ void cb_tile(const Args& a, const Dims& d,
                                        int tile, int c, int bi, int n,
                                        char* smem) {
  constexpr int NI = Prec<Tin>::NI, ORD = Prec<Tin>::ORD;
  int I = 0;
  while ((I + 1) * (I + 2) / 2 <= tile) ++I;
  const int J = tile - I * (I + 1) / 2;
  if (I * T >= n) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ld = d.NSP + LDX, plane = T * ld;
  bf16* cs = reinterpret_cast<bf16*>(smem);
  bf16* bs = cs + NI * plane;
  const long long s0 = (long long)c * d.Q;
  const Tin* C = static_cast<const Tin*>(a.c) + bi * a.c_sb +
                 (s0 + I * T) * a.c_ss;
  const Tin* Bm = static_cast<const Tin*>(a.b) + bi * a.b_sb +
                  (s0 + J * T) * a.b_ss;
  fill_input<Tin>(cs, plane, ld, C, a.c_ss, T, d.NSP, n - I * T, a.ns,
                  a.vec_c, tid, NT1);
  fill_input<Tin>(bs, plane, ld, Bm, a.b_ss, T, d.NSP, n - J * T, a.ns,
                  a.vec_b, tid, NT1);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();
  const int r = warp & 3, hc = warp >> 2;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < d.NSP; k0 += 16) {
    uint32_t af[NI][4];
    ld_a<NI>(af, cs, plane, a_mk(lane, 16 * r, k0, ld), false);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b0[NI][2], b1[NI][2];
      ld_b<NI>(b0, b1, bs, plane, b_nk(lane, k0, 32 * hc + 16 * np, ld),
               false);
      mma_terms<NI, NI, ORD>(acc[2 * np], af, b0);
      mma_terms<NI, NI, ORD>(acc[2 * np + 1], af, b1);
    }
  }
  const int g = lane >> 2, q = lane & 3;
  float* out = a.ws_cb + (((long long)bi * d.nc + c) * d.QP + I * T) * d.QP +
               J * T;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int col = 32 * hc + 8 * t + 2 * q;
    const int row = 16 * r + g;
    *reinterpret_cast<float2*>(out + (long long)row * d.QP + col) =
        make_float2(acc[t][0], acc[t][1]);
    *reinterpret_cast<float2*>(out + (long long)(row + 8) * d.QP + col) =
        make_float2(acc[t][2], acc[t][3]);
  }
}

// UPW: (16-row x 64-column) units of the state a warp owns, 1 or 2
template <typename Tin, int UPW>
__global__ void __launch_bounds__(NT1) ssd_scan_states_kernel(const Args a) {
  constexpr int NI = Prec<Tin>::NI, ND = Prec<Tin>::ND, ORD = Prec<Tin>::ORD;
  constexpr bool EX = Prec<Tin>::EXACT;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Dims d(a.S, a.hd, a.ns, a.chunk);
  const int c = blockIdx.y, bi = blockIdx.z;
  if (c >= d.nc || bi >= a.B) return;
  const long long s0 = (long long)c * d.Q;
  const int n = (int)(a.S - s0 < d.Q ? a.S - s0 : d.Q);
  if ((int)blockIdx.x >= a.nh) {
    cb_tile<Tin>(a, d, blockIdx.x - a.nh, c, bi, n, smem);
    return;
  }
  const int h = blockIdx.x;
  SSD_STAMP(0, 0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ldx = d.HDP + LDX, px = T * ldx;
  const int ldb = d.NSP + LDX, pb = T * ldb;
  float* cs = reinterpret_cast<float*>(smem);           // [QP]
  float* wv = cs + d.QP;                                // [QP] dt, then w
  bf16* xs = reinterpret_cast<bf16*>(wv + d.QP);        // ND x [T][ldx]
  bf16* bs = xs + ND * px;                        // STAGES x NI x [T][ldb]
  bf16* xr = bs + STAGES * NI * pb;               // STAGES x [T][ldx] (bf16)
  const Tin* X = static_cast<const Tin*>(a.x) + bi * a.x_sb + s0 * a.x_ss +
                 (long long)h * a.hd;
  const Tin* Bm = static_cast<const Tin*>(a.b) + bi * a.b_sb + s0 * a.b_ss;
  const float* DT = a.dt + ((long long)bi * a.S + s0) * a.nh + h;
  const int ntile = (n + T - 1) / T;

  for (int j = tid; j < d.QP; j += NT1)
    hopper::cp_async4(wv + j, j < n ? DT + (long long)j * a.nh : DT,
                      j < n ? 4 : 0);
  hopper::cp_async_commit();
  // b rows of tile t (and raw x rows, for bf16 inputs) into buffer
  // t % STAGES; one copy group a call, empty past the last tile
  auto issue = [&](int t) {
    const int j0 = t * T, buf = t % STAGES;
    if (t < ntile) {
      fill_input<Tin>(bs + buf * NI * pb, pb, ldb, Bm + j0 * a.b_ss, a.b_ss,
                      T, d.NSP, n - j0, a.ns, a.vec_b, tid, NT1);
      if constexpr (EX)
        fill_input<Tin>(xr + buf * px, px, ldx, X + j0 * a.x_ss, a.x_ss, T,
                        d.HDP, n - j0, a.hd, a.vec_x, tid, NT1);
    }
    hopper::cp_async_commit();
  };
  for (int t = 0; t < STAGES - 1; ++t) issue(t);
  hopper::cp_async_wait<STAGES - 1>();      // dt
  __syncthreads();
  SSD_STAMP(0, 1);
  if (tid == 0) {
    // in sequence, as the reference's cumsum adds: the same csum bit for
    // bit, so exp(csum_i - csum_j) carries no rounding of its own
    const float A = -expf(a.a_log[h]);
    float v = 0.f;
    for (int j0 = 0; j0 < n; j0 += 16) {
      float dd[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) dd[u] = wv[j0 + u];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        v = __fadd_rn(v, __fmul_rn(dd[u], A));
        cs[j0 + u] = v;
      }
    }
  }
  __syncthreads();
  const float last = cs[n - 1];
  const long long hq = (((long long)bi * d.nc + c) * a.nh + h) * d.QP;
  for (int j = tid; j < d.QP; j += NT1) {
    const float v = j < n ? cs[j] : last, dj = wv[j];
    a.ws_cs[hq + j] = v;
    a.ws_dt[hq + j] = dj;
    wv[j] = expf(last - v) * dj;
  }
  SSD_STAMP_ALL(0, 2);

  // units: 16 state rows (head dim) x 64 state columns
  const int mslabs = d.HDP / 16;
  const int units = mslabs * ((d.NSP + 63) / 64);
  float acc[UPW][8][4] = {};
  for (int t = 0; t < ntile; ++t) {
    const int j0 = t * T, buf = t % STAGES;
    hopper::cp_async_wait<STAGES - 2>();    // tile t is in
    __syncthreads();           // and every thread is done with tile t - 1
    SSD_STAMP(0, 3 + 2 * t);
    issue(t + STAGES - 1);
    if constexpr (EX) {
      // x w as two bf16 terms, from the raw tile
      const bf16* raw = xr + buf * px;
      const int c8 = d.HDP / 8;
      for (int e = tid; e < T * c8; e += NT1) {
        const int r = e / c8, k0 = (e - r * c8) * 8;
        float v[8];
        load8(raw + r * ldx + k0, v);
        const float w = wv[j0 + r];
        uint32_t pk[4][ND];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split2<ND>(v[2 * i] * w, v[2 * i + 1] * w, pk[i]);
#pragma unroll
        for (int u = 0; u < ND; ++u)
          *reinterpret_cast<uint4*>(xs + u * px + r * ldx + k0) =
              make_uint4(pk[0][u], pk[1][u], pk[2][u], pk[3][u]);
      }
    } else {
      load_planes<Tin, ND>(xs, px, ldx, X + j0 * a.x_ss, a.x_ss, T, d.HDP,
                           n - j0, a.hd, a.vec_x, wv + j0, tid, NT1);
    }
    __syncthreads();
    const bf16* bt = bs + buf * NI * pb;
    SSD_STAMP(0, 4 + 2 * t);
#pragma unroll
    for (int ui = 0; ui < UPW; ++ui) {
      const int u = warp + 8 * ui;
      if (u >= units) continue;
      const int ms = u % mslabs, ng = u / mslabs;
      const int np_n = (d.NSP - 64 * ng < 64 ? d.NSP - 64 * ng : 64) / 16;
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) {
        uint32_t af[ND][4];
        ld_a<ND>(af, xs, px, a_km(lane, 16 * ms, 16 * kk, ldx), true);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np >= np_n) continue;
          uint32_t b0[NI][2], b1[NI][2];
          ld_b<NI>(b0, b1, bt, pb,
                   b_kn(lane, 16 * kk, 64 * ng + 16 * np, ldb), true);
          mma_terms<ND, NI, ORD>(acc[ui][2 * np], af, b0);
          mma_terms<ND, NI, ORD>(acc[ui][2 * np + 1], af, b1);
        }
      }
    }
  }

  SSD_STAMP_ALL(0, 20);
  const int g = lane >> 2, q = lane & 3;
  float* out = a.ws_state +
               (((long long)bi * d.nc + c) * a.nh + h) * a.hd * a.ns;
#pragma unroll
  for (int ui = 0; ui < UPW; ++ui) {
    const int u = warp + 8 * ui;
    if (u >= units) continue;
    const int ms = u % mslabs, ng = u / mslabs;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int k = 64 * ng + 8 * t + 2 * q;
      if (k >= a.ns) continue;       // ns % 4 == 0: k + 1 < ns too
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int p = 16 * ms + g + 8 * hr;
        if (p < a.hd)
          *reinterpret_cast<float2*>(out + (long long)p * a.ns + k) =
              make_float2(acc[ui][t][2 * hr], acc[ui][t][2 * hr + 1]);
      }
    }
  }
}

// --- pass 2: the state recurrence across chunks ----------------------------

template <typename Tin>
__global__ void __launch_bounds__(NT2) ssd_scan_pass_kernel(const Args a) {
  constexpr int ND = Prec<Tin>::ND;
  const Dims d(a.S, a.hd, a.ns, a.chunk);
  const int h = blockIdx.y, bi = blockIdx.z;
  const int hdns = a.hd * a.ns;
  const int e = 4 * (blockIdx.x * NT2 + threadIdx.x);
  if (e >= hdns || h >= a.nh || bi >= a.B) return;
  const int p = e / a.ns, k = e - p * a.ns;    // ns % 4 == 0: one row
  const long long head = (long long)bi * a.nh + h;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (a.init != nullptr) {
    const float* ip = a.init + head * hdns + e;
    if (a.vec_init) {
      s = *reinterpret_cast<const float4*>(ip);
    } else {
      s = make_float4(ip[0], ip[1], ip[2], ip[3]);
    }
  }
  auto at = [&](int c) { return ((long long)bi * d.nc + c) * a.nh + h; };
  // chunk c + 1's inputs are loaded before chunk c's planes are stored
  float4 loc = *reinterpret_cast<const float4*>(a.ws_state + at(0) * hdns + e);
  float last = a.ws_cs[at(0) * d.QP + d.QP - 1];
  for (int c = 0; c < d.nc; ++c) {
    float4 nloc = loc;
    float nlast = last;
    if (c + 1 < d.nc) {
      nloc = *reinterpret_cast<const float4*>(a.ws_state + at(c + 1) * hdns +
                                              e);
      nlast = a.ws_cs[at(c + 1) * d.QP + d.QP - 1];
    }
    uint32_t lo[ND], hi[ND];
    split2<ND>(s.x, s.y, lo);
    split2<ND>(s.z, s.w, hi);
    bf16* sp = a.ws_sp + (at(c) * ND * a.hd + p) * d.NSP + k;
#pragma unroll
    for (int t = 0; t < ND; ++t)
      *reinterpret_cast<uint2*>(sp + (long long)t * a.hd * d.NSP) =
          make_uint2(lo[t], hi[t]);
    const float dec = expf(last);
    s.x = fmaf(s.x, dec, loc.x);
    s.y = fmaf(s.y, dec, loc.y);
    s.z = fmaf(s.z, dec, loc.z);
    s.w = fmaf(s.w, dec, loc.w);
    loc = nloc;
    last = nlast;
  }
  *reinterpret_cast<float4*>(a.fin + head * hdns + e) = s;
}

// --- pass 3: y of each 64-row tile ------------------------------------------

// bytes of one column-tile buffer: a CB tile and the x planes of each head
template <int HDP>
__device__ __forceinline__ int chunk_jbuf(int hg, int ni) {
  return 4 * T * LDCB + 2 * hg * ni * T * (HDP + LDX);
}

// the serve path's instance (bf16, head tile 64) keeps two blocks an SM
template <typename Tin, int HDP>
__global__ void __launch_bounds__(128 * MAX_GROUP,
                                  Prec<Tin>::EXACT && HDP == 64 ? 2 : 1)
    ssd_scan_chunk_kernel(const Args a) {
  constexpr int NI = Prec<Tin>::NI, ND = Prec<Tin>::ND, ORD = Prec<Tin>::ORD;
  constexpr int NTP = HDP / 8;             // n8 tiles over the head dim
  extern __shared__ float4 smem4[];
  const Dims d(a.S, a.hd, a.ns, a.chunk);
  const int HG = a.hg, groups = (a.nh + HG - 1) / HG;
  const int I = d.ntq - 1 - (int)blockIdx.x / groups;   // longest first
  const int hg0 = ((int)blockIdx.x % groups) * HG;
  const int c = blockIdx.y, bi = blockIdx.z;
  const long long s0 = (long long)c * d.Q;
  const int n = (int)(a.S - s0 < d.Q ? a.S - s0 : d.Q);
  if (c >= d.nc || bi >= a.B || I < 0 || I * T >= n)
    return;                                // past a ragged chunk's end
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthr = 128 * HG;
  const int hw = warp >> 2, r = warp & 3, h = hg0 + hw;
  const bool live = h < a.nh;
  const int rows = (I + 1) * T;
  const bool has_prev = c > 0 || a.init != nullptr;
  const int nlive = a.nh - hg0 < HG ? a.nh - hg0 : HG;
  SSD_STAMP(1, 0);

  float* cs = reinterpret_cast<float*>(smem4);          // [HG][QP]
  float* dv = cs + HG * d.QP;                           // [HG][QP]
  float* bcol = dv + HG * d.QP;                         // [2][HG][T]
  const int ldc = d.NSP + LDX, pc = T * ldc;
  bf16* cpl = reinterpret_cast<bf16*>(bcol + 2 * HG * T);  // NI x [T][ldc]
  char* U = reinterpret_cast<char*>(cpl + NI * pc);
  // state phase: ND planes [HDP][ldc] of S_prev for each head
  bf16* spl = reinterpret_cast<bf16*>(U);
  const int ps = HDP * ldc;
  // column-tile phase: 2 buffers of a CB tile [T][LDCB] and NI x [T][ldx]
  // planes of x for each head
  const int ldx = HDP + LDX, px = T * ldx;
  const int jbuf = chunk_jbuf<HDP>(HG, NI);

  const long long hq = (((long long)bi * d.nc + c) * a.nh + hg0) * d.QP;
  for (int k = 0; k < nlive; ++k) {
    copy_async<float>(cs + k * d.QP, 0, a.ws_cs + hq + k * d.QP, 0, 1, rows,
                      1, rows, tid, nthr);
    copy_async<float>(dv + k * d.QP, 0, a.ws_dt + hq + k * d.QP, 0, 1, rows,
                      1, rows, tid, nthr);
  }
  const Tin* C = static_cast<const Tin*>(a.c) + bi * a.c_sb +
                 (s0 + I * T) * a.c_ss;
  fill_input<Tin>(cpl, pc, ldc, C, a.c_ss, T, d.NSP, n - I * T, a.ns,
                  a.vec_c, tid, nthr);
  if (has_prev) {
    const bf16* src = a.ws_sp + (((long long)bi * d.nc + c) * a.nh + hg0) *
                                    ND * a.hd * d.NSP;
    for (int k = 0; k < nlive * ND; ++k)
      copy_async<bf16>(spl + k * ps, ldc, src + (long long)k * a.hd * d.NSP,
                       d.NSP, HDP, d.NSP, a.hd, a.ns, tid, nthr);
  }
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();
  SSD_STAMP(1, 1);

  const int g = lane >> 2, q = lane & 3;
  const float* csh = cs + hw * d.QP;
  const float* dvh = dv + hw * d.QP;
  const int i0 = I * T + 16 * r + g;       // chunk rows i0 and i0 + 8
  float acc[NTP][4] = {};
  if (has_prev && live) {
    // C_I S_prev^T, S_prev in ND bf16 terms
    const bf16* sh = spl + hw * ND * ps;
    for (int k0 = 0; k0 < d.NSP; k0 += 16) {
      uint32_t af[NI][4];
      ld_a<NI>(af, cpl, pc, a_mk(lane, 16 * r, k0, ldc), false);
#pragma unroll
      for (int np = 0; np < NTP / 2; ++np) {
        uint32_t b0[ND][2], b1[ND][2];
        ld_b<ND>(b0, b1, sh, ps, b_nk(lane, k0, 16 * np, ldc), false);
        mma_terms<NI, ND, ORD>(acc[2 * np], af, b0);
        mma_terms<NI, ND, ORD>(acc[2 * np + 1], af, b1);
      }
    }
    const float e0 = expf(csh[i0]), e1 = expf(csh[i0 + 8]);
#pragma unroll
    for (int t = 0; t < NTP; ++t) {
      acc[t][0] *= e0;
      acc[t][1] *= e0;
      acc[t][2] *= e1;
      acc[t][3] *= e1;
    }
  }
  __syncthreads();                         // U is reused below
  SSD_STAMP(1, 2);

  const float* cbrow = a.ws_cb +
                       (((long long)bi * d.nc + c) * d.QP + I * T) * d.QP;
  const Tin* X = static_cast<const Tin*>(a.x) + bi * a.x_sb + s0 * a.x_ss;
  auto issue = [&](int J) {
    float* cbt = reinterpret_cast<float*>(U + (J & 1) * jbuf);
    bf16* xpl = reinterpret_cast<bf16*>(cbt + T * LDCB);
    copy_async<float>(cbt, LDCB, cbrow + J * T, d.QP, T, T, T, T, tid, nthr);
    for (int k = 0; k < nlive; ++k)
      fill_input<Tin>(xpl + k * NI * px, px, ldx,
                      X + J * T * a.x_ss + (long long)(hg0 + k) * a.hd,
                      a.x_ss, T, HDP, n - J * T, a.hd, a.vec_x, tid, nthr);
    hopper::cp_async_commit();
  };
  // Left of the diagonal (J < I) every j < i, and with r the last row of
  // tile J, exp(csum_i - csum_j) = exp(csum_i - csum_r) exp(csum_r -
  // csum_j), both factors <= 1: the column factor, times dt_j, is made
  // once per tile and head into bcol[J & 1]
  auto columns = [&](int J) {
    const int rr = J * T + T - 1;
    for (int e = tid; e < nlive * T; e += nthr) {
      const int k = e / T, j = J * T + (e - k * T);
      bcol[((J & 1) * HG + k) * T + (j - J * T)] =
          __expf(cs[k * d.QP + rr] - cs[k * d.QP + j]) * dv[k * d.QP + j];
    }
  };
  issue(0);
  if (I > 0) columns(0);
  for (int J = 0; J <= I; ++J) {
    hopper::cp_async_wait<0>();            // tile J is in
    __syncthreads();           // and every thread is done with tile J - 1
    SSD_STAMP(1, 3 + 2 * J);
    if (J < I) issue(J + 1);
    SSD_STAMP(1, 4 + 2 * J);
    if (J + 1 < I) columns(J + 1);
    if (live) {
      const float* cbt = reinterpret_cast<const float*>(U + (J & 1) * jbuf);
      const bf16* xh = reinterpret_cast<const bf16*>(cbt + T * LDCB) +
                       hw * NI * px;
      const float c0 = csh[i0], c1 = csh[i0 + 8];
      const float* cb0 = cbt + (16 * r + g) * LDCB;
      const float* cb1 = cb0 + 8 * LDCB;
      const float* bj = bcol + ((J & 1) * HG + hw) * T;
      const float cr = csh[J * T + T - 1];
      const float a0 = J < I ? __expf(c0 - cr) : 0.f;
      const float a1 = J < I ? __expf(c1 - cr) : 0.f;
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) {
        // G at rows (i0, i0 + 8) x tile columns jl, jl + 1, jl + 8, jl + 9
        const int jl = 16 * kk + 2 * q, jg = J * T + jl;
        float gv[2][4];
        if (J < I) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int dj = (cc & 1) + 8 * (cc >> 1);
            const float b = bj[jl + dj];
            gv[0][cc] = a0 * (b * cb0[jl + dj]);
            gv[1][cc] = a1 * (b * cb1[jl + dj]);
          }
        } else {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int dj = (cc & 1) + 8 * (cc >> 1);
            const int j = jg + dj;
            const float csj = csh[j], dtj = dvh[j];
            gv[0][cc] =
                j <= i0 ? __expf(c0 - csj) * cb0[jl + dj] * dtj : 0.f;
            gv[1][cc] =
                j <= i0 + 8 ? __expf(c1 - csj) * cb1[jl + dj] * dtj : 0.f;
          }
        }
        uint32_t af[ND][4], t0[ND], t1[ND], t2[ND], t3[ND];
        split2<ND>(gv[0][0], gv[0][1], t0);
        split2<ND>(gv[1][0], gv[1][1], t1);
        split2<ND>(gv[0][2], gv[0][3], t2);
        split2<ND>(gv[1][2], gv[1][3], t3);
#pragma unroll
        for (int t = 0; t < ND; ++t) {
          af[t][0] = t0[t];
          af[t][1] = t1[t];
          af[t][2] = t2[t];
          af[t][3] = t3[t];
        }
#pragma unroll
        for (int np = 0; np < NTP / 2; ++np) {
          uint32_t b0[NI][2], b1[NI][2];
          ld_b<NI>(b0, b1, xh, px, b_kn(lane, 16 * kk, 16 * np, ldx), true);
          mma_terms<ND, NI, ORD>(acc[2 * np], af, b0);
          mma_terms<ND, NI, ORD>(acc[2 * np + 1], af, b1);
        }
      }
    }
  }
  SSD_STAMP_ALL(1, 30);
  if (!live) return;

  float* Y = a.y + (((long long)bi * a.S + s0) * a.nh + h) * a.hd;
  const long long ys = (long long)a.nh * a.hd;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = i0 + 8 * hr;
    if (i >= n) continue;
    float* yrow = Y + i * ys;
#pragma unroll
    for (int t = 0; t < NTP; ++t) {
      const int p = 8 * t + 2 * q;
      if (p >= a.hd) continue;
      if ((a.hd & 1) == 0) {
        *reinterpret_cast<float2*>(yrow + p) =
            make_float2(acc[t][2 * hr], acc[t][2 * hr + 1]);
      } else {
        yrow[p] = acc[t][2 * hr];
        if (p + 1 < a.hd) yrow[p + 1] = acc[t][2 * hr + 1];
      }
    }
  }
}

// --- launch --------------------------------------------------------------------

// The launch plan as kernels/ssd_scan.py::plan_launch gives it (SsdPlan.c_plan):
// 22 int64 in this order.
struct Plan {
  long long grid[3][3];   // (x, y, z) of the states, pass and chunk kernels
  long long threads[3];
  long long smem[3];      // dynamic shared memory a block, bytes
  long long ws[5];        // floats: states, CB, csum, dt, S_prev planes
  long long hg;           // heads a chunk-scan block
  long long hd_tile;      // head tile of the chunk scan: 64 or 128
};
static_assert(sizeof(Plan) == 22 * sizeof(long long), "plan layout");

// the shape within the kernels' limits, and the plan within the card's and
// the kernels' limits and the workspace given (it is not recomputed here)
inline bool valid(const Args& a, const Plan& p, const void* ws,
                  long long ws_bytes) {
  if (a.B < 1 || a.S < 1 || a.nh < 1 || a.hd < 1 || a.hd > MAX_HD ||
      a.ns < 4 || a.ns > MAX_NS || a.ns % 4 != 0 || a.chunk < 1 ||
      Dims(a.S, a.hd, a.ns, a.chunk).Q > MAX_Q)
    return false;
  if (p.hg < 1 || p.hg > MAX_GROUP || p.threads[0] != NT1 ||
      p.threads[1] != NT2 || p.threads[2] != 128 * p.hg ||
      (p.hd_tile != 64 && p.hd_tile != 128) || a.hd > p.hd_tile)
    return false;
  for (int k = 0; k < 3; ++k) {
    if (p.smem[k] < 0 || p.smem[k] > MAX_SMEM || p.grid[k][0] < 1 ||
        p.grid[k][0] > 0x7fffffff)
      return false;
    for (int i = 1; i < 3; ++i)
      if (p.grid[k][i] < 1 || p.grid[k][i] > 65535) return false;
  }
  long long need = 0;
  for (long long f : p.ws) {
    if (f < 0 || f % 4 != 0) return false;    // regions stay 16-byte aligned
    need += 4 * f;
  }
  return ws != nullptr && (uintptr_t)ws % 16 == 0 && need <= ws_bytes;
}

inline dim3 grid_of(const Plan& p, int k) {
  return dim3((unsigned)p.grid[k][0], (unsigned)p.grid[k][1],
              (unsigned)p.grid[k][2]);
}

template <typename Tin, int UPW>
int launch_states(const Args& a, const Plan& p, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_states_kernel<Tin, UPW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem[0]);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_states_kernel<Tin, UPW>
      <<<grid_of(p, 0), NT1, (int)p.smem[0], st>>>(a);
  return (int)cudaGetLastError();
}

template <typename Tin, int HDP>
int launch_chunk(const Args& a, const Plan& p, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_chunk_kernel<Tin, HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem[2]);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_chunk_kernel<Tin, HDP>
      <<<grid_of(p, 2), (int)p.threads[2], (int)p.smem[2], st>>>(a);
  return (int)cudaGetLastError();
}

template <typename Tin>
int launch(Args a, const Plan& p, void* ws, long long ws_bytes,
           cudaStream_t st) {
  if (!valid(a, p, ws, ws_bytes)) return (int)cudaErrorInvalidValue;
  a.hg = (int)p.hg;
  a.ws_state = static_cast<float*>(ws);
  a.ws_cb = a.ws_state + p.ws[0];
  a.ws_cs = a.ws_cb + p.ws[1];
  a.ws_dt = a.ws_cs + p.ws[2];
  a.ws_sp = reinterpret_cast<bf16*>(a.ws_dt + p.ws[3]);
  const int E = (int)sizeof(Tin);
  auto al = [](const void* ptr) { return (uintptr_t)ptr % 16 == 0; };
  a.vec_x = al(a.x) && (a.x_sb * E) % 16 == 0 && (a.x_ss * E) % 16 == 0 &&
            (a.hd * E) % 16 == 0;
  a.vec_b = al(a.b) && (a.b_sb * E) % 16 == 0 && (a.b_ss * E) % 16 == 0;
  a.vec_c = al(a.c) && (a.c_sb * E) % 16 == 0 && (a.c_ss * E) % 16 == 0;
  a.vec_init = a.init != nullptr && al(a.init);
  // state units (16 x 64) of pass 1 over its 8 warps: one or two a warp
  const Dims d(a.S, a.hd, a.ns, a.chunk);
  const bool two = (d.HDP / 16) * ((d.NSP + 63) / 64) > 8;

  int rc = two ? launch_states<Tin, 2>(a, p, st)
               : launch_states<Tin, 1>(a, p, st);
  if (rc != 0) return rc;
  ssd_scan_pass_kernel<Tin><<<grid_of(p, 1), NT2, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return p.hd_tile == 64 ? launch_chunk<Tin, 64>(a, p, st)
                         : launch_chunk<Tin, 128>(a, p, st);
}

// --- the backward ------------------------------------------------------------
//
// ssd_scan_bwd: the gradient of the scan for the cotangents dy (fp32, like
// y) and d_final_state (or 0) -> dx, ddt, da_log, db, dc.  The Pallas kernel
// has no VJP (the JAX package differentiates its jnp twin,
// models/ssm.py::ssd_chunk_scan); this computes that gradient in the
// chunk-parallel form of ref.ssd_scan_bwd_ref.  With xd = dt x,
// L_ij = exp(csum_i - csum_j) (i >= j), w_j = exp(last - csum_j),
// e_i = exp(csum_i), P the chunk's carried state and D the cotangent of the
// state leaving the chunk:
//   dS_prev[c] = sum_i e_i dy_i (x) c_i + exp(last_c) D[c],  D[c] = dS_prev[c+1]
//   dxd_j = sum_{i>=j} CB_ij L_ij dy_i + w_j D b_j
//   dCB_ij = (dy_i . xd_j) L_ij, and G = dCB summed over the heads:
//   dc = G b + sum_h e dy P,  db = G^T c + sum_h w xd D
//   dcsum_i = sum_j Z_ij - sum_j Z_ji + dy_i . y_inter_i - w_i xd_i . D b_i,
//     Z = dCB_h * CB, plus dlast = sum_j w_j xd_j . D b_j + exp(last) <D, P>
//     at the chunk's last row; dA = reverse cumsum of dcsum,
//   ddt = a dA + dxd . x,  dx = dt dxd,  da_log = a sum dA dt.
// b and c are shared by the heads, so the products of G with them are
// formed once per (batch, chunk, tile pair), not once per head.
//
// Passes (eight kernels a call in stream order; f32 inputs add one first
// that cuts x, b and c into their bf16 terms in the workspace):
//  F1, F2. the forward's passes 1 and 2 recompute csum, dt, c b^T and the
//     carried states (as bf16 terms) into the forward's workspace layout:
//     recomputed, not saved by the forward, so the training path keeps no
//     workspace between its forward and its backward.
//  B1. ssd_bwd_dstate_kernel, grid (nh, chunks, B), 4 warps: dS_y = sum_i
//     e_i dy_i (x) c_i of each (b, chunk, head), over the chunk's 64-row
//     tiles, into the chunk-state workspace (the chunk states are dead
//     after F2).
//  B2. ssd_bwd_pass_kernel, grid (hd ns / 1024, nh, B), a float4 of the
//     state a thread, as the forward's pass 2: walks the chunks backwards
//     from d_final_state: D[c] = g (written over dS_y[c]), g = dS_y[c] +
//     exp(last_c) g, in fp32; exp(last_c) <D[c], P[c]> as one partial sum a
//     block, summed by B4 in a fixed order.
//  B3a. ssd_bwd_cols_kernel, persistent (one block an SM), items (batch,
//     chunk, head group, column tile J): for each head of the group the
//     state terms u = b_J D^T (dxd = w u, the w xd . D b terms) and
//     db += (x dt w)_J D, then for each row tile I >= J S1^T = x_J dy_I^T,
//     dCB^T = S1^T dt L^T, the Z sums, dxd += (CB L)^T dy_I and G^T_IJ +=
//     dCB^T (fp32 in shared memory, each thread its own elements); it
//     writes dx, dxd . x (into ddt) and its rows' dcsum terms per head, and
//     at the item's end db += G^T_IJ c_I and G^T_IJ to the workspace.
//  B3b. ssd_bwd_rows_kernel, persistent, items (batch, chunk, row tile I):
//     for each head q = e dy_I P, dy . y_inter = c . q into the rows' dcsum
//     terms, dc += q; then dc += G_IJ b_J for J <= I (G summed over the
//     groups in order), and db summed over the groups when there are several.
//  B4. ssd_bwd_finish_kernel, a thread a (b, chunk, head): dlast, the reverse
//     cumsum over the chunk's rows, ddt += a dA, and sum dA dt.
//  B5. ssd_bwd_da_kernel, a thread a head: da_log = a sum over (b, chunk).
//
// B3a and B3b are the Hopper design: one producer warp issues every tile a
// block reads, as TMA tiles (x, b, c and the carried state's planes in the
// 128-byte swizzle wgmma reads; dy and c b^T fp32, swizzled) and bulk
// copies (D, csum, dt), into a ring of four 16 KB slots (and, for x, csum
// and dt, head stages) that complete on mbarriers; one consumer warpgroup
// waits for each tile, cuts the fp32 operands into bf16 terms in shared
// memory, and runs every 64-row product on wgmma: S1 and u SS (both
// operands from shared memory), the products whose A operand is formed in
// registers (dxd's (CB L)^T, db's x dt w and G^T, dc's e dy and G) RS.  The
// next head's and tile's copies are in flight behind the products.  Items
// are walked in a static order, in rounds of one item a block, every other
// round reversed, so the column items' 4 + s, 3 + s, 2 + s, 1 + s steps
// pair up; at batch 1 the heads are cut into groups (plan_bwd's
// `groups`) so that the items fill the card.  Sums over heads run in head
// order in registers or in a thread's own shared-memory elements, over
// groups and tiles in a fixed order: no atomics.
//
// Precision: the forward's bf16-term scheme.  An fp32 operand (dy, D, P and
// the products' factors) is cut into N bf16 terms (2 with bf16 inputs, 3
// with f32 inputs), an input operand (x, b, c) into Prec<Tin>::NI (1: exact
// bf16; 3 for f32), and the term pairs whose indices sum to at most N - 1
// are accumulated in fp32 (one more wgmma each into the same accumulator).
// The backward takes head dim <= 64 (one 64-wide tile), state <= 128 (one
// 128-wide tile) and chunk <= 256 (four row tiles: G^T of an item's tile
// pairs fits in shared memory).
//
// Bound on an H100 at the training shape (8, 4096, 80, 64), state 128,
// chunk 256: the inputs (bf16 x, b, c; fp32 dt, dy) and outputs (bf16 dx,
// db, dc; fp32 ddt) are about 1.40 GB, 0.42 ms at 3.35 TB/s; the least
// products (the chunk-parallel form, causal halves not counted) about
// 0.35 TFLOP, 0.35 ms at 989 TFLOP/s.  B3a's bf16-term products are about
// 0.6 TFLOP and its distinct reads about 1.3 GB.

constexpr int NTB = 128;        // threads of the dstate blocks
constexpr int NTP2 = 256;       // threads of the backward state pass
constexpr int BWD_HD = 64;      // head dims the backward takes (one tile)
constexpr int BWD_NS = 128;     // state columns (one tile, zero-padded)
constexpr int BWD_NTQ = 4;      // row tiles a chunk (chunk <= 256)
constexpr int NCW = 128;        // consumer threads of B3a / B3b
constexpr int NTK = NCW + 32;   // and the producer warp
constexpr int RING = 4;         // ring slots
constexpr int SLOT = 16384;     // a slot's tile: 64 x 64 fp32, 64 x 128 bf16
constexpr int SIDE = 1024;      // a slot's side vector (B3b: e of the rows)
constexpr int SLOT_STRIDE = SLOT + SIDE;
constexpr int GSLOT = 4096;     // floats of one G^T tile (64 x 64)

// bf16 terms of an fp32 operand (dy, D, P and the products' factors) and
// the highest term-index sum kept; an input operand takes Prec<Tin>::NI
template <typename Tin>
struct BPrec {
  static constexpr int N = 2, ORD = 1;
};
template <>
struct BPrec<float> {
  static constexpr int N = 3, ORD = 2;
};

struct BArgs {
  Args f;            // the forward's arguments (F1 and F2, the workspace)
  const float* dy;   // (B, S, nh, hd) f32 dense
  const float* dfin; // (B, nh, hd, ns) f32 dense or null
  void* dx;          // (B, S, nh, hd) like x, dense
  float* ddt;        // (B, S, nh)
  float* da_log;     // (nh,)
  void* db;          // (B, S, ns) like b, dense
  void* dc;
  float* ws_g;       // (B, nc, pairs, groups, 64, 64): G^T of a tile pair
  float* ws_dcs;     // (B, nc, nh, QP): each row's dcsum terms
  float* ws_zr;      // (B, nc, nh, off-diagonal pairs, 64): Z's row sums
  float* ws_dlj;     // (B, nc, nh, ntq): sum_j w_j xd_j . D b_j of tile J
  float* ws_dlr;     // (B, nc, nh, pass_parts): parts of exp(last) <D, P>
  float* ws_dda;     // (B, nc, nh): sum dA dt of the chunk
  float* ws_dbp;     // (B, nc, ntq, groups, 64, 128): db of a group
                     // (several groups, or f32 inputs)
  bf16* ws_pl;       // f32 inputs: x, b, c as NI bf16 planes
  int groups, hpg, hstages;  // head groups, heads a group, head stages
                             // of B3a
  int wx, wb;                      // f32 inputs' planes' row widths
};

// acc[t] (the warp's 16 rows from m0 x n8 tiles n0 / 8 + t, t < nt <= NT,
// NT even) += A B over K, both operands bf16-term planes in shared memory
// read by ldmatrix: A stored [m][k] (a_km_layout: [k][m]), B stored [n][k]
// (b_kn_layout: [k][n]); the term pairs of index sum <= ORD kept
template <int NA, int NB, int ORD, int NT>
__device__ __forceinline__ void plane_mm(float (&acc)[NT][4], const bf16* a,
                                         int pa, int lda, bool a_km_layout,
                                         const bf16* b, int pb, int ldb,
                                         bool b_kn_layout, int m0, int K,
                                         int n0, int nt, int lane) {
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[NA][4];
    ld_a<NA>(af, a, pa,
             a_km_layout ? a_km(lane, m0, k0, lda) : a_mk(lane, m0, k0, lda),
             a_km_layout);
#pragma unroll
    for (int t = 0; t < NT; t += 2) {
      if (t >= nt) continue;
      uint32_t b0[NB][2], b1[NB][2];
      ld_b<NB>(b0, b1, b, pb,
               b_kn_layout ? b_kn(lane, k0, n0 + 8 * t, ldb)
                           : b_nk(lane, k0, n0 + 8 * t, ldb),
               b_kn_layout);
      mma_terms<NA, NB, ORD>(acc[t], af, b0);
      if (t + 1 < nt) mma_terms<NA, NB, ORD>(acc[t + 1], af, b1);
    }
  }
}

__device__ __forceinline__ void tiles_landed() {
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();
}

// bytes of n bf16 planes of a 64-row tile of `cols` columns (B1's layout)
__host__ __device__ constexpr int pl_bytes(int n, int cols) {
  return 2 * n * T * (cols + LDX);
}

// bytes of the dstate block's shared memory: exp(csum), e dy and c as
// planes (input tiles NI planes, fp32 ones NF)
__host__ __device__ inline int bwd_dstate_bytes(int QP, int NSP, int ni,
                                                int nf) {
  return 4 * QP + pl_bytes(nf, BWD_HD) + pl_bytes(ni, NSP);
}

// B3a's shared memory, in this order from a 1024-byte aligned base: the
// ring (RING slots of SLOT_STRIDE bytes), `hs` head stages (x's NI
// planes of 64 x 64 bf16, csum and dt of the chunk), the bf16 planes the
// block cuts (NF planes of D, 64 x 128, or of dy, 64 x 64), G^T of
// BWD_NTQ tile pairs (fp32, each thread its own elements), the reduction
// scratch (4 x 64 floats), the diagonal Z
// row sums (64) and the dlast parts (4), the mbarriers (full, empty of
// the ring and of each head stage); plus 1024 bytes to align the base.
__host__ __device__ inline int bwd_head_bytes(int ni) {
  return ni * T * T * 2 + 2 * 4 * BWD_NTQ * T;
}
__host__ __device__ inline int bwd_cols_bytes(int ni, int nf, int hs) {
  return RING * SLOT_STRIDE + hs * bwd_head_bytes(ni) +
         nf * T * BWD_NS * 2 + BWD_NTQ * GSLOT * 4 +
         4 * (4 * T + T + 4) + 8 * (2 * RING + 2 * hs) + 1024;
}
// B3b's: the ring, c_I's NI planes (64 x 128 bf16), the mbarriers (full,
// empty of the ring and of the c_I buffer); plus the alignment.
__host__ __device__ inline int bwd_rows_bytes(int ni) {
  return RING * SLOT_STRIDE + ni * T * BWD_NS * 2 + 8 * (2 * RING + 2) +
         1024;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

template <typename E>
__device__ __forceinline__ void store_val(E* p, float v);
template <>
__device__ __forceinline__ void store_val<float>(float* p, float v) {
  *p = v;
}
template <>
__device__ __forceinline__ void store_val<bf16>(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// (v0, v1) to p[0], p[1]; one store where p is aligned to the pair
template <typename E>
__device__ __forceinline__ void store_pair(E* p, float v0, float v1) {
  if ((uintptr_t)p % (2 * sizeof(E)) == 0) {
    if constexpr (sizeof(E) == 2)
      *reinterpret_cast<uint32_t*>(p) = hopper::pack_bf16(v0, v1);
    else
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    store_val<E>(p, v0);
    store_val<E>(p + 1, v1);
  }
}

// whether one head's rows of dy take 16-byte loads
__device__ __forceinline__ bool vec_dy(const BArgs& A) {
  return (uintptr_t)A.dy % 16 == 0 && (A.f.hd * 4) % 16 == 0;
}

// --- B1: dS_y of each (b, chunk, head) ----------------------------------------

template <typename Tin>
__global__ void __launch_bounds__(NTB) ssd_bwd_dstate_kernel(const BArgs A) {
  constexpr int NI = Prec<Tin>::NI, NF = BPrec<Tin>::N;
  constexpr int ORD = BPrec<Tin>::ORD;
  const Args& a = A.f;
  extern __shared__ float4 smem4[];
  const Dims d(a.S, a.hd, a.ns, a.chunk);
  const int h = blockIdx.x, c = blockIdx.y, bi = blockIdx.z;
  if (h >= a.nh || c >= d.nc || bi >= a.B) return;
  const long long s0 = (long long)c * d.Q;
  const int n = (int)(a.S - s0 < d.Q ? a.S - s0 : d.Q);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int LX = BWD_HD + LDX, PX = T * LX, LB = d.NSP + LDX, PB = T * LB;
  const int nts = d.NSP / 8;
  float* es = reinterpret_cast<float*>(smem4);   // [QP] exp(csum)
  bf16* dye = reinterpret_cast<bf16*>(es + d.QP);   // NF x [T][LX]: e dy
  bf16* ct = dye + NF * PX;                         // NI x [T][LB]: c
  const long long at = ((long long)bi * d.nc + c) * a.nh + h;
  for (int j = tid; j < d.QP; j += NTB) es[j] = expf(a.ws_cs[at * d.QP + j]);
  const long long rs_y = (long long)a.nh * a.hd;
  const float* DY = A.dy + ((long long)bi * a.S + s0) * rs_y +
                    (long long)h * a.hd;
  const Tin* C = static_cast<const Tin*>(a.c) + bi * a.c_sb + s0 * a.c_ss;
  const bool vdy = vec_dy(A);
  float acc[16][4] = {};
  for (int i0 = 0; i0 < n; i0 += T) {
    __syncthreads();              // es is in; the last tile's planes are read
    load_planes<float, NF>(dye, PX, LX, DY + i0 * rs_y, rs_y, T, BWD_HD,
                           n - i0, a.hd, vdy, es + i0, tid, NTB);
    fill_input<Tin>(ct, PB, LB, C + i0 * a.c_ss, a.c_ss, T, d.NSP, n - i0,
                    a.ns, a.vec_c, tid, NTB);
    tiles_landed();
    // A(p, i) = e_i dy_ip, stored [i][p]; B(i, k) = c_ik, stored [i][k]
    plane_mm<NF, NI, ORD, 16>(acc, dye, PX, LX, true, ct, PB, LB, true,
                              16 * warp, T, 0, nts, lane);
  }
  const int g = lane >> 2, q = lane & 3;
  float* out = a.ws_state + at * a.hd * a.ns;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const int k = 8 * t + 2 * q;
    if (k >= a.ns) continue;        // ns % 4 == 0: k + 1 < ns too
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int p = 16 * warp + g + 8 * hr;
      if (p < a.hd)
        *reinterpret_cast<float2*>(out + (long long)p * a.ns + k) =
            make_float2(acc[t][2 * hr], acc[t][2 * hr + 1]);
    }
  }
}


// --- B2: the state gradient, backwards over the chunks ----------------------

// partial sums of exp(last) <D, P> a (b, chunk, head): one a block of the
// pass
__host__ __device__ inline int pass_parts(int hd, int ns) {
  return (hd * ns + 4 * NTP2 - 1) / (4 * NTP2);
}

// grid (hd ns / 1024, nh, B), a float4 of the state a thread, as the
// forward's pass; each chunk's loads issued while the one before is added
template <typename Tin>
__global__ void __launch_bounds__(NTP2) ssd_bwd_pass_kernel(const BArgs A) {
  constexpr int ND = Prec<Tin>::ND;
  __shared__ float red[NTP2 / 32];
  const Args& a = A.f;
  const Dims d(a.S, a.hd, a.ns, a.chunk);
  const int h = blockIdx.y, bi = blockIdx.z;
  const int hdns = a.hd * a.ns;
  const int e = 4 * (blockIdx.x * NTP2 + threadIdx.x);
  if (h >= a.nh || bi >= a.B) return;
  const bool live = e < hdns;
  const int p = live ? e / a.ns : 0, k = live ? e - p * a.ns : 0;
  const long long head = (long long)bi * a.nh + h;
  const int parts = pass_parts(a.hd, a.ns);
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live && A.dfin != nullptr)
    g = *reinterpret_cast<const float4*>(A.dfin + head * hdns + e);
  auto at_of = [&](int c) { return ((long long)bi * d.nc + c) * a.nh + h; };
  // chunk c's dS_y, carried-state terms and decay, loaded a chunk ahead
  auto load = [&](int c, float4& sy, uint2 (&pt)[ND], float& dec) {
    const long long at = at_of(c);
    dec = expf(a.ws_cs[at * d.QP + d.QP - 1]);
    if (!live) return;
    sy = *reinterpret_cast<const float4*>(a.ws_state + at * hdns + e);
    const bf16* sp = a.ws_sp + (at * ND * a.hd + p) * d.NSP + k;
#pragma unroll
    for (int t = 0; t < ND; ++t)
      pt[t] = *reinterpret_cast<const uint2*>(sp + (long long)t * a.hd *
                                                       d.NSP);
  };
  float4 sy = make_float4(0.f, 0.f, 0.f, 0.f);
  uint2 pt[ND];
  float dec;
  load(d.nc - 1, sy, pt, dec);
  for (int c = d.nc - 1; c >= 0; --c) {
    const long long at = at_of(c);
    float4 nsy = sy;
    uint2 npt[ND];
    float ndec = dec;
    if (c > 0) load(c - 1, nsy, npt, ndec);
    float dot = 0.f;
    if (live) {
      *reinterpret_cast<float4*>(a.ws_state + at * hdns + e) = g;
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int t = ND - 1; t >= 0; --t) {
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&pt[t].x));
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&pt[t].y));
        pv[0] += lo.x;
        pv[1] += lo.y;
        pv[2] += hi.x;
        pv[3] += hi.y;
      }
      dot = g.x * pv[0] + g.y * pv[1] + g.z * pv[2] + g.w * pv[3];
      g.x = fmaf(dec, g.x, sy.x);
      g.y = fmaf(dec, g.y, sy.y);
      g.z = fmaf(dec, g.z, sy.z);
      g.w = fmaf(dec, g.w, sy.w);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = dot;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NTP2 / 32; ++w) s += red[w];
      A.ws_dlr[at * parts + blockIdx.x] = dec * s;
    }
    __syncthreads();
    sy = nsy;
#pragma unroll
    for (int t = 0; t < ND; ++t) pt[t] = npt[t];
    dec = ndec;
  }
}

// --- B3a, B3b: the chunk terms --------------------------------------------------

// Byte offset of element (r, c) of a 64-row tile in the 128-byte swizzle
// that TMA writes and wgmma reads: bf16 in boxes of 64 columns, fp32 in
// boxes of 32, each box 64 rows of 128 bytes (8 KB)
__device__ __forceinline__ uint32_t sw_bf16(int r, int c) {
  return (c >> 6) * 8192 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}
__device__ __forceinline__ uint32_t sw_f32(int r, int c) {
  return (c >> 5) * 8192 + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) +
         (c & 3) * 4;
}
__device__ __forceinline__ float f32_val(const char* tile, int r, int c) {
  return *reinterpret_cast<const float*>(tile + sw_f32(r, c));
}
// the values at (r, c) and (r, c + 1), c even, held as N bf16 planes of
// a swizzled tile `plane` bytes apart (one 32-bit load a plane)
template <int N>
__device__ __forceinline__ float2 tile_pair(const char* pl, int plane, int r,
                                            int c) {
  float2 v = make_float2(0.f, 0.f);
#pragma unroll
  for (int t = N - 1; t >= 0; --t) {
    const uint32_t u =
        *reinterpret_cast<const uint32_t*>(pl + t * plane + sw_bf16(r, c));
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
    v.x += f.x;
    v.y += f.y;
  }
  return v;
}
// 8 fp32 values at (r, c0..c0 + 7), c0 % 8 == 0, cut into N bf16 planes
template <int N>
__device__ __forceinline__ void put8(char* pl, int plane, int r, int c0,
                                     const float (&v)[8]) {
  uint32_t pk[4][N];
#pragma unroll
  for (int i = 0; i < 4; ++i) split2<N>(v[2 * i], v[2 * i + 1], pk[i]);
#pragma unroll
  for (int t = 0; t < N; ++t)
    *reinterpret_cast<uint4*>(pl + t * plane + sw_bf16(r, c0)) =
        make_uint4(pk[0][t], pk[1][t], pk[2][t], pk[3][t]);
}

// `addr` as a value the compiler cannot see through: a descriptor made
// from it is made where it is used, not hoisted out of the loops and kept
// in registers
__device__ __forceinline__ uint32_t opaque(uint32_t addr) {
  asm volatile("mov.b32 %0, %0;" : "+r"(addr));
  return addr;
}
__device__ __forceinline__ int opaque(int v) {
  asm volatile("mov.b32 %0, %0;" : "+r"(v));
  return v;
}
// a wgmma descriptor (128-byte swizzle) of a tile at shared address `a`
__device__ __forceinline__ uint64_t desc_at(uint32_t a, uint32_t lbo) {
  return hopper::wgmma_desc_sw128(opaque(a), lbo, 1024);
}

// A operands of a 64 x 64 product in registers, cut into N terms: register
// rr of k16 step kk holds rows (16 w + lane / 4) + 8 (rr & 1), columns
// 16 kk + 2 (lane % 4) + 8 (rr >> 1) and the next
template <int N>
__device__ __forceinline__ void frag_put(uint32_t (&af)[N][4][4], int kk,
                                         int rr, float v0, float v1) {
  uint32_t o[N];
  split2<N>(v0, v1, o);
#pragma unroll
  for (int t = 0; t < N; ++t) af[t][kk][rr] = o[t];
}
// the same from a 64 x 64 accumulator: registers 8 kk + 2 rr and the next
template <int N>
__device__ __forceinline__ void frags_of(uint32_t (&af)[N][4][4],
                                         const float (&acc)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
      frag_put<N>(af, kk, rr, acc[8 * kk + 2 * rr], acc[8 * kk + 2 * rr + 1]);
}
// Keeps A fragments that an in-flight wgmma reads alive until its wait.
template <int N>
__device__ __forceinline__ void fence_af(uint32_t (&af)[N][4][4]) {
#pragma unroll
  for (int t = 0; t < N; ++t)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        asm volatile("" : "+r"(af[t][kk][rr])::"memory");
}

// d (64 x 64) = or += the term pairs of A . B over K = 16 KS, both from
// shared memory K-major (A at a_addr, NA planes `pa` bytes apart; B at
// b_addr, NB planes `pb` apart; a k16 step 32 bytes into a 128-byte row,
// a new 64-column box every 4 steps)
template <int NA, int NB, int ORD, int KS>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint32_t a_addr,
                                       int pa, uint32_t b_addr, int pb,
                                       bool fresh) {
  bool first = fresh;
#pragma unroll
  for (int i = NA - 1; i >= 0; --i)
#pragma unroll
    for (int j = NB - 1; j >= 0; --j) {
      if (i + j > ORD) continue;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t off = (kk >> 2) * 8192 + (kk & 3) * 32;
        hopper::wgmma_m64n64k16<0, 0>(
            d, desc_at(a_addr + i * pa + off, 16),
            desc_at(b_addr + j * pb + off, 16),
            first ? 0 : 1);
        first = false;
      }
    }
}
// d (64 x N) += the term pairs of A (registers, K = 64) . B (shared memory,
// MN-major: K rows of 128 bytes, 64-column boxes 8 KB apart; plane j at
// shared address b[j]); `fresh` overwrites d with the first
template <int NA, int NB, int ORD, int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&af)[NA][4][4],
                                       const uint32_t (&b)[NB], bool fresh) {
  bool first = fresh;
#pragma unroll
  for (int i = NA - 1; i >= 0; --i)
#pragma unroll
    for (int j = NB - 1; j >= 0; --j) {
      if (i + j > ORD) continue;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc_at(b[j] + kk * 2048, 8192);
        if constexpr (N == 128)
          hopper::wgmma_m64n128k16_rs<1>(d, af[i][kk], db, first ? 0 : 1);
        else
          hopper::wgmma_m64n64k16_rs<1>(d, af[i][kk], db, first ? 0 : 1);
        first = false;
      }
    }
}
// d (64 x N) += the term pairs of A . B as mma_rs (B's plane j at shared
// address b[j]), A's term i cut from the fp32 values v (register rr of
// k16 step kk from v[8 kk + 2 rr] and the next) as it is issued and
// waited for: one term's fragments live at a time (f32 inputs, whose
// three terms a side leave no registers for all of them at once)
template <int NA, int NB, int ORD, int N>
__device__ __forceinline__ void mma_rs_by_term(float (&d)[N / 2],
                                               const float (&v)[32],
                                               const uint32_t (&b)[NB]) {
#pragma unroll
  for (int i = NA - 1; i >= 0; --i) {
    uint32_t ai[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        // a term's cut made anew (opaque to the compiler), not kept from
        // the last term's
        float v0 = v[8 * kk + 2 * rr], v1 = v[8 * kk + 2 * rr + 1];
        asm volatile("" : "+f"(v0), "+f"(v1));
        uint32_t o[NA];
        split2<NA>(v0, v1, o);
        ai[kk][rr] = o[i];
      }
    hopper::wgmma_fence();
#pragma unroll
    for (int j = NB - 1; j >= 0; --j) {
      if (i + j > ORD) continue;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc_at(b[j] + kk * 2048, 8192);
        if constexpr (N == 128)
          hopper::wgmma_m64n128k16_rs<1>(d, ai[kk], db, 1);
        else
          hopper::wgmma_m64n64k16_rs<1>(d, ai[kk], db, 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(d);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        asm volatile("" : "+r"(ai[kk][rr])::"memory");
  }
}
// the shared addresses of NB planes `pb` bytes apart from `base`, or of
// ring slots s[0..NB)
template <int NB>
__device__ __forceinline__ void planes_at(uint32_t (&b)[NB], uint32_t base,
                                          int pb) {
#pragma unroll
  for (int j = 0; j < NB; ++j) b[j] = base + j * pb;
}
template <int NB>
__device__ __forceinline__ void slots_at(uint32_t (&b)[NB], uint32_t ring,
                                         const int (&s)[NB]) {
#pragma unroll
  for (int j = 0; j < NB; ++j) b[j] = ring + s[j] * SLOT_STRIDE;
}

template <int N>
__device__ __forceinline__ void mma_done(float (&d)[N]) {
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d);
}

// tile pairs I >= J of a chunk, and the pairs I > J
__host__ __device__ inline int n_pairs(int ntq) { return ntq * (ntq + 1) / 2; }
__host__ __device__ inline int n_off(int ntq) { return ntq * (ntq - 1) / 2; }
__host__ __device__ inline int pair_idx(int I, int J) {
  return I * (I + 1) / 2 + J;
}
__host__ __device__ inline int off_idx(int I, int J) {
  return I * (I - 1) / 2 + J;
}

// The static walk: block x of G takes in round k the item of rank k G + x,
// or k G + G - 1 - x in odd rounds (kernels/ssd_scan.py::walk mirrors it)
__host__ __device__ inline long long walk_rank(int k, int x, int G) {
  return (long long)k * G + ((k & 1) ? G - 1 - x : x);
}
// B3a's item of rank r: batches, chunks, head groups, then column tiles J
// (the last chunk has ntl tiles)
struct ColItem {
  int b, c, g, J;
};
__host__ __device__ inline ColItem col_item(long long r, int nc, int ntq,
                                            int ntl, int groups) {
  const long long full = (long long)(nc - 1) * groups * ntq;
  const long long per_b = full + (long long)groups * ntl;
  ColItem it;
  it.b = (int)(r / per_b);
  long long k = r % per_b;
  int per = ntq;
  if (k < full) {
    it.c = (int)(k / ((long long)groups * ntq));
    k %= (long long)groups * ntq;
  } else {
    k -= full;
    it.c = nc - 1;
    per = ntl;
  }
  it.g = (int)(k / per);
  it.J = (int)(k % per);
  return it;
}
__host__ __device__ inline long long col_items(int B, int nc, int ntq,
                                               int ntl, int groups) {
  return (long long)B * ((long long)(nc - 1) * groups * ntq +
                         (long long)groups * ntl);
}
// B3b's item of rank r: batches, chunks, then row tiles I (c, I in .y, .z)
__host__ __device__ inline int3 row_item(long long r, int nc, int ntq,
                                         int ntl) {
  const long long per_b = (long long)(nc - 1) * ntq + ntl;
  const int b = (int)(r / per_b);
  const int k = (int)(r % per_b);
  return k < (nc - 1) * ntq ? make_int3(b, k / ntq, k % ntq)
                            : make_int3(b, nc - 1, k - (nc - 1) * ntq);
}

// B3a: the column items.  Warps 0-3 consume, warp 4's lane 0 produces.
template <typename Tin>
__global__ void __launch_bounds__(NTK, 1)
    ssd_bwd_cols_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tb,
                        const __grid_constant__ CUtensorMap tc,
                        const __grid_constant__ CUtensorMap tdy,
                        const __grid_constant__ CUtensorMap tcb,
                        const BArgs A) {
  using namespace hopper;
  constexpr int NI = Prec<Tin>::NI, NF = BPrec<Tin>::N;
  constexpr int ORD = BPrec<Tin>::ORD;
  constexpr int XPL = T * T * 2;            // bytes of a 64 x 64 bf16 plane
  constexpr int SPL = T * BWD_NS * 2;       // of a 64 x 128 one
  const Args& a = A.f;
  const Dims d(a.S, a.hd, a.ns, a.chunk);
  const int HS = A.hstages, HB = bwd_head_bytes(NI);
  extern __shared__ uint8_t smem_raw[];
  char* ring = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  char* heads = ring + RING * SLOT_STRIDE;
  char* planes = heads + HS * HB;
  float* gacc = reinterpret_cast<float*>(planes + NF * SPL);
  float* zrw = gacc + BWD_NTQ * GSLOT;      // [4][64] warps' row sums
  float* zdg = zrw + 4 * T;                 // [64] the diagonal pair's
  float* wsum = zdg + T;                    // [4] warps' dlast parts
  uint64_t* full = reinterpret_cast<uint64_t*>(wsum + 4);
  uint64_t* empty = full + RING;
  uint64_t* hfull = empty + RING;
  uint64_t* hempty = hfull + HS;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCW);
    }
    for (int s = 0; s < HS; ++s) {
      mbar_init(&hfull[s], 1);
      mbar_init(&hempty[s], NCW);
    }
    mbar_fence_init();
  }
  for (int i = tid; i < BWD_NTQ * GSLOT; i += NTK) gacc[i] = 0.f;
  __syncthreads();

  const int nlast = a.S - (d.nc - 1) * d.Q;
  const int ntl = (nlast + T - 1) / T;
  const long long items = col_items(a.B, d.nc, d.ntq, ntl, A.groups);
  const int G = gridDim.x;
  const int npair = n_pairs(d.ntq), noff = n_off(d.ntq);

  if (tid >= NCW) {
    // the producer: every tile of the walk, in the consumers' order
    if (tid != NCW) return;
    int n = 0, hn = 0;
    auto slot = [&](uint32_t bytes) {
      const int s = n % RING;
      if (n >= RING) mbar_wait(&empty[s], ((n / RING) - 1) & 1);
      mbar_arrive_expect_tx(&full[s], bytes);
      ++n;
      return s;
    };
    for (int k = 0;; ++k) {
      const long long r = walk_rank(k, blockIdx.x, G);
      if (r >= items) break;
      const ColItem it = col_item(r, d.nc, d.ntq, ntl, A.groups);
      const int s0 = it.c * d.Q;
      const int nrows = min(a.S - s0, d.Q), nt = (nrows + T - 1) / T;
      const int h1 = min(a.nh, (it.g + 1) * A.hpg);
      for (int h = it.g * A.hpg; h < h1; ++h) {
        const long long at = ((long long)it.b * d.nc + it.c) * a.nh + h;
        {
          const int s = hn % HS;
          if (hn >= HS) mbar_wait(&hempty[s], ((hn / HS) - 1) & 1);
          ++hn;
          char* st = heads + s * HB;
          mbar_arrive_expect_tx(&hfull[s], NI * XPL + 8 * d.QP);
          for (int t = 0; t < NI; ++t)
            tma_load_4d(st + t * XPL, &tx, &hfull[s], h * a.hd,
                        s0 + T * it.J, it.b, t);
          float* cs = reinterpret_cast<float*>(st + NI * XPL);
          bulk_load(cs, a.ws_cs + at * d.QP, 4 * d.QP, &hfull[s]);
          bulk_load(cs + BWD_NTQ * T, a.ws_dt + at * d.QP, 4 * d.QP,
                    &hfull[s]);
        }
        // D in two halves of 32 rows (a half past hd is empty)
        const float* Dg = a.ws_state + at * a.hd * a.ns;
        for (int half = 0; half < 2; ++half) {
          const int rows = max(0, min(32, a.hd - 32 * half));
          const int s = slot(rows * a.ns * 4);
          if (rows)
            bulk_load(ring + s * SLOT_STRIDE, Dg + 32 * half * a.ns,
                      rows * a.ns * 4, &full[s]);
        }
        for (int t = 0; t < NI; ++t) {
          const int s = slot(SLOT);
          for (int bx = 0; bx < 2; ++bx)
            tma_load_4d(ring + s * SLOT_STRIDE + bx * 8192, &tb, &full[s],
                        64 * bx, s0 + T * it.J, it.b, t);
        }
        for (int I = it.J; I < nt; ++I) {
          int s = slot(SLOT);
          for (int bx = 0; bx < 2; ++bx)
            tma_load_3d(ring + s * SLOT_STRIDE + bx * 8192, &tdy, &full[s],
                        h * a.hd + 32 * bx, s0 + T * I, it.b);
          s = slot(SLOT);
          for (int bx = 0; bx < 2; ++bx)
            tma_load_2d(ring + s * SLOT_STRIDE + bx * 8192, &tcb, &full[s],
                        T * it.J + 32 * bx,
                        (it.b * d.nc + it.c) * d.QP + T * I);
        }
      }
      for (int I = it.J; I < nt; ++I)
        for (int t = 0; t < NI; ++t) {
          const int s = slot(SLOT);
          for (int bx = 0; bx < 2; ++bx)
            tma_load_4d(ring + s * SLOT_STRIDE + bx * 8192, &tc, &full[s],
                        64 * bx, s0 + T * I, it.b, t);
        }
    }
    return;
  }

  // the consumers: one warpgroup, 16 rows a warp.  With f32 inputs the
  // lane's rows and columns are made anew at each phase from an opaque
  // thread index, so the compiler makes the phase's shared-memory offsets
  // there instead of keeping them in registers across the walk (three
  // terms a side leave no room for them).
  int warp, lane, q, r0, r1;
  auto lanes = [&] {
    const int t = NF == 3 ? opaque(tid) : tid;
    warp = t >> 5;
    lane = t & 31;
    q = lane & 3;
    r0 = 16 * warp + (lane >> 2);
    r1 = r0 + 8;
  };
  lanes();
  const uint32_t ring_a = smem_u32(ring), planes_a = smem_u32(planes);
  int n = 0, hn = 0;
  auto take = [&]() {
    const int s = n % RING;
    mbar_wait(&full[s], (n / RING) & 1);
    ++n;
    return s;
  };
  auto give = [&](int s) { mbar_arrive(&empty[s]); };
  const long long rs_y = (long long)a.nh * a.hd;
  SSD_BT_BEGIN(0, 0, tt);
  for (int k = 0;; ++k) {
    const long long r = walk_rank(k, blockIdx.x, G);
    if (r >= items) break;
    SSD_BT_COUNT(0, 0);
    const ColItem it = col_item(r, d.nc, d.ntq, ntl, A.groups);
    const int J = it.J, j0 = T * J, s0 = it.c * d.Q;
    const int nrows = min(a.S - s0, d.Q), nt = (nrows + T - 1) / T;
    const int h1 = min(a.nh, (it.g + 1) * A.hpg);
    float db[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) db[i] = 0.f;
    // f32 inputs sum db in the group's part in the workspace instead, a
    // product at a time (their registers hold no 64 more across the
    // heads), each thread its own elements: the first head writes
    float* dbp_item = A.ws_dbp + ((((long long)it.b * d.nc + it.c) * d.ntq +
                                   J) * A.groups + it.g) * T * BWD_NS;
    auto db_part = [&](float* o, const float (&v)[64], bool add) {
#pragma unroll
      for (int t = 0; t < 16; ++t)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float2* p2 = reinterpret_cast<float2*>(
              o + (hh ? r1 : r0) * BWD_NS + 8 * t + 2 * q);
          float2 f = make_float2(v[4 * t + 2 * hh], v[4 * t + 2 * hh + 1]);
          if (add) {
            const float2 old = *p2;
            f.x += old.x;
            f.y += old.y;
          }
          *p2 = f;
        }
    };
    for (int h = it.g * A.hpg; h < h1; ++h) {
      const long long at = ((long long)it.b * d.nc + it.c) * a.nh + h;
      lanes();
      const int hs = hn % HS;
      mbar_wait(&hfull[hs], (hn / HS) & 1);
      ++hn;
      const char* xs = heads + hs * HB;
      const uint32_t xs_a = smem_u32(xs);
      const float* cs = reinterpret_cast<const float*>(xs + NI * XPL);
      const float* dtv = cs + BWD_NTQ * T;
      const float last = cs[d.QP - 1];
      float csj[2], dtj[2], wj[2], rwj[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = j0 + (hh ? r1 : r0);
        csj[hh] = cs[row];
        dtj[hh] = dtv[row];
        wj[hh] = expf(last - csj[hh]);
        rwj[hh] = dtj[hh] * wj[hh];
      }
      // D (fp32, rows of ns) cut into NF planes of 64 x 128
      const int sd0 = take(), sd1 = take();
      SSD_BT_LAP(0, 0, 2, tt);
      for (int e = NF == 3 ? opaque(tid) : tid; e < T * (BWD_NS / 8);
           e += NCW) {
        const int p = e >> 4, k0 = (e & 15) * 8;
        const float* src = reinterpret_cast<const float*>(
                               ring + (p < 32 ? sd0 : sd1) * SLOT_STRIDE) +
                           (p & 31) * a.ns + k0;
        float v[8];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const bool in = p < a.hd && k0 + 4 * u < a.ns;
          const float4 f = in ? *reinterpret_cast<const float4*>(src + 4 * u)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
          v[4 * u] = f.x;
          v[4 * u + 1] = f.y;
          v[4 * u + 2] = f.z;
          v[4 * u + 3] = f.w;
        }
        put8<NF>(planes, SPL, p, k0, v);
      }
      give(sd0);
      give(sd1);
      fence_proxy_async();
      named_bar_sync(1, NCW);
      if constexpr (NF == 3) {
        // f32 inputs: db's head part (x dt w)_J D first, while no other
        // product's registers are live
        float av[32];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const float2 xv = tile_pair<NI>(xs, XPL, (rr & 1) ? r1 : r0,
                                            16 * kk + 2 * q + 8 * (rr >> 1));
            av[8 * kk + 2 * rr] = xv.x * rwj[rr & 1];
            av[8 * kk + 2 * rr + 1] = xv.y * rwj[rr & 1];
          }
        uint32_t bp[NF];
        planes_at<NF>(bp, planes_a, SPL);
        float dbh[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) dbh[i] = 0.f;
        mma_rs_by_term<NF, NF, ORD, 128>(dbh, av, bp);
        db_part(dbp_item, dbh, h > it.g * A.hpg);
      }
      int sb[NI];
#pragma unroll
      for (int t = 0; t < NI; ++t) sb[t] = take();
      SSD_BT_LAP(0, 0, 2, tt);
      // the state term u = b_J D^T (K = 128 state columns)
      float u[32];
      wgmma_fence();
      {
        bool first = true;
#pragma unroll
        for (int i = NI - 1; i >= 0; --i)
#pragma unroll
          for (int j = NF - 1; j >= 0; --j) {
            if (i + j > ORD) continue;
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
              const uint32_t off = (kk >> 2) * 8192 + (kk & 3) * 32;
              wgmma_m64n64k16<0, 0>(
                  u, desc_at(ring_a + sb[i] * SLOT_STRIDE + off, 16),
                  desc_at(planes_a + j * SPL + off, 16),
                  first ? 0 : 1);
              first = false;
            }
          }
      }
      mma_done(u);
#pragma unroll
      for (int t = 0; t < NI; ++t) give(sb[t]);
      // dxd = w u; dw_j = dt_j w_j x_j . u_j
      lanes();
      float dxd[32], dw[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int idx = 4 * t + 2 * hh;
          const float2 xv = tile_pair<NI>(xs, XPL, hh ? r1 : r0, 8 * t + 2 * q);
          dw[hh] += u[idx] * xv.x + u[idx + 1] * xv.y;
          dxd[idx] = u[idx] * wj[hh];
          dxd[idx + 1] = u[idx + 1] * wj[hh];
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) dw[hh] = quad_sum(dw[hh]) * rwj[hh];
      // db += (x dt w)_J D: A in registers, B = D's planes MN-major (bf16
      // inputs; f32 above)
      if constexpr (NF == 2) {
        uint32_t af[NF][4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const float2 xv = tile_pair<NI>(xs, XPL, (rr & 1) ? r1 : r0,
                                            16 * kk + 2 * q + 8 * (rr >> 1));
            frag_put<NF>(af, kk, rr, xv.x * rwj[rr & 1], xv.y * rwj[rr & 1]);
          }
        uint32_t bp[NF];
        planes_at<NF>(bp, planes_a, SPL);
        wgmma_fence();
        mma_rs<NF, NF, ORD, 128>(db, af, bp, false);
        mma_done(db);
        fence_af(af);
      }
      SSD_BT_LAP(0, 0, 3, tt);

      // the row tiles I >= J
      float zc[2] = {0.f, 0.f};
      for (int I = J; I < nt; ++I) {
        const int sdy = take(), scb = take();
        SSD_BT_LAP(0, 0, 2, tt);
        lanes();
        const char* dyt = ring + sdy * SLOT_STRIDE;
        const char* cbt = ring + scb * SLOT_STRIDE;
        const int nrow = nrows - T * I;
        // dy_I (fp32, swizzled) cut into NF planes of 64 x 64
        for (int e = NF == 3 ? opaque(tid) : tid; e < T * 8; e += NCW) {
          const int i = e >> 3, p0 = (e & 7) * 8;
          float v[8];
#pragma unroll
          for (int u4 = 0; u4 < 2; ++u4) {
            const float4 f = *reinterpret_cast<const float4*>(
                dyt + sw_f32(i, p0 + 4 * u4));
            const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
            for (int m = 0; m < 4; ++m)
              v[4 * u4 + m] =
                  (i < nrow && p0 + 4 * u4 + m < a.hd) ? fv[m] : 0.f;
          }
          put8<NF>(planes, XPL, i, p0, v);
        }
        fence_proxy_async();
        named_bar_sync(1, NCW);
        // S1^T = x_J dy_I^T (rows j, columns i)
        float s[32];
        wgmma_fence();
        mma_ss<NI, NF, ORD, 4>(s, xs_a, XPL, planes_a, XPL, true);
        mma_done(s);
        // dCB^T = S1^T dt_j L^T; Z; G^T += dCB^T; s becomes (CB L)^T; Z's
        // row sums (over j) of the pair are the tile's column sums: this
        // thread's two rows, then the warp's 16 (lanes of one q), into
        // zrw for the warps' sum below
        float* gs = gacc + (I - J) * GSLOT;
        uint32_t af[NF][4][4];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          float4 gv = *reinterpret_cast<float4*>(gs + (t * NCW + tid) * 4);
          float* gp = &gv.x;
          float cz[2] = {0.f, 0.f};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 4 * t + 2 * hh + e;
              const int row = hh ? r1 : r0, col = 8 * t + 2 * q + e;
              const int ig = T * I + col, jg = j0 + row;
              const float L =
                  ig >= jg && ig < nrows ? expf(cs[ig] - csj[hh]) : 0.f;
              const float dcbt = s[idx] * dtj[hh] * L;
              const float cbv = f32_val(cbt, col, row);
              const float z = dcbt * cbv;
              zc[hh] += z;
              cz[e] += z;
              gp[2 * hh + e] += dcbt;
              s[idx] = cbv * L;
            }
          // registers 4 t .. 4 t + 3 are A's k16 step t / 2, registers
          // 2 (t % 2) + hh (f32 inputs cut them term by term below)
          if constexpr (NF == 2)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              frag_put<NF>(af, t >> 1, 2 * (t & 1) + hh, s[4 * t + 2 * hh],
                           s[4 * t + 2 * hh + 1]);
          *reinterpret_cast<float4*>(gs + (t * NCW + tid) * 4) = gv;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            cz[e] += __shfl_xor_sync(0xffffffffu, cz[e], 4);
            cz[e] += __shfl_xor_sync(0xffffffffu, cz[e], 8);
            cz[e] += __shfl_xor_sync(0xffffffffu, cz[e], 16);
          }
          if (lane < 4) {
            zrw[warp * T + 8 * t + 2 * q] = cz[0];
            zrw[warp * T + 8 * t + 2 * q + 1] = cz[1];
          }
        }
        give(sdy);
        give(scb);
        named_bar_sync(1, NCW);
        if (tid < T) {
          const float v = (zrw[tid] + zrw[T + tid]) +
                          (zrw[2 * T + tid] + zrw[3 * T + tid]);
          if (I == J)
            zdg[tid] = v;
          else
            A.ws_zr[(at * noff + off_idx(I, J)) * T + tid] = v;
        }
        // dxd += (CB L)^T dy_I (dy's planes MN-major)
        if constexpr (NF == 2) {
          uint32_t bp[NF];
          planes_at<NF>(bp, planes_a, XPL);
          wgmma_fence();
          mma_rs<NF, NF, ORD, 64>(dxd, af, bp, false);
          mma_done(dxd);
          fence_af(af);
        } else {
          uint32_t bp[NF];
          planes_at<NF>(bp, planes_a, XPL);
          mma_rs_by_term<NF, NF, ORD, 64>(dxd, s, bp);
        }
        SSD_BT_LAP(0, 0, 3, tt);
      }

      // this head's rows: dx = dt dxd, ddt = dxd . x, dcsum terms, dlast
      named_bar_sync(1, NCW);                // zdg is in
      lanes();
      float dd[2] = {0.f, 0.f};
      Tin* DX = static_cast<Tin*>(A.dx) + ((long long)it.b * a.S + s0) * rs_y +
                (long long)h * a.hd;
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = hh ? r1 : r0, col = 8 * t + 2 * q;
          const int idx = 4 * t + 2 * hh;
          const float2 xv = tile_pair<NI>(xs, XPL, row, col);
          dd[hh] += dxd[idx] * xv.x + dxd[idx + 1] * xv.y;
          if (j0 + row < nrows) {
            Tin* o = DX + (long long)(j0 + row) * rs_y + col;
            if (col + 1 < a.hd)
              store_pair<Tin>(o, dxd[idx] * dtj[hh], dxd[idx + 1] * dtj[hh]);
            else if (col < a.hd)
              store_val<Tin>(o, dxd[idx] * dtj[hh]);
          }
        }
      mbar_arrive(&hempty[hs]);              // x, csum and dt are read
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        dd[hh] = quad_sum(dd[hh]);
        zc[hh] = quad_sum(zc[hh]);
      }
      if (q == 0)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = hh ? r1 : r0, jg = j0 + row;
          if (jg < nrows) {
            A.ddt[((long long)it.b * a.S + s0 + jg) * a.nh + h] = dd[hh];
            A.ws_dcs[at * d.QP + jg] = zdg[row] - zc[hh] - dw[hh];
          }
        }
      float dl = q == 0 ? dw[0] + dw[1] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        dl += __shfl_xor_sync(0xffffffffu, dl, o);
      if (lane == 0) wsum[warp] = dl;
      named_bar_sync(1, NCW);
      if (tid == 0)
        A.ws_dlj[at * d.ntq + J] = (wsum[0] + wsum[1]) + (wsum[2] + wsum[3]);
      SSD_BT_LAP(0, 0, 4, tt);
    }

    // the item's end: db += G^T_IJ c_I; G^T_IJ to the workspace
    for (int I = J; I < nt; ++I) {
      lanes();
      float gv[32];
      float* gs = gacc + (I - J) * GSLOT;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        float4* p4 = reinterpret_cast<float4*>(gs + (t * NCW + tid) * 4);
        const float4 f = *p4;
        gv[4 * t] = f.x;
        gv[4 * t + 1] = f.y;
        gv[4 * t + 2] = f.z;
        gv[4 * t + 3] = f.w;
        *p4 = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float* gw = A.ws_g + ((((long long)it.b * d.nc + it.c) * npair +
                             pair_idx(I, J)) * A.groups + it.g) * GSLOT;
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(gw + (hh ? r1 : r0) * T + 8 * t +
                                     2 * q) =
              make_float2(gv[4 * t + 2 * hh], gv[4 * t + 2 * hh + 1]);
      int sc[NI];
#pragma unroll
      for (int t = 0; t < NI; ++t) sc[t] = take();
      SSD_BT_LAP(0, 0, 2, tt);
      uint32_t bp[NI];
      slots_at<NI>(bp, ring_a, sc);
      if constexpr (NF == 2) {
        uint32_t af[NF][4][4];
        frags_of<NF>(af, gv);
        wgmma_fence();
        mma_rs<NF, NI, ORD, 128>(db, af, bp, false);
        mma_done(db);
        fence_af(af);
      } else {
        float dbh[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) dbh[i] = 0.f;
        mma_rs_by_term<NF, NI, ORD, 128>(dbh, gv, bp);
        db_part(dbp_item, dbh, true);
      }
#pragma unroll
      for (int t = 0; t < NI; ++t) give(sc[t]);
      SSD_BT_LAP(0, 0, 3, tt);
    }
    lanes();
    // db of the tile's rows: the output (one group) or the group's part
    // (f32 inputs: added there above)
    if constexpr (NF == 2)
#pragma unroll
    for (int t = 0; t < 16; ++t)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = hh ? r1 : r0, col = 8 * t + 2 * q;
        if (j0 + row >= nrows || col >= a.ns) continue;  // ns % 4 == 0
        const float v0 = db[4 * t + 2 * hh], v1 = db[4 * t + 2 * hh + 1];
        if (A.groups == 1) {
          store_pair<Tin>(static_cast<Tin*>(A.db) +
                              ((long long)it.b * a.S + s0 + j0 + row) * a.ns +
                              col,
                          v0, v1);
        } else {
          float* o = A.ws_dbp +
                     (((((long long)it.b * d.nc + it.c) * d.ntq + J) *
                           A.groups + it.g) * T + row) * BWD_NS + col;
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        }
      }
    SSD_BT_LAP(0, 0, 4, tt);
  }
}

// B3b: the row items.  Warps 0-3 consume, warp 4's lane 0 produces.
template <typename Tin>
__global__ void __launch_bounds__(NTK, 1)
    ssd_bwd_rows_kernel(const __grid_constant__ CUtensorMap tdy,
                        const __grid_constant__ CUtensorMap tp,
                        const __grid_constant__ CUtensorMap tc,
                        const __grid_constant__ CUtensorMap tb,
                        const BArgs A) {
  using namespace hopper;
  constexpr int NI = Prec<Tin>::NI, NF = BPrec<Tin>::N;
  constexpr int ND = Prec<Tin>::ND, ORD = BPrec<Tin>::ORD;
  constexpr int SPL = T * BWD_NS * 2;
  static_assert(ND == NF, "the carried state's terms are an fp32 operand's");
  const Args& a = A.f;
  const Dims d(a.S, a.hd, a.ns, a.chunk);
  extern __shared__ uint8_t smem_raw[];
  char* ring = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  char* cpl = ring + RING * SLOT_STRIDE;            // c_I: NI planes
  uint64_t* full = reinterpret_cast<uint64_t*>(cpl + NI * SPL);
  uint64_t* empty = full + RING;
  uint64_t* ifull = empty + RING;
  uint64_t* iempty = ifull + 1;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCW);
    }
    mbar_init(ifull, 1);
    mbar_init(iempty, NCW);
    mbar_fence_init();
  }
  __syncthreads();

  const int nlast = a.S - (d.nc - 1) * d.Q;
  const int ntl = (nlast + T - 1) / T;
  const long long items = (long long)a.B * ((d.nc - 1) * d.ntq + ntl);
  const int G = gridDim.x;
  const int npair = n_pairs(d.ntq);

  if (tid >= NCW) {
    if (tid != NCW) return;
    int n = 0;
    auto slot = [&](uint32_t bytes) {
      const int s = n % RING;
      if (n >= RING) mbar_wait(&empty[s], ((n / RING) - 1) & 1);
      mbar_arrive_expect_tx(&full[s], bytes);
      ++n;
      return s;
    };
    for (int k = 0;; ++k) {
      const long long r = walk_rank(k, blockIdx.x, G);
      if (r >= items) break;
      const int3 it = row_item(r, d.nc, d.ntq, ntl);
      const int s0 = it.y * d.Q, I = it.z;
      if (k > 0) mbar_wait(iempty, (k - 1) & 1);
      mbar_arrive_expect_tx(ifull, NI * SPL);
      for (int t = 0; t < NI; ++t)
        for (int bx = 0; bx < 2; ++bx)
          tma_load_4d(cpl + t * SPL + bx * 8192, &tc, ifull, 64 * bx,
                      s0 + T * I, it.x, t);
      for (int h = 0; h < a.nh; ++h) {
        const long long at = ((long long)it.x * d.nc + it.y) * a.nh + h;
        int s = slot(SLOT + 4 * T);
        for (int bx = 0; bx < 2; ++bx)
          tma_load_3d(ring + s * SLOT_STRIDE + bx * 8192, &tdy, &full[s],
                      h * a.hd + 32 * bx, s0 + T * I, it.x);
        bulk_load(ring + s * SLOT_STRIDE + SLOT, a.ws_cs + at * d.QP + T * I,
                  4 * T, &full[s]);
        for (int t = 0; t < ND; ++t) {
          s = slot(SLOT);
          for (int bx = 0; bx < 2; ++bx)
            tma_load_3d(ring + s * SLOT_STRIDE + bx * 8192, &tp, &full[s],
                        64 * bx, 0, (int)(at * ND + t));
        }
      }
      for (int J = 0; J <= I; ++J)
        for (int t = 0; t < NI; ++t) {
          const int s = slot(SLOT);
          for (int bx = 0; bx < 2; ++bx)
            tma_load_4d(ring + s * SLOT_STRIDE + bx * 8192, &tb, &full[s],
                        64 * bx, s0 + T * J, it.x, t);
        }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, q = lane & 3;
  const int r0 = 16 * warp + (lane >> 2), r1 = r0 + 8;
  const uint32_t ring_a = smem_u32(ring);
  int n = 0;
  auto take = [&]() {
    const int s = n % RING;
    mbar_wait(&full[s], (n / RING) & 1);
    ++n;
    return s;
  };
  auto give = [&](int s) { mbar_arrive(&empty[s]); };
  SSD_BT_BEGIN(1, 0, tt);
  for (int k = 0;; ++k) {
    const long long r = walk_rank(k, blockIdx.x, G);
    if (r >= items) break;
    SSD_BT_COUNT(1, 0);
    const int3 it = row_item(r, d.nc, d.ntq, ntl);
    const int bi = it.x, c = it.y, I = it.z, s0 = c * d.Q, i0 = T * I;
    const int nrows = min(a.S - s0, d.Q), nrow = nrows - i0;
    mbar_wait(ifull, k & 1);
    float dc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dc[i] = 0.f;
    for (int h = 0; h < a.nh; ++h) {
      const long long at = ((long long)bi * d.nc + c) * a.nh + h;
      // q = e dy_I P: A = e dy_I in registers, B = P's planes MN-major
      const int sdy = take();
      SSD_BT_LAP(1, 0, 2, tt);
      const char* dyt = ring + sdy * SLOT_STRIDE;
      const float* ev = reinterpret_cast<const float*>(dyt + SLOT);
      const float e2[2] = {expf(ev[r0]), expf(ev[r1])};
      uint32_t af[NF][4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int row = (rr & 1) ? r1 : r0;
          const int col = 16 * kk + 2 * q + 8 * (rr >> 1);
          const bool in = row < nrow;
          const float v0 = in && col < a.hd ? f32_val(dyt, row, col) : 0.f;
          const float v1 =
              in && col + 1 < a.hd ? f32_val(dyt, row, col + 1) : 0.f;
          frag_put<NF>(af, kk, rr, v0 * e2[rr & 1], v1 * e2[rr & 1]);
        }
      give(sdy);
      int sp[ND];
#pragma unroll
      for (int t = 0; t < ND; ++t) sp[t] = take();
      SSD_BT_LAP(1, 0, 2, tt);
      float qa[64];
      uint32_t bp[ND];
      slots_at<ND>(bp, ring_a, sp);
      wgmma_fence();
      mma_rs<NF, ND, ORD, 128>(qa, af, bp, true);
      mma_done(qa);
      fence_af(af);
#pragma unroll
      for (int t = 0; t < ND; ++t) give(sp[t]);
      // dy_i . y_inter_i = c_i . q_i into the row's dcsum terms; dc += q
      float iv[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < 16; ++t)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int idx = 4 * t + 2 * hh;
          const float2 cv = tile_pair<NI>(cpl, SPL, hh ? r1 : r0, 8 * t + 2 * q);
          iv[hh] += qa[idx] * cv.x + qa[idx + 1] * cv.y;
          dc[idx] += qa[idx];
          dc[idx + 1] += qa[idx + 1];
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        iv[hh] = quad_sum(iv[hh]);
        const int row = hh ? r1 : r0;
        if (q == 0 && row < nrow) A.ws_dcs[at * d.QP + i0 + row] += iv[hh];
      }
      SSD_BT_LAP(1, 0, 3, tt);
    }
    // dc += G_IJ b_J, G = the groups' G^T parts summed in order
    for (int J = 0; J <= I; ++J) {
      const float* gsrc = A.ws_g + (((long long)bi * d.nc + c) * npair +
                                    pair_idx(I, J)) * A.groups * GSLOT;
      uint32_t af[NF][4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int i = (rr & 1) ? r1 : r0;
          const int j = 16 * kk + 2 * q + 8 * (rr >> 1);
          float v0 = 0.f, v1 = 0.f;
          for (int g = 0; g < A.groups; ++g) {
            v0 += gsrc[g * GSLOT + j * T + i];
            v1 += gsrc[g * GSLOT + (j + 1) * T + i];
          }
          frag_put<NF>(af, kk, rr, v0, v1);
        }
      int sb[NI];
#pragma unroll
      for (int t = 0; t < NI; ++t) sb[t] = take();
      SSD_BT_LAP(1, 0, 2, tt);
      uint32_t bp[NI];
      slots_at<NI>(bp, ring_a, sb);
      wgmma_fence();
      mma_rs<NF, NI, ORD, 128>(dc, af, bp, false);
      mma_done(dc);
      fence_af(af);
#pragma unroll
      for (int t = 0; t < NI; ++t) give(sb[t]);
      SSD_BT_LAP(1, 0, 3, tt);
    }
    // db of the tile's rows summed over B3a's head groups, in order (f32
    // inputs: from its one group's part, too)
    if (A.groups > 1 || !Prec<Tin>::EXACT) {
      Tin* DB = static_cast<Tin*>(A.db) + ((long long)bi * a.S + s0 + i0) *
                                              a.ns;
      const float* src = A.ws_dbp + (((long long)bi * d.nc + c) * d.ntq + I) *
                                        A.groups * T * BWD_NS;
      for (int e = tid; e < nrow * a.ns && e < T * a.ns; e += NCW) {
        const int row = e / a.ns, col = e - row * a.ns;
        float v = 0.f;
        for (int g = 0; g < A.groups; ++g)
          v += src[((long long)g * T + row) * BWD_NS + col];
        store_val<Tin>(DB + e, v);
      }
    }
    Tin* DC = static_cast<Tin*>(A.dc) + ((long long)bi * a.S + s0 + i0) * a.ns;
#pragma unroll
    for (int t = 0; t < 16; ++t)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = hh ? r1 : r0, col = 8 * t + 2 * q;
        if (row >= nrow || col >= a.ns) continue;        // ns % 4 == 0
        store_pair<Tin>(DC + (long long)row * a.ns + col, dc[4 * t + 2 * hh],
                        dc[4 * t + 2 * hh + 1]);
      }
    mbar_arrive(iempty);                     // c_I is read
    SSD_BT_LAP(1, 0, 4, tt);
  }
}

// f32 inputs: x, b and c cut into NI = 3 bf16 planes in the workspace,
// x as (3, B, S, wx), b and c as (3, B, S, wb), rows zero-padded
__global__ void ssd_bwd_split_kernel(const BArgs A) {
  const Args& a = A.f;
  const long long rows = (long long)a.B * a.S;
  const long long nx = rows * A.wx, nb = rows * A.wb;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < nx + 2 * nb; e += (long long)gridDim.x * blockDim.x) {
    const float* src;
    long long idx, plane, sb, ss;
    int width, ncol;
    bf16* dst;
    if (e < nx) {
      idx = e, plane = nx, width = A.wx, ncol = a.nh * a.hd;
      src = static_cast<const float*>(a.x), sb = a.x_sb, ss = a.x_ss;
      dst = A.ws_pl;
    } else if (e < nx + nb) {
      idx = e - nx, plane = nb, width = A.wb, ncol = a.ns;
      src = static_cast<const float*>(a.b), sb = a.b_sb, ss = a.b_ss;
      dst = A.ws_pl + 3 * nx;
    } else {
      idx = e - nx - nb, plane = nb, width = A.wb, ncol = a.ns;
      src = static_cast<const float*>(a.c), sb = a.c_sb, ss = a.c_ss;
      dst = A.ws_pl + 3 * nx + 3 * nb;
    }
    const long long r = idx / width;
    const int col = (int)(idx - r * width);
    const int bi = (int)(r / a.S), s = (int)(r - (long long)bi * a.S);
    float v = col < ncol ? src[bi * sb + s * ss + col] : 0.f;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const bf16 hv = __float2bfloat16_rn(v);
      dst[t * plane + idx] = hv;
      v -= __bfloat162float(hv);
    }
  }
}

// --- B4, B5: the reverse cumsum, ddt and da_log ------------------------------

__global__ void ssd_bwd_finish_kernel(const BArgs A) {
  const Args& a = A.f;
  const Dims d(a.S, a.hd, a.ns, a.chunk);
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)a.B * d.nc * a.nh) return;
  const int h = (int)(idx % a.nh), c = (int)((idx / a.nh) % d.nc);
  const int bi = (int)(idx / ((long long)a.nh * d.nc));
  const long long s0 = (long long)c * d.Q;
  const int n = (int)(a.S - s0 < d.Q ? a.S - s0 : d.Q);
  const float* dlj = A.ws_dlj + idx * d.ntq;
  const int parts = pass_parts(a.hd, a.ns);
  float run = 0.f;
  for (int w = 0; w < parts; ++w) run += A.ws_dlr[idx * parts + w];
  for (int J = 0; J * T < n; ++J) run += dlj[J];
  const float Aa = -expf(a.a_log[h]);
  const float* dcs = A.ws_dcs + idx * d.QP;
  const float* zr = A.ws_zr + idx * n_off(d.ntq) * T;
  const float* dtv = a.ws_dt + idx * d.QP;
  float sum = 0.f;
  for (int t = n - 1; t >= 0; --t) {
    const int I = t / T;
    float z = 0.f;          // Z's row sums over the column tiles left of I
    for (int J = 0; J < I; ++J) z += zr[off_idx(I, J) * T + t % T];
    run += dcs[t] + z;
    float* o = A.ddt + ((long long)bi * a.S + s0 + t) * a.nh + h;
    *o = fmaf(Aa, run, *o);
    sum = fmaf(run, dtv[t], sum);
  }
  A.ws_dda[idx] = sum;
}

__global__ void ssd_bwd_da_kernel(const BArgs A) {
  const Args& a = A.f;
  const Dims d(a.S, a.hd, a.ns, a.chunk);
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= a.nh) return;
  float s = 0.f;
  for (long long r = 0; r < (long long)a.B * d.nc; ++r)
    s += A.ws_dda[r * a.nh + h];
  A.da_log[h] = s * -expf(a.a_log[h]);
}

// The backward's plan as kernels/ssd_scan.py::plan_bwd gives it
// (BwdPlan.c_plan): the forward's plan for F1 and F2, then 48 int64.
struct BwdPlan {
  Plan fwd;
  long long grid[7][3];   // split (f32), B1, B2, B3a, B3b, B4, B5
  long long threads[7];
  long long smem[7];
  long long ws[8];        // floats: fin / G^T, dcs, zr, dlj, dlr, dda,
                          // db parts, input planes
  long long groups;       // B3a's head groups
  long long hpg;          // heads a group
  long long hstages;      // B3a's head stages
  long long wx;           // row widths of the f32 inputs' planes
  long long wb;
};
static_assert(sizeof(BwdPlan) == (22 + 48) * sizeof(long long),
              "bwd plan layout");

template <typename Tin>
bool valid_bwd(const BArgs& A, const BwdPlan& p, long long ws_bytes) {
  const Args& a = A.f;
  const Dims d(a.S, a.hd, a.ns, a.chunk);
  constexpr int ni = Prec<Tin>::NI, nf = BPrec<Tin>::N;
  const bool f32 = !Prec<Tin>::EXACT;
  if (a.hd > BWD_HD || a.ns > BWD_NS || d.ntq > BWD_NTQ ||
      p.threads[1] != NTB || p.threads[2] != NTP2 || p.threads[3] != NTK ||
      p.threads[4] != NTK)
    return false;
  for (int k = 0; k < 7; k += k == 0 ? 5 : 1)   // split, B4, B5
    if (p.threads[k] < 1 || p.threads[k] > 1024) return false;
  if (p.groups < 1 || p.hpg < 1 || p.groups * p.hpg < a.nh ||
      (p.groups - 1) * p.hpg >= a.nh || p.hstages < 1 || p.hstages > 2)
    return false;
  if (p.smem[1] < bwd_dstate_bytes(d.QP, d.NSP, ni, nf) ||
      p.smem[3] < bwd_cols_bytes(ni, nf, (int)p.hstages) ||
      p.smem[4] < bwd_rows_bytes(ni) || p.smem[0] != 0 || p.smem[2] != 0 ||
      p.smem[5] != 0 || p.smem[6] != 0)
    return false;
  for (int k = 0; k < 7; ++k) {
    if (p.smem[k] < 0 || p.smem[k] > MAX_SMEM || p.grid[k][0] < 1 ||
        p.grid[k][0] > 0x7fffffff)
      return false;
    for (int i = 1; i < 3; ++i)
      if (p.grid[k][i] < 1 || p.grid[k][i] > 65535) return false;
  }
  const int ntl = (a.S - (d.nc - 1) * d.Q + T - 1) / T;
  if (p.grid[3][0] > col_items(a.B, d.nc, d.ntq, ntl, (int)p.groups) ||
      p.grid[4][0] > (long long)a.B * ((d.nc - 1) * d.ntq + ntl) ||
      p.grid[3][1] != 1 || p.grid[3][2] != 1 || p.grid[4][1] != 1 ||
      p.grid[4][2] != 1)
    return false;
  const long long heads = (long long)a.B * d.nc * a.nh;
  const long long gfl = (long long)a.B * d.nc * n_pairs(d.ntq) * p.groups *
                        GSLOT;
  const long long fin = (long long)a.B * a.nh * a.hd * a.ns;
  if (p.wx < a.nh * a.hd || p.wb < a.ns || p.wx % 8 || p.wb % 8) return false;
  const long long rows = (long long)a.B * a.S;
  const long long need[8] = {
      fin > gfl ? fin : gfl, heads * d.QP, heads * n_off(d.ntq) * T,
      heads * d.ntq, heads * pass_parts(a.hd, a.ns), heads,
      p.groups > 1 || f32
          ? (long long)a.B * d.nc * d.ntq * p.groups * T * BWD_NS
          : 0,
      f32 ? 3 * rows * (p.wx + 2 * p.wb) / 2 : 0};
  long long total = 0;
  for (long long f : p.fwd.ws) total += 4 * f;
  for (int k = 0; k < 8; ++k) {
    if (p.ws[k] < need[k] || p.ws[k] % 4 != 0) return false;
    total += 4 * p.ws[k];
  }
  return total <= ws_bytes;
}

template <typename K>
int launch_smem(K kernel, dim3 grid, int threads, long long smem,
                cudaStream_t st, const BArgs& A) {
  if (smem > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, (int)smem, st>>>(A);
  return (int)cudaGetLastError();
}

inline dim3 bgrid(const BwdPlan& p, int k) {
  return dim3((unsigned)p.grid[k][0], (unsigned)p.grid[k][1],
              (unsigned)p.grid[k][2]);
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

// A tensor of `rank` dims (dims[0] contiguous; strides in bytes of dims
// 1..), read in `box` tiles with the 128-byte swizzle; out-of-range
// elements read as zero
bool swz_map(CUtensorMap* map, bool f32, const void* ptr, int rank,
             const cuuint64_t* dims, const cuuint64_t* strides,
             const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_fn();
  if (!fn) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return fn(map,
            f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            rank, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// An input (x: width nh hd; b, c: width ns) as NI bf16 planes of rows:
// the bf16 input itself (its batch and sequence strides, which must be
// 16-byte multiples) or the f32 input's planes in the workspace
bool input_map(CUtensorMap* map, const void* ptr, int ni, long long width,
               long long S, long long B, long long ss, long long sb,
               long long plane) {
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)S, (cuuint64_t)B,
                              (cuuint64_t)ni};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sb * 2,
                                 (cuuint64_t)plane * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  return swz_map(map, false, ptr, 4, dims, strides, box);
}

template <typename Tin>
int launch_bwd(BArgs A, const BwdPlan& p, void* ws, long long ws_bytes,
               cudaStream_t st) {
  constexpr int NI = Prec<Tin>::NI, ND = Prec<Tin>::ND;
  Args& a = A.f;
  if (!valid(a, p.fwd, ws, ws_bytes) || !valid_bwd<Tin>(A, p, ws_bytes))
    return (int)cudaErrorInvalidValue;
  a.hg = (int)p.fwd.hg;
  a.ws_state = static_cast<float*>(ws);
  a.ws_cb = a.ws_state + p.fwd.ws[0];
  a.ws_cs = a.ws_cb + p.fwd.ws[1];
  a.ws_dt = a.ws_cs + p.fwd.ws[2];
  a.ws_sp = reinterpret_cast<bf16*>(a.ws_dt + p.fwd.ws[3]);
  float* more = a.ws_dt + p.fwd.ws[3] + p.fwd.ws[4];
  a.fin = more;                 // F2's final state, dead before B3a
  A.ws_g = more;                // writes G^T over it
  A.ws_dcs = more + p.ws[0];
  A.ws_zr = A.ws_dcs + p.ws[1];
  A.ws_dlj = A.ws_zr + p.ws[2];
  A.ws_dlr = A.ws_dlj + p.ws[3];
  A.ws_dda = A.ws_dlr + p.ws[4];
  A.ws_dbp = A.ws_dda + p.ws[5];
  A.ws_pl = reinterpret_cast<bf16*>(A.ws_dbp + p.ws[6]);
  A.groups = (int)p.groups;
  A.hpg = (int)p.hpg;
  A.hstages = (int)p.hstages;
  A.wx = (int)p.wx;
  A.wb = (int)p.wb;
  const int E = (int)sizeof(Tin);
  auto al = [](const void* ptr) { return (uintptr_t)ptr % 16 == 0; };
  a.vec_x = al(a.x) && (a.x_sb * E) % 16 == 0 && (a.x_ss * E) % 16 == 0 &&
            (a.hd * E) % 16 == 0;
  a.vec_b = al(a.b) && (a.b_sb * E) % 16 == 0 && (a.b_ss * E) % 16 == 0;
  a.vec_c = al(a.c) && (a.c_sb * E) % 16 == 0 && (a.c_ss * E) % 16 == 0;
  a.vec_init = a.init != nullptr && al(a.init);
  const Dims d(a.S, a.hd, a.ns, a.chunk);

  // the tensor maps of B3a and B3b
  CUtensorMap tx, tb, tc, tdy, tcb, tp;
  const long long rows = (long long)a.B * a.S;
  bool ok;
  if (Prec<Tin>::EXACT) {
    ok = al(a.x) && al(a.b) && al(a.c) &&
         input_map(&tx, a.x, 1, (long long)a.nh * a.hd, a.S, a.B, a.x_ss,
                   a.x_sb, a.x_sb * a.B) &&
         input_map(&tb, a.b, 1, a.ns, a.S, a.B, a.b_ss, a.b_sb,
                   a.b_sb * a.B) &&
         input_map(&tc, a.c, 1, a.ns, a.S, a.B, a.c_ss, a.c_sb, a.c_sb * a.B);
  } else {
    const bf16* xp = A.ws_pl;
    const bf16* bp = xp + 3 * rows * A.wx;
    const bf16* cp = bp + 3 * rows * A.wb;
    ok = input_map(&tx, xp, NI, (long long)a.nh * a.hd, a.S, a.B, A.wx,
                   (long long)a.S * A.wx, rows * A.wx) &&
         input_map(&tb, bp, NI, a.ns, a.S, a.B, A.wb, (long long)a.S * A.wb,
                   rows * A.wb) &&
         input_map(&tc, cp, NI, a.ns, a.S, a.B, A.wb, (long long)a.S * A.wb,
                   rows * A.wb);
  }
  {
    const cuuint64_t ydims[3] = {(cuuint64_t)a.nh * a.hd, (cuuint64_t)a.S,
                                 (cuuint64_t)a.B};
    const cuuint64_t ystr[2] = {(cuuint64_t)a.nh * a.hd * 4,
                                (cuuint64_t)a.S * a.nh * a.hd * 4};
    const cuuint32_t fbox[3] = {32, 64, 1};
    const cuuint64_t cdims[2] = {(cuuint64_t)d.QP,
                                 (cuuint64_t)a.B * d.nc * d.QP};
    const cuuint64_t cstr[1] = {(cuuint64_t)d.QP * 4};
    const cuuint64_t pdims[3] = {(cuuint64_t)a.ns, (cuuint64_t)a.hd,
                                 (cuuint64_t)a.B * d.nc * a.nh * ND};
    const cuuint64_t pstr[2] = {(cuuint64_t)d.NSP * 2,
                                (cuuint64_t)a.hd * d.NSP * 2};
    const cuuint32_t pbox[3] = {64, 64, 1};
    ok = ok && al(A.dy) && swz_map(&tdy, true, A.dy, 3, ydims, ystr, fbox) &&
         swz_map(&tcb, true, a.ws_cb, 2, cdims, cstr, fbox) &&
         swz_map(&tp, false, a.ws_sp, 3, pdims, pstr, pbox);
  }
  if (!ok) return (int)cudaErrorInvalidValue;

  const bool two = (d.HDP / 16) * ((d.NSP + 63) / 64) > 8;
  int rc = two ? launch_states<Tin, 2>(a, p.fwd, st)
               : launch_states<Tin, 1>(a, p.fwd, st);
  if (rc != 0) return rc;
  ssd_scan_pass_kernel<Tin><<<grid_of(p.fwd, 1), NT2, 0, st>>>(a);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  if (!Prec<Tin>::EXACT) {
    rc = launch_smem(ssd_bwd_split_kernel, bgrid(p, 0), (int)p.threads[0], 0,
                     st, A);
    if (rc != 0) return rc;
  }
  rc = launch_smem(ssd_bwd_dstate_kernel<Tin>, bgrid(p, 1), NTB, p.smem[1],
                   st, A);
  if (rc != 0) return rc;
  rc = launch_smem(ssd_bwd_pass_kernel<Tin>, bgrid(p, 2), NTP2, 0, st, A);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_cols_kernel<Tin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem[3]);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_cols_kernel<Tin><<<bgrid(p, 3), NTK, (int)p.smem[3], st>>>(
      tx, tb, tc, tdy, tcb, A);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  err = cudaFuncSetAttribute(ssd_bwd_rows_kernel<Tin>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p.smem[4]);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_rows_kernel<Tin><<<bgrid(p, 4), NTK, (int)p.smem[4], st>>>(
      tdy, tp, tc, tb, A);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  rc = launch_smem(ssd_bwd_finish_kernel, bgrid(p, 5), (int)p.threads[5], 0,
                   st, A);
  if (rc != 0) return rc;
  return launch_smem(ssd_bwd_da_kernel, bgrid(p, 6), (int)p.threads[6], 0, st,
                     A);
}

}  // namespace

#define SSD_ENTRY(name, type)                                                 \
  extern "C" int name(const void* x, const float* dt, const float* a_log,     \
                      const void* b, const void* c, const float* init,        \
                      float* y, float* fin, int B, int S, int nh, int hd,     \
                      int ns, int chunk, long long x_sb, long long x_ss,      \
                      long long b_sb, long long b_ss, long long c_sb,         \
                      long long c_ss, const long long* plan, void* ws,        \
                      long long ws_bytes, void* stream) {                     \
    if (plan == nullptr) return (int)cudaErrorInvalidValue;                   \
    Args a{};                                                                 \
    a.x = x;                                                                  \
    a.dt = dt;                                                                \
    a.a_log = a_log;                                                          \
    a.b = b;                                                                  \
    a.c = c;                                                                  \
    a.init = init;                                                            \
    a.y = y;                                                                  \
    a.fin = fin;                                                              \
    a.B = B;                                                                  \
    a.S = S;                                                                  \
    a.nh = nh;                                                                \
    a.hd = hd;                                                                \
    a.ns = ns;                                                                \
    a.chunk = chunk;                                                          \
    a.x_sb = x_sb;                                                            \
    a.x_ss = x_ss;                                                            \
    a.b_sb = b_sb;                                                            \
    a.b_ss = b_ss;                                                            \
    a.c_sb = c_sb;                                                            \
    a.c_ss = c_ss;                                                            \
    return launch<type>(a, *reinterpret_cast<const Plan*>(plan), ws,          \
                        ws_bytes, static_cast<cudaStream_t>(stream));         \
  }

SSD_ENTRY(ssd_scan_bf16, __nv_bfloat16)
SSD_ENTRY(ssd_scan_f32, float)

#define SSD_BWD_ENTRY(name, type)                                             \
  extern "C" int name(                                                        \
      const void* x, const float* dt, const float* a_log, const void* b,      \
      const void* c, const float* init, const float* dy, const float* dfin,   \
      void* dx, float* ddt, float* da_log, void* db, void* dc, int B, int S,  \
      int nh, int hd, int ns, int chunk, long long x_sb, long long x_ss,      \
      long long b_sb, long long b_ss, long long c_sb, long long c_ss,         \
      const long long* plan, void* ws, long long ws_bytes, void* stream) {    \
    if (plan == nullptr || ws == nullptr) return (int)cudaErrorInvalidValue;  \
    BArgs A{};                                                                \
    A.f.x = x;                                                                \
    A.f.dt = dt;                                                              \
    A.f.a_log = a_log;                                                        \
    A.f.b = b;                                                                \
    A.f.c = c;                                                                \
    A.f.init = init;                                                          \
    A.f.B = B;                                                                \
    A.f.S = S;                                                                \
    A.f.nh = nh;                                                              \
    A.f.hd = hd;                                                              \
    A.f.ns = ns;                                                              \
    A.f.chunk = chunk;                                                        \
    A.f.x_sb = x_sb;                                                          \
    A.f.x_ss = x_ss;                                                          \
    A.f.b_sb = b_sb;                                                          \
    A.f.b_ss = b_ss;                                                          \
    A.f.c_sb = c_sb;                                                          \
    A.f.c_ss = c_ss;                                                          \
    A.dy = dy;                                                                \
    A.dfin = dfin;                                                            \
    A.dx = dx;                                                                \
    A.ddt = ddt;                                                              \
    A.da_log = da_log;                                                        \
    A.db = db;                                                                \
    A.dc = dc;                                                                \
    return launch_bwd<type>(A, *reinterpret_cast<const BwdPlan*>(plan), ws,   \
                            ws_bytes, static_cast<cudaStream_t>(stream));     \
  }

SSD_BWD_ENTRY(ssd_scan_bwd_bf16, __nv_bfloat16)
SSD_BWD_ENTRY(ssd_scan_bwd_f32, float)

#ifdef SSD_TRACE
// the stamps of pass k (0: states, 1: chunk scan), 8192 blocks x 32
extern "C" int ssd_trace_read(void* dst, int k) {
  return (int)cudaMemcpyFromSymbol(dst, g_ssd_trace,
                                   sizeof(unsigned long long) << 18,
                                   k * (sizeof(unsigned long long) << 18));
}
extern "C" int ssd_trace_clear() {
  static unsigned long long zero[2 << 18];
  cudaError_t e = cudaMemcpyToSymbol(g_ssd_trace, zero, sizeof(zero));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(g_ssd_btrace, zero,
                                 sizeof(g_ssd_btrace));
}
// the backward's chunk-term kernel k's block sums, 8192 blocks x 8
extern "C" int ssd_btrace_read(void* dst, int k) {
  return (int)cudaMemcpyFromSymbol(dst, g_ssd_btrace,
                                   sizeof(unsigned long long) * 8192 * 8,
                                   k * sizeof(unsigned long long) * 8192 * 8);
}
#endif
