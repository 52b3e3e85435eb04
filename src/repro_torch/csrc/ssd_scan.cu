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
#else
#define SSD_STAMP(K, P) \
  do {                  \
  } while (0)
#define SSD_STAMP_ALL(K, P) SSD_STAMP(K, P)
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
//   dCB_ij = (dy_i . xd_j) L_ij, summed over heads:
//   dc = dCB b + sum_h e dy P,  db = dCB^T c + sum_h w xd D
//   dcsum_i = sum_j Z_ij - sum_j Z_ji + dy_i . y_inter_i - w_i xd_i . D b_i,
//     Z = dCB_h * CB, plus dlast = sum_j w_j xd_j . D b_j + exp(last) <D, P>
//     at the chunk's last row; dA = reverse cumsum of dcsum,
//   ddt = a dA + dxd . x,  dx = dt dxd,  da_log = a sum dA dt.
//
// Passes (nine kernels a call, in stream order):
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
//     warp, summed by B4 in a fixed order.
//  B3. ssd_bwd_chunk_kernel, grid (row tiles, chunks, B), launched once a
//     role (each role at most 128 registers: two blocks an SM, no spill;
//     one kernel of all three roles spilled at that cap), 8 warps: warp w
//     takes rows 16 (w % 4) of the 64-row tile and half w / 4 of each
//     product's columns; the S1 tiles go in two halves of 32 columns.  A dx block (tile J) walks the
//     heads: the inter and state terms of its rows, then the row tiles
//     I >= J: S1 = x_J dy_I^T (times dt_j), dxd_J += (CB L)^T dy_I with the
//     product's A operand kept in registers; it writes dx, dxd . x (into
//     ddt) and its rows' dcsum terms per head.  A db block (tile J) walks
//     the heads: db_J += (x dt w)_J D + (S1 L^T) c_I.  A row block (tile I)
//     walks the heads: dc_I += e dy_I P, then for J <= I dCB = (dy_I
//     xd_J^T) L, dc_I += dCB b_J and the row sums of Z.  db and dc sum the
//     heads in registers in head order: no partials, no atomics.
//  B4. ssd_bwd_finish_kernel, a thread a (b, chunk, head): dlast, the reverse
//     cumsum over the chunk's rows, ddt += a dA, and sum dA dt.
//  B5. ssd_bwd_da_kernel, a thread a head: da_log = a sum over (b, chunk).
//
// Every product is mma.sync m16n8k16 on the forward's bf16-term scheme: an
// fp32 operand (dy, D, P, the products' factors) is cut into N bf16 terms
// (2 with bf16 inputs, 3 with f32 inputs), an input operand (x, b, c) into
// Prec<Tin>::NI (1: exact bf16; 3 for f32), and the term pairs whose indices
// sum to at most N - 1 are summed in fp32.  Each tile is held in shared
// memory as its bf16-term planes (an exact bf16 input copied by cp.async,
// an fp32 one cut once as it is loaded) and read by ldmatrix, as the
// forward's tiles; a product's A operand made in registers (S1 L^T, CB L)
// is cut there.  The backward takes head dim <= 64 (one 64-wide tile) and
// state <= 128.
//
// Bound on an H100 at the training shape (8, 4096, 80, 64), state 128,
// chunk 256: the inputs (bf16 x, b, c; fp32 dt, dy) and outputs (bf16 dx,
// db, dc; fp32 ddt) are about 1.40 GB, 0.42 ms at 3.35 TB/s; the least
// products (the chunk-parallel form, causal halves not counted) about
// 0.35 TFLOP, 0.35 ms at 989 TFLOP/s.  This first design is far from that
// (PERF.md): every block walks the heads in turn, each head's tiles loaded
// and waited for before its products, with no load in flight behind them.

constexpr int NTB = 128;        // threads of the dstate blocks
constexpr int NTC = 256;        // threads of the chunk blocks
constexpr int NTP2 = 256;       // threads of the backward state pass
constexpr int BWD_HD = 64;      // head dims the backward takes (one tile)

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
  float* ws_dcs;     // (B, nc, nh, QP): a column block's dcsum terms
  float* ws_dcr;     // (B, nc, nh, QP): a row block's
  float* ws_dlj;     // (B, nc, nh, ntq): sum_j w_j xd_j . D b_j of tile J
  float* ws_dlr;     // (B, nc, nh, pass_parts): parts of exp(last) <D, P>
  float* ws_dda;     // (B, nc, nh): sum dA dt of the chunk
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

// acc += A B over 32 columns of A from column k0, A the warp's 16 x 32 in
// registers in the accumulator layout (4 n8 tiles: the A-fragment layout of
// two k16 steps) cut into NA terms, B planes stored [k][n]
template <int NA, int NB, int ORD, int NT>
__device__ __forceinline__ void reg_mm(float (&acc)[NT][4],
                                       const float (&A)[4][4], const bf16* b,
                                       int pb, int ldb, int k0, int n0,
                                       int nt, int lane) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t t0[NA], t1[NA], t2[NA], t3[NA], af[NA][4];
    split2<NA>(A[2 * kk][0], A[2 * kk][1], t0);
    split2<NA>(A[2 * kk][2], A[2 * kk][3], t1);
    split2<NA>(A[2 * kk + 1][0], A[2 * kk + 1][1], t2);
    split2<NA>(A[2 * kk + 1][2], A[2 * kk + 1][3], t3);
#pragma unroll
    for (int u = 0; u < NA; ++u) {
      af[u][0] = t0[u];
      af[u][1] = t1[u];
      af[u][2] = t2[u];
      af[u][3] = t3[u];
    }
#pragma unroll
    for (int t = 0; t < NT; t += 2) {
      if (t >= nt) continue;
      uint32_t b0[NB][2], b1[NB][2];
      ld_b<NB>(b0, b1, b, pb, b_kn(lane, k0 + 16 * kk, n0 + 8 * t, ldb),
               true);
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

// bytes of n bf16 planes of a 64-row tile of `cols` columns
__host__ __device__ constexpr int pl_bytes(int n, int cols) {
  return 2 * n * T * (cols + LDX);
}
// row stride of an fp32 tile
__host__ __device__ constexpr int ld_f(int cols) { return cols + 4; }

// bytes of the backward's shared memory: the dstate block (exp(csum), e dy
// and c as planes), and a chunk block, the largest of its roles.  A chunk
// block's fp32 head holds csum, dt, a row vector, the halves' row sums and
// the slabs' dlast parts; then a dx block x_J and its phases (c_J, P, dy_J;
// b_J, D; dy_I, CB), a db block x_J, x_J dt w and its phases (D; dy_I,
// c_I), or a row block dy_I, e dy_I and its phases (P; x_J, b_J, CB).  Input
// tiles take NI planes, fp32 ones (dy, D, P) NF.
__host__ __device__ inline int bwd_dstate_bytes(int QP, int NSP, int ni,
                                                int nf) {
  return 4 * QP + pl_bytes(nf, BWD_HD) + pl_bytes(ni, NSP);
}
__host__ __device__ inline int bwd_chunk_bytes(int QP, int NSP, int ni,
                                               int nf) {
  const int cb = 4 * T * ld_f(T);
  const int xi = pl_bytes(ni, BWD_HD), xf = pl_bytes(nf, BWD_HD);
  const int si = pl_bytes(ni, NSP), sf = pl_bytes(nf, NSP);
  const int m1 = si + sf + xf, m2 = si + sf, m3 = xf + cb;
  const int dx = xi + (m1 > m2 ? (m1 > m3 ? m1 : m3) : (m2 > m3 ? m2 : m3));
  const int db = xi + xf + (sf > xf + si ? sf : xf + si);
  const int row = 2 * xf + (sf > xi + si + cb ? sf : xi + si + cb);
  const int most = dx > db ? (dx > row ? dx : row) : (db > row ? db : row);
  return 4 * (2 * QP + 6 * T) + most;
}

// a value of a tile held as N bf16 planes: the sum of its terms
template <int N>
__device__ __forceinline__ float plane_val(const bf16* pl, int plane,
                                           int off) {
  float v = 0.f;
#pragma unroll
  for (int t = N - 1; t >= 0; --t) v += __bfloat162float(pl[t * plane + off]);
  return v;
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

// the warp's accumulator element e (0..3) of n8 tile t: row, column
__device__ __forceinline__ int acc_row(int m0, int lane, int e) {
  return m0 + (lane >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int t, int lane, int e) {
  return 8 * t + 2 * (lane & 3) + (e & 1);
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

// partial sums of exp(last) <D, P> a (b, chunk, head): one a warp of each
// block of the pass
__host__ __device__ inline int pass_parts(int hd, int ns) {
  return (hd * ns + 4 * NTP2 - 1) / (4 * NTP2) * (NTP2 / 32);
}

// grid (hd ns / 1024, nh, B), a float4 of the state a thread, as the
// forward's pass
template <typename Tin>
__global__ void __launch_bounds__(NTP2) ssd_bwd_pass_kernel(const BArgs A) {
  constexpr int ND = Prec<Tin>::ND;
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
  const int part = blockIdx.x * (NTP2 / 32) + (threadIdx.x >> 5);
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live && A.dfin != nullptr)
    g = *reinterpret_cast<const float4*>(A.dfin + head * hdns + e);
  for (int c = d.nc - 1; c >= 0; --c) {
    const long long at = ((long long)bi * d.nc + c) * a.nh + h;
    const float dec = expf(a.ws_cs[at * d.QP + d.QP - 1]);
    float dot = 0.f;
    if (live) {
      float* st = a.ws_state + at * hdns + e;
      const float4 sy = *reinterpret_cast<const float4*>(st);
      *reinterpret_cast<float4*>(st) = g;
      const bf16* sp = a.ws_sp + (at * ND * a.hd + p) * d.NSP + k;
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int t = ND - 1; t >= 0; --t) {
        const uint2 u = *reinterpret_cast<const uint2*>(
            sp + (long long)t * a.hd * d.NSP);
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.y));
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
    if ((threadIdx.x & 31) == 0) A.ws_dlr[at * parts + part] = dec * dot;
  }
}

// --- B3: the chunk terms ------------------------------------------------------
//
// 8 warps: warp w takes rows 16 (w % 4) of the 64-row tile and half w / 4 of
// each product's columns (head dims, or state columns); the two halves of a
// row slab both form its S1 tile, the A operand of the next products, and
// sum their halves of a row's dot products through shared memory.

// n8 tiles [t0, t0 + nt) of `total` that half `half` of a row slab takes
struct Cols {
  int n0, nt;
  __device__ Cols(int total, int half) {
    const int per = (total + 1) / 2, t0 = half * per;
    n0 = 8 * t0;
    nt = total - t0 < per ? (total - t0 > 0 ? total - t0 : 0) : per;
  }
};

// a column block of tile J: with DB its db (summed over the heads), else
// per head its dx, its part of ddt, its rows' dcsum terms and dlast part
template <typename Tin, bool DB>
__device__ __forceinline__ void bwd_columns(const BArgs& A, const Dims& d,
                                            int J, int c, int bi, int n,
                                            char* sm) {
  constexpr int NI = Prec<Tin>::NI, NF = BPrec<Tin>::N;
  constexpr int ORD = BPrec<Tin>::ORD;
  const Args& a = A.f;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slab = warp & 3, half = warp >> 2, m0 = 16 * slab, j0 = J * T;
  const Cols pc(BWD_HD / 8, half), kc(d.NSP / 8, half);
  const int LX = BWD_HD + LDX, PX = T * LX, LB = d.NSP + LDX, PB = T * LB;
  const int LC = ld_f(T);
  const long long s0 = (long long)c * d.Q;
  float* cs = reinterpret_cast<float*>(sm);   // [QP] csum of the head
  float* dv = cs + d.QP;                      // [QP] dt
  float* rw = dv + d.QP;                      // [T] dt_j w_j of the rows
  float* red = rw + T;                        // [2][2][T] halves' row sums
  float* wsum = red + 4 * T;                  // [T] slabs' dlast parts
  bf16* xs = reinterpret_cast<bf16*>(wsum + T);   // NI x [T][LX] x_J
  bf16* U = xs + NI * PX;
  // dx blocks: phase 1a c_J, P, dy_J; phase 1b b_J, D; phase 2 dy_I, CB
  // db blocks: x_J dt w; phase 1b D; phase 2 dy_I, c_I
  bf16* xw = U;                               // NF x [T][LX]
  bf16* V = DB ? U + NF * PX : U;
  bf16* cj = V;                               // NI x [T][LB]
  bf16* Ps = cj + NI * PB;                    // NF x [64][LB]
  bf16* dyj = Ps + NF * PB;                   // NF x [T][LX]
  bf16* bs = V;                               // NI x [T][LB]
  bf16* Ds = DB ? V : bs + NI * PB;           // NF x [64][LB]
  bf16* dyi = V;                              // NF x [T][LX]
  bf16* ci = dyi + NF * PX;                   // NI x [T][LB]
  float* cbt = reinterpret_cast<float*>(ci);  // [T][LC] (dx blocks)
  const int nI = (n + T - 1) / T;
  const long long rs_y = (long long)a.nh * a.hd;
  const bool vdy = vec_dy(A);
  // this chunk's rows of the inputs, formed at each use (kept in no
  // register across the head loop)
  auto X = [&] { return static_cast<const Tin*>(a.x) + bi * a.x_sb +
                        s0 * a.x_ss; };
  auto Bm = [&] { return static_cast<const Tin*>(a.b) + bi * a.b_sb +
                         s0 * a.b_ss; };
  auto C = [&] { return static_cast<const Tin*>(a.c) + bi * a.c_sb +
                        s0 * a.c_ss; };
  auto DY = [&] { return A.dy + ((long long)bi * a.S + s0) * rs_y; };
  auto CB = [&] { return a.ws_cb + ((long long)bi * d.nc + c) * d.QP * d.QP; };
  const int r0 = acc_row(m0, lane, 0), r1 = r0 + 8;   // the lane's rows
  const bool quad0 = (lane & 3) == 0;
  // a row's sum over the head dims: this half's part (quad-summed) to
  // red[slot][half], then both halves in order
  auto row_sum = [&](int slot, float v0, float v1) {
    v0 = quad_sum(v0);
    v1 = quad_sum(v1);
    if (quad0) {
      red[(2 * slot + half) * T + r0] = v0;
      red[(2 * slot + half) * T + r1] = v1;
    }
  };
  auto both = [&](int slot, int r) {
    return red[2 * slot * T + r] + red[(2 * slot + 1) * T + r];
  };
  float db[8][4] = {};

  for (int h = 0; h < a.nh; ++h) {
    const long long at = ((long long)bi * d.nc + c) * a.nh + h;
    __syncthreads();                       // the last head is done with smem
    copy_async<float>(cs, 0, a.ws_cs + at * d.QP, 0, 1, d.QP, 1, d.QP, tid,
                      NTC);
    copy_async<float>(dv, 0, a.ws_dt + at * d.QP, 0, 1, d.QP, 1, d.QP, tid,
                      NTC);
    fill_input<Tin>(xs, PX, LX, X() + j0 * a.x_ss + (long long)h * a.hd,
                    a.x_ss, T, BWD_HD, n - j0, a.hd, a.vec_x, tid, NTC);
    if constexpr (!DB) {
      for (int t = 0; t < NF; ++t)
        copy_async<bf16>(Ps + t * PB, LB,
                         a.ws_sp + (at * NF + t) * a.hd * d.NSP, d.NSP,
                         BWD_HD, d.NSP, a.hd, d.NSP, tid, NTC);
      fill_input<Tin>(cj, PB, LB, C() + j0 * a.c_ss, a.c_ss, T, d.NSP, n - j0,
                      a.ns, a.vec_c, tid, NTC);
      load_planes<float, NF>(dyj, PX, LX, DY() + j0 * rs_y + (long long)h * a.hd,
                             rs_y, T, BWD_HD, n - j0, a.hd, vdy, nullptr, tid,
                             NTC);
    }
    tiles_landed();
    const float last = cs[d.QP - 1];
    for (int j = tid; j < T; j += NTC)
      rw[j] = dv[j0 + j] * expf(last - cs[j0 + j]);
    float v0 = 0.f, v1 = 0.f;
    if constexpr (!DB) {
      // the inter term's dcsum: e_j dy_j . (c_j P^T), this half's head dims
      float t4[4][4] = {};
      plane_mm<NI, NF, ORD, 4>(t4, cj, PB, LB, false, Ps, PB, LB, false, m0,
                               d.NSP, pc.n0, pc.nt, lane);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = t4[t][e] * plane_val<NF>(
              dyj, PX, acc_row(m0, lane, e) * LX + pc.n0 + acc_col(t, lane, e));
          if (e < 2) v0 += v; else v1 += v;
        }
      row_sum(0, v0, v1);
    }
    __syncthreads();                       // phase 1a and rw are done
    if constexpr (DB)
      load_planes<Tin, NF>(xw, PX, LX, X() + j0 * a.x_ss + (long long)h * a.hd,
                           a.x_ss, T, BWD_HD, n - j0, a.hd, a.vec_x, rw, tid,
                           NTC);
    else
      fill_input<Tin>(bs, PB, LB, Bm() + j0 * a.b_ss, a.b_ss, T, d.NSP, n - j0,
                      a.ns, a.vec_b, tid, NTC);
    load_planes<float, NF>(Ds, PB, LB, a.ws_state + at * a.hd * a.ns, a.ns,
                           T, d.NSP, a.hd, a.ns, true, nullptr, tid, NTC);
    tiles_landed();

    float dxd[4][4] = {};
    float dw0 = 0.f, dw1 = 0.f, dcs0 = 0.f, dcs1 = 0.f;
    if constexpr (DB) {
      // db_J += (x_J dt w) D, this half's state columns
      plane_mm<NF, NF, ORD, 8>(db, xw, PX, LX, false, Ds, PB, LB, true, m0,
                               BWD_HD, kc.n0, kc.nt, lane);
    } else {
      // the state term: u = b_J D^T; dxd = w u; dw_j w_j = rw_j x_j . u_j
      plane_mm<NI, NF, ORD, 4>(dxd, bs, PB, LB, false, Ds, PB, LB, false, m0,
                               d.NSP, pc.n0, pc.nt, lane);
      const float w0 = expf(last - cs[j0 + r0]);
      const float w1 = expf(last - cs[j0 + r1]);
      v0 = v1 = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = dxd[t][e] * plane_val<NI>(
              xs, PX, acc_row(m0, lane, e) * LX + pc.n0 + acc_col(t, lane, e));
          if (e < 2) v0 += v; else v1 += v;
          dxd[t][e] *= e < 2 ? w0 : w1;
        }
      row_sum(1, v0, v1);
      __syncthreads();                     // both halves' sums are in
      dw0 = both(1, r0) * rw[r0];
      dw1 = both(1, r1) * rw[r1];
      dcs0 = both(0, r0) * expf(cs[j0 + r0]) - dw0;
      dcs1 = both(0, r1) * expf(cs[j0 + r1]) - dw1;
    }

    if constexpr (!DB) {
      // this head's rows' dcsum terms so far and dlast part (the intra
      // terms' column sums are taken off below)
      float dls = quad0 ? dw0 + dw1 : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        dls += __shfl_xor_sync(0xffffffffu, dls, o);
      if (lane == 0 && half == 0) wsum[slab] = dls;
      if (half == 0 && quad0) {
        A.ws_dcs[at * d.QP + j0 + r0] = dcs0;
        A.ws_dcs[at * d.QP + j0 + r1] = dcs1;
      }
    }

    // the intra terms, row tiles I >= J, in two halves of 32 columns
    float zc0 = 0.f, zc1 = 0.f;
    for (int I = J; I < nI; ++I) {
      __syncthreads();                     // phase 1 / tile I - 1 is done
      load_planes<float, NF>(dyi, PX, LX, DY() + (long long)I * T * rs_y +
                                              (long long)h * a.hd,
                             rs_y, T, BWD_HD, n - I * T, a.hd, vdy, nullptr,
                             tid, NTC);
      if constexpr (DB)
        fill_input<Tin>(ci, PB, LB, C() + I * T * a.c_ss, a.c_ss, T, d.NSP,
                        n - I * T, a.ns, a.vec_c, tid, NTC);
      else
        copy_async<float>(cbt, LC, CB() + (long long)I * T * d.QP + j0, d.QP,
                          T, T, T, T, tid, NTC);
      tiles_landed();
      const float dt0 = dv[j0 + r0], dt1 = dv[j0 + r1];
      for (int part = 0; part < 2; ++part) {
        const int i0 = 32 * part;
        // S1^T = x_J dy_I^T (rows j, columns i0..i0 + 31), times dt_j below
        float t16[4][4] = {};
        plane_mm<NI, NF, ORD, 4>(t16, xs, PX, LX, false, dyi, PX, LX, false,
                                 m0, BWD_HD, i0, 4, lane);
        // L^T of the tile (rows j, columns i), 0 above the diagonal
        auto lmask = [&](int t, int e) {
          const int ig = I * T + i0 + acc_col(t, lane, e);
          const int jg = j0 + acc_row(m0, lane, e);
          return ig >= jg ? expf(cs[ig] - cs[jg]) : 0.f;
        };
        if constexpr (DB) {
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              t16[t][e] *= (e < 2 ? dt0 : dt1) * lmask(t, e);  // dCB^T
          reg_mm<NF, NI, ORD, 8>(db, t16, ci, PB, LB, i0, kc.n0, kc.nt,
                                 lane);
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float lm = lmask(t, e);
              const float cbv = cbt[(i0 + acc_col(t, lane, e)) * LC +
                                    acc_row(m0, lane, e)];
              const float z = t16[t][e] * (e < 2 ? dt0 : dt1) * lm * cbv;
              if (e < 2) zc0 += z; else zc1 += z;
              t16[t][e] = cbv * lm;        // (CB L)^T
            }
          reg_mm<NF, NF, ORD, 4>(dxd, t16, dyi, PX, LX, i0, pc.n0, pc.nt,
                                 lane);
        }
      }
    }
    if constexpr (DB) continue;

    // this head's rows: dx = dt dxd, ddt = dxd . x, the column sums
    Tin* DX = static_cast<Tin*>(A.dx) + ((long long)bi * a.S + s0) * rs_y +
              (long long)h * a.hd;
    v0 = v1 = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jr = acc_row(m0, lane, e), p = pc.n0 + acc_col(t, lane, e);
        const float v = dxd[t][e] * plane_val<NI>(xs, PX, jr * LX + p);
        if (e < 2) v0 += v; else v1 += v;
        if (t < pc.nt && j0 + jr < n && p < a.hd)
          store_val<Tin>(DX + (j0 + jr) * rs_y + p, dxd[t][e] * dv[j0 + jr]);
      }
    zc0 = quad_sum(zc0);
    zc1 = quad_sum(zc1);
    __syncthreads();                       // slot 0 of red is free again
    row_sum(0, v0, v1);
    __syncthreads();
    if (half == 0 && quad0) {
      // the same thread wrote these terms above
      A.ws_dcs[at * d.QP + j0 + r0] -= zc0;
      A.ws_dcs[at * d.QP + j0 + r1] -= zc1;
      float* dd = A.ddt + ((long long)bi * a.S + s0 + j0) * a.nh + h;
      if (j0 + r0 < n) dd[(long long)r0 * a.nh] = both(0, r0);
      if (j0 + r1 < n) dd[(long long)r1 * a.nh] = both(0, r1);
    }
    if (tid == 0)
      A.ws_dlj[at * d.ntq + J] = (wsum[0] + wsum[1]) + (wsum[2] + wsum[3]);
  }

  if constexpr (!DB) return;
  // db of the tile's rows, summed over the heads
  Tin* DBt = static_cast<Tin*>(A.db) + ((long long)bi * a.S + s0) * a.ns;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jr = acc_row(m0, lane, e), k = kc.n0 + acc_col(t, lane, e);
      if (t < kc.nt && j0 + jr < n && k < a.ns)
        store_val<Tin>(DBt + (long long)(j0 + jr) * a.ns + k, db[t][e]);
    }
}

template <typename Tin>
__device__ __forceinline__ void bwd_rows(const BArgs& A, const Dims& d, int I,
                                         int c, int bi, int n, char* sm) {
  constexpr int NI = Prec<Tin>::NI, NF = BPrec<Tin>::N;
  constexpr int ORD = BPrec<Tin>::ORD;
  const Args& a = A.f;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slab = warp & 3, half = warp >> 2, m0 = 16 * slab, i0 = I * T;
  const Cols kc(d.NSP / 8, half);
  const int LX = BWD_HD + LDX, PX = T * LX, LB = d.NSP + LDX, PB = T * LB;
  const int LC = ld_f(T);
  const long long s0 = (long long)c * d.Q;
  float* cs = reinterpret_cast<float*>(sm);   // [QP] csum of the head
  float* dv = cs + d.QP;                      // [QP] dt
  float* es = dv + d.QP;                      // [T] e_i of the rows
  bf16* dyi = reinterpret_cast<bf16*>(es + 6 * T);   // NF x [T][LX] dy_I
  bf16* dye = dyi + NF * PX;                  // NF x [T][LX] e dy_I
  bf16* U = dye + NF * PX;
  bf16* Ps = U;                               // phase 1: NF x [64][LB] P
  bf16* xs = U;                               // phase 2: x_J, b_J, CB_IJ
  bf16* bs = xs + NI * PX;
  float* cbt = reinterpret_cast<float*>(bs + NI * PB);
  const long long rs_y = (long long)a.nh * a.hd;
  const bool vdy = vec_dy(A);
  auto X = [&] { return static_cast<const Tin*>(a.x) + bi * a.x_sb +
                        s0 * a.x_ss; };
  auto Bm = [&] { return static_cast<const Tin*>(a.b) + bi * a.b_sb +
                         s0 * a.b_ss; };
  auto DY = [&] { return A.dy + ((long long)bi * a.S + s0) * rs_y; };
  auto CB = [&] { return a.ws_cb + ((long long)bi * d.nc + c) * d.QP * d.QP; };
  float dc[8][4] = {};

  for (int h = 0; h < a.nh; ++h) {
    const long long at = ((long long)bi * d.nc + c) * a.nh + h;
    __syncthreads();
    for (int i = tid; i < T; i += NTC)
      es[i] = expf(a.ws_cs[at * d.QP + i0 + i]);
    copy_async<float>(cs, 0, a.ws_cs + at * d.QP, 0, 1, d.QP, 1, d.QP, tid,
                      NTC);
    copy_async<float>(dv, 0, a.ws_dt + at * d.QP, 0, 1, d.QP, 1, d.QP, tid,
                      NTC);
    for (int t = 0; t < NF; ++t)
      copy_async<bf16>(Ps + t * PB, LB,
                       a.ws_sp + (at * NF + t) * a.hd * d.NSP, d.NSP, BWD_HD,
                       d.NSP, a.hd, d.NSP, tid, NTC);
    const float* dyh = DY() + i0 * rs_y + (long long)h * a.hd;
    load_planes<float, NF>(dyi, PX, LX, dyh, rs_y, T, BWD_HD, n - i0, a.hd,
                           vdy, nullptr, tid, NTC);
    __syncthreads();                       // es is in
    load_planes<float, NF>(dye, PX, LX, dyh, rs_y, T, BWD_HD, n - i0, a.hd,
                           vdy, es, tid, NTC);
    tiles_landed();
    // dc_I += (e dy_I) P, this half's state columns
    plane_mm<NF, NF, ORD, 8>(dc, dye, PX, LX, false, Ps, PB, LB, true, m0,
                             BWD_HD, kc.n0, kc.nt, lane);

    float zr0 = 0.f, zr1 = 0.f;
    for (int J = 0; J <= I; ++J) {
      __syncthreads();
      fill_input<Tin>(xs, PX, LX, X() + J * T * a.x_ss + (long long)h * a.hd,
                      a.x_ss, T, BWD_HD, n - J * T, a.hd, a.vec_x, tid, NTC);
      fill_input<Tin>(bs, PB, LB, Bm() + J * T * a.b_ss, a.b_ss, T, d.NSP,
                      n - J * T, a.ns, a.vec_b, tid, NTC);
      copy_async<float>(cbt, LC, CB() + (long long)i0 * d.QP + J * T, d.QP, T,
                        T, T, T, tid, NTC);
      tiles_landed();
      for (int part = 0; part < 2; ++part) {
        const int jp = 32 * part;
        // S1 = dy_I x_J^T (rows i, columns jp..jp + 31), times dt_j below
        float t16[4][4] = {};
        plane_mm<NF, NI, ORD, 4>(t16, dyi, PX, LX, false, xs, PX, LX, false,
                                 m0, BWD_HD, jp, 4, lane);
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ir = acc_row(m0, lane, e), jc = jp + acc_col(t, lane, e);
            const int ig = i0 + ir, jg = J * T + jc;
            const float lm = ig >= jg ? expf(cs[ig] - cs[jg]) * dv[jg] : 0.f;
            t16[t][e] *= lm;               // dCB
            const float z = t16[t][e] * cbt[ir * LC + jc];
            if (e < 2) zr0 += z; else zr1 += z;
          }
        reg_mm<NF, NI, ORD, 8>(dc, t16, bs, PB, LB, jp, kc.n0, kc.nt, lane);
      }
    }
    zr0 = quad_sum(zr0);
    zr1 = quad_sum(zr1);
    if (half == 0 && (lane & 3) == 0) {
      const long long hq = at * d.QP + i0;
      A.ws_dcr[hq + acc_row(m0, lane, 0)] = zr0;
      A.ws_dcr[hq + acc_row(m0, lane, 2)] = zr1;
    }
  }

  Tin* DC = static_cast<Tin*>(A.dc) + ((long long)bi * a.S + s0) * a.ns;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ir = acc_row(m0, lane, e), k = kc.n0 + acc_col(t, lane, e);
      if (t < kc.nt && i0 + ir < n && k < a.ns)
        store_val<Tin>(DC + (long long)(i0 + ir) * a.ns + k, dc[t][e]);
    }
}

// grid (row tiles, chunks, B), launched once a role: ROLE 0 the dx column
// blocks, 1 the db column blocks, 2 the row blocks; two blocks an SM at
// bf16 (128 registers); f32, off the training path, needs more registers
template <typename Tin, int ROLE>
__global__ void __launch_bounds__(NTC, Prec<Tin>::EXACT ? 2 : 1)
    ssd_bwd_chunk_kernel(const BArgs A) {
  extern __shared__ float4 smem4[];
  const Args& a = A.f;
  const Dims d(a.S, a.hd, a.ns, a.chunk);
  const int tile = blockIdx.x, c = blockIdx.y, bi = blockIdx.z;
  const long long s0 = (long long)c * d.Q;
  const int n = (int)(a.S - s0 < d.Q ? a.S - s0 : d.Q);
  if (c >= d.nc || bi >= a.B || tile >= d.ntq || tile * T >= n) return;
  char* sm = reinterpret_cast<char*>(smem4);
  if constexpr (ROLE == 0)
    bwd_columns<Tin, false>(A, d, tile, c, bi, n, sm);
  else if constexpr (ROLE == 1)
    bwd_columns<Tin, true>(A, d, tile, c, bi, n, sm);
  else
    bwd_rows<Tin>(A, d, tile, c, bi, n, sm);
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
  const float* dcr = A.ws_dcr + idx * d.QP;
  const float* dtv = a.ws_dt + idx * d.QP;
  float sum = 0.f;
  for (int t = n - 1; t >= 0; --t) {
    run += dcs[t] + dcr[t];
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
// (BwdPlan.c_plan): the forward's plan for F1 and F2, then 31 int64.
struct BwdPlan {
  Plan fwd;
  long long grid[5][3];   // B1 dstate, B2 pass, B3 chunk (a role), B4, B5
  long long threads[5];
  long long smem[5];
  long long ws[6];        // floats: fin, dcs, dcr, dlj, dlr, dda
};
static_assert(sizeof(BwdPlan) == (22 + 31) * sizeof(long long),
              "bwd plan layout");

template <typename Tin>
bool valid_bwd(const BArgs& A, const BwdPlan& p, long long ws_bytes) {
  const Args& a = A.f;
  const Dims d(a.S, a.hd, a.ns, a.chunk);
  if (a.hd > BWD_HD || p.threads[0] != NTB || p.threads[1] != NTP2 ||
      p.threads[2] != NTC || p.threads[3] < 1 || p.threads[3] > 1024 ||
      p.threads[4] < 1 || p.threads[4] > 1024 || p.smem[1] != 0 ||
      p.smem[3] != 0 || p.smem[4] != 0)
    return false;
  constexpr int ni = Prec<Tin>::NI, nf = BPrec<Tin>::N;
  if (p.smem[0] < bwd_dstate_bytes(d.QP, d.NSP, ni, nf) ||
      p.smem[2] < bwd_chunk_bytes(d.QP, d.NSP, ni, nf))
    return false;
  for (int k = 0; k < 5; ++k) {
    if (p.smem[k] < 0 || p.smem[k] > MAX_SMEM || p.grid[k][0] < 1 ||
        p.grid[k][0] > 0x7fffffff)
      return false;
    for (int i = 1; i < 3; ++i)
      if (p.grid[k][i] < 1 || p.grid[k][i] > 65535) return false;
  }
  long long need = 0;
  for (long long f : p.fwd.ws) need += 4 * f;
  for (long long f : p.ws) {
    if (f < 0 || f % 4 != 0) return false;
    need += 4 * f;
  }
  return need <= ws_bytes;
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

template <typename Tin>
int launch_bwd(BArgs A, const BwdPlan& p, void* ws, long long ws_bytes,
               cudaStream_t st) {
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
  a.fin = more;
  A.ws_dcs = a.fin + p.ws[0];
  A.ws_dcr = A.ws_dcs + p.ws[1];
  A.ws_dlj = A.ws_dcr + p.ws[2];
  A.ws_dlr = A.ws_dlj + p.ws[3];
  A.ws_dda = A.ws_dlr + p.ws[4];
  const int E = (int)sizeof(Tin);
  auto al = [](const void* ptr) { return (uintptr_t)ptr % 16 == 0; };
  a.vec_x = al(a.x) && (a.x_sb * E) % 16 == 0 && (a.x_ss * E) % 16 == 0 &&
            (a.hd * E) % 16 == 0;
  a.vec_b = al(a.b) && (a.b_sb * E) % 16 == 0 && (a.b_ss * E) % 16 == 0;
  a.vec_c = al(a.c) && (a.c_sb * E) % 16 == 0 && (a.c_ss * E) % 16 == 0;
  a.vec_init = a.init != nullptr && al(a.init);
  const Dims d(a.S, a.hd, a.ns, a.chunk);
  const bool two = (d.HDP / 16) * ((d.NSP + 63) / 64) > 8;
  int rc = two ? launch_states<Tin, 2>(a, p.fwd, st)
               : launch_states<Tin, 1>(a, p.fwd, st);
  if (rc != 0) return rc;
  ssd_scan_pass_kernel<Tin><<<grid_of(p.fwd, 1), NT2, 0, st>>>(a);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  rc = launch_smem(ssd_bwd_dstate_kernel<Tin>, bgrid(p, 0), NTB, p.smem[0],
                   st, A);
  if (rc != 0) return rc;
  rc = launch_smem(ssd_bwd_pass_kernel<Tin>, bgrid(p, 1), NTP2, 0, st, A);
  if (rc != 0) return rc;
  rc = launch_smem(ssd_bwd_chunk_kernel<Tin, 0>, bgrid(p, 2), NTC, p.smem[2],
                   st, A);
  if (rc != 0) return rc;
  rc = launch_smem(ssd_bwd_chunk_kernel<Tin, 1>, bgrid(p, 2), NTC, p.smem[2],
                   st, A);
  if (rc != 0) return rc;
  rc = launch_smem(ssd_bwd_chunk_kernel<Tin, 2>, bgrid(p, 2), NTC, p.smem[2],
                   st, A);
  if (rc != 0) return rc;
  rc = launch_smem(ssd_bwd_finish_kernel, bgrid(p, 3), (int)p.threads[3], 0,
                   st, A);
  if (rc != 0) return rc;
  return launch_smem(ssd_bwd_da_kernel, bgrid(p, 4), (int)p.threads[4], 0, st,
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
  return (int)cudaMemcpyToSymbol(g_ssd_trace, zero, sizeof(zero));
}
#endif
