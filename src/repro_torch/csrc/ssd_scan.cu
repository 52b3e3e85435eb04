// ssd_scan: the Mamba2 SSD chunk scan (state-space duality) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (`_kernel`), and computes the JAX model path's
// models/ssm.py::ssd_chunk_scan: fp32 y and the final fp32 state.
//
//   dA = dt * (-exp(a_log)),  csum = cumsum of dA within a chunk
//   y_i  = sum_{j<=i} exp(csum_i - csum_j) (c_i . b_j) dt_j x_j      (intra)
//        + exp(csum_i) (c_i . S_prev)                                (carried)
//   S    = S_prev exp(csum_last) + sum_j b_j (x) exp(csum_last - csum_j) dt_j x_j
//
// Layouts: x (B,S,nh,hd) bf16|f32 with batch/sequence strides given (heads
// and head dim dense), dt (B,S,nh) f32 dense, a_log (nh,) f32, b/c (B,S,ns)
// like x with their own strides, init (B,nh,hd,ns) f32 or null;
// y (B,S,nh,hd) f32 dense, fin (B,nh,hd,ns) f32 dense.  Ragged S: the last
// chunk is shorter; rows past S are zero in shared memory, so they add
// nothing and leave the state unchanged, as the reference's padding does.
//
// Design.  The TPU kernel walks a (B, heads, chunks) grid whose chunk axis
// runs in order and carries the state in VMEM scratch.  CUDA blocks run in
// no order, so here one block owns one (batch, head) pair and walks the
// chunks itself, with the (hd, ns) fp32 state resident in shared memory for
// the whole sequence.  A chunk of b and c in fp32 (2 x 256 x 128 x 4 B) does
// not fit in shared memory, so each chunk is walked in 64-row sub-tiles:
// for each row tile I the carried term and then the intra-chunk term over
// column tiles J <= I (G = mask(exp(csum_i - csum_j)) * C_I B_J^T, then
// G X_J); after all row tiles the state update over the same column tiles.
// Every product is an fp32 shared-memory GEMM on CUDA cores with 4x4
// register micro-tiles and 16-byte loads.
//
// Bound on this card: at the serve path's shapes, (1, 512, 80, 64) with
// ns 128 and chunk 256, the least work is about 19 MB moved (bf16 x, b, c;
// fp32 dt, y and state) against about 2 GFLOP, so bytes bound it (about
// 6 us).  This kernel recomputes c.b for each head and runs on CUDA cores
// in fp32, so it is far from that bound; tensor cores (wgmma), TMA and a
// split over more than B*nh blocks at batch-1 prefill are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int T = 64;         // rows of a sub-tile
constexpr int TP = T + 4;     // padded row of a transposed tile (16 B aligned)
constexpr int MAX_HD = 128;
constexpr int MAX_NS = 128;
constexpr int MAX_Q = 1024;
constexpr int MY = 2;         // y micro-tiles a thread: (T/4)(hd/4) <= 2 NT
constexpr int MS = 4;         // state micro-tiles a thread: (ns/4)(hd/4) <= 4 NT

struct Args {
  const void* x;
  const float* dt;
  const float* a_log;
  const void* b;
  const void* c;
  const float* init;
  float* y;
  float* fin;
  int B, S, nh, hd, ns, chunk;
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void unpack(const float4 v, float (&o)[4]) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__host__ __device__ inline int hd_pad(int hd) { return (hd + 3) & ~3; }

__host__ __device__ inline int q_pad(int chunk, int S) {
  int q = chunk < S ? chunk : S;
  return (q + T - 1) / T * T;
}

__host__ inline size_t smem_bytes(int hd, int ns, int chunk, int S) {
  size_t hdp = hd_pad(hd);
  return sizeof(float) * ((size_t)ns * hdp + 2 * (size_t)ns * TP +
                          (size_t)T * hdp + (size_t)T * TP +
                          2 * (size_t)q_pad(chunk, S));
}

template <typename Tin>
__global__ void __launch_bounds__(NT) ssd_scan_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int h = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  const int hd = a.hd, ns = a.ns, nh = a.nh, S = a.S;
  const int HDP = hd_pad(hd);
  const int Q = a.chunk < S ? a.chunk : S;
  const int PT = HDP / 4;                  // micro-tiles across the head dim
  float* St = sm;                          // [ns][HDP] state, transposed
  float* cT = St + ns * HDP;               // [ns][TP]  c rows of tile I
  float* bT = cT + ns * TP;                // [ns][TP]  b rows of tile J (A)
                                           // [T][ns]   b rows of tile J (B)
  float* xs = bT + ns * TP;                // [T][HDP]  x*dt (A), *decay (B)
  float* GT = xs + T * HDP;                // [T][TP]   G transposed, GT[j][i]
  float* csum = GT + T * TP;               // [QP]
  float* dts = csum + q_pad(a.chunk, S);   // [QP]

  const Tin* X = static_cast<const Tin*>(a.x);
  const Tin* Bm = static_cast<const Tin*>(a.b);
  const Tin* Cm = static_cast<const Tin*>(a.c);
  const float A = -expf(a.a_log[h]);
  const long long xo = bi * a.x_sb + (long long)h * hd;
  const long long bo = bi * a.b_sb, co = bi * a.c_sb;
  const float* DT = a.dt + (long long)bi * S * nh + h;
  const long long so = ((long long)bi * nh + h) * hd * ns;

  for (int e = tid; e < ns * HDP; e += NT) {
    const int k = e / HDP, p = e % HDP;
    St[e] = (a.init != nullptr && p < hd) ? a.init[so + (long long)p * ns + k]
                                          : 0.f;
  }

  const int ny = (T / 4) * PT;             // y micro-tiles of a row tile
  const int nsm = (ns / 4) * PT;           // state micro-tiles

  for (int s0 = 0; s0 < S; s0 += Q) {
    const int n = S - s0 < Q ? S - s0 : Q;
    const int np = (n + T - 1) / T * T;
    __syncthreads();
    // dt and the cumulative log-decay of the chunk (one warp); rows past
    // the chunk get dt 0, so csum stays flat there
    if (tid < 32) {
      float carry = 0.f;
      for (int q0 = 0; q0 < np; q0 += 32) {
        const int q = q0 + tid;
        const float d = q < n ? DT[(long long)(s0 + q) * nh] : 0.f;
        float v = d * A;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (tid >= o) v += u;
        }
        v += carry;
        csum[q] = v;
        dts[q] = d;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();

    // ---- phase A: y of each row tile ------------------------------------
    for (int i0 = 0; i0 < n; i0 += T) {
      __syncthreads();
      for (int e = tid; e < T * ns; e += NT) {
        const int i = e / ns, k = e % ns;
        cT[k * TP + i] =
            i0 + i < n ? to_f(Cm[co + (long long)(s0 + i0 + i) * a.c_ss + k])
                       : 0.f;
      }
      __syncthreads();

      float acc[MY][16];
      // carried term: exp(csum_i) * (c_i . S_prev)
#pragma unroll
      for (int m = 0; m < MY; ++m) {
#pragma unroll
        for (int r = 0; r < 16; ++r) acc[m][r] = 0.f;
        const int mt = tid + m * NT;
        if (mt < ny) {
          const int ti = mt / PT, tp = mt % PT;
          for (int k = 0; k < ns; ++k) {
            float cv[4], sv[4];
            unpack(ld4(cT + k * TP + 4 * ti), cv);
            unpack(ld4(St + k * HDP + 4 * tp), sv);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[m][r * 4 + q] += cv[r] * sv[q];
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float g = expf(csum[i0 + 4 * ti + r]);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[m][r * 4 + q] *= g;
          }
        }
      }

      // intra-chunk term over column tiles J <= I
      for (int j0 = 0; j0 <= i0; j0 += T) {
        __syncthreads();
        for (int e = tid; e < T * ns; e += NT) {
          const int j = e / ns, k = e % ns;
          bT[k * TP + j] =
              j0 + j < n
                  ? to_f(Bm[bo + (long long)(s0 + j0 + j) * a.b_ss + k])
                  : 0.f;
        }
        for (int e = tid; e < T * HDP; e += NT) {
          const int j = e / HDP, p = e % HDP;
          xs[e] = (j0 + j < n && p < hd)
                      ? to_f(X[xo + (long long)(s0 + j0 + j) * a.x_ss + p]) *
                            dts[j0 + j]
                      : 0.f;
        }
        __syncthreads();
        {
          // G[i][j] = exp(csum_i - csum_j) (c_i . b_j) for j <= i, else 0
          const int ti = tid / 16, tj = tid % 16;
          float g[16];
#pragma unroll
          for (int r = 0; r < 16; ++r) g[r] = 0.f;
          for (int k = 0; k < ns; ++k) {
            float cv[4], bv[4];
            unpack(ld4(cT + k * TP + 4 * ti), cv);
            unpack(ld4(bT + k * TP + 4 * tj), bv);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int q = 0; q < 4; ++q) g[r * 4 + q] += cv[r] * bv[q];
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + 4 * tj + q;
            float out[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = i0 + 4 * ti + r;
              // mask before exp: masked differences are positive
              out[r] = j <= i ? expf(csum[i] - csum[j]) * g[r * 4 + q] : 0.f;
            }
            *reinterpret_cast<float4*>(GT + (4 * tj + q) * TP + 4 * ti) =
                make_float4(out[0], out[1], out[2], out[3]);
          }
        }
        __syncthreads();
#pragma unroll
        for (int m = 0; m < MY; ++m) {
          const int mt = tid + m * NT;
          if (mt < ny) {
            const int ti = mt / PT, tp = mt % PT;
            for (int j = 0; j < T; ++j) {
              float gv[4], xv[4];
              unpack(ld4(GT + j * TP + 4 * ti), gv);
              unpack(ld4(xs + j * HDP + 4 * tp), xv);
#pragma unroll
              for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[m][r * 4 + q] += gv[r] * xv[q];
            }
          }
        }
      }

#pragma unroll
      for (int m = 0; m < MY; ++m) {
        const int mt = tid + m * NT;
        if (mt < ny) {
          const int ti = mt / PT, tp = mt % PT;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + 4 * ti + r;
            if (i >= n) continue;
            float* yrow = a.y + (((long long)bi * S + s0 + i) * nh + h) * hd;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (4 * tp + q < hd) yrow[4 * tp + q] = acc[m][r * 4 + q];
          }
        }
      }
    }

    // ---- phase B: state update --------------------------------------------
    __syncthreads();
    const float last = csum[n - 1];
    const float dlast = expf(last);
    for (int e = tid; e < ns * HDP; e += NT) St[e] *= dlast;
    for (int j0 = 0; j0 < n; j0 += T) {
      __syncthreads();
      for (int e = tid; e < T * ns; e += NT) {
        const int j = e / ns, k = e % ns;
        bT[e] = j0 + j < n
                    ? to_f(Bm[bo + (long long)(s0 + j0 + j) * a.b_ss + k])
                    : 0.f;
      }
      for (int e = tid; e < T * HDP; e += NT) {
        const int j = e / HDP, p = e % HDP;
        xs[e] = (j0 + j < n && p < hd)
                    ? to_f(X[xo + (long long)(s0 + j0 + j) * a.x_ss + p]) *
                          dts[j0 + j] * expf(last - csum[j0 + j])
                    : 0.f;
      }
      __syncthreads();
      const int jn = n - j0 < T ? n - j0 : T;
#pragma unroll
      for (int m = 0; m < MS; ++m) {
        const int mt = tid + m * NT;
        if (mt < nsm) {
          const int tk = mt / PT, tp = mt % PT;
          float u[16];
#pragma unroll
          for (int r = 0; r < 16; ++r) u[r] = 0.f;
          for (int j = 0; j < jn; ++j) {
            float bv[4], xv[4];
            unpack(ld4(bT + j * ns + 4 * tk), bv);
            unpack(ld4(xs + j * HDP + 4 * tp), xv);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int q = 0; q < 4; ++q) u[r * 4 + q] += bv[r] * xv[q];
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float4* dst =
                reinterpret_cast<float4*>(St + (4 * tk + r) * HDP + 4 * tp);
            float4 v = *dst;
            v.x += u[r * 4 + 0];
            v.y += u[r * 4 + 1];
            v.z += u[r * 4 + 2];
            v.w += u[r * 4 + 3];
            *dst = v;
          }
        }
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < hd * ns; e += NT) {
    const int p = e / ns, k = e % ns;
    a.fin[so + e] = St[k * HDP + p];
  }
}

template <typename Tin>
int launch(const Args& a, cudaStream_t stream) {
  if (a.B < 1 || a.S < 1 || a.nh < 1 || a.hd < 1 || a.hd > MAX_HD ||
      a.ns < 4 || a.ns > MAX_NS || a.ns % 4 != 0 || a.chunk < 1 ||
      (a.chunk < a.S ? a.chunk : a.S) > MAX_Q || a.B > 65535 ||
      (T / 4) * (hd_pad(a.hd) / 4) > MY * NT ||
      (a.ns / 4) * (hd_pad(a.hd) / 4) > MS * NT)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.hd, a.ns, a.chunk, a.S);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<Tin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.nh, a.B);
  ssd_scan_kernel<Tin><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

#define SSD_ENTRY(name, type)                                                 \
  extern "C" int name(const void* x, const float* dt, const float* a_log,     \
                      const void* b, const void* c, const float* init,        \
                      float* y, float* fin, int B, int S, int nh, int hd,     \
                      int ns, int chunk, long long x_sb, long long x_ss,      \
                      long long b_sb, long long b_ss, long long c_sb,         \
                      long long c_ss, void* stream) {                         \
    const Args a{x,  dt, a_log, b,  c,     init, y,    fin,  B,    S,       \
                 nh, hd, ns,    chunk, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss};   \
    return launch<type>(a, static_cast<cudaStream_t>(stream));                \
  }

SSD_ENTRY(ssd_scan_bf16, __nv_bfloat16)
SSD_ENTRY(ssd_scan_f32, float)
