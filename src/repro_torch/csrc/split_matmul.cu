// split_matmul for Hopper (sm_90a): y = x @ w with x (M,K), w (K,N), both
// row-major and contiguous, y (M,N) in x's type, fp32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/split_matmul.py::split_matmul
// (body `_kernel`): OSDP operator splitting (paper §3.3) at tile level.
// On the TPU the K dimension is a sequential grid axis carried in a VMEM
// accumulator.  Here each block owns one 64x64 output tile and walks K
// itself, in slices of `kslice` (the paper's slice granularity K/kslice),
// each slice in steps of 32 staged through shared memory, into fp32
// accumulators kept in registers.  Only one (32, 64) weight tile is
// resident per block at a time.  Ragged M, N and K are masked by the
// loads (zero fill) and the store; the TPU kernel asserts divisibility.
//
// What bounds it on an H100: at decode (M = 8 slots) every product is a
// stream of the weight from HBM (bytes: K*N*2), far below the ~295
// FLOP/byte ridge; at prefill (M = prompt length, a few hundred) the
// large products are near or above the ridge (operations).  This first
// version is simple: bf16 WMMA 16x16x16 fragments (tensor cores via
// mma.sync), 16-byte vector loads, no cp.async/TMA pipeline and no
// wgmma.  A TMA + wgmma ring is the later fast version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

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
                         const __nv_bfloat16* __restrict__ w,
                         __nv_bfloat16* __restrict__ y, int M, int N, int K,
                         int kslice, int vec_x, int vec_w) {
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
    if (row0 + r < M && col0 + c < N)
      y[(size_t)(row0 + r) * N + col0 + c] = __float2bfloat16(Cs[r * C_LD + c]);
  }
}

// float32 inputs: CUDA-core FMAs in full fp32 (no TF32), each thread a
// 4x4 patch of the 64x64 tile.
__global__ void __launch_bounds__(256)
split_matmul_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w, float* __restrict__ y,
                        int M, int N, int K, int kslice) {
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
      if (gr < M && gc < N) y[(size_t)gr * N + gc] = acc[i][j];
    }
}

}  // namespace

extern "C" int split_matmul_bf16(const void* x, const void* w, void* y,
                                 int M, int N, int K, int kslice,
                                 void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const int ks = (((kslice > 1 ? kslice : 1) + BK - 1) / BK) * BK;
  const int vec_x = (K % 8 == 0) && ((uintptr_t)x % 16 == 0);
  const int vec_w = (N % 8 == 0) && ((uintptr_t)w % 16 == 0);
  split_matmul_bf16_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)y,
      M, N, K, ks, vec_x, vec_w);
  return (int)cudaGetLastError();
}

extern "C" int split_matmul_f32(const void* x, const void* w, void* y,
                                int M, int N, int K, int kslice,
                                void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  split_matmul_f32_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)y, M, N, K,
      kslice > 1 ? kslice : 1);
  return (int)cudaGetLastError();
}
