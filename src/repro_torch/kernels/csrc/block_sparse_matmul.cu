// block_sparse_matmul: SIGMA's tile-sparse product on the card.
//
//   Z[rows[t] * bm + i, n] += sum_k A_tiles[t, i, k] * B[cols[t] * bk + k, n]
//
// a_tiles: [T, bm, bk] (fp32 or bf16), the nonzero tiles of A sorted by
// (row, col); rowptr: [n_tile_rows + 1] int64, tile t belongs to tile-row
// r for rowptr[r] <= t < rowptr[r + 1]; cols: [T] int64; b: [K, N] (fp32 or
// bf16); z: [M, N] fp32.  All contiguous.
//
// Replaces the Pallas kernel src/repro/kernels/block_sparse_matmul.py::
// _bsmm_kernel (pl.pallas_call at block_sparse_matmul.py:90, grid
// (n_nblocks, T)).
//
// Bound: operations.  At the card case (A 8192 x 8192 in 128 x 128 tiles at
// 30% tile density, about 1,230 tiles; B 8192 x 1024 fp32) the tiles need
// about 41 GFLOP, 0.62 ms at the fp32 CUDA-core peak, against 147 MB read
// and written once (0.04 ms).  This first version runs on the fp32 CUDA
// cores with 8 x 8 outputs per thread; tensor cores (TF32 / bf16 mma) are
// later work.
//
// How it replaces the TPU kernel's assumptions:
//  * a serial grid that revisits each output block over consecutive steps
//    and accumulates into it: here one CTA owns one (tile-row, n-block)
//    output block, walks that row's tiles in order through the CSR row
//    pointers, and keeps the sum in registers.  Each output element is
//    written once, by one thread, with no atomics: the result does not
//    depend on the schedule.
//  * zero tiles that pad empty tile-rows so that every output block is
//    initialised: a CTA whose row has no tile writes zeros, so the pads
//    are harmless but not needed.
//  * scalar-prefetched tile coordinates: the CTA reads its row's range
//    from rowptr and each tile's column from cols itself.
//  * (bm, bk, bn) BlockSpecs: the CTA covers TM = 64 or 128 rows of a
//    tile-row (tile-rows taller than TM take several CTAs) and TN = 64 or
//    128 columns, masks rows past bm and M and columns past N, and streams
//    the k dimension through shared memory in steps of 32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 16 x 16
constexpr int kKc = 32;             // k per shared-memory step
constexpr int kPad = 4;             // keeps float4 rows aligned

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// NI x NJ groups of 4 x 4 outputs per thread: TM = 64 NI rows, TN = 64 NJ
// columns per CTA.
template <int NI, int NJ, typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
bsmm_kernel(const TA* __restrict__ a_tiles,
            const int64_t* __restrict__ rowptr,
            const int64_t* __restrict__ cols, const TB* __restrict__ b,
            float* __restrict__ z, int M, int K, int N, int bm, int bk,
            int subs) {
  constexpr int TM = 64 * NI, TN = 64 * NJ;
  __shared__ __align__(16) float a_s[kKc][TM + kPad];   // A^T chunk
  __shared__ __align__(16) float b_s[kKc][TN + kPad];   // B chunk

  const int r = blockIdx.x / subs;               // tile-row
  const int m_off = (blockIdx.x % subs) * TM;    // first row in the tile
  const int n0 = blockIdx.y * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[NI][4][NJ][4] = {};
  const int64_t t_end = rowptr[r + 1];
  for (int64_t t = rowptr[r]; t < t_end; ++t) {
    const TA* at = a_tiles + t * (int64_t)bm * bk;
    const int64_t kb = cols[t] * (int64_t)bk;    // B row of the tile's k 0
    for (int k0 = 0; k0 < bk; k0 += kKc) {
      __syncthreads();                           // last step's reads done
      for (int idx = tid; idx < TM * kKc; idx += kThreads) {
        const int kk = idx % kKc, mm = idx / kKc;
        const int i = m_off + mm, k = k0 + kk;
        a_s[kk][mm] = (i < bm && k < bk)
                          ? to_f32(at[(int64_t)i * bk + k]) : 0.f;
      }
      for (int idx = tid; idx < TN * kKc; idx += kThreads) {
        const int nn = idx % TN, kk = idx / TN;
        const int k = k0 + kk, n = n0 + nn;
        b_s[kk][nn] = (k < bk && kb + k >= 0 && kb + k < K && n < N)
                          ? to_f32(b[(kb + k) * N + n]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKc; ++kk) {
        float av[NI][4], bv[NJ][4];
#pragma unroll
        for (int gi = 0; gi < NI; ++gi) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(&a_s[kk][64 * gi + 4 * ty]);
          av[gi][0] = v4.x; av[gi][1] = v4.y; av[gi][2] = v4.z;
          av[gi][3] = v4.w;
        }
#pragma unroll
        for (int gj = 0; gj < NJ; ++gj) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(&b_s[kk][64 * gj + 4 * tx]);
          bv[gj][0] = v4.x; bv[gj][1] = v4.y; bv[gj][2] = v4.z;
          bv[gj][3] = v4.w;
        }
#pragma unroll
        for (int gi = 0; gi < NI; ++gi)
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int gj = 0; gj < NJ; ++gj)
#pragma unroll
              for (int f = 0; f < 4; ++f)
                acc[gi][e][gj][f] =
                    fmaf(av[gi][e], bv[gj][f], acc[gi][e][gj][f]);
      }
    }
  }

#pragma unroll
  for (int gi = 0; gi < NI; ++gi)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = m_off + 64 * gi + 4 * ty + e;
      const int64_t row = (int64_t)r * bm + i;
      if (i >= bm || row >= M) continue;
#pragma unroll
      for (int gj = 0; gj < NJ; ++gj)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int n = n0 + 64 * gj + 4 * tx + f;
          if (n < N) z[row * N + n] = acc[gi][e][gj][f];
        }
    }
}

template <int NI, int NJ, typename TA, typename TB>
int launch(const void* a, const void* rowptr, const void* cols,
           const void* b, void* z, int n_tile_rows, int M, int K, int N,
           int bm, int bk, cudaStream_t stream) {
  const int subs = (bm + 64 * NI - 1) / (64 * NI);
  const dim3 grid((unsigned)((int64_t)n_tile_rows * subs),
                  (unsigned)((N + 64 * NJ - 1) / (64 * NJ)));
  bsmm_kernel<NI, NJ, TA, TB><<<grid, kThreads, 0, stream>>>(
      (const TA*)a, (const int64_t*)rowptr, (const int64_t*)cols,
      (const TB*)b, (float*)z, M, K, N, bm, bk, subs);
  return (int)cudaGetLastError();
}

template <typename TA, typename TB>
int launch_tiles(int tm, int tn, const void* a, const void* rowptr,
                 const void* cols, const void* b, void* z, int n_tile_rows,
                 int M, int K, int N, int bm, int bk, cudaStream_t s) {
  if (tm == 128 && tn == 128)
    return launch<2, 2, TA, TB>(a, rowptr, cols, b, z, n_tile_rows, M, K, N,
                                bm, bk, s);
  if (tm == 128)
    return launch<2, 1, TA, TB>(a, rowptr, cols, b, z, n_tile_rows, M, K, N,
                                bm, bk, s);
  if (tn == 128)
    return launch<1, 2, TA, TB>(a, rowptr, cols, b, z, n_tile_rows, M, K, N,
                                bm, bk, s);
  return launch<1, 1, TA, TB>(a, rowptr, cols, b, z, n_tile_rows, M, K, N,
                              bm, bk, s);
}

}  // namespace

// a_dtype, b_dtype: 0 = float32, 1 = bfloat16.  tm, tn: the CTA's rows and
// columns, 64 or 128.
extern "C" int repro_block_sparse_matmul(
    const void* a, const void* rowptr, const void* cols, const void* b,
    void* z, int n_tile_rows, int M, int K, int N, int bm, int bk, int tm,
    int tn, int a_dtype, int b_dtype, void* stream) {
  if ((int64_t)M * N == 0 || n_tile_rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (a_dtype == 1 && b_dtype == 1)
    return launch_tiles<__nv_bfloat16, __nv_bfloat16>(
        tm, tn, a, rowptr, cols, b, z, n_tile_rows, M, K, N, bm, bk, s);
  if (a_dtype == 1)
    return launch_tiles<__nv_bfloat16, float>(
        tm, tn, a, rowptr, cols, b, z, n_tile_rows, M, K, N, bm, bk, s);
  if (b_dtype == 1)
    return launch_tiles<float, __nv_bfloat16>(
        tm, tn, a, rowptr, cols, b, z, n_tile_rows, M, K, N, bm, bk, s);
  return launch_tiles<float, float>(tm, tn, a, rowptr, cols, b, z,
                                    n_tile_rows, M, K, N, bm, bk, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
