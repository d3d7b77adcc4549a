// ssd_chunk: the intra-chunk (diagonal-block) stage of the Mamba2 SSD
// cascade.  For every (batch b, chunk c, head h):
//
//   G[i, j] = sum_n C[i, n] B[j, n]                      (no head index)
//   L[i, j] = exp(cum[i] - cum[j]) for j <= i, else 0    cum = cumsum(a)
//   Y[i, p] = sum_j G[i, j] L[i, j] X[j, p]              (fp32 accumulate)
//
// x: [B, nc, l, H, P] and b, c: [B, nc, l, N] in one dtype (bf16 or fp32);
// a: [B, H, nc, l] fp32; y: [B, nc, l, H, P] fp32.  All contiguous.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_chunk.py::
// _ssd_chunk_kernel (pl.pallas_call at ssd_chunk.py:62, grid (B, H, nc)).
//
// Bound: bytes.  At the Mamba2-1.3B prefill shape (B 4, S 2048, l 256,
// H 64, P 64, N 128, bf16) the inputs and output are read and written once
// in about 208 MB (y in fp32 alone is 134 MB): 0.062 ms at 3.35 TB/s.  The
// work is about 9 GFLOP (G once per (b, c), the causal half of Y), 9 us
// at the bf16 tensor-core peak.  This first version does its products on
// the fp32 CUDA cores (about 0.14 ms at their peak), so it is expected to
// sit a few times above the bytes bound; tensor cores (mma.sync / wgmma)
// are later work.
//
// How it replaces the TPU kernel's assumptions:
//  * one whole (b, h, c) cell in VMEM (G and L are 256 x 256 fp32, 256 KB
//    each, over the 227 KB a CTA may have): a CTA owns one 64-row tile of
//    one chunk and keeps only G's rows of that tile (64 x l fp32, 64 KB at
//    l = 256) in shared memory; S = G o L and X move through 64 x 64 tiles.
//  * the full l x l products: the CTA loops over column tiles j <= i only,
//    so the blocks above the diagonal are never computed.
//  * G recomputed per head: G has no head index (one B/C group), so a CTA
//    computes its G rows once and loops over 8 heads.
//  * jnp.cumsum inside the cell: warp 0 scans a with shuffles per head.
//  * masked exponentials: the TPU kernel guards exp() with two where()s;
//    here exp is evaluated only for j <= i, where cum[i] - cum[j] <= 0, so
//    the entries whose exp could overflow are never computed.
//  * a serial grid: CTAs are independent; the row tiles with the most
//    column tiles are numbered first so the long CTAs start first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 16 x 16; each owns a 4 x 4 block
constexpr int kTile = 64;           // rows i, columns j and p per tile
constexpr int kNTile = 32;          // state columns per step of G
constexpr int kHeadsPerCta = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ a,
                 const T* __restrict__ b, const T* __restrict__ c,
                 float* __restrict__ y, int B, int nc, int l, int H, int P,
                 int N) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_row_tiles = (l + kTile - 1) / kTile;
  const int l_pad = n_row_tiles * kTile;
  const int ld_g = l_pad + 1;                  // odd: conflict-free columns
  float* g_s = smem;                           // [kTile][ld_g]
  float* cum_s = g_s + kTile * ld_g;           // [l_pad]
  float* s_t = cum_s + l_pad;                  // [kTile j][kTile i]
  float* x_s = s_t + kTile * kTile;            // [kTile j][kTile p]
  float* c_s = s_t;                            // [kTile][kNTile + 1], G only
  float* b_s = x_s;                            // [kTile][kNTile + 1], G only

  const int n_groups = (H + kHeadsPerCta - 1) / kHeadsPerCta;
  const int cells = B * nc * n_groups;
  const int it = n_row_tiles - 1 - (int)(blockIdx.x / cells);
  int rem = (int)(blockIdx.x % cells);
  const int hg = rem % n_groups;
  rem /= n_groups;
  const int ci = rem % nc;
  const int bi = rem / nc;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int i0 = it * kTile;
  const int64_t cell = (int64_t)bi * nc + ci;

  // ---- G rows i0 .. i0 + 63, columns 0 .. i0 + 63 -------------------------
  const T* cb = c + cell * l * N;
  const T* bb = b + cell * l * N;
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kTile;
    float acc[4][4] = {};
    for (int n0 = 0; n0 < N; n0 += kNTile) {
      for (int idx = tid; idx < kTile * kNTile; idx += kThreads) {
        const int r = idx / kNTile, k = idx % kNTile, n = n0 + k;
        const int gi = i0 + r, gj = j0 + r;
        c_s[r * (kNTile + 1) + k] =
            (gi < l && n < N) ? to_f32(cb[(int64_t)gi * N + n]) : 0.f;
        b_s[r * (kNTile + 1) + k] =
            (gj < l && n < N) ? to_f32(bb[(int64_t)gj * N + n]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kNTile; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = c_s[(ty + 16 * r) * (kNTile + 1) + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = b_s[(tx + 16 * q) * (kNTile + 1) + k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(cv[r], bv[q], acc[r][q]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        g_s[(ty + 16 * r) * ld_g + j0 + tx + 16 * q] = acc[r][q];
  }

  // ---- per head: cumsum of a, then Y = (G o L) X over column tiles ------
  const int j_end = i0 + kTile;
  for (int hh = 0; hh < kHeadsPerCta; ++hh) {
    const int h = hg * kHeadsPerCta + hh;
    if (h >= H) break;
    __syncthreads();        // G written; the last head's tiles consumed
    if (tid < 32) {
      const float* ab = a + (((int64_t)bi * H + h) * nc + ci) * l;
      float carry = 0.f;
      for (int k0 = 0; k0 < j_end; k0 += 32) {
        const int k = k0 + tid;
        float v = (k < l) ? ab[k] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float t = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += t;
        }
        v += carry;
        cum_s[k] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    for (int p0 = 0; p0 < P; p0 += kTile) {
      float acc[4][4] = {};
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
          const int jl = idx / kTile, il = idx % kTile;
          const int gi = i0 + il, gj = j0 + jl;
          float v = 0.f;
          if (gj <= gi && gi < l)          // never exp() above the diagonal
            v = g_s[il * ld_g + gj] * expf(cum_s[gi] - cum_s[gj]);
          s_t[jl * kTile + il] = v;
        }
        for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
          const int jl = idx / kTile, pl = idx % kTile;
          const int gj = j0 + jl, p = p0 + pl;
          x_s[jl * kTile + pl] =
              (gj < l && p < P)
                  ? to_f32(x[((cell * l + gj) * H + h) * (int64_t)P + p])
                  : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int jl = 0; jl < kTile; ++jl) {
          const float4 s4 =
              *reinterpret_cast<const float4*>(&s_t[jl * kTile + ty * 4]);
          const float4 x4 =
              *reinterpret_cast<const float4*>(&x_s[jl * kTile + tx * 4]);
          const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(sv[r], xv[q], acc[r][q]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gi = i0 + ty * 4 + r;
        if (gi >= l) continue;
        float* yrow = y + ((cell * l + gi) * H + h) * (int64_t)P;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = p0 + tx * 4 + q;
          if (p < P) yrow[p] = acc[r][q];
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* c,
           void* y, int B, int nc, int l, int H, int P, int N,
           cudaStream_t stream) {
  const int n_row_tiles = (l + kTile - 1) / kTile;
  const int l_pad = n_row_tiles * kTile;
  const size_t smem =
      (size_t)(kTile * (l_pad + 1) + l_pad + 2 * kTile * kTile) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_groups = (H + kHeadsPerCta - 1) / kHeadsPerCta;
  const int64_t blocks = (int64_t)n_row_tiles * B * nc * n_groups;
  ssd_chunk_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const T*)x, (const float*)a, (const T*)b, (const T*)c, (float*)y, B,
      nc, l, H, P, N);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b and c).
extern "C" int repro_ssd_chunk(const void* x, const void* a, const void* b,
                               const void* c, void* y, int B, int nc, int l,
                               int H, int P, int N, int dtype, void* stream) {
  if ((int64_t)B * nc * l * H * P == 0) return 0;
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a, b, c, y, B, nc, l, H, P, N,
                                 (cudaStream_t)stream);
  return launch<float>(x, a, b, c, y, B, nc, l, H, P, N,
                       (cudaStream_t)stream);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
