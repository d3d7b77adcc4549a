// ssd_chunk_bwd: the gradient of ssd_chunk (csrc/ssd_chunk.cu).  The
// forward computes, for every (batch b, chunk c, head h),
//
//   G = C B^T (no head index), L[i, j] = exp(cum[i] - cum[j]) for j <= i
//   (cum = cumsum(a)), W = G o L, Y = W X.
//
// Given dY (fp32, as y is), this computes
//
//   dX_h  = W_h^T dY_h                              (x's dtype)
//   dW_h  = dY_h X_h^T, on and below the diagonal
//   dG    = sum_h dW_h o L_h                        (every head of (b, c))
//   dC    = dG B,  dB = dG^T C                      (b's dtype)
//   M_h   = dW_h o W_h, dcum_h = rowsum(M_h) - colsum(M_h)
//   da_h  = the reverse cumsum of dcum_h, in fp64, rounded once (fp32)
//
// x, dx: [B, nc, l, H, P]; a, da: [B, H, nc, l] fp32; b, c, db, dc:
// [B, nc, l, N]; dy: [B, nc, l, H, P] fp32.  All contiguous.  l <= 512,
// P <= 64.
//
// Replaces no TPU kernel: the reference's Pallas kernel _ssd_chunk_kernel
// (src/repro/kernels/ssd_chunk.py, pl.pallas_call at :62) has no VJP, and
// the reference trains through its plain jnp SSD.  The port's model path
// runs the forward kernel on the card, so its training path needs this
// gradient; kernels/ssd_chunk.py's SsdChunk calls it.
//
// Bound: at Mamba2-1.3B's train shape (B 8, nc 8, l 256, H 64, P 64, N
// 128, bf16) the function reads x 134 MB, dy 268 MB (fp32), a, b and c
// 4 MB each and writes dx 134 MB, da, db and dc 4 MB each: 560 MB, 0.17
// ms at 3.35 TB/s.  Its products over the causal halves are 36 GFLOP,
// almost all per head (dW and dX); as fp32-accurate products on the TF32
// tensor cores (2 passes for dW, 3 for dX) they take about as long as the
// bytes.
//
// Design (first kernel: right and simple, one route for both dtypes):
//  * Four launches: cum (one warp a (b, h, c) row: cumsum(a) in fp64,
//    rounded once, as the forward and ssd_chunk_plain take it), main,
//    dc_sum and da (below).  No atomics anywhere: every sum runs in a fixed
//    order, so two calls give the same bits (the trainer's resume is
//    bit-equal).
//  * main: a CTA owns one column tile jt (64 columns j) of one (b, c) and
//    every head, in balanced pairs (jt and n - 1 - jt, as the forward
//    pairs row tiles), so the head sum behind dG stays inside the CTA.
//    For each head and each row tile it >= jt (rows i >= j only):
//      dW tile = dY[it] X[jt]^T;  elementwise: L, W = G o L, M = dW o W,
//      dG[it, jt] += dW o L (in shared memory, the warp's own fragment,
//      over the heads in order), M's row sums (this column tile's share)
//      and column sums (complete over it for column j);
//      dX[jt] += W^T dY[it], each row tile's product in a fresh
//      accumulator added to the running one (the tensor cores truncate as
//      they accumulate, so long sums compound).
//    After the heads: dB[jt] = sum_it dG[it, jt]^T C[it] (complete) and
//    dC[it] += dG[it, jt] B[jt] (this column tile's share, to scratch).
//  * dc_sum adds the column tiles' shares of dC in order (j < i only);
//    da adds the column tiles' shares of each row sum, less the column sum,
//    and takes the reverse cumsum in fp64.
//  * Every operand lies in shared memory in fp32 (bf16 inputs converted
//    as they load) and every product is mma.sync m16n8k8 on TF32
//    (tf32.cuh): an fp32 operand goes as hi + lo (3xTF32 when both are
//    fp32, 2 when one is bf16, which is exact in TF32), so the products
//    keep fp32's accuracy: dY and everything derived from it (W, dG) are
//    fp32 in both dtypes.  G = C B^T is one pass in bf16 and three in fp32.
//  * exp is taken of arguments <= 0 only: above the diagonal (and on
//    rows past l) the argument is -inf, so L, W, M and dW o L are exact
//    zeros there, with no inf x 0.
//  * Shared memory at l <= 256: G and dG for every row tile of the column
//    tile (4 x 16 KB each) and the staged tiles, 200 KB: one CTA an SM.
//    At l in (256, 512] the G tiles do not fit beside dG's: G is
//    recomputed per head and row tile (slower; no model runs that chunk).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd.cuh"
#include "tf32.cuh"

namespace {

using ssd::cp_async16;
using ssd::cp_async_commit;
using ssd::cp_async_wait;
using ssd::smem_addr;

constexpr int kThreads = 256;            // 8 warps: row group w % 4, half w / 4
constexpr int kT = 64;                   // rows i and columns j of a tile
constexpr int kLd = kT + 4;              // staged rows 272 B apart
constexpr int kStage = kT * kLd;         // floats of a staged 64 x 64 tile
constexpr int kFrag = kT * kT;           // floats of a tile as fragments
constexpr int kGk = 32;                  // n of a G step
constexpr int kGLd = kGk + 4;            // its staged rows 144 B apart
constexpr int kWt = 2 * kT * kGLd;       // W^T's tile, G's staging too
constexpr int kCachedTiles = 4;          // G cached for this many tiles
static_assert(kWt >= kStage, "W^T fits the G staging area");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v's TF32 parts; without kLo (a bf16 value, exact in TF32) hi is v
template <bool kLo>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  if (kLo) {
    tf32::split(v, hi, lo);
  } else {
    hi = __float_as_uint(v);
    lo = 0u;
  }
}
template <bool kLo>
__device__ __forceinline__ void split4(const uint32_t (&f)[4],
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split<kLo>(__uint_as_float(f[e]), hi[e], lo[e]);
}

// d += a b from split operands, small terms first: al bh, ah bl, ah bh,
// each lo term only where that operand has one
template <bool kALo, bool kBLo>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&ah)[4],
                                    const uint32_t (&al)[4], uint32_t bh0,
                                    uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  if (kALo) tf32::mma(d, al, bh0, bh1);
  if (kBLo) tf32::mma(d, ah, bl0, bl1);
  tf32::mma(d, ah, bh0, bh1);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// acc[nt] += A B^T for the warp's 16 rows (16 rg ..) and 32 columns (32 ch
// + 8 nt ..), over k < 8 n_ks: A and B row-major fp32 tiles in shared
// memory at byte addresses as and bs, rows ld floats apart (A's rows i,
// B's rows the output's columns j, both with k contiguous)
template <bool kALo, bool kBLo>
__device__ __forceinline__ void mma_abt(float (&acc)[4][4], uint32_t as,
                                        uint32_t bs, int ld, int n_ks, int rg,
                                        int ch, int lane) {
#pragma unroll 2
  for (int ks = 0; ks < 8; ++ks) {
    if (ks >= n_ks) break;
    uint32_t af[4], ah[4], al[4];
    tf32::ldmatrix_x4(af, as + ((rg * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * ld +
                                8 * ks + (lane >> 4) * 4) * 4);
    split4<kALo>(af, ah, al);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int np = 2 * ch + q;           // 16 columns: n8 tiles 2q, 2q+1
      uint32_t bf[4], bh[4], bl[4];
      tf32::ldmatrix_x4(bf, bs + ((16 * np + (lane & 7) + (lane >> 4) * 8) *
                                      ld +
                                  8 * ks + ((lane >> 3) & 1) * 4) * 4);
      split4<kBLo>(bf, bh, bl);
      mma<kALo, kBLo>(acc[2 * q], ah, al, bh[0], bh[1], bl[0], bl[1]);
      mma<kALo, kBLo>(acc[2 * q + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
    }
  }
}

// acc[nt] += A^T-as-stored B: A from an [m][k] tile at as (ldmatrix, rows
// 16 rg .. of m, ld kLd), B from a row-major [k][n] fp32 tile bk (k the
// rows, 64 of them; the warp's columns 32 ch + 8 nt .., those < n_cols)
template <bool kBLo>
__device__ __forceinline__ void mma_ab(float (&acc)[4][4], uint32_t as,
                                       const float* bk, int n_cols, int rg,
                                       int ch, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll 2
  for (int ks = 0; ks < 8; ++ks) {
    uint32_t af[4], ah[4], al[4];
    tf32::ldmatrix_x4(af, as + ((rg * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * kLd +
                                8 * ks + (lane >> 4) * 4) * 4);
    split4<true>(af, ah, al);
    const float* b0 = bk + (8 * ks + t) * kLd + 32 * ch + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (32 * ch + 8 * nt >= n_cols) break;
      uint32_t bh0, bl0, bh1, bl1;
      split<kBLo>(b0[8 * nt], bh0, bl0);
      split<kBLo>(b0[4 * kLd + 8 * nt], bh1, bl1);
      mma<true, kBLo>(acc[nt], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// rows [0, 64) and columns [0, kCols) of a row-major matrix at src (row
// stride ld) into dst (rows dld floats apart) as fp32, zeros at rows >=
// nr and columns >= ncols
template <int kCols, typename T>
__device__ __forceinline__ void stage(float* dst, int dld, const T* src,
                                      int64_t ld, int nr, int ncols) {
  for (int idx = threadIdx.x; idx < kT * kCols; idx += kThreads) {
    const int r = idx / kCols, k = idx % kCols;
    dst[r * dld + k] = (r < nr && k < ncols) ? to_f(src[r * ld + k]) : 0.f;
  }
}

// one G tile, rows i0 .. (C) and columns j0 .. (B), as the warps'
// accumulator fragments at dst: N in steps of kGk through the staging area
// (both staged tiles, kGLd apart), one pass in bf16, three in fp32
template <bool kExact, typename T>
__device__ void g_tile(float* dst, float* staging, const T* cb, const T* bb,
                       int i0, int j0, int l, int N, int rg, int ch,
                       int lane) {
  float acc[4][4];
  zero(acc);
  float* cst = staging;
  float* bst = staging + kT * kGLd;
  for (int n0 = 0; n0 < N; n0 += kGk) {
    __syncthreads();                       // the staging's last readers done
    stage<kGk>(cst, kGLd, cb + (int64_t)i0 * N + n0, N, l - i0, N - n0);
    stage<kGk>(bst, kGLd, bb + (int64_t)j0 * N + n0, N, l - j0, N - n0);
    __syncthreads();
    mma_abt<!kExact, !kExact>(acc, smem_addr(cst), smem_addr(bst), kGLd,
                              kGk / 8, rg, ch, lane);
  }
  float4* d = reinterpret_cast<float4*>(dst) + (threadIdx.x / 32) * 128 +
              lane;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    d[32 * nt] = make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
  __syncthreads();                         // staging read; G written
}

// dY rows [i0, i0 + 64) of one head (dyh: row i at dyh + i H P) into a
// staged tile: 16-byte cp.async when vec (P % 4 == 0, 16-byte rows), else
// plain loads; zeros past l and P
__device__ __forceinline__ void issue_dy(float* dst, const float* dyh, int i0,
                                         int l, int H, int P, bool vec) {
  for (int idx = threadIdx.x; idx < kT * (kT / 4); idx += kThreads) {
    const int r = idx / (kT / 4), k = (idx % (kT / 4)) * 4;
    float* d = dst + r * kLd + k;
    const bool in = i0 + r < l && k < P;
    const float* s = dyh + (int64_t)(i0 + r) * H * P + k;
    if (vec) {
      cp_async16(smem_addr(d), in ? s : dyh, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = (in && k + e < P) ? s[e] : 0.f;
    }
  }
  cp_async_commit();
}

// a head's X rows [j0, j0 + 64) (xh: row j at xh + j H P) and cum row
// into registers: 16 elements and 2 cum values a thread
template <typename T>
__device__ __forceinline__ void x_load(float (&v)[16], float (&cm)[2],
                                       const T* xh, const float* cum_row,
                                       int j0, int l, int l_pad, int H,
                                       int P) {
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int idx = threadIdx.x + kThreads * e, r = idx / kT, k = idx % kT;
    v[e] = (j0 + r < l && k < P) ? to_f(xh[(int64_t)(j0 + r) * H * P + k])
                                 : 0.f;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int k = threadIdx.x + kThreads * e;
    cm[e] = k < l_pad ? cum_row[k] : 0.f;
  }
}
__device__ __forceinline__ void x_store(float* xs, float* cum_s,
                                        const float (&v)[16],
                                        const float (&cm)[2], int l_pad) {
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int idx = threadIdx.x + kThreads * e;
    xs[(idx / kT) * kLd + idx % kT] = v[e];
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int k = threadIdx.x + kThreads * e;
    if (k < l_pad) cum_s[k] = cm[e];
  }
}

// cum[row][k] = a[row][0] + ... + a[row][k] for k < l_pad (a as 0 past l):
// one warp a (b, h, c) row
__global__ void __launch_bounds__(256)
cum_kernel(const float* __restrict__ a, float* __restrict__ cum, int rows,
           int l, int l_pad) {
  const int row = (int)((blockIdx.x * (int64_t)blockDim.x + threadIdx.x) /
                        32);
  if (row >= rows) return;
  ssd::warp_cumsum(a + (int64_t)row * l, l, l_pad, cum + (int64_t)row * l_pad,
                   threadIdx.x % 32);
}

// The main pass (see the header).  part: [n_rt][B H nc][l], column tile
// jt's share of each row sum of M (for jt's own rows, less the column
// sum); dcp: [n_rt][B nc][l][N], jt's share of dC.
template <bool kExact, typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_main(const T* __restrict__ x, const float* __restrict__ cum,
             const T* __restrict__ b, const T* __restrict__ c,
             const float* __restrict__ dy, T* __restrict__ dx,
             T* __restrict__ db, float* __restrict__ part,
             float* __restrict__ dcp, int nc, int l, int H, int P, int N,
             int cached, int vec) {
  extern __shared__ float4 smem4[];
  const int n_rt = (l + kT - 1) / kT, l_pad = n_rt * kT;
  float* dg_s = reinterpret_cast<float*>(smem4);     // [n_rt][kFrag]
  float* g_s = dg_s + n_rt * kFrag;                   // [n_rt or 1][kFrag]
  float* xs = g_s + (cached ? n_rt : 1) * kFrag;      // [kStage]
  float* ys = xs + kStage;                            // [2][kStage]
  float* wt = ys + 2 * kStage;                        // [kWt]
  float* cum_s = wt + kWt;                            // [l_pad]
  float* red_row = cum_s + l_pad;                     // [2][64]
  float* red_col = red_row + 2 * kT;                  // [4][64]
  float* col_run = red_col + 4 * kT;                  // [64]
  float* diag_row = col_run + kT;                     // [64]

  const int pairs = (n_rt + 1) / 2;
  const int pair = (int)(blockIdx.x % pairs);
  const int64_t cell = blockIdx.x / pairs;            // b * nc + c
  const int bi = (int)(cell / nc), ci = (int)(cell % nc);
  const int64_t cells = gridDim.x / pairs, rows = cells * H;  // B nc, B H nc
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = warp % 4, ch = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const T* cb = c + cell * l * N;
  const T* bb = b + cell * l * N;
  const int n_ks = (min(P, kT) + 7) / 8;
  auto row_of = [&](int h) { return ((int64_t)bi * H + h) * nc + ci; };
  auto xhead = [&](int h) { return x + (cell * l * H + h) * (int64_t)P; };

  for (int half = 0; half < 2; ++half) {
    const int jt = half == 0 ? n_rt - 1 - pair : pair;
    if (half == 1 && jt == n_rt - 1 - pair) break;
    const int j0 = jt * kT, n_it = n_rt - jt;
    __syncthreads();                       // the last column tile's readers
    if (cached)
      for (int it = jt; it < n_rt; ++it)
        g_tile<kExact>(g_s + (it - jt) * kFrag, wt, cb, bb, it * kT, j0, l, N,
                       rg, ch, lane);
    // dG's tiles: each thread owns its fragment slots
    for (int it = 0; it < n_it; ++it) {
      float4* d = reinterpret_cast<float4*>(dg_s + it * kFrag) + warp * 128 +
                  lane;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) d[32 * nt] = make_float4(0, 0, 0, 0);
    }
    {
      float v[16], cm[2];
      x_load(v, cm, xhead(0), cum + row_of(0) * l_pad, j0, l, l_pad, H, P);
      x_store(xs, cum_s, v, cm, l_pad);
    }
    const int steps = H * n_it;
    issue_dy(ys, dy + cell * l * H * (int64_t)P, j0, l, H, P, vec);
    float run[4][4];                       // dX of the head, rows j, cols p
    for (int s = 0; s < steps; ++s) {
      const int h = s / n_it, it = jt + s % n_it, i0 = it * kT;
      const bool first = it == jt, last = it == n_rt - 1;
      cp_async_wait<0>();
      __syncthreads();                     // dY tile s, X and cum of h in
      if (first && h > 0 && tid < kT && j0 + tid < l)   // head h - 1's sums
        part[(jt * rows + row_of(h - 1)) * l + j0 + tid] =
            diag_row[tid] - col_run[tid];
      if (s + 1 < steps) {
        const int h1 = (s + 1) / n_it, it1 = jt + (s + 1) % n_it;
        issue_dy(ys + ((s + 1) & 1) * kStage,
                 dy + (cell * l * H + h1) * (int64_t)P, it1 * kT, l, H, P,
                 vec);
      } else {
        cp_async_commit();
      }
      const bool pre = last && h + 1 < H;
      float v[16], cm[2];
      if (pre)
        x_load(v, cm, xhead(h + 1), cum + row_of(h + 1) * l_pad, j0, l,
               l_pad, H, P);
      const float* gt = g_s;
      if (cached)
        gt += (it - jt) * kFrag;
      else
        g_tile<kExact>(g_s, wt, cb, bb, i0, j0, l, N, rg, ch, lane);
      if (first) zero(run);

      // ---- dW = dY X^T: rows i of it, columns j of jt --------------------
      const float* yst = ys + (s & 1) * kStage;
      float dw[4][4];
      zero(dw);
      mma_abt<true, !kExact>(dw, smem_addr(yst), smem_addr(xs), kLd, n_ks, rg,
                             ch, lane);

      // ---- L, W, M and dG, element by element -------------------------
      {
        const int il = 16 * rg + g, ia = i0 + il, ib = ia + 8;
        const float ca = cum_s[ia], cbv = cum_s[ib];
        const float4* gf = reinterpret_cast<const float4*>(gt) + warp * 128 +
                           lane;
        float4* dgf = reinterpret_cast<float4*>(dg_s + (it - jt) * kFrag) +
                      warp * 128 + lane;
        float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int jl = 32 * ch + 8 * nt + 2 * t, ja = j0 + jl;
          const float cja = cum_s[ja], cjb = cum_s[ja + 1];
          // exponents at (ia, ja), (ia, ja + 1), (ib, ja), (ib, ja + 1):
          // -inf (0xff800000) above the diagonal and past l, so exp is
          // only taken of arguments <= 0
          const float ninf = __uint_as_float(0xff800000u);
          const float e0 = (ja <= ia && ia < l) ? ca - cja : ninf;
          const float e1 = (ja + 1 <= ia && ia < l) ? ca - cjb : ninf;
          const float e2 = (ja <= ib && ib < l) ? cbv - cja : ninf;
          const float e3 = (ja + 1 <= ib && ib < l) ? cbv - cjb : ninf;
          const float L[4] = {__expf(e0), __expf(e1), __expf(e2), __expf(e3)};
          const float4 gv = gf[32 * nt];
          const float gvs[4] = {gv.x, gv.y, gv.z, gv.w};
          float4 dg = dgf[32 * nt];
          float dgv[4] = {dg.x, dg.y, dg.z, dg.w};
          float m[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float w = gvs[e] * L[e];
            m[e] = dw[nt][e] * w;
            dgv[e] = fmaf(dw[nt][e], L[e], dgv[e]);
            // W^T[j][i]: rows 272 B apart, conflict-free across the warp
            wt[(jl + (e & 1)) * kLd + il + (e & 2) * 4] = w;
          }
          dgf[32 * nt] = make_float4(dgv[0], dgv[1], dgv[2], dgv[3]);
          rs_a += m[0] + m[1];
          rs_b += m[2] + m[3];
          // column sums of the warp's 16 rows: over g
          float c0 = m[0] + m[2], c1 = m[1] + m[3];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            c0 += __shfl_xor_sync(0xffffffffu, c0, off);
            c1 += __shfl_xor_sync(0xffffffffu, c1, off);
          }
          if (g == 0) {
            red_col[rg * kT + jl] = c0;
            red_col[rg * kT + jl + 1] = c1;
          }
        }
        // row sums of the warp's 32 columns: over t
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          rs_a += __shfl_xor_sync(0xffffffffu, rs_a, off);
          rs_b += __shfl_xor_sync(0xffffffffu, rs_b, off);
        }
        if (t == 0) {
          red_row[ch * kT + il] = rs_a;
          red_row[ch * kT + il + 8] = rs_b;
        }
      }
      __syncthreads();                     // W^T and the partial sums in

      // ---- dX += W^T dY, this row tile in a fresh accumulator ----------
      {
        float fresh[4][4];
        zero(fresh);
        mma_ab<true>(fresh, smem_addr(wt), yst, P, rg, ch, lane);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) run[nt][e] += fresh[nt][e];
      }
      if (tid < kT) {                      // column sums, row tiles in order
        const float cs = red_col[tid] + red_col[kT + tid] +
                         red_col[2 * kT + tid] + red_col[3 * kT + tid];
        col_run[tid] = first ? cs : col_run[tid] + cs;
      } else if (tid < 2 * kT) {           // row sums of this column tile
        const int r = tid - kT;
        const float rs = red_row[r] + red_row[kT + r];
        if (first)
          diag_row[r] = rs;
        else if (i0 + r < l)
          part[(jt * rows + row_of(h)) * l + i0 + r] = rs;
      }
      if (last) {                          // dX of head h, rows j of jt
        T* dxh = dx + (cell * l * H + h) * (int64_t)P;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int p = 32 * ch + 8 * nt + 2 * t;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + 16 * rg + g + (e & 2) * 4, pe = p + (e & 1);
            if (j < l && pe < P)
              dxh[(int64_t)j * H * P + pe] = from_f<T>(run[nt][e]);
          }
        }
      }
      if (pre) x_store(xs, cum_s, v, cm, l_pad);   // X and cum of h + 1
    }
    __syncthreads();
    if (tid < kT && j0 + tid < l)          // the last head's sums
      part[(jt * rows + row_of(H - 1)) * l + j0 + tid] =
          diag_row[tid] - col_run[tid];

    // ---- dB[jt] = sum_it dG^T C[it]; dC[it] share = dG B[jt] ------------
    float* bst = ys;                       // B[jt], rows j, one N chunk
    float* cst = ys + kStage;              // C[it], rows i, one N chunk
    for (int n0 = 0; n0 < N; n0 += kT) {
      const int nn = min(kT, N - n0);
      __syncthreads();
      stage<kT>(bst, kLd, bb + (int64_t)j0 * N + n0, N, l - j0, nn);
      float dbr[4][4];
      zero(dbr);
      for (int it = jt; it < n_rt; ++it) {
        const int i0 = it * kT;
        const float4* dgf = reinterpret_cast<const float4*>(
                                dg_s + (it - jt) * kFrag) + lane;
        stage<kT>(cst, kLd, cb + (int64_t)i0 * N + n0, N, l - i0, nn);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {   // dG^T of the tile into wt
          const float4 v = dgf[(warp * 4 + nt) * 32];
          const int jl = 32 * ch + 8 * nt + 2 * t, il = 16 * rg + g;
          wt[jl * kLd + il] = v.x;
          wt[(jl + 1) * kLd + il] = v.y;
          wt[jl * kLd + il + 8] = v.z;
          wt[(jl + 1) * kLd + il + 8] = v.w;
        }
        __syncthreads();
        // dC share, rows i 16 rg .., columns n 32 ch ..: A is dG from the
        // fragments with k permuted (accumulator column 2t as k t, 2t + 1
        // as t + 4), so B takes rows 2t and 2t + 1 of each 8
        float acc[4][4];
        zero(acc);
#pragma unroll
        for (int kb = 0; kb < 8; ++kb) {
          const float4 v = dgf[((rg + 4 * (kb / 4)) * 4 + kb % 4) * 32];
          const uint32_t af[4] = {__float_as_uint(v.x), __float_as_uint(v.z),
                                  __float_as_uint(v.y), __float_as_uint(v.w)};
          uint32_t ah[4], al[4];
          split4<true>(af, ah, al);
          const float* b0 = bst + (8 * kb + 2 * t) * kLd + 32 * ch + g;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (32 * ch + 8 * nt >= nn) break;
            uint32_t bh0, bl0, bh1, bl1;
            split<!kExact>(b0[8 * nt], bh0, bl0);
            split<!kExact>(b0[kLd + 8 * nt], bh1, bl1);
            mma<true, !kExact>(acc[nt], ah, al, bh0, bh1, bl0, bl1);
          }
        }
        float* dci = dcp + (jt * cells + cell) * l * N;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + 16 * rg + g + (e & 2) * 4;
            const int n = 32 * ch + 8 * nt + 2 * t + (e & 1);
            if (i < l && n < nn) dci[(int64_t)i * N + n0 + n] = acc[nt][e];
          }
        // dB, rows j 16 rg .., columns n 32 ch ..: dG^T C[it] fresh
        float fresh[4][4];
        zero(fresh);
        mma_ab<!kExact>(fresh, smem_addr(wt), cst, nn, rg, ch, lane);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) dbr[nt][e] += fresh[nt][e];
        __syncthreads();                   // cst and wt read
      }
      T* dbc = db + cell * l * N;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + 16 * rg + g + (e & 2) * 4;
          const int n = 32 * ch + 8 * nt + 2 * t + (e & 1);
          if (j < l && n < nn)
            dbc[(int64_t)j * N + n0 + n] = from_f<T>(dbr[nt][e]);
        }
    }
  }
}

// dc[cell][i][n] = the column tiles' shares jt <= i / 64, added in order
template <typename T>
__global__ void __launch_bounds__(256)
dc_sum_kernel(const float* __restrict__ dcp, T* __restrict__ dc,
              int64_t total, int l, int N) {
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int i = (int)((idx / N) % l);
    float s = 0.f;
    for (int jt = 0; jt <= i / kT; ++jt) s += dcp[jt * total + idx];
    dc[idx] = from_f<T>(s);
  }
}

// da[row][k] = sum_{m >= k} dcum[m], dcum[m] the column tiles' shares of
// row m's sum (less its column sum) added in order; the reverse cumsum in
// fp64, rounded once.  One warp a (b, h, c) row: lane t takes ceil(l / 32)
// consecutive m and sums them, a shuffle scan adds the lanes after it, a
// second pass (the shares read again) writes.
__device__ __forceinline__ float dcum_at(const float* __restrict__ part,
                                         int64_t rows, int row, int l,
                                         int m) {
  float s = 0.f;
  for (int jt = 0; jt <= m / kT; ++jt)
    s += part[((int64_t)jt * rows + row) * l + m];
  return s;
}
__global__ void __launch_bounds__(256)
da_kernel(const float* __restrict__ part, float* __restrict__ da, int rows,
          int l) {
  const int row = (int)((blockIdx.x * (int64_t)blockDim.x + threadIdx.x) /
                        32);
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int seg = (l + 31) / 32, k0 = lane * seg, k1 = min(k0 + seg, l);
  double incl = 0.0;                       // this lane's and the later ones'
  for (int m = k0; m < k1; ++m) incl += (double)dcum_at(part, rows, row, l, m);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += u;
  }
  double run = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) run = 0.0;
  for (int m = k1 - 1; m >= k0; --m) {
    run += (double)dcum_at(part, rows, row, l, m);
    da[(int64_t)row * l + m] = (float)run;
  }
}

template <bool kExact, typename T>
int launch(const void* x, const void* a, const void* b, const void* c,
           const void* dy, void* dx, void* da, void* db, void* dc,
           void* scratch, int B, int nc, int l, int H, int P, int N,
           cudaStream_t stream) {
  const int n_rt = (l + kT - 1) / kT, l_pad = n_rt * kT;
  const int64_t rows = (int64_t)B * H * nc, cells = (int64_t)B * nc;
  float* cum = static_cast<float*>(scratch);          // [rows][l_pad]
  float* part = cum + rows * l_pad;                    // [n_rt][rows][l]
  float* dcp = part + n_rt * rows * l;                 // [n_rt][cells][l][N]
  const unsigned row_blocks = (unsigned)((rows * 32 + 255) / 256);
  cum_kernel<<<row_blocks, 256, 0, stream>>>(
      static_cast<const float*>(a), cum, (int)rows, l, l_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int cached = n_rt <= kCachedTiles;
  const size_t smem =
      sizeof(float) * ((size_t)(n_rt + (cached ? n_rt : 1)) * kFrag +
                       3 * kStage + kWt + l_pad + 8 * kT);
  auto kernel = ssd_bwd_main<kExact, T>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = P % 4 == 0 && (uintptr_t)dy % 16 == 0;
  const int64_t blocks = cells * ((n_rt + 1) / 2);
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), cum, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(dy),
      static_cast<T*>(dx), static_cast<T*>(db), part, dcp, nc, l, H, P, N,
      cached, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int64_t total = cells * l * N;
  const int64_t dc_blocks = (total + 255) / 256;
  dc_sum_kernel<T><<<(unsigned)(dc_blocks < 8192 ? dc_blocks : 8192), 256, 0,
                     stream>>>(dcp, static_cast<T*>(dc), total, l, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  da_kernel<<<row_blocks, 256, 0, stream>>>(part, static_cast<float*>(da),
                                            (int)rows, l);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b, c and their gradients).
// scratch: B H nc l_pad + n_rt (B H nc l + B nc l N) floats, l_pad the
// chunk rounded up to 64 and n_rt = l_pad / 64.
extern "C" int repro_ssd_chunk_bwd(const void* x, const void* a,
                                   const void* b, const void* c,
                                   const void* dy, void* dx, void* da,
                                   void* db, void* dc, void* scratch, int B,
                                   int nc, int l, int H, int P, int N,
                                   int dtype, void* stream) {
  if ((int64_t)B * nc * l == 0) return 0;
  if (dtype == 1)
    return launch<true, __nv_bfloat16>(x, a, b, c, dy, dx, da, db, dc,
                                       scratch, B, nc, l, H, P, N,
                                       (cudaStream_t)stream);
  return launch<false, float>(x, a, b, c, dy, dx, da, db, dc, scratch, B, nc,
                              l, H, P, N, (cudaStream_t)stream);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
