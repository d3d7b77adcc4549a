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
// x, dx: [B, nc, l, H, 64]; a, da: [B, H, nc, l] fp32; b, c, db, dc:
// [B, nc, l, N]; dy: [B, nc, l, H, 64] fp32.  All contiguous, x and dy on
// 16 bytes; l <= 512.  The wrapper (kernels/ssd_chunk_bwd.py) pads a head
// dim below 64 with zeros.
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
// almost all per head (dW and dX); on the routes below they take about
// as long as the bytes at the tensor cores' peaks, so the bound is the
// bytes.  What holds this kernel back is neither: the elementwise pass
// between the two products (L, W, M, dG, W^T's planes and M's sums,
// element by element) takes about as long to issue as the products run.
//
// Five launches, no atomics anywhere:
//  1. cum: one warp a (b, h, c) row: cumsum(a) in fp64, rounded once, as
//     the forward and ssd_chunk_plain take it.
//  2. g: G's tiles on and below the diagonal, one CTA a (cell, tile), on
//     TF32 mma.sync (one pass in bf16, where C and B are exact in TF32;
//     3xTF32 in fp32), into scratch in the main pass's fragment order.
//  3. main: one CTA an item (column tile jt of 64 columns j, cell, group
//     of heads), the longest column tiles first; per head and row tile it
//     >= jt (a step): dW, L, W, M, dG's share, dX's share (below).  The
//     heads split into groups (kernels/ssd_chunk_bwd.py's head_group:
//     about 512 items, so that Mamba2-1.3B's 64 cells and 64 heads and
//     the reduced Jamba's 32 cells and 128 heads both give 512 items of
//     32 heads, four a streaming multiprocessor); a group's dG partial
//     goes to scratch.
//  4. dbdc: dB and dC, one CTA a tile of 64 rows and a 64-column chunk
//     of N on 8 warps of TF32 mma.sync (fp32 operands split hi + lo; B
//     and C exact in bf16), from dG's tiles (the groups' partials added
//     in order): dB[jt] = sum over it >= jt of dG[it, jt]^T C[it], dC[it]
//     = sum over jt <= it of dG[it, jt] B[jt], each tile's product fresh.
//  5. da adds the shares of each row sum, less the column sums, and takes
//     the reverse cumsum in fp64.
//
// main, warp-specialised (hopper.cuh's skeleton): 384 threads; warpgroups
// 0 and 1 consume, warpgroup 2 produces (one thread issues every TMA
// load; setmaxnreg gives it 40 registers and the consumers 232).
//  * Loads: dY's tile of a step (64 rows x 64 fp32, two boxes of 32
//    columns under the 128-byte swizzle) streams by TMA through a ring of
//    3 stages with a full and an empty mbarrier each; X's tile (64 rows j)
//    and the head's cum row come per head into one of two slots (their
//    own full / empty barriers), so the next head's X loads during this
//    one.  The consumers never wait for the ring to drain.
//  * dW = dY X^T, consumer w the columns j 32 w .. 32 w + 31 (wgmma
//    m64n32k16), dY as the register A operand read from the stage and
//    split into two bf16 parts (hi + lo: 16 significant bits), X the
//    K-major B operand: in bf16 its TMA tile, exact (2 passes); in fp32
//    split once a head into bf16 hi and lo planes (3 passes: d_lo x_hi,
//    d_hi x_lo, d_hi x_hi).  tests/test_torch_ssd_grad.py emulates both:
//    one bf16 part of dY misses ATOL, two hold it.
//  * Elementwise, in dW's accumulator layout: L by __expf (argument <= 0:
//    above the diagonal and past l it is -inf, so L, W, M and dW o L are
//    exact zeros there; only the diagonal tile and rows past l are
//    masked), G from scratch (L2), W = G L, M = dW W; dG's share dW o L
//    added into the item's dG tile (each thread its own slots, the heads
//    in order); W written transposed as TF32 hi and lo planes (rows j,
//    K-major); M's row sums over the consumer's 32 columns go to scratch
//    (one share a (jt, consumer)), its column sums over the tile's 64
//    rows (a 16-row warp's, halved across lanes, then the 4 warps in
//    order) run over the row tiles in order.
//  * dX^T = dY^T W, consumer w over rows i 32 w .. 32 w + 31 and every
//    column j (wgmma m64n64k8, TF32 as 3xTF32 in both dtypes: W and dY
//    are fp32): TF32 wgmma reads only K-major operands from shared
//    memory, so dY^T is the register A operand (dY's stage read
//    transposed, split hi + lo) and W^T's planes the K-major B operand.
//    Each row tile's product goes into a fresh accumulator added to the
//    head's running sum in fp32 (the tensor cores truncate as they
//    accumulate: chained over row tiles that bias grows).  At a head's
//    end the two consumers' sums meet in shared memory, consumer 0's plus
//    consumer 1's, and leave transposed, 16 bytes a store.
//  * Both consumers meet twice a step (W^T's planes complete before
//    either reads them, both products done before they are rewritten) and
//    take turns at the tensor cores (hopper.cuh).
//  * dG's tiles lie in shared memory at l <= 256 (4 x 16 KB) and are
//    copied to the group's scratch at the item's end; at l in (256, 512]
//    they do not fit, and the same loop adds into the scratch in place.
//
// Why the order of every sum is fixed (two calls give the same bits, so
// the trainer resumes bit-equal): every output element and every scratch
// share has one writer; dG sums a group's heads in order inside one
// thread and the groups in order in dbdc; row and column sums, dX's row
// tiles and halves, dB's row tiles and dC's column tiles run in fixed
// orders; no atomics.  Which CTA takes an item depends only on the shape.
//
// Shared memory (main): the ring 3 x 16 KB, X slots 2 x 8 KB (bf16) or 2
// x 16 KB and X's bf16 planes 16 KB (fp32), W^T's planes 32 KB, cum 4 KB,
// sums 3 KB, dG 64 KB: 171 KB in bf16, 205 KB in fp32, one CTA an SM
// (227 KB).  Registers: 168 a thread at launch (384 threads); a consumer
// holds dX^T's running and fresh sums (2 x 32), dW (16), G (16) and one
// product's A operand (32), with no spill (nvcc -Xptxas -v).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

#include "hopper.cuh"
#include "ssd.cuh"
#include "tf32.cuh"

namespace {

using ssd::smem_addr;

constexpr int kThreads = 256;            // the mma.sync passes: 8 warps
constexpr int kT = 64;                   // rows i and columns j of a tile
constexpr int kLd = kT + 4;              // staged rows 272 B apart
constexpr int kStage = kT * kLd;         // floats of a staged 64 x 64 tile
constexpr int kFrag = kT * kT;           // floats of a tile as fragments

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

// rows [0, 64) and columns [0, 64) of a row-major matrix at src (row
// stride ld) into dst (rows kLd floats apart) as fp32, zeros at rows >=
// nr and columns >= ncols: 16-byte loads where every row starts on 16
// bytes and ncols is whole 16-byte pieces, single elements otherwise
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t ld,
                                      int nr, int ncols) {
  constexpr int kV = 16 / (int)sizeof(T);  // values a 16-byte piece
  const bool vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   (ld * (int64_t)sizeof(T)) % 16 == 0 && ncols % kV == 0;
  if (vec) {
    for (int idx = threadIdx.x; idx < kT * (kT / kV); idx += kThreads) {
      const int r = idx / (kT / kV), k = (idx % (kT / kV)) * kV;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (r < nr && k < ncols)
        u = *reinterpret_cast<const uint4*>(src + r * ld + k);
      float4* d = reinterpret_cast<float4*>(dst + r * kLd + k);
      if constexpr (sizeof(T) == 4) {
        d[0] = make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                           __uint_as_float(u.z), __uint_as_float(u.w));
      } else {
        const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 a = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w4[2 * e]));
          const float2 b = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w4[2 * e + 1]));
          d[e] = make_float4(a.x, a.y, b.x, b.y);
        }
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < kT * kT; idx += kThreads) {
      const int r = idx / kT, k = idx % kT;
      dst[r * kLd + k] = (r < nr && k < ncols) ? to_f(src[r * ld + k]) : 0.f;
    }
  }
}

// tile (it, jt), jt <= it, of a chunk's lower triangle of 64 x 64 tiles
__device__ __forceinline__ int tile_of(int it, int jt) {
  return it * (it + 1) / 2 + jt;
}

// A tile of 64 x 64 fp32 as accumulator fragments, float4 (column pair
// group nt, warp row group rg, lane) at ((ch * 4 + nt) * 128 + rg * 32 +
// lane): for the main pass, consumer ch's warp rg, its dW columns 8 nt ..;
// for an 8-warp mma.sync CTA, warp rg + 4 ch.  mma.sync m16n8 and wgmma
// m64nN give a warp the same accumulator layout, so the two passes share
// it: element e of the float4 is row 16 rg + lane / 4 + 8 (e / 2), column
// 32 ch + 8 nt + 2 (lane % 4) + e % 2.
__device__ __forceinline__ int frag4(int ch, int nt, int rg, int lane) {
  return (ch * 4 + nt) * 128 + rg * 32 + lane;
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

// G's tile (it, jt) of one cell: rows i0 .. (C) and columns j0 .. (B), N
// in steps of 64 through shared memory, one pass in bf16 (exact), three
// in fp32; written in fragment order to g[cell][tile]
template <bool kExact, typename T>
__global__ void __launch_bounds__(kThreads)
g_kernel(const T* __restrict__ b, const T* __restrict__ c,
         float* __restrict__ g, int l, int N, int n_tiles) {
  __shared__ __align__(16) float staging[2 * kStage];
  const int64_t cell = blockIdx.x / n_tiles;
  const int tile = (int)(blockIdx.x % n_tiles);
  int it = 0;
  while (tile_of(it + 1, 0) <= tile) ++it;
  const int jt = tile - tile_of(it, 0);
  const int i0 = it * kT, j0 = jt * kT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % 4, ch = warp / 4;
  const T* cb = c + cell * l * N;
  const T* bb = b + cell * l * N;
  float* cst = staging;
  float* bst = staging + kStage;
  float acc[4][4];
  zero(acc);
  for (int n0 = 0; n0 < N; n0 += kT) {
    __syncthreads();                       // the staging's last readers done
    stage(cst, cb + (int64_t)i0 * N + n0, N, l - i0, N - n0);
    stage(bst, bb + (int64_t)j0 * N + n0, N, l - j0, N - n0);
    __syncthreads();
    mma_abt<!kExact, !kExact>(acc, smem_addr(cst), smem_addr(bst), kLd,
                              (min(kT, N - n0) + 7) / 8, rg, ch, lane);
  }
  float4* d = reinterpret_cast<float4*>(g + (cell * n_tiles + tile) * kFrag);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    d[frag4(ch, nt, rg, lane)] =
        make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
}

// --------------------------------------------------------------------- //
// main: wgmma fed by TMA, warp-specialised
// --------------------------------------------------------------------- //
namespace wg {

constexpr int kThreads = 384;       // warpgroups 0 and 1 consume, 2 produces
constexpr int kConsumers = 256;     // arrivals that release a stage
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kProducerRegs * 128 + kConsumerRegs * 256 <= 65536,
              "setmaxnreg budget");
constexpr int kStages = 3;
constexpr int kTileBytes = kT * kT * 4;   // an fp32 64 x 64 tile: 16 KB
constexpr int kBox = 8192;                // 64 rows of 128 bytes
constexpr int kMaxLPad = 512;
constexpr int kSmemDgTiles = 4;           // dG in shared memory at l <= 256

// byte offsets from a 1024-aligned base: dY ring | X slots | X's bf16
// planes (fp32) | W^T's planes | cum slots | column sums | diagonal row
// sums | mbarriers | dG tiles
template <bool kBf16>
struct Smem {
  static constexpr int kXBytes = kBf16 ? kTileBytes / 2 : kTileBytes;
  static constexpr int kDy = 0;
  static constexpr int kX = kDy + kStages * kTileBytes;
  static constexpr int kX1 = kX + 2 * kXBytes;          // fp32: X's bf16
  static constexpr int kX2 = kX1 + kTileBytes / 2;      // hi and lo planes
  static constexpr int kWh = kX1 + (kBf16 ? 0 : kTileBytes);
  static constexpr int kWl = kWh + kTileBytes;
  static constexpr int kCum = kWl + kTileBytes;          // [2][kMaxLPad]
  static constexpr int kRed = kCum + 2 * kMaxLPad * 4;   // [2][2][4][32]
  static constexpr int kDiag = kRed + 2 * 2 * 4 * 32 * 4;  // [2][2][64]
  static constexpr int kBar = kDiag + 2 * 2 * 64 * 4;
  static constexpr int kDg = kBar + 8 * (2 * kStages + 4) + 48;
  static constexpr int bytes(int dg_tiles) {
    return kDg + dg_tiles * kTileBytes + 1024;
  }
};
static_assert(Smem<false>::bytes(kSmemDgTiles) <= 232448 &&
              Smem<true>::bytes(kSmemDgTiles) <= 232448,
              "shared memory of one CTA");
static_assert(Smem<false>::kDg % 16 == 0 && Smem<true>::kDg % 16 == 0,
              "dG tiles on 16 bytes");

struct Params {
  const float* cum;        // [B H nc][l_pad]
  const float* g;          // [cells][n_tiles][kFrag], fragment order
  float* dgp;              // [groups][cells][n_tiles][kFrag]
  float* part;             // [n_rt][2][B H nc][l]
  void* dx;                // [B nc l H 64]
  int nc, l, H, n_rt, l_pad, n_tiles, hg, groups, cells, dg_smem;
};

// a consumer's own barrier (3 or 4: 1 and 2 are hopper.cuh's turns), and
// both consumers' (5)
__device__ __forceinline__ void wg_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(3 + w) : "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 5, 256;\n" ::: "memory");
}

#define SSD_ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), \
    "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
    "+f"(d[i + 7])
// D[64 x 32] (+)= A[64 x 16] B[16 x 32], bf16: A in registers, B K-major
// in shared memory; D is overwritten when accumulate is 0
__device__ __forceinline__ void wgmma_bf16_n32(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : SSD_ACC8(0), SSD_ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
#undef SSD_ACC8

// byte offset of element (r, k) of a 64-row tile of fp32 in two boxes of
// 32 columns under the 128-byte swizzle (TMA's layout of dY and X, and
// the planes': K-major for wgmma)
__device__ __forceinline__ uint32_t off32(int r, int k) {
  return (uint32_t)((k >> 5) * kBox + tf32::swz<128>(r, (k & 31) >> 2) +
                    (k & 3) * 4);
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e]) :: "memory");
}

// dY^T's TF32 hi and lo parts over rows i 32 w .. 32 w + 31, consumer w's
// share of dX^T's register A operand, from dY's stage: k8 step kk holds
// rows p il0 and il0 + 8 at dY rows i 32 w + 8 kk + t and + 4.  ybase[e]:
// element e's offset at kk 0 (the swizzle depends on the row mod 8 only,
// so step kk adds 8 rows: 1,024 bytes).
__device__ __forceinline__ void load_dyt(const uint8_t* dys,
                                         const uint32_t (&ybase)[4],
                                         uint32_t (&yh)[4][4],
                                         uint32_t (&yl)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tf32::split(*reinterpret_cast<const float*>(dys + ybase[e] + 1024 * kk),
                  yh[kk][e], yl[kk][e]);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
main_kernel(const __grid_constant__ CUtensorMap tdy,
            const __grid_constant__ CUtensorMap tx, const Params p) {
  using S = Smem<kBf16>;
  using T = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(sm);
  const uint32_t full = base + S::kBar, empty = full + 8 * kStages;
  const uint32_t xfull = empty + 8 * kStages, xempty = xfull + 16;

  // the item: longest column tiles first, then cell, then head group
  const int per_jt = p.cells * p.groups;
  const int jt = (int)(blockIdx.x / per_jt);
  const int cell = (int)(blockIdx.x % per_jt) / p.groups;
  const int grp = (int)(blockIdx.x % per_jt) % p.groups;
  const int bi = cell / p.nc, ci = cell % p.nc;
  const int h0 = grp * p.hg, h1 = min(p.H, h0 + p.hg);
  const int n_it = p.n_rt - jt, j0 = jt * kT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, kConsumers);
    }
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(xfull + 8 * s, 1);
      sm90::mbar_init(xempty + 8 * s, kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread issues the loads in order, X and cum of a head
    // into slot h % 2 and dY of each step into the ring; a wait on an
    // empty barrier takes the opposite parity, so the first pass through
    // is free
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      int n = 0;
      for (int hx = 0; hx < h1 - h0; ++hx) {
        const int h = h0 + hx, xs = hx & 1;
        sm90::mbar_wait(xempty + 8 * xs, ((hx >> 1) & 1) ^ 1);
        sm90::mbar_expect_tx(xfull + 8 * xs, S::kXBytes + p.l_pad * 4);
        const uint32_t xd = base + S::kX + xs * S::kXBytes;
        sm90::tma_load(xd, &tx, xfull + 8 * xs, 0, h, j0, cell);
        if (!kBf16)
          sm90::tma_load(xd + kBox, &tx, xfull + 8 * xs, 32, h, j0, cell);
        const int64_t row = ((int64_t)bi * p.H + h) * p.nc + ci;
        sm90::bulk_load(base + S::kCum + xs * kMaxLPad * 4,
                        p.cum + row * p.l_pad, p.l_pad * 4, xfull + 8 * xs);
        for (int it = jt; it < p.n_rt; ++it, ++n) {
          const int st = n % kStages;
          sm90::mbar_wait(empty + 8 * st, ((n / kStages) & 1) ^ 1);
          sm90::mbar_expect_tx(full + 8 * st, kTileBytes);
          const uint32_t dst = base + S::kDy + st * kTileBytes;
          sm90::tma_load(dst, &tdy, full + 8 * st, 0, h, it * kT, cell);
          sm90::tma_load(dst + kBox, &tdy, full + 8 * st, 32, h, it * kT,
                         cell);
        }
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int w = threadIdx.x / 128;         // columns 32 w .. 32 w + 31
  const int ct = threadIdx.x - 128 * w;
  const int warp = ct / 32, lane = ct % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t rows = (int64_t)p.cells * p.H;
  float* red = reinterpret_cast<float*>(sm + S::kRed) + w * 2 * 4 * 32;
  float* diag = reinterpret_cast<float*>(sm + S::kDiag) + w * 2 * 64;
  float4* dg = p.dg_smem
                   ? reinterpret_cast<float4*>(sm + S::kDg)
                   : reinterpret_cast<float4*>(
                         p.dgp + ((int64_t)grp * p.cells + cell) * p.n_tiles *
                                     kFrag);
  // the item's dG tiles: tile it - jt in shared memory, tile (it, jt) of
  // the group's scratch otherwise
  auto dg_tile = [&](int it) {
    return dg + (p.dg_smem ? (it - jt) : tile_of(it, jt)) * (kFrag / 4);
  };
  for (int it = jt; it < p.n_rt; ++it)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      dg_tile(it)[frag4(w, nt, warp, lane)] = make_float4(0.f, 0.f, 0.f, 0.f);

  const float4* gsrc =
      reinterpret_cast<const float4*>(p.g + (int64_t)cell * p.n_tiles * kFrag);
  // W^T's columns i 32 w .. 32 w + 31 (one box), every row j
  const uint32_t wh_w = base + S::kWh + w * kBox;
  const uint32_t wl_w = base + S::kWl + w * kBox;
  const int il0 = 16 * warp + g;           // the thread's rows il0, il0 + 8
  // byte offsets in a 64-row fp32 tile of the elements a thread reads or
  // writes, at their first step; the rest add whole boxes (8,192 bytes)
  // or 8-row groups (1,024), which keep the swizzle (module notes)
  uint32_t ybase[4], abase[8], wbase[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ybase[e] = off32(32 * w + t + 2 * (e & 2), il0 + 8 * (e & 1));
    wbase[e] = off32(32 * w + 2 * t + (e & 1), il0 + 4 * (e & 2));
  }
#pragma unroll
  for (int q = 0; q < 8; ++q)              // q = 4 (kk % 2) + e
    abase[q] = off32(il0 + 8 * (q & 1), 16 * (q >> 2) + 2 * t + 4 * (q & 2));
  float col_run = 0.f;                     // column 32 w + lane (warp w)
  // dX^T over this consumer's rows i, all 64 columns j: the head's sum
  // and a row tile's
  float run[32], fresh[32], dw[16];
  float4 gv[4];                            // G of the step, dW's layout
  uint32_t yh[4][4], yl[4][4];             // dX's A operand: dY^T, k8 steps
  uint32_t ah[4][4], al[4][4];             // dW's: dY's bf16 parts, k16

  // a head's X (and cum) in; in fp32 X's rows of this consumer as bf16
  // hi and lo planes (16 significant bits), in the layout of a bf16 TMA
  // tile: rows j of 128 bytes, 16-byte chunk c at c ^ (j % 8)
  auto head_in = [&](int hx) {
    const int xs = hx & 1;
    sm90::mbar_wait(xfull + 8 * xs, (hx >> 1) & 1);
    if (!kBf16) {
      const uint32_t xslot = S::kX + xs * S::kXBytes;
      for (int q = ct; q < 32 * 8; q += 128) {
        const int r = 32 * w + q / 8, c = q % 8;
        const float4 u = *reinterpret_cast<const float4*>(
            sm + xslot + off32(r, 8 * c));
        const float4 v = *reinterpret_cast<const float4*>(
            sm + xslot + off32(r, 8 * c + 4));
        const float x[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 h2 =
              __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
          const float2 hf = __bfloat1622float2(h2);
          const __nv_bfloat162 l2 =
              __floats2bfloat162_rn(x[2 * e] - hf.x, x[2 * e + 1] - hf.y);
          hi[e] = *reinterpret_cast<const uint32_t*>(&h2);
          lo[e] = *reinterpret_cast<const uint32_t*>(&l2);
        }
        const int o = tf32::swz<128>(r, c);
        *reinterpret_cast<uint4*>(sm + S::kX1 + o) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(sm + S::kX2 + o) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      tf32::fence_async_smem();
      wg_sync(w);
    }
  };
  // step s's G (from scratch) and dW's A operand (from its dY stage, once
  // it is in)
  auto dw_in = [&](int it, int st, uint32_t ph) {
    const float4* gt = gsrc + tile_of(it, jt) * (kFrag / 4);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) gv[nt] = gt[frag4(w, nt, warp, lane)];
    sm90::mbar_wait(full + 8 * st, ph);
    const uint8_t* dys = sm + S::kDy + st * kTileBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // row il0 + 8 (e % 2), columns 16 kk + 2 t + 8 (e / 2), + 1
        const float2 v = *reinterpret_cast<const float2*>(
            dys + abase[4 * (kk & 1) + e] + (kk >> 1) * kBox);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v.x, v.y);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(v.x - hf.x, v.y - hf.y);
        ah[kk][e] = *reinterpret_cast<const uint32_t*>(&hi);
        al[kk][e] = *reinterpret_cast<const uint32_t*>(&lo);
      }
  };
  // dW = dY X^T for step s: rows i of its row tile, the consumer's
  // columns j (issued, not committed)
  auto dw_issue = [&](int xs) {
    const uint32_t xslot = base + S::kX + xs * S::kXBytes;
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bx =
            tf32::kmajor_desc<128>(xslot + 32 * w * 128 + kk * 32);
        wgmma_bf16_n32(dw, al[kk], bx, kk > 0);
        wgmma_bf16_n32(dw, ah[kk], bx, 1);
      }
    } else {                               // d2 x1, d1 x2, d1 x1
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t o = 32 * w * 128 + kk * 32;
        const uint64_t b1 = tf32::kmajor_desc<128>(base + S::kX1 + o);
        wgmma_bf16_n32(dw, al[kk], b1, kk > 0);
        wgmma_bf16_n32(dw, ah[kk], tf32::kmajor_desc<128>(base + S::kX2 + o),
                       1);
        wgmma_bf16_n32(dw, ah[kk], b1, 1);
      }
    }
  };
  // the end of step s's head: dX's rows j of the consumer (run[4 nt + e]
  // is row p = il0 + 8 (e / 2), column j = 32 w + 8 nt + 2 t + e % 2), and
  // the diagonal tile's row sums less the column sums of this consumer's
  // columns (their own threads: warp w)
  auto head_out = [&](int hx, int64_t row) {
    const int h = h0 + hx;
    // each consumer holds dX^T over its rows i: the other's share of this
    // consumer's columns comes through shared memory (W^T's hi plane, free
    // once both consumers' last products are done), the two added in
    // consumer order (w selects between registers: an index that depends
    // on it would put run in local memory)
    float4* xb = reinterpret_cast<float4*>(sm + S::kWh);
    consumers_sync();                      // both consumers' dX^T done
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        r[e] = w == 0 ? run[4 * (4 + nt) + e] : run[4 * nt + e];
      xb[((1 - w) * 4 + nt) * 128 + ct] = make_float4(r[0], r[1], r[2], r[3]);
    }
    consumers_sync();
    // dX rows j of this consumer, transposed through W^T's lo plane (rows j
    // of 64 fp32, 16-byte chunk c at c ^ (j % 8)), then stored a row at a
    // time in 16-byte pieces
    uint8_t* tr = sm + S::kWl + w * 32 * 256;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float4 o4 = xb[(w * 4 + nt) * 128 + ct];
      const float other[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mine = w == 0 ? run[4 * nt + e] : run[4 * (4 + nt) + e];
        const int jr = 8 * nt + 2 * t + (e & 1), pc = il0 + 4 * (e & 2);
        *reinterpret_cast<float*>(tr + jr * 256 +
                                  (((pc >> 2) ^ (jr & 7)) << 4) +
                                  (pc & 3) * 4) =
            w == 0 ? mine + other[e] : other[e] + mine;
      }
    }
    wg_sync(w);
    T* dxh = static_cast<T*>(p.dx) + (((int64_t)cell * p.l) * p.H + h) * 64;
    constexpr int kPer = 16 / (int)sizeof(T);          // elements a store
    for (int q = ct; q < 32 * (64 / kPer); q += 128) {
      const int jr = q / (64 / kPer), p0 = (q % (64 / kPer)) * kPer;
      const int j = j0 + 32 * w + jr;
      float v[kPer];
#pragma unroll
      for (int c = 0; c < kPer / 4; ++c) {
        const float4 f = *reinterpret_cast<const float4*>(
            tr + jr * 256 + ((((p0 >> 2) + c) ^ (jr & 7)) << 4));
        v[4 * c] = f.x;
        v[4 * c + 1] = f.y;
        v[4 * c + 2] = f.z;
        v[4 * c + 3] = f.w;
      }
      if (j < p.l) {
        T* dst = dxh + (int64_t)j * p.H * 64 + p0;
        if constexpr (kBf16) {
          uint32_t u[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            u[e] = sm90::pack_bf16(v[2 * e], v[2 * e + 1]);
          *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
        } else {
          *reinterpret_cast<float4*>(dst) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    // the diagonal tile's row sums less the column sums of this consumer's
    // columns (their own threads: warp w)
    if (ct < 64 && j0 + ct < p.l) {
      float v = diag[(hx & 1) * 64 + ct];
      if (warp == w) v -= col_run;
      p.part[((int64_t)(jt * 2 + w) * rows + row) * p.l + j0 + ct] = v;
    }
  };

  // a step: dW (its operands in registers and the X tile), then the
  // elementwise pass, then dX; the two consumers take turns at the tensor
  // cores (hopper.cuh), so that one's elementwise pass runs while the
  // other's products do
  sm90::turn_start(w);
  int s = 0, st = 0;                       // the step, its stage of the ring
  uint32_t ph = 0;                         // and the stage's phase
  for (int hx = 0; hx < h1 - h0; ++hx) {
    head_in(hx);
    const int64_t row = ((int64_t)bi * p.H + h0 + hx) * p.nc + ci;
    float* prow = p.part + ((int64_t)(jt * 2 + w) * rows + row) * p.l;
    const float* cs = reinterpret_cast<const float*>(sm + S::kCum) +
                      (hx & 1) * kMaxLPad;
    for (int it = jt; it < p.n_rt; ++it, ++s) {
      const bool first = it == jt, last = it == p.n_rt - 1;
      const int i0 = it * kT, par = s & 1;
      dw_in(it, st, ph);
      sm90::turn_wait(w);
      tf32::wgmma_fence();
      dw_issue(hx & 1);
      tf32::wgmma_commit();
      sm90::turn_pass(w);
      load_dyt(sm + S::kDy + st * kTileBytes, ybase, yh, yl);   // dX's operand
      tf32::wgmma_wait<0>();
      tf32::reg_fence(dw);
      fence_regs(ah);
      fence_regs(al);
      sm90::mbar_arrive(empty + 8 * st);     // dY's stage read
      if (++st == kStages) {
        st = 0;
        ph ^= 1;
      }
      consumers_sync();                      // both consumers' last dX^T done

      // ---- L, W, M and dG, element by element ---------------------------
      const int ia = i0 + il0, ib = ia + 8;
      // masked: the diagonal tile (L 0 above it) or rows past l (L 0)
      auto elem = [&](auto masked) {
        const float ca = cs[ia], cb = cs[ib];
        float4* dgt = dg_tile(it);
        float rs_a = 0.f, rs_b = 0.f;
        float cv[8];                       // column sums: 2 nt + e % 2
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int jl = 32 * w + 8 * nt + 2 * t, ja = j0 + jl;
          const float cja = cs[ja], cjb = cs[ja + 1];
          float ex[4] = {ca - cja, ca - cjb, cb - cja, cb - cjb};
          if constexpr (decltype(masked)::value) {
            // exponents at (ia, ja), (ia, ja + 1), (ib, ja), (ib, ja + 1):
            // -inf (0xff800000) above the diagonal and past l
            const float ninf = __uint_as_float(0xff800000u);
            if (!(ja <= ia && ia < p.l)) ex[0] = ninf;
            if (!(ja + 1 <= ia && ia < p.l)) ex[1] = ninf;
            if (!(ja <= ib && ib < p.l)) ex[2] = ninf;
            if (!(ja + 1 <= ib && ib < p.l)) ex[3] = ninf;
          }
          const float L[4] = {__expf(ex[0]), __expf(ex[1]), __expf(ex[2]),
                              __expf(ex[3])};
          const float gvs[4] = {gv[nt].x, gv[nt].y, gv[nt].z, gv[nt].w};
          float4& dgr = dgt[frag4(w, nt, warp, lane)];
          const float4 dgv = dgr;
          float dgs[4] = {dgv.x, dgv.y, dgv.z, dgv.w};
          float m[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float wv = gvs[e] * L[e];
            m[e] = dw[4 * nt + e] * wv;
            dgs[e] = fmaf(dw[4 * nt + e], L[e], dgs[e]);
            // W^T[j][i] as TF32 hi and lo: rows j, K-major
            uint32_t hi, lo;
            tf32::split(wv, hi, lo);
            const uint32_t o = wbase[e] + 1024 * nt;   // row jl + e % 2
            *reinterpret_cast<uint32_t*>(sm + S::kWh + o) = hi;
            *reinterpret_cast<uint32_t*>(sm + S::kWl + o) = lo;
          }
          dgr = make_float4(dgs[0], dgs[1], dgs[2], dgs[3]);
          rs_a += m[0] + m[1];
          rs_b += m[2] + m[3];
          cv[2 * nt] = m[0] + m[2];
          cv[2 * nt + 1] = m[1] + m[3];
        }
        // column sums of the warp's 16 rows over g, halving the values
        // each step (lane bit 4, 3, 2 of g): lane g then holds column
        // 8 (g / 2) + 2 t + g % 2 of the consumer's 32
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool up = (lane >> 4) & 1;
          cv[q] = (up ? cv[q + 4] : cv[q]) +
                  __shfl_xor_sync(0xffffffffu, up ? cv[q] : cv[q + 4], 16);
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const bool up = (lane >> 3) & 1;
          cv[q] = (up ? cv[q + 2] : cv[q]) +
                  __shfl_xor_sync(0xffffffffu, up ? cv[q] : cv[q + 2], 8);
        }
        {
          const bool up = (lane >> 2) & 1;
          cv[0] = (up ? cv[1] : cv[0]) +
                  __shfl_xor_sync(0xffffffffu, up ? cv[0] : cv[1], 4);
        }
        red[(par * 4 + warp) * 32 + 8 * (g >> 1) + 2 * t + (g & 1)] = cv[0];
        // row sums of the consumer's 32 columns: over t
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          rs_a += __shfl_xor_sync(0xffffffffu, rs_a, off);
          rs_b += __shfl_xor_sync(0xffffffffu, rs_b, off);
        }
        if (t == 0) {
          if (first) {                     // less the column sums, later
            diag[(hx & 1) * 64 + il0] = rs_a;
            diag[(hx & 1) * 64 + il0 + 8] = rs_b;
          } else {
            if (ia < p.l) prow[ia] = rs_a;
            if (ib < p.l) prow[ib] = rs_b;
          }
        }
      };
      if (first || i0 + kT > p.l)
        elem(std::true_type{});
      else
        elem(std::false_type{});
      if (last) sm90::mbar_arrive(xempty + 8 * (hx & 1));   // X, cum read
      tf32::fence_async_smem();
      consumers_sync();                      // W^T's planes and the sums in
      if (warp == w) {                       // column sums, row tiles in order
        const float* rc = red + par * 4 * 32 + lane;
        const float cs4 = rc[0] + rc[32] + rc[64] + rc[96];
        col_run = first ? cs4 : col_run + cs4;
      }

      // ---- dX^T = dY^T W: rows p, the consumer's columns j, fresh --------
      sm90::turn_wait(w);
      tf32::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bh = tf32::kmajor_desc<128>(wh_w + kk * 32);
        const uint64_t bl = tf32::kmajor_desc<128>(wl_w + kk * 32);
        tf32::wgmma_tf32_rs(fresh, yl[kk], bh, kk > 0);
        tf32::wgmma_tf32_rs(fresh, yh[kk], bl, 1);
        tf32::wgmma_tf32_rs(fresh, yh[kk], bh, 1);
      }
      tf32::wgmma_commit();
      sm90::turn_pass(w);
      tf32::wgmma_wait<0>();
      tf32::reg_fence(fresh);
      fence_regs(yh);
      fence_regs(yl);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        run[e] = first ? fresh[e] : run[e] + fresh[e];
    }
    head_out(hx, row);
  }
  if (p.dg_smem) {                         // the group's partial of dG
    float4* out = reinterpret_cast<float4*>(
        p.dgp + ((int64_t)grp * p.cells + cell) * p.n_tiles * kFrag);
    for (int it = jt; it < p.n_rt; ++it)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        out[tile_of(it, jt) * (kFrag / 4) + frag4(w, nt, warp, lane)] =
            dg_tile(it)[frag4(w, nt, warp, lane)];
  }
}

// a [cells, l, H, 64] tensor of fp32 or bf16 as a 4-d tensor map (64, H,
// l, cells) with boxes of box_cols x 1 x 64 x 1 under the 128-byte
// swizzle; rows past l load as zeros
inline int encode(CUtensorMap* map, const void* ptr, bool bf16, int H, int l,
                  int cells, int box_cols) {
  sm90::EncodeTiled fn;
  const int err = sm90::encoder(&fn);
  if (err != 0) return err;
  const cuuint64_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {64, (cuuint64_t)H, (cuuint64_t)l,
                              (cuuint64_t)cells};
  const cuuint64_t strides[3] = {64 * es, (cuuint64_t)H * 64 * es,
                                 (cuuint64_t)l * H * 64 * es};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)kT, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
         4, const_cast<void*>(ptr), dims, strides, box, elem,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : sm90::kEncodeErrorBase + (int)r;
}

}  // namespace wg

// dbdc: dB and dC, one CTA an output tile of 64 rows and a 64-column
// chunk of N, from dG's tiles (the groups' partials added in order), each
// tile's product in a fresh accumulator added to the sum in fp32, in
// order: dB[jt] = sum over it >= jt of dG[it, jt]^T C[it]; dC[it] = sum
// over jt <= it of dG[it, jt] B[jt].  The two kinds alternate, the tiles
// with the most terms first.
template <bool kExact, typename T>
__global__ void __launch_bounds__(kThreads, 2)
dbdc_kernel(const float* __restrict__ dgp, const T* __restrict__ b,
            const T* __restrict__ c, T* __restrict__ db, T* __restrict__ dc,
            int cells, int l, int N, int n_rt, int groups) {
  extern __shared__ float4 smem4[];
  const int n_tiles = n_rt * (n_rt + 1) / 2, chunks = (N + kT - 1) / kT;
  const int per = cells * chunks, q = (int)(blockIdx.x / 2);
  const bool is_db = blockIdx.x % 2 == 0;
  const int k = q / per;                   // 0: the most terms
  const int64_t cell = (q % per) / chunks;
  const int n0 = (q % chunks) * kT, nn = min(kT, N - n0);
  const int tt = is_db ? k : n_rt - 1 - k; // jt of dB, it of dC
  float* dg_s = reinterpret_cast<float*>(smem4);      // [kFrag]
  float* ost = dg_s + kFrag;                           // C[it] or B[jt]
  float* wt = ost + kStage;                            // dG^T of the tile
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = warp % 4, ch = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const T* other = (is_db ? c : b) + cell * l * N;
  const float4* dgf = reinterpret_cast<const float4*>(dg_s) + lane;
  float sum[4][4];
  zero(sum);
  for (int u = is_db ? tt : 0; u < (is_db ? n_rt : tt + 1); ++u) {
    const int it = is_db ? u : tt, jt = is_db ? tt : u;
    __syncthreads();                       // the last tile's readers done
    // dG: the groups' partials added in order (a group's four loads in
    // flight together); this thread's fragments at warp * 128 + 32 nt +
    // lane (the layout the dC product reads), or dG^T of them into wt
    // (dB's)
    float4 dv[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) dv[nt] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* part = reinterpret_cast<const float4*>(
        dgp + (cell * n_tiles + tile_of(it, jt)) * kFrag);
    for (int gi = 0; gi < groups; ++gi) {
      float4 w4[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        w4[nt] = part[gi * (int64_t)cells * n_tiles * (kFrag / 4) +
                      frag4(ch, nt, rg, lane)];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        dv[nt].x += w4[nt].x;
        dv[nt].y += w4[nt].y;
        dv[nt].z += w4[nt].z;
        dv[nt].w += w4[nt].w;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float4 v = dv[nt];
      if (is_db) {
        const int jl = 32 * ch + 8 * nt + 2 * t, il = 16 * rg + g;
        wt[jl * kLd + il] = v.x;
        wt[(jl + 1) * kLd + il] = v.y;
        wt[jl * kLd + il + 8] = v.z;
        wt[(jl + 1) * kLd + il + 8] = v.w;
      } else {
        reinterpret_cast<float4*>(dg_s)[warp * 128 + 32 * nt + lane] = v;
      }
    }
    stage(ost, other + (int64_t)u * kT * N + n0, N, l - u * kT, nn);
    __syncthreads();
    float acc[4][4];
    zero(acc);
    if (is_db) {                           // dG^T C[it]: rows j, columns n
      mma_ab<!kExact>(acc, smem_addr(wt), ost, nn, rg, ch, lane);
    } else {
      // dG B[jt], rows i, columns n: A is dG from the fragments with k
      // permuted (accumulator column 2t as k t, 2t + 1 as t + 4), so B
      // takes rows 2t and 2t + 1 of each 8
#pragma unroll
      for (int kb = 0; kb < 8; ++kb) {
        const float4 v = dgf[((rg + 4 * (kb / 4)) * 4 + kb % 4) * 32];
        const uint32_t af[4] = {__float_as_uint(v.x), __float_as_uint(v.z),
                                __float_as_uint(v.y), __float_as_uint(v.w)};
        uint32_t ah[4], al[4];
        split4<true>(af, ah, al);
        const float* b0 = ost + (8 * kb + 2 * t) * kLd + 32 * ch + g;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (32 * ch + 8 * nt >= nn) break;
          uint32_t bh0, bl0, bh1, bl1;
          split<!kExact>(b0[8 * nt], bh0, bl0);
          split<!kExact>(b0[kLd + 8 * nt], bh1, bl1);
          mma<true, !kExact>(acc[nt], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[nt][e] += acc[nt][e];
  }
  // element e of fragment nt: row 16 rg + g + 8 (e / 2), column 32 ch + 8
  // nt + 2 t + e % 2 of the tile
  T* out = (is_db ? db : dc) + cell * l * N;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = tt * kT + 16 * rg + g + (e & 2) * 4;
      const int n = 32 * ch + 8 * nt + 2 * t + (e & 1);
      if (r < l && n < nn)
        out[(int64_t)r * N + n0 + n] = from_f<T>(sum[nt][e]);
    }
}

// da[row][k] = sum_{m >= k} dcum[m], dcum[m] the shares of row m's sum
// (less its column sum), column tiles jt <= m / 64 and their two halves
// added in order; the reverse cumsum in fp64, rounded once.  One warp a
// (b, h, c) row: lane t takes ceil(l / 32) consecutive m and sums them
// (kept in registers), a shuffle scan adds the lanes after it, and the
// lane writes its m in reverse.
__device__ __forceinline__ float dcum_at(const float* __restrict__ part,
                                         int64_t rows, int row, int l,
                                         int m) {
  float s = 0.f;
  for (int q = 0; q < 2 * (m / kT + 1); ++q)
    s += part[(q * rows + row) * l + m];
  return s;
}
constexpr int kMaxSeg = 512 / 32;          // a lane's rows at l <= 512
__global__ void __launch_bounds__(256)
da_kernel(const float* __restrict__ part, float* __restrict__ da, int rows,
          int l) {
  const int row = (int)((blockIdx.x * (int64_t)blockDim.x + threadIdx.x) /
                        32);
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int seg = (l + 31) / 32, k0 = lane * seg, k1 = min(k0 + seg, l);
  float d[kMaxSeg];                        // dcum of this lane's rows
  double incl = 0.0;                       // this lane's and the later ones'
#pragma unroll
  for (int q = 0; q < kMaxSeg; ++q) {
    d[q] = k0 + q < k1 ? dcum_at(part, rows, row, l, k0 + q) : 0.f;
    incl += (double)d[q];
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += u;
  }
  double run = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) run = 0.0;
#pragma unroll
  for (int q = kMaxSeg - 1; q >= 0; --q) {
    if (k0 + q < k1) {
      run += (double)d[q];
      da[(int64_t)row * l + k0 + q] = (float)run;
    }
  }
}

// the main pass: the tensor maps of dY and X, then the launch
template <bool kBf16>
int launch_main(const void* x, const void* dy, const wg::Params& p,
                cudaStream_t stream) {
  CUtensorMap tdy, tx;
  int code = wg::encode(&tdy, dy, false, p.H, p.l, p.cells, 32);
  if (code == 0)
    code = wg::encode(&tx, x, kBf16, p.H, p.l, p.cells, kBf16 ? 64 : 32);
  if (code != 0) return code;
  const int smem = wg::Smem<kBf16>::bytes(p.dg_smem ? wg::kSmemDgTiles : 0);
  auto kernel = wg::main_kernel<kBf16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(p.cells * p.n_rt * p.groups), wg::kThreads, smem,
           stream>>>(tdy, tx, p);
  return (int)cudaGetLastError();
}

template <bool kBf16>
int launch(const void* x, const void* a, const void* b, const void* c,
           const void* dy, void* dx, void* da, void* db, void* dc,
           void* scratch, int B, int nc, int l, int H, int N, int hg,
           cudaStream_t stream, cudaEvent_t* ev) {
  using T = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  // ev: none, or kLaunches + 1 events recorded around the launches
  auto mark = [&](int k) {
    if (ev != nullptr) cudaEventRecord(ev[k], stream);
  };
  const int n_rt = (l + kT - 1) / kT, l_pad = n_rt * kT;
  const int n_tiles = n_rt * (n_rt + 1) / 2;
  const int groups = (H + hg - 1) / hg;
  const int64_t rows = (int64_t)B * H * nc, cells = (int64_t)B * nc;
  float* cum = static_cast<float*>(scratch);           // [rows][l_pad]
  float* gs = cum + rows * l_pad;                       // [cells][tiles][]
  float* dgp = gs + cells * n_tiles * kFrag;            // [groups][cells]..
  float* part = dgp + groups * cells * n_tiles * kFrag; // [n_rt][2][rows][l]
  const unsigned row_blocks = (unsigned)((rows * 32 + 255) / 256);
  cudaError_t err;
  mark(0);
  if (rows > 0) {                          // H 0: dG 0, so db and dc 0
    cum_kernel<<<row_blocks, 256, 0, stream>>>(
        static_cast<const float*>(a), cum, (int)rows, l, l_pad);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  mark(1);
  g_kernel<kBf16, T><<<(unsigned)(cells * n_tiles), kThreads, 0, stream>>>(
      static_cast<const T*>(b), static_cast<const T*>(c), gs, l, N, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  mark(2);
  if (rows > 0) {
    wg::Params p;
    p.cum = cum;
    p.g = gs;
    p.dgp = dgp;
    p.part = part;
    p.dx = dx;
    p.nc = nc;
    p.l = l;
    p.H = H;
    p.n_rt = n_rt;
    p.l_pad = l_pad;
    p.n_tiles = n_tiles;
    p.hg = hg;
    p.groups = groups;
    p.cells = (int)cells;
    p.dg_smem = n_rt <= wg::kSmemDgTiles;
    const int code = launch_main<kBf16>(x, dy, p, stream);
    if (code != 0) return code;
  }

  mark(3);
  const size_t dbdc_smem = sizeof(float) * (kFrag + 2 * kStage);
  auto dbdc = dbdc_kernel<kBf16, T>;
  err = cudaFuncSetAttribute(dbdc,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dbdc_smem);
  if (err != cudaSuccess) return (int)err;
  if (N > 0)
    dbdc<<<(unsigned)(2 * n_rt * cells * ((N + kT - 1) / kT)), kThreads,
           dbdc_smem, stream>>>(
        dgp, static_cast<const T*>(b), static_cast<const T*>(c),
        static_cast<T*>(db), static_cast<T*>(dc), (int)cells, l, N, n_rt,
        groups);
  err = cudaGetLastError();
  mark(4);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0)
    da_kernel<<<row_blocks, 256, 0, stream>>>(part, static_cast<float*>(da),
                                              (int)rows, l);
  mark(5);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b, c and their gradients); hg: the
// heads of a group (kernels/ssd_chunk_bwd.py's head_group).  scratch, in
// floats, with n_rt = ceil(l / 64), l_pad = 64 n_rt, T = n_rt (n_rt + 1)
// / 2 tiles and G = ceil(H / hg) groups: B H nc l_pad (cum) + B nc T 4096
// (G) + G B nc T 4096 (dG's partials) + n_rt 2 B H nc l (row sums).
extern "C" int repro_ssd_chunk_bwd(const void* x, const void* a,
                                   const void* b, const void* c,
                                   const void* dy, void* dx, void* da,
                                   void* db, void* dc, void* scratch, int B,
                                   int nc, int l, int H, int N, int hg,
                                   int dtype, void* stream) {
  if ((int64_t)B * nc * l == 0) return 0;
  if (dtype == 1)
    return launch<true>(x, a, b, c, dy, dx, da, db, dc, scratch, B, nc, l,
                        H, N, hg, (cudaStream_t)stream, nullptr);
  return launch<false>(x, a, b, c, dy, dx, da, db, dc, scratch, B, nc, l, H,
                       N, hg, (cudaStream_t)stream, nullptr);
}

// The same call, timed: ms[k] the device milliseconds of launch k (cum,
// g, main, dbdc, da) from CUDA events recorded around each on the stream;
// returns once the call is done.  For measurement only.
extern "C" int repro_ssd_chunk_bwd_timed(const void* x, const void* a,
                                         const void* b, const void* c,
                                         const void* dy, void* dx, void* da,
                                         void* db, void* dc, void* scratch,
                                         int B, int nc, int l, int H, int N,
                                         int hg, int dtype, void* stream,
                                         float* ms) {
  constexpr int kLaunches = 5;
  cudaEvent_t ev[kLaunches + 1];
  int made = 0, code = 0;
  for (; made <= kLaunches; ++made) {
    code = (int)cudaEventCreate(&ev[made]);
    if (code != 0) break;
  }
  if (code == 0 && (int64_t)B * nc * l > 0) {
    code = dtype == 1
               ? launch<true>(x, a, b, c, dy, dx, da, db, dc, scratch, B, nc,
                              l, H, N, hg, (cudaStream_t)stream, ev)
               : launch<false>(x, a, b, c, dy, dx, da, db, dc, scratch, B,
                               nc, l, H, N, hg, (cudaStream_t)stream, ev);
    if (code == 0) code = (int)cudaEventSynchronize(ev[kLaunches]);
    for (int k = 0; k < kLaunches && code == 0; ++k)
      code = (int)cudaEventElapsedTime(&ms[k], ev[k], ev[k + 1]);
  }
  for (int k = 0; k < made; ++k) cudaEventDestroy(ev[k]);
  return code;
}

extern "C" const char* repro_error_string(int code) {
  if (code >= sm90::kEncodeErrorBase) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString((cudaError_t)code);
}
