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
// Bound: bytes.  At the Mamba2-1.3B prefill shape (B 4, nc 8, l 256, H 64,
// P 64, N 128, bf16) the function reads and writes 208 MB once: x 67.1 MB
// (bf16), y 134.2 MB (fp32, 65% of the bytes), a, b and c 2.1 MB each;
// 0.062 ms at 3.35 TB/s.  Its operations, the causal half of G once per
// (b, c) and of Y per head, are 8.9 GFLOP: 9 us at the bf16 tensor-core
// peak.  So on tensor cores the kernel is bound by the bytes, most of
// them the fp32 y store.  What it does besides, 71M exponentials and
// three-way splits of S at that shape, costs it more than either (see
// PERF.md).
//
// bf16 (namespace tc): tensor cores.
//  * Both products are mma.sync m16n8k16 (bf16 in, fp32 accumulate).  A
//    CTA owns a 64-row tile i of one (b, c) and 8 heads, two of them at
//    once: 8 warps, warp w takes rows 16 (w % 4) .. + 15 of head slot
//    w / 4.  G = C B^T: C and B come through shared memory in 64 x 64
//    chunks of (rows, n), zero padded past l and N (N 40 and l 100 work),
//    double-buffered so one chunk pair loads while the last one
//    multiplies, and ldmatrix gives the A (C rows) and B (B rows, n
//    contiguous) fragments; each warp computes 32 of a tile's 64 columns.
//    G is computed once per CTA and kept in shared memory in fp32, laid
//    out as the accumulator fragments of the 4 row groups, so every head
//    reads it back with two 16-byte loads per thread and 16 columns,
//    without bank conflicts.
//  * S = G o L is built in registers, 16 columns j at a time, in the
//    accumulator layout of an m16n8 pair, which is the layout of an
//    m16n8k16 A fragment (the identity flash_attention.cu uses for P).
//    exp is taken of arguments <= 0 only: in the diagonal tile the
//    argument is -inf above the diagonal; off it every j < i.  S is split
//    three ways, S_hi = bf16(S), S_mid = bf16(S - S_hi), S_lo = bf16(S -
//    S_hi - S_mid) (both differences exact in fp32), and Y += S_hi X +
//    S_mid X + S_lo X as three mma on one fp32 accumulator.  X is bf16
//    already, so its B fragment (ldmatrix.trans from shared memory) is
//    exact, and the three terms carry S to fp32's 24 bits.  One bf16
//    rounding of S (2^-9 of |S|) summed over 256 keys misses the 2e-4
//    tolerance by hundreds of times where y is near 0, and two (2^-17)
//    still by up to 2 times; three keep the kernel at fp32's accuracy
//    (tests/test_torch_ssd_numerics.py emulates them on the CPU).  The
//    three passes make Y 27 GFLOP at the prefill shape (28 us at the
//    bf16 peak, under the bytes bound); the tensor cores are not what
//    bounds the kernel, so it stays on mma.sync: a variant with the
//    off-diagonal tiles on wgmma (m64n64k16, S from registers) gained
//    nothing to speak of.
//  * X tiles (64 j x 64 p, one per head slot) come by 16-byte cp.async
//    into a ring of 2 stages that runs on across column tiles, heads and
//    the P chunks of a head, so the next tiles load during this tile's
//    products; staged rows are 144 bytes apart, which keeps ldmatrix free
//    of bank conflicts.  Off the diagonal a warp's 4 slices of a tile run
//    without a branch, so the compiler interleaves them.
//  * y is written with 16-byte stores: a shuffle between the two threads
//    of a quad that hold a row's 4 neighbouring columns gives each of
//    them one float4 (rows of one head are P fp32 contiguous).
//  * Balance: a CTA takes row tiles it and n - 1 - it of one (b, c) and
//    head group, so every CTA walks n + 1 column tiles (4 + 1 = 3 + 2 at
//    l = 256); the blocks above the diagonal are never computed, and in
//    the diagonal tile a warp skips the 16-column slices above its rows.
//  * The grid numbers the pairs and head groups of one (b, c) together,
//    so the CTAs that read one (b, c)'s X (2 MB at the prefill shape)
//    are resident at once and its re-reads hit L2.
//  * 108 KB of shared memory (G 64 KB, the ring 36 KB, cum 8 KB), 256
//    threads and at most 128 registers a thread: 2 CTAs, 16 warps, per
//    SM at l = 256.
//
// fp32 (namespace tc32): 3xTF32 on the tensor cores (tf32.cuh), on the
// bf16 kernel's skeleton: the same balanced pairs, G kept in shared
// memory in fp32 as accumulator fragments, S built in registers, the
// cp.async ring for X and the 16-byte y stores.
//  * Both products are mma.sync m16n8k8 TF32, each operand split into hi
//    and lo and a product taken as al bh + ah bl + ah bh (al bl dropped)
//    on one fp32 accumulator: about 2^-21 of a product.  One TF32 pass
//    (2^-11), or two that round one operand of a product once, miss the
//    2e-4 tolerance by 20 to 270 times where y is near 0
//    (tests/test_torch_ssd_numerics.py emulates them on the CPU).
//  * C, B and X land as they lie (16-byte cp.async, rows 272 bytes apart,
//    which keeps ldmatrix and the X fragment loads free of bank
//    conflicts) and every warp splits its fragments in registers as they
//    load: hi and lo planes would double what the warps read from shared
//    memory.  C and B come by ldmatrix (b16 rows of 16 bytes carry fp32
//    words intact); X's B fragment by two 4-byte loads per n8 tile.
//  * S = G o L is built 16 columns at a time as in bf16, now two k8 steps
//    of 8: the m16n8 accumulator layout holds columns (2t, 2t + 1) where
//    the k8 A fragment wants (t, t + 4), so X's fragment takes rows 2t
//    and 2t + 1 of the step instead (the sum over j does not depend on
//    its order), and S is split in registers, never shuffled.
//  * The ring's fp32 tiles are twice bf16's: 68 KB for X (or C and B),
//    64 KB for G and 8 KB for cum at l = 256, so one CTA of 8 warps an SM
//    (bf16: two); 212 KB at l = 512.
//  * Bound: three TF32 passes of the causal half of G and Y are 27 GFLOP
//    at the Mamba2-1.3B prefill shape, 0.054 ms at the TF32 peak (495
//    TFLOP/s), under the 279 MB the function reads and writes once in
//    fp32 (0.083 ms): bytes, as in bf16 (on the fp32 CUDA cores, 67
//    TFLOP/s, the operations alone would take 0.133 ms).
//
// How both replace the TPU kernel's assumptions:
//  * one whole (b, h, c) cell in VMEM (G and L are 256 x 256 fp32, 256 KB
//    each, over the 227 KB a CTA may have): a CTA owns 64-row tiles of
//    one chunk and keeps only G's rows of a tile in shared memory; S never
//    leaves registers.
//  * the full l x l products: column tiles j <= i only.
//  * G recomputed per head: G has no head index (one B/C group), so a CTA
//    computes its G rows once and loops over 8 heads.
//  * jnp.cumsum inside the cell: a warp scans a with shuffles per head,
//    in fp64, rounded once (see warp_cumsum).
//  * masked exponentials: the TPU kernel guards exp() with two where()s;
//    here exp is used only for j <= i, where cum[i] - cum[j] <= 0, so the
//    entries whose exp could overflow never enter a product.  The decay
//    is never factored as exp(cum[i] - r) exp(r - cum[j]), which
//    overflows under strong decay.
//  * a serial grid: CTAs are independent, each a balanced pair of row
//    tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd.cuh"
#include "tf32.cuh"

namespace {

using ssd::warp_cumsum;

// --------------------------------------------------------------------- //
// bf16: tensor cores
// --------------------------------------------------------------------- //
namespace tc {

constexpr int kGroups = 4;               // row groups of 16 rows
constexpr int kSlots = 2;                // heads in flight at once
constexpr int kWarps = kGroups * kSlots; // warp w: group w % 4, slot w / 4
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kGroups;      // rows i of a row tile
constexpr int kCols = 64;                // columns j of a column tile
constexpr int kWide = 64;                // p of a chunk of Y; n of a G step
constexpr int kLd = kWide + 8;           // staged row: 144 B apart
constexpr int kTileBytes = kCols * kLd * 2;       // one staged 64 x 64 tile
constexpr int kStages = 2;               // X ring, kSlots tiles a stage
constexpr int kStageBytes = kSlots * kTileBytes;
constexpr int kHeads = 8;                // heads of a CTA, one G for all
constexpr int kSlices = kCols / 16;      // 16-column slices of a tile
constexpr int kGTile = kSlices * 32 * 8; // floats of one group's G tile
static_assert(kRows == kCols, "column tile jt <= row tile it");
static_assert(kStages * kSlots == 4, "G double-buffers its C and B chunks");

using ssd::cp_async16;
using ssd::cp_async_commit;
using ssd::cp_async_wait;
using ssd::smem_addr;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a b, m16n8k16, bf16 inputs, fp32 accumulator (not volatile: a
// function of its registers, which the compiler may schedule freely)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[2 np], acc[2 np + 1] += a X for the kNp 16-column groups of X
template <int kNp>
__device__ __forceinline__ void mma_x(float (&acc)[8][4],
                                      const uint32_t (&a)[4],
                                      const uint32_t (&bx)[kNp][4]) {
#pragma unroll
  for (int np = 0; np < kNp; ++np) {
    mma(acc[2 * np], a, bx[np][0], bx[np][1]);
    mma(acc[2 * np + 1], a, bx[np][2], bx[np][3]);
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) = hi + mid + lo to fp32's 24 bits, each a packed bf16 pair
// (v0 in the low half, as the A fragment wants the lower column)
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = v0 - hf.x, r1 = v1 - hf.y;          // exact
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));  // exact args
}

// Rows [0, 64) and columns [0, 64) of a row-major bf16 matrix at src (row
// stride ld elements) into a [64][kLd] tile at dst, rows >= nr and
// columns >= ncols as zeros.  vec: 16-byte cp.async (src and ld on 8
// elements, ncols a multiple of 8); else plain loads and stores.
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const __nv_bfloat16* src,
                                          int64_t ld, int nr, int ncols,
                                          bool vec) {
  constexpr int kChunks = kWide / 8;
  for (int idx = threadIdx.x; idx < kCols * kChunks; idx += kThreads) {
    const int r = idx / kChunks, k = (idx % kChunks) * 8;
    unsigned char* d = dst + (r * kLd + k) * 2;
    if (vec) {
      const bool in = r < nr && k < ncols;
      cp_async16(smem_addr(d), in ? src + r * ld + k : src, in ? 16 : 0);
    } else {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = (r < nr && k + e < ncols) ? src[r * ld + k + e]
                                         : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// Y += (G o L) X over one 64-column tile, for the warp's 16 rows (r0 and
// r0 + 8 in the tile are the thread's): S is built in registers 16
// columns at a time, split three ways and multiplied with the tile's kNp
// 16-column groups of X.  g_t: the warp's G fragments of the tile plus
// lane * 8; cum_j: cum at the tile's first column; xs: the X tile.
// kDiag: the diagonal tile, where a warp takes only the n_slices slices
// that reach its rows and L is masked above the diagonal; off it every
// slice is whole and the loop has no branch, so the compiler interleaves
// the slices.
template <int kNp, bool kDiag>
__device__ __forceinline__ void y_tile(float (&acc)[8][4],
                                       const float* g_t, const float* cum_j,
                                       float cum_i0, float cum_i1, int r0,
                                       int n_slices, uint32_t xs, int lane) {
  const int t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kSlices; ++kk) {
    if (kDiag && kk >= n_slices) break;
    const float4 ga = *reinterpret_cast<const float4*>(g_t + kk * 256);
    const float4 gb = *reinterpret_cast<const float4*>(g_t + kk * 256 + 4);
    const int j = 16 * kk + 2 * t;             // columns j, j+1, j+8, j+9
    const float2 ca = *reinterpret_cast<const float2*>(cum_j + j);
    const float2 cc = *reinterpret_cast<const float2*>(cum_j + j + 8);
    // exponents cum[i] - cum[j] at (row, column) (g, j), (g, j+1),
    // (g+8, j), (g+8, j+1), then the same at j + 8
    float e[8] = {cum_i0 - ca.x, cum_i0 - ca.y, cum_i1 - ca.x,
                  cum_i1 - ca.y, cum_i0 - cc.x, cum_i0 - cc.y,
                  cum_i1 - cc.x, cum_i1 - cc.y};
    if (kDiag) {
      // above the diagonal the exponent is -inf (0xff800000), so exp is
      // only ever taken of arguments <= 0 and gives 0 there
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (j + (q & 1) + (q & 4 ? 8 : 0) > r0 + (q & 2 ? 8 : 0))
          e[q] = __uint_as_float(0xff800000u);
    }
    // __expf, ex2.approx of e log2 e: within 2 + floor(|1.16 e|) ulp, an
    // error that grows with |e| only where exp(e) is already small
    // (tests/test_torch_ssd_numerics.py holds that bound to the tolerance)
    const float s0 = ga.x * __expf(e[0]), s1 = ga.y * __expf(e[1]);
    const float s2 = ga.z * __expf(e[2]), s3 = ga.w * __expf(e[3]);
    const float s4 = gb.x * __expf(e[4]), s5 = gb.y * __expf(e[5]);
    const float s6 = gb.z * __expf(e[6]), s7 = gb.w * __expf(e[7]);
    // the m16n8 pair's accumulators are the m16k16 A fragment
    uint32_t ah[4], am[4], al[4];
    split3(s0, s1, ah[0], am[0], al[0]);    // row g,     k 2t, 2t+1
    split3(s2, s3, ah[1], am[1], al[1]);    // row g + 8
    split3(s4, s5, ah[2], am[2], al[2]);    // row g,     k 2t+8, 2t+9
    split3(s6, s7, ah[3], am[3], al[3]);    // row g + 8
    uint32_t bx[kNp][4];
#pragma unroll
    for (int np = 0; np < kNp; ++np)
      ldmatrix_x4_trans(bx[np], xs + ((16 * kk + (lane & 7) +
                                       ((lane >> 3) & 1) * 8) * kLd +
                                      16 * np + (lane >> 4) * 8) * 2);
    // part by part: 2 kNp independent accumulators between dependent mma
    mma_x<kNp>(acc, ah, bx);
    mma_x<kNp>(acc, am, bx);
    mma_x<kNp>(acc, al, bx);
  }
}

// y_tile for a chunk of n_np (1 to 4) 16-column groups of X
template <bool kDiag>
__device__ __forceinline__ void y_tile_n(int n_np, float (&acc)[8][4],
                                         const float* g_t, const float* cum_j,
                                         float cum_i0, float cum_i1, int r0,
                                         int n_slices, uint32_t xs,
                                         int lane) {
  switch (n_np) {
    case 4: y_tile<4, kDiag>(acc, g_t, cum_j, cum_i0, cum_i1, r0, n_slices,
                             xs, lane); break;
    case 3: y_tile<3, kDiag>(acc, g_t, cum_j, cum_i0, cum_i1, r0, n_slices,
                             xs, lane); break;
    case 2: y_tile<2, kDiag>(acc, g_t, cum_j, cum_i0, cum_i1, r0, n_slices,
                             xs, lane); break;
    default: y_tile<1, kDiag>(acc, g_t, cum_j, cum_i0, cum_i1, r0, n_slices,
                              xs, lane);
  }
}

// vec bits: 1 x by cp.async, 2 b and c by cp.async, 4 y by float4 stores
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_tc(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
             const __nv_bfloat16* __restrict__ b,
             const __nv_bfloat16* __restrict__ c, float* __restrict__ y,
             int nc, int l, int H, int P, int N, int vec) {
  extern __shared__ float4 smem4[];
  const int n_row_tiles = (l + kRows - 1) / kRows;
  const int l_pad = n_row_tiles * kRows;
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4);
  // G: [group][column tile][slice][lane][8], the accumulator fragments
  float* g_s = reinterpret_cast<float*>(ring + kStages * kStageBytes);
  float* cum_s = g_s + kGroups * n_row_tiles * kGTile;  // [kHeads][l_pad]

  const int n_pairs = (n_row_tiles + 1) / 2;
  const int n_groups = (H + kHeads - 1) / kHeads;
  const int pair = (int)(blockIdx.x % n_pairs);
  const int rem = (int)(blockIdx.x / n_pairs);
  const int hg = rem % n_groups;
  const int64_t cell = rem / n_groups;                   // b * nc + c
  const int bi = (int)(cell / nc), ci = (int)(cell % nc);
  const int heads = min(kHeads, H - hg * kHeads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp % kGroups, slot = warp / kGroups;
  const int g = lane / 4, t = lane % 4;
  const bool vec_x = vec & 1, vec_bc = vec & 2, vec_y = vec & 4;

  // cumsum of a per head, over the whole chunk (zeros past l)
  for (int hh = warp; hh < heads; hh += kWarps)
    warp_cumsum(a + (((int64_t)bi * H + hg * kHeads + hh) * nc + ci) * l, l,
                l_pad, cum_s + hh * l_pad, lane);

  const __nv_bfloat16* cb = c + cell * l * N;
  const __nv_bfloat16* bb = b + cell * l * N;
  const int n_pc = (P + kWide - 1) / kWide;
  const int n_nk = max(1, (N + kWide - 1) / kWide);
  float* g_w = g_s + grp * n_row_tiles * kGTile;
  const int r0 = grp * 16 + g;             // the thread's rows: r0, r0 + 8

  for (int half = 0; half < 2; ++half) {
    const int it = half == 0 ? n_row_tiles - 1 - pair : pair;
    if (half == 1 && it == n_row_tiles - 1 - pair) break;
    const int i0 = it * kRows;
    const int ncol = it + 1;

    // ---- G rows i0 .. i0 + 63, column tiles 0 .. it --------------------
    // step k is (column tile k / n_nk, state chunk k % n_nk); its C and B
    // chunks load into ring tiles 2 (k & 1) and 2 (k & 1) + 1 while step
    // k - 1 computes.  Warp w takes its group's rows and the 16-column
    // groups 2 slot, 2 slot + 1 of the tile.
    const int gsteps = ncol * n_nk;
    auto g_issue = [&](int k) {
      if (k < gsteps) {
        const int jt = k / n_nk, n0 = (k % n_nk) * kWide;
        unsigned char* st = ring + 2 * (k & 1) * kTileBytes;
        load_tile(st, cb + (int64_t)i0 * N + n0, N, l - i0, N - n0, vec_bc);
        load_tile(st + kTileBytes, bb + (int64_t)jt * kCols * N + n0, N,
                  l - jt * kCols, N - n0, vec_bc);
      }
      cp_async_commit();
    };
    __syncthreads();                       // the ring's last readers done
    g_issue(0);
    float acc[8][4];                       // G: acc[0 .. 3]; Y: all
    for (int k = 0; k < gsteps; ++k) {
      g_issue(k + 1);
      cp_async_wait<1>();
      __syncthreads();                     // step k's chunks in
      const int n0 = (k % n_nk) * kWide;
      if (n0 == 0) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      }
      const uint32_t cs = smem_addr(ring + 2 * (k & 1) * kTileBytes);
      const uint32_t bs = cs + kTileBytes;
#pragma unroll
      for (int ks = 0; ks < kWide / 16; ++ks) {
        if (n0 + 16 * ks >= N) break;
        uint32_t af[4];
        ldmatrix_x4(af, cs + ((grp * 16 + (lane & 7) +
                               ((lane >> 3) & 1) * 8) * kLd +
                              16 * ks + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int np = 2 * slot + q;     // 16 columns: n8 tiles 2q, 2q+1
          uint32_t bf[4];
          ldmatrix_x4(bf, bs + ((16 * np + (lane & 7) + (lane >> 4) * 8) *
                                    kLd +
                                16 * ks + ((lane >> 3) & 1) * 8) * 2);
          mma(acc[2 * q], af, bf[0], bf[1]);
          mma(acc[2 * q + 1], af, bf[2], bf[3]);
        }
      }
      if (n0 + kWide >= N) {               // the tile's last chunk: store G
        const int jt = k / n_nk;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)     // slice 2 slot + nt / 2
          *reinterpret_cast<float4*>(
              g_w + (jt * kSlices + 2 * slot + nt / 2) * 256 + lane * 8 +
              (nt % 2) * 4) =
              make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
      }
      __syncthreads();                     // read; step k + 2 reloads them
    }

    // ---- per head and P chunk: Y = (G o L) X over column tiles --------
    // step s is (head pair hp, chunk pc, column tile jt), jt fastest:
    // slot q's warps take head 2 hp + q.  The X tiles of step s + 1 load
    // while step s computes.
    const int n_hp = (heads + kSlots - 1) / kSlots;
    const int nsteps = n_hp * n_pc * ncol;
    auto issue = [&](int s) {
      if (s < nsteps) {
        const int jt = s % ncol, q = s / ncol;
        const int p0 = (q % n_pc) * kWide, j0 = jt * kCols;
        for (int sl = 0; sl < kSlots; ++sl) {
          const int hh = (q / n_pc) * kSlots + sl;
          if (hh < heads)
            load_tile(ring + (s % kStages) * kStageBytes + sl * kTileBytes,
                      x + ((cell * l + j0) * H + hg * kHeads + hh) *
                              (int64_t)P + p0,
                      (int64_t)H * P, l - j0, P - p0, vec_x);
        }
      }
      cp_async_commit();
    };
    for (int s = 0; s < kStages - 1; ++s) issue(s);
    float cum_i0 = 0.f, cum_i1 = 0.f;
    const int gi0 = i0 + r0, gi1 = gi0 + 8;
    for (int s = 0; s < nsteps; ++s) {
      cp_async_wait<kStages - 2>();
      __syncthreads();                     // tile s in; tile s - 1 read
      issue(s + kStages - 1);
      const int jt = s % ncol, q = s / ncol, pc = q % n_pc;
      const int hh = (q / n_pc) * kSlots + slot;
      if (hh >= heads) continue;           // an odd head count's last pair
      const int j0 = jt * kCols, p0 = pc * kWide;
      const int n_np = (min(kWide, P - p0) + 15) / 16;
      const float* cum = cum_s + hh * l_pad;
      if (jt == 0) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
        cum_i0 = cum[gi0];
        cum_i1 = cum[gi1];
      }
      const uint32_t xs =
          smem_addr(ring + (s % kStages) * kStageBytes + slot * kTileBytes);
      const float* g_t = g_w + jt * kSlices * 256 + lane * 8;
      if (jt == it)               // slices 0 .. grp reach the warp's rows
        y_tile_n<true>(n_np, acc, g_t, cum + j0, cum_i0, cum_i1, r0,
                       grp + 1, xs, lane);
      else
        y_tile_n<false>(n_np, acc, g_t, cum + j0, cum_i0, cum_i1, r0,
                        kSlices, xs, lane);
      if (jt != ncol - 1) continue;
      // ---- store Y's rows of this head and P chunk --------------------
      float* yh = y + (cell * l * H + hg * kHeads + hh) * (int64_t)P;
      const int64_t ys = (int64_t)H * P;               // row stride of y
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= 2 * n_np) break;
        const int p = p0 + 8 * nt + 2 * t;
        if (vec_y) {
          // quad neighbours t, t ^ 1 swap halves: even t stores row g,
          // odd t row g + 8, four columns each
          const bool odd = t & 1;
          const float q0 = __shfl_xor_sync(
              0xffffffffu, odd ? acc[nt][0] : acc[nt][2], 1);
          const float q1 = __shfl_xor_sync(
              0xffffffffu, odd ? acc[nt][1] : acc[nt][3], 1);
          const int row = odd ? gi1 : gi0, pv = odd ? p - 2 : p;
          if (row < l && pv < P)
            *reinterpret_cast<float4*>(yh + row * ys + pv) =
                odd ? make_float4(q0, q1, acc[nt][2], acc[nt][3])
                    : make_float4(acc[nt][0], acc[nt][1], q0, q1);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? gi0 : gi1, pe = p + (e & 1);
            if (row < l && pe < P) yh[row * ys + pe] = acc[nt][e];
          }
        }
      }
    }
    cp_async_wait<0>();
  }
}

int launch(const void* x, const void* a, const void* b, const void* c,
           void* y, int B, int nc, int l, int H, int P, int N,
           cudaStream_t stream) {
  const int n_row_tiles = (l + kRows - 1) / kRows;
  const size_t smem = (size_t)kStages * kStageBytes +
                      (size_t)kGroups * n_row_tiles * kGTile * sizeof(float) +
                      (size_t)kHeads * n_row_tiles * kRows * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  auto on16 = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const int vec = (P % 8 == 0 && on16(x) ? 1 : 0) |
                  (N % 8 == 0 && on16(b) && on16(c) ? 2 : 0) |
                  (P % 4 == 0 && on16(y) ? 4 : 0);
  const int n_groups = (H + kHeads - 1) / kHeads;
  const int64_t blocks =
      (int64_t)B * nc * n_groups * ((n_row_tiles + 1) / 2);
  ssd_chunk_tc<<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const float*)a, (const __nv_bfloat16*)b,
      (const __nv_bfloat16*)c, (float*)y, nc, l, H, P, N, vec);
  return (int)cudaGetLastError();
}

}  // namespace tc

// --------------------------------------------------------------------- //
// fp32: 3xTF32 on the tensor cores
// --------------------------------------------------------------------- //
namespace tc32 {

using ssd::cp_async16;
using ssd::cp_async_commit;
using ssd::cp_async_wait;
using ssd::smem_addr;

constexpr int kGroups = 4;               // row groups of 16 rows
constexpr int kSlots = 2;                // heads in flight at once
constexpr int kWarps = kGroups * kSlots; // warp w: group w % 4, slot w / 4
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kGroups;      // rows i of a row tile
constexpr int kCols = 64;                // columns j of a column tile
constexpr int kWide = 64;                // p of a chunk of Y; n of a G step
constexpr int kLd = kWide + 4;           // staged row: 272 B apart
constexpr int kTileBytes = kCols * kLd * 4;       // one staged 64 x 64 tile
constexpr int kStages = 2;               // X ring, kSlots tiles a stage
constexpr int kStageBytes = kSlots * kTileBytes;
constexpr int kHeads = 8;                // heads of a CTA, one G for all
constexpr int kSlices = kCols / 16;      // 16-column slices of a tile
constexpr int kGTile = kSlices * 32 * 8; // floats of one group's G tile
static_assert(kRows == kCols, "column tile jt <= row tile it");
static_assert(kStages * kSlots == 4, "G double-buffers its C and B chunks");

// Rows [0, 64) and columns [0, 64) of a row-major fp32 matrix at src (row
// stride ld elements) into a [64][kLd] tile at dst, rows >= nr and
// columns >= ncols as zeros.  vec: 16-byte cp.async (src and ld on 4
// elements, ncols a multiple of 4); else plain loads and stores.
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const float* src, int64_t ld,
                                          int nr, int ncols, bool vec) {
  constexpr int kChunks = kWide / 4;
  for (int idx = threadIdx.x; idx < kCols * kChunks; idx += kThreads) {
    const int r = idx / kChunks, k = (idx % kChunks) * 4;
    unsigned char* d = dst + (r * kLd + k) * 4;
    if (vec) {
      const bool in = r < nr && k < ncols;
      cp_async16(smem_addr(d), in ? src + r * ld + k : src, in ? 16 : 0);
    } else {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = (r < nr && k + e < ncols) ? src[r * ld + k + e] : 0.f;
      *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Y += (G o L) X over one 64-column tile, for the warp's 16 rows (r0 and
// r0 + 8 in the tile are the thread's): S is built in registers 16
// columns at a time, as two k8 steps, split into TF32 hi and lo and
// multiplied with the tile's kNp 16-column groups of X in 3xTF32.  g_t:
// the warp's G fragments of the tile plus lane * 8; cum_j: cum at the
// tile's first column; xs: the X tile, as it lies.  kDiag: the diagonal
// tile, where a warp takes only the n_slices slices that reach its rows
// and L is masked above the diagonal; off it every slice is whole.
template <int kNp, bool kDiag>
__device__ __forceinline__ void y_tile(float (&acc)[8][4],
                                       const float* g_t, const float* cum_j,
                                       float cum_i0, float cum_i1, int r0,
                                       int n_slices, const float* xs,
                                       int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kSlices; ++kk) {
    if (kDiag && kk >= n_slices) break;
    const float4 ga = *reinterpret_cast<const float4*>(g_t + kk * 256);
    const float4 gb = *reinterpret_cast<const float4*>(g_t + kk * 256 + 4);
    const int j = 16 * kk + 2 * t;             // columns j, j+1, j+8, j+9
    const float2 ca = *reinterpret_cast<const float2*>(cum_j + j);
    const float2 cc = *reinterpret_cast<const float2*>(cum_j + j + 8);
    // exponents cum[i] - cum[j] at (row, column) (g, j), (g, j+1),
    // (g+8, j), (g+8, j+1), then the same at j + 8
    float e[8] = {cum_i0 - ca.x, cum_i0 - ca.y, cum_i1 - ca.x,
                  cum_i1 - ca.y, cum_i0 - cc.x, cum_i0 - cc.y,
                  cum_i1 - cc.x, cum_i1 - cc.y};
    if (kDiag) {
      // above the diagonal the exponent is -inf (0xff800000), so exp is
      // only ever taken of arguments <= 0 and gives 0 there
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (j + (q & 1) + (q & 4 ? 8 : 0) > r0 + (q & 2 ? 8 : 0))
          e[q] = __uint_as_float(0xff800000u);
    }
    // __expf, as the bf16 kernel takes it (tests/test_torch_ssd_numerics.py
    // holds its error bound to the tolerance)
    const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
    float sv[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) sv[q] = gv[q] * __expf(e[q]);
    // step h: columns 16 kk + 8 h ..; its m16n8 accumulator is the k8 A
    // fragment with columns permuted (column t is j = 2t, t + 4 is 2t +
    // 1), so X's B fragment takes rows 2t and 2t + 1 of the step
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t ah[4], al[4];
      tf32::split(sv[4 * h], ah[0], al[0]);       // row g,     j 2t
      tf32::split(sv[4 * h + 2], ah[1], al[1]);   // row g + 8, j 2t
      tf32::split(sv[4 * h + 1], ah[2], al[2]);   // row g,     j 2t + 1
      tf32::split(sv[4 * h + 3], ah[3], al[3]);   // row g + 8, j 2t + 1
      const float* xr = xs + (16 * kk + 8 * h + 2 * t) * kLd + g;
      uint32_t bh[2 * kNp][2], bl[2 * kNp][2];
#pragma unroll
      for (int nt = 0; nt < 2 * kNp; ++nt) {
        tf32::split(xr[8 * nt], bh[nt][0], bl[nt][0]);
        tf32::split(xr[kLd + 8 * nt], bh[nt][1], bl[nt][1]);
      }
      // part by part: 2 kNp independent accumulators between dependent mma
#pragma unroll
      for (int nt = 0; nt < 2 * kNp; ++nt)
        tf32::mma(acc[nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int nt = 0; nt < 2 * kNp; ++nt)
        tf32::mma(acc[nt], ah, bl[nt][0], bl[nt][1]);
#pragma unroll
      for (int nt = 0; nt < 2 * kNp; ++nt)
        tf32::mma(acc[nt], ah, bh[nt][0], bh[nt][1]);
    }
  }
}

// y_tile for a chunk of n_np (1 to 4) 16-column groups of X
template <bool kDiag>
__device__ __forceinline__ void y_tile_n(int n_np, float (&acc)[8][4],
                                         const float* g_t, const float* cum_j,
                                         float cum_i0, float cum_i1, int r0,
                                         int n_slices, const float* xs,
                                         int lane) {
  switch (n_np) {
    case 4: y_tile<4, kDiag>(acc, g_t, cum_j, cum_i0, cum_i1, r0, n_slices,
                             xs, lane); break;
    case 3: y_tile<3, kDiag>(acc, g_t, cum_j, cum_i0, cum_i1, r0, n_slices,
                             xs, lane); break;
    case 2: y_tile<2, kDiag>(acc, g_t, cum_j, cum_i0, cum_i1, r0, n_slices,
                             xs, lane); break;
    default: y_tile<1, kDiag>(acc, g_t, cum_j, cum_i0, cum_i1, r0, n_slices,
                              xs, lane);
  }
}

// vec bits: 1 x by cp.async, 2 b and c by cp.async, 4 y by float4 stores
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_tc32(const float* __restrict__ x, const float* __restrict__ a,
               const float* __restrict__ b, const float* __restrict__ c,
               float* __restrict__ y, int nc, int l, int H, int P, int N,
               int vec) {
  extern __shared__ float4 smem4[];
  const int n_row_tiles = (l + kRows - 1) / kRows;
  const int l_pad = n_row_tiles * kRows;
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4);
  // G: [group][column tile][slice][lane][8], the accumulator fragments
  float* g_s = reinterpret_cast<float*>(ring + kStages * kStageBytes);
  float* cum_s = g_s + kGroups * n_row_tiles * kGTile;  // [kHeads][l_pad]

  const int n_pairs = (n_row_tiles + 1) / 2;
  const int n_groups = (H + kHeads - 1) / kHeads;
  const int pair = (int)(blockIdx.x % n_pairs);
  const int rem = (int)(blockIdx.x / n_pairs);
  const int hg = rem % n_groups;
  const int64_t cell = rem / n_groups;                   // b * nc + c
  const int bi = (int)(cell / nc), ci = (int)(cell % nc);
  const int heads = min(kHeads, H - hg * kHeads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp % kGroups, slot = warp / kGroups;
  const int g = lane / 4, t = lane % 4;
  const bool vec_x = vec & 1, vec_bc = vec & 2, vec_y = vec & 4;

  // cumsum of a per head, over the whole chunk (zeros past l)
  for (int hh = warp; hh < heads; hh += kWarps)
    warp_cumsum(a + (((int64_t)bi * H + hg * kHeads + hh) * nc + ci) * l, l,
                l_pad, cum_s + hh * l_pad, lane);

  const float* cb = c + cell * l * N;
  const float* bb = b + cell * l * N;
  const int n_pc = (P + kWide - 1) / kWide;
  const int n_nk = max(1, (N + kWide - 1) / kWide);
  float* g_w = g_s + grp * n_row_tiles * kGTile;
  const int r0 = grp * 16 + g;             // the thread's rows: r0, r0 + 8

  for (int half = 0; half < 2; ++half) {
    const int it = half == 0 ? n_row_tiles - 1 - pair : pair;
    if (half == 1 && it == n_row_tiles - 1 - pair) break;
    const int i0 = it * kRows;
    const int ncol = it + 1;

    // ---- G rows i0 .. i0 + 63, column tiles 0 .. it --------------------
    // step k is (column tile k / n_nk, state chunk k % n_nk); its C and B
    // chunks load into ring tiles 2 (k & 1) and 2 (k & 1) + 1 while step
    // k - 1 computes.  Warp w takes its group's rows and the 16-column
    // groups 2 slot, 2 slot + 1 of the tile; both operands are split as
    // their fragments load.
    const int gsteps = ncol * n_nk;
    auto g_issue = [&](int k) {
      if (k < gsteps) {
        const int jt = k / n_nk, n0 = (k % n_nk) * kWide;
        unsigned char* st = ring + 2 * (k & 1) * kTileBytes;
        load_tile(st, cb + (int64_t)i0 * N + n0, N, l - i0, N - n0, vec_bc);
        load_tile(st + kTileBytes, bb + (int64_t)jt * kCols * N + n0, N,
                  l - jt * kCols, N - n0, vec_bc);
      }
      cp_async_commit();
    };
    __syncthreads();                       // the ring's last readers done
    g_issue(0);
    float acc[8][4];                       // G: acc[0 .. 3]; Y: all
    for (int k = 0; k < gsteps; ++k) {
      g_issue(k + 1);
      cp_async_wait<1>();
      __syncthreads();                     // step k's chunks in
      const int n0 = (k % n_nk) * kWide;
      if (n0 == 0) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      }
      const uint32_t cs = smem_addr(ring + 2 * (k & 1) * kTileBytes);
      const uint32_t bs = cs + kTileBytes;
#pragma unroll
      for (int ks = 0; ks < kWide / 8; ++ks) {
        if (n0 + 8 * ks >= N) break;
        uint32_t af[4], ah[4], al[4];
        tf32::ldmatrix_x4(af, cs + ((grp * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * kLd +
                                    8 * ks + (lane >> 4) * 4) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tf32::split(__uint_as_float(af[e]), ah[e], al[e]);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int np = 2 * slot + q;     // 16 columns: n8 tiles 2q, 2q+1
          uint32_t bf[4], bh[4], bl[4];
          tf32::ldmatrix_x4(bf, bs + ((16 * np + (lane & 7) +
                                       (lane >> 4) * 8) * kLd +
                                      8 * ks + ((lane >> 3) & 1) * 4) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tf32::split(__uint_as_float(bf[e]), bh[e], bl[e]);
          tf32::mma3(acc[2 * q], ah, al, bh[0], bh[1], bl[0], bl[1]);
          tf32::mma3(acc[2 * q + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        }
      }
      if (n0 + kWide >= N) {               // the tile's last chunk: store G
        const int jt = k / n_nk;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)     // slice 2 slot + nt / 2
          *reinterpret_cast<float4*>(
              g_w + (jt * kSlices + 2 * slot + nt / 2) * 256 + lane * 8 +
              (nt % 2) * 4) =
              make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
      }
      __syncthreads();                     // read; step k + 2 reloads them
    }

    // ---- per head and P chunk: Y = (G o L) X over column tiles --------
    // step s is (head pair hp, chunk pc, column tile jt), jt fastest:
    // slot q's warps take head 2 hp + q.  The X tiles of step s + 1 load
    // while step s computes.
    const int n_hp = (heads + kSlots - 1) / kSlots;
    const int nsteps = n_hp * n_pc * ncol;
    auto issue = [&](int s) {
      if (s < nsteps) {
        const int jt = s % ncol, q = s / ncol;
        const int p0 = (q % n_pc) * kWide, j0 = jt * kCols;
        for (int sl = 0; sl < kSlots; ++sl) {
          const int hh = (q / n_pc) * kSlots + sl;
          if (hh < heads)
            load_tile(ring + (s % kStages) * kStageBytes + sl * kTileBytes,
                      x + ((cell * l + j0) * H + hg * kHeads + hh) *
                              (int64_t)P + p0,
                      (int64_t)H * P, l - j0, P - p0, vec_x);
        }
      }
      cp_async_commit();
    };
    for (int s = 0; s < kStages - 1; ++s) issue(s);
    float cum_i0 = 0.f, cum_i1 = 0.f;
    const int gi0 = i0 + r0, gi1 = gi0 + 8;
    for (int s = 0; s < nsteps; ++s) {
      cp_async_wait<kStages - 2>();
      __syncthreads();                     // tile s in; tile s - 1 read
      issue(s + kStages - 1);
      const int jt = s % ncol, q = s / ncol, pc = q % n_pc;
      const int hh = (q / n_pc) * kSlots + slot;
      if (hh >= heads) continue;           // an odd head count's last pair
      const int j0 = jt * kCols, p0 = pc * kWide;
      const int n_np = (min(kWide, P - p0) + 15) / 16;
      const float* cum = cum_s + hh * l_pad;
      if (jt == 0) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
        cum_i0 = cum[gi0];
        cum_i1 = cum[gi1];
      }
      const float* xs = reinterpret_cast<const float*>(
          ring + (s % kStages) * kStageBytes + slot * kTileBytes);
      const float* g_t = g_w + jt * kSlices * 256 + lane * 8;
      if (jt == it)               // slices 0 .. grp reach the warp's rows
        y_tile_n<true>(n_np, acc, g_t, cum + j0, cum_i0, cum_i1, r0,
                       grp + 1, xs, lane);
      else
        y_tile_n<false>(n_np, acc, g_t, cum + j0, cum_i0, cum_i1, r0,
                        kSlices, xs, lane);
      if (jt != ncol - 1) continue;
      // ---- store Y's rows of this head and P chunk --------------------
      float* yh = y + (cell * l * H + hg * kHeads + hh) * (int64_t)P;
      const int64_t ys = (int64_t)H * P;               // row stride of y
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= 2 * n_np) break;
        const int p = p0 + 8 * nt + 2 * t;
        if (vec_y) {
          // quad neighbours t, t ^ 1 swap halves: even t stores row g,
          // odd t row g + 8, four columns each
          const bool odd = t & 1;
          const float q0 = __shfl_xor_sync(
              0xffffffffu, odd ? acc[nt][0] : acc[nt][2], 1);
          const float q1 = __shfl_xor_sync(
              0xffffffffu, odd ? acc[nt][1] : acc[nt][3], 1);
          const int row = odd ? gi1 : gi0, pv = odd ? p - 2 : p;
          if (row < l && pv < P)
            *reinterpret_cast<float4*>(yh + row * ys + pv) =
                odd ? make_float4(q0, q1, acc[nt][2], acc[nt][3])
                    : make_float4(acc[nt][0], acc[nt][1], q0, q1);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? gi0 : gi1, pe = p + (e & 1);
            if (row < l && pe < P) yh[row * ys + pe] = acc[nt][e];
          }
        }
      }
    }
    cp_async_wait<0>();
  }
}

int launch(const void* x, const void* a, const void* b, const void* c,
           void* y, int B, int nc, int l, int H, int P, int N,
           cudaStream_t stream) {
  const int n_row_tiles = (l + kRows - 1) / kRows;
  const size_t smem = (size_t)kStages * kStageBytes +
                      (size_t)kGroups * n_row_tiles * kGTile * sizeof(float) +
                      (size_t)kHeads * n_row_tiles * kRows * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_tc32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  auto on16 = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const int vec = (P % 4 == 0 && on16(x) ? 1 : 0) |
                  (N % 4 == 0 && on16(b) && on16(c) ? 2 : 0) |
                  (P % 4 == 0 && on16(y) ? 4 : 0);
  const int n_groups = (H + kHeads - 1) / kHeads;
  const int64_t blocks =
      (int64_t)B * nc * n_groups * ((n_row_tiles + 1) / 2);
  ssd_chunk_tc32<<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const float*)x, (const float*)a, (const float*)b, (const float*)c,
      (float*)y, nc, l, H, P, N, vec);
  return (int)cudaGetLastError();
}

}  // namespace tc32

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b and c).
extern "C" int repro_ssd_chunk(const void* x, const void* a, const void* b,
                               const void* c, void* y, int B, int nc, int l,
                               int H, int P, int N, int dtype, void* stream) {
  if ((int64_t)B * nc * l * H * P == 0) return 0;
  if (dtype == 1)
    return tc::launch(x, a, b, c, y, B, nc, l, H, P, N,
                      (cudaStream_t)stream);
  return tc32::launch(x, a, b, c, y, B, nc, l, H, P, N,
                      (cudaStream_t)stream);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
