// flash_attention_bwd: the gradient of flash_attention (softmax attention
// with GQA, causal or not).  For each (batch b, head h, query i, key j),
// with s = scale q[b, h, i] . k[b, h / group, j] and the forward's row
// log-sum-exp lse[b, h, i]:
//
//   P[i, j]  = exp(s - lse[i])          (0 where the mask drops j)
//   D[i]     = sum_c do[i, c] o[i, c]
//   dP[i, j] = do[i] . v[j],   dS = P (dP - D[i])
//   dq[i]    = scale sum_j dS[i, j] k[j]
//   dk[j]    = scale sum_{h in j's group, i} dS[i, j] q[i]
//   dv[j]    = sum_{h in j's group, i} P[i, j] do[i]
//
// q, o, do, dq: [B, H, sq, d]; k, v, dk, dv: [B, Hkv, sk, d], one dtype
// (bf16 or fp32), d in {32, 64, 128}, any strides with the last dimension
// contiguous and the others on 16 bytes; lse: [B, H, sq] fp32, as the
// forward kernel writes it.  The mask is the forward's: top-left aligned
// (query i sees keys j <= i), also when sq != sk.
//
// Replaces no TPU kernel: the reference's Pallas kernel _attn_kernel
// (src/repro/kernels/flash_attention.py:113) has no VJP, and the reference
// trains through plain jnp attention.  The port's model path runs the
// forward kernel on the card, so training needs this gradient.
//
// Bound: operations.  Five products of 2 sq sk d a head (S, dP, dV, dK,
// dQ) against the forward's two: at OLMo-1B's train shape (8, 16, 16,
// 2048, 2048, 128), causal, bf16, 3.44e11 operations over the causal half,
// 0.35 ms at the bf16 tensor-core peak (989 TFLOP/s), against 0.8 GB read
// and written once (0.25 ms); in fp32 2.08 ms as 3xTF32 at the TF32 peak.
// This kernel does seven products (S and dP twice, below): 0.49 ms at the
// peak in bf16, 2.92 ms in fp32 (six bf16 passes a product).
//
// Three launches (four in fp32: pass 1b below), FlashAttention-2's
// method, no atomics:
//  1. dsum: D = rowsum(do o) in fp32 (16-byte loads, d / 8 lanes a row in
//     bf16) into a scratch of rows padded to 128 a (b, h): [2][B H]
//     [sq_pad], lse in log2 units (+inf past sq, so P is 0 there) and D
//     (0 past sq).
//  2. dkdv, key-stationary: a work item is 128 keys of one (b, KV head);
//     it walks the group's query heads and the query tiles the mask
//     admits (all of them, or those with a query at or past its first
//     key), recomputes S^T and dP^T, and sums dK and dV over them.
//  3. dq, query-stationary: a work item is 128 queries of one (b, h); it
//     walks the key tiles the mask admits, recomputes S and dP, and sums
//     dQ.
//
// Why the order of every sum is fixed (the same bits on every run, so the
// trainer resumes bit-equal): no two CTAs write one output row, and there
// are no atomics.  dK and dV of a key are summed by the one consumer
// warpgroup that owns the key, over the group's heads in order and each
// head's query tiles in order, inside wgmma's fixed accumulation; dQ of a
// query by the one warpgroup that owns it, over key tiles in order.  Which
// CTA takes an item depends only on the grid size (the SM count), and no
// sum crosses an item.  D is a fixed shuffle tree.  Recomputing S and dP
// in both passes costs 7/5 of the bound's products; a fused pass would add
// dQ's partial sums across CTAs in an order that only a counter-gated wait
// can fix, and a persistent grid whose CTAs wait on each other's counters
// can hang on a tile not yet scheduled.
//
// bf16 (namespace hopper): wgmma fed by TMA on the forward's
// warp-specialised skeleton (hopper.cuh).  384 threads a CTA: warpgroup 0
// is the producer (one thread issues every TMA load, then the warpgroup
// gives registers back), warpgroups 1 and 2 are consumers; one CTA an SM,
// persistent, items in a snake over rounds of the grid, longest first.
//  * dkdv: the item's K and V tiles (128 x d) load once by TMA and stay;
//    consumer w owns keys 64 w .. 64 w + 63.  Q and dO tiles of 64
//    queries, with their lse and D (bulk copies from the scratch), stream
//    through a ring of 4 stages with a full and an empty mbarrier each.
//    Per tile, per consumer: S^T = K Q^T and dP^T = V dO^T as wgmma
//    m64n64k16 (K, V, Q, dO all K-major in shared memory), P^T formed
//    while dP^T runs, dS^T after, then dV += P^T dO and dK += dS^T Q as
//    wgmma m64n{d}k16 with P^T and dS^T as the register A operand
//    (rounded to bf16 in place, as the forward feeds P) and dO, Q read
//    MN-major through the transpose bit.  dK and dV stay in fp32
//    registers for the whole item and are written once, dK scaled.  A
//    consumer skips a tile whose queries all lie before its keys (exact:
//    P = 0 there) and masks only tiles that cross the diagonal.
//  * dq: the item's Q and dO (128 x d) load once; K and V tiles of 128
//    keys stream through a ring of 2 stages.  Per tile, per consumer
//    (64 queries): S = Q K^T and dP = dO V^T as wgmma m64n128k16 (the
//    forward's S product), P while dP runs, dS after, dQ += dS K as wgmma
//    m64n{d}k16 with dS from registers and K read MN-major.  Keys at or
//    past sk (zeros from TMA) are masked, so no inf reaches the product.
//  * The consumers take turns at the tensor cores (hopper.cuh's named
//    barriers): each issues its products only in its turn, so one's
//    exponentials run while the other's products do.  The stationary
//    tiles are released after an item's last S and dP, so the next item's
//    load overlaps its last products and stores.
//  * Registers, at d 128 (setmaxnreg: producer 40, consumers 232; 40 x
//    128 + 232 x 256 = 64,512 of 65,536): a dkdv consumer holds dK and dV
//    (2 x 64 fp32) and S^T and dP^T (2 x 32) at the first two products,
//    192 live, then P^T and dS^T packed to 2 x 16 as S^T and dP^T die,
//    160 at the last two; a dq consumer holds dQ (64), S and dP (2 x 64),
//    192, then dS packed to 32.  A 128-query dkdv tile would need 256, and
//    running a tile's S^T and dP^T beside the last tile's dV and dK
//    products 224.  Two forms of that overlap that fit (S^T beside them
//    and dP^T after; dq over halves of a key tile) were slower.
//  * Shared memory, at d 128: dkdv K and V 2 x 32 KB + 4 stages x (Q 16
//    KB + dO 16 KB + lse and D 512 B) = 194 KB; dq Q and dO 2 x 32 KB + 2
//    stages x (K 32 KB + V 32 KB) = 192 KB; one CTA an SM (of 227 KB).  A
//    second K/V buffer for the next item (2 x 64 KB + 2 or 3 stages) was
//    no faster: the loads are hidden.
//  * What holds it back: the seven products (S and dP twice), each pass
//    near half the bf16 peak (OLMo-1B's shape: PERF.md, row 4g).
//
// fp32 (namespace bf16x3): every product on bf16 wgmma fed by TMA, each
// fp32 operand as three bf16 parts, x = p0 + p1 + p2 to 2^-27 of x (p0 =
// bf16(x), p1 = bf16(x - p0), p2 = bf16(x - p0 - p1); each remainder exact
// in fp32), and a product as the six passes whose order stays above 2^-24
// (a2 b0, a1 b1, a1 b0, a0 b2, a0 b1, a0 b0, small terms first; a1 b2, a2
// b1 and a2 b2 dropped): about 2^-24 of a term where 3xTF32 leaves 2^-21,
// at the same tensor-core time (six k16 passes at the bf16 peak against
// three k8 passes at the TF32 peak).  Why bf16 and not TF32: TF32 wgmma
// reads only K-major operands from shared memory, so dV += P^T dO, dK +=
// dS^T Q and dQ += dS K would want transposed TF32 hi and lo copies of
// dO, Q and K beside the K-major ones of S and dP (at d 128 over 227 KB);
// 16-bit wgmma reads the same parts MN-major through the transpose bit, so
// one copy of each tensor (6 bytes an element) serves both products.
//  * Pass 1b (split3_kernel) writes q, do, k and v as their parts into the
//    scratch after pass 1's rows ([3 B, heads, rows, d] bf16 a tensor),
//    once, near the memory rate (PERF.md, row 4g): the passes below then
//    load parts by TMA into hopper.cuh's layout as the bf16 route loads
//    its tiles, and split nothing.
//  * dkdv, key-stationary: a work item is 64 keys of one (b, KV head);
//    its K and V parts load once and stay; Q and dO parts of query tiles
//    (32 queries at d 128, 64 below) stream through a ring with a full and
//    an empty mbarrier a stage.  The two consumers split the products, not
//    the keys: consumer 0 takes S^T = K Q^T (wgmma m64n{tile}k16, both
//    K-major), forms P^T and hands it to consumer 1 through shared memory
//    (fp32, in the accumulator's order, a named barrier a tile, two
//    buffers), then dV += P^T dO (P^T's parts the register A operand, dO's
//    parts MN-major); consumer 1 takes dP^T = V dO^T, then dS^T from P^T
//    and dK += dS^T Q.  S^T and dP^T are each computed once: four products
//    a tile, as in the bf16 route.
//  * dq, query-stationary: a work item is 64 queries of one (b, h); its Q
//    and dO parts stay; the consumers take the key tiles (32 keys at d
//    128, 64 below) in turns, consumer c the tiles c, c + 2, ..., each
//    through a ring of its own (so each mbarrier is waited on by the one
//    consumer that releases it, phase by phase), and each computes S = Q
//    K^T, then dP = dO V^T with P formed while dP runs, dS, and dQ += dS K
//    (dS's parts from registers, K's parts MN-major) over its own tiles;
//    at the item's end consumer 1 hands its sum over shared memory and
//    consumer 0 adds it to its own (named barriers; the split depends on
//    the tile index only, not on the grid).  S and dP are computed again
//    here, as in the bf16 route: seven products of the bound's five.
//  * Stacked tiles (d 128): a streamed tile's three parts lie in each box
//    one after the other, so that S^T, dP^T and S take each A part against
//    B's parts side by side in one wgmma: a0 [b0 b1 b2] (m64n96), a1 [b0
//    b1] (n64), a2 b0 (n32), summed in fp32 after: 12 KB of shared memory
//    read a k16 step where six m64n32 passes read 18, which the SM's
//    shared-memory bandwidth (about 128 bytes a clock) feeds at two thirds
//    of the tensor cores' rate.  dq's dP keeps six chained m64n32 passes:
//    its 96 stacked accumulators beside dQ's sum and P spill.  Below d 128
//    the tiles are 64 rows (m64n64: both feeds match) and unstacked.
//  * Each long sum (dK and dV over the group's heads and query tiles, dQ
//    over key tiles) takes a tile's product in a fresh accumulator (the
//    first pass overwrites it), added to the running sum in fp32: the
//    tensor cores truncate as they accumulate, and chained over many tiles
//    that bias grows (PERF.md, the fp32 forward's fix).
//  * Registers (setmaxnreg: producer 40, consumers 232; 168 at launch; no
//    spill): at d 128 a dkdv consumer holds its running sum (64) and S^T's
//    or dP^T's stacked accumulators (96), then the tile's fresh sum (64)
//    and the A operand's three parts (24); a dq consumer dQ's running sum
//    (64) and S's stacked accumulators (96), then P and dP (2 x 16), then
//    dQ's fresh sum (64) and dS's parts (24).  Splitting the keys as the
//    bf16 route does would hold dK, dV and a fresh sum (192) beside S^T
//    and dP^T: over the budget.
//  * Shared memory (the parts, 6 bytes an element): dkdv at d 128 K and V
//    2 x 48 KB + 2 stages x (Q and dO 2 x 24 KB + lse and D 256 B) + P^T
//    2 x 8 KB = 209 KB; at d 64 2 x 24 KB + 3 x 48 KB + 2 x 16 KB = 226
//    KB; at d 32 2 x 12 KB + 4 x 24.5 KB + 2 x 16 KB = 154 KB.  dq at d 128
//    Q and dO 2 x 48 KB + 2 stages (one a consumer) x (K and V 2 x 24 KB)
//    + consumer 1's dQ 32 KB = 224 KB; at d 64 48 + 2 x 48 + 16 = 160 KB;
//    at d 32 24 + 4 x 24 + 8 = 128 KB.  One CTA an SM (of 227 KB).
//    Larger tiles do not fit: a 64-query tile at d 128 is 96 KB a stage.
//  * What holds it back (OLMo-1B's shape: PERF.md, row 4g): the seven
//    products; dq's dP at two thirds of the rate (above); a dq consumer
//    has one stage, so its next tile loads while the other consumer
//    computes; the exponentials and the parts' packing between products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// tensors whose (batch, head, sequence) strides the launch takes
enum { kQ, kK, kV, kO, kDo, kDq, kDk, kDv, kTensors };

struct Params {
  int B, H, Hkv, sq, sk, causal;
  int sq_pad;                       // sq rounded up to 128
  float scale, scale_log2;
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  const float* lse;                 // [B, H, sq], natural log
  float* lse2;                      // [B, H, sq_pad], log2 units (pass 1)
  float* dsum;                      // [B, H, sq_pad], D (pass 1)
  int64_t st[kTensors][3];          // elements
  // fp32: q, do, k and v as three bf16 parts each (pass 1b), after dsum
  __nv_bfloat16* parts;
};

// the dot product of 16 bytes of a and b (8 bf16 or 4 fp32), in fp32
__device__ __forceinline__ float dot16(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  return x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* a,
                                       const __nv_bfloat16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 fx = __bfloat1622float2(xa[k]);
    const float2 fy = __bfloat1622float2(ya[k]);
    acc += fx.x * fy.x + fx.y * fy.y;
  }
  return acc;
}

// ---- pass 1: D = rowsum(do o) into the padded scratch ---- //
// kLanes lanes a row, 16 bytes each, summed by a fixed shuffle tree
template <typename T, int D>
__global__ void __launch_bounds__(256) dsum_kernel(const Params p) {
  constexpr int kVec = 16 / (int)sizeof(T), kLanes = D / kVec;
  const int64_t row = (int64_t)blockIdx.x * (256 / kLanes) +
                      threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const bool valid = row < (int64_t)p.B * p.H * p.sq_pad;
  const int i = valid ? (int)(row % p.sq_pad) : 0;
  const int64_t bh = row / p.sq_pad;
  float acc = 0.f;
  if (valid && i < p.sq) {
    const int h = (int)(bh % p.H), bi = (int)(bh / p.H);
    acc = dot16(static_cast<const T*>(p.o) + bi * p.st[kO][0] +
                    h * p.st[kO][1] + i * p.st[kO][2] + lane * kVec,
                static_cast<const T*>(p.dout) + bi * p.st[kDo][0] +
                    h * p.st[kDo][1] + i * p.st[kDo][2] + lane * kVec);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (valid && lane == 0) {
    p.dsum[row] = acc;                           // 0 past sq
    p.lse2[row] = i < p.sq ? p.lse[bh * p.sq + i] * kLog2e : INFINITY;
  }
}

template <typename T, int D>
int launch_dsum(const Params& p, cudaStream_t stream) {
  constexpr int kRows = 256 / (D / (16 / (int)sizeof(T)));   // a block
  const int64_t rows = (int64_t)p.B * p.H * p.sq_pad;
  if (rows > 0)
    dsum_kernel<T, D><<<(unsigned)((rows + kRows - 1) / kRows), 256, 0,
                        stream>>>(p);
  return (int)cudaGetLastError();
}

// a timed call's events (repro_flash_attention_bwd_timed): event k is
// recorded on the stream before launch k and the last after the last
// launch; none for an untimed call
void mark(cudaEvent_t* ev, int k, cudaStream_t stream) {
  if (ev != nullptr) cudaEventRecord(ev[k], stream);
}

// --------------------------------------------------------------------- //
// bf16: wgmma fed by TMA, warp-specialised
// --------------------------------------------------------------------- //
namespace hopper {

using namespace sm90;


constexpr int kThreads = 384;       // warpgroup 0 produces, 1 and 2 consume
constexpr int kConsumers = 256;     // arrivals that release a stage
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kBk = 128;            // dkdv: keys an item; dq: keys a tile
constexpr int kBq = 64;             // dkdv: queries a tile
constexpr int kBqQ = 128;           // dq: queries an item
constexpr int kBox = 64;            // rows of a TMA box
static_assert(kProducerRegs * 128 + kConsumerRegs * 256 <= 65536,
              "setmaxnreg budget");

// a bf16 tile of d columns (hopper.cuh's layout): boxes of kBoxCols
// columns, each R rows of kSpan bytes
template <int D>
struct Geo {
  static constexpr int kBoxCols = D < 64 ? D : 64;    // one swizzle span
  static constexpr int kSpan = 2 * kBoxCols;          // bytes: 128 or 64
  static constexpr int kBoxes = D / kBoxCols;         // boxes across d
  static constexpr int kKSteps = kBoxCols / 16;       // k16 steps in a box
  static constexpr uint64_t kLayout = kSpan == 128 ? 1 : 2;
  static constexpr int bytes(int rows) { return rows * D * 2; }
};

// shared memory of pass 2, from a 1024-byte-aligned base: K | V |
// Q[kStages] | dO[kStages] | (lse2, D)[kStages] | mbarriers (K/V full,
// K/V empty; full, empty per stage)
template <int D>
struct KvSmem {
  static constexpr int kStages = 4;
  static constexpr int kKV = Geo<D>::bytes(kBk), kQt = Geo<D>::bytes(kBq);
  static constexpr int kK = 0, kV = kKV, kQs = 2 * kKV;
  static constexpr int kDos = kQs + kStages * kQt;
  static constexpr int kRows = kDos + kStages * kQt;  // 2 kBq floats a stage
  static constexpr int kBar = kRows + kStages * 2 * kBq * 4;
  static constexpr int kSmem = kBar + 8 * (2 + 2 * kStages) + 1024;
};

// shared memory of pass 3: Q | dO | K[kStages] | V[kStages] | mbarriers
// (Q full, Q empty; full, empty per stage)
template <int D>
struct QSmem {
  static constexpr int kStages = 2;
  static constexpr int kT = Geo<D>::bytes(kBk);
  static constexpr int kQ = 0, kDo = kT, kK = 2 * kT;
  static constexpr int kV = kK + kStages * kT;
  static constexpr int kBar = kV + kStages * kT;
  static constexpr int kSmem = kBar + 8 * (2 + 2 * kStages) + 1024;
};
static_assert(KvSmem<128>::kSmem <= 232448 && QSmem<128>::kSmem <= 232448,
              "shared memory of one CTA");

// R rows (a multiple of kBox) of a [b, h, s, d] view from row0 into a
// tile of R rows; rows past the view land as zeros
template <int D, int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row0, int h,
                                         int b) {
  using G = Geo<D>;
#pragma unroll
  for (int c = 0; c < G::kBoxes; ++c)
#pragma unroll
    for (int r = 0; r < R / kBox; ++r)
      tma_load(dst + (c * R + r * kBox) * G::kSpan, map, bar,
               c * G::kBoxCols, row0 + r * kBox, h, b);
}

// C[64 x N] (+)= A[64 x d] B[N x d]^T over d / 16 k16 steps: A the 64
// rows at ``a`` of a tile of RA rows, B the N rows at ``b`` of a tile of RB
// rows, both K-major
template <int D, int RA, int RB, int N>
__device__ __forceinline__ void mma_nt(float (&c)[N / 2], uint32_t a,
                                       uint32_t b) {
  using G = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t box = kk / G::kKSteps, col = (kk % G::kKSteps) * 32;
    const uint64_t da = make_desc(a + box * RA * G::kSpan + col, 16,
                                  8 * G::kSpan, G::kLayout);
    const uint64_t db = make_desc(b + box * RB * G::kSpan + col, 16,
                                  8 * G::kSpan, G::kLayout);
    if constexpr (N == 64) wgmma_ss_n64(c, da, db, kk);
    else wgmma_ss_n128(c, da, db, kk);
  }
}

// C[64 x d] += A[64 x K] B[K x d] over K / 16 k16 steps: A in registers
// (bf16 fragments), B the K rows at ``b`` of a tile of R rows, read
// MN-major
template <int D, int K, int R>
__device__ __forceinline__ void mma_pn(float (&c)[D / 2],
                                       const uint32_t (&a)[K / 16][4],
                                       uint32_t b) {
  using G = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<D>(c, a[kk], make_desc(b + kk * 16 * G::kSpan, R * G::kSpan,
                                    8 * G::kSpan, G::kLayout));
}

// an fp32 accumulator of N columns as bf16 wgmma A fragments, in place of
// its layout: k16 step kk holds 8-column groups 2 kk and 2 kk + 1
template <int N>
__device__ __forceinline__ void pack(const float (&x)[N / 2],
                                     uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    a[j / 2][2 * (j % 2)] = pack_bf16(x[4 * j], x[4 * j + 1]);
    a[j / 2][2 * (j % 2) + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

// rows r0 and r0 + 8 x d of an accumulator (scaled) into a [rows, d] view
// at ``dst`` (row stride ld); rows at or past n_rows are not written.  The
// thread's columns are c2, c2 + 1 of every 8.
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* dst, int64_t ld,
                                          int r0, int c2, int n_rows,
                                          const float (&x)[D / 2],
                                          float scale) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < n_rows)
      *reinterpret_cast<uint32_t*>(dst + (int64_t)r0 * ld + 8 * j + c2) =
          pack_bf16(x[4 * j] * scale, x[4 * j + 1] * scale);
    if (r0 + 8 < n_rows)
      *reinterpret_cast<uint32_t*>(dst + (int64_t)(r0 + 8) * ld + 8 * j +
                                   c2) =
          pack_bf16(x[4 * j + 2] * scale, x[4 * j + 3] * scale);
  }
}

// CTA c of G takes items c, 2G - 1 - c, 2G + c, ...: a snake over rounds
// of G, so that under the causal mask every CTA gets heavy and light
// items alike
__device__ __forceinline__ int item_of(int round) {
  const int g = (int)gridDim.x, c = (int)blockIdx.x;
  return round * g + ((round & 1) ? g - 1 - c : c);
}

// pass 2's item: 128 keys of one (b, KV head) and the query tiles (of
// every head of the group) that see them; numbered with (b, KV head)
// fastest and, under the causal mask, the key blocks with the most query
// tiles first
struct KvWork {
  int bi, hk, j0, qt0, per_head, n;
};
__device__ __forceinline__ KvWork kv_work(int w, const Params& p) {
  const int bhs = p.B * p.Hkv, bhk = w % bhs;
  KvWork wk;
  wk.bi = bhk / p.Hkv;
  wk.hk = bhk % p.Hkv;
  wk.j0 = (w / bhs) * kBk;
  const int nq = (p.sq + kBq - 1) / kBq;
  wk.qt0 = p.causal ? min(wk.j0 / kBq, nq) : 0;
  wk.per_head = nq - wk.qt0;
  wk.n = (p.H / p.Hkv) * wk.per_head;
  return wk;
}

// pass 3's item: 128 queries of one (b, h) and the key tiles they see;
// (b, h) fastest and, causal, the query blocks with the most tiles first
struct QWork {
  int bi, h, hk, q0, n;
};
__device__ __forceinline__ QWork q_work(int w, const Params& p) {
  const int nq = (p.sq + kBqQ - 1) / kBqQ, bhs = p.B * p.H, bh = w % bhs;
  QWork wk;
  wk.bi = bh / p.H;
  wk.h = bh % p.H;
  wk.hk = wk.h / (p.H / p.Hkv);
  wk.q0 = (p.causal ? nq - 1 - w / bhs : w / bhs) * kBqQ;
  const int kv_end = p.causal ? min(p.sk, min(wk.q0 + kBqQ, p.sq)) : p.sk;
  wk.n = (kv_end + kBk - 1) / kBk;
  return wk;
}

// ---- pass 2: dK and dV, key-stationary ---- //
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo, const Params p) {
  using G = Geo<D>;
  using S = KvSmem<D>;
  extern __shared__ uint8_t smem_kv[];
  const uint32_t raw = smem_addr(smem_kv);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float* rows =
      reinterpret_cast<const float*>(smem_kv + (base - raw) + S::kRows);
  const uint32_t kv_full = base + S::kBar, kv_empty = kv_full + 8;
  const uint32_t full = kv_empty + 8, empty = full + 8 * S::kStages;
  const int group = p.H / p.Hkv;
  const int n_items = p.B * p.Hkv * ((p.sk + kBk - 1) / kBk);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumers);
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread starts every load; a wait on an empty barrier
    // takes the opposite parity, so the first pass through is free
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;                                // tiles through the ring
      for (int round = 0; item_of(round) < n_items; ++round) {
        const KvWork wk = kv_work(item_of(round), p);
        mbar_wait(kv_empty, (round & 1) ^ 1);
        mbar_expect_tx(kv_full, 2 * S::kKV);
        tma_tile<D, kBk>(base + S::kK, &tk, kv_full, wk.j0, wk.hk, wk.bi);
        tma_tile<D, kBk>(base + S::kV, &tv, kv_full, wk.j0, wk.hk, wk.bi);
        for (int t = 0; t < wk.n; ++t, ++it) {
          const int s = it % S::kStages;
          const uint32_t bar = full + 8 * s;
          const int h = wk.hk * group + t / wk.per_head;
          const int i0 = (wk.qt0 + t % wk.per_head) * kBq;
          const int64_t row = ((int64_t)wk.bi * p.H + h) * p.sq_pad + i0;
          mbar_wait(empty + 8 * s, ((it / S::kStages) & 1) ^ 1);
          mbar_expect_tx(bar, 2 * S::kQt + 2 * kBq * 4);
          tma_tile<D, kBq>(base + S::kQs + s * S::kQt, &tq, bar, i0, h,
                           wk.bi);
          tma_tile<D, kBq>(base + S::kDos + s * S::kQt, &tdo, bar, i0, h,
                           wk.bi);
          const uint32_t r = base + S::kRows + s * 2 * kBq * 4;
          bulk_load(r, p.lse2 + row, kBq * 4, bar);
          bulk_load(r + kBq * 4, p.dsum + row, kBq * 4, bar);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int ct = threadIdx.x - 128 * wg;
    const int warp = ct / 32, lane = ct % 32;
    const int c2 = 2 * (lane % 4);             // columns c2, c2 + 1 of 8
    const uint32_t k_wg = base + S::kK + 64 * (wg - 1) * G::kSpan;
    const uint32_t v_wg = base + S::kV + 64 * (wg - 1) * G::kSpan;
    turn_start(wg - 1);
    int it = 0;
    for (int round = 0; item_of(round) < n_items; ++round) {
      const KvWork wk = kv_work(item_of(round), p);
      const int jw0 = wk.j0 + 64 * (wg - 1);     // the warpgroup's keys
      const int r0 = jw0 + 16 * warp + lane / 4; // the thread's: r0, r0 + 8
      float dk[D / 2], dv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
      mbar_wait(kv_full, round & 1);
      for (int t = 0; t < wk.n; ++t, ++it) {
        const int s = it % S::kStages;
        const int i0 = (wk.qt0 + t % wk.per_head) * kBq;
        const uint32_t q_s = base + S::kQs + s * S::kQt;
        const uint32_t do_s = base + S::kDos + s * S::kQt;
        // a tile whose queries all lie before the warpgroup's keys adds
        // nothing (P = 0): skipped, as are keys all at or past sk; a
        // skipping warpgroup still takes its two turns
        const bool active = jw0 < p.sk && !(p.causal && i0 + kBq - 1 < jw0);
        mbar_wait(full + 8 * s, (it / S::kStages) & 1);
        if (active) {
          const float* ls = rows + s * 2 * kBq;
          const float* dd = ls + kBq;
          float st[kBq / 2], dpt[kBq / 2];       // S^T, dP^T: keys x queries
          turn_wait(wg - 1);
          wgmma_fence();
          mma_nt<D, kBk, kBq, kBq>(st, k_wg, q_s);
          wgmma_commit();
          mma_nt<D, kBk, kBq, kBq>(dpt, v_wg, do_s);
          wgmma_commit();
          turn_pass(wg - 1);
          wgmma_wait<1>();                        // S^T is done, dP^T runs
          reg_fence(st);
          // P^T and dS^T: element 4 j + e is key r0 + 8 (e / 2), query i0
          // + 8 j + c2 + e % 2; past sq lse2 is +inf (P = 0), D is 0
          const bool diag = p.causal && jw0 + 63 > i0;
#pragma unroll
          for (int j = 0; j < kBq / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int il = 8 * j + c2 + (e & 1);
              float pe = ex2(fmaf(st[4 * j + e], p.scale_log2, -ls[il]));
              if (diag && r0 + 8 * (e >> 1) > i0 + il) pe = 0.f;
              st[4 * j + e] = pe;
            }
          wgmma_wait<0>();
          reg_fence(dpt);
          if (t == wk.n - 1) mbar_arrive(kv_empty);  // K, V read for good
#pragma unroll
          for (int j = 0; j < kBq / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dpt[4 * j + e] = st[4 * j + e] *
                               (dpt[4 * j + e] - dd[8 * j + c2 + (e & 1)]);
          uint32_t pa[kBq / 16][4], da[kBq / 16][4];
          pack<kBq>(st, pa);
          pack<kBq>(dpt, da);
          turn_wait(wg - 1);
          wgmma_fence();
          mma_pn<D, kBq, kBq>(dv, pa, do_s);      // dV += P^T dO
          mma_pn<D, kBq, kBq>(dk, da, q_s);       // dK += dS^T Q
          wgmma_commit();
          turn_pass(wg - 1);
          wgmma_wait<0>();
          reg_fence(dv);
          reg_fence(dk);
          reg_fence(pa);
          reg_fence(da);
        } else {
          turn_wait(wg - 1);
          turn_pass(wg - 1);
          if (t == wk.n - 1) mbar_arrive(kv_empty);
          turn_wait(wg - 1);
          turn_pass(wg - 1);
        }
        mbar_arrive(empty + 8 * s);
      }
      if (wk.n == 0) mbar_arrive(kv_empty);
      __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) +
                           wk.bi * p.st[kDk][0] + wk.hk * p.st[kDk][1];
      __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) +
                           wk.bi * p.st[kDv][0] + wk.hk * p.st[kDv][1];
      store_acc<D>(dkg, p.st[kDk][2], r0, c2, p.sk, dk, p.scale);
      store_acc<D>(dvg, p.st[kDv][2], r0, c2, p.sk, dv, 1.f);
    }
  }
}

// ---- pass 3: dQ, query-stationary ---- //
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo, const Params p) {
  using G = Geo<D>;
  using S = QSmem<D>;
  extern __shared__ uint8_t smem_q[];
  const uint32_t base = (smem_addr(smem_q) + 1023) & ~1023u;
  const uint32_t q_full = base + S::kBar, q_empty = q_full + 8;
  const uint32_t full = q_empty + 8, empty = full + 8 * S::kStages;
  const int n_items = p.B * p.H * ((p.sq + kBqQ - 1) / kBqQ);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int round = 0; item_of(round) < n_items; ++round) {
        const QWork wk = q_work(item_of(round), p);
        mbar_wait(q_empty, (round & 1) ^ 1);
        mbar_expect_tx(q_full, 2 * S::kT);
        tma_tile<D, kBqQ>(base + S::kQ, &tq, q_full, wk.q0, wk.h, wk.bi);
        tma_tile<D, kBqQ>(base + S::kDo, &tdo, q_full, wk.q0, wk.h, wk.bi);
        for (int t = 0; t < wk.n; ++t, ++it) {
          const int s = it % S::kStages;
          const uint32_t bar = full + 8 * s;
          mbar_wait(empty + 8 * s, ((it / S::kStages) & 1) ^ 1);
          mbar_expect_tx(bar, 2 * S::kT);
          tma_tile<D, kBk>(base + S::kK + s * S::kT, &tk, bar, t * kBk,
                           wk.hk, wk.bi);
          tma_tile<D, kBk>(base + S::kV + s * S::kT, &tv, bar, t * kBk,
                           wk.hk, wk.bi);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int ct = threadIdx.x - 128 * wg;
    const int warp = ct / 32, lane = ct % 32;
    const int c2 = 2 * (lane % 4);
    const uint32_t q_wg = base + S::kQ + 64 * (wg - 1) * G::kSpan;
    const uint32_t do_wg = base + S::kDo + 64 * (wg - 1) * G::kSpan;
    turn_start(wg - 1);
    int it = 0;
    for (int round = 0; item_of(round) < n_items; ++round) {
      const QWork wk = q_work(item_of(round), p);
      const int wq0 = wk.q0 + 64 * (wg - 1);     // the warpgroup's queries
      const int r0 = wq0 + 16 * warp + lane / 4; // the thread's: r0, r0 + 8
      // keys < lim are seen; lse2 and D of rows past sq are +inf and 0
      const int lim0 = p.causal ? min(p.sk, r0 + 1) : p.sk;
      const int lim1 = p.causal ? min(p.sk, r0 + 9) : p.sk;
      const int64_t rb = ((int64_t)wk.bi * p.H + wk.h) * p.sq_pad + r0;
      const float l0 = p.lse2[rb], l1 = p.lse2[rb + 8];
      const float d0 = p.dsum[rb], d1 = p.dsum[rb + 8];
      float dq[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
      mbar_wait(q_full, round & 1);
      for (int t = 0; t < wk.n; ++t, ++it) {
        const int s = it % S::kStages, j0 = t * kBk;
        const uint32_t k_s = base + S::kK + s * S::kT;
        const uint32_t v_s = base + S::kV + s * S::kT;
        // a warpgroup skips a tile whose keys all lie above its rows, and
        // rows all at or past sq (not written), taking its two turns
        const bool active = wq0 < p.sq && !(p.causal && j0 > wq0 + 63);
        mbar_wait(full + 8 * s, (it / S::kStages) & 1);
        if (active) {
          float sc[kBk / 2], dp[kBk / 2];        // S, dP: queries x keys
          turn_wait(wg - 1);
          wgmma_fence();
          mma_nt<D, kBqQ, kBk, kBk>(sc, q_wg, k_s);
          wgmma_commit();
          mma_nt<D, kBqQ, kBk, kBk>(dp, do_wg, v_s);
          wgmma_commit();
          turn_pass(wg - 1);
          wgmma_wait<1>();                        // S is done, dP runs
          reg_fence(sc);
          // element 4 j + e is query r0 + 8 (e / 2), key j0 + 8 j + c2 +
          // e % 2; keys past sk (zero rows) and above the diagonal masked
          const bool edge = j0 + kBk > p.sk ||
                            (p.causal && j0 + kBk - 1 > wq0);
#pragma unroll
          for (int j = 0; j < kBk / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool hi = e >= 2;
              float pe = ex2(fmaf(sc[4 * j + e], p.scale_log2,
                                  -(hi ? l1 : l0)));
              if (edge && j0 + 8 * j + c2 + (e & 1) >= (hi ? lim1 : lim0))
                pe = 0.f;
              sc[4 * j + e] = pe;
            }
          wgmma_wait<0>();
          reg_fence(dp);
          if (t == wk.n - 1) mbar_arrive(q_empty);   // Q, dO read for good
#pragma unroll
          for (int i = 0; i < kBk / 2; ++i)
            dp[i] = sc[i] * (dp[i] - ((i & 3) >= 2 ? d1 : d0));
          uint32_t da[kBk / 16][4];
          pack<kBk>(dp, da);
          turn_wait(wg - 1);
          wgmma_fence();
          mma_pn<D, kBk, kBk>(dq, da, k_s);       // dQ += dS K
          wgmma_commit();
          turn_pass(wg - 1);
          wgmma_wait<0>();
          reg_fence(dq);
          reg_fence(da);
        } else {
          turn_wait(wg - 1);
          turn_pass(wg - 1);
          if (t == wk.n - 1) mbar_arrive(q_empty);
          turn_wait(wg - 1);
          turn_pass(wg - 1);
        }
        mbar_arrive(empty + 8 * s);
      }
      if (wk.n == 0) mbar_arrive(q_empty);
      __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) +
                           wk.bi * p.st[kDq][0] + wk.h * p.st[kDq][1];
      store_acc<D>(dqg, p.st[kDq][2], r0, c2, p.sq, dq, p.scale);
    }
  }
}

// a persistent launch: one CTA an SM, or one an item where fewer
template <typename K>
int persistent(K kernel, int items, int smem, const CUtensorMap& tq,
               const CUtensorMap& tk, const CUtensorMap& tv,
               const CUtensorMap& tdo, const Params& p, int sms,
               cudaStream_t stream) {
  if (items == 0) return 0;
  kernel<<<items < sms ? items : sms, kThreads, smem, stream>>>(tq, tk, tv,
                                                                tdo, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const Params& p, const int64_t* st, cudaStream_t stream,
           cudaEvent_t* ev) {
  using G = Geo<D>;
  const CUtensorMapSwizzle swizzle = G::kSpan == 128
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  // a view with no rows is never loaded: its map describes the other side
  const bool no_q = p.sq == 0, no_k = p.sk == 0;
  auto map = [&](CUtensorMap* m, const void* ptr, int tensor, bool keys) {
    const bool other = keys ? no_k : no_q;
    const bool as_keys = keys != other;
    return encode(m, other ? (keys ? p.q : p.k) : ptr, D,
                  as_keys ? p.sk : p.sq, as_keys ? p.Hkv : p.H, p.B,
                  st + 3 * (other ? (keys ? kQ : kK) : tensor), G::kBoxCols,
                  kBox, swizzle);
  };
  // the kernels' shared-memory sizes first: a runtime call that makes the
  // device's context current in this thread (autograd's backward runs in
  // a thread of its own), which cuTensorMapEncodeTiled needs
  cudaError_t e = cudaFuncSetAttribute(
      dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      KvSmem<D>::kSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             QSmem<D>::kSmem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tq, tk, tv, tdo;
  int err = map(&tq, p.q, kQ, false);
  if (err == 0) err = map(&tdo, p.dout, kDo, false);
  if (err == 0) err = map(&tk, p.k, kK, true);
  if (err == 0) err = map(&tv, p.v, kV, true);
  if (err != 0) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != 0) return err;
  mark(ev, 0, stream);
  err = launch_dsum<__nv_bfloat16, D>(p, stream);
  mark(ev, 1, stream);
  if (err == 0)
    err = persistent(dkdv_kernel<D>, p.B * p.Hkv * ((p.sk + kBk - 1) / kBk),
                     KvSmem<D>::kSmem, tq, tk, tv, tdo, p, sms, stream);
  mark(ev, 2, stream);
  if (err == 0)
    err = persistent(dq_kernel<D>, p.B * p.H * ((p.sq + kBqQ - 1) / kBqQ),
                     QSmem<D>::kSmem, tq, tk, tv, tdo, p, sms, stream);
  mark(ev, 3, stream);
  return err;
}

}  // namespace hopper

// --------------------------------------------------------------------- //
// fp32: three bf16 parts an operand, bf16 wgmma fed by TMA
// --------------------------------------------------------------------- //
namespace bf16x3 {

using namespace sm90;
using hopper::Geo;
using hopper::item_of;

constexpr int kThreads = 384;       // warpgroup 0 produces, 1 and 2 consume
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kItem = 64;           // dkdv: keys an item; dq: queries an item
constexpr int kTileF = 64;          // rows of a streamed tile at d 32 and 64
constexpr int kTileF128 = 32;       // ... at d 128
// named barriers (0 is __syncthreads; 1 and 2 are hopper.cuh's turns,
// which this route does not take): dkdv's exchange of P^T, dq's hand-over
// of consumer 1's dQ
constexpr int kExchange = 3, kRedFull = 3, kRedEmpty = 4;
// the passes of a product of three-part operands, by A part and small
// terms first: (A part, B part) for a2 b0, a1 b1, a1 b0, a0 b2, a0 b1, a0 b0
__host__ __device__ constexpr int pass_a(int ps) {
  return ps == 0 ? 2 : ps <= 2 ? 1 : 0;
}
__host__ __device__ constexpr int pass_b(int ps) {
  return ps == 3 ? 2 : ps == 1 || ps == 4 ? 1 : 0;
}
static_assert(kProducerRegs * 128 + kConsumerRegs * 256 <= 65536,
              "setmaxnreg budget");

// a streamed tile's rows (queries in dkdv, keys in dq; also a TMA box's
// rows) and the bytes of one bf16 part of R rows of d columns, in
// hopper.cuh's layout
template <int D>
struct Cfg {
  static constexpr int kTile = D == 128 ? kTileF128 : kTileF;
  // a streamed tile's parts stacked in each box (d 128; below, each part a
  // plane of its own): see mma3_nt
  static constexpr bool kStacked = D == 128;
  __host__ __device__ static constexpr int plane(int rows) {
    return rows * D * 2;
  }
  static constexpr int kItemParts = 3 * plane(kItem);
  static constexpr int kTileParts = 3 * plane(kTile);
};

// shared memory of pass 2, from a 1024-byte-aligned base: K's parts | V's
// parts | Q's parts[kStages] | dO's parts[kStages] | (lse2, D)[kStages] |
// P^T exchange[2] | mbarriers (K/V full, K/V empty; full, empty a stage)
template <int D>
struct KvSmem {
  using C = Cfg<D>;
  static constexpr int kStages = D == 128 ? 2 : (D == 64 ? 3 : 4);
  static constexpr int kK = 0, kV = C::kItemParts, kQs = 2 * C::kItemParts;
  static constexpr int kDos = kQs + kStages * C::kTileParts;
  static constexpr int kRows = kDos + kStages * C::kTileParts;
  static constexpr int kEx = kRows + kStages * 2 * C::kTile * 4;
  static constexpr int kExBuf = kItem * C::kTile * 4;   // P^T, fp32
  static constexpr int kBar = kEx + 2 * kExBuf;
  static constexpr int kSmem = kBar + 8 * (2 + 2 * kStages) + 1024;
};

// shared memory of pass 3: Q's parts | dO's parts | (K's parts, V's
// parts)[2 kHalf] (consumer c's ring: stages c kHalf ..) | consumer 1's dQ
// | mbarriers (Q full, Q empty; full, empty a stage)
template <int D>
struct QSmem {
  using C = Cfg<D>;
  static constexpr int kHalf = D == 32 ? 2 : 1;         // stages a consumer
  static constexpr int kStages = 2 * kHalf;
  static constexpr int kQ = 0, kDo = C::kItemParts, kK = 2 * C::kItemParts;
  static constexpr int kV = kK + kStages * C::kTileParts;
  static constexpr int kRed = kV + kStages * C::kTileParts;
  static constexpr int kBar = kRed + kItem * D * 4;
  static constexpr int kSmem = kBar + 8 * (2 + 2 * kStages) + 1024;
};
static_assert(KvSmem<128>::kSmem <= 232448 && QSmem<128>::kSmem <= 232448 &&
              KvSmem<64>::kSmem <= 232448 && QSmem<64>::kSmem <= 232448 &&
              KvSmem<32>::kSmem <= 232448 && QSmem<32>::kSmem <= 232448,
              "shared memory of one CTA");

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// (x, y) as three packed bf16 pairs, x = p0 + p1 + p2 to 2^-27 of x (each
// remainder exact in fp32); x in the low half, as wgmma's A fragment
// wants the lower column
__device__ __forceinline__ void split3(float x, float y, uint32_t& p0,
                                       uint32_t& p1, uint32_t& p2) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(rx - mf.x, ry - mf.y);
  p0 = *reinterpret_cast<const uint32_t*>(&h);
  p1 = *reinterpret_cast<const uint32_t*>(&m);
  p2 = *reinterpret_cast<const uint32_t*>(&l);
}

// an fp32 accumulator of N columns as the three parts' bf16 wgmma A
// fragments (hopper::pack's layout, a part each)
template <int N>
__device__ __forceinline__ void pack3(const float (&x)[N / 2],
                                      uint32_t (&a)[3][N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int kk = j / 2, e = 2 * (j % 2);
    split3(x[4 * j], x[4 * j + 1], a[0][kk][e], a[1][kk][e], a[2][kk][e]);
    split3(x[4 * j + 2], x[4 * j + 3], a[0][kk][e + 1], a[1][kk][e + 1],
           a[2][kk][e + 1]);
  }
}
template <int N>
__device__ __forceinline__ void reg_fence3(uint32_t (&a)[3][N][4]) {
  reg_fence(a[0]);
  reg_fence(a[1]);
  reg_fence(a[2]);
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&c)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 32) wgmma_ss_n32(c, da, db, accumulate);
  else if constexpr (N == 64) wgmma_ss_n64(c, da, db, accumulate);
  else if constexpr (N == 96) wgmma_ss_n96(c, da, db, accumulate);
  else wgmma_ss_n128(c, da, db, accumulate);
}

// byte offset of part ``part``, box ``box`` of a streamed tile of R rows:
// planes one after the other, or (kStacked) in each box the three parts'
// R rows one after the other
template <int D, int R>
__host__ __device__ constexpr int tile_off(int part, int box) {
  return Cfg<D>::kStacked
             ? (box * 3 * R + part * R) * Geo<D>::kSpan
             : part * Cfg<D>::plane(R) + box * R * Geo<D>::kSpan;
}

// the accumulators of C[64 x N] = A[64 x d] B[N x d]^T on three-part
// operands (mma3_nt): one for the six passes chained, or (kStacked) one a
// part of A, against B's parts side by side: a0 [b0 b1 b2], a1 [b0 b1], a2
// b0 (wgmma m64n96, n64, n32 at a 32-row tile: 12 KB of shared memory read
// a k16 step where six m64n32 passes read 18, which the SM's shared-memory
// bandwidth feeds at two thirds of the tensor cores' rate)
template <int D, int N, bool kStacked = Cfg<D>::kStacked>
struct NtAcc {
  float x[N / 2];
};
template <int D, int N>
struct NtAcc<D, N, true> {
  float x0[3 * N / 2], x1[N], x2[N / 2];
};

// issues C = A B^T into ``acc`` (the caller fences, commits and waits): A
// the parts (planes of RA rows, the first of its 64 rows at ``a``), B the
// parts of a streamed tile of N rows at ``b``, both K-major; the six
// passes chained into one accumulator, or (kStacked) stacked as above.  A
// stacked tile's parts take chained passes too: dq's dP, issued while its
// consumer holds dQ's running sum and P, would spill stacked
template <int D, int RA, int N, bool kStacked = Cfg<D>::kStacked>
__device__ __forceinline__ void mma3_nt(NtAcc<D, N, kStacked>& acc,
                                        uint32_t a, uint32_t b) {
  using G = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t box = kk / G::kKSteps, col = (kk % G::kKSteps) * 32;
    auto da = [&](int part) {
      return make_desc(a + part * Cfg<D>::plane(RA) + box * RA * G::kSpan +
                           col, 16, 8 * G::kSpan, G::kLayout);
    };
    if constexpr (kStacked) {
      const uint64_t db = make_desc(b + tile_off<D, N>(0, box) + col, 16,
                                    8 * G::kSpan, G::kLayout);
      wgmma_ss<N>(acc.x2, da(2), db, kk > 0);
      wgmma_ss<2 * N>(acc.x1, da(1), db, kk > 0);
      wgmma_ss<3 * N>(acc.x0, da(0), db, kk > 0);
    } else {
#pragma unroll
      for (int ps = 0; ps < 6; ++ps)
        wgmma_ss<N>(acc.x, da(pass_a(ps)),
                    make_desc(b + tile_off<D, N>(pass_b(ps), box) + col, 16,
                              8 * G::kSpan, G::kLayout),
                    kk > 0 || ps > 0);
    }
  }
}

// C from mma3_nt's accumulators once they are done: stacked, the six
// passes' sums added in fp32 in the passes' order
template <int D, int N, bool kStacked>
__device__ __forceinline__ void nt_sum(NtAcc<D, N, kStacked>& acc,
                                       float (&c)[N / 2]) {
  if constexpr (kStacked) {
    reg_fence(acc.x0);
    reg_fence(acc.x1);
    reg_fence(acc.x2);
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      c[i] = ((((acc.x2[i] + acc.x1[i + N / 2]) + acc.x1[i]) +
               acc.x0[i + N]) + acc.x0[i + N / 2]) + acc.x0[i];
  } else {
    reg_fence(acc.x);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) c[i] = acc.x[i];
  }
}

// C[64 x d] = A[64 x K] B[K x d] on three-part operands: A in registers
// (pack3's fragments), B the parts of a streamed tile of K rows at ``b``,
// read MN-major (the boxes across d tile_off's box stride apart); six
// passes a k16 step, into C afresh
template <int D, int K>
__device__ __forceinline__ void mma3_pn(float (&c)[D / 2],
                                        const uint32_t (&a)[3][K / 16][4],
                                        uint32_t b) {
  using G = Geo<D>;
  constexpr int kBoxStride = tile_off<D, K>(0, 1) - tile_off<D, K>(0, 0);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int ps = 0; ps < 6; ++ps)
      wgmma_rs<D>(c, a[pass_a(ps)][kk],
                  make_desc(b + tile_off<D, K>(pass_b(ps), 0) +
                                kk * 16 * G::kSpan,
                            kBoxStride, 8 * G::kSpan, G::kLayout),
                  kk > 0 || ps > 0);
}

// the three parts of R rows (a multiple of the tile) of an fp32 view from
// row0, from their [3 B, heads, rows, d] scratch, to dst: an item's as
// planes of R rows, a streamed tile's (kStream) at tile_off; rows past the
// view land as zeros
template <int D, int R, bool kStream>
__device__ __forceinline__ void tma_parts(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int row0, int h, int b,
                                          int batch) {
  using G = Geo<D>;
  constexpr int kBox = Cfg<D>::kTile;
#pragma unroll
  for (int part = 0; part < 3; ++part)
#pragma unroll
    for (int c = 0; c < G::kBoxes; ++c)
#pragma unroll
      for (int r = 0; r < R / kBox; ++r)
        tma_load(dst + (kStream ? tile_off<D, R>(part, c)
                              : part * Cfg<D>::plane(R) + c * R * G::kSpan) +
                     r * kBox * G::kSpan,
                 map, bar, c * G::kBoxCols, row0 + r * kBox, h,
                 part * batch + b);
}

// rows r0 and r0 + 8 x d of an accumulator (scaled) into a [rows, d] fp32
// view at ``dst`` (row stride ld); rows at or past n_rows are not written
template <int D>
__device__ __forceinline__ void store_acc(float* dst, int64_t ld, int r0,
                                          int c2, int n_rows,
                                          const float (&x)[D / 2],
                                          float scale) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < n_rows)
      *reinterpret_cast<float2*>(dst + (int64_t)r0 * ld + 8 * j + c2) =
          make_float2(x[4 * j] * scale, x[4 * j + 1] * scale);
    if (r0 + 8 < n_rows)
      *reinterpret_cast<float2*>(dst + (int64_t)(r0 + 8) * ld + 8 * j + c2) =
          make_float2(x[4 * j + 2] * scale, x[4 * j + 3] * scale);
  }
}

// pass 2's item: 64 keys of one (b, KV head) and the query tiles (of every
// head of the group) that see them; (b, KV head) fastest, the key blocks
// with the most query tiles first (numbered as pass 3's, with the key
// blocks of one head fastest, the rounds' unequal causal items cost more
// than L2 gives back: slower at the GQA train shapes on an H100)
struct KvWork {
  int bi, hk, j0, qt0, per_head, n;
};
template <int D>
__device__ __forceinline__ KvWork kv_work(int w, const Params& p) {
  constexpr int kTile = Cfg<D>::kTile;
  const int bhs = p.B * p.Hkv, bhk = w % bhs;
  KvWork wk;
  wk.bi = bhk / p.Hkv;
  wk.hk = bhk % p.Hkv;
  wk.j0 = (w / bhs) * kItem;
  const int nq = (p.sq + kTile - 1) / kTile;
  wk.qt0 = p.causal ? min(wk.j0 / kTile, nq) : 0;
  wk.per_head = nq - wk.qt0;
  wk.n = (p.H / p.Hkv) * wk.per_head;
  return wk;
}

// pass 3's item: 64 queries of one (b, h) and the key tiles they see;
// the query blocks of one (b, h) fastest and, causal, those with the most
// tiles first: the CTAs at work at once read the key and value parts of a
// few heads, which stay in L2 (numbered with (b, h) fastest, they read
// every head's, from memory where the heads do not share a KV head:
// slower at OLMo-1B's and Whisper's shapes on an H100, as were chunks of
// 8 heads)
struct QWork {
  int bi, h, hk, q0, n;
};
template <int D>
__device__ __forceinline__ QWork q_work(int w, const Params& p) {
  constexpr int kTile = Cfg<D>::kTile;
  const int nq = (p.sq + kItem - 1) / kItem, bh = w / nq;
  QWork wk;
  wk.bi = bh / p.H;
  wk.h = bh % p.H;
  wk.hk = wk.h / (p.H / p.Hkv);
  wk.q0 = (p.causal ? nq - 1 - w % nq : w % nq) * kItem;
  const int kv_end = p.causal ? min(p.sk, min(wk.q0 + kItem, p.sq)) : p.sk;
  wk.n = (kv_end + kTile - 1) / kTile;
  return wk;
}

// ---- pass 2: dK and dV, key-stationary ---- //
// consumer 0 takes S^T, P^T and dV; consumer 1 dP^T, dS^T and dK, P^T
// handed over through shared memory
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo, const Params p) {
  using C = Cfg<D>;
  using S = KvSmem<D>;
  constexpr int kTile = C::kTile;
  extern __shared__ uint8_t smem_kv3[];
  const uint32_t raw = smem_addr(smem_kv3);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_kv3 + (base - raw);
  const float* rows = reinterpret_cast<const float*>(sm + S::kRows);
  float4* ex = reinterpret_cast<float4*>(sm + S::kEx);
  const uint32_t kv_full = base + S::kBar, kv_empty = kv_full + 8;
  const uint32_t full = kv_empty + 8, empty = full + 8 * S::kStages;
  const int group = p.H / p.Hkv;
  const int n_items = p.B * p.Hkv * ((p.sk + kItem - 1) / kItem);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 256);
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;                                // tiles through the ring
      for (int round = 0; item_of(round) < n_items; ++round) {
        const KvWork wk = kv_work<D>(item_of(round), p);
        mbar_wait(kv_empty, (round & 1) ^ 1);
        mbar_expect_tx(kv_full, 2 * C::kItemParts);
        tma_parts<D, kItem, false>(base + S::kK, &tk, kv_full, wk.j0, wk.hk,
                                   wk.bi, p.B);
        tma_parts<D, kItem, false>(base + S::kV, &tv, kv_full, wk.j0, wk.hk,
                                   wk.bi, p.B);
        for (int t = 0; t < wk.n; ++t, ++it) {
          const int s = it % S::kStages;
          const uint32_t bar = full + 8 * s;
          const int h = wk.hk * group + t / wk.per_head;
          const int i0 = (wk.qt0 + t % wk.per_head) * kTile;
          const int64_t row = ((int64_t)wk.bi * p.H + h) * p.sq_pad + i0;
          mbar_wait(empty + 8 * s, ((it / S::kStages) & 1) ^ 1);
          mbar_expect_tx(bar, 2 * C::kTileParts + 2 * kTile * 4);
          tma_parts<D, kTile, true>(base + S::kQs + s * C::kTileParts, &tq,
                                    bar, i0, h, wk.bi, p.B);
          tma_parts<D, kTile, true>(base + S::kDos + s * C::kTileParts, &tdo,
                                    bar, i0, h, wk.bi, p.B);
          const uint32_t r = base + S::kRows + s * 2 * kTile * 4;
          bulk_load(r, p.lse2 + row, kTile * 4, bar);
          bulk_load(r + kTile * 4, p.dsum + row, kTile * 4, bar);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int ct = threadIdx.x - 128 * wg;
    const int warp = ct / 32, lane = ct % 32;
    const int c2 = 2 * (lane % 4);             // columns c2, c2 + 1 of 8
    // consumer 0: S^T = K Q^T, then dV += P^T dO; consumer 1: dP^T =
    // V dO^T, then dK += dS^T Q
    const uint32_t a_st = base + (c == 0 ? S::kK : S::kV);
    int it = 0, n_ex = 0;
    for (int round = 0; item_of(round) < n_items; ++round) {
      const KvWork wk = kv_work<D>(item_of(round), p);
      const int r0 = wk.j0 + 16 * warp + lane / 4;  // the thread's: r0, +8
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      mbar_wait(kv_full, round & 1);
      for (int t = 0; t < wk.n; ++t, ++it) {
        const int s = it % S::kStages;
        const int i0 = (wk.qt0 + t % wk.per_head) * kTile;
        const uint32_t q_s = base + S::kQs + s * C::kTileParts;
        const uint32_t do_s = base + S::kDos + s * C::kTileParts;
        mbar_wait(full + 8 * s, (it / S::kStages) & 1);
        float x[kTile / 2];            // S^T or dP^T: keys x queries
        {
          NtAcc<D, kTile> st;
          wgmma_fence();
          mma3_nt<D, kItem, kTile>(st, a_st, c == 0 ? q_s : do_s);
          wgmma_commit();
          wgmma_wait<0>();
          nt_sum(st, x);
        }
        if (t == wk.n - 1) mbar_arrive(kv_empty);   // K, V read for good
        // element 4 j + e is key r0 + 8 (e / 2), query i0 + 8 j + c2 +
        // e % 2; past sq lse2 is +inf (P = 0) and D is 0
        const float* ls = rows + s * 2 * kTile;
        float4* xb = ex + (n_ex & 1) * (kTile / 8) * 128 + ct;
        ++n_ex;
        if (c == 0) {
          const bool diag = p.causal && wk.j0 + kItem - 1 > i0;
#pragma unroll
          for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int il = 8 * j + c2 + (e & 1);
              float pe = ex2(fmaf(x[4 * j + e], p.scale_log2, -ls[il]));
              if (diag && r0 + 8 * (e >> 1) > i0 + il) pe = 0.f;
              x[4 * j + e] = pe;
            }
#pragma unroll
          for (int q4 = 0; q4 < kTile / 8; ++q4)
            xb[q4 * 128] = make_float4(x[4 * q4], x[4 * q4 + 1],
                                       x[4 * q4 + 2], x[4 * q4 + 3]);
          named_sync(kExchange);                 // P^T handed over
        } else {
          named_sync(kExchange);
          const float* dd = ls + kTile;
#pragma unroll
          for (int q4 = 0; q4 < kTile / 8; ++q4) {
            const float4 pt = xb[q4 * 128];
            const float pv[4] = {pt.x, pt.y, pt.z, pt.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              x[4 * q4 + e] = pv[e] * (x[4 * q4 + e] -
                                       dd[8 * q4 + c2 + (e & 1)]);
          }
        }
        // a tile's dV (or dK) in a fresh accumulator, added in fp32
        uint32_t a[3][kTile / 16][4];
        pack3<kTile>(x, a);
        float fresh[D / 2];
        wgmma_fence();
        mma3_pn<D, kTile>(fresh, a, c == 0 ? do_s : q_s);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(fresh);
        reg_fence3(a);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] += fresh[i];
        mbar_arrive(empty + 8 * s);
      }
      if (wk.n == 0) mbar_arrive(kv_empty);
      const int tsr = c == 0 ? kDv : kDk;
      float* dst = static_cast<float*>(c == 0 ? p.dv : p.dk) +
                   wk.bi * p.st[tsr][0] + wk.hk * p.st[tsr][1];
      store_acc<D>(dst, p.st[tsr][2], r0, c2, p.sk, acc,
                   c == 0 ? 1.f : p.scale);
    }
  }
}

// ---- pass 3: dQ, query-stationary ---- //
// the consumers take the key tiles in turns (consumer c tiles c, c + 2,
// ..., through a ring of its own), each summing its share of dQ; at the
// item's end consumer 0 adds consumer 1's share to its own
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo, const Params p) {
  using C = Cfg<D>;
  using S = QSmem<D>;
  constexpr int kTile = C::kTile;
  extern __shared__ uint8_t smem_q3[];
  const uint32_t raw = smem_addr(smem_q3);
  const uint32_t base = (raw + 1023) & ~1023u;
  float4* red = reinterpret_cast<float4*>(smem_q3 + (base - raw) + S::kRed);
  const uint32_t q_full = base + S::kBar, q_empty = q_full + 8;
  const uint32_t full = q_empty + 8, empty = full + 8 * S::kStages;
  const int n_items = p.B * p.H * ((p.sq + kItem - 1) / kItem);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 256);
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it0 = 0, it1 = 0;                      // tiles through each ring
      for (int round = 0; item_of(round) < n_items; ++round) {
        const QWork wk = q_work<D>(item_of(round), p);
        mbar_wait(q_empty, (round & 1) ^ 1);
        mbar_expect_tx(q_full, 2 * C::kItemParts);
        tma_parts<D, kItem, false>(base + S::kQ, &tq, q_full, wk.q0, wk.h,
                                   wk.bi, p.B);
        tma_parts<D, kItem, false>(base + S::kDo, &tdo, q_full, wk.q0, wk.h,
                                   wk.bi, p.B);
        for (int t = 0; t < wk.n; ++t) {
          const int c = t & 1, n = c == 0 ? it0++ : it1++;
          const int s = c * S::kHalf + n % S::kHalf;
          const uint32_t bar = full + 8 * s;
          mbar_wait(empty + 8 * s, ((n / S::kHalf) & 1) ^ 1);
          mbar_expect_tx(bar, 2 * C::kTileParts);
          tma_parts<D, kTile, true>(base + S::kK + s * C::kTileParts, &tk,
                                    bar, t * kTile, wk.hk, wk.bi, p.B);
          tma_parts<D, kTile, true>(base + S::kV + s * C::kTileParts, &tv,
                                    bar, t * kTile, wk.hk, wk.bi, p.B);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int ct = threadIdx.x - 128 * wg;
    const int warp = ct / 32, lane = ct % 32;
    const int c2 = 2 * (lane % 4);
    if (c == 0) named_arrive(kRedEmpty);         // the hand-over is free
    int n = 0;                                   // tiles this consumer took
    for (int round = 0; item_of(round) < n_items; ++round) {
      const QWork wk = q_work<D>(item_of(round), p);
      const int r0 = wk.q0 + 16 * warp + lane / 4;  // the thread's: r0, +8
      // keys < lim are seen; lse2 and D of rows past sq are +inf and 0
      const int lim0 = p.causal ? min(p.sk, r0 + 1) : p.sk;
      const int lim1 = p.causal ? min(p.sk, r0 + 9) : p.sk;
      const int64_t rb = ((int64_t)wk.bi * p.H + wk.h) * p.sq_pad + r0;
      const float l0 = p.lse2[rb], l1 = p.lse2[rb + 8];
      const float d0 = p.dsum[rb], d1 = p.dsum[rb + 8];
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      mbar_wait(q_full, round & 1);
      bool released = false;
      for (int t = c; t < wk.n; t += 2, ++n) {
        const int s = c * S::kHalf + n % S::kHalf, j0 = t * kTile;
        const uint32_t k_s = base + S::kK + s * C::kTileParts;
        const uint32_t v_s = base + S::kV + s * C::kTileParts;
        mbar_wait(full + 8 * s, (n / S::kHalf) & 1);
        float sc[kTile / 2], dp[kTile / 2];      // S, dP: queries x keys
        {
          NtAcc<D, kTile, C::kStacked> acc_s;
          wgmma_fence();
          mma3_nt<D, kItem, kTile>(acc_s, base + S::kQ, k_s);
          wgmma_commit();
          wgmma_wait<0>();
          nt_sum(acc_s, sc);
        }
        NtAcc<D, kTile, false> acc_dp;           // chained: see mma3_nt
        wgmma_fence();
        mma3_nt<D, kItem, kTile, false>(acc_dp, base + S::kDo, v_s);
        wgmma_commit();                           // dP runs beside P
        // element 4 j + e is query r0 + 8 (e / 2), key j0 + 8 j + c2 +
        // e % 2; keys past sk (zero rows) and above the diagonal masked
        const bool edge = j0 + kTile > p.sk ||
                          (p.causal && j0 + kTile - 1 > wk.q0);
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool hi = e >= 2;
            float pe = ex2(fmaf(sc[4 * j + e], p.scale_log2,
                                -(hi ? l1 : l0)));
            if (edge && j0 + 8 * j + c2 + (e & 1) >= (hi ? lim1 : lim0))
              pe = 0.f;
            sc[4 * j + e] = pe;
          }
        wgmma_wait<0>();
        nt_sum(acc_dp, dp);
        if (t + 2 >= wk.n) {                      // Q, dO read for good
          mbar_arrive(q_empty);
          released = true;
        }
#pragma unroll
        for (int i = 0; i < kTile / 2; ++i)
          dp[i] = sc[i] * (dp[i] - ((i & 3) >= 2 ? d1 : d0));
        uint32_t a[3][kTile / 16][4];
        pack3<kTile>(dp, a);
        float fresh[D / 2];
        wgmma_fence();
        mma3_pn<D, kTile>(fresh, a, k_s);        // a tile's dS K, afresh
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(fresh);
        reg_fence3(a);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] += fresh[i];
        mbar_arrive(empty + 8 * s);
      }
      if (!released) mbar_arrive(q_empty);
      // dQ = consumer 0's share + consumer 1's, in that order
      if (c == 1) {
        named_sync(kRedEmpty);
#pragma unroll
        for (int q4 = 0; q4 < D / 8; ++q4)
          red[q4 * 128 + ct] = make_float4(acc[4 * q4], acc[4 * q4 + 1],
                                           acc[4 * q4 + 2], acc[4 * q4 + 3]);
        named_arrive(kRedFull);
      } else {
        named_sync(kRedFull);
#pragma unroll
        for (int q4 = 0; q4 < D / 8; ++q4) {
          const float4 o = red[q4 * 128 + ct];
          acc[4 * q4] += o.x;
          acc[4 * q4 + 1] += o.y;
          acc[4 * q4 + 2] += o.z;
          acc[4 * q4 + 3] += o.w;
        }
        named_arrive(kRedEmpty);
        float* dqg = static_cast<float*>(p.dq) + wk.bi * p.st[kDq][0] +
                     wk.h * p.st[kDq][1];
        store_acc<D>(dqg, p.st[kDq][2], r0, c2, p.sq, acc, p.scale);
      }
    }
  }
}

// ---- pass 1b: q, do, k and v as three bf16 parts ---- //
// tensor blockIdx.y (q, do, k, v) into its [3 B, heads, rows, d] array of
// the scratch (Params::parts: q's, do's, k's, v's), 4 elements a thread
template <int D>
__global__ void __launch_bounds__(256) split3_kernel(const Params p) {
  const int y = blockIdx.y;
  const bool kv = y >= 2;
  const int tsr = y == 0 ? kQ : y == 1 ? kDo : y == 2 ? kK : kV;
  const int heads = kv ? p.Hkv : p.H, len = kv ? p.sk : p.sq;
  const int64_t n_q = (int64_t)p.B * p.H * p.sq * D;
  const int64_t n_k = (int64_t)p.B * p.Hkv * p.sk * D;
  const int64_t n = kv ? n_k : n_q;
  const int64_t idx = ((int64_t)blockIdx.x * 256 + threadIdx.x) * 4;
  if (idx >= n) return;
  const int64_t row = idx / D;
  const int col = (int)(idx % D), i = (int)(row % len);
  const int h = (int)(row / len % heads), bi = (int)(row / len / heads);
  const float4 x = *reinterpret_cast<const float4*>(
      static_cast<const float*>(
          tsr == kQ ? p.q : tsr == kDo ? p.dout : tsr == kK ? p.k : p.v) +
      bi * p.st[tsr][0] + h * p.st[tsr][1] + i * p.st[tsr][2] + col);
  __nv_bfloat16* dst = p.parts + (y < 2 ? y * 3 * n_q
                                        : 6 * n_q + (y - 2) * 3 * n_k) + idx;
  uint32_t a[3], b[3];
  split3(x.x, x.y, a[0], a[1], a[2]);
  split3(x.z, x.w, b[0], b[1], b[2]);
#pragma unroll
  for (int part = 0; part < 3; ++part)
    *reinterpret_cast<uint2*>(dst + part * n) = make_uint2(a[part], b[part]);
}

template <int D>
int launch(const Params& p, cudaStream_t stream, cudaEvent_t* ev) {
  using G = Geo<D>;
  const CUtensorMapSwizzle swizzle = G::kSpan == 128
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  const int64_t n_q = (int64_t)p.B * p.H * p.sq * D;
  const int64_t n_k = (int64_t)p.B * p.Hkv * p.sk * D;
  const __nv_bfloat16* parts[4] = {p.parts, p.parts + 3 * n_q,
                                   p.parts + 6 * n_q,
                                   p.parts + 6 * n_q + 3 * n_k};
  // a view with no rows is never loaded: its map describes the other side
  const bool no_q = p.sq == 0, no_k = p.sk == 0;
  auto map = [&](CUtensorMap* m, int which) {
    const bool keys = which >= 2, other = keys ? no_k : no_q;
    const bool as_keys = keys != other;
    const int rows = as_keys ? p.sk : p.sq, heads = as_keys ? p.Hkv : p.H;
    const int64_t pst[3] = {(int64_t)heads * rows * D, (int64_t)rows * D, D};
    return encode(m, other ? parts[keys ? 0 : 2] : parts[which], D, rows,
                  heads, 3 * p.B, pst, G::kBoxCols, Cfg<D>::kTile, swizzle);
  };
  cudaError_t e = cudaFuncSetAttribute(
      dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      KvSmem<D>::kSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             QSmem<D>::kSmem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tq, tk, tv, tdo;
  int err = map(&tq, 0);
  if (err == 0) err = map(&tdo, 1);
  if (err == 0) err = map(&tk, 2);
  if (err == 0) err = map(&tv, 3);
  if (err != 0) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != 0) return err;
  const int64_t n4 = (n_q > n_k ? n_q : n_k) / 4;
  mark(ev, 0, stream);
  split3_kernel<D><<<dim3((unsigned)((n4 + 255) / 256), 4), 256, 0,
                     stream>>>(p);
  err = (int)cudaGetLastError();
  mark(ev, 1, stream);
  if (err == 0) err = launch_dsum<float, D>(p, stream);
  mark(ev, 2, stream);
  if (err == 0)
    err = hopper::persistent(dkdv_kernel<D>,
                             p.B * p.Hkv * ((p.sk + kItem - 1) / kItem),
                             KvSmem<D>::kSmem, tq, tk, tv, tdo, p, sms,
                             stream);
  mark(ev, 3, stream);
  if (err == 0)
    err = hopper::persistent(dq_kernel<D>,
                             p.B * p.H * ((p.sq + kItem - 1) / kItem),
                             QSmem<D>::kSmem, tq, tk, tv, tdo, p, sms,
                             stream);
  mark(ev, 4, stream);
  return err;
}

}  // namespace bf16x3

template <typename Fn>
int by_head_dim(int d, Fn&& fn) {
  if (d == 32) return fn(std::integral_constant<int, 32>{});
  if (d == 64) return fn(std::integral_constant<int, 64>{});
  if (d == 128) return fn(std::integral_constant<int, 128>{});
  return (int)cudaErrorInvalidValue;
}

// one call's launches on ``stream``, ev (none, or the timed call's
// events) passed on to mark
int run(const void* q, const void* k, const void* v, const void* o,
        const void* lse, const void* dout, void* dq, void* dk, void* dv,
        void* dsum, int B, int H, int Hkv, int sq, int sk, int d, int causal,
        float scale, int dtype, const int64_t* strides, cudaStream_t stream,
        cudaEvent_t* ev) {
  Params p;
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.sq_pad = (sq + 127) / 128 * 128;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = static_cast<const float*>(lse);
  p.lse2 = static_cast<float*>(dsum);
  p.dsum = p.lse2 + (int64_t)B * H * p.sq_pad;
  p.parts = nullptr;
  for (int tsr = 0; tsr < kTensors; ++tsr)
    for (int a = 0; a < 3; ++a) p.st[tsr][a] = strides[3 * tsr + a];
  if (dtype == 1)
    return by_head_dim(d, [&](auto D) {
      return hopper::launch<decltype(D)::value>(p, strides, stream, ev);
    });
  p.parts = reinterpret_cast<__nv_bfloat16*>(p.dsum + (int64_t)B * H *
                                                          p.sq_pad);
  return by_head_dim(d, [&](auto D) {
    return bf16x3::launch<decltype(D)::value>(p, stream, ev);
  });
}

// nothing has a row: no launch
bool no_rows(int B, int H, int Hkv, int sq, int sk) {
  return (int64_t)B * H * Hkv == 0 || (sq == 0 && sk == 0);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, do, dq, dk, dv).  lse: the
// forward's contiguous fp32 [B, H, sq]; dsum: a contiguous fp32 scratch of
// 2 B H sq_pad values, sq_pad = sq rounded up to a multiple of 128 (pass
// 1's lse2 and D rows), in fp32 followed by the three bf16 parts of q,
// do, k and v (3 (2 B H sq + 2 B Hkv sk) d values).  strides: 24 int64,
// the batch, head and sequence strides of q, k, v, o, do, dq, dk and dv,
// in elements, each a multiple of 16 bytes, as the bases are.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* dsum, int B, int H, int Hkv, int sq, int sk, int d, int causal,
    float scale, int dtype, const int64_t* strides, void* stream) {
  if (no_rows(B, H, Hkv, sq, sk)) return 0;
  return run(q, k, v, o, lse, dout, dq, dk, dv, dsum, B, H, Hkv, sq, sk, d,
             causal, scale, dtype, strides, (cudaStream_t)stream, nullptr);
}

// The same call, timed: ms[k] the device milliseconds of launch k (bf16:
// dsum, dkdv, dq; fp32: split3, dsum, dkdv, dq; 0 where nothing has a
// row) from CUDA events recorded around each on the stream; returns once
// the call is done.  For measurement only.
extern "C" int repro_flash_attention_bwd_timed(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* dsum, int B, int H, int Hkv, int sq, int sk, int d, int causal,
    float scale, int dtype, const int64_t* strides, void* stream,
    float* ms) {
  const int n = dtype == 1 ? 3 : 4;              // the route's launches
  for (int i = 0; i < n; ++i) ms[i] = 0.f;
  if (no_rows(B, H, Hkv, sq, sk)) return 0;
  cudaEvent_t ev[5];
  int made = 0, code = 0;
  for (; made <= n; ++made) {
    code = (int)cudaEventCreate(&ev[made]);
    if (code != 0) break;
  }
  if (code == 0)
    code = run(q, k, v, o, lse, dout, dq, dk, dv, dsum, B, H, Hkv, sq, sk,
               d, causal, scale, dtype, strides, (cudaStream_t)stream, ev);
  if (code == 0) code = (int)cudaEventSynchronize(ev[n]);
  for (int i = 0; i < n && code == 0; ++i)
    code = (int)cudaEventElapsedTime(&ms[i], ev[i], ev[i + 1]);
  for (int i = 0; i < made; ++i) cudaEventDestroy(ev[i]);
  return code;
}

extern "C" const char* repro_error_string(int code) {
  static char buf[96];
  if (code >= sm90::kEncodeErrorBase) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed with CUresult "
             "%d", code - sm90::kEncodeErrorBase);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)code);
}
