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
// and written once (0.25 ms).  This kernel does seven products (S and dP
// twice, below): 0.49 ms at the peak.
//
// Three launches, FlashAttention-2's method, no atomics:
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
// fp32 (namespace tc32): mma.sync m16n8k8 on TF32 as 3xTF32
// (tf32.cuh; each operand split into hi + lo as its fragment loads) at
// every head dim.  TF32 wgmma reads only K-major operands from shared
// memory, so dV += P^T dO, dK += dS^T Q and dQ += dS K each want a
// transposed hi and lo copy of their B operand beside the K-major ones
// of S^T = K Q^T and dP^T = V dO^T.  dkdv at d 128, 64 keys: K and V hi
// and lo 4 x 32 KB = 128 KB, and per 32-query tile Q, dO, Q^T and dO^T
// hi and lo 8 x 16 KB = 128 KB: 256 KB, over 227 KB with no ring.  At d
// 64 and 64-query tiles the same is 64 + 128 KB, with the raw tiles 224
// KB and no second stage.  So no head dim takes wgmma in fp32.
//  * The m16n8 k8 A fragment wants columns (t, t + 4) where the
//    accumulator holds (2t, 2t + 1): the route permutes the contraction
//    index, reading rows 2t, 2t + 1 of the B operand, never the values.
//  * Each long sum (dK and dV over query tiles, dQ over key tiles) takes a
//    tile's product in a fresh accumulator, added to the running sum in
//    fp32: the tensor cores truncate as they accumulate, and chained over
//    many tiles that bias grows (PERF.md, the fp32 forward's fix).
//  * Tiles: rows padded by 16 bytes (no bank conflicts in the fragment
//    loads); dkdv takes query tiles of 32, dq key tiles of 32; at d 128
//    two CTAs share a key tile, each accumulating half of dK's and dV's
//    columns (S^T and dP^T computed by both): the whole width with the
//    split fragments spills (half the width already holds 255 registers
//    a thread).  Shared memory at d 128: dkdv and dq 135 KB,
//    one CTA an SM, so registers are left free (up to 255); at d 64 (70
//    KB, three CTAs an SM) they are capped at 168 to keep the three.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <type_traits>

#include "hopper.cuh"
#include "tf32.cuh"

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
int launch(const Params& p, const int64_t* st, cudaStream_t stream) {
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
  err = launch_dsum<__nv_bfloat16, D>(p, stream);
  if (err == 0)
    err = persistent(dkdv_kernel<D>, p.B * p.Hkv * ((p.sk + kBk - 1) / kBk),
                     KvSmem<D>::kSmem, tq, tk, tv, tdo, p, sms, stream);
  if (err == 0)
    err = persistent(dq_kernel<D>, p.B * p.H * ((p.sq + kBqQ - 1) / kBqQ),
                     QSmem<D>::kSmem, tq, tk, tv, tdo, p, sms, stream);
  return err;
}

}  // namespace hopper

// --------------------------------------------------------------------- //
// fp32: 3xTF32 on mma.sync m16n8k8
// --------------------------------------------------------------------- //
namespace tc32 {

constexpr int kWarps = 4, kThreads = 32 * kWarps;
// CTAs an SM the registers must allow: 3 at d 64, which its 70 KB of
// shared memory allows too (registers capped at 168); 1 elsewhere (d 128:
// 135 KB; d 32 spills 16 bytes at ptxas's own cap of 128)
template <int D>
constexpr int kMinBlocks = D == 64 ? 3 : 1;

template <int D>
struct Cfg {
  static constexpr int kLd = D + 4;                    // a padded row
  static constexpr int kBk = 64;                       // dkdv: keys a CTA
  static constexpr int kBqKV = 32;                     // dkdv: query tile
  // dkdv: CTAs a key tile, each accumulating dK and dV over its share of
  // d: two at d 128, where the whole width (128 registers) and 3xTF32's
  // split fragments spill
  static constexpr int kSplitD = D == 128 ? 2 : 1;
  static constexpr int kBq = 64;                       // dq: queries a CTA
  static constexpr int kBkQ = 32;                      // dq: key tile
  static constexpr int kTile = kLd * 4;                // bytes a row
  // dkdv: K | V | Q[2] | dO[2] | lse2[2] | D[2]
  static constexpr int kSmemKV = 2 * kBk * kTile + 4 * kBqKV * kTile +
                                 4 * kBqKV * 4;
  // dq: Q | dO | K[2] | V[2] | lse2 | D
  static constexpr int kSmemQ = 2 * kBq * kTile + 4 * kBkQ * kTile +
                                2 * kBq * 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; bytes 0 zero-fills
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest N committed groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// kRows rows of d elements from row row0 of a [rows, d] view (row stride
// ld elements) into a padded tile; rows at or past n_rows zeros
template <int D, int kRows>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t ld, int row0, int n_rows) {
  constexpr int kChunks = D / 4, kLd = Cfg<D>::kLd;
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 4;
    const bool in = row0 + r < n_rows;
    cp_async16(smem_addr(dst + r * kLd + c),
               in ? src + (int64_t)(row0 + r) * ld + c : src, in ? 16 : 0);
  }
}

// a tile's lse2 and D from pass 1's padded rows (+inf and 0 past sq)
__device__ __forceinline__ void load_rows(float* ls, float* ds,
                                          const float* lse2,
                                          const float* dsum, int row0,
                                          int n_rows) {
  for (int r = threadIdx.x; r < n_rows; r += kThreads) {
    ls[r] = lse2[row0 + r];
    ds[r] = dsum[row0 + r];
  }
}

// C[16 x 8 NT] += X[16 x kDepth] Y[8 NT x kDepth]^T, X and Y padded tiles
// in shared memory (rows of kLd floats) with the contraction dimension
// contiguous in both; X and Y point at their first rows.  Accumulator
// fragments (g = lane / 4, t = lane % 4): c[nt] = C[g][8 nt + 2t, + 1],
// C[g + 8][8 nt + 2t, + 1].
template <int kLd, int kDepth, int NT>
__device__ __forceinline__ void mma_nt(float (&c)[NT][4], const float* X,
                                       const float* Y, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kDepth / 8; ++kk) {
    const float* x0 = X + g * kLd + 8 * kk + t;
    uint32_t ah[4], al[4];
    tf32::split(x0[0], ah[0], al[0]);
    tf32::split(x0[8 * kLd], ah[1], al[1]);
    tf32::split(x0[4], ah[2], al[2]);
    tf32::split(x0[8 * kLd + 4], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* y0 = Y + (8 * nt + g) * kLd + 8 * kk + t;
      uint32_t bh0, bl0, bh1, bl1;
      tf32::split(y0[0], bh0, bl0);
      tf32::split(y0[4], bh1, bl1);
      tf32::mma3(c[nt], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// O[16 x 8 ND] += P[16 x 8 NK] Y[8 NK x 8 ND]: P in accumulator fragments
// (mma_nt's layout), Y a padded tile in shared memory ([k][n], rows of kLd
// floats).  Each 8 columns of O take the sum over P's columns in a fresh
// accumulator, added to O in fp32.  The accumulator of n-tile kk is the A
// fragment of k8 step kk with column t holding k = 2t and t + 4 holding
// 2t + 1, so B reads Y's rows 2t and 2t + 1 where the fragment names t and
// t + 4.
template <int kLd, int NK, int ND>
__device__ __forceinline__ void mma_pn(float (&o)[ND][4],
                                       const float (&p)[NK][4],
                                       const float* Y, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t ah[4], al[4];
      tf32::split(p[kk][0], ah[0], al[0]);
      tf32::split(p[kk][2], ah[1], al[1]);
      tf32::split(p[kk][1], ah[2], al[2]);
      tf32::split(p[kk][3], ah[3], al[3]);
      const float* y0 = Y + (8 * kk + 2 * t) * kLd + 8 * nd + g;
      uint32_t bh0, bl0, bh1, bl1;
      tf32::split(y0[0], bh0, bl0);
      tf32::split(y0[kLd], bh1, bl1);
      tf32::mma3(acc, ah, al, bh0, bh1, bl0, bl1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] += acc[e];
  }
}

// rows [r, r + 8) x 8 ND of O (fragments as mma_nt's), scaled, into rows
// row0 + g and row0 + g + 8 of a [rows, d] view; rows at or past n_rows
// are not written
template <int ND>
__device__ __forceinline__ void store_rows(float* dst, int64_t ld, int row0,
                                           int n_rows, const float (&o)[ND][4],
                                           float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int c = 8 * nd + 2 * t;
    if (row0 + g < n_rows)
      *reinterpret_cast<float2*>(dst + (int64_t)(row0 + g) * ld + c) =
          make_float2(o[nd][0] * scale, o[nd][1] * scale);
    if (row0 + g + 8 < n_rows)
      *reinterpret_cast<float2*>(dst + (int64_t)(row0 + g + 8) * ld + c) =
          make_float2(o[nd][2] * scale, o[nd][3] * scale);
  }
}

// ---- pass 2: dK and dV, a CTA a key tile of one (b, KV head) ---- //
template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
dkdv_kernel(const Params p) {
  using C = Cfg<D>;
  constexpr int kBk = C::kBk, kBq = C::kBqKV, kLd = C::kLd;
  constexpr int NQ = kBq / 8, ND = D / 8 / C::kSplitD;
  const int c0 = (int)blockIdx.y * (D / C::kSplitD);   // first column
  extern __shared__ __align__(16) uint8_t smem_kv[];
  float* ks = reinterpret_cast<float*>(smem_kv);
  float* vs = ks + kBk * kLd;
  float* qs = vs + kBk * kLd;                   // two stages
  float* dos = qs + 2 * kBq * kLd;              // two stages
  float* ls = dos + 2 * kBq * kLd;
  float* dd = ls + 2 * kBq;

  const int bhk = (int)(blockIdx.x % (unsigned)(p.B * p.Hkv));
  const int kt = (int)(blockIdx.x / (unsigned)(p.B * p.Hkv));
  const int bi = bhk / p.Hkv, hk = bhk % p.Hkv, group = p.H / p.Hkv;
  const int j0 = kt * kBk;
  const int nq = (p.sq + kBq - 1) / kBq;
  // query tiles that see a key of this tile: causal, those with a query
  // at or past its first key
  const int qt0 = p.causal ? min(j0 / kBq, nq) : 0;
  const int per_head = nq - qt0, n = group * per_head;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  const float* qg = static_cast<const float*>(p.q) + bi * p.st[kQ][0];
  const float* dog = static_cast<const float*>(p.dout) + bi * p.st[kDo][0];
  const int64_t rows_bh = (int64_t)bi * p.H;
  load_tile<D, kBk>(ks, static_cast<const float*>(p.k) + bi * p.st[kK][0] +
                            hk * p.st[kK][1], p.st[kK][2], j0, p.sk);
  load_tile<D, kBk>(vs, static_cast<const float*>(p.v) + bi * p.st[kV][0] +
                            hk * p.st[kV][1], p.st[kV][2], j0, p.sk);
  // tile it: head hk group + it / per_head, query tile qt0 + it % per_head
  auto issue = [&](int it) {
    const int h = hk * group + it / per_head;
    const int i0 = (qt0 + it % per_head) * kBq, s = it & 1;
    load_tile<D, kBq>(qs + s * kBq * kLd, qg + h * p.st[kQ][1], p.st[kQ][2],
                      i0, p.sq);
    load_tile<D, kBq>(dos + s * kBq * kLd, dog + h * p.st[kDo][1],
                      p.st[kDo][2], i0, p.sq);
    load_rows(ls + s * kBq, dd + s * kBq, p.lse2 + (rows_bh + h) * p.sq_pad,
              p.dsum + (rows_bh + h) * p.sq_pad, i0, kBq);
  };
  if (n > 0) issue(0);
  cp_async_commit();

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;
  const int jw = j0 + 16 * warp + g;            // the thread's keys jw, +8
  for (int it = 0; it < n; ++it) {
    if (it + 1 < n) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int s = it & 1, i0 = (qt0 + it % per_head) * kBq;
    const float* qt = qs + s * kBq * kLd;
    const float* dot = dos + s * kBq * kLd;
    const float* lt = ls + s * kBq;
    const float* dt = dd + s * kBq;
    float sc[NQ][4], dp[NQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
    mma_nt<kLd, D, NQ>(sc, ks + 16 * warp * kLd, qt, lane);  // S^T
    mma_nt<kLd, D, NQ>(dp, vs + 16 * warp * kLd, dot, lane); // dP^T
    // P^T and dS^T: element e of n-tile nt is key jw + 8 (e / 2), query
    // i0 + 8 nt + 2t + e % 2
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = 8 * nt + 2 * t + (e & 1), i = i0 + il;
        const int j = jw + 8 * (e >> 1);
        const bool ok = i < p.sq && j < p.sk && (!p.causal || j <= i);
        const float pe = ok ? ex2(sc[nt][e] * p.scale_log2 - lt[il]) : 0.f;
        sc[nt][e] = pe;
        dp[nt][e] = pe * (dp[nt][e] - dt[il]);
      }
    mma_pn<kLd, NQ, ND>(dv, sc, dot + c0, lane);  // dV += P^T dO
    mma_pn<kLd, NQ, ND>(dk, dp, qt + c0, lane);   // dK += dS^T Q
    __syncthreads();                            // the stage is free
  }
  const int r0 = j0 + 16 * warp;
  store_rows<ND>(static_cast<float*>(p.dk) + bi * p.st[kDk][0] +
                     hk * p.st[kDk][1] + c0, p.st[kDk][2], r0, p.sk, dk,
                 p.scale, lane);
  store_rows<ND>(static_cast<float*>(p.dv) + bi * p.st[kDv][0] +
                     hk * p.st[kDv][1] + c0, p.st[kDv][2], r0, p.sk, dv,
                 1.f, lane);
}

// ---- pass 3: dQ, a CTA a query tile of one (b, h) ---- //
template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
dq_kernel(const Params p) {
  using C = Cfg<D>;
  constexpr int kBq = C::kBq, kBk = C::kBkQ, kLd = C::kLd;
  constexpr int NK = kBk / 8, ND = D / 8;
  extern __shared__ __align__(16) uint8_t smem_q[];
  float* qs = reinterpret_cast<float*>(smem_q);
  float* dos = qs + kBq * kLd;
  float* ks = dos + kBq * kLd;                  // two stages
  float* vs = ks + 2 * kBk * kLd;               // two stages
  float* ls = vs + 2 * kBk * kLd;
  float* dd = ls + kBq;

  const int nq = (p.sq + kBq - 1) / kBq;
  const int bh = (int)(blockIdx.x % (unsigned)(p.B * p.H));
  // under the causal mask the query blocks with the most key tiles first
  const int qb = p.causal ? nq - 1 - (int)(blockIdx.x / (unsigned)(p.B * p.H))
                          : (int)(blockIdx.x / (unsigned)(p.B * p.H));
  const int bi = bh / p.H, h = bh % p.H, hk = h / (p.H / p.Hkv);
  const int i0 = qb * kBq;
  const int kv_end = p.causal ? min(p.sk, min(i0 + kBq, p.sq)) : p.sk;
  const int n = (kv_end + kBk - 1) / kBk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  load_tile<D, kBq>(qs, static_cast<const float*>(p.q) + bi * p.st[kQ][0] +
                            h * p.st[kQ][1], p.st[kQ][2], i0, p.sq);
  load_tile<D, kBq>(dos, static_cast<const float*>(p.dout) +
                             bi * p.st[kDo][0] + h * p.st[kDo][1],
                    p.st[kDo][2], i0, p.sq);
  load_rows(ls, dd, p.lse2 + ((int64_t)bi * p.H + h) * p.sq_pad,
            p.dsum + ((int64_t)bi * p.H + h) * p.sq_pad, i0, kBq);
  const float* kg = static_cast<const float*>(p.k) + bi * p.st[kK][0] +
                    hk * p.st[kK][1];
  const float* vg = static_cast<const float*>(p.v) + bi * p.st[kV][0] +
                    hk * p.st[kV][1];
  auto issue = [&](int it) {
    const int s = it & 1;
    load_tile<D, kBk>(ks + s * kBk * kLd, kg, p.st[kK][2], it * kBk, p.sk);
    load_tile<D, kBk>(vs + s * kBk * kLd, vg, p.st[kV][2], it * kBk, p.sk);
  };
  if (n > 0) issue(0);
  cp_async_commit();

  float dq[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nd][e] = 0.f;
  const int iw = 16 * warp + g;                 // the thread's rows, +8
  for (int it = 0; it < n; ++it) {
    if (it + 1 < n) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int s = it & 1, j0 = it * kBk;
    const float* kt = ks + s * kBk * kLd;
    const float* vt = vs + s * kBk * kLd;
    float sc[NK][4], dp[NK][4];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
    mma_nt<kLd, D, NK>(sc, qs + 16 * warp * kLd, kt, lane);   // S
    mma_nt<kLd, D, NK>(dp, dos + 16 * warp * kLd, vt, lane);  // dP
    // element e of n-tile nt is query i0 + iw + 8 (e / 2), key j0 + 8 nt
    // + 2t + e % 2
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = iw + 8 * (e >> 1), i = i0 + il;
        const int j = j0 + 8 * nt + 2 * t + (e & 1);
        const bool ok = i < p.sq && j < p.sk && (!p.causal || j <= i);
        const float pe = ok ? ex2(sc[nt][e] * p.scale_log2 - ls[il]) : 0.f;
        dp[nt][e] = pe * (dp[nt][e] - dd[il]);
      }
    mma_pn<kLd, NK, ND>(dq, dp, kt, lane);      // dQ += dS K
    __syncthreads();                            // the stage is free
  }
  store_rows<ND>(static_cast<float*>(p.dq) + bi * p.st[kDq][0] +
                     h * p.st[kDq][1], p.st[kDq][2], i0 + 16 * warp, p.sq,
                 dq, p.scale, lane);
}

template <int D>
int launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = (cudaError_t)launch_dsum<float, D>(p, stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t kv_blocks = (int64_t)p.B * p.Hkv *
                            ((p.sk + C::kBk - 1) / C::kBk);
  if (kv_blocks > 0) {
    err = cudaFuncSetAttribute(dkdv_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmemKV);
    if (err != cudaSuccess) return (int)err;
    dkdv_kernel<D><<<dim3((unsigned)kv_blocks, C::kSplitD), kThreads,
                     C::kSmemKV, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t q_blocks = (int64_t)p.B * p.H *
                           ((p.sq + C::kBq - 1) / C::kBq);
  if (q_blocks > 0) {
    err = cudaFuncSetAttribute(dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmemQ);
    if (err != cudaSuccess) return (int)err;
    dq_kernel<D><<<(unsigned)q_blocks, kThreads, C::kSmemQ, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace tc32

template <typename Fn>
int by_head_dim(int d, Fn&& fn) {
  if (d == 32) return fn(std::integral_constant<int, 32>{});
  if (d == 64) return fn(std::integral_constant<int, 64>{});
  if (d == 128) return fn(std::integral_constant<int, 128>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, do, dq, dk, dv).  lse: the
// forward's contiguous fp32 [B, H, sq]; dsum: a contiguous fp32 scratch of
// 2 B H sq_pad values, sq_pad = sq rounded up to a multiple of 128 (pass
// 1's lse2 and D rows).  strides: 24 int64, the batch, head and sequence
// strides of q, k, v, o, do, dq, dk and dv, in elements, each a multiple
// of 16 bytes, as the bases are.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* dsum, int B, int H, int Hkv, int sq, int sk, int d, int causal,
    float scale, int dtype, const int64_t* strides, void* stream) {
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
  for (int tsr = 0; tsr < kTensors; ++tsr)
    for (int a = 0; a < 3; ++a) p.st[tsr][a] = strides[3 * tsr + a];
  if ((int64_t)B * H * Hkv == 0 || (sq == 0 && sk == 0)) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return by_head_dim(d, [&](auto D) {
      return hopper::launch<decltype(D)::value>(p, strides, s);
    });
  return by_head_dim(d, [&](auto D) {
    return tc32::launch<decltype(D)::value>(p, s);
  });
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
