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
// and written once (0.25 ms).
//
// FlashAttention-2's method, in three launches and no atomics, so the
// gradient is the same bits on every run:
//  1. dsum: D = rowsum(do o) in fp32, one warp a row.
//  2. dkdv: a CTA owns 64 keys of one (b, KV head), its K and V tiles in
//     shared memory, and walks the group's query heads and the query
//     tiles the mask admits (all of them, or those with a query >= its
//     first key).  Each of 4 warps owns 16 keys and recomputes S^T = K
//     Q^T and dP^T = V dO^T for them, P^T and dS^T in the accumulators'
//     registers, then dV += P^T dO and dK += dS^T Q with P^T and dS^T as
//     the A fragments, straight from those registers.  dK and dV sum over
//     the group inside the CTA: no two CTAs write one row.
//  3. dq: a CTA owns 64 queries of one (b, h), its Q and dO tiles in
//     shared memory, and walks the key tiles the mask admits; each warp
//     recomputes S and dP for its 16 queries and forms dQ += dS K.
//  Q and dO tiles (pass 2), K and V tiles (pass 3) stream through a ring
//  of two stages by cp.async (zero fill past sq or sk), so the next tile
//  loads while this one multiplies.
//
// Routes.  bf16: mma.sync m16n8k16 on the tensor cores, fp32 accumulate;
// P and dS are rounded to bf16 for their products (as the forward rounds
// P for P V).  fp32: mma.sync m16n8k8 on TF32 as 3xTF32 (tf32.cuh; each
// operand split into hi + lo as its fragment loads).  The m16n8 k8 A
// fragment wants columns (t, t + 4) where the accumulator holds (2t,
// 2t + 1): the fp32 route permutes the contraction index, reading rows
// 2t, 2t + 1 of the B operand, never the values.  Each long sum (dK and
// dV over query tiles, dQ over key tiles) takes a tile's product in a
// fresh accumulator, added to the running sum in fp32: the tensor cores
// truncate as they accumulate, and chained over many tiles that bias
// grows (PERF.md, the fp32 forward's fix).
//
// Tiles: rows padded by 16 bytes, which keeps every fragment load of both
// routes free of bank conflicts.  dkdv takes query tiles of 64, dq key
// tiles of 64; both 32 at d 128 (where dK and dV hold 128 registers) and
// in fp32 (3xTF32's split fragments).  In fp32 at d 128 two CTAs share a key tile, each accumulating
// half of dK's and dV's columns (S^T and dP^T computed by both): the
// whole width with 3xTF32's split fragments spilled.  Shared memory, at
// d 128: dkdv 70 KB in bf16 and 135 KB in fp32, dq 70 / 135 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "tf32.cuh"

namespace {

constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

// tensors whose (batch, head, sequence) strides the launch takes
enum { kQ, kK, kV, kO, kDo, kDq, kDk, kDv, kTensors };

struct Params {
  int B, H, Hkv, sq, sk, causal;
  float scale, scale_log2;
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  const float* lse;                 // [B, H, sq], natural log
  float* dsum;                      // [B, H, sq], written by pass 1
  int64_t st[kTensors][3];          // elements
};

template <typename T, int D>
struct Cfg {
  static constexpr int kLd = D + 16 / (int)sizeof(T);  // a padded row
  static constexpr int kBk = 64;                       // dkdv: keys a CTA
  // tiles of 32 where registers are short: at d 128 (dK and dV hold 128
  // registers) and in fp32 (3xTF32's split fragments)
  static constexpr bool kNarrow = D == 128 || sizeof(T) == 4;
  static constexpr int kBqKV = kNarrow ? 32 : 64;      // dkdv: query tile
  // dkdv: CTAs a key tile, each accumulating dK and dV over its share of
  // d: two in fp32 at d 128, where the whole width (128 registers) and
  // 3xTF32's split fragments spill
  static constexpr int kSplitD = sizeof(T) == 4 && D == 128 ? 2 : 1;
  static constexpr int kBq = 64;                       // dq: queries a CTA
  static constexpr int kBkQ = kNarrow ? 32 : 64;       // dq: key tile
  static constexpr int kTile = kLd * (int)sizeof(T);   // bytes a row
  // dkdv: K | V | Q[2] | dO[2] | lse[2] | D[2]
  static constexpr int kSmemKV = 2 * kBk * kTile + 4 * kBqKV * kTile +
                                 4 * kBqKV * 4;
  // dq: Q | dO | K[2] | V[2] | lse | D
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// two bf16 as one register, lo in the low half
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a b, m16n8k16, bf16 inputs, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kRows rows of d elements from row row0 of a [rows, d] view (row stride
// ld elements) into a padded tile; rows at or past n_rows zeros
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t ld,
                                          int row0, int n_rows) {
  constexpr int kVec = 16 / (int)sizeof(T), kChunks = D / kVec;
  constexpr int kLd = Cfg<T, D>::kLd;
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * kVec;
    const bool in = row0 + r < n_rows;
    cp_async16(smem_addr(dst + r * kLd + c),
               in ? src + (int64_t)(row0 + r) * ld + c : src, in ? 16 : 0);
  }
}

// a tile's lse (in log2 units; +inf past sq, so P is 0 there) and D
__device__ __forceinline__ void load_rows(float* ls, float* ds,
                                          const float* lse,
                                          const float* dsum, int row0,
                                          int n_rows, int sq) {
  for (int r = threadIdx.x; r < n_rows; r += kThreads) {
    const bool in = row0 + r < sq;
    ls[r] = in ? lse[row0 + r] * kLog2e : INFINITY;
    ds[r] = in ? dsum[row0 + r] : 0.f;
  }
}

// C[16 x 8 NT] += X[16 x kDepth] Y[8 NT x kDepth]^T, X and Y padded tiles
// in shared memory (rows of kLd elements) with the contraction dimension
// contiguous in both; X and Y point at their first rows.  Accumulator
// fragments (g = lane / 4, t = lane % 4): c[nt] = C[g][8 nt + 2t, + 1],
// C[g + 8][8 nt + 2t, + 1].
template <typename T, int kLd, int kDepth, int NT>
__device__ __forceinline__ void mma_nt(float (&c)[NT][4], const T* X,
                                       const T* Y, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk) {
      const T* x0 = X + g * kLd + 16 * kk + 2 * t;
      const uint32_t a[4] = {ld32(x0), ld32(x0 + 8 * kLd), ld32(x0 + 8),
                             ld32(x0 + 8 * kLd + 8)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const T* y0 = Y + (8 * nt + g) * kLd + 16 * kk + 2 * t;
        mma_bf16(c[nt], a, ld32(y0), ld32(y0 + 8));
      }
    }
  } else {
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
}

// O[16 x 8 ND] += P[16 x 8 NK] Y[8 NK x 8 ND]: P in accumulator fragments
// (mma_nt's layout), Y a padded tile in shared memory ([k][n], rows of kLd
// elements).  Each 8 columns of O take the sum over P's columns in a
// fresh accumulator, added to O in fp32.  bf16: P's accumulators of n-
// tiles 2 kk and 2 kk + 1 are the A fragment of k16 step kk, rounded to
// bf16.  fp32: the accumulator of n-tile kk is the A fragment of k8 step
// kk with column t holding k = 2t and t + 4 holding 2t + 1, so B reads
// Y's rows 2t and 2t + 1 where the fragment names t and t + 4.
template <typename T, int kLd, int NK, int ND>
__device__ __forceinline__ void mma_pn(float (&o)[ND][4],
                                       const float (&p)[NK][4], const T* Y,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
        const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                               pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                               pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                               pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
        const T* y0 = Y + (16 * kk + 2 * t) * kLd + 8 * nd + g;
        mma_bf16(acc, a, pack2(y0[0], y0[kLd]),
                 pack2(y0[8 * kLd], y0[9 * kLd]));
      }
    } else {
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
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] += acc[e];
  }
}

// two neighbouring outputs of a row, in the tensor's dtype
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// rows [r, r + 8) x 8 ND of O (fragments as mma_nt's), scaled, into rows
// row0 + g and row0 + g + 8 of a [rows, d] view; rows at or past n_rows
// are not written
template <typename T, int ND>
__device__ __forceinline__ void store_rows(T* dst, int64_t ld, int row0,
                                           int n_rows, const float (&o)[ND][4],
                                           float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int c = 8 * nd + 2 * t;
    if (row0 + g < n_rows)
      store2(dst + (int64_t)(row0 + g) * ld + c, o[nd][0] * scale,
             o[nd][1] * scale);
    if (row0 + g + 8 < n_rows)
      store2(dst + (int64_t)(row0 + g + 8) * ld + c, o[nd][2] * scale,
             o[nd][3] * scale);
  }
}

// ---- pass 1: D = rowsum(do o), one warp a row ---- //
template <typename T, int D>
__global__ void __launch_bounds__(256) dsum_kernel(const Params p) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)p.B * p.H * p.sq) return;
  const int i = (int)(row % p.sq);
  const int64_t bh = row / p.sq;
  const int h = (int)(bh % p.H), bi = (int)(bh / p.H);
  const T* o = static_cast<const T*>(p.o) + bi * p.st[kO][0] +
               h * p.st[kO][1] + i * p.st[kO][2];
  const T* d = static_cast<const T*>(p.dout) + bi * p.st[kDo][0] +
               h * p.st[kDo][1] + i * p.st[kDo][2];
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc += to_f(o[c]) * to_f(d[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.dsum[row] = acc;
}

// ---- pass 2: dK and dV, a CTA a key tile of one (b, KV head) ---- //
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Params p) {
  using C = Cfg<T, D>;
  constexpr int kBk = C::kBk, kBq = C::kBqKV, kLd = C::kLd;
  constexpr int NQ = kBq / 8, ND = D / 8 / C::kSplitD;
  const int c0 = (int)blockIdx.y * (D / C::kSplitD);   // first column
  extern __shared__ __align__(16) uint8_t smem_kv[];
  T* ks = reinterpret_cast<T*>(smem_kv);
  T* vs = ks + kBk * kLd;
  T* qs = vs + kBk * kLd;                       // two stages
  T* dos = qs + 2 * kBq * kLd;                  // two stages
  float* ls = reinterpret_cast<float*>(dos + 2 * kBq * kLd);
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

  const T* qg = static_cast<const T*>(p.q) + bi * p.st[kQ][0];
  const T* dog = static_cast<const T*>(p.dout) + bi * p.st[kDo][0];
  const int64_t rows_bh = (int64_t)bi * p.H;
  load_tile<T, D, kBk>(ks, static_cast<const T*>(p.k) + bi * p.st[kK][0] +
                               hk * p.st[kK][1], p.st[kK][2], j0, p.sk);
  load_tile<T, D, kBk>(vs, static_cast<const T*>(p.v) + bi * p.st[kV][0] +
                               hk * p.st[kV][1], p.st[kV][2], j0, p.sk);
  // tile it: head hk group + it / per_head, query tile qt0 + it % per_head
  auto issue = [&](int it) {
    const int h = hk * group + it / per_head;
    const int i0 = (qt0 + it % per_head) * kBq, s = it & 1;
    load_tile<T, D, kBq>(qs + s * kBq * kLd, qg + h * p.st[kQ][1],
                         p.st[kQ][2], i0, p.sq);
    load_tile<T, D, kBq>(dos + s * kBq * kLd, dog + h * p.st[kDo][1],
                         p.st[kDo][2], i0, p.sq);
    load_rows(ls + s * kBq, dd + s * kBq, p.lse + (rows_bh + h) * p.sq,
              p.dsum + (rows_bh + h) * p.sq, i0, kBq, p.sq);
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
    const T* qt = qs + s * kBq * kLd;
    const T* dot = dos + s * kBq * kLd;
    const float* lt = ls + s * kBq;
    const float* dt = dd + s * kBq;
    float sc[NQ][4], dp[NQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
    mma_nt<T, kLd, D, NQ>(sc, ks + 16 * warp * kLd, qt, lane);  // S^T
    mma_nt<T, kLd, D, NQ>(dp, vs + 16 * warp * kLd, dot, lane); // dP^T
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
    mma_pn<T, kLd, NQ, ND>(dv, sc, dot + c0, lane);  // dV += P^T dO
    mma_pn<T, kLd, NQ, ND>(dk, dp, qt + c0, lane);   // dK += dS^T Q
    __syncthreads();                            // the stage is free
  }
  const int r0 = j0 + 16 * warp;
  store_rows<T, ND>(static_cast<T*>(p.dk) + bi * p.st[kDk][0] +
                        hk * p.st[kDk][1] + c0, p.st[kDk][2], r0, p.sk, dk,
                    p.scale, lane);
  store_rows<T, ND>(static_cast<T*>(p.dv) + bi * p.st[kDv][0] +
                        hk * p.st[kDv][1] + c0, p.st[kDv][2], r0, p.sk, dv,
                    1.f, lane);
}

// ---- pass 3: dQ, a CTA a query tile of one (b, h) ---- //
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Params p) {
  using C = Cfg<T, D>;
  constexpr int kBq = C::kBq, kBk = C::kBkQ, kLd = C::kLd;
  constexpr int NK = kBk / 8, ND = D / 8;
  extern __shared__ __align__(16) uint8_t smem_q[];
  T* qs = reinterpret_cast<T*>(smem_q);
  T* dos = qs + kBq * kLd;
  T* ks = dos + kBq * kLd;                      // two stages
  T* vs = ks + 2 * kBk * kLd;                   // two stages
  float* ls = reinterpret_cast<float*>(vs + 2 * kBk * kLd);
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

  load_tile<T, D, kBq>(qs, static_cast<const T*>(p.q) + bi * p.st[kQ][0] +
                               h * p.st[kQ][1], p.st[kQ][2], i0, p.sq);
  load_tile<T, D, kBq>(dos, static_cast<const T*>(p.dout) +
                                bi * p.st[kDo][0] + h * p.st[kDo][1],
                       p.st[kDo][2], i0, p.sq);
  load_rows(ls, dd, p.lse + ((int64_t)bi * p.H + h) * p.sq,
            p.dsum + ((int64_t)bi * p.H + h) * p.sq, i0, kBq, p.sq);
  const T* kg = static_cast<const T*>(p.k) + bi * p.st[kK][0] +
                hk * p.st[kK][1];
  const T* vg = static_cast<const T*>(p.v) + bi * p.st[kV][0] +
                hk * p.st[kV][1];
  auto issue = [&](int it) {
    const int s = it & 1;
    load_tile<T, D, kBk>(ks + s * kBk * kLd, kg, p.st[kK][2], it * kBk,
                         p.sk);
    load_tile<T, D, kBk>(vs + s * kBk * kLd, vg, p.st[kV][2], it * kBk,
                         p.sk);
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
    const T* kt = ks + s * kBk * kLd;
    const T* vt = vs + s * kBk * kLd;
    float sc[NK][4], dp[NK][4];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
    mma_nt<T, kLd, D, NK>(sc, qs + 16 * warp * kLd, kt, lane);   // S
    mma_nt<T, kLd, D, NK>(dp, dos + 16 * warp * kLd, vt, lane);  // dP
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
    mma_pn<T, kLd, NK, ND>(dq, dp, kt, lane);   // dQ += dS K
    __syncthreads();                            // the stage is free
  }
  store_rows<T, ND>(static_cast<T*>(p.dq) + bi * p.st[kDq][0] +
                        h * p.st[kDq][1], p.st[kDq][2], i0 + 16 * warp,
                    p.sq, dq, p.scale, lane);
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<T, D>;
  const int64_t rows = (int64_t)p.B * p.H * p.sq;
  if (rows > 0)
    dsum_kernel<T, D><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t kv_blocks = (int64_t)p.B * p.Hkv *
                            ((p.sk + C::kBk - 1) / C::kBk);
  if (kv_blocks > 0) {
    err = cudaFuncSetAttribute(dkdv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmemKV);
    if (err != cudaSuccess) return (int)err;
    dkdv_kernel<T, D><<<dim3((unsigned)kv_blocks, C::kSplitD), kThreads,
                        C::kSmemKV, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t q_blocks = (int64_t)p.B * p.H *
                           ((p.sq + C::kBq - 1) / C::kBq);
  if (q_blocks > 0) {
    err = cudaFuncSetAttribute(dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmemQ);
    if (err != cudaSuccess) return (int)err;
    dq_kernel<T, D><<<(unsigned)q_blocks, kThreads, C::kSmemQ, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int by_head_dim(int d, const Params& p, cudaStream_t s) {
  if (d == 32) return launch<T, 32>(p, s);
  if (d == 64) return launch<T, 64>(p, s);
  if (d == 128) return launch<T, 128>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, do, dq, dk, dv).  lse: the
// forward's contiguous fp32 [B, H, sq]; dsum: a contiguous fp32 [B, H, sq]
// scratch.  strides: 24 int64, the batch, head and sequence strides of q,
// k, v, o, do, dq, dk and dv, in elements, each a multiple of 16 bytes, as
// the bases are.
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
  p.dsum = static_cast<float*>(dsum);
  for (int tsr = 0; tsr < kTensors; ++tsr)
    for (int a = 0; a < 3; ++a) p.st[tsr][a] = strides[3 * tsr + a];
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return by_head_dim<__nv_bfloat16>(d, p, s);
  return by_head_dim<float>(d, p, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
