// flash_attention: softmax attention with GQA in one pass over the keys,
// with an online-softmax carry.  For each (batch b, head h, query i):
//
//   s[j] = (q[b, h, i] . k[b, h / group, j]) / sqrt(d)   j < sk, and j <= i
//                                                        when causal
//   o[b, h, i] = sum_j softmax(s)[j] v[b, h / group, j]
//
// q: [B, H, sq, d]; k, v: [B, Hkv, sk, d]; o: [B, H, sq, d], in q's dtype
// (bf16 or fp32; k and v the same), d in {32, 64, 128}.  Any strides with
// the last dimension contiguous: the wrapper passes the batch, head and
// sequence strides, so the model's [b, s, h, d] projections are read and
// written in place.  The carry (m, l, acc) is fp32.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// _attn_kernel (pl.pallas_call at flash_attention.py:113, grid
// (b, h, nq, nk)).
//
// Bound: operations.  At the Qwen2-7B prefill shape (q [4, 28, 2048, 128],
// k, v [4, 4, 2048, 128], bf16, causal) QK^T and PV over the causal half
// are about 120 GFLOP: 0.12 ms at the bf16 tensor-core peak (989 TFLOP/s),
// against 134 MB read and written once (0.04 ms).
//
// bf16: a warp-specialised Hopper kernel (namespace hopper).
//  * Tensor cores for both products.  A work item is 128 queries of one
//    (b, h) and the 128-key tiles they need.  Warpgroup 0 is the
//    producer; warpgroups 1 and 2 are consumers of 64 query rows each.
//    S = Q K^T is wgmma m64n128k16 with Q and K read from shared memory
//    through descriptors (both K-major); O += P V is wgmma m64n{d}k16 with
//    P as the register A operand and V read MN-major (d contiguous).  The
//    fp32 accumulator fragment of S is the layout of wgmma's A fragment,
//    so P goes to bf16 in place, two columns to a register, and never
//    touches shared memory.  P = exp(s - m) in (0, 1] is rounded to bf16
//    for the product, as the reference model's attention rounds its
//    softmax weights (models/layers.py:153); l sums the unrounded fp32
//    weights and the division by l stays at the end, in fp32.
//  * The softmax overlaps the tensor cores: a consumer starts S of tile t
//    and PV of tile t - 1 together, waits for S only, and runs the
//    softmax of tile t while PV runs (FlashAttention-3's intra-warpgroup
//    pipelining); the two consumers interleave on the SM besides.
//  * TMA for the tiles.  One thread of the producer loads an item's Q,
//    then K and V tiles into a ring of 2 stages with a full and an empty
//    mbarrier per stage and operand (consumers release K after S, V after
//    PV, Q after the item's last S).  The tensor maps describe the
//    strided [b, h, s, d] views directly (dims d, s, h, b; byte strides
//    from the tensor), with the 128-byte swizzle wgmma expects (64-byte at
//    d = 32): a box is one swizzle span of 64 columns, so a tile at
//    d = 128 is two boxes.  The maps are encoded on the host with
//    cuTensorMapEncodeTiled, reached through the runtime's
//    cudaGetDriverEntryPoint (no link against libcuda), and passed as
//    __grid_constant__ parameters.
//  * Persistent: one CTA per SM walks its items, the ring running on
//    across them, so the next item's Q and first tiles load during this
//    item's last PV and output stores.  CTA c of G takes items c,
//    2G - 1 - c, 2G + c, ...: a snake over the items in launch order,
//    which evens out the causal blocks' unequal work.
//  * Registers: the producer gives its registers back (setmaxnreg 40)
//    and the consumers take them (232): S and O are 64 fp32 registers
//    each at d = 128, P 32 more.
//  * Shared memory: Q, two K and two V tiles of 128 x d bf16: 160 KB at
//    d = 128, one CTA per SM.
//
// fp32 (namespace wg32): 3xTF32 on the tensor cores (tf32.cuh), bound by
// three passes at the TF32 peak (495 TFLOP/s): 0.73 ms at the Qwen2-7B
// prefill shape and 0.17 ms at Whisper's encoder (4, 12, 12, 1500, 1500,
// 64), where the fp32 CUDA cores (67 TFLOP/s) would need 1.80 and 0.41.
//  * wgmma, not mma.sync: a FlashAttention-2-style mma.sync kernel, its
//    splits in registers, was right but slower on an H100 (0.58 ms at
//    Whisper's encoder where this one takes 0.48; bench/ssd_ab.py,
//    PERF.md).  A CTA is two warpgroups of 64
//    queries; it walks the key tiles (64 keys; 32 at d 128), and each
//    product takes al bh + ah bl + ah bh a k8 step on one fp32
//    accumulator.  The carry (m, l, O) stays fp32, and P in (0, 1] is
//    split like any operand, not rounded to bf16.
//  * A tile's P V goes to a fresh accumulator, which a rounding FMA adds
//    to O (O = alpha O + P V).  The tensor cores truncate as they
//    accumulate; with O itself as the accumulator that bias compounded
//    over every key tile, to 4.6e-5 (twice the limit) on Whisper's
//    cross-attention over 1500 frames, whose values share a mean.
//  * TF32 wgmma reads only K-major operands from shared memory.  K and V
//    land as they lie (16-byte cp.async into raw tiles, zero fill past
//    sk) and the CTA splits each tile once into hi and lo planes under
//    the 128-byte swizzle: K as it lies, V transposed to V^T [d][key].
//    Q is split once, into registers as the A fragments of S = Q K^T
//    where they fit (hi and lo at d 32, hi at d 64) and into planes
//    otherwise (lo at d 64, both at d 128).
//  * P feeds PV from registers: the accumulator of S's 8 columns j is the
//    A fragment of key step j with its columns permuted (it holds keys
//    2t, 2t + 1 where the fragment wants t, t + 4), so the V^T planes
//    store each 8 keys in that order (0, 2, 4, 6, 1, 3, 5, 7; a sum over
//    keys does not depend on their order) and P is never shuffled.
//  * The next tile's raw K and V load during this tile's products.
//    Shared memory: 131 KB at d 64, 226 KB at d 128 (with Q's planes);
//    one CTA an SM.  Splitting a tile during the other product's wgmma
//    or one warpgroup a CTA (two CTAs an SM) were no faster.
//
// How both replace the TPU kernel's assumptions:
//  * a serial grid whose innermost dimension walks the KV blocks while the
//    carry waits in VMEM scratch: here a CTA (an item, in bf16) loops
//    over the key tiles itself, the carry in registers.  The threads that
//    own a row's scores own its outputs, so rescaling by alpha needs no
//    exchange; the row max is a shuffle among the 4 threads of a row, and
//    l is summed per thread and reduced once at the end.
//  * every KV block visited, masked ones included: with the causal mask a
//    CTA (an item) stops at the tile that holds its last query.  Skipping
//    the tiles above the diagonal is exact: there the TPU kernel adds
//    p = exp(-1e30 - m) = 0 and rescales by exp(0) = 1, since every row
//    has met key 0 in the first tile.  Both kernels mask only the tiles
//    that cross the diagonal or the ragged tail, and an fp32 warpgroup
//    skips the tiles above its own rows.
//  * BlockSpec padding of the ragged KV tail: TMA's out-of-bounds fill
//    loads keys at or past sk (and queries at or past sq) as zeros in the
//    bf16 kernel, cp.async's zero fill (and zeroed Q rows) in the fp32
//    one; the scores of those keys are masked to -inf (-1e30 in fp32).
//  * an index map that folds head h onto KV head h / group: a CTA reads
//    its KV head's rows directly; nothing is repeated.
//  * blocks sized for VMEM: tiles sized for 227 KB of shared memory and
//    the register file, as above.
//  * a grid in order: CTAs are independent.  Work is numbered with (b, h)
//    fastest, so the query heads of one KV head run side by side and read
//    its tiles from L2; under the causal mask the query blocks with the
//    most tiles are numbered first (the fp32 kernel's CTAs, the bf16
//    kernel's items).
#include <cuda.h>            // CUtensorMap and its enums; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <type_traits>

#include "tf32.cuh"

namespace {

struct Strides {                    // elements; the last dimension is 1
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// --------------------------------------------------------------------- //
// fp32: 3xTF32 on the tensor cores (wgmma)
// --------------------------------------------------------------------- //
namespace wg32 {

constexpr int kThreads = 256;       // two warpgroups
constexpr int kBq = 128;            // queries a CTA, 64 a warpgroup
constexpr float kNegInf = -1e30f;   // the reference's mask value

// Q's hi and lo parts are wgmma A fragments in registers at d 32; at d 64
// hi stays in registers and lo in a shared-memory plane, read by wgmma, and
// at d 128 both are planes (registers would spill beside O and the tile's
// PV accumulator).
template <int D>
struct Cfg {
  static constexpr int kBk = D == 128 ? 32 : 64;      // keys a tile
  static constexpr bool kHiRegs = D <= 64, kLoRegs = D <= 32;
  static constexpr int kLd = D + 4;                   // floats a raw row
  // TF32 planes, K-major in boxes of 32 columns (128-byte rows) under the
  // 128-byte swizzle: box b of a plane of R rows starts at b R 128 bytes
  static constexpr int kQPlane = kBq * D * 4;         // Q hi or lo
  static constexpr int kKPlane = kBk * D * 4;         // K or V^T hi or lo
  static constexpr int kRaw = kBk * kLd * 4;          // a raw K or V tile
  // bytes from a 1024-aligned base: Q hi | Q lo (each where not in
  // registers) | K hi | K lo | V^T hi | V^T lo | raw K | raw V
  static constexpr int kQh = 0, kQl = kQh + (kHiRegs ? 0 : kQPlane);
  static constexpr int kKh = kQl + (kLoRegs ? 0 : kQPlane);
  static constexpr int kKl = kKh + kKPlane;
  static constexpr int kVh = kKl + kKPlane, kVl = kVh + kKPlane;
  static constexpr int kRawK = kVl + kKPlane, kRawV = kRawK + kRaw;
  static constexpr int kSmem = kRawV + kRaw + 1024;   // + alignment slack
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// byte offset of the 16-byte chunk at (row r, column c, c % 4 = 0) of a
// TF32 plane of R rows
template <int R>
__device__ __forceinline__ int plane_off(int r, int c) {
  return (c >> 5) * R * 128 + tf32::swz<128>(r, (c & 31) >> 2);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o, int B,
            int H, int Hkv, int sq, int sk, int causal, float scale_log2,
            Strides st) {
  using C = Cfg<D>;
  constexpr int kBk = C::kBk, kLd = C::kLd, kVec = D / 4;
  extern __shared__ uint8_t smem_wg[];
  uint8_t* sm = smem_wg + ((1024 - (smem_addr(smem_wg) & 1023)) & 1023);
  const uint32_t sb = smem_addr(sm);
  float* raw_k = reinterpret_cast<float*>(sm + C::kRawK);
  float* raw_v = reinterpret_cast<float*>(sm + C::kRawV);

  const int nq = (sq + kBq - 1) / kBq;
  const int bh = (int)(blockIdx.x % (unsigned)(B * H));
  const int qb = causal ? nq - 1 - (int)(blockIdx.x / (unsigned)(B * H))
                        : (int)(blockIdx.x / (unsigned)(B * H));
  const int bi = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qb * kBq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, g = lane / 4, t = lane % 4;

  const float* qg = q + bi * st.qb + h * st.qh;
  const float* kg = k + bi * st.kb + hk * st.kh;
  const float* vg = v + bi * st.vb + hk * st.vh;

  // kBk rows of K or V from key j0 as they lie; keys at or past sk zeros
  auto load_raw = [&](float* dst, const float* src, int64_t ld, int j0) {
    for (int idx = tid; idx < kBk * kVec; idx += kThreads) {
      const int r = idx / kVec, c = (idx % kVec) * 4;
      const bool in = j0 + r < sk;
      cp_async16(smem_addr(dst + r * kLd + c),
                 in ? src + (int64_t)(j0 + r) * ld + c : src, in ? 16 : 0);
    }
  };

  // keys this block needs: all of them, or up to its last query
  const int kv_end = causal ? min(sk, min(q0 + kBq, sq)) : sk;
  const int n_tiles = (kv_end + kBk - 1) / kBk;
  if (n_tiles > 0) {
    load_raw(raw_k, kg, st.ks, 0);
    load_raw(raw_v, vg, st.vs, 0);
  }
  cp_async_commit();

  const int wq0 = q0 + 64 * wg;              // the warpgroup's first query
  const int r0 = wq0 + 16 * (warp % 4) + g, r1 = r0 + 8;   // the thread's
  const int lim0 = causal ? min(sk, r0 + 1) : sk;  // a row sees keys < lim
  const int lim1 = causal ? min(sk, r1 + 1) : sk;
  // Q split into TF32 hi and lo, as the A fragments of the warp's 16 rows
  // (k8 step kk: rows r0, r1 at columns 8 kk + t, then 8 kk + t + 4);
  // rows at or past sq zeros
  uint32_t qh[C::kHiRegs ? D / 8 : 1][4], ql[C::kLoRegs ? D / 8 : 1][4];
  if constexpr (C::kHiRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e & 1 ? r1 : r0, c = 8 * kk + t + (e & 2) * 2;
        const float x = r < sq ? qg[(int64_t)r * st.qs + c] : 0.f;
        uint32_t lo;
        tf32::split(x, qh[kk][e], lo);
        if constexpr (C::kLoRegs) ql[kk][e] = lo;
      }
  }
  if constexpr (!C::kLoRegs) {
    // Q's lo part, and its hi part where not in registers, as TF32 planes
    for (int idx = tid; idx < kBq * kVec; idx += kThreads) {
      const int r = idx / kVec, c = (idx % kVec) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < sq)
        x = *reinterpret_cast<const float4*>(qg + (int64_t)(q0 + r) * st.qs +
                                             c);
      const int off = plane_off<kBq>(r, c);
      if constexpr (C::kHiRegs) {
        uint32_t hi, lo[4];
        tf32::split(x.x, hi, lo[0]);
        tf32::split(x.y, hi, lo[1]);
        tf32::split(x.z, hi, lo[2]);
        tf32::split(x.w, hi, lo[3]);
        *reinterpret_cast<uint4*>(sm + C::kQl + off) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      } else {
        tf32::split4<true>(x, sm + C::kQh + off, sm + C::kQl + off);
      }
    }
  }
  float acc[D / 2];                          // O, in wgmma's layout
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // log2 units

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = it * kBk;
    cp_async_wait_all();
    __syncthreads();               // raw tile in; the last tile's products
                                   // have read the planes
    // split into TF32 planes: K as it lies; V transposed to V^T [d][key],
    // each 8 keys' order permuted (positions 0-3 keys 0, 2, 4, 6, then
    // 1, 3, 5, 7) to match P's fragments below
    for (int idx = tid; idx < kBk * kVec; idx += kThreads) {
      const int r = idx / kVec, c = (idx % kVec) * 4;
      const int off = plane_off<kBk>(r, c);
      tf32::split4<true>(*reinterpret_cast<const float4*>(raw_k + r * kLd + c),
                         sm + C::kKh + off, sm + C::kKl + off);
    }
    for (int idx = tid; idx < D * (kBk / 4); idx += kThreads) {
      const int d = idx % D, qc = idx / D;   // chunk qc of V^T's row d
      const float* vc = raw_v + (8 * (qc >> 1) + (qc & 1)) * kLd + d;
      const int off = plane_off<D>(d, 4 * qc);
      tf32::split4<true>(make_float4(vc[0], vc[2 * kLd], vc[4 * kLd],
                                     vc[6 * kLd]),
                         sm + C::kVh + off, sm + C::kVl + off);
    }
    tf32::fence_async_smem();
    __syncthreads();               // planes written; the raw tiles read
    if (it + 1 < n_tiles) {
      load_raw(raw_k, kg, st.ks, j0 + kBk);
      load_raw(raw_v, vg, st.vs, j0 + kBk);
    }
    cp_async_commit();
    // a warpgroup skips a tile with no query of its own in range, or
    // whose keys all lie above its rows (exact: there p = 0, alpha = 1)
    if (wq0 >= sq || (causal && j0 > wq0 + 63)) continue;

    // S = Q K^T, 64 x kBk a warpgroup: al bh + ah bl + ah bh a k8 step
    float sc[kBk / 2];
    tf32::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t ko = (kk >> 2) * kBk * 128 + (kk & 3) * 32;
      const uint32_t qo = (kk >> 2) * kBq * 128 + wg * 64 * 128 +
                          (kk & 3) * 32;
      const uint64_t bh = tf32::kmajor_desc<128>(sb + C::kKh + ko);
      const uint64_t bl = tf32::kmajor_desc<128>(sb + C::kKl + ko);
      if constexpr (C::kLoRegs)
        tf32::wgmma_tf32_rs(sc, ql[kk], bh, kk > 0);
      else
        tf32::wgmma_tf32(sc, tf32::kmajor_desc<128>(sb + C::kQl + qo), bh,
                         kk > 0);
      if constexpr (C::kHiRegs) {
        tf32::wgmma_tf32_rs(sc, qh[kk], bl, 1);
        tf32::wgmma_tf32_rs(sc, qh[kk], bh, 1);
      } else {
        const uint64_t ah = tf32::kmajor_desc<128>(sb + C::kQh + qo);
        tf32::wgmma_tf32(sc, ah, bl, 1);
        tf32::wgmma_tf32(sc, ah, bh, 1);
      }
    }
    tf32::wgmma_commit();
    tf32::wgmma_wait<0>();
    tf32::reg_fence(sc);

    // online softmax: sc[4j + e] is row r0 (e < 2) or r1, key j0 + 8j +
    // 2t + e % 2; a row's 4 threads are lanes 4g .. 4g + 3
    const bool edge = j0 + kBk > sk || (causal && j0 + kBk - 1 > wq0);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < kBk / 2; ++i) {
      const int e = i & 3;
      float x = sc[i] * scale_log2;
      if (edge && j0 + 8 * (i >> 2) + 2 * t + (e & 1) >= (e < 2 ? lim0 : lim1))
        x = kNegInf;
      sc[i] = x;
      if (e < 2) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < kBk / 2; ++i) {
      sc[i] = ex2(sc[i] - ((i & 3) < 2 ? mn0 : mn1));
      if ((i & 3) < 2) sum0 += sc[i];
      else sum1 += sc[i];
    }
    l0 = l0 * a0 + sum0;                     // summed per thread
    l1 = l1 * a1 + sum1;

    // O = alpha O + P V, P V in a fresh accumulator a tile (the tensor
    // cores' accumulation truncates: chained over every key tile its bias
    // grew with sk; a tile's sum is added to O by a rounding FMA).  The
    // accumulator of S's 8 columns j is the A fragment of key step j with
    // its columns permuted (column t is key 2t, t + 4 is key 2t + 1), the
    // order V^T's planes hold
    uint32_t ph[kBk / 8][4], pl[kBk / 8][4];
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
      tf32::split(sc[4 * j], ph[j][0], pl[j][0]);
      tf32::split(sc[4 * j + 2], ph[j][1], pl[j][1]);
      tf32::split(sc[4 * j + 1], ph[j][2], pl[j][2]);
      tf32::split(sc[4 * j + 3], ph[j][3], pl[j][3]);
    }
    float pv[D / 2];
    tf32::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
      const uint32_t vo = (j >> 2) * D * 128 + (j & 3) * 32;
      const uint64_t bh = tf32::kmajor_desc<128>(sb + C::kVh + vo);
      tf32::wgmma_tf32_rs(pv, pl[j], bh, j > 0);
      tf32::wgmma_tf32_rs(pv, ph[j], tf32::kmajor_desc<128>(sb + C::kVl + vo),
                          1);
      tf32::wgmma_tf32_rs(pv, ph[j], bh, 1);
    }
    tf32::wgmma_commit();
    tf32::wgmma_wait<0>();
    tf32::reg_fence(pv);
    tf32::reg_fence(ph);
    tf32::reg_fence(pl);
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      acc[i] = fmaf(acc[i], (i & 3) < 2 ? a0 : a1, pv[i]);
  }

  // a row's l is spread over its 4 threads; a row with no key gives 0
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
  float* og = o + bi * st.ob + h * st.oh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (r0 < sq)
      *reinterpret_cast<float2*>(og + (int64_t)r0 * st.os + c) =
          make_float2(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (r1 < sq)
      *reinterpret_cast<float2*>(og + (int64_t)r1 * st.os + c) =
          make_float2(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int sq, int sk, int causal, float scale,
           const Strides& st, cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)B * H * ((sq + kBq - 1) / kBq);
  attn_kernel<D><<<(unsigned)blocks, kThreads, C::kSmem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, B, H,
      Hkv, sq, sk, causal, scale * 1.4426950408889634f, st);
  return (int)cudaGetLastError();
}

}  // namespace wg32

// --------------------------------------------------------------------- //
// bf16: wgmma fed by TMA, warp-specialised
// --------------------------------------------------------------------- //
namespace hopper {

constexpr int kThreads = 384;       // warpgroup 0 produces, 1 and 2 consume
constexpr int kBq = 128;            // queries per CTA: 64 per consumer
constexpr int kBk = 128;            // keys per tile
constexpr int kStages = 2;          // K and V ring depth
constexpr int kConsumers = 256;     // arrivals that release a stage
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kBq == kBk, "Q, K and V tiles share one TMA box shape");
static_assert(kProducerRegs * 128 + kConsumerRegs * 256 <= 65536,
              "setmaxnreg budget");

template <int D>
struct Tile {
  static constexpr int kBoxCols = D < 64 ? D : 64;    // one swizzle span
  static constexpr int kSwizzle = 2 * kBoxCols;       // bytes: 128 or 64
  static constexpr int kBoxes = D / kBoxCols;         // boxes across d
  static constexpr int kBoxBytes = kBk * kSwizzle;    // 128 rows of a box
  static constexpr int kBytes = kBoxes * kBoxBytes;   // 128 rows x d
  static constexpr int kKSteps = kBoxCols / 16;       // k16 steps in a box
  static constexpr uint64_t kDescLayout = kSwizzle == 128 ? 1 : 2;
  // shared memory, from a 1024-byte-aligned base: Q | K[kStages] |
  // V[kStages] | 10 mbarriers (Q full, Q empty; K full, K empty, V full,
  // V empty per stage)
  static constexpr int kK = kBytes;
  static constexpr int kV = kK + kStages * kBytes;
  static constexpr int kBar = kV + kStages * kBytes;
  static constexpr int kSmem = kBar + 128 + 1024;     // + alignment slack
};

struct Params {
  int B, H, Hkv, sq, sk, causal;
  float scale_log2;                 // 1 / sqrt(d) / ln 2: exp via ex2
  int64_t ob, oh, os;               // output strides, elements
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 4-d tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory; completion counted on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout (1: 128 B, 2: 64 B)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// at most N of the committed groups still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from touching wgmma's registers before it is done
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 32] += A[64 x 16] B[16 x 32]: A in registers, B MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A in registers, B MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A in registers, B MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// a consumer thread's two rows (r0 and r0 + 8): where they are, their
// carry (m in log2 units, l summed per thread) and their outputs
template <int D>
struct Rows {
  int wq0, r0, c2, lim0, lim1;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[D / 2] = {};
};

// S = Q K^T for one tile, 64 x 128 fp32: d / 16 steps of k16, Q and K
// K-major in shared memory
template <int D>
__device__ __forceinline__ void mma_s(float (&sc)[kBk / 2], uint32_t q,
                                        uint32_t k) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / T::kKSteps) * T::kBoxBytes +
                         (kk % T::kKSteps) * 32;
    wgmma_ss_n128(sc,
                  make_desc(q + off, 16, 8 * T::kSwizzle, T::kDescLayout),
                  make_desc(k + off, 16, 8 * T::kSwizzle, T::kDescLayout),
                  kk);
  }
}

// O += P V for one tile: kBk / 16 steps of k16 over its keys, P from
// registers, V MN-major in shared memory (boxes of 64 columns kBoxBytes
// apart)
template <int D>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[kBk / 16][4],
                                         uint32_t v) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < kBk / 16; ++kk)
    wgmma_rs<D>(acc, pa[kk],
                make_desc(v + kk * 16 * T::kSwizzle, T::kBoxBytes,
                          8 * T::kSwizzle, T::kDescLayout));
}

// the online softmax of one S tile (keys j0..): masks the tile where it
// crosses the diagonal or the ragged tail, updates the rows' m and l, and
// leaves P = 2^(s scale_log2 - m) in sc.  Returns the factors (rows r0,
// r0 + 8) that rescale the earlier outputs.  sc[4 j + e] is row r0
// (e < 2) or r0 + 8, key j0 + 8 j + c2 + e % 2; a row's 4 threads are
// lanes 4g..4g+3.
template <int D>
__device__ __forceinline__ float2 softmax_tile(float (&sc)[kBk / 2],
                                               Rows<D>& r, int j0,
                                               const Params& p) {
  if (j0 + kBk > p.sk || (p.causal && j0 + kBk - 1 > r.wq0)) {
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + 8 * j + r.c2 + (e & 1) >= (e < 2 ? r.lim0 : r.lim1))
          sc[4 * j + e] = -INFINITY;
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kBk / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(r.m0, mx0 * p.scale_log2);
  const float mn1 = fmaxf(r.m1, mx1 * p.scale_log2);
  // a row with no key yet keeps m = -inf; subtract 0 there
  const float b0 = mn0 == -INFINITY ? 0.f : mn0;
  const float b1 = mn1 == -INFINITY ? 0.f : mn1;
  const float2 alpha = make_float2(ex2(r.m0 - b0), ex2(r.m1 - b1));
  r.m0 = mn0;
  r.m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < kBk / 8; ++j) {
    sc[4 * j] = ex2(fmaf(sc[4 * j], p.scale_log2, -b0));
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], p.scale_log2, -b0));
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], p.scale_log2, -b1));
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], p.scale_log2, -b1));
    sum0 += sc[4 * j] + sc[4 * j + 1];
    sum1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  r.l0 = r.l0 * alpha.x + sum0;
  r.l1 = r.l1 * alpha.y + sum1;
  return alpha;
}

// P to bf16 wgmma A fragments, in place of the accumulator layout: key
// step kk holds 8-column groups 2 kk and 2 kk + 1 of rows r0 and r0 + 8
__device__ __forceinline__ void pack_p(const float (&sc)[kBk / 2],
                                       uint32_t (&pa)[kBk / 16][4]) {
#pragma unroll
  for (int j = 0; j < kBk / 8; ++j) {
    pa[j / 2][2 * (j % 2)] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

// one work item: 128 queries of one (b, h) and the key tiles they need
struct Work {
  int bi, h, hk, q0, n_tiles;
};

// CTA c of G takes items c, 2G - 1 - c, 2G + c, ...: a snake over rounds
// of G, so that under the causal mask every CTA gets heavy and light
// query blocks alike
__device__ __forceinline__ int item_of(int round) {
  const int g = (int)gridDim.x, c = (int)blockIdx.x;
  return round * g + ((round & 1) ? g - 1 - c : c);
}

// items are numbered with (b, h) fastest, so the query heads of one KV
// head run side by side and read its tiles from L2; under the causal
// mask the query blocks with the most tiles come first
__device__ __forceinline__ Work work_of(int w, const Params& p) {
  const int nq = (p.sq + kBq - 1) / kBq, bhs = p.B * p.H;
  const int bh = w % bhs;
  const int qb = p.causal ? nq - 1 - w / bhs : w / bhs;
  Work wk;
  wk.bi = bh / p.H;
  wk.h = bh % p.H;
  wk.hk = wk.h / (p.H / p.Hkv);
  wk.q0 = qb * kBq;
  // keys the block needs: all of them, or up to its last query
  const int kv_end = p.causal ? min(p.sk, min(wk.q0 + kBq, p.sq)) : p.sk;
  wk.n_tiles = (kv_end + kBk - 1) / kBk;
  return wk;
}

// persistent: one CTA per SM walks its work items; the ring of K and V
// stages runs on across items, and Q is reloaded once both consumers are
// done with it, so the next item's loads overlap this one's last PV and
// output stores
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_kernel(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            __nv_bfloat16* __restrict__ o, const Params p) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_tma[];
  const uint32_t base = (smem_addr(smem_tma) + 1023) & ~1023u;
  const uint32_t q_s = base, k_s = base + T::kK, v_s = base + T::kV;
  // Q full and empty; per stage s: K full, K empty, V full, V empty
  const uint32_t q_full = base + T::kBar, q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8, k_empty = k_full + 8 * kStages;
  const uint32_t v_full = k_empty + 8 * kStages;
  const uint32_t v_empty = v_full + 8 * kStages;
  const int n_items = (p.sq + kBq - 1) / kBq * p.B * p.H;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kConsumers);
      mbar_init(v_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread starts every load.  Waits on an empty barrier
    // take the opposite parity, so the first pass through is free.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;                                // tiles through the ring
      for (int round = 0; item_of(round) < n_items; ++round) {
        const Work wk = work_of(item_of(round), p);
        mbar_wait(q_empty, (round & 1) ^ 1);
        mbar_expect_tx(q_full, T::kBytes);
        for (int c = 0; c < T::kBoxes; ++c)
          tma_load(q_s + c * T::kBoxBytes, &tq, q_full, c * T::kBoxCols,
                   wk.q0, wk.h, wk.bi);
        for (int t = 0; t < wk.n_tiles; ++t, ++it) {
          const int s = it % kStages;
          const uint32_t parity = ((it / kStages) & 1) ^ 1;
          mbar_wait(k_empty + 8 * s, parity);
          mbar_expect_tx(k_full + 8 * s, T::kBytes);
          for (int c = 0; c < T::kBoxes; ++c)
            tma_load(k_s + s * T::kBytes + c * T::kBoxBytes, &tk,
                     k_full + 8 * s, c * T::kBoxCols, t * kBk, wk.hk, wk.bi);
          mbar_wait(v_empty + 8 * s, parity);
          mbar_expect_tx(v_full + 8 * s, T::kBytes);
          for (int c = 0; c < T::kBoxes; ++c)
            tma_load(v_s + s * T::kBytes + c * T::kBoxBytes, &tv,
                     v_full + 8 * s, c * T::kBoxCols, t * kBk, wk.hk, wk.bi);
        }
      }
    }
  } else {
    // consumers: 64 query rows per warpgroup.  While the softmax of tile
    // t runs, S of tile t and PV of tile t - 1 are already started: the
    // tensor cores work during the exponentials.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int ct = threadIdx.x - 128 * wg;
    const int warp = ct / 32, lane = ct % 32;
    const uint32_t q_wg = q_s + 64 * (wg - 1) * T::kSwizzle;
    int it = 0;                                  // tiles through the ring
    for (int round = 0; item_of(round) < n_items; ++round) {
      const Work wk = work_of(item_of(round), p);
      const int n = wk.n_tiles;
      Rows<D> r;
      r.wq0 = wk.q0 + 64 * (wg - 1);             // the warpgroup's first row
      r.r0 = r.wq0 + 16 * warp + lane / 4;       // this thread's rows: r0,
      r.c2 = 2 * (lane % 4);                     // r0 + 8; columns c2, c2 + 1
      // of every 8-column group of a fragment; keys < lim are seen
      r.lim0 = p.causal ? min(p.sk, r.r0 + 1) : p.sk;
      r.lim1 = p.causal ? min(p.sk, r.r0 + 9) : p.sk;
      uint32_t pa[kBk / 16][4];                  // P of the last tile, bf16
      mbar_wait(q_full, round & 1);
      if (n == 0) mbar_arrive(q_empty);

      if (n > 0) {
        const int s = it % kStages;
        float sc[kBk / 2];
        mbar_wait(k_full + 8 * s, (it / kStages) & 1);
        wgmma_fence();
        mma_s<D>(sc, q_wg, k_s + s * T::kBytes);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sc);
        mbar_arrive(k_empty + 8 * s);
        if (n == 1) mbar_arrive(q_empty);
        softmax_tile<D>(sc, r, 0, p);
        pack_p(sc, pa);
      }
      for (int t = 1; t < n; ++t) {
        const int s = (it + t) % kStages, sp = (it + t - 1) % kStages;
        float sc[kBk / 2];
        mbar_wait(k_full + 8 * s, ((it + t) / kStages) & 1);
        wgmma_fence();
        mma_s<D>(sc, q_wg, k_s + s * T::kBytes);
        wgmma_commit();
        mbar_wait(v_full + 8 * sp, ((it + t - 1) / kStages) & 1);
        mma_pv<D>(r.acc, pa, v_s + sp * T::kBytes);
        wgmma_commit();
        wgmma_wait<1>();                         // S of tile t is done
        reg_fence(sc);
        mbar_arrive(k_empty + 8 * s);
        if (t == n - 1) mbar_arrive(q_empty);
        const float2 alpha = softmax_tile<D>(sc, r, t * kBk, p);
        wgmma_wait<0>();                         // PV of tile t - 1 is done
        reg_fence(r.acc);
        reg_fence(pa);
        mbar_arrive(v_empty + 8 * sp);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          r.acc[4 * j] *= alpha.x;
          r.acc[4 * j + 1] *= alpha.x;
          r.acc[4 * j + 2] *= alpha.y;
          r.acc[4 * j + 3] *= alpha.y;
        }
        pack_p(sc, pa);
      }
      if (n > 0) {
        const int sl = (it + n - 1) % kStages;
        mbar_wait(v_full + 8 * sl, ((it + n - 1) / kStages) & 1);
        wgmma_fence();
        mma_pv<D>(r.acc, pa, v_s + sl * T::kBytes);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(r.acc);
        reg_fence(pa);
        mbar_arrive(v_empty + 8 * sl);
      }
      it += n;

      // a row's l is spread over its 4 threads; fully masked rows give 0
      float l0 = r.l0, l1 = r.l1;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
      const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
      __nv_bfloat16* og = o + wk.bi * p.ob + wk.h * p.oh;
      const int r0 = r.r0, c2 = r.c2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (r0 < p.sq)
          *reinterpret_cast<uint32_t*>(og + (int64_t)r0 * p.os + 8 * j +
                                       c2) =
              pack_bf16(r.acc[4 * j] * inv0, r.acc[4 * j + 1] * inv0);
        if (r0 + 8 < p.sq)
          *reinterpret_cast<uint32_t*>(og + (int64_t)(r0 + 8) * p.os +
                                       8 * j + c2) =
              pack_bf16(r.acc[4 * j + 2] * inv1, r.acc[4 * j + 3] * inv1);
      }
    }
  }
}

// launch errors above this are cuTensorMapEncodeTiled's CUresult + base
constexpr int kEncodeErrorBase = 20000;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled through the runtime, so the library
// needs no -lcuda
int encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr)
      return (int)cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(ptr);
  }
  *fn = cached;
  return 0;
}

// a [batch, heads, rows, d] bf16 view (strides b, h, s in elements) as a
// 4-d tensor map (d, rows, heads, batch) with boxes of box_cols x kBk
int encode(CUtensorMap* map, const void* ptr, int d, int rows, int heads,
           int batch, const int64_t* st, int box_cols,
           CUtensorMapSwizzle swizzle) {
  EncodeTiled fn;
  const int err = encoder(&fn);
  if (err != 0) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)kBk, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // zeros
  return r == CUDA_SUCCESS ? 0 : kEncodeErrorBase + (int)r;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int sq, int sk, int causal, float scale,
           const int64_t* st, cudaStream_t stream) {
  using T = Tile<D>;
  const CUtensorMapSwizzle swizzle = T::kSwizzle == 128
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  // with no keys nothing loads K or V: their maps describe q instead
  const bool no_keys = sk == 0;
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, D, sq, H, B, st, T::kBoxCols, swizzle);
  if (err == 0)
    err = encode(&tk, no_keys ? q : k, D, no_keys ? sq : sk,
                 no_keys ? H : Hkv, B, no_keys ? st : st + 3, T::kBoxCols,
                 swizzle);
  if (err == 0)
    err = encode(&tv, no_keys ? q : v, D, no_keys ? sq : sk,
                 no_keys ? H : Hkv, B, no_keys ? st : st + 6, T::kBoxCols,
                 swizzle);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      attn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (e != cudaSuccess) return (int)e;
  const Params p{B, H, Hkv, sq, sk, causal,
                 scale * 1.4426950408889634f, st[9], st[10], st[11]};
  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int64_t items = (int64_t)B * H * ((sq + kBq - 1) / kBq);
  const int blocks = (int)(items < sms ? items : sms);
  attn_kernel<D><<<blocks, kThreads, T::kSmem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, p);
  return (int)cudaGetLastError();
}

}  // namespace hopper

template <typename Fn>
int by_head_dim(int d, Fn&& fn) {
  if (d == 32) return fn(std::integral_constant<int, 32>{});
  if (d == 64) return fn(std::integral_constant<int, 64>{});
  if (d == 128) return fn(std::integral_constant<int, 128>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o).  strides: 12 int64,
// the batch, head and sequence strides of q, k, v and o, in elements.
// bf16 needs 16-byte-aligned bases and strides (TMA); the wrapper copies
// a view that has neither.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int Hkv, int sq, int sk, int d,
                                     int causal, float scale, int dtype,
                                     const int64_t* strides, void* stream) {
  if ((int64_t)B * H * sq == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return by_head_dim(d, [&](auto D) {
      return hopper::launch<decltype(D)::value>(q, k, v, o, B, H, Hkv, sq,
                                                sk, causal, scale, strides,
                                                s);
    });
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  return by_head_dim(d, [&](auto D) {
    return wg32::launch<decltype(D)::value>(q, k, v, o, B, H, Hkv, sq, sk,
                                            causal, scale, st, s);
  });
}

extern "C" const char* repro_error_string(int code) {
  static char buf[96];
  if (code >= hopper::kEncodeErrorBase) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed with CUresult "
             "%d", code - hopper::kEncodeErrorBase);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)code);
}
