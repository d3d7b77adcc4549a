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
// 30% tile density, 1,229 tiles; B 8192 x 1024) the tiles need 41.2 GFLOP
// against 148 MB read and written once (0.044 ms).  On tensor cores:
//
//  * fp32 operands: 3xTF32.  Each fp32 x is split into hi = tf32(x) and
//    lo = tf32(x - hi), both rounded to nearest with ties away (as
//    cvt.rna rounds; the truncation the hardware applies to a plain fp32
//    word would cost a bit of hi and leave lo wrong), and
//    a b = al bh + ah bl + ah bh, small terms
//    first, on one fp32 accumulator; al bl is dropped.  A product then
//    carries a relative error near 2^-21 (fp32's own rounding is 2^-24),
//    where one TF32 pass (2^-11) misses the reference's atol 1e-4 at K 256
//    by about a hundred times (tests/test_torch_bsmm_numerics.py emulates
//    both on the CPU).  Three passes: 124 GFLOP, 0.25 ms at the 495
//    TFLOP/s TF32 peak.
//  * bf16 x bf16: products exact in fp32, so one pass on bf16 tensor
//    cores: 0.042 ms at the bf16 peak.
//  * bf16 x fp32 (either side): bf16 is exact in TF32, so two TF32 passes
//    (a bh + a bl, or al b + ah b).
//
// Design (both routes):
//  * One CTA (two warpgroups) owns one (tile-row, 128-column block) of Z:
//    TM = 128 or 64 of the tile-row's rows (tile-rows taller than TM take
//    several CTAs) and 128 columns; a warpgroup holds 64 x 128 (TM 128) or
//    64 x 64 (TM 64) fp32 accumulators of wgmma.  It walks the row's tiles
//    in order through the CSR row pointers, k in stages of 16 (fp32) or
//    64 (bf16), and writes each element once: no atomics, so the result
//    does not depend on the schedule, and a tile-row with no tile comes
//    out zero.
//  * Operands come by 16-byte cp.async (zero fill past bm, bk, K and N)
//    into a ring in shared memory that keeps the next stage in flight
//    while one multiplies; rows that 16-byte copies cannot take (bk or N
//    not a multiple of 4, or 8 for bf16) are loaded by the threads
//    instead.  The row's tile columns are copied to shared memory first,
//    so issuing a stage waits on no dependent load.  Both kernels keep to
//    128 registers and under half the shared memory, so two CTAs share an
//    SM and one's loads and splits overlap the other's products.
//  * wgmma reads both operands from shared memory under the swizzle of
//    their row width.  TF32 wgmma takes only K-major operands, so each
//    fp32 stage lands raw (A [TM][16], B [16][128] as B lies) and the
//    threads split it once: A into hi and lo planes in place of its
//    chunks, B transposed to K-major hi and lo planes (a thread takes one
//    column and 4 k, so its reads and its 16-byte writes are free of bank
//    conflicts).  Two plane buffers let one stage split while the last
//    one multiplies.  bf16 wgmma takes B MN-major, so bf16 stages land
//    where wgmma reads them: A K-major, B as two boxes of 64 columns.
//  * The grid is 1-D with the column blocks fastest, so the CTAs that
//    share a tile-row run together and read its A tiles from L2 once.
//  * What bounds it at the card case (PERF.md): not the tensor cores but
//    the traffic from L2, since each tile's B block is read (and in fp32
//    split) by the CTAs of every tile-row that holds the tile, and the
//    split, the copies and wgmma share the SM's shared-memory bandwidth.
//
// How it replaces the TPU kernel's assumptions:
//  * a serial grid that revisits each output block over consecutive steps
//    and accumulates into it: here one CTA owns an output block and loops
//    over the row's tiles; nothing carries across CTAs.
//  * zero tiles that pad empty tile-rows so that every output block is
//    initialised: a CTA whose row has no tile writes zeros.
//  * scalar-prefetched tile coordinates: the CTA reads its row's range
//    from rowptr and each tile's column from cols itself.
//  * (bm, bk, bn) BlockSpecs: any bm and bk; the CTA masks rows past bm and
//    M, k past bk and K, and columns past N.  The tm / tn arguments of the
//    C interface pick TM (128 or 64); the column block is always 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

#include "tf32.cuh"

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr int kTN = 128;               // columns per CTA

// Grid position: the column block, then (tile-row, TM slice).
struct Pos {
  int r, m_off, n0;
};
__device__ __forceinline__ Pos position(int n_nblocks, int subs, int tm) {
  const int64_t bid = blockIdx.x;
  const int rs = (int)(bid / n_nblocks);
  return {rs / subs, (rs % subs) * tm, (int)(bid % n_nblocks) * kTN};
}

// ---- loads: lim is the count of valid elements from p (<= 0: none) ---- //
__device__ __forceinline__ float4 ld4(const float* p, int lim, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) {
    if (lim >= 4) v = __ldg(reinterpret_cast<const float4*>(p));
  } else {
    if (lim > 0) v.x = __ldg(p);
    if (lim > 1) v.y = __ldg(p + 1);
    if (lim > 2) v.z = __ldg(p + 2);
    if (lim > 3) v.w = __ldg(p + 3);
  }
  return v;
}
__device__ __forceinline__ float bf(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p, int lim,
                                      bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  if (vec) {
    if (lim >= 4) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      v = make_float4(bf(u.x & 0xffffu), bf(u.x >> 16), bf(u.y & 0xffffu),
                      bf(u.y >> 16));
    }
  } else {
    if (lim > 0) v.x = bf(__ldg(q));
    if (lim > 1) v.y = bf(__ldg(q + 1));
    if (lim > 2) v.z = bf(__ldg(q + 2));
    if (lim > 3) v.w = bf(__ldg(q + 3));
  }
  return v;
}
// 8 bf16 as raw bits
__device__ __forceinline__ uint4 ld8(const __nv_bfloat16* p, int lim,
                                     bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (vec) {
    if (lim >= 8) v = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    uint32_t w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) w[e] = lim > e ? __ldg(q + e) : 0u;
    v = make_uint4(w[0] | w[1] << 16, w[2] | w[3] << 16, w[4] | w[5] << 16,
                   w[6] | w[7] << 16);
  }
  return v;
}

// ---- TF32 split (tf32.cuh) and tensor-core products ---- //
using tf32::split4;

using tf32::fence_async_smem;
using tf32::kmajor_desc;
using tf32::reg_fence;
using tf32::swz;
using tf32::wgmma_commit;
using tf32::wgmma_fence;
using tf32::wgmma_tf32;
using tf32::wgmma_wait;

// the same for an MN-major operand (16-bit types only): 64-element boxes
// lbo bytes apart, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// D[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16: A K-major, B MN-major
// (its two 64-column boxes LBO apart) in shared memory
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : REPRO_ACC8(0), REPRO_ACC8(8), REPRO_ACC8(16), REPRO_ACC8(24),
        REPRO_ACC8(32), REPRO_ACC8(40), REPRO_ACC8(48), REPRO_ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}
// D[64 x 64] (+)= A[64 x 16] B[16 x 64], the same for one box
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : REPRO_ACC8(0), REPRO_ACC8(8), REPRO_ACC8(16), REPRO_ACC8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}
#undef REPRO_ACC8

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, asynchronously; bytes 0 zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// The tile-row's work as a list of stages: stage c is tile
// t_beg + c / kpt at k0 = (c % kpt) kc.  The row's first kColCache tile
// columns are copied to shared memory at the start (s_cols), so that
// issuing a stage waits on no dependent device load.
constexpr int kColCache = 128;
struct Stages {
  int64_t t_beg;
  int64_t count;
  int kpt;
};
__device__ __forceinline__ Stages stages(const int64_t* rowptr,
                                         const int64_t* cols,
                                         int64_t* s_cols, int r, int bk,
                                         int kc) {
  const int64_t t_beg = rowptr[r], nt = rowptr[r + 1] - t_beg;
  for (int j = threadIdx.x; j < nt && j < kColCache; j += blockDim.x)
    s_cols[j] = cols[t_beg + j];
  __syncthreads();
  return {t_beg, nt * ((bk + kc - 1) / kc), (bk + kc - 1) / kc};
}
__device__ __forceinline__ int64_t col_of(const Stages& st,
                                          const int64_t* s_cols,
                                          const int64_t* cols, int64_t ti) {
  const int64_t j = ti - st.t_beg;
  return j < kColCache ? s_cols[j] : __ldg(cols + ti);
}

// The warpgroup's accumulators of m64nNk8 / m64nNk16 into Z: warp w of
// warpgroup wg holds rows 16 w + lane / 4 (and + 8) of the warpgroup's 64,
// columns 8 j + 2 (lane % 4) (and + 1) of its NW; warpgroup wg takes rows
// 64 wg (TM 128) or columns 64 wg (TM 64) of the CTA's block.  Masked to
// the tile-row, M and N.
template <int TM, int NW>
__device__ __forceinline__ void store_z(float* z, const float (&acc)[NW / 2],
                                        const Pos& pos, int M, int N,
                                        int bm) {
  const int wg = threadIdx.x / 128, w = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int i0 = pos.m_off + (TM == 128 ? wg * 64 : 0) + 16 * w + lane / 4;
  const int nb = pos.n0 + (TM == 128 ? 0 : wg * 64) + 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + 8 * h;
    const int64_t row = (int64_t)pos.r * bm + i;
    if (i >= bm || row >= M) continue;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int n = nb + 8 * j;
      float* zp = z + row * N + n;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (n + 1 < N && (N & 1) == 0) {
        *reinterpret_cast<float2*>(zp) = make_float2(v0, v1);
      } else {
        if (n < N) zp[0] = v0;
        if (n + 1 < N) zp[1] = v1;
      }
    }
  }
}

// ------------------------------------------------------------------ //
// fp32 or mixed operands: TF32 wgmma, 3 (or 2) passes
// ------------------------------------------------------------------ //
constexpr int kKc = 16;                // k per stage: a 64-byte row
constexpr int kRowB = 4 * kKc;         // bytes of a plane row
constexpr int kRaw = 2;                // raw stages: 1 in flight
constexpr int kTf32Blocks = 2;         // CTAs an SM holds (<= 128 registers)

// Shared memory from a 1024-byte-aligned base: two plane buffers (A hi,
// A lo, B hi, B lo; K-major, rows of kRowB bytes, swizzled), then the raw
// ring (A [TM][kKc] swizzled like its planes, B [kKc][128] as in B).
template <int TM>
struct Smem {
  static constexpr int kA = TM * kRowB;          // an A plane
  static constexpr int kB = kTN * kRowB;         // a B plane
  static constexpr int kPlanes = 2 * kA + 2 * kB;
  static constexpr int kRawA = TM * kRowB;
  static constexpr int kRawStage = kRawA + kKc * kTN * 4;
  static constexpr int kBytes = 2 * kPlanes + kRaw * kRawStage + 1024;
};

template <int TM, typename TA, typename TB>
__global__ void __launch_bounds__(kThreads, kTf32Blocks)
bsmm_tf32_kernel(const TA* __restrict__ a_tiles,
                 const int64_t* __restrict__ rowptr,
                 const int64_t* __restrict__ cols, const TB* __restrict__ b,
                 float* __restrict__ z, int M, int K, int N, int bm, int bk,
                 int subs, int n_nblocks, bool vec_a, bool vec_b) {
  using S = Smem<TM>;
  constexpr bool kLoA = std::is_same<TA, float>::value;
  constexpr bool kLoB = std::is_same<TB, float>::value;
  // a warpgroup's share: 64 rows x 128 columns (TM 128) or all 64 rows x
  // 64 columns (TM 64)
  constexpr int NW = TM == 128 ? kTN : kTN / 2;
  constexpr int kQ = kRowB / 16;                  // 16-byte chunks a row
  constexpr int kChA = TM * kQ / kThreads;        // ... a thread
  constexpr int kChB = kKc * kTN / 4 / kThreads;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);

  __shared__ int64_t s_cols[kColCache];
  const Pos pos = position(n_nblocks, subs, TM);
  const Stages st = stages(rowptr, cols, s_cols, pos.r, bk, kKc);
  const int tid = threadIdx.x, wg = tid / 128;

  auto plane = [&](int p, int which) {           // 0 A hi, 1 A lo, 2 B hi,
    return base + p * S::kPlanes + (which < 2 ? which * S::kA    // 3 B lo
                                              : 2 * S::kA + (which - 2) * S::kB);
  };
  auto raw_a = [&](int s) { return base + 2 * S::kPlanes + s * S::kRawStage; };
  auto raw_b = [&](int s) {
    return reinterpret_cast<float*>(raw_a(s) + S::kRawA);
  };

  // stage c into raw slot s: 16-byte cp.async for fp32 rows that allow
  // it, else loads converted to fp32 by the thread
  auto issue = [&](int64_t c, int s) {
    if (c >= st.count) return;
    const int64_t ti = st.t_beg + c / st.kpt;
    const int k0 = (int)(c % st.kpt) * kKc;
    const TA* at = a_tiles + ti * (int64_t)bm * bk;
    const int64_t kb = col_of(st, s_cols, cols, ti) * bk + k0;
#pragma unroll
    for (int j = 0; j < kChA; ++j) {
      const int idx = tid + j * kThreads;
      const int r = idx / kQ, q = idx % kQ;
      const int i = pos.m_off + r, k = k0 + 4 * q;
      const int lim = i < bm ? bk - k : 0;
      const TA* src = at + (int64_t)i * bk + k;
      unsigned char* d = raw_a(s) + swz<kRowB>(r, q);
      if (kLoA && vec_a)
        cp_async16(d, lim > 0 ? src : at, lim > 0 ? 16 : 0);
      else
        *reinterpret_cast<float4*>(d) = ld4(src, lim, vec_a);
    }
#pragma unroll
    for (int j = 0; j < kChB; ++j) {
      const int idx = tid + j * kThreads;
      const int kr = idx / (kTN / 4), q = idx % (kTN / 4);
      const int n = pos.n0 + 4 * q;
      const bool in = k0 + kr < bk && kb + kr < K;
      const int lim = in ? N - n : 0;
      const TB* src = b + (kb + kr) * N + n;
      float* d = raw_b(s) + kr * kTN + 4 * q;
      if (kLoB && vec_b)
        cp_async16(d, lim > 0 ? src : b, lim > 0 ? 16 : 0);
      else
        *reinterpret_cast<float4*>(d) = ld4(src, lim, vec_b);
    }
  };
  // raw slot s split into plane buffer p: A in place of its chunks, B
  // transposed to K-major (thread: one column n, 4 k)
  auto split = [&](int s, int p) {
#pragma unroll
    for (int j = 0; j < kChA; ++j) {
      const int idx = tid + j * kThreads;
      const int o = swz<kRowB>(idx / kQ, idx % kQ);
      split4<kLoA>(*reinterpret_cast<const float4*>(raw_a(s) + o),
                   plane(p, 0) + o, plane(p, 1) + o);
    }
#pragma unroll
    for (int j = 0; j < kChB; ++j) {
      const int idx = tid + j * kThreads;
      const int n = idx % kTN, q = idx / kTN;
      const float* col = raw_b(s) + 4 * q * kTN + n;
      const int o = swz<kRowB>(n, q);
      split4<kLoB>(make_float4(col[0], col[kTN], col[2 * kTN], col[3 * kTN]),
                   plane(p, 2) + o, plane(p, 3) + o);
    }
  };

  // no zero fill: the first product overwrites the accumulators, so that
  // no other instruction defines them while wgmma runs
  float acc[NW / 2];
  const uint32_t a_off = TM == 128 ? wg * 64 * kRowB : 0;  // the warpgroup's
  const uint32_t b_off = TM == 128 ? 0 : wg * 64 * kRowB;  // rows, columns
#pragma unroll
  for (int s = 0; s < kRaw - 1; ++s) {
    issue(s, s);
    cp_async_commit();
  }
  for (int64_t c = 0; c < st.count; ++c) {
    const int p = (int)(c & 1);
    cp_async_wait<kRaw - 2>();         // raw stage c has landed (own)
    __syncthreads();                   // ... all of it; plane buffer p and
                                       // raw slot c - 1 are free
    issue(c + kRaw - 1, (int)((c + kRaw - 1) % kRaw));
    cp_async_commit();
    split((int)(c % kRaw), p);
    fence_async_smem();
    __syncthreads();
    reg_fence(acc);
    wgmma_fence();
    const uint32_t ah = smem_addr(plane(p, 0)) + a_off;
    const uint32_t al = smem_addr(plane(p, 1)) + a_off;
    const uint32_t bh = smem_addr(plane(p, 2)) + b_off;
    const uint32_t bl = smem_addr(plane(p, 3)) + b_off;
#pragma unroll
    for (int ks = 0; ks < kKc / 8; ++ks) {          // 32 bytes a k8 step
      const uint64_t dah = kmajor_desc<kRowB>(ah + 32 * ks);
      const uint64_t dbh = kmajor_desc<kRowB>(bh + 32 * ks);
      const int more = c > 0 || ks > 0;
      if (kLoA) wgmma_tf32(acc, kmajor_desc<kRowB>(al + 32 * ks), dbh, more);
      if (kLoB)                                  // small terms first
        wgmma_tf32(acc, dah, kmajor_desc<kRowB>(bl + 32 * ks), more || kLoA);
      wgmma_tf32(acc, dah, dbh, more || kLoA || kLoB);
    }
    wgmma_commit();
    wgmma_wait<1>();                   // stage c - 1's products are done
    reg_fence(acc);
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
  reg_fence(acc);
  if (st.count == 0) {                 // a tile-row without tiles
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) acc[j] = 0.f;
  }

  store_z<TM, NW>(z, acc, pos, M, N, bm);
}

// ------------------------------------------------------------------ //
// bf16 x bf16: bf16 wgmma, one pass
// ------------------------------------------------------------------ //
constexpr int kKb = 64;                // k per stage: one 128-byte row
constexpr int kRing = 3;               // stages in the ring: 1 in flight
constexpr int kBf16Blocks = 2;         // CTAs an SM holds (<= 128 registers)

// Shared memory from a 1024-byte-aligned base: kRing stages of A [TM][64]
// (K-major) and B [64][128] as two boxes of 64 columns (MN-major), each
// in 128-byte rows under the 128-byte swizzle, as cp.async lands them.
template <int TM>
struct SmemB {
  static constexpr int kA = TM * 128;
  static constexpr int kBox = kKb * 128;
  static constexpr int kStage = kA + 2 * kBox;
  static constexpr int kBytes = kRing * kStage + 1024;
};

template <int TM>
__global__ void __launch_bounds__(kThreads, kBf16Blocks)
bsmm_bf16_kernel(const __nv_bfloat16* __restrict__ a_tiles,
                 const int64_t* __restrict__ rowptr,
                 const int64_t* __restrict__ cols,
                 const __nv_bfloat16* __restrict__ b, float* __restrict__ z,
                 int M, int K, int N, int bm, int bk, int subs,
                 int n_nblocks, bool vec_a, bool vec_b) {
  using S = SmemB<TM>;
  constexpr int NW = TM == 128 ? kTN : kTN / 2;
  constexpr int kChA = TM * 8 / kThreads;          // 16-byte chunks a thread
  constexpr int kChB = kKb * kTN / 8 / kThreads;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);

  __shared__ int64_t s_cols[kColCache];
  const Pos pos = position(n_nblocks, subs, TM);
  const Stages st = stages(rowptr, cols, s_cols, pos.r, bk, kKb);
  const int tid = threadIdx.x, wg = tid / 128;

  auto stage_a = [&](int s) { return base + s * S::kStage; };
  auto stage_b = [&](int s) { return stage_a(s) + S::kA; };
  auto issue = [&](int64_t c, int s) {
    if (c >= st.count) return;
    const int64_t ti = st.t_beg + c / st.kpt;
    const int k0 = (int)(c % st.kpt) * kKb;
    const __nv_bfloat16* at = a_tiles + ti * (int64_t)bm * bk;
    const int64_t kb = col_of(st, s_cols, cols, ti) * bk + k0;
#pragma unroll
    for (int j = 0; j < kChA; ++j) {
      const int idx = tid + j * kThreads;
      const int r = idx / 8, q = idx % 8;
      const int i = pos.m_off + r, k = k0 + 8 * q;
      const int lim = i < bm ? bk - k : 0;
      const __nv_bfloat16* src = at + (int64_t)i * bk + k;
      unsigned char* d = stage_a(s) + swz(r, q);
      if (vec_a)
        cp_async16(d, lim > 0 ? src : at, lim > 0 ? 16 : 0);
      else
        *reinterpret_cast<uint4*>(d) = ld8(src, lim, false);
    }
#pragma unroll
    for (int j = 0; j < kChB; ++j) {
      const int idx = tid + j * kThreads;
      const int kr = idx / (kTN / 8), q = idx % (kTN / 8);
      const int n = pos.n0 + 8 * q;
      const bool in = k0 + kr < bk && kb + kr < K;
      const int lim = in ? N - n : 0;
      const __nv_bfloat16* src = b + (kb + kr) * N + n;
      unsigned char* d = stage_b(s) + (q / 8) * S::kBox + swz(kr, q % 8);
      if (vec_b)
        cp_async16(d, lim > 0 ? src : b, lim > 0 ? 16 : 0);
      else
        *reinterpret_cast<uint4*>(d) = ld8(src, lim, false);
    }
  };

  float acc[NW / 2];                   // the first product overwrites it
  const uint32_t a_off = TM == 128 ? wg * 64 * 128 : 0;
  const uint32_t b_off = TM == 128 ? 0 : wg * S::kBox;
#pragma unroll
  for (int s = 0; s < kRing - 2; ++s) {
    issue(s, s);
    cp_async_commit();
  }
  for (int64_t c = 0; c < st.count; ++c) {
    cp_async_wait<kRing - 3>();        // stage c has landed (own copies)
    fence_async_smem();
    __syncthreads();                   // ... all of it; stage c - 2's
                                       // products are done, its slot free
    issue(c + kRing - 2, (int)((c + kRing - 2) % kRing));
    cp_async_commit();
    reg_fence(acc);
    wgmma_fence();
    const int s = (int)(c % kRing);
    const uint32_t ad = smem_addr(stage_a(s)) + a_off;
    const uint32_t bd = smem_addr(stage_b(s)) + b_off;
#pragma unroll
    for (int kk = 0; kk < kKb / 16; ++kk)       // 32 bytes, 16 rows a k16
      wgmma_bf16(acc, kmajor_desc<128>(ad + 32 * kk),
                 mnmajor_desc(bd + 16 * 128 * kk, S::kBox), c > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(acc);
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
  reg_fence(acc);
  if (st.count == 0) {
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) acc[j] = 0.f;
  }
  store_z<TM, NW>(z, acc, pos, M, N, bm);
}

// ------------------------------------------------------------------ //
// launch
// ------------------------------------------------------------------ //
bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p % (uintptr_t)bytes) == 0;
}

template <typename Kernel, typename TA, typename TB>
int launch(Kernel kernel, size_t smem, const void* a, const void* rowptr,
           const void* cols, const void* b, void* z, int n_tile_rows, int M,
           int K, int N, int bm, int bk, int tm, bool vec_a, bool vec_b,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int subs = (bm + tm - 1) / tm;
  const int n_nblocks = (N + kTN - 1) / kTN;
  const int64_t blocks = (int64_t)n_tile_rows * subs * n_nblocks;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const TA*)a, (const int64_t*)rowptr, (const int64_t*)cols,
      (const TB*)b, (float*)z, M, K, N, bm, bk, subs, n_nblocks, vec_a,
      vec_b);
  return (int)cudaGetLastError();
}

template <int TM, typename TA, typename TB>
int launch_tf32(const void* a, const void* rowptr, const void* cols,
                const void* b, void* z, int n_tile_rows, int M, int K, int N,
                int bm, int bk, cudaStream_t s) {
  // 4 elements a load: rows of bk (A) and N (B) elements on 4
  const bool vec_a = bk % 4 == 0 && aligned(a, 4 * sizeof(TA));
  const bool vec_b = N % 4 == 0 && aligned(b, 4 * sizeof(TB));
  return launch<decltype(&bsmm_tf32_kernel<TM, TA, TB>), TA, TB>(
      bsmm_tf32_kernel<TM, TA, TB>, Smem<TM>::kBytes, a,
      rowptr, cols, b, z, n_tile_rows, M, K, N, bm, bk, TM, vec_a, vec_b, s);
}

template <int TM>
int launch_bf16(const void* a, const void* rowptr, const void* cols,
                const void* b, void* z, int n_tile_rows, int M, int K, int N,
                int bm, int bk, cudaStream_t s) {
  const bool vec_a = bk % 8 == 0 && aligned(a, 16);
  const bool vec_b = N % 8 == 0 && aligned(b, 16);
  return launch<decltype(&bsmm_bf16_kernel<TM>), __nv_bfloat16,
                __nv_bfloat16>(bsmm_bf16_kernel<TM>, SmemB<TM>::kBytes,
                               a, rowptr, cols, b, z, n_tile_rows, M, K, N, bm,
                               bk, TM, vec_a, vec_b, s);
}

template <int TM>
int launch_dtypes(int a_dtype, int b_dtype, const void* a, const void* rowptr,
                  const void* cols, const void* b, void* z, int n_tile_rows,
                  int M, int K, int N, int bm, int bk, cudaStream_t s) {
  if (a_dtype == 1 && b_dtype == 1)
    return launch_bf16<TM>(a, rowptr, cols, b, z, n_tile_rows, M, K, N, bm,
                           bk, s);
  if (a_dtype == 1)
    return launch_tf32<TM, __nv_bfloat16, float>(a, rowptr, cols, b, z,
                                                 n_tile_rows, M, K, N, bm,
                                                 bk, s);
  if (b_dtype == 1)
    return launch_tf32<TM, float, __nv_bfloat16>(a, rowptr, cols, b, z,
                                                 n_tile_rows, M, K, N, bm,
                                                 bk, s);
  return launch_tf32<TM, float, float>(a, rowptr, cols, b, z, n_tile_rows, M,
                                       K, N, bm, bk, s);
}

}  // namespace

// a_dtype, b_dtype: 0 = float32, 1 = bfloat16.  tm: the CTA's rows, 128
// or 64; tn is not used (the column block is 128).
extern "C" int repro_block_sparse_matmul(
    const void* a, const void* rowptr, const void* cols, const void* b,
    void* z, int n_tile_rows, int M, int K, int N, int bm, int bk, int tm,
    int tn, int a_dtype, int b_dtype, void* stream) {
  (void)tn;
  if ((int64_t)M * N == 0 || n_tile_rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (tm == 128)
    return launch_dtypes<128>(a_dtype, b_dtype, a, rowptr, cols, b, z,
                              n_tile_rows, M, K, N, bm, bk, s);
  return launch_dtypes<64>(a_dtype, b_dtype, a, rowptr, cols, b, z,
                           n_tile_rows, M, K, N, bm, bk, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
