// tf32.cuh: fp32 products on the TF32 tensor cores at about fp32's
// accuracy (3xTF32), shared by the fp32 routes of block_sparse_matmul.cu
// and flash_attention.cu (wgmma) and of ssd_chunk.cu (mma.sync).
//
// An fp32 x is split into hi = tf32(x) and lo = tf32(x - hi), both
// rounded to nearest with ties away from zero (as cvt.rna rounds; the
// truncation the tensor core applies to a plain fp32 word would cost a
// bit of hi and leave lo wrong), and a b is taken as al bh + ah bl +
// ah bh, small terms first, on one fp32 accumulator; al bl is dropped.
// TF32 products are exact in fp32 (11 x 11 significant bits), so a
// product carries a relative error near 2^-21 where one TF32 pass leaves
// 2^-11 (tests/test_torch_bsmm_numerics.py, test_torch_flash_numerics.py
// and test_torch_ssd_numerics.py emulate the splits on the CPU).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: what cvt.rna.tf32.f32 gives for every finite x, as two integer
// operations on the bits (half of the dropped 13 bits added to the
// magnitude, then cleared), which cost less than the conversion
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x as hi + lo, both TF32 bit patterns (lo's argument is exact in fp32)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// hi and lo parts of 4 values as TF32 bit patterns; a bf16 operand (kLo
// false) is exact in TF32 and has no lo part
template <bool kLo>
__device__ __forceinline__ void split4(float4 v, unsigned char* hi,
                                       unsigned char* lo) {
  const float x[4] = {v.x, v.y, v.z, v.w};
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    h[e] = kLo ? tf32_rna(x[e]) : __float_as_uint(x[e]);
    l[e] = kLo ? tf32_rna(x[e] - __uint_as_float(h[e])) : 0u;
  }
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  if (kLo) *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// d += a b, m16n8k8, TF32 inputs, fp32 accumulator.  Fragments (g = lane
// / 4, t = lane % 4): a = A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t +
// 4]; b = B[t][g], B[t + 4][g]; d = D[g][2t], D[g][2t + 1], D[g + 8][2t],
// D[g + 8][2t + 1].  Not volatile: a function of its registers, which the
// compiler may schedule freely.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32 from split operands: al bh + ah bl + ah bh
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// four 8 x 4 fp32 blocks from shared memory, one register each: lanes 8m
// .. 8m + 7 give the row addresses of block m (16 bytes a row), and lane
// g * 4 + t receives row g, column t of every block.  The b16 ldmatrix
// moves 32-bit words intact, so this is the A fragment of an m16n8k8
// (blocks: rows 0-7 and 8-15 at columns 0-3, then at 4-7) or the B
// fragments of two n8 tiles (K-major rows n, columns k 0-3 and 4-7).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// ---- wgmma: descriptors, fences and TF32 products ---- //
// wgmma shared-memory descriptor of a K-major operand in rows of kRowB
// bytes (128 or 64) with the swizzle of that width: start address,
// leading byte offset 16, stride byte offset 8 rows, layout 1 (128-byte
// swizzle) or 2 (64-byte)
template <int kRowB>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * kRowB >> 4) << 32) |
         ((uint64_t)(kRowB == 128 ? 1 : 2) << 62);
}
// byte offset of 16-byte chunk q of row r in rows of kRowB bytes under
// the swizzle of that width (128: chunk ^ row % 8; 64: chunk ^ row / 2 % 4)
template <int kRowB = 128>
__device__ __forceinline__ int swz(int r, int q) {
  return r * kRowB + ((q ^ (kRowB == 128 ? r & 7 : (r >> 1) & 3)) << 4);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// shared-memory writes of the threads, visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from touching wgmma's accumulators while it runs
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define REPRO_ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), \
    "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
    "+f"(d[i + 7])

// D[64 x 128] (+)= A[64 x 8] B[8 x 128], tf32, A and B K-major in shared
// memory; D is overwritten when accumulate is 0
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : REPRO_ACC8(0), REPRO_ACC8(8), REPRO_ACC8(16), REPRO_ACC8(24),
        REPRO_ACC8(32), REPRO_ACC8(40), REPRO_ACC8(48), REPRO_ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}
// D[64 x 64] (+)= A[64 x 8] B[8 x 64], the same for 64 columns
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : REPRO_ACC8(0), REPRO_ACC8(8), REPRO_ACC8(16), REPRO_ACC8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 8] B[8 x 32], the same for 32 columns
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : REPRO_ACC8(0), REPRO_ACC8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x N] (+)= A[64 x 8] B[8 x N], tf32, A from registers (per warp
// the m16n8k8 A fragment of its 16 rows), B K-major in shared memory; D
// is overwritten when accumulate is 0
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : REPRO_ACC8(0), REPRO_ACC8(8), REPRO_ACC8(16), REPRO_ACC8(24),
        REPRO_ACC8(32), REPRO_ACC8(40), REPRO_ACC8(48), REPRO_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, "
      "%36, p, 1, 1;\n}\n"
      : REPRO_ACC8(0), REPRO_ACC8(8), REPRO_ACC8(16), REPRO_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : REPRO_ACC8(0), REPRO_ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e]) :: "memory");
}

}  // namespace tf32
