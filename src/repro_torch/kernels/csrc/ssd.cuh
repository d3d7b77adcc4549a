// ssd.cuh: what ssd_chunk.cu (the forward) and ssd_chunk_bwd.cu (its
// gradient) share: the cumulative sum of a chunk's decay, summed in fp64
// and rounded once, and 16-byte cp.async copies into shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssd {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// out[k] = a[0] + ... + a[k] for k < n (a as 0 past l), summed in fp64 and
// rounded once, as ssd_chunk_plain does: an fp32 scan in another order
// than the plain version's moves cum by ulps of |cum|, and under strong
// decay (|cum| in the hundreds) exp(cum[i] - cum[j]) with it, by several
// times the kernel's tolerance.  One warp, n a multiple of 32: lane t
// sums its n / 32 values in order, 8 loads in flight at a time; one
// shuffle scan adds the lanes before it; a second pass writes.
__device__ __forceinline__ void warp_cumsum(const float* __restrict__ ab,
                                            int l, int n, float* out,
                                            int lane) {
  const int seg = n / 32, k0 = lane * seg;
  auto load8 = [&](int e0, float (&v)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = k0 + e0 + e;
      v[e] = (e0 + e < seg && k < l) ? ab[k] : 0.f;
    }
  };
  double part = 0.0;
  for (int e0 = 0; e0 < seg; e0 += 8) {
    float v[8];
    load8(e0, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) part += (double)v[e];
  }
  double incl = part;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  double run = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) run = 0.0;
  for (int e0 = 0; e0 < seg; e0 += 8) {
    float v[8];
    load8(e0, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      run += (double)v[e];
      if (e0 + e < seg) out[k0 + e0 + e] = (float)run;
    }
  }
}

}  // namespace ssd
