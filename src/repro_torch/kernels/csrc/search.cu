// search: lower-bound binary search of int64 probes in a sorted int64
// haystack; per probe, the position of an equal key or -1.
//
// Replaces the Pallas kernel src/repro/kernels/intersect.py::_isect_kernel
// (pl.pallas_call at intersect.py:67, wrapper intersect_sorted).  It serves
// three seams of the vector backend: intersect_keys (sorted probes),
// lookup_keys (probes in any order) and the position gathers of both unions.
//
// Bound: bytes.  The least traffic is each probe read once (8 B), each
// output written once (8 B) and the haystack read once (8 B a key), so
// the bound is (16 n + 8 m) / 3.35 TB/s.  Each probe in fact makes
// ceil(log2 m) dependent loads; the upper levels of the search tree are
// shared by all probes and stay in L1/L2, the last few levels miss.
//
// How it replaces the TPU kernel's assumptions:
//  * int32 keys padded with INT32_MAX: keys and positions are int64 and
//    both lengths are passed explicitly, so no key value is reserved
//    (the Pallas kernel reports a real key equal to the pad as absent)
//    and packed offset keys up to 2^62 are searched as they are.
//  * the whole haystack resident in VMEM: the haystack stays in device
//    memory and L2; one thread per probe searches it directly, so its
//    length is bounded by device memory, not by on-chip memory.
//  * a serial grid over blocks of sorted probes: threads are independent
//    and probes need not be sorted, so lookup_keys needs no argsort and
//    unsort around the call.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

__global__ void __launch_bounds__(kThreads)
search_kernel(const int64_t* __restrict__ hay, int64_t m,
              const int64_t* __restrict__ probes, int64_t n,
              int64_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t p = probes[i];
    int64_t lo = 0, hi = m;
    while (lo < hi) {
      const int64_t mid = lo + ((hi - lo) >> 1);
      if (__ldg(hay + mid) < p) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    out[i] = (lo < m && __ldg(hay + lo) == p) ? lo : -1;
  }
}

}  // namespace

extern "C" int repro_search(const void* hay, int64_t m, const void* probes,
                            int64_t n, void* out, void* stream) {
  if (n > 0) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    search_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)hay, m, (const int64_t*)probes, n, (int64_t*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
