// merge_path: stable merge of two sorted int64 arrays, with a source flag
// per output (0 = taken from a, 1 = from b; a first on equal keys).
//
// Replaces the Pallas kernel src/repro/kernels/ops.py::_merge_kernel
// (pl.pallas_call at ops.py:119, wrapper merge_sorted).  It serves the
// 2-way union seam (union_keys); the dedup of adjacent equal keys and the
// positions (through the search kernel) follow as tensor code on the
// device.
//
// Bound: bytes.  Each input key is read once and each output written once:
// (8 + 8) (n + m) + (n + m) bytes for keys in, keys out and the one-byte
// flags, over 3.35 TB/s.
//
// Design: the output is cut into tiles of kThreads * kItems slots, one
// tile per block.  Every thread finds the merge-path split of its own
// diagonal (the number of a's among the first d outputs) by a binary
// search over global memory, merges its kItems outputs serially, and
// stages them in shared memory, so that the block writes its tile with
// coalesced stores.
//
// How it replaces the TPU kernel's assumptions:
//  * int32 keys padded with INT32_MAX to a block multiple: keys are int64
//    and both lengths are explicit, so the ragged last tile is masked by
//    length and no key value is reserved.
//  * both operands whole in VMEM: operands stay in device memory; a
//    thread touches only the log-depth search path and its own window, so
//    lengths are bounded by device memory.
//  * a serial grid: every tile finds its splits itself, so tiles run in
//    any order and in parallel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;

// Number of elements of a among the first d outputs of the stable merge.
__device__ __forceinline__ int64_t merge_split(const int64_t* __restrict__ a,
                                               int64_t n,
                                               const int64_t* __restrict__ b,
                                               int64_t m, int64_t d) {
  int64_t lo = d > m ? d - m : 0;
  int64_t hi = d < n ? d : n;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) <= __ldg(b + (d - 1 - mid))) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
merge_path_kernel(const int64_t* __restrict__ a, int64_t n,
                  const int64_t* __restrict__ b, int64_t m,
                  int64_t* __restrict__ merged, int8_t* __restrict__ src) {
  __shared__ int64_t s_key[kTile];
  __shared__ int8_t s_src[kTile];
  const int64_t total = n + m;
  const int64_t tile0 = (int64_t)blockIdx.x * kTile;
  const int64_t d0 = tile0 + (int64_t)threadIdx.x * kItems;
  if (d0 < total) {
    int64_t i = merge_split(a, n, b, m, d0);
    int64_t j = d0 - i;
    const int64_t end = d0 + kItems < total ? d0 + kItems : total;
    int slot = threadIdx.x * kItems;
    for (int64_t d = d0; d < end; ++d, ++slot) {
      const bool take_a = i < n && (j >= m || __ldg(a + i) <= __ldg(b + j));
      if (take_a) {
        s_key[slot] = __ldg(a + i);
        s_src[slot] = 0;
        ++i;
      } else {
        s_key[slot] = __ldg(b + j);
        s_src[slot] = 1;
        ++j;
      }
    }
  }
  __syncthreads();
  const int64_t len = total - tile0 < kTile ? total - tile0 : kTile;
  for (int t = threadIdx.x; t < len; t += kThreads) {
    merged[tile0 + t] = s_key[t];
    src[tile0 + t] = s_src[t];
  }
}

}  // namespace

extern "C" int repro_merge_path(const void* a, int64_t n, const void* b,
                                int64_t m, void* merged, void* src,
                                void* stream) {
  const int64_t total = n + m;
  if (total > 0) {
    const int64_t blocks = (total + kTile - 1) / kTile;
    merge_path_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const int64_t*)a, n, (const int64_t*)b, m, (int64_t*)merged,
        (int8_t*)src);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
