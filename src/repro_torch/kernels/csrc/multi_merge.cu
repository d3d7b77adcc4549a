// multi_merge_ranks: for every element of k sorted int64 rows, its rank in
// the stable k-way merge (ties resolve by row, then by position in the
// row).  The rows arrive concatenated, with CSR row offsets.
//
// Replaces the Pallas kernel src/repro/kernels/ops.py::_multi_merge_kernel
// (pl.pallas_call at ops.py:188, wrapper multi_merge_ranks).  It serves the
// k-way union seam (union_k_keys, k >= 3): the ranks are a permutation, so
// the scatter merged[rank] = key that follows on the device is
// deterministic; dedup and positions follow as in the 2-way union.
//
// Rank of element e of row r at index x within its row:
//   x + sum_{j<r} #(row_j <= e) + sum_{j>r} #(row_j < e)
// One thread per element does the k - 1 binary searches it needs (one
// bound per other row: upper for rows before r, lower for rows after);
// the Pallas kernel ran both bounds on every row and selected, 2(k - 1).
//
// Bound: bytes.  Each key is read once and each rank written once:
// 16 * total bytes (plus the k + 1 offsets) over 3.35 TB/s.  The searches
// make (k - 1) ceil(log2 n) dependent loads per element, served mostly by
// L2 for the rows the union sees.
//
// How it replaces the TPU kernel's assumptions:
//  * rows padded with INT32_MAX to a common length: rows keep their own
//    lengths through CSR offsets, keys are int64, and no key value is
//    reserved.
//  * all k rows whole in VMEM: rows stay in device memory and L2.
//  * a serial (row, block) grid: elements are independent; a thread finds
//    its row from the offsets itself.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

__global__ void __launch_bounds__(kThreads)
multi_merge_kernel(const int64_t* __restrict__ keys,
                   const int64_t* __restrict__ offs, int k, int64_t total,
                   int64_t* __restrict__ ranks) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < total;
       g += stride) {
    // the row of g: offs[r] <= g < offs[r + 1] (k is small; rows may be
    // empty, and g < offs[k] ends the scan)
    int r = 0;
    while (__ldg(offs + r + 1) <= g) ++r;
    const int64_t e = keys[g];
    int64_t rank = g - __ldg(offs + r);
    for (int j = 0; j < k; ++j) {
      if (j == r) continue;
      const int64_t base = __ldg(offs + j);
      int64_t lo = base, hi = __ldg(offs + j + 1);
      if (j < r) {                      // rows before r: count keys <= e
        while (lo < hi) {
          const int64_t mid = lo + ((hi - lo) >> 1);
          if (__ldg(keys + mid) <= e) lo = mid + 1; else hi = mid;
        }
      } else {                          // rows after r: count keys < e
        while (lo < hi) {
          const int64_t mid = lo + ((hi - lo) >> 1);
          if (__ldg(keys + mid) < e) lo = mid + 1; else hi = mid;
        }
      }
      rank += lo - base;
    }
    ranks[g] = rank;
  }
}

}  // namespace

extern "C" int repro_multi_merge_ranks(const void* keys, const void* offs,
                                       int k, int64_t total, void* ranks,
                                       void* stream) {
  if (total > 0) {
    int64_t blocks = (total + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    multi_merge_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const int64_t*)keys, (const int64_t*)offs, k, total,
        (int64_t*)ranks);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
