// partition.cuh: partition points of a monotone predicate, the search step
// that merge_path.cu and multi_merge.cu share.
//
// Every search here takes a predicate over an index range [lo, hi) that is
// true on a prefix of the range and false after it, and returns the first
// index where it is false (hi if none).  A lower bound of p in sorted keys
// is the predicate key[i] < p, an upper bound key[i] <= p, and a merge-path
// split of diagonal d is a[i] <= b[d - 1 - i].  The predicate is called
// only on indices inside [lo, hi).
#pragma once

#include <stdint.h>

namespace part {

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// By a whole warp (all 32 lanes call it with the same arguments): kWays
// probes a level, kWays / 32 a lane, all loaded before any is tested, so
// a range of w indices takes ceil(log_kWays w) + 1 dependent rounds of
// loads (2 at 6K keys and 3 at 100K for kWays = 128) where one thread's
// binary search takes ceil(log2 w) (13 and 17).  Every lane returns it.
template <int kWays, class Pred>
__device__ int64_t warp_partition(int64_t lo, int64_t hi, Pred pred) {
  static_assert(kWays % 32 == 0, "kWays is a multiple of the warp");
  constexpr int kPer = kWays / 32;
  const int lane = threadIdx.x % 32;
  while (hi - lo > kWays) {
    const int64_t step = (hi - lo + kWays - 1) / kWays;
    bool held[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      // probe q = 32 p + lane; one past the range reads its last index
      const int64_t i = lo + (int64_t)(32 * p + lane) * step;
      held[p] = pred(imin(i, hi - 1)) && i < hi;
    }
    // the probes that hold are a prefix of the kWays, in order of q
    int cnt = 0;
#pragma unroll
    for (int p = 0; p < kPer; ++p)
      cnt += __popc(__ballot_sync(0xffffffffu, held[p]));
    const int64_t new_lo = cnt == 0 ? lo : lo + (cnt - 1) * step + 1;
    hi = imin(lo + cnt * step, hi);
    lo = new_lo;
  }
  if (lo == hi) return lo;
  bool held[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int64_t i = lo + 32 * p + lane;
    held[p] = pred(imin(i, hi - 1)) && i < hi;
  }
  int cnt = 0;
#pragma unroll
  for (int p = 0; p < kPer; ++p)
    cnt += __popc(__ballot_sync(0xffffffffu, held[p]));
  return lo + cnt;
}

// By one thread: a binary search (shared memory, or a short stretch of
// device memory).
template <class Pred>
__device__ __forceinline__ int64_t partition(int64_t lo, int64_t hi,
                                             Pred pred) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (pred(mid)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

}  // namespace part
