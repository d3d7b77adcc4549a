// multi_merge_ranks: for every element of k sorted int64 rows, its rank in
// the stable k-way merge (ties resolve by row, then by position in the
// row).  The rows arrive concatenated, with CSR row offsets.
//
// Replaces the Pallas kernel src/repro/kernels/ops.py::_multi_merge_kernel
// (ops.py:142, pl.pallas_call at ops.py:188, wrapper multi_merge_ranks).
// It serves the k-way union seam (union_k_keys, k >= 3): the ranks are a
// permutation, so the scatter merged[rank] = key that follows on the
// device is deterministic; dedup and positions follow as in the 2-way
// union.
//
// Rank of element e of row r at index x within its row:
//   x + sum_{j<r} #(row_j <= e) + sum_{j>r} #(row_j < e)
//
// Bound.  Each key is read once and each rank written once: 16 bytes an
// element plus the k + 1 offsets, over 3.35 TB/s: 0.09 us at the
// simulator's launches (3 rows of about 6,250 keys) and 1.6 us at 3 rows
// of 345K.  At the first size a launch costs its chain of dependent loads
// and the launch itself, so the design shortens the chain; at millions of
// keys the bytes bound it.
//
// Design (tests/test_torch_merge_tiling.py models this partition in numpy
// and holds it to the plain version).  A launch is a chain of dependent
// rounds of loads plus the instructions of its counts:
//  * A CTA of 256 threads takes a block of up to kBlock = 1,024
//    consecutive elements of one row r, 4 a thread, 256 apart, so that a
//    warp's lanes hold 32 consecutive elements; blocks never straddle
//    rows.  Warp 0 maps the CTA to (row, first element) from the offsets
//    (each row's ceil(len / kBlock) blocks, prefix-summed 32 rows at a
//    time by shuffles), so the wrapper needs no host sync; the launch has
//    ceil(total / kBlock) + k CTAs and those past the last row's blocks
//    exit.  At the simulator's 3 x 6,250 keys that is 21 working CTAs, at
//    345K keys in 3 rows 339, and launch bounds of 3 CTAs a SM keep
//    those in one wave.
//  * For each other row j, the counts of all elements of the block lie
//    between those of its first and its last key, so the keys of row j
//    that matter are a window [lo, hi): the bounds of the first and the
//    last key (the upper bound for j < r, the lower bound for j > r).
//    The other rows go two at a time; one warp for each end of each
//    window finds it by a 128-way search: 2 dependent rounds of loads at
//    6K keys and 3 at 100K, where a binary search for every element makes
//    13-17 a row.
//  * Every element adds lo - offs[j].  The first 2,048 keys of both
//    windows (a window at equal density is about 1,024) come into shared
//    memory in one round, all loads issued before the first store; each
//    thread counts the keys its predicate takes for its 4 elements by 4
//    branch-free binary searches there, interleaved step by step: every
//    lane takes the same steps, and the lanes of a warp, holding 32
//    consecutive elements, read nearly the same keys at each step.
//    (Galloping from one element to the next, with 4 consecutive
//    elements a thread, diverges the lanes: the counts then take more
//    than half of the launch, bound by the instructions the SM issues.)
//    A window of up to kDense = 8,192 keys streams its further chunks the
//    same way; a wider one (row j much denser than row r over the block's
//    keys) comes as a splitter sample, every ceil(width / 2048)-th key,
//    and a count there leaves a stretch of that many keys to search in
//    device memory.
//  * Ranks stay in int64 registers and are written once, coalesced.
//
// How it replaces the TPU kernel's assumptions:
//  * rows padded with INT32_MAX to a common length: rows keep their own
//    lengths through CSR offsets, keys are int64, and no key value is
//    reserved.
//  * all k rows whole in VMEM: rows stay in device memory; a CTA reads its
//    own block, two search paths a row and the windows.
//  * a serial (row, block) grid: blocks are independent and find their
//    row from the offsets themselves.
#include <cuda_runtime.h>
#include <stdint.h>

#include "partition.cuh"

namespace {

using part::imin;

constexpr int kThreads = 256;
constexpr int kPer = 4;                      // elements a thread
constexpr int kBlock = kThreads * kPer;      // elements a CTA
constexpr int kKeys = 2048;                  // window chunk / sample keys
constexpr int kLoads = kKeys / kThreads;     // a thread's loads a chunk
constexpr int64_t kDense = 4 * kKeys;        // widest streamed window
constexpr int kGroup = 2;                    // other rows a step
constexpr int kWays = 128;                   // probes a level of a bound

// x counts toward the rank of e: x <= e in rows before e's, x < e after
template <bool kUpper>
__device__ __forceinline__ bool takes(int64_t x, int64_t e) {
  return kUpper ? x <= e : x < e;
}

__device__ __forceinline__ bool takes(int64_t x, int64_t e, bool upper) {
  return upper ? takes<true>(x, e) : takes<false>(x, e);
}

// The keys of sorted s[0, n) (n > 0) that count toward each element's
// rank, a prefix of s, added to the ranks: a branch-free binary search for
// each of the thread's elements, the four interleaved.  The steps depend
// on n alone, so every lane takes the same ceil(log2 n), and a step is a
// load, a compare and a select an element.
template <bool kUpper>
__device__ __forceinline__ void count_chunk(const int64_t* s, int n,
                                            const int64_t (&e)[kPer],
                                            int64_t (&rank)[kPer],
                                            int nmine) {
  int at[kPer];                        // the point lies in [at, at + len]
#pragma unroll
  for (int x = 0; x < kPer; ++x) at[x] = 0;
  for (int len = n; len > 1; len -= len >> 1) {
    const int half = len >> 1;
#pragma unroll
    for (int x = 0; x < kPer; ++x)
      at[x] = takes<kUpper>(s[at[x] + half - 1], e[x]) ? at[x] + half : at[x];
  }
#pragma unroll
  for (int x = 0; x < kPer; ++x)
    if (x < nmine) rank[x] += at[x] + takes<kUpper>(s[at[x]], e[x]);
}

// keys[lo[w] + t step[w]] for t < kKeys and t step[w] < lim[w] into s[w],
// for W windows at once: all of a thread's loads are issued before its
// first store
template <int W>
__device__ __forceinline__ void load_keys(const int64_t* __restrict__ keys,
                                          const int64_t (&lo)[W],
                                          const int64_t (&step)[W],
                                          const int64_t (&lim)[W],
                                          int64_t (*s)[kKeys]) {
  int64_t v[W][kLoads];
#pragma unroll
  for (int w = 0; w < W; ++w) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int t = threadIdx.x + u * kThreads;
      v[w][u] = t * step[w] < lim[w] ? __ldg(keys + lo[w] + t * step[w]) : 0;
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int t = threadIdx.x + u * kThreads;
      if (t * step[w] < lim[w]) s[w][t] = v[w][u];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 3)
multi_merge_kernel(const int64_t* __restrict__ keys,
                   const int64_t* __restrict__ offs, int k,
                   int64_t* __restrict__ ranks) {
  __shared__ int64_t s_k[kGroup][kKeys];  // window chunks or samples
  __shared__ int64_t s_win[2 * kGroup];   // window ends of a step
  __shared__ int64_t s_blk[4];  // row (-1: none), its start, block's ends
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (warp == 0) {
    int64_t before = 0, row = -1, row0 = 0, start = 0, end = 0;
    for (int c = 0; c < k; c += 32) {
      const int j = c + lane;
      const int64_t lo = j < k ? __ldg(offs + j) : 0;
      const int64_t hi = j < k ? __ldg(offs + j + 1) : 0;
      const int64_t nb = (hi - lo + kBlock - 1) / kBlock;
      int64_t incl = nb;
      for (int o = 1; o < 32; o <<= 1) {
        const int64_t v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const int64_t first = before + incl - nb;   // row j's first block
      const unsigned hit = __ballot_sync(
          0xffffffffu, first <= blockIdx.x && blockIdx.x < first + nb);
      if (hit) {
        const int from = __ffs(hit) - 1;
        row = c + from;
        row0 = __shfl_sync(0xffffffffu, lo, from);
        start = row0 + (blockIdx.x - __shfl_sync(0xffffffffu, first, from))
                           * kBlock;
        end = imin(start + kBlock, __shfl_sync(0xffffffffu, hi, from));
        break;
      }
      before += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) {
      s_blk[0] = row;
      s_blk[1] = row0;
      s_blk[2] = start;
      s_blk[3] = end;
    }
  }
  __syncthreads();
  const int r = (int)s_blk[0];
  if (r < 0) return;                           // past the last row's blocks
  const int64_t base = s_blk[2];
  const int cnt = (int)(s_blk[3] - base);
  const int64_t first = __ldg(keys + base);
  const int64_t last = __ldg(keys + base + cnt - 1);
  // the thread's elements are tid + x kThreads, x < nmine
  const int nmine = max(0, min(kPer, (cnt - tid + kThreads - 1) / kThreads));
  int64_t e[kPer], rank[kPer];
#pragma unroll
  for (int x = 0; x < kPer; ++x) {
    e[x] = x < nmine ? __ldg(keys + base + tid + x * kThreads) : 0;
    rank[x] = base + tid + x * kThreads - s_blk[1];  // its index in the row
  }

  // the other rows, kGroup at a time: other row o is row o + (o >= r)
  for (int g = 0; g < k - 1; g += kGroup) {
    if (warp < 2 * kGroup && g + warp / 2 < k - 1) {
      const int o = g + warp / 2, j = o + (o >= r);
      const int64_t p = warp % 2 == 0 ? first : last;
      const bool upper = j < r;
      const int64_t pos = part::warp_partition<kWays>(
          __ldg(offs + j), __ldg(offs + j + 1),
          [=](int64_t i) { return takes(__ldg(keys + i), p, upper); });
      if (lane == 0) s_win[warp] = pos;
    }
    __syncthreads();
    {  // every window's first chunk, or its sample, in one round
      int64_t lo[kGroup], step[kGroup], width[kGroup];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        const bool any = g + q < k - 1;
        lo[q] = any ? s_win[2 * q] : 0;
        width[q] = any ? s_win[2 * q + 1] - lo[q] : 0;
        step[q] = width[q] <= kDense ? 1 : (width[q] + kKeys - 1) / kKeys;
      }
      load_keys(keys, lo, step, width, s_k);
    }
    __syncthreads();
    for (int q = 0; q < kGroup && g + q < k - 1; ++q) {
      const int o = g + q, j = o + (o >= r);
      const bool upper = j < r;
      const int64_t lo = s_win[2 * q], hi = s_win[2 * q + 1], w = hi - lo;
      const int64_t below = lo - __ldg(offs + j);
#pragma unroll
      for (int x = 0; x < kPer; ++x) rank[x] += below;
      if (w == 0) continue;
      if (w <= kDense) {
        for (int64_t c0 = lo; c0 < hi; c0 += kKeys) {
          const int64_t at[1] = {c0}, one[1] = {1}, rest[1] = {hi - c0};
          if (c0 != lo) {                    // a further chunk
            __syncthreads();                 // the last chunk's reads are done
            load_keys(keys, at, one, rest, s_k + q);
            __syncthreads();
          }
          const int n = (int)imin(kKeys, rest[0]);
          if (upper)
            count_chunk<true>(s_k[q], n, e, rank, nmine);
          else
            count_chunk<false>(s_k[q], n, e, rank, nmine);
        }
      } else {
        // the samples an element takes leave a stretch of at most step
        // keys to search
        const int64_t step = (w + kKeys - 1) / kKeys;
        const int ns = (int)((w + step - 1) / step);
        const int64_t* s = s_k[q];
#pragma unroll
        for (int x = 0; x < kPer; ++x) {
          if (x < nmine) {
            const int64_t ex = e[x];
            const int64_t js = part::partition(0, ns, [&](int64_t i) {
              return takes(s[i], ex, upper);
            });
            const int64_t pos = part::partition(
                js == 0 ? lo : lo + (js - 1) * step + 1,
                imin(lo + js * step, hi),
                [&](int64_t i) { return takes(__ldg(keys + i), ex, upper); });
            rank[x] += pos - lo;
          }
        }
      }
    }
    __syncthreads();                         // s_win, s_k are rewritten next
  }

#pragma unroll
  for (int x = 0; x < kPer; ++x)
    if (x < nmine) ranks[base + tid + x * kThreads] = rank[x];
}

}  // namespace

extern "C" int repro_multi_merge_ranks(const void* keys, const void* offs,
                                       int k, int64_t total, void* ranks,
                                       void* stream) {
  if (total > 0) {
    const int64_t blocks = (total + kBlock - 1) / kBlock + k;
    multi_merge_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const int64_t*)keys, (const int64_t*)offs, k, (int64_t*)ranks);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
