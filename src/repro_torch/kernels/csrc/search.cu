// search: lower-bound search of int64 probes in a sorted int64 haystack;
// per probe, the position of an equal key or -1.
//
// Replaces the Pallas kernel src/repro/kernels/intersect.py::_isect_kernel
// (pl.pallas_call at intersect.py:67, wrapper intersect_sorted).  It serves
// three seams of the vector backend: intersect_keys (sorted probes),
// lookup_keys (probes in any order) and the position gathers of both unions
// (sorted probes).
//
// Bound: bytes.  The least traffic is each probe read once (8 B), each
// output written once (8 B) and the haystack read once (8 B a key), so
// the bound is (16 n + 8 m) / 3.35 TB/s.  A search of its own for every
// probe makes ceil(log2 m) dependent loads (25 at m = 21.5M), the last
// levels missing L2.  This kernel reads the haystack in windows instead:
//
//  * A CTA takes a block of 2,048 probes; thread i loads probes 8 i ..
//    8 i + 7 (16-byte loads) and the CTA tests whether the block is
//    non-decreasing (__syncthreads_and): the caller's order is not
//    trusted.
//  * Sorted block.  Its probes can only match keys in the window
//    [lower_bound(first), lower_bound(last) + 1).  Two warps find both
//    ends at once, each by a 32-way search (a warp loads 32 keys a
//    level, so 5 dependent loads for 21.5M keys, not 25), while the
//    other warps load their probes.  A launch of 16 blocks or more finds
//    the ends of all its whole blocks first, in a kernel of its own (one
//    thread a search, all of them at once), which hands them over in the
//    blocks' own first and last output slots; a haystack of one chunk
//    is its own window.  A window of at most 4
//    keys a probe streams through shared memory in coalesced chunks of
//    2,048 keys, and each thread finds its probes there (a binary search
//    for its first probe, a galloping one from there for each next).
//  * A wider window (probes sparse in the haystack), and the whole
//    haystack for an unsorted block (lookup_keys), is not read whole: the
//    CTA loads a splitter sample of it, every ceil(width / 2048)-th key,
//    into shared memory, and a probe's search there leaves a stretch of
//    that many keys to search in device memory (14 of the 25 dependent
//    loads at m = 21.5M; 4 in a window of 26K keys).
//  * 16 KB of shared memory a CTA, so registers, not shared memory, set
//    how many CTAs share an SM.
//
// How it replaces the TPU kernel's assumptions:
//  * int32 keys padded with INT32_MAX: keys and positions are int64 and
//    both lengths are passed explicitly, so no key value is reserved
//    (the Pallas kernel reports a real key equal to the pad as absent)
//    and packed offset keys up to 2^62 are searched as they are; m may
//    pass 2^31.
//  * the whole haystack resident in VMEM: the haystack stays in device
//    memory and L2 and only a window or a sample of it comes on chip.
//  * a serial grid over blocks of sorted probes: blocks are independent,
//    and probes need not be sorted, so lookup_keys needs no argsort and
//    unsort around the call.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                       // probes a thread
constexpr int kBlock = kThreads * kPer;       // probes a CTA
constexpr int kKeys = 2048;                   // window chunk / sample keys
constexpr int64_t kDense = 4 * (int64_t)kBlock;  // widest streamed window
constexpr int64_t kPrepass = 16;             // blocks that take window_kernel

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// lower_bound of p in hay[lo, hi), by one warp: 32 keys a level
__device__ int64_t warp_lower_bound(const int64_t* __restrict__ hay,
                                    int64_t lo, int64_t hi, int64_t p) {
  const int lane = threadIdx.x % 32;
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t i = lo + lane * step;
    const unsigned below =
        __ballot_sync(0xffffffffu, i < hi && __ldg(hay + i) < p);
    const int cnt = __popc(below);      // samples below p: a prefix
    const int64_t new_lo = cnt == 0 ? lo : lo + (cnt - 1) * step + 1;
    hi = imin(lo + cnt * step, hi);
    lo = new_lo;
  }
  const int64_t i = lo + lane;
  const unsigned below =
      __ballot_sync(0xffffffffu, i < hi && __ldg(hay + i) < p);
  return lo + __popc(below);
}

// first position in s[lo, hi) whose key is >= p (hi if none)
__device__ __forceinline__ int smem_lower_bound(const int64_t* s, int lo,
                                                int hi, int64_t p) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < p) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the same, knowing that s[lo - 1] < p if lo > 0: galloping (1, 2, 4, ...
// past lo) and then a binary search, so a probe that lands near the last
// one costs a step or two
__device__ __forceinline__ int smem_gallop(const int64_t* s, int lo, int hi,
                                           int64_t p) {
  int step = 1, end = lo;
  while (end < hi && s[end] < p) {
    lo = end + 1;
    end = lo + step;
    step <<= 1;
  }
  return smem_lower_bound(s, lo, end < hi ? end : hi, p);
}

// first position in hay[lo, hi) whose key is >= p (hi if none)
__device__ __forceinline__ int64_t lower_bound(const int64_t* __restrict__ hay,
                                               int64_t lo, int64_t hi,
                                               int64_t p) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(hay + mid) < p) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// lower_bound of the first and of the last probe of each of the first
// `whole` blocks (all of them whole), one thread each, written to the
// block's own first and last output slots for search_kernel to read
__global__ void __launch_bounds__(kThreads)
window_kernel(const int64_t* __restrict__ hay, int64_t m,
              const int64_t* __restrict__ probes, int64_t whole,
              int64_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= 2 * whole) return;
  const int64_t slot = (i / 2) * kBlock + (i % 2) * (kBlock - 1);
  out[slot] = lower_bound(hay, 0, m, __ldg(probes + slot));
}

__global__ void __launch_bounds__(kThreads)
search_kernel(const int64_t* __restrict__ hay, int64_t m,
              const int64_t* __restrict__ probes, int64_t n, int64_t whole,
              int64_t* __restrict__ out) {
  __shared__ __align__(16) int64_t s_k[kKeys];  // window chunk or sample
  __shared__ int64_t s_win[2];                  // the window's ends

  const int tid = threadIdx.x, warp = tid / 32;
  const int64_t base = (int64_t)blockIdx.x * kBlock;
  const int cnt = (int)imin(kBlock, n - base);
  const int mine = tid * kPer;          // the thread's first probe
  const int nmine = max(0, min(kPer, cnt - mine));
  const int64_t* pp = probes + base + mine;

  // the thread's probes: 16-byte loads when the block is whole (a warp's
  // loads then cover 2 KB of probes, each 32-byte sector from L1 twice)
  int64_t p[kPer], res[kPer];
  if (nmine == kPer && ((uintptr_t)pp & 15) == 0) {
#pragma unroll
    for (int j = 0; j < kPer; j += 2) {
      const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(pp + j));
      p[j] = v.x;
      p[j + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) p[j] = j < nmine ? __ldg(pp + j) : 0;
  }
  bool ordered = true;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    res[j] = -1;
    if (j + 1 < nmine) ordered &= p[j] <= p[j + 1];
  }
  if (nmine == kPer && mine + kPer < cnt)
    ordered &= p[kPer - 1] <= __ldg(pp + kPer);

  // the window of a sorted block, in place before the block knows it is
  // sorted: from window_kernel, or searched here by two warps while the
  // others load their probes
  if (m > 0 && m <= kKeys) {            // the haystack is one chunk
    if (tid < 2) s_win[tid] = tid * (m - 1);
  } else if (m > 0 && blockIdx.x < whole) {
    if (tid < 2) s_win[tid] = out[base + tid * (kBlock - 1)];
  } else if (m > 0 && warp < 2) {
    const int64_t q = __ldg(probes + base + (warp == 0 ? 0 : cnt - 1));
    const int64_t lb = warp_lower_bound(hay, 0, m, q);
    if (tid % 32 == 0) s_win[warp] = lb;
  }
  const bool sorted = __syncthreads_and(ordered);

  // a sorted block's window, or the whole haystack
  const bool win = sorted && m > 0;
  const int64_t lo = win ? s_win[0] : 0;
  const int64_t hi = win ? imin(s_win[1] + 1, m) : m;
  if (win && hi - lo <= kDense) {
    for (int64_t c0 = lo; c0 < hi; c0 += kKeys) {
      const int ck = (int)imin(kKeys, hi - c0);
      __syncthreads();                  // the last chunk's reads are done
      for (int j = tid; j < ck; j += kThreads) s_k[j] = __ldg(hay + c0 + j);
      __syncthreads();
      const int64_t first = s_k[0], last = s_k[ck - 1];
      int from = -1;                    // where the last probe landed
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (j < nmine && p[j] >= first && p[j] <= last) {
          from = from < 0 ? smem_lower_bound(s_k, 0, ck, p[j])
                          : smem_gallop(s_k, from, ck, p[j]);
          if (s_k[from] == p[j]) res[j] = c0 + from;
        }
      }
    }
  } else if (lo < hi) {
    // a splitter sample of [lo, hi), every step-th key: a probe's search
    // there leaves a stretch of at most step keys to search in memory
    const int64_t step = (hi - lo + kKeys - 1) / kKeys;
    const int ns = (int)((hi - lo + step - 1) / step);
    for (int j = tid; j < ns; j += kThreads)
      s_k[j] = __ldg(hay + lo + j * step);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (j < nmine) {
        // samples s_k[0, js) are below p[j], s_k[js] (if any) is not
        const int js = smem_lower_bound(s_k, 0, ns, p[j]);
        const int64_t a = js == 0 ? lo : lo + (js - 1) * step + 1;
        const int64_t pos = lower_bound(hay, a, imin(lo + js * step, hi),
                                        p[j]);
        if (pos < hi && __ldg(hay + pos) == p[j]) res[j] = pos;
      }
    }
  }

  int64_t* op = out + base + mine;
  if (nmine == kPer && ((uintptr_t)op & 15) == 0) {
#pragma unroll
    for (int j = 0; j < kPer; j += 2)
      *reinterpret_cast<longlong2*>(op + j) = make_longlong2(res[j],
                                                             res[j + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (j < nmine) op[j] = res[j];
  }
}

}  // namespace

extern "C" int repro_search(const void* hay, int64_t m, const void* probes,
                            int64_t n, void* out, void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t blocks = (n + kBlock - 1) / kBlock;
    // a launch of many blocks finds their windows first, all at once
    const int64_t whole = m > kKeys && blocks >= kPrepass ? n / kBlock : 0;
    if (whole > 0)
      window_kernel<<<(unsigned)((2 * whole + kThreads - 1) / kThreads),
                      kThreads, 0, s>>>((const int64_t*)hay, m,
                                        (const int64_t*)probes, whole,
                                        (int64_t*)out);
    search_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int64_t*)hay, m, (const int64_t*)probes, n, whole,
        (int64_t*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
