// merge_path: stable merge of two sorted int64 arrays, with a source flag
// per output (0 = taken from a, 1 = from b; a first on equal keys).
//
// Replaces the Pallas kernel src/repro/kernels/ops.py::_merge_kernel
// (ops.py:72, pl.pallas_call at ops.py:119, wrapper merge_sorted).  It
// serves the 2-way union seam (union_keys); the dedup of adjacent equal
// keys and the positions (through the search kernel) follow as tensor
// code on the device.
//
// Bound.  Each input key is read once and each output written once:
// 17 (n + m) bytes (keys in, keys out, one-byte flags) over 3.35 TB/s,
// 0.06 us at the simulator's launches (about 12,500 outputs) and 1.1 us at
// 225K.  At the first size nothing of that is bandwidth: a launch costs
// its chain of dependent loads plus the launch itself, so the design
// shortens the chain; at millions of keys the bytes bound it.
//
// Design (tests/test_torch_merge_tiling.py models this partition in numpy
// and holds it to the plain version):
//  * A CTA of 128 threads takes a tile of kTile = 512 consecutive outputs,
//    diagonals [d0, d1).  512 keeps the simulator's 12,500-output launches
//    on 25 SMs (a tile of 2,048 would use 7) and fills the card in one wave
//    at 225K (440 CTAs of 9 KB of shared memory, several a SM).
//  * Warp 0 finds the merge-path split of d0 (the number of a's among the
//    first d0 outputs: the first i with a[i] > b[d0 - 1 - i], so a comes
//    first on equal keys), warp 1 that of d1, at once, each by a 128-way
//    search (4 probes a lane, loaded together): 2 dependent rounds of
//    loads at 6K keys a side and 3 at 100K, where a binary search by
//    each thread makes 13 and 17 (their top levels hit L1, shared by the
//    CTA's threads; the bottom ones do not).
//    Neighbouring tiles compute their shared boundary by the same
//    predicate, so they agree on it exactly.  At d = 0 and d = n + m the
//    range is empty and nothing is loaded, so a launch of one tile makes
//    no global search.
//  * The tile's inputs are exactly a[i0, i1) and b[j0, j1), 512 keys in
//    all.  Each thread loads its 4 of them (8-byte loads, a warp's reads
//    contiguous in a or in b), all issued before the first is stored to
//    shared memory, so the window costs one round trip.  It starts at any
//    int64 index, and at 4 KB a tile 8- or 16-byte loads take the same
//    one round, so no bulk copy rounds it out to 16 bytes.
//  * Each thread finds its own split, of diagonal 4 t inside the window,
//    by a binary search in shared memory (9 steps), merges its 4 outputs
//    from there with the same predicate, and stages keys and flags in
//    shared memory; the tile leaves with coalesced stores.
//
// How it replaces the TPU kernel's assumptions:
//  * int32 keys padded with INT32_MAX to a block multiple: keys are int64
//    and both lengths are explicit, so the ragged last tile is cut by
//    length and no key value is reserved.
//  * both operands whole in VMEM: operands stay in device memory; a CTA
//    reads two search paths and its own 4 KB window.
//  * a serial grid: every tile finds its own bounds, so tiles run in any
//    order and in parallel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "partition.cuh"

namespace {

using part::imax;
using part::imin;

constexpr int kThreads = 128;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWays = 128;                 // probes a level of a tile split

__global__ void __launch_bounds__(kThreads)
merge_path_kernel(const int64_t* __restrict__ a, int64_t n,
                  const int64_t* __restrict__ b, int64_t m,
                  int64_t* __restrict__ merged, int8_t* __restrict__ src) {
  __shared__ int64_t s_in[kTile];    // a[i0, i1) then b[j0, j1)
  __shared__ int64_t s_out[kTile];
  __shared__ int8_t s_src[kTile];
  __shared__ int64_t s_cut[2];       // i0, i1
  const int tid = threadIdx.x, warp = tid / 32;
  const int64_t d0 = (int64_t)blockIdx.x * kTile;
  const int len = (int)imin(kTile, n + m - d0);

  if (warp < 2) {
    const int64_t d = d0 + (warp == 0 ? 0 : len);
    const int64_t i = part::warp_partition<kWays>(
        imax(0, d - m), imin(d, n),
        [=](int64_t x) { return __ldg(a + x) <= __ldg(b + (d - 1 - x)); });
    if (tid % 32 == 0) s_cut[warp] = i;
  }
  __syncthreads();
  const int64_t i0 = s_cut[0], j0 = d0 - i0;
  const int na = (int)(s_cut[1] - i0), nb = len - na;
  int64_t v[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int t = tid + u * kThreads;
    v[u] = t >= len ? 0
           : t < na ? __ldg(a + i0 + t) : __ldg(b + j0 + (t - na));
  }
#pragma unroll
  for (int u = 0; u < kItems; ++u)
    if (tid + u * kThreads < len) s_in[tid + u * kThreads] = v[u];
  __syncthreads();

  const int64_t* sa = s_in;
  const int64_t* sb = s_in + na;
  const int dl = tid * kItems;
  if (dl < len) {
    int i = (int)part::partition(
        imax(0, dl - nb), imin(dl, na),
        [=](int64_t x) { return sa[x] <= sb[dl - 1 - x]; });
    int j = dl - i;
    const int end = min(dl + kItems, len);
    for (int s = dl; s < end; ++s) {
      const bool take_a = i < na && (j >= nb || sa[i] <= sb[j]);
      s_out[s] = take_a ? sa[i++] : sb[j++];
      s_src[s] = take_a ? 0 : 1;
    }
  }
  __syncthreads();
  for (int t = tid; t < len; t += kThreads) {
    merged[d0 + t] = s_out[t];
    src[d0 + t] = s_src[t];
  }
}

// does nothing: a launch of it is the floor that no launch goes under
__global__ void empty_kernel() {}

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

extern "C" int repro_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
