// flash_attention: softmax attention with GQA in one pass over the keys,
// with an online-softmax carry.  For each (batch b, head h, query i):
//
//   s[j] = (q[b, h, i] . k[b, h / group, j]) / sqrt(d)   j < sk, and j <= i
//                                                        when causal
//   o[b, h, i] = sum_j softmax(s)[j] v[b, h / group, j]
//
// q: [B, H, sq, d]; k, v: [B, Hkv, sk, d]; o: [B, H, sq, d], in q's dtype
// (fp32 or bf16; k and v the same).  Any strides with the last dimension
// contiguous: the wrapper passes the batch, head and sequence strides, so
// the model's [b, s, h, d] projections are read and written in place.
// Scores, the carry (m, l, acc) and the products are fp32.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// _attn_kernel (pl.pallas_call at flash_attention.py:113, grid
// (b, h, nq, nk)).
//
// Bound: operations.  At the Qwen2-7B prefill shape (q [4, 28, 2048, 128],
// k, v [4, 4, 2048, 128], bf16, causal) QK^T and PV over the causal half
// are about 120 GFLOP: 0.12 ms at the bf16 tensor-core peak, against
// 134 MB read and written once (0.04 ms).  This first version computes on
// the fp32 CUDA cores (67 TFLOP/s peak, so at least 1.8 ms), 4 x 4 scores
// and 4 x d/16 outputs per thread; tensor cores (mma.sync / wgmma on bf16
// tiles) are later work.
//
// How it replaces the TPU kernel's assumptions:
//  * a serial grid whose innermost dimension walks the KV blocks while the
//    carry waits in VMEM scratch: here one CTA owns a 64-query block of
//    one (b, h) and loops over 64-key tiles itself, the carry in
//    registers; the thread that owns a row's scores owns its outputs, so
//    rescaling by alpha needs no exchange, and the row max and sum are
//    shuffles among the 16 threads of a row.
//  * every KV block visited, masked ones included: with the causal mask the
//    CTA stops at the tile that holds the block's last query.  Skipping
//    the tiles above the diagonal is exact: there the TPU kernel adds
//    p = exp(-1e30 - m) = 0 and rescales by exp(0) = 1, since every row
//    has met key 0 in the first tile.
//  * BlockSpec padding of the ragged KV tail: keys at or past sk are
//    loaded as zeros (k and v), and their scores masked to -1e30.
//  * an index map that folds head h onto KV head h / group: the CTA reads
//    its KV head's rows directly; nothing is repeated.
//  * blocks sized for VMEM: q (64 x d) and k, v (64 x d) tiles in fp32 in
//    shared memory, 100 KB at d = 128, so two CTAs share an SM; the
//    probabilities reuse k's buffer once the scores are in registers.
//  * a grid in order: CTAs are independent; under the causal mask the
//    query blocks with the most tiles are numbered first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 16 x 16
constexpr int kBq = 64;             // queries per CTA
constexpr int kBk = 64;             // keys per tile
constexpr int kPad = 4;             // keeps float4 rows aligned, spreads banks
constexpr float kNegInf = -1e30f;
static_assert(kBq == kBk, "load_tile stages kBk rows for q, k and v");

struct Strides {                    // elements; the last dimension is 1
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// rows x D of one [*, D] matrix (row stride ld_g elements) into shared
// memory rows of ld_s floats; rows at or past n_valid become zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld_s,
                                          const T* src, int64_t ld_g,
                                          int row0, int n_valid) {
  constexpr int kVecs = D / 4;
  for (int idx = threadIdx.x; idx < kBk * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = (idx % kVecs) * 4;
    const int row = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_valid) v = load4(src + (int64_t)row * ld_g + c);
    *reinterpret_cast<float4*>(dst + r * ld_s + c) = v;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int B,
                       int H, int Hkv, int sq, int sk, int causal,
                       float scale, Strides st) {
  // the thread's output columns: NG groups of VEC contiguous columns
  constexpr int VEC = D / 16 < 4 ? D / 16 : 4;
  constexpr int NG = D / (16 * VEC);
  constexpr int ldq = D + kPad;
  constexpr int ldp = kBk + kPad;
  constexpr int kv_floats = kBk * ldq > kBq * ldp ? kBk * ldq : kBq * ldp;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kBq][ldq]
  float* k_s = q_s + kBq * ldq;                   // [kBk][ldq]
  float* p_s = k_s;                               // [kBq][ldp], after S
  float* v_s = k_s + kv_floats;                   // [kBk][D]

  const int nq = (sq + kBq - 1) / kBq;
  const int bh = (int)(blockIdx.x % (unsigned)(B * H));
  const int qb = causal ? nq - 1 - (int)(blockIdx.x / (unsigned)(B * H))
                        : (int)(blockIdx.x / (unsigned)(B * H));
  const int bi = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qb * kBq;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  const T* qg = q + bi * st.qb + h * st.qh + (int64_t)q0 * st.qs;
  const T* kg = k + bi * st.kb + hk * st.kh;
  const T* vg = v + bi * st.vb + hk * st.vh;
  load_tile<T, D>(q_s, ldq, qg, st.qs, 0, sq - q0);

  // keys this block needs: all of them, or up to its last query
  int kv_end = sk;
  if (causal) {
    const int last_q = min(q0 + kBq, sq);
    kv_end = min(sk, last_q);
  }
  const int n_tiles = (kv_end + kBk - 1) / kBk;

  float m[4], l[4], acc[4][NG][VEC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][g][e] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int j0 = kt * kBk;
    __syncthreads();                   // the last tile's p_s, v_s consumed
    load_tile<T, D>(k_s, ldq, kg, st.ks, j0, sk);
    load_tile<T, D>(v_s, D, vg, st.vs, j0, sk);
    __syncthreads();

    // scores of rows ty + 16 r, keys tx + 16 c
    float s[4][4] = {};
#pragma unroll 4
    for (int d0 = 0; d0 < D; d0 += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * r) * ldq + d0);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * c) * ldq + d0);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float t = s[r][c];
          t = fmaf(qv[r].x, kv[c].x, t);
          t = fmaf(qv[r].y, kv[c].y, t);
          t = fmaf(qv[r].z, kv[c].z, t);
          t = fmaf(qv[r].w, kv[c].w, t);
          s[r][c] = t;
        }
    }
    __syncthreads();                   // k_s read: p_s may overwrite it

    // online softmax per row; the 16 threads of a row are lanes
    // 16 (ty % 2) .. 16 (ty % 2) + 15 of one warp
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty + 16 * r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tx + 16 * c;
        float t = s[r][c] * scale;
        if (j >= sk || (causal && j > i)) t = kNegInf;
        s[r][c] = t;
        mx = fmaxf(mx, t);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        p_s[(ty + 16 * r) * ldp + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][g][e] *= alpha;
    }
    __syncthreads();

    // acc += P V over this tile's keys
#pragma unroll 2
    for (int j = 0; j < kBk; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pv[r] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * r) * ldp + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[NG][VEC];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float* vp = v_s + (j + jj) * D + g * 16 * VEC + tx * VEC;
          if constexpr (VEC == 4) {
            const float4 t = *reinterpret_cast<const float4*>(vp);
            vv[g][0] = t.x; vv[g][1] = t.y; vv[g][2] = t.z; vv[g][3] = t.w;
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) vv[g][e] = vp[e];
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = jj == 0 ? pv[r].x : jj == 1 ? pv[r].y
                        : jj == 2 ? pv[r].z : pv[r].w;
#pragma unroll
          for (int g = 0; g < NG; ++g)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[r][g][e] = fmaf(p, vv[g][e], acc[r][g][e]);
        }
      }
    }
  }

  T* og = o + bi * st.ob + h * st.oh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= sq) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);  // fully masked: 0
    T* orow = og + (int64_t)i * st.os;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store1(orow + g * 16 * VEC + tx * VEC + e, acc[r][g][e] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int sq, int sk, int causal, float scale,
           const Strides& st, cudaStream_t stream) {
  constexpr int ldq = D + kPad;
  constexpr int ldp = kBk + kPad;
  constexpr int kv_floats = kBk * ldq > kBq * ldp ? kBk * ldq : kBq * ldp;
  const size_t smem = (size_t)(kBq * ldq + kv_floats + kBk * D) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)B * H * ((sq + kBq - 1) / kBq);
  flash_attention_kernel<T, D><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, B, H, Hkv, sq, sk,
      causal, scale, st);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             int B, int H, int Hkv, int sq, int sk, int causal, float scale,
             const Strides& st, cudaStream_t stream) {
  if (d == 32)
    return launch<T, 32>(q, k, v, o, B, H, Hkv, sq, sk, causal, scale, st,
                         stream);
  if (d == 64)
    return launch<T, 64>(q, k, v, o, B, H, Hkv, sq, sk, causal, scale, st,
                         stream);
  if (d == 128)
    return launch<T, 128>(q, k, v, o, B, H, Hkv, sq, sk, causal, scale, st,
                          stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o).  strides: 12 int64,
// the batch, head and sequence strides of q, k, v and o, in elements.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int Hkv, int sq, int sk, int d,
                                     int causal, float scale, int dtype,
                                     const int64_t* strides, void* stream) {
  if ((int64_t)B * H * sq == 0) return 0;
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, B, H, Hkv, sq, sk, causal,
                                   scale, st, (cudaStream_t)stream);
  return launch_d<float>(d, q, k, v, o, B, H, Hkv, sq, sk, causal, scale,
                         st, (cudaStream_t)stream);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
