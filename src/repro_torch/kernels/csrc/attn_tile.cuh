// Shared tile machinery of the attention kernels (paged_decode.cu,
// paged_prefill.cu, spec_verify.cu, flash_prefill.cu, sink_decode.cu): typed
// 16-byte tile loads into float32 shared memory, the int8 arena tile load
// that dequantizes as it writes shared memory (QuantPlane), and one
// online-softmax step of R query rows against a tile of TK keys.
//
// Layout of a CTA's shared memory (floats):
//   Qs [R][HD+1]   query rows (padded: the score loop reads rows and keys
//   Ks [TK][HD+1]  key tile     column-wise, the +1 keeps banks distinct)
//   Vs [TK][HD]    value tile (read row-wise by consecutive threads)
//   P  [R][TK]     scores, then probabilities
//   M, L, C [R]    running max, running sum, this step's correction
// Accumulators live in registers: thread `tid` owns column d = tid % HD of
// rows tid / HD + k * (NT / HD), k < NR (NR = MAXR unless a kernel passes a
// longer accumulator array: a CTA holds at most NR · NT / HD query rows).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace paged {

constexpr float NEG_INF = -1e30f;   // masked score (finite, as in the TPU kernels)
constexpr int NT = 128;             // threads per CTA
constexpr int MAXR = 16;            // accumulator rows per thread

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy `n_rows` rows of HD contiguous elements, `row_stride` elements apart,
// from `src` into shared `dst` (row stride `ld` floats), converting to
// float32. Rows >= valid_rows are zero-filled and never read from global
// memory. Each thread moves 16 bytes per load; neighbouring threads read
// neighbouring addresses. Every row start must be 16-byte aligned.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          size_t row_stride, int n_rows,
                                          int valid_rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = HD / VEC;
  for (int i = threadIdx.x; i < n_rows * VPR; i += NT) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    float* out = dst + r * ld + c;
    if (r < valid_rows) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (size_t)r * row_stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < VEC; ++u) out[u] = to_f32<T>(e[u]);
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u) out[u] = 0.f;
    }
  }
}

// The same for rows stored back to back (row stride HD).
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int n_rows, int valid_rows) {
  load_rows<T, HD>(dst, ld, src, HD, n_rows, valid_rows);
}

// QuantPlane: an int8 arena block carries float32 per-channel seal scales
// sc[HD] (a nonzero entry marks a sealed block's channel) and per-token
// scales tk[bs] of unsealed content. Element (r, c) of the block is
// q · (sc[c] != 0 ? sc[c] : tk[r]), decided per channel: exactly one
// float32 product, as the plain version computes it.
template <typename KV>
constexpr bool kInt8Kv = std::is_same<KV, int8_t>::value;

// Copy block `phys`'s scale rows (kv head kh) of K and V into shared memory:
// Ks_sc/Vs_sc [HD], Ks_tk/Vs_tk [bs]. Only resident blocks are passed in.
template <int HD>
__device__ __forceinline__ void load_scale_rows(
    float* Ks_sc, float* Ks_tk, float* Vs_sc, float* Vs_tk,
    const float* __restrict__ ks, const float* __restrict__ kt,
    const float* __restrict__ vs, const float* __restrict__ vt, int phys,
    int K, int kh, int bs) {
  const size_t srow = ((size_t)phys * K + kh) * HD;
  const size_t trow = ((size_t)phys * K + kh) * bs;
  for (int i = threadIdx.x; i < HD; i += NT) {
    Ks_sc[i] = ks[srow + i];
    Vs_sc[i] = vs[srow + i];
  }
  for (int i = threadIdx.x; i < bs; i += NT) {
    Ks_tk[i] = kt[trow + i];
    Vs_tk[i] = vt[trow + i];
  }
}

// Load `n_rows` back-to-back rows of an arena block into shared `dst` (row
// stride `ld` floats). KV = float / bf16: `load_tile`. KV = int8_t: each
// thread moves 16 int8 per 16-byte load and dequantizes each element with
// the block's scale rows in shared memory (sc, tk) as it writes it.
template <typename KV, int HD>
__device__ __forceinline__ void load_kv_tile(float* dst, int ld, const KV* src,
                                             int n_rows, int valid_rows,
                                             const float* sc, const float* tk) {
  if constexpr (kInt8Kv<KV>) {
    constexpr int VEC = 16;
    constexpr int VPR = HD / VEC;
    for (int i = threadIdx.x; i < n_rows * VPR; i += NT) {
      const int r = i / VPR;
      const int c = (i % VPR) * VEC;
      float* out = dst + r * ld + c;
      if (r < valid_rows) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(src + (size_t)r * HD + c);
        const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
        const float t = tk[r];
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          const float s = sc[c + u];
          out[u] = (float)e[u] * (s != 0.f ? s : t);
        }
      } else {
#pragma unroll
        for (int u = 0; u < VEC; ++u) out[u] = 0.f;
      }
    }
  } else {
    load_tile<KV, HD>(dst, ld, src, n_rows, valid_rows);
  }
}

// Shared-memory floats of the scale rows (none for float / bf16 arenas).
template <typename KV>
inline size_t scale_smem_floats(int HD, int bs) {
  return kInt8Kv<KV> ? 2 * ((size_t)HD + bs) : 0;
}

// One online-softmax step: R query rows (Qs) against TK keys (Ks, Vs).
// `valid(r, t)` says whether key t is visible to row r; masked scores are
// NEG_INF, exactly as the TPU kernels mask them. The caller has synchronised
// after filling Ks/Vs; this function ends with a barrier, so the caller may
// overwrite the tiles right after it returns.
template <int HD, int NR, typename ValidF>
__device__ __forceinline__ void tile_step(const float* Qs, const float* Ks,
                                          const float* Vs, float* P, float* M,
                                          float* L, float* C, float (&acc)[NR],
                                          int R, int TK, float scale,
                                          ValidF valid) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < R * TK; i += NT) {
    const int r = i / TK, t = i % TK;
    const float* q = Qs + r * LD;
    const float* k = Ks + t * LD;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) s = fmaf(q[d], k[d], s);
    P[i] = valid(r, t) ? s * scale : NEG_INF;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += NT) {
    float* p = P + r * TK;
    const float m_prev = M[r];
    float mx = NEG_INF;
    for (int t = 0; t < TK; ++t) mx = fmaxf(mx, p[t]);
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int t = 0; t < TK; ++t) {
      const float e = expf(p[t] - m_new);
      p[t] = e;
      sum += e;
    }
    const float corr = expf(m_prev - m_new);
    L[r] = L[r] * corr + sum;
    M[r] = m_new;
    C[r] = corr;
  }
  __syncthreads();
  constexpr int RG = NT / HD;
  const int d = threadIdx.x % HD;
  const int r0 = threadIdx.x / HD;
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const int r = r0 + k * RG;
    if (r < R) {
      const float* p = P + r * TK;
      float a = acc[k] * C[r];
      for (int t = 0; t < TK; ++t) a = fmaf(p[t], Vs[t * HD + d], a);
      acc[k] = a;
    }
  }
  __syncthreads();
}

// out[r][d] = acc / max(l, 1e-30) for the rows this thread owns, r < R.
template <typename T, int HD, int NR>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[NR],
                                           const float* L, int R) {
  constexpr int RG = NT / HD;
  const int d = threadIdx.x % HD;
  const int r0 = threadIdx.x / HD;
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const int r = r0 + k * RG;
    if (r < R) out[(size_t)r * HD + d] = from_f32<T>(acc[k] / fmaxf(L[r], 1e-30f));
  }
}

// Shared-memory bytes of one CTA holding R query rows and a TK-key tile.
inline size_t tile_smem_bytes(int R, int TK, int HD) {
  return sizeof(float) * ((size_t)R * (HD + 1) + (size_t)TK * (HD + 1) +
                          (size_t)TK * HD + (size_t)R * TK + 3 * (size_t)R);
}

}  // namespace paged
