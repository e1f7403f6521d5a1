// Shared tile machinery of the attention kernels (paged_decode.cu,
// sink_decode.cu, paged_prefill.cu, spec_verify.cu, flash_prefill.cu):
//   * typed 16-byte loads of rows into float32 shared memory (`load_rows`,
//     `load_tile`: the query rows of a decode CTA);
//   * the tensor-core tile (`tc_tile_step`): 16 query rows per warp against
//     a key tile staged in shared memory, products on mma.sync (bf16
//     m16n8k16, or float32 through the 3xTF32 split), the online softmax in
//     registers (flash_prefill, and through the paged-history routine);
//   * the split-KV decode routine (`decode_split_attend` over
//     `decode_stage_rows`, `decode_block_step`, `decode_merge`, then
//     `decode_combine` / `lse_combine`: paged_decode and sink_decode): each
//     warp walks its own KV chunks through a cp.async double buffer with
//     its own softmax state; the warps of a CTA, then the CTAs of a split
//     grid, merge by log-sum-exp; a GQA group wider than a CTA holds
//     (`dec_gmax`) is cut into row groups, one CTA each;
//   * the paged-history tensor-core routine (`paged_tc_attend`,
//     paged_prefill and spec_verify): a CTA of 16-row warps walks its
//     split's share of a paged history, key tiles staged through the table
//     by cp.async (int8 pages dequantized through registers), then the
//     chunk's own keys, all on `tc_tile_step`; the splits merge by
//     `lse_combine`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace paged {

constexpr float NEG_INF = -1e30f;   // masked score (finite, as in the TPU kernels)
constexpr int NT = 128;             // threads per CTA
constexpr int MAXR = 16;            // a decode CTA holds ≤ MAXR·NT/HD
                                    // query rows (dec_gmax)

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return (float)x;
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

// ---- asynchronous copies, vector loads ----------------------------------

// 16 bytes global → shared with cp.async (L2 only); `pred` false writes
// zeros and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred = true) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n contiguous elements at p (aligned to n · sizeof(KV) bytes, or 16) as
// float32, with the widest loads that alignment allows.
template <typename KV, int n>
__device__ __forceinline__ void ld_f32(const KV* p, float (&o)[n]) {
  constexpr int bytes = n * (int)sizeof(KV);
  if constexpr (bytes % 16 == 0) {
    constexpr int E = 16 / sizeof(KV);
#pragma unroll
    for (int i = 0; i < bytes / 16; ++i) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[i];
      const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
      for (int u = 0; u < E; ++u) o[i * E + u] = to_f32<KV>(e[u]);
    }
  } else if constexpr (bytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int u = 0; u < n; ++u) o[u] = to_f32<KV>(e[u]);
  } else if constexpr (bytes == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int u = 0; u < n; ++u) o[u] = to_f32<KV>(e[u]);
  } else {
#pragma unroll
    for (int u = 0; u < n; ++u) o[u] = to_f32<KV>(p[u]);
  }
}

// ---- tensor-core tile (flash_prefill, paged_tc_attend) -----------------
//
// A CTA of TC_WARPS warps holds TC_BM = 16 · TC_WARPS query rows in shared
// memory; warp w owns rows 16w .. 16w + 15. A key tile of BN keys (K and V)
// is staged in shared memory by the caller (cp.async). Per tile and warp:
//   S = Q·Kᵀ on mma.sync into C fragments (registers), the online softmax on
//   those fragments (row max and sum over the quad that holds a row, exp2
//   of log2e-prescaled scores), then O += P·V with P taken straight from
//   the S fragments.
// float32 runs m16n8k8 TF32 with the 3xTF32 split of each operand
// (big = tf32(x), small = tf32(x − big), both rounded to nearest;
// big·big' + big·small' + small·big'), which keeps float32 accuracy; bf16
// runs m16n8k16 with P rounded to bf16.
// Fragment layouts (PTX ISA, mma.m16n8k8 / m16n8k16): lane = 4·g + t holds
// C rows g and g + 8, columns 2t and 2t + 1 of each 8-wide n-tile. The
// k order inside one mma is free (it is a sum), so each operand's k index is
// permuted to make a thread's loads contiguous:
//   TF32 scores: k = t ↔ d = 8kc + 2t, k = t + 4 ↔ d = 8kc + 2t + 1 (float2
//   loads of Q and K rows); TF32 P·V: k = t ↔ key 8kc + 2t, k = t + 4 ↔
//   key 8kc + 2t + 1, so A = (c0, c2, c1, c3) of the S n-tile kc, with no
//   shuffle; bf16 scores: k pairs (2t, 2t+1) ↔ d = 16kc + 4t + (0, 1),
//   (2t+8, 2t+9) ↔ 16kc + 4t + (2, 3) (8-byte loads); bf16 P·V keeps the
//   natural key order (A from the S n-tiles 2kc and 2kc + 1) and reads V
//   with ldmatrix.trans.
// Shared-memory row strides (elements) keep every fragment load free of
// bank conflicts and every row 16-byte aligned for cp.async.
constexpr int TC_WARPS = 4;
constexpr int TC_BM = 16 * TC_WARPS;

template <typename T> constexpr bool kIsF32 = std::is_same<T, float>::value;
// Q and K rows: float HD + 8 (≡ 8 or 24 mod 32 words at every HD taken),
// bf16 HD + 16 elements, or HD + 32 when HD ≡ 16 mod 32 (h 80: a row of 48
// words would put rows g and g + 2 of a half-warp's 8-byte loads on the
// same banks; 56 words ≡ 24 mod 32 keeps the four rows apart).
template <typename T, int HD>
__host__ __device__ constexpr int tc_ldk() {
  return kIsF32<T> ? HD + 8 : (HD % 32 == 16 ? HD + 32 : HD + 16);
}
// V rows: float HD + 4 (≡ 4 mod 32 words), bf16 HD + 8 (an odd number of
// 16-byte units, for ldmatrix).
template <typename T, int HD>
__host__ __device__ constexpr int tc_ldv() { return kIsF32<T> ? HD + 4 : HD + 8; }

// Round a float32 to TF32 (nearest, ties away from zero) with integer
// operations: add half a TF32 ulp, clear the 13 low mantissa bits. (A cvt
// instruction does the same on a slower pipe.) Finite inputs only.
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x ≈ big + small, both TF32 (the residual keeps 21 more bits).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_round(x);
  small = tf32_round(x - __uint_as_float(big));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a·b in 3xTF32: the small cross terms first, then big·big.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bsm)[2]) {
  mma_tf32(d, as, bb[0], bb[1]);
  mma_tf32(d, ab, bsm[0], bsm[1]);
  mma_tf32(d, ab, bb[0], bb[1]);
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// cp.async `n_rows` rows of HD elements (`row_stride` elements apart in
// global memory) into shared `dst` (row stride `ld` elements); rows >=
// valid_rows are zero-filled and read nothing. Called by all NTH threads.
template <typename T, int HD, int NTH = NT>
__device__ __forceinline__ void cp_rows(T* dst, int ld, const T* src,
                                        size_t row_stride, int n_rows,
                                        int valid_rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = HD / VEC;
  for (int i = threadIdx.x; i < n_rows * CPR; i += NTH) {
    const int r = i / CPR;
    const int c = (i - r * CPR) * VEC;
    const bool ok = r < valid_rows;
    cp_async16(dst + r * ld + c, src + (ok ? (size_t)r * row_stride : 0) + c,
               ok);
  }
}

// One warp's 16 query rows: output fragments, and per row (g, g + 8) the
// running max (log2 domain) and this thread's share of the running sum.
template <int HD>
struct TcRows {
  float o[HD / 8][4];
  float m[2];
  float l[2];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
  }
};

// S = Q·Kᵀ for this warp's rows (row0 .. row0 + 15 of Qs) and BN keys.
template <typename T, int HD, int BN>
__device__ __forceinline__ void tc_scores(const T* Qs, const T* Ks, int row0,
                                          float (&s)[BN / 8][4]) {
  constexpr int LD = tc_ldk<T, HD>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  if constexpr (kIsF32<T>) {
    const T* qa = Qs + (row0 + g) * LD + 2 * t;
    const T* kb = Ks + g * LD + 2 * t;
#pragma unroll
    for (int kc = 0; kc < HD / 8; ++kc) {
      const float2 x = *reinterpret_cast<const float2*>(qa + kc * 8);
      const float2 y = *reinterpret_cast<const float2*>(qa + 8 * LD + kc * 8);
      uint32_t ab[4], as[4];
      split_tf32(x.x, ab[0], as[0]);
      split_tf32(y.x, ab[1], as[1]);
      split_tf32(x.y, ab[2], as[2]);
      split_tf32(y.y, ab[3], as[3]);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const float2 z =
            *reinterpret_cast<const float2*>(kb + nt * 8 * LD + kc * 8);
        uint32_t bb[2], bsm[2];
        split_tf32(z.x, bb[0], bsm[0]);
        split_tf32(z.y, bb[1], bsm[1]);
        mma_3xtf32(s[nt], ab, as, bb, bsm);
      }
    }
  } else {
    const T* qa = Qs + (row0 + g) * LD + 4 * t;
    const T* kb = Ks + g * LD + 4 * t;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      const uint2 x = *reinterpret_cast<const uint2*>(qa + kc * 16);
      const uint2 y = *reinterpret_cast<const uint2*>(qa + 8 * LD + kc * 16);
      const uint32_t a[4] = {x.x, y.x, x.y, y.y};
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const uint2 z =
            *reinterpret_cast<const uint2*>(kb + nt * 8 * LD + kc * 16);
        mma_bf16(s[nt], a, z.x, z.y);
      }
    }
  }
}

// O += P·V: P (BN keys) in this warp's S fragments, V [BN][HD] in Vs.
template <typename T, int HD, int BN>
__device__ __forceinline__ void tc_pv(const T* Vs, const float (&p)[BN / 8][4],
                                      float (&o)[HD / 8][4]) {
  constexpr int LD = tc_ldv<T, HD>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (kIsF32<T>) {
#pragma unroll
    for (int kc = 0; kc < BN / 8; ++kc) {
      uint32_t ab[4], as[4];
      split_tf32(p[kc][0], ab[0], as[0]);
      split_tf32(p[kc][2], ab[1], as[1]);
      split_tf32(p[kc][1], ab[2], as[2]);
      split_tf32(p[kc][3], ab[3], as[3]);
      const T* v0 = Vs + (kc * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        uint32_t bb[2], bsm[2];
        split_tf32(v0[dt * 8], bb[0], bsm[0]);
        split_tf32(v0[LD + dt * 8], bb[1], bsm[1]);
        mma_3xtf32(o[dt], ab, as, bb, bsm);
      }
    }
  } else {
    const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      const uint32_t a[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                             pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                             pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                             pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
      const T* vrow = Vs + (kc * 16 + (mi & 1) * 8 + ri) * LD + (mi >> 1) * 8;
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vrow + dp * 16);
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
}

// One online-softmax step of this warp's 16 rows against a key tile of BN
// keys (Ks [BN][tc_ldk], Vs [BN][tc_ldv], staged and synchronised by the
// caller; nothing here writes shared memory). `valid(r, t)`: key t of the
// tile is visible to row r of the CTA (r = row0 + 0..15); masked scores are
// NEG_INF exactly, as in the TPU kernels. With `masked` false every key is
// visible to every row and the predicate is never evaluated.
// scale_log2 = softmax scale · log2(e).
template <typename T, int HD, int BN, typename ValidF>
__device__ __forceinline__ void tc_tile_step(const T* Qs, const T* Ks,
                                             const T* Vs, TcRows<HD>& st,
                                             int row0, float scale_log2,
                                             bool masked, ValidF valid) {
  float s[BN / 8][4];
  tc_scores<T, HD, BN>(Qs, Ks, row0, s);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float mx[2] = {st.m[0], st.m[1]};
  if (masked) {
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = valid(row0 + g + 8 * (e >> 1), nt * 8 + 2 * t + (e & 1))
                            ? s[nt][e] * scale_log2
                            : NEG_INF;
        s[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
  } else {
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] *= scale_log2;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
  }
  float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    corr[i] = exp2f(st.m[i] - mx[i]);
    st.m[i] = mx[i];
  }
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[nt][e] - mx[e >> 1]);
      s[nt][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) st.l[i] = st.l[i] * corr[i] + sum[i];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    st.o[dt][0] *= corr[0];
    st.o[dt][1] *= corr[0];
    st.o[dt][2] *= corr[1];
    st.o[dt][3] *= corr[1];
  }
  tc_pv<T, HD, BN>(Vs, s, st.o);
}

// out[r][d] = o / max(l, 1e-30) for this warp's rows r < R (row r of `out`
// is CTA row r). All lanes of the warp must call it.
template <typename T, int HD>
__device__ __forceinline__ void tc_store_rows(T* out, TcRows<HD>& st, int row0,
                                              int R) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = st.l[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int r = row0 + g + 8 * i;
    if (r >= R) continue;
    T* row = out + (size_t)r * HD + 2 * t;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      const float a = st.o[dt][2 * i] / l, b = st.o[dt][2 * i + 1] / l;
      if constexpr (kIsF32<T>) {
        *reinterpret_cast<float2*>(row + dt * 8) = make_float2(a, b);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(row + dt * 8) =
            __floats2bfloat162_rn(a, b);
      }
    }
  }
}

// ---- split-KV decode (paged_decode, sink_decode) ------------------------
//
// A decode CTA holds G ≤ dec_gmax<HD>() query rows of one GQA group
// (float32, row stride HD + 4: the whole group, or one of its row groups,
// which the callers' grids add as a further axis and which each re-read the
// kv head) and walks a run of KV "chunks" (at most dec_tr<HD>() consecutive
// rows: of one arena block for paged_decode, of the dense cache for
// sink_decode).
// Its DEC_WARPS warps take the chunks in turn; each warp double-buffers its
// chunks with cp.async (`decode_stage_rows`, which both callers hand a row
// base and a row stride) and keeps its own online-softmax state: M, L, C
// [G] in shared memory, acc in registers (lane owns d = lane · VD + 0 ..
// VD − 1 of each row, VD = dec_vd<HD>() = ceil(HD / 32), masked past HD).
// `decode_split_attend` is the CTA's walk;
// `decode_merge` folds the warps' states by log-sum-exp, `decode_combine`
// (`lse_combine`) the splits of a split grid the same way. A warp or split that saw
// no key has m = NEG_INF, l = 0, acc = 0 and adds exactly nothing next to
// one that did.
constexpr int DEC_WARPS = 4;
constexpr int DEC_STAGES = 2;
// Rows per chunk: 16, and 8 at HD = 256, where a 16-row float32 stage
// (33 KB) times DEC_STAGES · DEC_WARPS would pass the 227 KB a CTA may
// take; the 8-row stages keep the CTA's bytes those of HD = 128.
template <int HD>
__host__ __device__ constexpr int dec_tr() { return HD > 128 ? 8 : 16; }
// Query rows a decode CTA holds: a lane keeps dec_vd<HD>() accumulators of
// each, MAXR·NT/HD rows keep that at 64 registers (16 at HD = 128, 8 at
// 256; 25 rows of 3 at HD = 80, 21 of 3 at 96).
template <int HD>
__host__ __device__ constexpr int dec_gmax() { return MAXR * NT / HD; }
// Output channels a lane owns in P·V and the merge: d = lane·VD .. lane·VD
// + VD − 1, VD = ceil(HD / 32). At HD = 80 that is 3 channels for lanes 0-25
// (lane 26 holds 78-79, the channels past HD are masked), so no channel of
// 64-79 is left out, as HD / 32 = 2 would leave them.
template <int HD>
__host__ __device__ constexpr int dec_vd() { return (HD + 31) / 32; }
template <int HD>
__host__ __device__ constexpr bool dec_exact() { return HD % 32 == 0; }

// One warp's staging buffer for a chunk of TR rows: K [TR][HD + 16 bytes]
// (the pad keeps the score loop's row-wise reads conflict-free), V [TR][HD],
// and for int8 pages the block's scale rows (seal scales [HD] and this
// chunk's token scales [TR], for K and for V).
template <typename KV, int HD>
struct DecStage {
  static constexpr int TR = dec_tr<HD>();
  static constexpr int LDK = HD + 16 / (int)sizeof(KV);
  static __host__ __device__ size_t bytes() {
    size_t b = (size_t)TR * (LDK + HD) * sizeof(KV);
    if (kInt8Kv<KV>) b += sizeof(float) * (2 * HD + 2 * TR);
    return (b + 15) / 16 * 16;
  }
  KV* K;
  KV* V;
  float *ksc, *vsc, *ktk, *vtk;
  __device__ __forceinline__ explicit DecStage(unsigned char* base) {
    K = reinterpret_cast<KV*>(base);
    V = K + TR * LDK;
    ksc = reinterpret_cast<float*>(V + TR * HD);
    vsc = ksc + HD;
    ktk = vsc + HD;
    vtk = ktk + TR;
  }
};

// Issue (no wait) this warp's cp.async of `rows` K and V rows into a stage:
// row r of the chunk is at krow + r·kstride and vrow + r·vstride (elements;
// HD contiguous, every row 16-byte aligned).
template <typename KV, int HD>
__device__ __forceinline__ void decode_stage_rows(const DecStage<KV, HD>& st,
                                                  const KV* __restrict__ krow,
                                                  const KV* __restrict__ vrow,
                                                  size_t kstride,
                                                  size_t vstride, int rows) {
  constexpr int VEC = 16 / sizeof(KV);
  constexpr int CPR = HD / VEC;
  constexpr int LDK = DecStage<KV, HD>::LDK;
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < rows * CPR; i += 32) {
    const int r = i / CPR;
    const int c = (i - r * CPR) * VEC;
    cp_async16(st.K + r * LDK + c, krow + (size_t)r * kstride + c);
    cp_async16(st.V + r * HD + c, vrow + (size_t)r * vstride + c);
  }
}

// The paged caller's stage: `rows` rows from row r0 of block `phys` (kv
// head kh) of the arenas [N, K, bs, HD]; int8 arenas also bring the block's
// scale rows ks/vs [N, K, HD] and rows r0.. of kt/vt [N, K, bs].
template <typename KV, int HD>
__device__ __forceinline__ void decode_stage_issue(
    const DecStage<KV, HD>& st, const KV* __restrict__ kp,
    const KV* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ kt, const float* __restrict__ vs,
    const float* __restrict__ vt, int phys, int K, int kh, int bs, int r0,
    int rows) {
  const size_t blk = (size_t)phys * K + kh;
  const size_t base = (blk * bs + r0) * HD;
  decode_stage_rows<KV, HD>(st, kp + base, vp + base, HD, HD, rows);
  if constexpr (kInt8Kv<KV>) {
    const int lane = threadIdx.x & 31;
    for (int i = lane; i < HD / 4; i += 32) {
      cp_async16(st.ksc + 4 * i, ks + blk * HD + 4 * i);
      cp_async16(st.vsc + 4 * i, vs + blk * HD + 4 * i);
    }
    for (int i = lane; i < rows; i += 32) {
      cp_async4(st.ktk + i, kt + blk * bs + r0 + i);
      cp_async4(st.vtk + i, vt + blk * bs + r0 + i);
    }
  }
}

// One warp's online-softmax step of the G rows of Qs against the `rows`
// keys of a staged chunk (synchronised by the caller: wait + __syncwarp).
// Scores: each lane takes whole (row, key) dot products, q from Qs and k
// dequantized as it is read (int8: q · (sc[c] != 0 ? sc[c] : tk[r]), the
// one float32 product of load_kv_tile); `valid(t)` says whether key t of
// the chunk is visible (masked scores are NEG_INF). Softmax: lane r < G owns
// row r. P·V: each lane its dec_vd<HD>() columns of every row (masked past
// HD). P, M, L, C are this
// warp's [G·TR], [G], [G], [G] in shared memory (TR = dec_tr<HD>()). Ends
// with __syncwarp, so the caller may refill the stage right after it
// returns.
template <typename KV, int HD, int GMAX, typename ValidF>
__device__ __forceinline__ void decode_block_step(
    const float* Qs, const DecStage<KV, HD>& st, float* P, float* M, float* L,
    float* C, float (&acc)[GMAX][dec_vd<HD>()], int G, int rows,
    float scale_log2, ValidF valid) {
  constexpr int LDQ = HD + 4;
  constexpr int LDK = DecStage<KV, HD>::LDK;
  constexpr int CH = 16 / sizeof(KV);   // elements per 16-byte load
  constexpr int VD = dec_vd<HD>();
  static_assert(32 * VD >= HD && 32 * (VD - 1) < HD,
                "the lanes' channels must cover HD");
  static_assert(HD % CH == 0, "a row must be whole 16-byte loads");
  constexpr int TR = DecStage<KV, HD>::TR;
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < G * rows; i += 32) {
    const int r = i / rows, t = i - r * rows;
    const float* qr = Qs + r * LDQ;
    const KV* kr = st.K + t * LDK;
    float s4[4] = {0.f, 0.f, 0.f, 0.f};   // four chains: latency, not one
                                          // 128-long dependent FMA chain
#pragma unroll 2
    for (int c = 0; c < HD; c += CH) {
      float k[CH];
      ld_f32<KV, CH>(kr + c, k);
      if constexpr (kInt8Kv<KV>) {
        const float tk = st.ktk[t];
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const float sc = st.ksc[c + u];
          k[u] *= sc != 0.f ? sc : tk;
        }
      }
#pragma unroll
      for (int u = 0; u < CH; u += 4) {
        const float4 q = *reinterpret_cast<const float4*>(qr + c + u);
        s4[0] = fmaf(q.x, k[u], s4[0]);
        s4[1] = fmaf(q.y, k[u + 1], s4[1]);
        s4[2] = fmaf(q.z, k[u + 2], s4[2]);
        s4[3] = fmaf(q.w, k[u + 3], s4[3]);
      }
    }
    const float s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
    P[r * TR + t] = valid(t) ? s * scale_log2 : NEG_INF;
  }
  __syncwarp();
  for (int r = lane; r < G; r += 32) {
    float* p = P + r * TR;
    const float m_prev = M[r];
    float x[TR];                         // the row in registers: one
#pragma unroll                           // batch of loads, no chain
    for (int t = 0; t < TR; ++t) x[t] = t < rows ? p[t] : NEG_INF;
    float mx = m_prev;
#pragma unroll
    for (int t = 0; t < TR; ++t) mx = fmaxf(mx, x[t]);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      if (t < rows) {
        const float e = exp2f(x[t] - mx);
        p[t] = e;
        sum += e;
      }
    }
    const float corr = exp2f(m_prev - mx);
    L[r] = L[r] * corr + sum;
    M[r] = mx;
    C[r] = corr;
  }
  __syncwarp();
  const int d0 = lane * VD;
#pragma unroll
  for (int r = 0; r < GMAX; ++r) {
    if (r < G) {
      const float c = C[r];
#pragma unroll
      for (int u = 0; u < VD; ++u) acc[r][u] *= c;
    }
  }
#pragma unroll 4
  for (int t = 0; t < rows; ++t) {
    float v[VD];
    if constexpr (dec_exact<HD>()) {
      ld_f32<KV, VD>(st.V + t * HD + d0, v);
    } else {
      // the tail lanes' channels past HD read nothing and stay 0
#pragma unroll
      for (int u = 0; u < VD; ++u)
        v[u] = d0 + u < HD ? to_f32<KV>(st.V[t * HD + d0 + u]) : 0.f;
    }
    if constexpr (kInt8Kv<KV>) {
      const float tk = st.vtk[t];
#pragma unroll
      for (int u = 0; u < VD; ++u) {
        const float sc = d0 + u < HD ? st.vsc[d0 + u] : 0.f;
        v[u] *= sc != 0.f ? sc : tk;
      }
    }
#pragma unroll
    for (int r = 0; r < GMAX; ++r) {
      if (r < G) {
        const float p = P[r * TR + t];
#pragma unroll
        for (int u = 0; u < VD; ++u) acc[r][u] = fmaf(p, v[u], acc[r][u]);
      }
    }
  }
  __syncwarp();
}

// Fold the DEC_WARPS warps' states of a CTA by log-sum-exp. Mall/Lall
// [DEC_WARPS][G] hold each warp's M and L; Oall [DEC_WARPS][G][HD] is
// scratch (it may alias the warps' stages: the caller has synchronised
// after the last step). emit(r, d, m, l, acc) receives, for every row r < G
// and column d, the CTA's max, sum and unnormalised output; m and l are the
// same for every d of a row.
template <int HD, int GMAX, typename EmitF>
__device__ __forceinline__ void decode_merge(
    const float (&acc)[GMAX][dec_vd<HD>()], const float* Mall,
    const float* Lall, float* Oall, int G, EmitF emit) {
  constexpr int VD = dec_vd<HD>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < GMAX; ++r) {
    if (r < G) {
#pragma unroll
      for (int u = 0; u < VD; ++u)
        if (dec_exact<HD>() || lane * VD + u < HD)
          Oall[((size_t)warp * G + r) * HD + lane * VD + u] = acc[r][u];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += NT) {
    const int r = i / HD, d = i - r * HD;
    float m = NEG_INF;
    for (int w = 0; w < DEC_WARPS; ++w) m = fmaxf(m, Mall[w * G + r]);
    float l = 0.f, o = 0.f;
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float e = exp2f(Mall[w * G + r] - m);
      l += e * Lall[w * G + r];
      o += e * Oall[((size_t)w * G + r) * HD + d];
    }
    emit(r, d, m, l, o);
  }
}

// out[r][d] = Σ_s e^{m_s − M}·acc_s / max(Σ_s e^{m_s − M}·l_s, 1e-30) over
// the n splits of one (sequence, kv head), for one row r and column d (one
// thread each): m/l [n][G], acc [n][G][HD], float32, m in the log2 domain.
// A split that saw no key (l = 0) adds nothing, and its acc is not read.
// The split loops are unrolled so their loads are in flight together.
template <typename T, int HD>
__device__ __forceinline__ void lse_combine(const float* m, const float* l,
                                            const float* acc, T* out, int G,
                                            int n, int r, int d) {
  float M = NEG_INF;
#pragma unroll 8
  for (int s = 0; s < n; ++s) M = fmaxf(M, m[s * G + r]);
  float den = 0.f, num = 0.f;
#pragma unroll 8
  for (int s = 0; s < n; ++s) {
    const float e = exp2f(m[s * G + r] - M), ls = l[s * G + r];
    den = fmaf(e, ls, den);
    if (ls > 0.f) num = fmaf(e, acc[((size_t)s * G + r) * HD + d], num);
  }
  out[(size_t)r * HD + d] = from_f32<T>(num / fmaxf(den, 1e-30f));
}

// Shared memory of a decode CTA of G rows: a head of Qs [G][HD + 4] | M, L,
// C [DEC_WARPS][G] | P [DEC_WARPS][G][dec_tr] (floats, padded to 16 bytes),
// then the warps' stages [DEC_WARPS][DEC_STAGES], or, after the walk, the
// merge scratch [DEC_WARPS][G][HD] in their place.
template <int HD>
__host__ __device__ inline size_t decode_head_bytes(int G) {
  const size_t b = sizeof(float) * ((size_t)G * (HD + 4) +
                                    3 * DEC_WARPS * (size_t)G +
                                    (size_t)DEC_WARPS * G * dec_tr<HD>());
  return (b + 15) / 16 * 16;
}
template <typename KV, int HD>
inline size_t decode_smem_bytes(int G) {
  const size_t stages = DEC_WARPS * DEC_STAGES * DecStage<KV, HD>::bytes();
  const size_t merge = sizeof(float) * DEC_WARPS * (size_t)G * HD;
  return decode_head_bytes<HD>(G) + (stages > merge ? stages : merge);
}

// The body of a split-KV decode CTA. q and out point at its G ≤
// dec_gmax<HD>() rows of [.., HD] (a GQA group, or a row group of one); it
// walks chunks 0 .. n_chunks − 1 of its split: issue(stage,
// c) starts chunk c's cp.async copies (decode_stage_rows), chunk(c) gives
// (first slot, rows) of chunk c; slot s is visible when s < limit. With ws
// null the CTA writes out; otherwise its partial state (m in the log2
// domain, l, unnormalised acc) goes to rows wrow .. wrow + G − 1 of the
// workspace: m [rows], l [rows], acc [rows][HD] (rows = ws_rows), for
// `decode_combine`.
template <typename T, typename KV, int HD, typename IssueF, typename ChunkF>
__device__ __forceinline__ void decode_split_attend(
    const T* __restrict__ q, T* __restrict__ out, float* __restrict__ ws,
    size_t ws_rows, size_t wrow, int G, int n_chunks, int limit,
    float scale_log2, IssueF issue, ChunkF chunk) {
  constexpr int GMAX = dec_gmax<HD>();
  constexpr int TR = dec_tr<HD>();
  constexpr int VD = dec_vd<HD>();
  extern __shared__ __align__(16) unsigned char dec_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Qs = reinterpret_cast<float*>(dec_smem);
  float* Mall = Qs + G * (HD + 4);
  float* Lall = Mall + DEC_WARPS * G;
  float* Call = Lall + DEC_WARPS * G;
  float* Pall = Call + DEC_WARPS * G;
  unsigned char* tail = dec_smem + decode_head_bytes<HD>(G);
  unsigned char* wstages = tail + warp * DEC_STAGES * DecStage<KV, HD>::bytes();
  auto stage = [&](int st) {
    return DecStage<KV, HD>(wstages + st * DecStage<KV, HD>::bytes());
  };
  float* M = Mall + warp * G;
  float* L = Lall + warp * G;
  float* C = Call + warp * G;
  float* P = Pall + warp * G * TR;

  // chunk c is walked by warp c % DEC_WARPS; its first chunk is in flight
  // while q loads
  int c = warp;
  if (c < n_chunks) issue(stage(0), c);
  cp_async_commit();
  load_tile<T, HD>(Qs, HD + 4, q, G, G);
  for (int r = lane; r < G; r += 32) {
    M[r] = NEG_INF;
    L[r] = 0.f;
  }
  float acc[GMAX][VD];
#pragma unroll
  for (int r = 0; r < GMAX; ++r)
#pragma unroll
    for (int u = 0; u < VD; ++u) acc[r][u] = 0.f;
  __syncthreads();

  for (int it = 0; c < n_chunks; ++it, c += DEC_WARPS) {
    const int cn = c + DEC_WARPS;
    if (cn < n_chunks) issue(stage((it + 1) & 1), cn);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const int2 ch = chunk(c);
    decode_block_step<KV, HD, GMAX>(Qs, stage(it & 1), P, M, L, C, acc, G,
                                    ch.y, scale_log2,
                                    [=](int t) { return ch.x + t < limit; });
  }
  cp_async_wait<0>();
  __syncthreads();                       // stages become the merge scratch

  float* ws_l = ws + ws_rows;
  float* ws_acc = ws + 2 * ws_rows;
  decode_merge<HD, GMAX>(
      acc, Mall, Lall, reinterpret_cast<float*>(tail), G,
      [&](int r, int d, float m, float l, float o) {
        if (ws == nullptr) {
          out[(size_t)r * HD + d] = from_f32<T>(o / fmaxf(l, 1e-30f));
        } else {
          ws_acc[(wrow + r) * HD + d] = o;
          if (d == 0) {
            ws[wrow + r] = m;
            ws_l[wrow + r] = l;
          }
        }
      });
}

// Merge the n_split partial states of decode_split_attend: grid (B·K, G),
// one thread per column; the workspace rows of (b, kh) are bk·nsp·G ..
// (bk + 1)·nsp·G − 1 (split-major; each row group writes its own rows).
template <typename T, int HD>
__device__ __forceinline__ void decode_combine(const float* __restrict__ ws,
                                               T* __restrict__ out, int BK,
                                               int G, int nsp) {
  const size_t bk = blockIdx.x;
  const size_t rows = (size_t)BK * nsp * G;
  lse_combine<T, HD>(ws + bk * nsp * G, ws + rows + bk * nsp * G,
                     ws + 2 * rows + bk * nsp * G * HD, out + bk * G * HD, G,
                     nsp, blockIdx.y, threadIdx.x);
}

// ---- paged-history tensor-core routine (paged_prefill, spec_verify) -----
//
// A CTA of W warps holds BM = 16·W query rows of one (sequence b, kv head
// kh): rows r0 .. r0 + BM − 1 of q [B, K, S·G, h], row r being chunk token
// r / G (GQA rows of one group share every key tile). It walks, through
// `tc_tile_step`, key tiles of BN keys from two sources:
//   1. its split's share of the resident history: table entries
//      [sp·per, (sp+1)·per) of row b, cut at the residency ceil(off / bs)
//      (entries past it alias the null block and are never read) and at
//      key `off`;
//   2. on the last split only, the chunk's own keys k_new/v_new
//      [B, K, S, h], keys u < n_keys.
// A history tile may span several table entries (a bf16 tile of 64 keys
// spans four blocks of 16); each row is staged from its own physical
// block. float / bf16 pages go by cp.async straight into the tile,
// double-buffered: tile i + 1 is in flight while tile i is scored. int8
// pages cannot: their payload, their token scales and the channel scale
// rows of the blocks a tile touches go by cp.async into a raw stage
// (double-buffered), and are dequantized through registers into the tile
// (`ph_dequant`) — one float32 product per element, q · (sc[c] != 0 ?
// sc[c] : tk[r]), decided per channel, as the plain version computes it —
// then written in the tile's type (bf16 tiles round it to bf16). The split
// plan comes from shapes alone (the host never reads off, chunk_len or
// n_tok). With one split the CTA writes its rows; otherwise it writes its
// partial state (m in the log2 domain, l, unnormalised acc; float32) to a
// workspace that `lse_combine` folds. A split with no resident block and
// not the chunk writes m = NEG_INF and l = 0 (and no acc, which the merge
// then never reads): it adds exactly nothing.
//
// Shared memory: Qs [BM][tc_ldk] | tile 0 {K [BN][tc_ldk], V [BN][tc_ldv]}
// | area: tile 1 (float / bf16 pages), or two int8 raw stages (at least one
// tile's bytes, so the chunk walk takes tile 0 and the area as its two
// stages).

// Keys per tile: 16 in float32 (12-15 % faster than 32 at the main chunk
// and verify window, the same at long histories; three CTAs per SM), 64 in
// bf16.
template <typename T>
__host__ __device__ constexpr int ph_bn() { return kIsF32<T> ? 16 : 64; }

template <typename T, int HD, int BN>
__host__ __device__ constexpr int ph_tile_elems() {
  return BN * (tc_ldk<T, HD>() + tc_ldv<T, HD>());
}

// Channel-scale slots of an int8 raw stage: the blocks BN consecutive keys
// can touch.
__host__ __device__ inline int ph_slots(int BN, int bs) {
  const int s = (BN - 1) / bs + 2;
  return s < BN ? s : BN;
}

// One int8 raw stage: payload K, V [BN][HD] int8; channel scale rows K, V
// [slots][HD] and token scales K, V [BN], float32.
template <int HD, int BN>
struct PhRaw {
  static __host__ __device__ size_t bytes(int bs) {
    return 2 * (size_t)BN * HD +
           sizeof(float) * (2 * (size_t)ph_slots(BN, bs) * HD + 2 * BN);
  }
  int8_t *K, *V;
  float *ksc, *vsc, *ktk, *vtk;
  __device__ __forceinline__ PhRaw(unsigned char* base, int bs) {
    const int slots = ph_slots(BN, bs);
    K = reinterpret_cast<int8_t*>(base);
    V = K + BN * HD;
    ksc = reinterpret_cast<float*>(V + BN * HD);
    vsc = ksc + slots * HD;
    ktk = vsc + slots * HD;
    vtk = ktk + BN;
  }
};

template <typename T, typename KV, int HD, int BM, int BN>
__host__ __device__ inline size_t ph_smem_bytes(int bs) {
  const size_t q = sizeof(T) * (size_t)BM * tc_ldk<T, HD>();
  const size_t tile = sizeof(T) * (size_t)ph_tile_elems<T, HD, BN>();
  if (!kInt8Kv<KV>) return q + 2 * tile;
  const size_t raw = 2 * PhRaw<HD, BN>::bytes(bs);
  return q + tile + (raw > tile ? raw : tile);
}

// Everything a paged-history CTA reads and writes. T: q, out and the
// chunk's keys (float / bf16); KV: the pages (T, or int8_t with the scale
// plane ks/vs [N, K, h], kt/vt [N, K, bs]; null otherwise).
template <typename T, typename KV>
struct PhArgs {
  const T *q, *kn, *vn;
  const KV *kp, *vp;
  const float *ks, *kt, *vs, *vt;
  const int* tables;                 // [B, nb]
  T* out;
  float* ws;                         // per (b, kh): m, l [n_split][S·G],
                                     // acc [n_split][S·G][HD]
  int K, S, G, bs, nb, per;
  float scale_log2;                  // softmax scale · log2(e)
};

// Walk n tiles double-buffered: issue(stage, i) starts tile i's cp.async
// copies, step(stage, i) consumes it. All threads of the CTA call it; n is
// uniform over the CTA.
template <typename IssueF, typename StepF>
__device__ __forceinline__ void ph_walk(int n, IssueF issue, StepF step) {
  if (n > 0) issue(0, 0);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) issue((i + 1) & 1, i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    step(i & 1, i);
    __syncthreads();                     // the stage is refilled next
  }
}

// 4 dequantized elements into a tile row.
template <typename T>
__device__ __forceinline__ void ph_put4(T* o, const float (&f)[4]) {
  if constexpr (kIsF32<T>)
    *reinterpret_cast<float4*>(o) = make_float4(f[0], f[1], f[2], f[3]);
  else
    *reinterpret_cast<uint2*>(o) =
        make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
}

// Dequantize an int8 raw stage (tile keys k0 .., nv present) into the tile
// K [BN][tc_ldk], V [BN][tc_ldv]: element (r, c) = q · (sc[c] != 0 ?
// sc[c] : tk[r]), one float32 product; absent rows are zeros. Thread x
// owns channels 4·(x mod HD/4) .. + 3 of every (NTH·4/HD)-th row, so a warp
// reads and writes contiguous row segments (no bank conflicts; 16-byte
// chunks per thread conflicted 4–8 ways and cost the long chunk 10 %).
template <typename T, int HD, int BN, int NTH>
__device__ __forceinline__ void ph_dequant(T* Ks, const PhRaw<HD, BN>& w,
                                           int k0, int nv, int bs) {
  constexpr int LDK = tc_ldk<T, HD>(), LDV = tc_ldv<T, HD>();
  constexpr int CG = HD / 4;             // 4-channel groups per row
  constexpr int RS = NTH / CG;           // rows per pass
  static_assert(NTH % CG == 0 && BN % RS == 0, "whole rows per pass");
  T* Vs = Ks + BN * LDK;
  const int c = 4 * (threadIdx.x % CG), b0 = k0 / bs;
#pragma unroll
  for (int j = 0; j < BN / RS; ++j) {
    const int r = threadIdx.x / CG + j * RS;
    float kf[4] = {0.f, 0.f, 0.f, 0.f}, vf[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < nv) {
      const int sl = (k0 + r) / bs - b0;
      const float4 ks = *reinterpret_cast<const float4*>(w.ksc + sl * HD + c);
      const float4 vs = *reinterpret_cast<const float4*>(w.vsc + sl * HD + c);
      const float kt = w.ktk[r], vt = w.vtk[r];
      const char4 kq = *reinterpret_cast<const char4*>(w.K + r * HD + c);
      const char4 vq = *reinterpret_cast<const char4*>(w.V + r * HD + c);
      kf[0] = (float)kq.x * (ks.x != 0.f ? ks.x : kt);
      kf[1] = (float)kq.y * (ks.y != 0.f ? ks.y : kt);
      kf[2] = (float)kq.z * (ks.z != 0.f ? ks.z : kt);
      kf[3] = (float)kq.w * (ks.w != 0.f ? ks.w : kt);
      vf[0] = (float)vq.x * (vs.x != 0.f ? vs.x : vt);
      vf[1] = (float)vq.y * (vs.y != 0.f ? vs.y : vt);
      vf[2] = (float)vq.z * (vs.z != 0.f ? vs.z : vt);
      vf[3] = (float)vq.w * (vs.w != 0.f ? vs.w : vt);
    }
    ph_put4<T>(Ks + r * LDK + c, kf);
    ph_put4<T>(Vs + r * LDV + c, vf);
  }
}

// This warp's partial state of its rows r < R (CTA rows; row r0 + r of the
// sequence's S·G) for split sp of nsp, into the workspace wb of its
// (b, kh); acc only if the split walked a key (l > 0). All lanes of the
// warp call it.
template <int HD>
__device__ __forceinline__ void tc_store_partial(float* wb, TcRows<HD>& st,
                                                 int row0, int R, int r0,
                                                 int SG, int sp, int nsp,
                                                 bool walked) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t n = (size_t)nsp * SG;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = st.l[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = row0 + g + 8 * i;
    if (r >= R) continue;
    const size_t row = (size_t)sp * SG + r0 + r;
    if (t == 0) {
      wb[row] = st.m[i];
      wb[n + row] = l;
    }
    if (!walked) continue;
    float* acc = wb + 2 * n + row * HD + 2 * t;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<float2*>(acc + dt * 8) =
          make_float2(st.o[dt][2 * i], st.o[dt][2 * i + 1]);
  }
}

// The routine: rows r0.. of (b, kh), split sp of nsp, history of `off`
// tokens, the chunk's first n_keys keys (last split). hist_ok(r, key):
// history key `key` (absolute position, < off) is visible to CTA row r;
// chunk_ok(r, u): chunk key u is. hist_visible: every resident history key
// is visible to every row (no window), so whole tiles skip the mask.
template <typename T, typename KV, int HD, int W, int BN, typename HistF,
          typename ChunkF>
__device__ __forceinline__ void paged_tc_attend(const PhArgs<T, KV>& a,
                                                int b, int kh, int r0,
                                                int sp, int nsp, int off,
                                                int n_keys, bool hist_visible,
                                                HistF hist_ok,
                                                ChunkF chunk_ok) {
  constexpr int BM = 16 * W, NTH = 32 * W;
  constexpr int LDK = tc_ldk<T, HD>(), LDV = tc_ldv<T, HD>();
  extern __shared__ __align__(16) unsigned char ph_smem[];
  T* Qs = reinterpret_cast<T*>(ph_smem);
  T* tile0 = Qs + BM * LDK;
  unsigned char* area =
      reinterpret_cast<unsigned char*>(tile0 + ph_tile_elems<T, HD, BN>());
  auto tile = [&](int s) { return s ? reinterpret_cast<T*>(area) : tile0; };
  const int SG = a.S * a.G;
  const int R = min(BM, SG - r0);
  const int bk = b * a.K + kh;
  const size_t qoff = ((size_t)bk * SG + r0) * HD;
  const int row0 = (threadIdx.x >> 5) * 16;

  cp_rows<T, HD, NTH>(Qs, LDK, a.q + qoff, HD, BM, R);
  cp_async_commit();
  TcRows<HD> st;
  st.init();

  // 1. this split's resident history: keys [k_lo, k_hi)
  const int bs = a.bs;
  const int nres = min((off + bs - 1) / bs, a.nb);
  const int j0 = sp * a.per;
  const int j1 = min(j0 + a.per, nres);
  const int k_lo = j0 * bs;
  const int k_hi = min(j1 * bs, off);
  const int n_hist = k_hi > k_lo ? (k_hi - k_lo + BN - 1) / BN : 0;
  const int* tbl = a.tables + (size_t)b * a.nb;
  auto block_of = [&](int key) {         // (phys · K + kh), key < k_hi
    return (size_t)tbl[key / bs] * a.K + kh;
  };
  auto hist_step = [&](const T* Ks, int k0) {
    tc_tile_step<T, HD, BN>(Qs, Ks, Ks + BN * LDK, st, row0, a.scale_log2,
                            !hist_visible || k0 + BN > k_hi,
                            [=](int r, int t) {
                              const int key = k0 + t;
                              return key < k_hi && hist_ok(r, key);
                            });
  };
  if constexpr (!kInt8Kv<KV>) {
    constexpr int VEC = 16 / sizeof(T), CPR = HD / VEC;
    ph_walk(
        n_hist,
        [&](int s, int i) {
          const int k0 = k_lo + i * BN, nv = min(BN, k_hi - k0);
          T* Ks = tile(s);
          for (int x = threadIdx.x; x < BN * CPR; x += NTH) {
            const int r = x / CPR, c = (x - r * CPR) * VEC;
            const bool ok = r < nv;
            const size_t src =
                ok ? (block_of(k0 + r) * bs + (k0 + r) % bs) * HD + c : 0;
            cp_async16(Ks + r * LDK + c, a.kp + src, ok);
            cp_async16(Ks + BN * LDK + r * LDV + c, a.vp + src, ok);
          }
        },
        [&](int s, int i) { hist_step(tile(s), k_lo + i * BN); });
  } else {
    constexpr int C8 = HD / 16;          // 16-byte chunks of an int8 row
    const size_t raw_bytes = PhRaw<HD, BN>::bytes(bs);
    ph_walk(
        n_hist,
        [&](int s, int i) {
          const int k0 = k_lo + i * BN, nv = min(BN, k_hi - k0);
          const PhRaw<HD, BN> w(area + s * raw_bytes, bs);
          for (int x = threadIdx.x; x < BN * C8; x += NTH) {
            const int r = x / C8, c = (x - r * C8) * 16;
            const bool ok = r < nv;
            const size_t src =
                ok ? (block_of(k0 + r) * bs + (k0 + r) % bs) * HD + c : 0;
            cp_async16(w.K + r * HD + c, a.kp + src, ok);
            cp_async16(w.V + r * HD + c, a.vp + src, ok);
          }
          const int b0 = k0 / bs, n_sl = (k0 + nv - 1) / bs - b0 + 1;
          for (int x = threadIdx.x; x < n_sl * (HD / 4); x += NTH) {
            const int sl = x / (HD / 4), c = (x - sl * (HD / 4)) * 4;
            const size_t src = block_of((b0 + sl) * bs) * HD + c;
            cp_async16(w.ksc + sl * HD + c, a.ks + src);
            cp_async16(w.vsc + sl * HD + c, a.vs + src);
          }
          for (int r = threadIdx.x; r < nv; r += NTH) {
            const size_t src = block_of(k0 + r) * bs + (k0 + r) % bs;
            cp_async4(w.ktk + r, a.kt + src);
            cp_async4(w.vtk + r, a.vt + src);
          }
        },
        [&](int s, int i) {
          const int k0 = k_lo + i * BN;
          ph_dequant<T, HD, BN, NTH>(tile0,
                                     PhRaw<HD, BN>(area + s * raw_bytes, bs),
                                     k0, min(BN, k_hi - k0), bs);
          __syncthreads();
          hist_step(tile0, k0);
        });
  }

  // 2. the chunk's own keys, on the last split
  n_keys = sp == nsp - 1 ? min(n_keys, a.S) : 0;
  if (n_keys > 0) {
    const size_t kvoff = (size_t)bk * a.S * HD;
    ph_walk(
        (n_keys + BN - 1) / BN,
        [&](int s, int i) {
          const int u0 = i * BN, nv = min(BN, n_keys - u0);
          T* Ks = tile(s);
          cp_rows<T, HD, NTH>(Ks, LDK, a.kn + kvoff + (size_t)u0 * HD, HD, BN,
                              nv);
          cp_rows<T, HD, NTH>(Ks + BN * LDK, LDV,
                              a.vn + kvoff + (size_t)u0 * HD, HD, BN, nv);
        },
        [&](int s, int i) {
          const int u0 = i * BN;
          const T* Ks = tile(s);
          tc_tile_step<T, HD, BN>(Qs, Ks, Ks + BN * LDK, st, row0,
                                  a.scale_log2, true, [=](int r, int t) {
                                    const int u = u0 + t;
                                    return u < n_keys && chunk_ok(r, u);
                                  });
        });
  }
  cp_async_wait<0>();                    // q's copy when no tile was walked

  if (nsp == 1)
    tc_store_rows<T, HD>(a.out + qoff, st, row0, R);
  else
    tc_store_partial<HD>(a.ws + (size_t)bk * nsp * SG * (HD + 2), st, row0,
                         R, r0, SG, sp, nsp, n_hist > 0 || n_keys > 0);
}

// Fold the n_split partial states of one (b, kh) — grid (B·K, S·G), one
// thread per column d (blockDim HD) — into out [B, K, S·G, h].
template <typename T, int HD>
__device__ __forceinline__ void ph_combine(const float* ws, T* out, int SG,
                                           int nsp) {
  const size_t n = (size_t)nsp * SG;
  const float* wb = ws + blockIdx.x * n * (HD + 2);
  lse_combine<T, HD>(wb, wb + n, wb + 2 * n,
                     out + (size_t)blockIdx.x * SG * HD, SG, nsp, blockIdx.y,
                     threadIdx.x);
}

}  // namespace paged
