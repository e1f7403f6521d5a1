// Slot-batched grouped matmul with per-slot valid rows on Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces the TPU kernel `moe_gmm` in src/repro/kernels/moe_gmm.py
// (pl.pallas_call at :66; adapter ops.py:123): the expert FFN of an MoE
// layer after OmniPlacement dispatch,
//   out[s, c, :] = x[s, c, :] @ w[s]   for c < n_valid[s],   0 otherwise,
// x [S, C, D], w [S, D, F], n_valid [S] int32, out [S, C, F]; float32 or
// bfloat16 in and out (out has x's dtype), float32 accumulation.
//
// What bounds it on the card: bytes. At decode a slot holds a handful of
// tokens (C = 8 capacity rows, 1-2 of them valid, 16-21 of 60 slots live),
// so each live slot's D x F weight block is read once for ~2-4 flops per
// weight; a prefill chunk (C = 24, ~8 valid rows a slot) stays below the
// card's ~20 float32 flops per byte too. The work that counts is reading
// each LIVE slot's weights once, at the full memory rate, and nothing else:
//   * a persistent grid from shapes alone (kernels/moe_gmm.py::gmm_ctas:
//     four CTAs per SM, fewer when the shapes hold fewer work items), so
//     the host never reads n_valid. Every CTA reads n_valid (S ints) and
//     lists the live work items itself, in slot order: (slot, 32-row tile
//     below n_valid, 64-column tile of F); CTA b takes items b, b + grid,
//     ... . The weight stream is spread over the whole card whichever
//     slots are live, and a slot with n_valid = 0 has no item: its x and w
//     are never read;
//   * rows at or past n_valid are written as zeros, without being read
//     (row r of the S·C output rows by CTA r mod grid);
//   * an item streams its D x 64 weight strip (and its valid x rows)
//     through a 4-stage cp.async ring of 16-byte copies, 8 KB of weights a
//     stage in either dtype (float32 32 deep, bf16 64 deep), so 24 KB per
//     CTA and ~96 KB per SM are in flight; bf16 moves twice the elements
//     per copy. Shapes whose rows are not 16-byte multiples (D or F not a
//     multiple of 16 / sizeof(T)) fill the ring with plain loads instead;
//   * products by dtype, as measured at the main shapes (NVIDIA H100 80GB
//     HBM3, 700.00 W; PERF.md): float32 on CUDA cores, exact FMAs (the 4
//     warps split each stage's depth, a lane owns 2 columns of every valid
//     row), because with 3xTF32 mma.sync the decode shape ran 0.0991 ms
//     against 0.0781 on FMAs (the operand splits outweigh 1-2 rows of
//     FMAs) and the prefill chunk 0.27 ms either way; bf16 on tensor cores
//     (mma.sync m16n8k16, float32 accumulation, m16 row tiles below n_valid
//     only), because on CUDA cores its FMAs and conversions set the chunk's
//     time: 0.2228 ms, against 0.1383 on tensor cores and a 0.1051 ms bytes
//     bound;
//   * the 4 warps' partial sums are added in a fixed order (warp 0 + 1 + 2
//     + 3) through shared memory; each output element is computed by one
//     CTA with no atomics, so a slot's output depends neither on timing nor
//     on the slot's index (a slot-reversal migration keeps streams bit for
//     bit).
// Not done yet (later work): TMA bulk copies on an mbarrier ring, fusing
// silu(x w1) * (x w3) into one pass over x.
#include <type_traits>

#include "attn_tile.cuh"

using paged::cp_async16;
using paged::cp_async_commit;
using paged::cp_async_wait;
using paged::from_f32;
using paged::kIsF32;

constexpr int GT = 128;          // threads per CTA
constexpr int GW = GT / 32;      // warps
constexpr int BN = 64;           // output columns per work item (8 n-tiles)
constexpr int RT = 32;           // output rows per work item (2 m16 tiles)
constexpr int STAGES = 4;        // depth of the cp.async ring
constexpr int CTAS_PER_SM = 4;   // kernels/moe_gmm.py GMM_CTAS_PER_SM
// Shared-memory row strides (elements), so every fragment load is free of
// bank conflicts and every row 16-byte aligned for cp.async: weight rows
// BN + 8 (float32: 72 words ≡ 8 mod 32; bf16: 144 bytes, an odd number of
// 16-byte units for ldmatrix), x rows BK + 4 words (≡ 4 mod 32).
constexpr int LDW = BN + 8;

// Depth of one stage: 8 KB of weights in either dtype; each warp takes one
// mma depth of it (float32 k8, bf16 k16).
template <typename T>
__host__ __device__ constexpr int gmm_bk() {
  return kIsF32<T> ? 32 : 64;
}
template <typename T>
__host__ __device__ constexpr int gmm_ldx() {
  return kIsF32<T> ? gmm_bk<T>() + 4 : gmm_bk<T>() + 8;
}
// One stage: W [BK][LDW], then x [RT][LDX] (elements of T).
template <typename T>
__host__ __device__ constexpr int stage_elems() {
  return gmm_bk<T>() * LDW + RT * gmm_ldx<T>();
}
template <typename T>
__host__ __device__ constexpr size_t ring_bytes() {
  return STAGES * stage_elems<T>() * sizeof(T);
}
static_assert(ring_bytes<float>() >= sizeof(float) * GW * RT * BN &&
                  ring_bytes<__nv_bfloat16>() >= sizeof(float) * GW * RT * BN,
              "the warps' partial sums fit in the ring");

// A warp's accumulators and its share of a stage: its depth slice kb ..
// kb + BK/GW − 1 of W (rows) and x (columns), for the item's `rows` rows.
// float32: CUDA-core FMAs, exact float32 products; a lane owns columns
// 2·lane, 2·lane + 1 of every valid row.
struct GmmFma {
  float acc[RT][2];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r][0] = acc[r][1] = 0.f;
  }
  __device__ __forceinline__ void step(const float* Ws, const float* Xs,
                                       int kb, int rows) {
    constexpr int LDX = gmm_ldx<float>();
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int kk = 0; kk < gmm_bk<float>() / GW; kk += 4) {
      const int k = kb + kk;
      float2 w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        w[u] = *reinterpret_cast<const float2*>(Ws + (k + u) * LDW + 2 * lane);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r >= rows) break;
        const float4 x = *reinterpret_cast<const float4*>(Xs + r * LDX + k);
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[r][0] = fmaf(xv[u], w[u].x, acc[r][0]);
          acc[r][1] = fmaf(xv[u], w[u].y, acc[r][1]);
        }
      }
    }
  }
  // this warp's partial sums of rows < rows into red [RT][BN]
  __device__ __forceinline__ void partials(float* red, int rows) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r >= rows) break;
      *reinterpret_cast<float2*>(red + r * BN + 2 * lane) =
          make_float2(acc[r][0], acc[r][1]);
    }
  }
};

// bf16: tensor cores, mma.sync m16n8k16 (attn_tile.cuh) in the m16 row
// tiles below `rows`; acc[mt][nt] is the C fragment of rows 16mt + g
// (+ 8), columns 8nt + 2t (+ 1). A from x rows as 32-bit pairs (k 2t.. and
// 2t + 8..), B by ldmatrix.trans from the [k][n] weight rows.
struct GmmMma {
  float acc[2][8][4];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }
  __device__ __forceinline__ void step(const __nv_bfloat16* Ws,
                                       const __nv_bfloat16* Xs, int kb,
                                       int rows) {
    constexpr int LDX = gmm_ldx<__nv_bfloat16>();
    static_assert(gmm_bk<__nv_bfloat16>() / GW == 16, "one k16 per warp");
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int MT = (rows + 15) / 16;
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt < MT) {
        const __nv_bfloat16* xa = Xs + (16 * mt + g) * LDX + kb + 2 * t;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(xa);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(xa + 8 * LDX);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(xa + 8);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(xa + 8 * LDX + 8);
      }
    }
    const int mi = lane >> 3, ri = lane & 7;
    const __nv_bfloat16* wrow =
        Ws + (kb + (mi & 1) * 8 + ri) * LDW + (mi >> 1) * 8;
#pragma unroll
    for (int dp = 0; dp < BN / 16; ++dp) {
      uint32_t b[4];
      paged::ldmatrix_x4_trans(b, wrow + dp * 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt < MT) {
          paged::mma_bf16(acc[mt][2 * dp], a[mt], b[0], b[1]);
          paged::mma_bf16(acc[mt][2 * dp + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  __device__ __forceinline__ void partials(float* red, int rows) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mt + g + 8 * h;
        if (r >= rows) continue;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          *reinterpret_cast<float2*>(red + r * BN + 8 * nt + 2 * t) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
  }
};

template <typename T>
using GmmAcc = std::conditional_t<kIsF32<T>, GmmFma, GmmMma>;

// One work item: rows 0 .. rows − 1 of xs (row stride D) times the weight
// strip ws (columns f0 .. f0 + BN − 1 of a row-major [D, F] block, ws
// already offset by f0) into o (row stride F). All threads call it.
template <typename T, bool VEC>
__device__ __forceinline__ void gmm_item(T* ring, float* red,
                                         const T* __restrict__ xs,
                                         const T* __restrict__ ws,
                                         T* __restrict__ o, int rows, int D,
                                         int F, int f0) {
  constexpr int BK = gmm_bk<T>();
  constexpr int LDX = gmm_ldx<T>();
  constexpr int SE = stage_elems<T>();
  const int warp = threadIdx.x >> 5;
  const int nk = (D + BK - 1) / BK;
  const int rows16 = (rows + 15) / 16 * 16;   // whole m16 row tiles

  // stage st ← depth tile kt; rows past D, columns past F and x rows in
  // [rows, rows16) are zeros
  auto issue = [&](int st, int kt) {
    T* Ws = ring + st * SE;
    T* Xs = Ws + BK * LDW;
    const int k0 = kt * BK;
    if constexpr (VEC) {
      constexpr int E = 16 / sizeof(T);
      constexpr int WC = BN / E;         // 16-byte copies per weight row
      for (int i = threadIdx.x; i < BK * WC; i += GT) {
        const int k = i / WC, f = (i - k * WC) * E;
        const bool ok = k0 + k < D && f0 + f < F;
        cp_async16(Ws + k * LDW + f,
                   ws + (ok ? (size_t)(k0 + k) * F + f : 0), ok);
      }
      constexpr int XC = BK / E;         // 16-byte copies per x row
      for (int i = threadIdx.x; i < rows16 * XC; i += GT) {
        const int r = i / XC, k = (i - r * XC) * E;
        const bool ok = r < rows && k0 + k < D;
        cp_async16(Xs + r * LDX + k,
                   xs + (ok ? (size_t)r * D + k0 + k : 0), ok);
      }
    } else {
      for (int i = threadIdx.x; i < BK * BN; i += GT) {
        const int k = i / BN, f = i - k * BN;
        Ws[k * LDW + f] = k0 + k < D && f0 + f < F
                              ? ws[(size_t)(k0 + k) * F + f]
                              : from_f32<T>(0.f);
      }
      for (int i = threadIdx.x; i < rows16 * BK; i += GT) {
        const int r = i / BK, k = i - r * BK;
        Xs[r * LDX + k] = r < rows && k0 + k < D
                              ? xs[(size_t)r * D + k0 + k]
                              : from_f32<T>(0.f);
      }
    }
  };

  GmmAcc<T> acc;
  acc.init();
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nk) issue(i, i);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();         // tile kt has landed
    __syncthreads();                     // and every warp left tile kt − 1
    const int nx = kt + STAGES - 1;
    if (nx < nk) issue(nx % STAGES, nx);
    cp_async_commit();
    const T* Ws = ring + (kt % STAGES) * SE;
    acc.step(Ws, Ws + BK * LDW, warp * (BK / GW), rows);
  }
  cp_async_wait<0>();
  __syncthreads();                       // the ring becomes `red`

  // the warps' partial sums, then their fixed-order sum
  acc.partials(red + warp * RT * BN, rows);
  __syncthreads();
  for (int e = threadIdx.x; e < rows * BN; e += GT) {
    const int r = e / BN, f = e - r * BN;
    if (f0 + f >= F) continue;
    float v = red[r * BN + f];
#pragma unroll
    for (int wp = 1; wp < GW; ++wp) v += red[(wp * RT + r) * BN + f];
    o[(size_t)r * F + f] = from_f32<T>(v);
  }
  __syncthreads();                       // before the ring is refilled
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(GT, CTAS_PER_SM)
moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ n_valid, T* __restrict__ out, int S,
               int C, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem);
  int* nv = reinterpret_cast<int*>(smem + ring_bytes<T>());   // [S]
  int* first = nv + S;   // [S + 1]: the live row tiles before slot s
  const int tid = threadIdx.x;

  for (int s = tid; s < S; s += GT) {
    const int n = min(max(n_valid[s], 0), C);
    nv[s] = n;
    first[s + 1] = (n + RT - 1) / RT;
  }
  __syncthreads();
  if (tid < 32) {                        // prefix sum, 32 slots a pass
    int carry = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + tid;
      int v = s < S ? first[s + 1] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, d);
        if (tid >= d) v += u;
      }
      if (s < S) first[s + 1] = v + carry;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    if (tid == 0) first[0] = 0;
  }
  __syncthreads();

  // rows at or past n_valid: zeros, never read
  for (int row = blockIdx.x; row < S * C; row += gridDim.x) {
    const int s = row / C;
    if (row - s * C < nv[s]) continue;
    T* o = out + (size_t)row * F;
    for (int f = tid; f < F; f += GT) o[f] = from_f32<T>(0.f);
  }

  // the live items (slot, row tile, column tile), slot-major
  const int n_ct = (F + BN - 1) / BN;
  const int n_items = first[S] * n_ct;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int g = it / n_ct;             // live row tile g, column tile
    const int f0 = (it - g * n_ct) * BN;
    int lo = 0, hi = S;                  // the slot s: first[s] <= g <
    while (hi - lo > 1) {                // first[s + 1]
      const int mid = (lo + hi) >> 1;
      if (first[mid] <= g) lo = mid;
      else hi = mid;
    }
    const int s = lo;
    const int c0 = (g - first[s]) * RT;
    const size_t row0 = (size_t)s * C + c0;
    gmm_item<T, VEC>(ring, red, x + row0 * D, w + (size_t)s * D * F + f0,
                     out + row0 * F + f0, min(RT, nv[s] - c0), D, F, f0);
  }
}

template <typename T, bool VEC>
static int launch(const void* x, const void* w, const void* n_valid,
                  void* out, int S, int C, int D, int F, int n_cta,
                  cudaStream_t stream) {
  const size_t smem = ring_bytes<T>() + sizeof(int) * (2 * (size_t)S + 1);
  auto kern = moe_gmm_kernel<T, VEC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<n_cta, GT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(n_valid), static_cast<T*>(out), S, C, D, F);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* x, const void* w, const void* n_valid,
                    void* out, int S, int C, int D, int F, int n_cta,
                    cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  if (D % E == 0 && F % E == 0)
    return launch<T, true>(x, w, n_valid, out, S, C, D, F, n_cta, stream);
  return launch<T, false>(x, w, n_valid, out, S, C, D, F, n_cta, stream);
}

// dtype (of x, w and out): 0 = float32, 1 = bfloat16. n_cta: the grid
// (kernels/moe_gmm.py::gmm_ctas). Every pointer is 16-byte aligned.
// Returns 0 on success, a cudaError_t value after a failed launch, or -1
// for a shape the kernel does not take.
extern "C" int moe_gmm_launch(int dtype, const void* x, const void* w,
                              const void* n_valid, void* out, int S, int C,
                              int D, int F, int n_cta, void* stream) {
  if (S < 1 || C < 1 || D < 1 || F < 1 || n_cta < 1 ||
      (long long)S * C > 0x7fffffff || S > 16384 ||
      (long long)S * ((C + RT - 1) / RT) * ((F + BN - 1) / BN) > 0x7fffffff)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, w, n_valid, out, S, C, D, F,
                                         n_cta, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, w, n_valid, out, S, C, D,
                                                 F, n_cta, st);
  return -1;
}
