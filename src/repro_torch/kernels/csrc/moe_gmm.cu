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
// tokens (C = 8 capacity rows, 1-6 of them valid), so each active slot's
// D x F weight block is read once for ~2 flops per weight: far below the
// H100's ~20 flops per byte in float32. Prefill chunks (C = 24) stay
// below it too. The work that counts is reading each ACTIVE slot's
// weights once, at full rate, and nothing else:
//   * one CTA per (slot, 128-column tile of F, 32-row tile of C). The CTA
//     holds every valid row of its slot (C <= 32 on the serving path), so
//     the weight tile is read once, not once per row tile;
//   * n_valid[s] is read first: a CTA whose first row is >= n_valid writes
//     zeros and returns, so a slot with n_valid = 0 never reads x or w
//     (at decode most of the 60 slots are empty);
//   * D is walked in 32-deep tiles: the weight tile [32 x 128] and the x
//     tile [32 x 32] are staged in shared memory as float32, and the next
//     tiles are loaded into registers while the current one is multiplied
//     (a register double buffer), so loads stay in flight during the FMAs;
//     two CTAs fit on an SM (launch bounds cap a thread at 128 registers);
//   * thread (ty, tx) owns columns tx + 32 j (j < 4: a warp reads 32
//     consecutive weights, conflict-free) of rows ty + 8 i (i < 4); a row
//     group at or past n_valid skips its FMAs, warp-uniformly;
//   * every edge is guarded: C, D and F need not divide the tiles
//     (1408 = 11 x 128, the test sweeps use F = 48).
// Not done yet (later work): wgmma tensor-core tiles for bf16 and large C,
// TMA loads, fusing silu(x w1) * (x w3) into one pass over x.
#include "attn_tile.cuh"

using paged::from_f32;
using paged::to_f32;

constexpr int GT = 256;          // threads per CTA
constexpr int BF = 128;          // output columns per CTA
constexpr int BK = 32;           // depth of one D tile
constexpr int ROWS = 32;         // output rows per CTA
constexpr int TX = 32;           // column lanes
constexpr int TY = GT / TX;      // row groups
constexpr int RPT = ROWS / TY;   // rows per thread
constexpr int CPT = BF / TX;     // columns per thread
constexpr int WPT = BK * BF / GT;    // weight elements loaded per thread
constexpr int XPT = ROWS * BK / GT;  // x elements loaded per thread

template <typename T>
__global__ void __launch_bounds__(GT, 2)
moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ n_valid, T* __restrict__ out, int C,
               int D, int F) {
  __shared__ float ws[BK * BF];
  __shared__ float xs[ROWS][BK + 1];
  const int s = blockIdx.x;
  const int f0 = blockIdx.y * BF;
  const int c0 = blockIdx.z * ROWS;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int n = min(max(n_valid[s], 0), C);
  const int rows = min(ROWS, n - c0);   // valid rows of this tile
  T* o = out + (size_t)s * C * F;

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  if (rows > 0) {
    const T* xs_g = x + ((size_t)s * C + c0) * D;
    const T* ws_g = w + (size_t)s * D * F;
    float wr[WPT], xr[XPT];
    auto load = [&](int k0) {
#pragma unroll
      for (int u = 0; u < WPT; ++u) {
        const int e = tid + GT * u;
        const int kg = k0 + e / BF;
        const int f = f0 + e % BF;
        wr[u] = (kg < D && f < F) ? to_f32<T>(ws_g[(size_t)kg * F + f]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < XPT; ++u) {
        const int e = tid + GT * u;
        const int r = e / BK;
        const int kg = k0 + e % BK;
        xr[u] = (r < rows && kg < D) ? to_f32<T>(xs_g[(size_t)r * D + kg])
                                     : 0.f;
      }
    };
    const int nk = (D + BK - 1) / BK;
    load(0);
    for (int t = 0; t < nk; ++t) {
#pragma unroll
      for (int u = 0; u < WPT; ++u) ws[tid + GT * u] = wr[u];
#pragma unroll
      for (int u = 0; u < XPT; ++u) {
        const int e = tid + GT * u;
        xs[e / BK][e % BK] = xr[u];
      }
      __syncthreads();
      if (t + 1 < nk) load((t + 1) * BK);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float wv[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) wv[j] = ws[kk * BF + tx + TX * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          if (ty + TY * i < rows) {
            const float xv = xs[ty + TY * i][kk];
#pragma unroll
            for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + TY * i;
    const int c = c0 + r;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int f = f0 + tx + TX * j;
      if (f < F) o[(size_t)c * F + f] = from_f32<T>(r < rows ? acc[i][j] : 0.f);
    }
  }
}

template <typename T>
static int launch(const void* x, const void* w, const void* n_valid,
                  void* out, int S, int C, int D, int F,
                  cudaStream_t stream) {
  const dim3 grid(S, (F + BF - 1) / BF, (C + ROWS - 1) / ROWS);
  moe_gmm_kernel<T><<<grid, GT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(n_valid), static_cast<T*>(out), C, D, F);
  return (int)cudaGetLastError();
}

// dtype (of x, w and out): 0 = float32, 1 = bfloat16. Returns 0 on
// success, a cudaError_t value after a failed launch, or -1 for a shape
// the kernel does not take.
extern "C" int moe_gmm_launch(int dtype, const void* x, const void* w,
                              const void* n_valid, void* out, int S, int C,
                              int D, int F, void* stream) {
  if (S < 1 || C < 1 || D < 1 || F < 1) return -1;
  if ((F + BF - 1) / BF > 65535 || (C + ROWS - 1) / ROWS > 65535) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, n_valid, out, S, C, D, F, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, n_valid, out, S, C, D, F, st);
  return -1;
}
