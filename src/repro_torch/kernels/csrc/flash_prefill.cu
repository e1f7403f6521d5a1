// Whole-prompt flash attention for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the TPU kernel `flash_prefill` in
// src/repro/kernels/flash_prefill.py (pl.pallas_call at :89; layout adapter
// ops.py:22): blockwise online-softmax attention of a whole prompt over its
// own keys, causal or bidirectional, with the optional sink+window mask
// fused into the score tile. GQA is native: the G query heads of one kv head
// are rows of one matrix, row r of q [N, S·G, h] being token r / G (N =
// sequences × kv heads; with G = 1 this is the TPU kernel's [BH, S, h]
// layout). The TPU adapter repeats every kv head G times; here one loaded
// K/V tile serves all G heads of its group.
//
// What bounds it on the card: operations. At the main-path shape (S = 4608,
// 12 query heads over 2 kv heads, h = 128, causal) each K/V element read
// feeds about 2·S·G/2 flops, far above float32's ~20 flop/byte. The design
// keeps it simple and right first:
//   * one CTA per (sequence × kv head, tile of TQ query rows); the rows of a
//     tile are consecutive (token, head) pairs, so they share their keys;
//   * key tiles of TK keys, walked in order; tiles wholly above the causal
//     diagonal are never visited, nor are tiles wholly outside every row's
//     window that also lie outside the sink (the function is unchanged:
//     such tiles contribute nothing);
//   * ragged tails (S not a multiple of TK, S·G not of TQ) are masked, so
//     any bucketed length works, e.g. max_len = 4608;
//   * 16-byte coalesced tile loads into float32 shared memory and the same
//     online softmax as the TPU kernel (NEG_INF = -1e30, l >= 1e-30), via
//     the shared attn_tile.cuh.
// Not done yet (later work): wgmma / mma.sync products, TMA pipelining,
// register-blocked scores.
#include "attn_tile.cuh"

using namespace paged;

constexpr int TQ = 16;   // query rows per CTA
constexpr int TK = 32;   // keys per tile

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int S,
                     int G, float scale, int causal, int window, int sink) {
  extern __shared__ float smem[];
  constexpr int LD = HD + 1;
  const int n = blockIdx.y;
  const int SG = S * G;
  const int r0 = blockIdx.x * TQ;
  const int R = min(TQ, SG - r0);
  float* Qs = smem;
  float* Ks = Qs + TQ * LD;
  float* Vs = Ks + TK * LD;
  float* P = Vs + TK * HD;
  float* M = P + TQ * TK;
  float* L = M + TQ;
  float* C = L + TQ;

  const size_t qoff = ((size_t)n * SG + r0) * HD;
  load_tile<T, HD>(Qs, LD, q + qoff, TQ, R);
  for (int r = threadIdx.x; r < TQ; r += NT) {
    M[r] = NEG_INF;
    L[r] = 0.f;
  }
  float acc[MAXR];
#pragma unroll
  for (int i = 0; i < MAXR; ++i) acc[i] = 0.f;
  const size_t kvoff = (size_t)n * S * HD;
  const int p_lo = r0 / G;               // first and last query token
  const int p_hi = (r0 + R - 1) / G;     // of this tile
  const int k_end = causal ? p_hi + 1 : S;
  __syncthreads();

  for (int k0 = 0; k0 < k_end; k0 += TK) {
    const int k_last = min(k0 + TK, S) - 1;
    if (window > 0 && p_lo - k_last >= window && (sink <= 0 || k0 >= sink))
      continue;                          // uniform over the CTA
    const int rows = min(TK, S - k0);
    load_tile<T, HD>(Ks, LD, k + kvoff + (size_t)k0 * HD, TK, rows);
    load_tile<T, HD>(Vs, HD, v + kvoff + (size_t)k0 * HD, TK, rows);
    __syncthreads();
    tile_step<HD>(Qs, Ks, Vs, P, M, L, C, acc, R, TK, scale,
                  [=](int r, int t) {
                    const int key = k0 + t;
                    const int p = (r0 + r) / G;
                    bool ok = key < S && (!causal || key <= p);
                    if (window > 0)
                      ok = ok &&
                           ((p - key) < window || (sink > 0 && key < sink));
                    return ok;
                  });
  }
  store_rows<T, HD>(out + qoff, acc, L, R);
}

template <typename T, int HD>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int N, int S, int G, float scale, int causal, int window,
                  int sink, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(TQ, TK, HD);
  auto kern = flash_prefill_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((S * G + TQ - 1) / TQ, N);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, G, scale, causal,
      window, sink);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. Returns 0 on success, a cudaError_t
// value after a failed launch, or -1 for a shape the kernel does not take.
extern "C" int flash_prefill_launch(int dtype, const void* q, const void* k,
                                    const void* v, void* out, int N, int S,
                                    int G, int h, float scale, int causal,
                                    int window, int sink, void* stream) {
  if (TQ > MAXR * (NT / h) || N < 1 || N > 65535 || S < 1 || G < 1)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FP_CASE(T, HD)                                                     \
  if (h == HD)                                                             \
    return launch<T, HD>(q, k, v, out, N, S, G, scale, causal, window,     \
                         sink, s);
  if (dtype == 0) {
    FP_CASE(float, 32) FP_CASE(float, 64) FP_CASE(float, 128)
  } else if (dtype == 1) {
    FP_CASE(__nv_bfloat16, 32) FP_CASE(__nv_bfloat16, 64)
    FP_CASE(__nv_bfloat16, 128)
  }
#undef FP_CASE
  return -1;
}
