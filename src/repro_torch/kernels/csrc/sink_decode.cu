// Decode-step attention over a dense (sink‖ring, or full) KV cache for
// Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `sink_decode` in src/repro/kernels/sink_decode.py
// (pl.pallas_call at :74; layout adapter ops.py:40): one query token per
// sequence attends over the first min(t, W) slots of its cache, t [B] being
// the occupancy (t = pos + 1, which exceeds W once a ring has wrapped: then
// every slot is live). q is [B, K, G, h]; the caches are read as
// [B, K, W, h] through element strides, so the model's own [B, W, K, h]
// layout is read in place — the TPU adapter's transposed copy of the whole
// cache is not carried over.
//
// What bounds it on the card: bytes. Each cached K/V element is read once
// per (sequence, kv head) and feeds only 2·G flops (G = 6 query rows on
// full-width qwen2-1.5b). The design reads each live slot exactly once:
//   * one CTA per (sequence, kv head) holds all G rows of the GQA group in
//     shared memory, so one K/V tile read serves all of them;
//   * the CTA loops over tiles of TW slots below min(t, W) only; slots past
//     the occupancy are never touched;
//   * 16-byte coalesced loads of each h-long row (rows are K·h elements
//     apart in the model layout) into float32 shared memory, and the TPU
//     kernel's online softmax (NEG_INF = -1e30, l >= 1e-30) from
//     attn_tile.cuh.
// t >= 1 is required (every decode step writes its own token first).
// Not done yet (later work): split-KV over more CTAs (B·K = 12 CTAs on the
// main path leave most SMs idle), cp.async/TMA double buffering.
#include "attn_tile.cuh"

using namespace paged;

constexpr int TW = 64;   // cache slots per tile

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
sink_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, const int* __restrict__ t_a,
                   T* __restrict__ out, int K, int G, int W, long long ksb,
                   long long ksk, long long ksw, long long vsb, long long vsk,
                   long long vsw, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = HD + 1;
  const int b = blockIdx.x, kh = blockIdx.y;
  float* Qs = smem;
  float* Ks = Qs + G * LD;
  float* Vs = Ks + TW * LD;
  float* P = Vs + TW * HD;
  float* M = P + G * TW;
  float* L = M + G;
  float* C = L + G;

  const size_t qoff = ((size_t)b * K + kh) * G * HD;
  load_tile<T, HD>(Qs, LD, q + qoff, G, G);
  for (int r = threadIdx.x; r < G; r += NT) {
    M[r] = NEG_INF;
    L[r] = 0.f;
  }
  float acc[MAXR];
#pragma unroll
  for (int i = 0; i < MAXR; ++i) acc[i] = 0.f;
  const int n = min(t_a[b], W);
  const T* kb = kc + b * ksb + kh * ksk;
  const T* vb = vc + b * vsb + kh * vsk;
  __syncthreads();

  for (int w0 = 0; w0 < n; w0 += TW) {
    const int rows = min(TW, n - w0);
    load_rows<T, HD>(Ks, LD, kb + w0 * ksw, (size_t)ksw, TW, rows);
    load_rows<T, HD>(Vs, HD, vb + w0 * vsw, (size_t)vsw, TW, rows);
    __syncthreads();
    tile_step<HD>(Qs, Ks, Vs, P, M, L, C, acc, G, TW, scale,
                  [=](int, int t) { return w0 + t < n; });
  }
  store_rows<T, HD>(out + qoff, acc, L, G);
}

template <typename T, int HD>
static int launch(const void* q, const void* kc, const void* vc,
                  const void* t, void* out, int B, int K, int G, int W,
                  long long ksb, long long ksk, long long ksw, long long vsb,
                  long long vsk, long long vsw, float scale,
                  cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(G, TW, HD);
  auto kern = sink_decode_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, K);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(t),
      static_cast<T*>(out), K, G, W, ksb, ksk, ksw, vsb, vsk, vsw, scale);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; h is
// contiguous. Returns 0 on success, a cudaError_t value after a failed
// launch, or -1 for a shape the kernel does not take.
extern "C" int sink_decode_launch(int dtype, const void* q, const void* kc,
                                  const void* vc, const void* t, void* out,
                                  int B, int K, int G, int h, int W,
                                  long long ksb, long long ksk, long long ksw,
                                  long long vsb, long long vsk, long long vsw,
                                  float scale, void* stream) {
  if (G < 1 || G > MAXR * (NT / h) || B < 1 || K < 1 || K > 65535 || W < 1)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SD_CASE(T, HD)                                                     \
  if (h == HD)                                                             \
    return launch<T, HD>(q, kc, vc, t, out, B, K, G, W, ksb, ksk, ksw,     \
                         vsb, vsk, vsw, scale, s);
  if (dtype == 0) {
    SD_CASE(float, 32) SD_CASE(float, 64) SD_CASE(float, 128)
  } else if (dtype == 1) {
    SD_CASE(__nv_bfloat16, 32) SD_CASE(__nv_bfloat16, 64)
    SD_CASE(__nv_bfloat16, 128)
  }
#undef SD_CASE
  return -1;
}
