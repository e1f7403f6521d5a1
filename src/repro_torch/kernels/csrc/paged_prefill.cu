// Chunked-prefill attention over paged history for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the TPU kernel `paged_prefill` in
// src/repro/kernels/paged_prefill.py (pl.pallas_call at :194; layout adapter
// ops.py:80): a chunk of S prompt tokens at absolute positions off .. off+S
// (the first chunk_len real) attends to
//   1. the prompt's resident history, tokens < off, in blocks of the arena
//      [N, K, bs, h] reached through the block table [B, nb], and
//   2. the chunk's own keys k_new/v_new [B, K, S, h] under the causal mask,
// with the optional sink+window mask (window = sink = 0 on full-attention
// layers). Query rows are GQA-grouped per kv head: row r of q [B, K, S·G, h]
// is chunk token r / G at absolute position off + r / G.
//
// What bounds it on the card: at the main-path shapes (S = 128, G = 6,
// history 384, h = 128) each K/V element read from memory feeds 2·S·G
// flops, so the kernel is bound by operations, and in float32 outside the
// tensor cores. The design keeps it simple and right first:
//   * one CTA per (sequence, kv head, tile of TQ query rows), so the 768
//     rows of one chunk and kv head spread over 48 CTAs per head;
//   * the CTA walks history blocks j < ceil(off / bs) through the table
//     (never the blocks past the history), then the chunk's keys in tiles
//     of bs, stopping at the last key the tile's rows can see
//     (min(chunk_len, last row token + 1));
//   * 16-byte coalesced tile loads into float32 shared memory and the same
//     online softmax as the TPU kernel (NEG_INF = -1e30, l >= 1e-30), so
//     padded rows (>= chunk_len) stay finite.
//
// QuantPlane (int8 arenas, paged_prefill.py:54-110): the HISTORY pages are
// int8 with their float32 scale plane; the chunk's own keys k_new/v_new stay
// in q's type. Each resident history block's K and V scale rows go into
// shared memory before its tile, which is dequantized as it is written to
// shared memory (one float32 product per element, decided per channel).
// Not done yet (later work): wgmma / mma.sync products, TMA pipelining.
#include "attn_tile.cuh"

using namespace paged;

constexpr int TQ = 16;   // query rows per CTA

__device__ __forceinline__ bool allowed(int p, int t, int window, int sink) {
  bool ok = t <= p;
  if (window > 0) ok = ok && ((p - t) < window || (sink > 0 && t < sink));
  return ok;
}

// T: q, out and the chunk's keys (float / bf16); KV: the arena payload (T,
// or int8_t with the scale plane ks/kt/vs/vt, null otherwise).
template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(NT)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                     const T* __restrict__ vn, const KV* __restrict__ kp,
                     const KV* __restrict__ vp, const float* __restrict__ ks,
                     const float* __restrict__ kt,
                     const float* __restrict__ vs,
                     const float* __restrict__ vt,
                     const int* __restrict__ tables,
                     const int* __restrict__ off_a,
                     const int* __restrict__ cl_a, T* __restrict__ out, int K,
                     int S, int G, int bs, int nb, float scale, int window,
                     int sink) {
  extern __shared__ float smem[];
  constexpr int LD = HD + 1;
  const int b = blockIdx.x, kh = blockIdx.y;
  const int SG = S * G;
  const int r0 = blockIdx.z * TQ;
  const int R = min(TQ, SG - r0);
  float* Qs = smem;
  float* Ks = Qs + TQ * LD;
  float* Vs = Ks + bs * LD;
  float* P = Vs + bs * HD;
  float* M = P + TQ * bs;
  float* L = M + TQ;
  float* C = L + TQ;
  float* Ksc = C + TQ;       // scale rows (int8 arenas only)
  float* Ktk = Ksc + HD;
  float* Vsc = Ktk + bs;
  float* Vtk = Vsc + HD;

  const size_t qoff = (((size_t)b * K + kh) * SG + r0) * HD;
  load_tile<T, HD>(Qs, LD, q + qoff, TQ, R);
  for (int r = threadIdx.x; r < TQ; r += NT) {
    M[r] = NEG_INF;
    L[r] = 0.f;
  }
  float acc[MAXR];
#pragma unroll
  for (int k = 0; k < MAXR; ++k) acc[k] = 0.f;
  const int off = off_a[b];
  const int cl = cl_a[b];
  __syncthreads();

  // 1. resident history: logical slot = absolute token position
  const int nh = min((off + bs - 1) / bs, nb);
  for (int j = 0; j < nh; ++j) {
    const int phys = tables[(size_t)b * nb + j];
    const size_t base = ((size_t)phys * K + kh) * bs * HD;
    if constexpr (kInt8Kv<KV>) {
      load_scale_rows<HD>(Ksc, Ktk, Vsc, Vtk, ks, kt, vs, vt, phys, K, kh,
                          bs);
      __syncthreads();
    }
    load_kv_tile<KV, HD>(Ks, LD, kp + base, bs, bs, Ksc, Ktk);
    load_kv_tile<KV, HD>(Vs, HD, vp + base, bs, bs, Vsc, Vtk);
    __syncthreads();
    const int tok0 = j * bs;
    tile_step<HD>(Qs, Ks, Vs, P, M, L, C, acc, R, bs, scale,
                  [=](int r, int t) {
                    const int tok = tok0 + t;
                    const int p = off + (r0 + r) / G;
                    return tok < off && allowed(p, tok, window, sink);
                  });
  }

  // 2. the chunk's own keys, causal on absolute positions
  const size_t kvoff = ((size_t)b * K + kh) * S * HD;
  const int last_tok = (r0 + R - 1) / G;
  const int n_keys = min(cl, last_tok + 1);
  for (int u0 = 0; u0 < n_keys; u0 += bs) {
    const int rows = min(bs, S - u0);
    load_tile<T, HD>(Ks, LD, kn + kvoff + (size_t)u0 * HD, bs, rows);
    load_tile<T, HD>(Vs, HD, vn + kvoff + (size_t)u0 * HD, bs, rows);
    __syncthreads();
    tile_step<HD>(Qs, Ks, Vs, P, M, L, C, acc, R, bs, scale,
                  [=](int r, int t) {
                    const int u = u0 + t;
                    const int p = off + (r0 + r) / G;
                    return u < cl && allowed(p, off + u, window, sink);
                  });
  }
  store_rows<T, HD>(out + qoff, acc, L, R);
}

template <typename T, typename KV, int HD>
static int launch(const void* q, const void* kn, const void* vn,
                  const void* kp, const void* vp, const float* ks,
                  const float* kt, const float* vs, const float* vt,
                  const void* tables, const void* off, const void* cl,
                  void* out, int B, int K, int S, int G, int bs, int nb,
                  float scale, int window, int sink, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(TQ, bs, HD) +
                      sizeof(float) * scale_smem_floats<KV>(HD, bs);
  auto kern = paged_prefill_kernel<T, KV, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, K, (S * G + TQ - 1) / TQ);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), ks, kt, vs, vt,
      static_cast<const int*>(tables), static_cast<const int*>(off),
      static_cast<const int*>(cl), static_cast<T*>(out), K, S, G, bs, nb,
      scale, window, sink);
  return (int)cudaGetLastError();
}

// KV = T when `int8` is false, else int8_t with the scale plane.
static int dispatch(int dtype, bool int8, const void* q, const void* kn,
                    const void* vn, const void* kp, const void* vp,
                    const float* ks, const float* kt, const float* vs,
                    const float* vt, const void* tables, const void* off,
                    const void* cl, void* out, int B, int K, int S, int G,
                    int h, int bs, int nb, float scale, int window, int sink,
                    void* stream) {
  if (TQ > MAXR * (NT / h) || S < 1 || G < 1 || bs < 1 || nb < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PP_CASE(T, HD)                                                      \
  if (h == HD)                                                              \
    return int8 ? launch<T, int8_t, HD>(q, kn, vn, kp, vp, ks, kt, vs, vt,  \
                                        tables, off, cl, out, B, K, S, G,   \
                                        bs, nb, scale, window, sink, s)     \
                : launch<T, T, HD>(q, kn, vn, kp, vp, ks, kt, vs, vt,       \
                                   tables, off, cl, out, B, K, S, G, bs,    \
                                   nb, scale, window, sink, s);
  if (dtype == 0) {
    PP_CASE(float, 32) PP_CASE(float, 64) PP_CASE(float, 128)
  } else if (dtype == 1) {
    PP_CASE(__nv_bfloat16, 32) PP_CASE(__nv_bfloat16, 64)
    PP_CASE(__nv_bfloat16, 128)
  }
#undef PP_CASE
  return -1;
}

// dtype (of q, out, the chunk's keys and the pages): 0 = float32,
// 1 = bfloat16. Returns 0 on success, a cudaError_t value after a failed
// launch, or -1 for a shape the kernel does not take.
extern "C" int paged_prefill_launch(int dtype, const void* q, const void* kn,
                                    const void* vn, const void* kp,
                                    const void* vp, const void* tables,
                                    const void* off, const void* cl,
                                    void* out, int B, int K, int S, int G,
                                    int h, int bs, int nb, float scale,
                                    int window, int sink, void* stream) {
  return dispatch(dtype, false, q, kn, vn, kp, vp, nullptr, nullptr, nullptr,
                  nullptr, tables, off, cl, out, B, K, S, G, h, bs, nb, scale,
                  window, sink, stream);
}

// The same over int8 history pages with their scale plane: ks/vs [N, K, h]
// and kt/vt [N, K, bs], float32 (the chunk's keys stay in q's type).
extern "C" int paged_prefill_int8_launch(
    int dtype, const void* q, const void* kn, const void* vn, const void* kp,
    const void* vp, const void* ks, const void* kt, const void* vs,
    const void* vt, const void* tables, const void* off, const void* cl,
    void* out, int B, int K, int S, int G, int h, int bs, int nb, float scale,
    int window, int sink, void* stream) {
  return dispatch(dtype, true, q, kn, vn, kp, vp,
                  static_cast<const float*>(ks), static_cast<const float*>(kt),
                  static_cast<const float*>(vs), static_cast<const float*>(vt),
                  tables, off, cl, out, B, K, S, G, h, bs, nb, scale, window,
                  sink, stream);
}
