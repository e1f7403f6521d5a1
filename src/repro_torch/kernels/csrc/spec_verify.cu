// Batched speculative-verify attention over paged history for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `spec_verify` in src/repro/kernels/spec_verify.py
// (pl.pallas_call at :186; layout adapter ops.py:102): every decode slot b
// presents a window of S = k + 1 tokens (its current input token and k
// drafts) at absolute positions off_b .. off_b + S - 1, and each window row
// attends
//   1. the slot's resident history, tokens < off_b, in blocks of the arena
//      [N, K, bs, h] reached through the slot's own table row [nb], and
//   2. the window's own keys k_new/v_new [B, K, S, h] under the causal mask,
//      keys past n_tok_b masked.
// Query rows are GQA-grouped per kv head: row r of q [B, K, S·G, h] is
// window token r / G. Nothing is written: the engine commits the accepted
// prefix afterwards.
//
// What bounds it on the card: bytes at the main-path shape. Each history
// K or V element (4 bytes in float32) feeds 2·S·G = 60 flops (S = 5,
// G = 6): 15 flop/byte, below the ~20 flop/byte where float32 compute would
// take over; and the window is a handful of rows, far from a tensor-core
// tile. Unlike chunked prefill
// (one task, 16-row tiles over many CTAs), every slot here has its own
// off_b and n_tok_b, read on the device. The design:
//   * one CTA per (slot, kv head) holds all S·G window rows in shared memory
//     (30 rows at k = 4, G = 6; the accumulators are a 32-row array), so
//     each history K/V tile is read once for all of them; windows longer
//     than 32·128/h rows take further CTAs along grid z;
//   * the CTA reads off_b, n_tok_b and its table row itself and walks only
//     the history blocks j < ceil(off_b / bs), never the table entries past
//     the residency (they alias the null block);
//   * then the window's keys in tiles of bs, stopping at the last key its
//     rows can see (min(n_tok_b, last row token + 1));
//   * 16-byte coalesced tile loads into float32 shared memory and the TPU
//     kernel's online softmax (NEG_INF = -1e30, l >= 1e-30) from
//     attn_tile.cuh, so padded window rows stay finite.
//
// QuantPlane (int8 arenas, spec_verify.py:55-100): the history pages are
// int8 with their float32 scale plane; the window's keys stay in q's type.
// Each resident history block's K and V scale rows go into shared memory
// before its tile, which is dequantized as it is written to shared memory
// (one float32 product per element, decided per channel).
// Not done yet (later work): split-KV over more CTAs for long histories
// (B·K = 12 CTAs on the main path), cp.async/TMA double buffering.
#include "attn_tile.cuh"

using namespace paged;

constexpr int NRV = 32;   // accumulator rows per thread (window rows / CTA
                          // = NRV · NT / h)

// T: q, out and the window's keys (float / bf16); KV: the arena payload (T,
// or int8_t with the scale plane ks/kt/vs/vt, null otherwise).
template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(NT)
spec_verify_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                   const T* __restrict__ vn, const KV* __restrict__ kp,
                   const KV* __restrict__ vp, const float* __restrict__ ks,
                   const float* __restrict__ kt, const float* __restrict__ vs,
                   const float* __restrict__ vt,
                   const int* __restrict__ tables,
                   const int* __restrict__ off_a,
                   const int* __restrict__ ntok_a, T* __restrict__ out, int K,
                   int S, int G, int bs, int nb, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = HD + 1;
  constexpr int TQ = NRV * (NT / HD);
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
  float acc[NRV];
#pragma unroll
  for (int k = 0; k < NRV; ++k) acc[k] = 0.f;
  const int off = off_a[b];
  const int ntok = ntok_a[b];
  __syncthreads();

  // 1. resident history: logical slot = absolute token position < off
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
                  [=](int, int t) { return tok0 + t < off; });
  }

  // 2. the window's own keys, causal: row token i sees keys u <= i, u < ntok
  const size_t kvoff = ((size_t)b * K + kh) * S * HD;
  const int last_tok = (r0 + R - 1) / G;
  const int n_keys = min(ntok, last_tok + 1);
  for (int u0 = 0; u0 < n_keys; u0 += bs) {
    const int rows = min(bs, S - u0);
    load_tile<T, HD>(Ks, LD, kn + kvoff + (size_t)u0 * HD, bs, rows);
    load_tile<T, HD>(Vs, HD, vn + kvoff + (size_t)u0 * HD, bs, rows);
    __syncthreads();
    tile_step<HD>(Qs, Ks, Vs, P, M, L, C, acc, R, bs, scale,
                  [=](int r, int t) {
                    const int u = u0 + t;
                    return u < ntok && u <= (r0 + r) / G;
                  });
  }
  store_rows<T, HD>(out + qoff, acc, L, R);
}

template <typename T, typename KV, int HD>
static int launch(const void* q, const void* kn, const void* vn,
                  const void* kp, const void* vp, const float* ks,
                  const float* kt, const float* vs, const float* vt,
                  const void* tables, const void* off, const void* ntok,
                  void* out, int B, int K, int S, int G, int bs, int nb,
                  float scale, cudaStream_t stream) {
  constexpr int TQ = NRV * (NT / HD);
  const size_t smem = tile_smem_bytes(TQ, bs, HD) +
                      sizeof(float) * scale_smem_floats<KV>(HD, bs);
  auto kern = spec_verify_kernel<T, KV, HD>;
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
      static_cast<const int*>(ntok), static_cast<T*>(out), K, S, G, bs, nb,
      scale);
  return (int)cudaGetLastError();
}

// KV = T when `int8` is false, else int8_t with the scale plane.
static int dispatch(int dtype, bool int8, const void* q, const void* kn,
                    const void* vn, const void* kp, const void* vp,
                    const float* ks, const float* kt, const float* vs,
                    const float* vt, const void* tables, const void* off,
                    const void* ntok, void* out, int B, int K, int S, int G,
                    int h, int bs, int nb, float scale, void* stream) {
  if (B < 1 || K < 1 || S < 1 || G < 1 || bs < 1 || nb < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SV_CASE(T, HD)                                                      \
  if (h == HD)                                                              \
    return int8 ? launch<T, int8_t, HD>(q, kn, vn, kp, vp, ks, kt, vs, vt,  \
                                        tables, off, ntok, out, B, K, S, G, \
                                        bs, nb, scale, s)                   \
                : launch<T, T, HD>(q, kn, vn, kp, vp, ks, kt, vs, vt,       \
                                   tables, off, ntok, out, B, K, S, G, bs,  \
                                   nb, scale, s);
  if (dtype == 0) {
    SV_CASE(float, 32) SV_CASE(float, 64) SV_CASE(float, 128)
  } else if (dtype == 1) {
    SV_CASE(__nv_bfloat16, 32) SV_CASE(__nv_bfloat16, 64)
    SV_CASE(__nv_bfloat16, 128)
  }
#undef SV_CASE
  return -1;
}

// dtype (of q, out, the window's keys and the pages): 0 = float32,
// 1 = bfloat16. Returns 0 on success, a cudaError_t value after a failed
// launch, or -1 for a shape the kernel does not take.
extern "C" int spec_verify_launch(int dtype, const void* q, const void* kn,
                                  const void* vn, const void* kp,
                                  const void* vp, const void* tables,
                                  const void* off, const void* ntok,
                                  void* out, int B, int K, int S, int G,
                                  int h, int bs, int nb, float scale,
                                  void* stream) {
  return dispatch(dtype, false, q, kn, vn, kp, vp, nullptr, nullptr, nullptr,
                  nullptr, tables, off, ntok, out, B, K, S, G, h, bs, nb,
                  scale, stream);
}

// The same over int8 history pages with their scale plane: ks/vs [N, K, h]
// and kt/vt [N, K, bs], float32 (the window's keys stay in q's type).
extern "C" int spec_verify_int8_launch(
    int dtype, const void* q, const void* kn, const void* vn, const void* kp,
    const void* vp, const void* ks, const void* kt, const void* vs,
    const void* vt, const void* tables, const void* off, const void* ntok,
    void* out, int B, int K, int S, int G, int h, int bs, int nb, float scale,
    void* stream) {
  return dispatch(dtype, true, q, kn, vn, kp, vp,
                  static_cast<const float*>(ks), static_cast<const float*>(kt),
                  static_cast<const float*>(vs), static_cast<const float*>(vt),
                  tables, off, ntok, out, B, K, S, G, h, bs, nb, scale,
                  stream);
}
