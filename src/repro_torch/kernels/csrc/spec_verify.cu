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
// prefix afterwards. It is chunked prefill's function with per-slot
// offsets and no sparse window (as ref.spec_verify_ref is
// ref.paged_prefill_ref).
//
// What bounds it on the card: bytes. Each history K or V element (4 bytes
// in float32) feeds 2·S·G = 60 flops (S = 5, G = 6), 15 flop/byte — below
// the card's balance — and at a 4,000-token history one verify reads 49 MB
// of K/V, which one CTA per (slot, kv head) — 12 CTAs on 132 SMs — cannot
// pull at the memory's rate. The design runs on the paged-history routine
// (attn_tile.cuh, `paged_tc_attend`):
//   * one 32-row tile of two 16-row warps holds all S·G = 30 window rows of
//     a (slot, kv head), so every history tile is read once for all of
//     them; longer windows take further row tiles (G = 48: 240 rows, 8
//     tiles; h = 256 runs the same tile with 128 output accumulators a
//     thread);
//   * the history split over CTAs from shapes alone (`prefill_splits`:
//     about 2 CTAs per SM, 22 splits per (slot, kv head) at a 256-entry
//     table), each CTA reading its slot's off_b and n_tok_b and walking
//     only its resident table entries, never those past the residency
//     (they alias the null block); key tiles staged by cp.async through
//     the table, double-buffered, so the next tile is in flight while one
//     is scored; int8 pages dequantized through registers;
//   * products on the tensor cores (`tc_tile_step`; float32 through
//     3xTF32); the window's own keys on the last split; a second small
//     kernel merges the splits by log-sum-exp;
//   * the TPU kernel's online softmax (NEG_INF = -1e30, l >= 1e-30), so
//     padded window rows (>= n_tok, or 30 and 31 of the tile) stay finite;
//     they are never stored out of bounds.
//
// QuantPlane (int8 arenas, spec_verify.py:55-100): the history pages are
// int8 with their float32 scale plane; the window's keys stay in q's type.
// Not done yet (later work): TMA bulk copies with an mbarrier ring, a merge
// by the last CTA of a split (one launch, not two).
#include "attn_tile.cuh"

using namespace paged;

constexpr int SV_WARPS = 2;              // 32-row tiles

// grid (n_split, row tiles, B·K)
template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(32 * SV_WARPS)
spec_verify_kernel(PhArgs<T, KV> a, const int* __restrict__ off_a,
                   const int* __restrict__ ntok_a) {
  constexpr int BM = 16 * SV_WARPS;
  const int b = blockIdx.z / a.K, kh = blockIdx.z - b * a.K;
  const int r0 = blockIdx.y * BM;
  const int G = a.G;
  const int R = min(BM, a.S * G - r0);
  const int ntok = ntok_a[b];
  paged_tc_attend<T, KV, HD, SV_WARPS, ph_bn<T>()>(
      a, b, kh, r0, blockIdx.x, gridDim.x, off_a[b],
      min(ntok, (r0 + R - 1) / G + 1), true, [](int, int) { return true; },
      [=](int r, int u) { return u < ntok && u <= (r0 + r) / G; });
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
spec_verify_combine(const float* __restrict__ ws, T* __restrict__ out,
                    int SG, int nsp) {
  ph_combine<T, HD>(ws, out, SG, nsp);
}

template <typename T, typename KV, int HD>
static int launch(const PhArgs<T, KV>& a, const int* off, const int* ntok,
                  int B, int n_split, cudaStream_t stream) {
  constexpr int BM = 16 * SV_WARPS;
  const size_t smem = ph_smem_bytes<T, KV, HD, BM, ph_bn<T>()>(a.bs);
  auto kern = spec_verify_kernel<T, KV, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const int SG = a.S * a.G;
  dim3 grid(n_split, (SG + BM - 1) / BM, B * a.K);
  kern<<<grid, 32 * SV_WARPS, smem, stream>>>(a, off, ntok);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  spec_verify_combine<T, HD><<<dim3(B * a.K, SG), HD, 0, stream>>>(
      a.ws, a.out, SG, n_split);
  return (int)cudaGetLastError();
}

template <typename T, typename KV, int HD>
static int run(const void* q, const void* kn, const void* vn, const void* kp,
               const void* vp, const float* ks, const float* kt,
               const float* vs, const float* vt, const void* tables,
               const void* off, const void* ntok, void* out, void* ws, int B,
               int K, int S, int G, int bs, int nb, int n_split, int per,
               float scale, cudaStream_t stream) {
  const PhArgs<T, KV> a{
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), ks, kt, vs, vt,
      static_cast<const int*>(tables), static_cast<T*>(out),
      static_cast<float*>(ws), K, S, G, bs, nb, per,
      scale * 1.4426950408889634f};
  return launch<T, KV, HD>(a, static_cast<const int*>(off),
                           static_cast<const int*>(ntok), B, n_split, stream);
}

// KV = T when `int8` is false, else int8_t with the scale plane.
static int dispatch(int dtype, bool int8, const void* q, const void* kn,
                    const void* vn, const void* kp, const void* vp,
                    const float* ks, const float* kt, const float* vs,
                    const float* vt, const void* tables, const void* off,
                    const void* ntok, void* out, void* ws, int B, int K,
                    int S, int G, int h, int bs, int nb, int n_split, int per,
                    float scale, void* stream) {
  const long long SG = (long long)S * G;
  if (B < 1 || K < 1 || S < 1 || G < 1 || bs < 1 || nb < 1 ||
      (long long)B * K > 65535 ||
      (SG + 16 * SV_WARPS - 1) / (16 * SV_WARPS) > 65535 || n_split < 1 ||
      per < 1 || (long long)n_split * per < nb ||
      (n_split > 1 && (ws == nullptr || SG > 65535)))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SV_CASE(T, HD)                                                      \
  if (h == HD)                                                              \
    return int8 ? run<T, int8_t, HD>(q, kn, vn, kp, vp, ks, kt, vs, vt,     \
                                     tables, off, ntok, out, ws, B, K, S,   \
                                     G, bs, nb, n_split, per, scale, s)     \
                : run<T, T, HD>(q, kn, vn, kp, vp, ks, kt, vs, vt, tables,  \
                                off, ntok, out, ws, B, K, S, G, bs, nb,     \
                                n_split, per, scale, s);
  if (dtype == 0) {
    SV_CASE(float, 32) SV_CASE(float, 64) SV_CASE(float, 128)
    SV_CASE(float, 256)
  } else if (dtype == 1) {
    SV_CASE(__nv_bfloat16, 32) SV_CASE(__nv_bfloat16, 64)
    SV_CASE(__nv_bfloat16, 128) SV_CASE(__nv_bfloat16, 256)
  }
#undef SV_CASE
  return -1;
}

// dtype (of q, out, the window's keys and the pages): 0 = float32,
// 1 = bfloat16. The grid is (n_split, ceil(S·G / 32), B·K); split s takes
// table entries [s·per, (s+1)·per) (kernels/paged_decode.py::
// prefill_splits). ws: float32 workspace of B·K·n_split·S·G·(h + 2) floats
// (may be null when n_split = 1). Returns 0 on success, a cudaError_t value
// after a failed launch, or -1 for a shape the kernel does not take.
extern "C" int spec_verify_launch(int dtype, const void* q, const void* kn,
                                  const void* vn, const void* kp,
                                  const void* vp, const void* tables,
                                  const void* off, const void* ntok,
                                  void* out, void* ws, int B, int K, int S,
                                  int G, int h, int bs, int nb, int n_split,
                                  int per, float scale, void* stream) {
  return dispatch(dtype, false, q, kn, vn, kp, vp, nullptr, nullptr, nullptr,
                  nullptr, tables, off, ntok, out, ws, B, K, S, G, h, bs, nb,
                  n_split, per, scale, stream);
}

// The same over int8 history pages with their scale plane: ks/vs [N, K, h]
// and kt/vt [N, K, bs], float32 (the window's keys stay in q's type).
extern "C" int spec_verify_int8_launch(
    int dtype, const void* q, const void* kn, const void* vn, const void* kp,
    const void* vp, const void* ks, const void* kt, const void* vs,
    const void* vt, const void* tables, const void* off, const void* ntok,
    void* out, void* ws, int B, int K, int S, int G, int h, int bs, int nb,
    int n_split, int per, float scale, void* stream) {
  return dispatch(dtype, true, q, kn, vn, kp, vp,
                  static_cast<const float*>(ks), static_cast<const float*>(kt),
                  static_cast<const float*>(vs), static_cast<const float*>(vt),
                  tables, off, ntok, out, ws, B, K, S, G, h, bs, nb, n_split,
                  per, scale, stream);
}
