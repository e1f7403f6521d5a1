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
// What bounds it on the card: operations. At the main-path shapes (S = 128,
// G = 6, h = 128) each K/V element read feeds 2·S·G = 1,536 flops, far
// above the card's ~50 flop/byte balance in float32 on tensor cores; at a
// 3,840-token history the chunk does 3 GFLOP against 4 MB of K/V. The
// design runs on the paged-history routine (attn_tile.cuh,
// `paged_tc_attend`):
//   * products on the tensor cores (`tc_tile_step`: mma.sync, float32
//     through the 3xTF32 split, bf16 m16n8k16), the online softmax in
//     registers, 64-row tiles of four 16-row warps — 12 row tiles per kv
//     head at the main chunk, each key tile serving all six GQA heads (96
//     row tiles at granite-34b's G = 48, S·G = 6,144; at h = 256 a thread
//     keeps 128 output accumulators and the CTA ~132 KB float32 / ~168 KB
//     bf16 of shared memory);
//   * the history split over CTAs from shapes alone (`prefill_splits`:
//     B·K·row tiles·splits ≈ 2 CTAs per SM), each split walking only its
//     resident table entries, key tiles staged by cp.async through the
//     table (double-buffered; int8 pages dequantized through registers);
//     the chunk's keys on the last split; a second small kernel merges the
//     splits by log-sum-exp (none when there is one split);
//   * the TPU kernel's function exactly: masked scores NEG_INF = -1e30
//     (sink+window on absolute positions, history tok < off, chunk
//     u < chunk_len), l clamped at 1e-30, so padded rows (>= chunk_len, or
//     past S·G in the last row tile) stay finite; they are never stored
//     out of bounds.
//
// QuantPlane (int8 arenas, paged_prefill.py:54-110): the HISTORY pages are
// int8 with their float32 scale plane; the chunk's own keys stay in q's
// type.
// Not done yet (later work): wgmma on 64-row warpgroup tiles with TMA
// loads, skipping history tiles outside every row's window.
#include "attn_tile.cuh"

using namespace paged;

constexpr int PP_WARPS = TC_WARPS;       // 64-row tiles

__device__ __forceinline__ bool allowed(int p, int t, int window, int sink) {
  bool ok = t <= p;
  if (window > 0) ok = ok && ((p - t) < window || (sink > 0 && t < sink));
  return ok;
}

// grid (n_split, row tiles, B·K)
template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(32 * PP_WARPS)
paged_prefill_kernel(PhArgs<T, KV> a, const int* __restrict__ off_a,
                     const int* __restrict__ cl_a, int window, int sink) {
  constexpr int BM = 16 * PP_WARPS;
  const int b = blockIdx.z / a.K, kh = blockIdx.z - b * a.K;
  const int r0 = blockIdx.y * BM;
  const int G = a.G;
  const int R = min(BM, a.S * G - r0);
  const int off = off_a[b];
  const int cl = cl_a[b];
  paged_tc_attend<T, KV, HD, PP_WARPS, ph_bn<T>()>(
      a, b, kh, r0, blockIdx.x, gridDim.x, off,
      min(cl, (r0 + R - 1) / G + 1), window <= 0,
      [=](int r, int key) {
        return allowed(off + (r0 + r) / G, key, window, sink);
      },
      [=](int r, int u) {
        return u < cl && allowed(off + (r0 + r) / G, off + u, window, sink);
      });
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
paged_prefill_combine(const float* __restrict__ ws, T* __restrict__ out,
                      int SG, int nsp) {
  ph_combine<T, HD>(ws, out, SG, nsp);
}

template <typename T, typename KV, int HD>
static int launch(const PhArgs<T, KV>& a, const int* off, const int* cl,
                  int B, int n_split, int window, int sink,
                  cudaStream_t stream) {
  constexpr int BM = 16 * PP_WARPS;
  const size_t smem = ph_smem_bytes<T, KV, HD, BM, ph_bn<T>()>(a.bs);
  auto kern = paged_prefill_kernel<T, KV, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const int SG = a.S * a.G;
  dim3 grid(n_split, (SG + BM - 1) / BM, B * a.K);
  kern<<<grid, 32 * PP_WARPS, smem, stream>>>(a, off, cl, window, sink);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  paged_prefill_combine<T, HD><<<dim3(B * a.K, SG), HD, 0, stream>>>(
      a.ws, a.out, SG, n_split);
  return (int)cudaGetLastError();
}

template <typename T, typename KV, int HD>
static int run(const void* q, const void* kn, const void* vn, const void* kp,
               const void* vp, const float* ks, const float* kt,
               const float* vs, const float* vt, const void* tables,
               const void* off, const void* cl, void* out, void* ws, int B,
               int K, int S, int G, int bs, int nb, int n_split, int per,
               float scale, int window, int sink, cudaStream_t stream) {
  const PhArgs<T, KV> a{
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), ks, kt, vs, vt,
      static_cast<const int*>(tables), static_cast<T*>(out),
      static_cast<float*>(ws), K, S, G, bs, nb, per,
      scale * 1.4426950408889634f};
  return launch<T, KV, HD>(a, static_cast<const int*>(off),
                           static_cast<const int*>(cl), B, n_split, window,
                           sink, stream);
}

// KV = T when `int8` is false, else int8_t with the scale plane.
static int dispatch(int dtype, bool int8, const void* q, const void* kn,
                    const void* vn, const void* kp, const void* vp,
                    const float* ks, const float* kt, const float* vs,
                    const float* vt, const void* tables, const void* off,
                    const void* cl, void* out, void* ws, int B, int K, int S,
                    int G, int h, int bs, int nb, int n_split, int per,
                    float scale, int window, int sink, void* stream) {
  const long long SG = (long long)S * G;
  if (B < 1 || K < 1 || S < 1 || G < 1 || bs < 1 || nb < 1 ||
      (long long)B * K > 65535 ||
      (SG + 16 * PP_WARPS - 1) / (16 * PP_WARPS) > 65535 || n_split < 1 ||
      per < 1 || (long long)n_split * per < nb ||
      (n_split > 1 && (ws == nullptr || SG > 65535)))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PP_CASE(T, HD)                                                      \
  if (h == HD)                                                              \
    return int8 ? run<T, int8_t, HD>(q, kn, vn, kp, vp, ks, kt, vs, vt,     \
                                     tables, off, cl, out, ws, B, K, S, G,  \
                                     bs, nb, n_split, per, scale, window,   \
                                     sink, s)                               \
                : run<T, T, HD>(q, kn, vn, kp, vp, ks, kt, vs, vt, tables,  \
                                off, cl, out, ws, B, K, S, G, bs, nb,       \
                                n_split, per, scale, window, sink, s);
  if (dtype == 0) {
    PP_CASE(float, 32) PP_CASE(float, 64) PP_CASE(float, 128)
    PP_CASE(float, 256)
  } else if (dtype == 1) {
    PP_CASE(__nv_bfloat16, 32) PP_CASE(__nv_bfloat16, 64)
    PP_CASE(__nv_bfloat16, 128) PP_CASE(__nv_bfloat16, 256)
  }
#undef PP_CASE
  return -1;
}

// dtype (of q, out, the chunk's keys and the pages): 0 = float32,
// 1 = bfloat16. The grid is (n_split, ceil(S·G / 64), B·K); split s takes
// table entries [s·per, (s+1)·per) (kernels/paged_decode.py::
// prefill_splits). ws: float32 workspace of B·K·n_split·S·G·(h + 2) floats
// (may be null when n_split = 1). Returns 0 on success, a cudaError_t value
// after a failed launch, or -1 for a shape the kernel does not take.
extern "C" int paged_prefill_launch(int dtype, const void* q, const void* kn,
                                    const void* vn, const void* kp,
                                    const void* vp, const void* tables,
                                    const void* off, const void* cl,
                                    void* out, void* ws, int B, int K, int S,
                                    int G, int h, int bs, int nb, int n_split,
                                    int per, float scale, int window,
                                    int sink, void* stream) {
  return dispatch(dtype, false, q, kn, vn, kp, vp, nullptr, nullptr, nullptr,
                  nullptr, tables, off, cl, out, ws, B, K, S, G, h, bs, nb,
                  n_split, per, scale, window, sink, stream);
}

// The same over int8 history pages with their scale plane: ks/vs [N, K, h]
// and kt/vt [N, K, bs], float32 (the chunk's keys stay in q's type).
extern "C" int paged_prefill_int8_launch(
    int dtype, const void* q, const void* kn, const void* vn, const void* kp,
    const void* vp, const void* ks, const void* kt, const void* vs,
    const void* vt, const void* tables, const void* off, const void* cl,
    void* out, void* ws, int B, int K, int S, int G, int h, int bs, int nb,
    int n_split, int per, float scale, int window, int sink, void* stream) {
  return dispatch(dtype, true, q, kn, vn, kp, vp,
                  static_cast<const float*>(ks), static_cast<const float*>(kt),
                  static_cast<const float*>(vs), static_cast<const float*>(vt),
                  tables, off, cl, out, ws, B, K, S, G, h, bs, nb, n_split,
                  per, scale, window, sink, stream);
}
