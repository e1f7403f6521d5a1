// Decode-step attention over a dense (sink‖ring, or full) KV cache for
// Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `sink_decode` in src/repro/kernels/sink_decode.py
// (pl.pallas_call at :74; layout adapter ops.py:40): one query token per
// sequence attends over the first min(t, W) slots of its cache, t [B] being
// the occupancy (t = pos + 1, which exceeds W once a ring has wrapped: then
// every slot is live; softmax is order-free, so no ring order is needed).
// q is [B, K, G, h]; the caches are read as [B, K, W, h] through element
// strides, so the model's own [B, W, K, h] layout is read in place — the
// TPU adapter's transposed copy of the whole cache is not carried over.
//
// What bounds it on the card: bytes. Each cached K/V element is read once
// per (sequence, kv head) and feeds only 2·G flops (G = 6 query rows on
// full-width qwen2-1.5b). The design reads each live slot exactly once,
// from enough CTAs and with enough loads in flight to keep the memory busy,
// on the split-KV routine it shares with paged_decode (attn_tile.cuh,
// `decode_split_attend`):
//   * grid (B, K·n_grp, n_split): split s of (sequence b, kv head kh)
//     owns the SINK_CHUNK = 16-slot chunks [s·per, (s+1)·per) of the cache
//     (staged 8 slots at a time at h = 256, `dec_tr`); a GQA group wider
//     than a CTA holds (`dec_gmax`: 16 rows at h = 128, 8 at h = 256, 25
//     at h = 80, 21 at h = 96) is
//     cut into n_grp row groups of `rows` rows, each re-reading the kv
//     head, as in paged_decode. n_split and per come
//     from shapes alone (kernels/sink_decode.py::sink_splits, paged_decode's
//     plan over ceil(W / 16) chunks: about two CTAs per SM), so the host
//     never reads t and a captured launch stays valid;
//   * a CTA walks only chunks below min(t, W) and stages only the live rows
//     of the last one: slots past the occupancy are never read, and a split
//     with no live slot adds exactly nothing (m = NEG_INF, l = 0);
//   * the G query rows of the group sit in shared memory, so one K/V read
//     serves all G rows;
//   * the CTA's 4 warps take its chunks in turn, each with a two-stage
//     cp.async buffer filled from the strided rows (`decode_stage_rows`:
//     rows ksw elements apart, 16-byte copies of each h-long row), so the
//     next chunk is in flight while one computes; the warps merge by
//     log-sum-exp in shared memory;
//   * with n_split > 1 each CTA writes (m, l, acc[G][h]) in float32 to a
//     workspace the wrapper allocates, and `sink_decode_combine` merges the
//     splits in a fixed order (no atomics);
//   * online softmax in float32 with NEG_INF = -1e30 and l clamped at 1e-30,
//     as the TPU kernel does (exp2 of log2e-prescaled scores).
// t >= 1 is required (every decode step writes its own token first).
// Not done yet (later work): TMA bulk copies in place of per-lane cp.async,
// a merge by the last CTA of a split (one launch, not two).
#include "attn_tile.cuh"

using namespace paged;

constexpr int SINK_CHUNK = 16;           // cache slots per plan chunk

// ws: [B·K][n_split][G] m, then the same of l, then [B·K][n_split][G][HD]
// acc (null when n_split = 1). grid (B, K·n_grp, n_split): row group gi of
// kv head kh holds query rows gi·rows .. min((gi + 1)·rows, G) − 1.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
sink_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, const int* __restrict__ t_a,
                   T* __restrict__ out, float* __restrict__ ws, int K, int G,
                   int n_grp, int rows, int W, long long ksb, long long ksk,
                   long long ksw, long long vsb, long long vsk, long long vsw,
                   int per, float scale_log2) {
  constexpr int TR = dec_tr<HD>();        // staged rows (divides 16)
  constexpr int SUB = SINK_CHUNK / TR;
  const int b = blockIdx.x, sp = blockIdx.z;
  const int kh = blockIdx.y / n_grp, g0 = (blockIdx.y - kh * n_grp) * rows;
  const int nsp = gridDim.z;
  const int bk = b * K + kh;
  const int n = min(t_a[b], W);          // live slots
  // this split's plan chunks [sp·per, (sp+1)·per), as staged chunks of TR
  // slots cut at the occupancy
  const int s0 = sp * per * SUB;
  const int s1 = min(s0 + per * SUB, (n + TR - 1) / TR);
  const T* kb = kc + b * ksb + kh * ksk;
  const T* vb = vc + b * vsb + kh * vsk;
  const size_t qoff = ((size_t)bk * G + g0) * HD;
  decode_split_attend<T, T, HD>(
      q + qoff, out + qoff, ws, (size_t)gridDim.x * K * nsp * G,
      ((size_t)bk * nsp + sp) * G + g0, min(rows, G - g0),
      s1 > s0 ? s1 - s0 : 0, n, scale_log2,
      [&](const DecStage<T, HD>& st, int c) {
        const int w0 = (s0 + c) * TR;
        decode_stage_rows<T, HD>(st, kb + w0 * ksw, vb + w0 * vsw,
                                 (size_t)ksw, (size_t)vsw, min(TR, n - w0));
      },
      [&](int c) {
        const int w0 = (s0 + c) * TR;
        return make_int2(w0, min(TR, n - w0));
      });
}

// Merge the n_split partial states: grid (B·K, G), one thread per column.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
sink_decode_combine(const float* __restrict__ ws, T* __restrict__ out,
                    int BK, int G, int nsp) {
  decode_combine<T, HD>(ws, out, BK, G, nsp);
}

template <typename T, int HD>
static int launch(const void* q, const void* kc, const void* vc,
                  const void* t, void* out, void* ws, int B, int K, int G,
                  int n_grp, int rows, int W, long long ksb, long long ksk,
                  long long ksw, long long vsb, long long vsk, long long vsw,
                  int n_split, int per, float scale, cudaStream_t stream) {
  if (rows > dec_gmax<HD>()) return -1;
  const size_t smem = decode_smem_bytes<T, HD>(rows);
  auto kern = sink_decode_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  float* w = n_split > 1 ? static_cast<float*>(ws) : nullptr;
  kern<<<dim3(B, K * n_grp, n_split), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(t),
      static_cast<T*>(out), w, K, G, n_grp, rows, W, ksb, ksk, ksw, vsb, vsk,
      vsw, per, scale * 1.4426950408889634f);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  sink_decode_combine<T, HD><<<dim3(B * K, G), HD, 0, stream>>>(
      w, static_cast<T*>(out), B * K, G, n_split);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; h is
// contiguous. The G query rows of a kv head go in n_grp row groups of
// `rows` (kernels/paged_decode.py::decode_row_groups). ws: float32
// workspace of B·K·n_split·G·(h + 2) floats (may be null when n_split =
// 1); split s takes the 16-slot chunks [s·per, (s+1)·per). Returns 0 on
// success, a cudaError_t value after a failed launch, or -1 for a shape the
// kernel does not take.
extern "C" int sink_decode_launch(int dtype, const void* q, const void* kc,
                                  const void* vc, const void* t, void* out,
                                  void* ws, int B, int K, int G, int h,
                                  int n_grp, int rows, int W, long long ksb,
                                  long long ksk, long long ksw, long long vsb,
                                  long long vsk, long long vsw, int n_split,
                                  int per, float scale, void* stream) {
  const long long n_chunks = (W + (long long)SINK_CHUNK - 1) / SINK_CHUNK;
  if (G < 1 || rows < 1 || n_grp < 1 || (long long)n_grp * rows < G ||
      (long long)(n_grp - 1) * rows >= G || B < 1 || K < 1 ||
      (long long)K * n_grp > 65535 || W < 1 || n_split < 1 ||
      n_split > 65535 || per < 1 || (long long)n_split * per < n_chunks ||
      (n_split > 1 && ws == nullptr))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SD_CASE(T, HD)                                                     \
  if (h == HD)                                                             \
    return launch<T, HD>(q, kc, vc, t, out, ws, B, K, G, n_grp, rows, W,   \
                         ksb, ksk, ksw, vsb, vsk, vsw, n_split, per, scale, \
                         s);
  if (dtype == 0) {
    SD_CASE(float, 32) SD_CASE(float, 64) SD_CASE(float, 80)
    SD_CASE(float, 96) SD_CASE(float, 128) SD_CASE(float, 256)
  } else if (dtype == 1) {
    SD_CASE(__nv_bfloat16, 32) SD_CASE(__nv_bfloat16, 64)
    SD_CASE(__nv_bfloat16, 80) SD_CASE(__nv_bfloat16, 96)
    SD_CASE(__nv_bfloat16, 128) SD_CASE(__nv_bfloat16, 256)
  }
#undef SD_CASE
  return -1;
}
