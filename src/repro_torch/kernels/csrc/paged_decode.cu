// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `paged_decode` in src/repro/kernels/paged_decode.py
// (pl.pallas_call at :145; layout adapter ops.py:53): one query token per
// sequence attends over its KV, which lives in fixed-size blocks of a global
// arena [N, K, bs, h] reached through a per-sequence block table [B, nb];
// lens [B] is the number of resident logical slots.
//
// What bounds it on the card: bytes. Every resident K/V block is read once
// per (sequence, kv head) and each element feeds only 2·G flops (G query
// rows of the GQA group). The design reads each resident block exactly once,
// from enough CTAs and with enough loads in flight to keep the memory busy
// (split-KV, "flash-decoding"; attn_tile.cuh's decode routines):
//   * grid (B, K·n_grp, n_split): split s of (sequence b, kv head kh)
//     owns table entries [s·per, (s+1)·per). n_split and per come from
//     shapes alone (kernels/paged_decode.py::decode_splits: about two CTAs
//     per SM), so the host never reads `lens` and a captured launch stays
//     valid;
//   * each CTA reads its own table entries and visits only blocks
//     j < ceil(lens / bs). Unlike the TPU kernel, whose grid fetches every
//     tabled block and skips only the compute, blocks past `lens` are never
//     touched; a split with no resident block adds exactly nothing;
//   * the G query rows of the group sit in shared memory, so one K/V read
//     serves all G rows (G = 6 on full-width qwen2-1.5b). A CTA holds at
//     most dec_gmax = 2048/h rows (16 at h = 128, 8 at h = 256, 25 at 80,
//     21 at 96: a lane keeps ceil(h/32) accumulators of each, the last
//     lanes' channels past h masked at h 80); a wider group (granite-34b: 48
//     query heads over one kv head) is cut into n_grp row groups of `rows`
//     rows, a further grid axis (kernels/paged_decode.py::
//     decode_row_groups). Each row group reads the kv head again — the
//     bytes bound counts them once, so at G = 48 the kernel moves three
//     times the bytes of its bound;
//   * the CTA's 4 warps take its chunks (≤ 16 rows of a block, ≤ 8 at
//     h = 256, whose stages would otherwise pass 227 KB) in turn, each
//     with a two-stage cp.async buffer, so the next chunk is in flight while
//     one computes. Scores are lane-parallel dot products, the softmax of
//     row r runs in lane r, P·V gives each lane ceil(h/32) columns; every warp
//     keeps its own online-softmax state and the warps merge by
//     log-sum-exp in shared memory;
//   * with n_split > 1 each CTA writes (m, l, acc[G][h]) in float32 to a
//     workspace the wrapper allocates, and a second small kernel merges the
//     splits: Σ e^{m_i−M}·acc_i / max(Σ e^{m_i−M}·l_i, 1e-30); with
//     n_split = 1 the CTA writes the output itself;
//   * online softmax in float32 with NEG_INF = -1e30 and l clamped at 1e-30,
//     as paged_decode.py:41 and :94 do (exp2 of log2e-prescaled scores).
//
// QuantPlane (int8 arenas, paged_decode.py:50-90): the pages are int8 and
// each block carries float32 scale rows, per-channel seal scales [N, K, h]
// and per-token scales [N, K, bs]. They travel with the block's payload in
// the same cp.async stage; each element is dequantized as it is read from
// shared memory with the one float32 product q · (scale != 0 ? scale : tok),
// per channel, as load_kv_tile does, so the softmax is the float path's.
// Only resident blocks' scale rows are read. An int8 block moves a quarter
// of a float32 block's payload bytes plus 2·(h + bs)·4 bytes of scales.
// The CTA's walk and merge are `decode_split_attend` in attn_tile.cuh,
// which sink_decode.cu shares.
// Not done yet (later work): TMA bulk copies with an mbarrier ring in place
// of per-lane cp.async, a merge by the last CTA of a split (one launch, not
// two).
#include "attn_tile.cuh"

using namespace paged;

// T: q and out (float / bf16); KV: the arena payload (T, or int8_t with the
// scale plane ks/kt/vs/vt, null otherwise). ws: [B·K][n_split][G] m, then
// the same of l, then [B·K][n_split][G][HD] acc (null when n_split = 1).
// grid (B, K·n_grp, n_split): row group gi of kv head kh holds query rows
// gi·rows .. min((gi + 1)·rows, G) − 1.
template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                    const KV* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ kt, const float* __restrict__ vs,
                    const float* __restrict__ vt,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens, T* __restrict__ out,
                    float* __restrict__ ws, int K, int G, int n_grp,
                    int rows, int bs, int nb, int per, float scale_log2) {
  constexpr int TR = dec_tr<HD>();
  const int b = blockIdx.x, sp = blockIdx.z;
  const int kh = blockIdx.y / n_grp, g0 = (blockIdx.y - kh * n_grp) * rows;
  const int nsp = gridDim.z;
  const int bk = b * K + kh;
  // This split's resident chunks: blocks [j0, j1), each cut into cpb chunks
  // of at most TR rows.
  const int len = lens[b];
  const int nblk = min((len + bs - 1) / bs, nb);
  const int j0 = sp * per;
  const int j1 = min(j0 + per, nblk);
  const int cpb = (bs + TR - 1) / TR;
  const int* tbl = tables + (size_t)b * nb;
  const size_t qoff = ((size_t)bk * G + g0) * HD;
  decode_split_attend<T, KV, HD>(
      q + qoff, out + qoff, ws, (size_t)gridDim.x * K * nsp * G,
      ((size_t)bk * nsp + sp) * G + g0, min(rows, G - g0),
      j1 > j0 ? (j1 - j0) * cpb : 0, len, scale_log2,
      [&](const DecStage<KV, HD>& st, int c) {
        const int j = j0 + c / cpb, r0 = (c % cpb) * TR;
        decode_stage_issue<KV, HD>(st, kp, vp, ks, kt, vs, vt, tbl[j], K, kh,
                                   bs, r0, min(TR, bs - r0));
      },
      [&](int c) {
        const int j = j0 + c / cpb, r0 = (c % cpb) * TR;
        return make_int2(j * bs + r0, min(TR, bs - r0));
      });
}

// Merge the n_split partial states: grid (B·K, G), one thread per column.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
paged_decode_combine(const float* __restrict__ ws, T* __restrict__ out,
                     int BK, int G, int nsp) {
  decode_combine<T, HD>(ws, out, BK, G, nsp);
}

template <typename T, typename KV, int HD>
static int launch(const void* q, const void* kp, const void* vp,
                  const float* ks, const float* kt, const float* vs,
                  const float* vt, const void* tables, const void* lens,
                  void* out, void* ws, int B, int K, int G, int n_grp,
                  int rows, int bs, int nb, int n_split, int per, float scale,
                  cudaStream_t stream) {
  if (rows > dec_gmax<HD>()) return -1;
  const size_t smem = decode_smem_bytes<KV, HD>(rows);
  auto kern = paged_decode_kernel<T, KV, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B, K * n_grp, n_split);
  float* w = n_split > 1 ? static_cast<float*>(ws) : nullptr;
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), ks, kt, vs, vt,
      static_cast<const int*>(tables), static_cast<const int*>(lens),
      static_cast<T*>(out), w, K, G, n_grp, rows, bs, nb, per,
      scale * 1.4426950408889634f);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  paged_decode_combine<T, HD><<<dim3(B * K, G), HD, 0, stream>>>(
      w, static_cast<T*>(out), B * K, G, n_split);
  return (int)cudaGetLastError();
}

// KV = T when `int8` is 0, else int8_t with the scale plane.
static int dispatch(int dtype, bool int8, const void* q, const void* kp,
                    const void* vp, const float* ks, const float* kt,
                    const float* vs, const float* vt, const void* tables,
                    const void* lens, void* out, void* ws, int B, int K,
                    int G, int h, int n_grp, int rows, int bs, int nb,
                    int n_split, int per, float scale, void* stream) {
  // every row group holds 1..rows rows (rows ≤ dec_gmax, checked per HD)
  if (G < 1 || rows < 1 || n_grp < 1 || (long long)n_grp * rows < G ||
      (long long)(n_grp - 1) * rows >= G || bs < 1 || nb < 1 || B < 1 ||
      K < 1 || (long long)K * n_grp > 65535 || n_split < 1 ||
      n_split > 65535 || per < 1 || (long long)n_split * per < nb ||
      (n_split > 1 && ws == nullptr))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PD_CASE(T, HD)                                                      \
  if (h == HD)                                                              \
    return int8 ? launch<T, int8_t, HD>(q, kp, vp, ks, kt, vs, vt, tables,  \
                                        lens, out, ws, B, K, G, n_grp,      \
                                        rows, bs, nb, n_split, per, scale,  \
                                        s)                                  \
                : launch<T, T, HD>(q, kp, vp, ks, kt, vs, vt, tables, lens, \
                                   out, ws, B, K, G, n_grp, rows, bs, nb,   \
                                   n_split, per, scale, s);
  if (dtype == 0) {
    PD_CASE(float, 32) PD_CASE(float, 64) PD_CASE(float, 80)
    PD_CASE(float, 96) PD_CASE(float, 128) PD_CASE(float, 256)
  } else if (dtype == 1) {
    PD_CASE(__nv_bfloat16, 32) PD_CASE(__nv_bfloat16, 64)
    PD_CASE(__nv_bfloat16, 80) PD_CASE(__nv_bfloat16, 96)
    PD_CASE(__nv_bfloat16, 128) PD_CASE(__nv_bfloat16, 256)
  }
#undef PD_CASE
  return -1;
}

// dtype (of q and out): 0 = float32, 1 = bfloat16; the pages have the same
// type. The G query rows of a kv head go in n_grp row groups of `rows`
// (kernels/paged_decode.py::decode_row_groups). ws: float32 workspace of
// B·K·n_split·G·(h + 2) floats (may be null when n_split = 1). Returns 0
// on success, a cudaError_t value after a failed launch, or -1 for a shape
// the kernel does not take.
extern "C" int paged_decode_launch(int dtype, const void* q, const void* kp,
                                   const void* vp, const void* tables,
                                   const void* lens, void* out, void* ws,
                                   int B, int K, int G, int h, int n_grp,
                                   int rows, int bs, int nb, int n_split,
                                   int per, float scale, void* stream) {
  return dispatch(dtype, false, q, kp, vp, nullptr, nullptr, nullptr,
                  nullptr, tables, lens, out, ws, B, K, G, h, n_grp, rows, bs,
                  nb, n_split, per, scale, stream);
}

// The same over int8 pages with their scale plane: ks/vs [N, K, h] and
// kt/vt [N, K, bs], float32.
extern "C" int paged_decode_int8_launch(int dtype, const void* q,
                                        const void* kp, const void* vp,
                                        const void* ks, const void* kt,
                                        const void* vs, const void* vt,
                                        const void* tables, const void* lens,
                                        void* out, void* ws, int B, int K,
                                        int G, int h, int n_grp, int rows,
                                        int bs, int nb, int n_split, int per,
                                        float scale, void* stream) {
  return dispatch(dtype, true, q, kp, vp, static_cast<const float*>(ks),
                  static_cast<const float*>(kt), static_cast<const float*>(vs),
                  static_cast<const float*>(vt), tables, lens, out, ws, B, K,
                  G, h, n_grp, rows, bs, nb, n_split, per, scale, stream);
}
