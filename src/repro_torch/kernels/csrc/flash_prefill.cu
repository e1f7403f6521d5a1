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
// feeds about 2·S·G/2 flops. The design puts the products on the tensor
// cores (attn_tile.cuh, `tc_tile_step`):
//   * one CTA of 4 warps per (sequence × kv head, tile of TC_BM = 64 query
//     rows); warp w owns 16 rows. Rows are consecutive (token, head) pairs
//     of one GQA group, so one K/V tile serves all G heads;
//   * Q·Kᵀ and P·V on mma.sync: bf16 m16n8k16 with float32 accumulators;
//     float32 through the 3xTF32 split on m16n8k8 (three TF32 products per
//     step keep float32 accuracy; one-pass TF32 would not);
//   * the online softmax on the accumulator fragments in registers (quad
//     shuffles for row max and sum, exp2 of log2e-prescaled scores); P goes
//     from the score fragments straight into the P·V product;
//   * key tiles of BN keys (32 in float32, 64 in bf16) double-buffered with
//     cp.async: tile j + 1 is in flight while tile j computes; padded shared
//     rows keep fragment loads free of bank conflicts; ~101 KB (float32) or
//     ~88 KB (bf16) of shared memory, two CTAs per SM; at h = 256 (gemma3)
//     ~197 KB / ~168 KB, one CTA per SM, and each thread keeps 128 output
//     accumulators (`TcRows<256>`) beside the 3xTF32 fragments; h = 80
//     (hubert-xlarge) and 96 (phi-3-vision) step through 10 / 12 k-tiles
//     of 8 (5 / 6 of 16 in bf16) and take ~67 KB / ~79 KB (float32);
//     bf16 Q and K rows at h 80 take a pad of 32 elements
//     (`tc_ldk`), so the 8-byte fragment loads stay conflict-free;
//   * key tiles wholly above the causal diagonal are never visited, nor are
//     tiles wholly outside every row's window that also lie outside the sink
//     (they contribute nothing); tiles visible to every row skip the mask;
//   * ragged tails (S not a multiple of BN, S·G not of 64) are masked and
//     zero-filled, so any bucketed length works, e.g. max_len = 4608;
//   * causal query tiles with the most keys launch first (blockIdx.y counts
//     from the last tile; the kv-head index is blockIdx.x);
//   * the same function as the TPU kernel: NEG_INF = -1e30 for masked
//     scores, l clamped at 1e-30.
// Not done yet (later work): wgmma on 64-row warpgroup tiles with TMA loads
// and an mbarrier ring (mma.sync and cp.async are used), a persistent grid.
#include "attn_tile.cuh"

using namespace paged;

// Keys per tile: 32 in float32 (two stages of 32 keys and the 64 query rows
// take ~101 KB, so two CTAs share an SM; 64 keys measured slower), 64 in
// bf16 (~88 KB).
template <typename T>
__host__ __device__ constexpr int flash_bn() { return kIsF32<T> ? 32 : 64; }

template <typename T, int HD>
constexpr size_t flash_smem_bytes() {
  constexpr int BN = flash_bn<T>();
  return sizeof(T) * ((size_t)TC_BM * tc_ldk<T, HD>() +
                      2 * (size_t)BN * (tc_ldk<T, HD>() + tc_ldv<T, HD>()));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int S,
                     int G, float scale_log2, int causal, int window,
                     int sink) {
  constexpr int BN = flash_bn<T>();
  constexpr int LDK = tc_ldk<T, HD>();
  constexpr int LDV = tc_ldv<T, HD>();
  constexpr int STAGE = BN * (LDK + LDV);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* stages = Qs + TC_BM * LDK;

  const int n = blockIdx.x;
  const int SG = S * G;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * TC_BM;  // heavy tiles first
  const int R = min(TC_BM, SG - r0);
  const int row0 = (threadIdx.x >> 5) * 16;
  const size_t qoff = ((size_t)n * SG + r0) * HD;
  const size_t kvoff = (size_t)n * S * HD;
  const int p_lo = r0 / G;               // first and last query token
  const int p_hi = (r0 + R - 1) / G;     // of this tile
  const int k_end = causal ? p_hi + 1 : S;

  auto skip = [&](int k0) {              // uniform over the CTA
    const int k_last = min(k0 + BN, S) - 1;
    return window > 0 && p_lo - k_last >= window && (sink <= 0 || k0 >= sink);
  };
  auto next = [&](int k0) {
    do k0 += BN; while (k0 < k_end && skip(k0));
    return k0;
  };
  auto issue = [&](int stage, int k0) {
    T* Ks = stages + stage * STAGE;
    const int rows = min(BN, S - k0);
    cp_rows<T, HD>(Ks, LDK, k + kvoff + (size_t)k0 * HD, HD, BN, rows);
    cp_rows<T, HD>(Ks + BN * LDK, LDV, v + kvoff + (size_t)k0 * HD, HD, BN,
                   rows);
  };

  cp_rows<T, HD>(Qs, LDK, q + qoff, HD, TC_BM, R);
  int k0 = skip(0) ? next(0) : 0;
  if (k0 < k_end) issue(0, k0);
  cp_async_commit();
  TcRows<HD> st;
  st.init();

  for (int it = 0; k0 < k_end; ++it) {
    const int kn = next(k0);
    if (kn < k_end) issue((it + 1) & 1, kn);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Ks = stages + (it & 1) * STAGE;
    const int k_last = min(k0 + BN, S) - 1;
    const bool masked = k0 + BN > S || (causal && k_last > p_lo) ||
                        (window > 0 && p_hi - k0 >= window && k_last >= sink);
    tc_tile_step<T, HD, BN>(Qs, Ks, Ks + BN * LDK, st, row0, scale_log2,
                            masked, [=](int r, int t) {
                              const int key = k0 + t;
                              const int p = (r0 + r) / G;
                              bool ok = key < S && (!causal || key <= p);
                              if (window > 0)
                                ok = ok && ((p - key) < window ||
                                            (sink > 0 && key < sink));
                              return ok;
                            });
    __syncthreads();                     // the stage is refilled next
    k0 = kn;
  }
  cp_async_wait<0>();
  tc_store_rows<T, HD>(out + qoff, st, row0, R);
}

template <typename T, int HD>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int N, int S, int G, float scale, int causal, int window,
                  int sink, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<T, HD>();
  auto kern = flash_prefill_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(N, (S * G + TC_BM - 1) / TC_BM);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, G,
      scale * 1.4426950408889634f, causal, window, sink);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. Returns 0 on success, a cudaError_t
// value after a failed launch, or -1 for a shape the kernel does not take.
extern "C" int flash_prefill_launch(int dtype, const void* q, const void* k,
                                    const void* v, void* out, int N, int S,
                                    int G, int h, float scale, int causal,
                                    int window, int sink, void* stream) {
  if (N < 1 || S < 1 || G < 1 || ((long long)S * G + TC_BM - 1) / TC_BM > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FP_CASE(T, HD)                                                     \
  if (h == HD)                                                             \
    return launch<T, HD>(q, k, v, out, N, S, G, scale, causal, window,     \
                         sink, s);
  if (dtype == 0) {
    FP_CASE(float, 32) FP_CASE(float, 64) FP_CASE(float, 80)
    FP_CASE(float, 96) FP_CASE(float, 128) FP_CASE(float, 256)
  } else if (dtype == 1) {
    FP_CASE(__nv_bfloat16, 32) FP_CASE(__nv_bfloat16, 64)
    FP_CASE(__nv_bfloat16, 80) FP_CASE(__nv_bfloat16, 96)
    FP_CASE(__nv_bfloat16, 128) FP_CASE(__nv_bfloat16, 256)
  }
#undef FP_CASE
  return -1;
}
