// Quest-style block scores for OmniAttn online top-k sparsity on Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `block_topk_scores` in
// src/repro/kernels/block_topk.py (pl.pallas_call at :95; layout adapter
// ops.py:69): for every tabled block j of sequence b,
//   score[b, j] = max over (kv head, query head) of
//                 sum_c max(q_c * kmin_c, q_c * kmax_c),
// an upper bound on any key dot-product inside the block, from the per-block
// key summaries kmin/kmax [N, K, h] (float32) that the arena keeps beside
// its [N, K, bs, h] blocks. Blocks whose logical range starts at or past
// lens[b] score NEG_INF = -1e30 (their table entries alias the null block).
//
// What bounds it on the card: bytes. Each resident block contributes 2·K·h
// float32 summary values (1 KB per block at K = 2, h = 128) and ~4·K·G·h
// flops, about one flop per byte. The TPU kernel walks the blocks of a
// sequence in order only so that one VMEM row can collect the scores; here
// every (sequence, block) score is independent, so the design spreads them
// over the whole card:
//   * one warp per tabled block, four warps per CTA, as many CTAs as the
//     blocks need (B·nb / 4: 384 CTAs at B = 6, nb = 256);
//   * each warp reads its own table entry and lens[b]; a block at or past
//     lens writes NEG_INF without touching its summaries;
//   * a warp reads one kv head's kmin/kmax rows coalesced (lane l takes
//     channels l, l + 32, ...: 512 B per row at h = 128) into registers,
//     reduces sum_c max(q·lo, q·hi) for each of the G query rows of the
//     group with warp shuffles, and keeps the running max over (K, G).
// Not done yet (later work): fusing the top-k selection and table
// compaction (today plain torch ops, as the reference keeps them in jnp).
#include "attn_tile.cuh"

using namespace paged;

constexpr int WARPS = NT / 32;   // tabled blocks per CTA

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
block_topk_kernel(const T* __restrict__ q, const float* __restrict__ kmin,
                  const float* __restrict__ kmax,
                  const int* __restrict__ tables,
                  const int* __restrict__ lens, float* __restrict__ out,
                  int B, int K, int G, int nb, int bs) {
  constexpr int CPL = HD / 32;   // channels per lane
  const int lane = threadIdx.x % 32;
  const long long gw = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (gw >= (long long)B * nb) return;
  const int b = (int)(gw / nb);
  const int j = (int)(gw % nb);
  if ((long long)j * bs >= lens[b]) {
    if (lane == 0) out[gw] = NEG_INF;
    return;
  }
  const int phys = tables[gw];
  float best = NEG_INF;
  for (int kh = 0; kh < K; ++kh) {
    const size_t srow = ((size_t)phys * K + kh) * HD;
    float lo[CPL], hi[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      lo[c] = kmin[srow + lane + 32 * c];
      hi[c] = kmax[srow + lane + 32 * c];
    }
    const T* qh = q + ((size_t)b * K + kh) * G * HD;
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const float x = to_f32<T>(qh[(size_t)g * HD + lane + 32 * c]);
        s += fmaxf(x * lo[c], x * hi[c]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      best = fmaxf(best, s);
    }
  }
  if (lane == 0) out[gw] = best;
}

template <typename T, int HD>
static int launch(const void* q, const void* kmin, const void* kmax,
                  const void* tables, const void* lens, void* out, int B,
                  int K, int G, int nb, int bs, cudaStream_t stream) {
  const long long n = (long long)B * nb;
  const int grid = (int)((n + WARPS - 1) / WARPS);
  block_topk_kernel<T, HD><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const float*>(kmin),
      static_cast<const float*>(kmax), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<float*>(out), B, K, G, nb,
      bs);
  return (int)cudaGetLastError();
}

// dtype (of q): 0 = float32, 1 = bfloat16; summaries are float32. Returns 0
// on success, a cudaError_t value after a failed launch, or -1 for a shape
// the kernel does not take.
extern "C" int block_topk_launch(int dtype, const void* q, const void* kmin,
                                 const void* kmax, const void* tables,
                                 const void* lens, void* out, int B, int K,
                                 int G, int h, int nb, int bs, void* stream) {
  if (B < 1 || K < 1 || G < 1 || nb < 1 || bs < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BT_CASE(T, HD)                                                     \
  if (h == HD)                                                             \
    return launch<T, HD>(q, kmin, kmax, tables, lens, out, B, K, G, nb, bs, \
                         s);
  if (dtype == 0) {
    BT_CASE(float, 32) BT_CASE(float, 64) BT_CASE(float, 128)
  } else if (dtype == 1) {
    BT_CASE(__nv_bfloat16, 32) BT_CASE(__nv_bfloat16, 64)
    BT_CASE(__nv_bfloat16, 128)
  }
#undef BT_CASE
  return -1;
}
