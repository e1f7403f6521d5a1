// Quest-style block scores and the top-k block table of OmniAttn online
// sparsity on Hopper (sm_90a), plain C interface for ctypes.
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
// `block_topk_select_launch` also does, in the same launch, the selection
// that the reference keeps in jnp after the scores
// (src/repro/models/attention.py::select_kv_blocks; the port's plain
// version is kernels/block_topk.py::select_kv_blocks): forced sink and
// recent blocks, the rest ranked by score (a stable descending order: equal
// scores go to the lower logical index), the per-slot budget, and the
// compacted table in ascending logical order with null-block padding. Its
// tables, lens, counts and selection mask are bit-identical to that
// function applied to the scores this launch writes.
//
// What bounds it on the card: bytes. Each resident block contributes 2·K·h
// float32 summary values (1 KB per block at K = 2, h = 128) and ~4·K·G·h
// flops, about one flop per byte; the ranking is integer work on nb keys
// in shared memory (h = 256 and G = 48 take the same path: a kv head's
// row of summaries spans two 32-lane passes at h = 256, summed before the
// head's reduction; the q rows, K·G·h values, stay in shared memory).
// Design:
//   * a thread-block cluster per slot (grid [cluster, B]); `plan` gives
//     the cluster size (at most 8 CTAs, about 32 tabled blocks each) and
//     each CTA's share from nb alone, so the grid depends on shapes only
//     and a launch reads nothing on the host (capturable);
//   * each CTA copies the slot's query rows into shared memory (cp.async)
//     while each warp reads its table entries and issues the 16-byte loads
//     of its first blocks' flat K·h summary rows (up to 8 float4 loads per
//     operand in flight): two dependent memory round trips, not four; a
//     block at or past lens[b] reads no summary. The blocks' sums of one
//     (kv head, query row) reduce over the head's lanes together (a
//     butterfly that halves the values each lane holds), then the lanes
//     holding a block take the max over (K, G);
//   * select mode: each score becomes a 64-bit key in the leader CTA's
//     shared memory, written through distributed shared memory: the high
//     word is the adjusted score (+inf forced, -inf non-resident) mapped to
//     an order-preserving uint32 and inverted (a descending order; -0 ties
//     with +0, NaN first as torch.sort ranks it), the low word the logical
//     index, so an ascending sort of the keys is the stable descending
//     order of the scores. After a cluster barrier the leader sorts the keys
//     (bitonic: one key per thread, partners within a warp by shuffles,
//     for tables of up to 256 entries; in shared memory beyond), flags the
//     first min(budget, k_static), writes the mask and places each flagged
//     block by a block-wide prefix sum over the flags in logical order. No
//     float arithmetic after the scores except the frac budget, rounded in
//     float32 as torch does;
//   * the decode step's stats fold in: a slot's kept count depends on
//     lens alone, so slot 0's leader sums mask·n_res and mask·m over the
//     slots into aux[4] while the scores load, and no eager op follows the
//     launch.
// `block_topk_select_scores_launch` is select mode on scores given (a CTA
// per slot, no score pass): over tensor-parallel ranks each rank scores its
// own heads with `block_topk_launch`, the scores are max-reduced across the
// ranks, and this entry ranks and compacts them, the same on every rank.
// Limit: a table of at most NB_MAX = 8192 entries (131,072 tokens at
// bs 16; qwen2-1.5b's 32,768-token context needs 2,048), keys 64 KB of
// shared memory. The wrapper raises past it.
#include <cooperative_groups.h>

#include "attn_tile.cuh"

namespace cg = cooperative_groups;
using namespace paged;

namespace topk {

constexpr int THREADS = 256;         // 8 warps per CTA
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 8;       // portable cluster size
constexpr int MIN_SHARE = 32;        // tabled blocks per CTA before it grows
constexpr int NB_MAX = 8192;
constexpr int LOADS = 8;             // float4 loads in flight per operand

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Cluster size and each CTA's share of the nb tabled blocks (CTA r scores
// [r·per, min((r+1)·per, nb))). Mirrored by kernels/block_topk.py::
// topk_cluster_plan; chip_smoke.py holds the two against each other.
__host__ __device__ inline int plan(int nb, int* cluster, int* per) {
  if (nb < 1 || nb > NB_MAX) return -1;
  int c = (nb + MIN_SHARE - 1) / MIN_SHARE;
  c = c > MAX_CLUSTER ? MAX_CLUSTER : c;
  *cluster = c;
  *per = (nb + c - 1) / c;
  return 0;
}

struct Args {
  const void* q;             // [B, K, G, HD] float32 / bfloat16
  const float* kmin;         // [N, K, HD]
  const float* kmax;
  const int* tables;         // [B, nb]
  const int* lens;           // [B]
  float* scores;             // [B, nb]
  int* new_tables;           // select mode: [B, k_static]
  int* new_lens;             // [B]
  int* m;                    // [B]
  unsigned char* selected;   // [B, nb] (torch.bool)
  const unsigned char* mask; // [B] live slots (torch.bool) or null: all live
  float* aux;                // [4] or null: Σ mask·n_res, Σ mask·m, 0, 0
  int B, K, G, nb, bs, per;
  int k_static, use_frac, sink, recent;
  float frac;
};

__device__ __forceinline__ unsigned desc_code(float x) {
  if (x != x) return 0u;                           // NaN ranks first
  unsigned u = __float_as_uint(x == 0.f ? 0.f : x);  // -0 ties with +0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending order
  return ~u;                                       // descending
}

__device__ __forceinline__ int floor_div(int a, int b) {   // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Keys the leader sorts: nb padded to a power of two, at least one per
// thread (a table of up to THREADS entries sorts in registers).
__host__ __device__ inline int sort_width(int nb) {
  const int p = pow2_at_least(nb);
  return p < THREADS ? THREADS : p;
}

// Dynamic shared memory: the raw q rows (elements of `esize` bytes), then
// in select mode the keys (sort_width(nb) of them) and one flag byte per
// tabled block.
__host__ __device__ inline size_t smem_bytes(int K, int G, int HD, int nb,
                                             int esize, bool select) {
  size_t n = align16((size_t)K * G * HD * esize);
  if (select) n += (size_t)sort_width(nb) * 8 + align16(nb);
  return n;
}

// Four query channels as float32 from the raw rows in shared memory.
template <typename T>
__device__ __forceinline__ float4 q_chunk(const T* qs, int i);
template <>
__device__ __forceinline__ float4 q_chunk<float>(const float* qs, int i) {
  return reinterpret_cast<const float4*>(qs)[i];
}
template <>
__device__ __forceinline__ float4 q_chunk<__nv_bfloat16>(
    const __nv_bfloat16* qs, int i) {
  const uint2 raw = reinterpret_cast<const uint2*>(qs)[i];
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
  return make_float4(__bfloat162float(e[0]), __bfloat162float(e[1]),
                     __bfloat162float(e[2]), __bfloat162float(e[3]));
}

// A lane takes float4 chunks lane + 32·t of a block's K·HD summaries; a kv
// head's row is HD/4 chunks, so past HD = 128 one head spans parts() = HD/128
// consecutive t (its chunks lane, lane + 32, ...), summed before the
// reduction over the head's lanes.
template <int HD>
__host__ __device__ constexpr int parts() { return HD / 4 > 32 ? HD / 128 : 1; }

// Score this CTA's share [j0, j1) of slot b's tabled blocks; in select
// mode each score's key goes to `lead` (the leader CTA's key array). The
// query rows arrive in `qs` by cp.async: each warp first issues its table
// entries' and first blocks' summary loads, then `barrier()` waits for the
// rows (and, in select mode, for the cluster), so the query copy, the
// table read and the summary read overlap.
template <typename T, int HD, int TG, bool SELECT, typename Barrier>
__device__ __forceinline__ void score_share(const Args& a, const T* qs,
                                            unsigned long long* lead, int b,
                                            int j0, int j1, int L,
                                            int n_res, Barrier barrier) {
  constexpr int CPH = HD / 4;          // float4 chunks per kv-head row
  constexpr int U = LOADS / TG;        // blocks in flight per warp
  constexpr int RED = CPH < 32 ? CPH : 32;
  constexpr int PARTS = parts<HD>();
  static_assert(TG % PARTS == 0, "a kv head's chunks in one batch");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nch = a.K * CPH;           // chunks of a block's K·HD floats
  const int n_t = (nch + 31) / 32;     // chunks per lane
  const float4* lo4 = reinterpret_cast<const float4*>(a.kmin);
  const float4* hi4 = reinterpret_cast<const float4*>(a.kmax);
  const int* tb = a.tables + (size_t)b * a.nb;
  bool res[U];
  size_t row[U];
  float4 lo[U][TG], hi[U][TG];
  auto rows = [&](int jb) {            // table entries: no wait on lens
    int phys[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = jb + u * WARPS;
      phys[u] = j < j1 ? __ldg(tb + j) : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = jb + u * WARPS;
      res[u] = j < j1 && (long long)j * a.bs < L;
      row[u] = (size_t)phys[u] * nch;
    }
  };
  auto load = [&](int t0) {            // a block past lens reads nothing
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int t = 0; t < TG; ++t) {
        const int c = lane + 32 * (t0 + t);
        if (res[u] && c < nch) {
          lo[u][t] = __ldg(lo4 + row[u] + c);
          hi[u][t] = __ldg(hi4 + row[u] + c);
        } else {
          lo[u][t] = hi[u][t] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
  };
  // The U blocks' sums of one (kv head, query row) reduce over a kv head's
  // RED lanes together: each butterfly step halves the values a lane
  // holds (the lower lane keeps the lower half), so after log2(U) steps a
  // lane holds one block's sum — block `ul`, from the lane bits UMASK —
  // and the remaining steps finish it: U - 1 + log2(RED / U) shuffles
  // instead of U · log2(RED).
  constexpr int LOG_U = U == 8 ? 3 : U == 4 ? 2 : U == 2 ? 1 : 0;
  constexpr int UMASK = (RED - 1) & ~(RED / U - 1);
  int ul = 0;
#pragma unroll
  for (int i = 0; i < LOG_U; ++i)
    ul = 2 * ul + ((lane & (RED >> (i + 1))) ? 1 : 0);
  int jb = j0 + warp;
  rows(jb);
  load(0);
  barrier();
  for (; jb < j1; jb += WARPS * U) {
    float best = neg_inf();            // over (kv head, query row), block ul
    for (int t0 = 0; t0 < n_t; t0 += TG) {
      if (t0 > 0) load(t0);
#pragma unroll
      for (int t = 0; t < TG; t += PARTS) {
        const int c = lane + 32 * (t0 + t);
        const bool cv = c < nch;       // uniform over a kv head's lanes
        const int kh = c / CPH, c4 = c % CPH;
        for (int g = 0; g < a.G; ++g) {
          float v[U];
#pragma unroll
          for (int p = 0; p < PARTS; ++p) {
            const float4 x =
                cv ? q_chunk<T>(qs, (kh * a.G + g) * CPH + c4 + 32 * p)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const float4 l = lo[u][t + p], h = hi[u][t + p];
              const float e =
                  fmaxf(x.x * l.x, x.x * h.x) + fmaxf(x.y * l.y, x.y * h.y)
                  + fmaxf(x.z * l.z, x.z * h.z) + fmaxf(x.w * l.w, x.w * h.w);
              v[u] = p == 0 ? e : v[u] + e;
            }
          }
#pragma unroll
          for (int i = 0; i < LOG_U; ++i) {
            const int o = RED >> (i + 1);
            const bool upper = (lane & o) != 0;
            const int half = U >> (i + 1);
#pragma unroll
            for (int k = 0; k < (U >> 1); ++k) {
              if (k < half) {
                const float send = upper ? v[k] : v[k + half];
                const float keep = upper ? v[k + half] : v[k];
                v[k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
              }
            }
          }
#pragma unroll
          for (int o = (RED / U) / 2; o > 0; o >>= 1)
            v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
          if (cv) best = fmaxf(best, v[0]);
        }
      }
    }
    // the max over kv heads and query rows: the lanes that hold block ul
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      if ((o & UMASK) == 0) best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, o));
    bool was[U];
#pragma unroll
    for (int u = 0; u < U; ++u) was[u] = res[u];
    if (jb + WARPS * U < j1) {         // the next blocks' loads go out now
      rows(jb + WARPS * U);
      load(0);
    }
    const int j = jb + ul * WARPS;
    bool res_ul = false;
#pragma unroll
    for (int u = 0; u < U; ++u) res_ul = (u == ul) ? was[u] : res_ul;
    if ((lane & ~UMASK) == 0 && j < j1) {
      const float sc = res_ul ? best : NEG_INF;
      a.scores[(size_t)b * a.nb + j] = sc;
      if constexpr (SELECT) {
        const bool forced = j < a.sink || j >= n_res - a.recent;
        const float adj = !res_ul ? neg_inf() : (forced ? pos_inf() : sc);
        lead[j] = ((unsigned long long)desc_code(adj) << 32) | (unsigned)j;
      }
    }
  }
}

// Blocks a slot keeps, as select_kv_blocks counts them: the budget
// (frac·n_res rounded in float32, as torch does, floored at the forced
// keeps), at most n_res and k_static. It depends on lens alone.
__device__ __forceinline__ int kept_blocks(const Args& a, int n_res) {
  int kb = a.k_static;
  if (a.use_frac) {
    kb = (int)ceilf(__fmul_rn(a.frac, (float)n_res));
    kb = max(kb, a.sink + a.recent);
  }
  kb = min(kb, n_res);
  return max(0, min(kb, a.k_static));
}

// The decode step's stats over the slots: [Σ mask·n_res, Σ mask·m, 0, 0].
// Small integers in float32, exact in any order, so exactly torch's sums.
__device__ __forceinline__ void step_stats(const Args& a) {
  __shared__ float part[2][WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float sc = 0.f, at = 0.f;
  for (int i = tid; i < a.B; i += THREADS) {
    const float act = a.mask == nullptr ? 1.f : (a.mask[i] ? 1.f : 0.f);
    const int n_res = floor_div(a.lens[i] + a.bs - 1, a.bs);
    sc += act * (float)n_res;
    at += act * (float)kept_blocks(a, n_res);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sc += __shfl_xor_sync(0xffffffffu, sc, o);
    at += __shfl_xor_sync(0xffffffffu, at, o);
  }
  if (lane == 0) part[0][warp] = sc, part[1][warp] = at;
  __syncthreads();
  if (tid == 0) {
    sc = at = 0.f;
    for (int w = 0; w < WARPS; ++w) sc += part[0][w], at += part[1][w];
    a.aux[0] = sc;
    a.aux[1] = at;
    a.aux[2] = a.aux[3] = 0.f;
  }
}

// The leader CTA of slot b: sort the keys, flag the chosen blocks, write
// the mask, the compacted table, lens and the count.
__device__ __forceinline__ void rank_and_compact(const Args& a,
                                                 unsigned long long* keys,
                                                 unsigned char* flags, int b,
                                                 int L, int n_res) {
  __shared__ int wsum[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = a.nb, P2 = sort_width(nb);
  if (P2 == THREADS) {
    // one key per thread: partners within a warp by shuffles, the others
    // through shared memory
    unsigned long long x = keys[tid];
    for (int k = 2; k <= THREADS; k <<= 1) {
      for (int jj = k >> 1; jj > 0; jj >>= 1) {
        unsigned long long y;
        if (jj >= 32) {
          __syncthreads();
          keys[tid] = x;
          __syncthreads();
          y = keys[tid ^ jj];
        } else {
          y = __shfl_xor_sync(0xffffffffu, x, jj);
        }
        // the pair's lower position keeps the min in an ascending run
        x = (((tid & jj) == 0) == ((tid & k) == 0)) ? (x < y ? x : y)
                                                    : (x < y ? y : x);
      }
    }
    __syncthreads();
    keys[tid] = x;
    __syncthreads();
  } else {
    for (int k = 2; k <= P2; k <<= 1) {
      for (int jj = k >> 1; jj > 0; jj >>= 1) {
        for (int i = tid; i < P2 / 2; i += THREADS) {
          const int lo = 2 * i - (i & (jj - 1));
          const int hi = lo + jj;
          const unsigned long long x = keys[lo], y = keys[hi];
          if ((x > y) == ((lo & k) == 0)) {
            keys[lo] = y;
            keys[hi] = x;
          }
        }
        __syncthreads();
      }
    }
  }
  const int m = kept_blocks(a, n_res);
  for (int p = tid; p < m; p += THREADS) flags[(unsigned)keys[p]] = 1;
  __syncthreads();
  unsigned char* sel = a.selected + (size_t)b * nb;
  for (int j = tid; j < nb; j += THREADS) sel[j] = flags[j];
  // each thread a contiguous run of flags; an exclusive scan of the runs'
  // counts places every flagged block in logical order
  const int ch = (nb + THREADS - 1) / THREADS;
  const int s0 = min(tid * ch, nb), s1 = min(s0 + ch, nb);
  int cnt = 0;
  for (int j = s0; j < s1; ++j) cnt += flags[j];
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int pos = incl - cnt;
  for (int w = 0; w < warp; ++w) pos += wsum[w];
  int* nt = a.new_tables + (size_t)b * a.k_static;
  const int* tb = a.tables + (size_t)b * nb;
  for (int j = s0; j < s1; ++j)
    if (flags[j]) nt[pos++] = tb[j];
  for (int p = m + tid; p < a.k_static; p += THREADS) nt[p] = 0;
  if (tid == 0) {
    a.m[b] = m;
    a.new_lens[b] = max(m - 1, 0) * a.bs + (L - (n_res - 1) * a.bs);
  }
}

template <typename T, int HD, int TG, bool SELECT>
__global__ void __launch_bounds__(THREADS) block_topk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  const int qn = a.K * a.G * HD;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(
      smem + align16((size_t)qn * sizeof(T)));
  const int nb = a.nb, b = blockIdx.y, rank = blockIdx.x;
  const int j0 = min(rank * a.per, nb), j1 = min(j0 + a.per, nb);
  const int L = a.lens[b];
  const int n_res = floor_div(L + a.bs - 1, a.bs);
  {  // the slot's query rows, raw, 16-byte asynchronous copies
    constexpr int VEC = 16 / sizeof(T);
    const T* q = static_cast<const T*>(a.q) + (size_t)b * qn;
    for (int i = threadIdx.x; i < qn / VEC; i += THREADS)
      cp_async16(qs + i * VEC, q + i * VEC);
    cp_async_commit();
  }
  if constexpr (SELECT) {
    cg::cluster_group cluster = cg::this_cluster();
    const int P2 = sort_width(nb);
    unsigned char* flags = reinterpret_cast<unsigned char*>(keys + P2);
    if (rank == 0) {
      for (int i = nb + threadIdx.x; i < P2; i += THREADS) keys[i] = ~0ull;
      for (int j = threadIdx.x; j < nb; j += THREADS) flags[j] = 0;
    }
    // every CTA of the cluster must run before a peer writes into the
    // leader's shared memory: arrive now, wait once q is staged
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    // slot 0's leader reckons the step's stats while its loads are out
    const bool stats = a.aux != nullptr && b == 0 && rank == 0;
    score_share<T, HD, TG, true>(a, qs, cluster.map_shared_rank(keys, 0), b,
                                 j0, j1, L, n_res, [&] {
                                   if (stats) step_stats(a);
                                   cp_async_wait<0>();
                                   __syncthreads();
                                   asm volatile("barrier.cluster.wait.aligned;\n"
                                                ::: "memory");
                                 });
    cluster.sync();   // every key is in the leader's shared memory
    if (rank == 0) rank_and_compact(a, keys, flags, b, L, n_res);
  } else {
    score_share<T, HD, TG, false>(a, qs, nullptr, b, j0, j1, L, n_res, [] {
      cp_async_wait<0>();
      __syncthreads();
    });
  }
}

template <typename T, int HD, int TG, bool SELECT>
static int launch(Args a, cudaStream_t stream) {
  int cluster = 0;
  if (plan(a.nb, &cluster, &a.per) != 0) return -1;
  const size_t smem = smem_bytes(a.K, a.G, HD, a.nb, (int)sizeof(T), SELECT);
  if (smem > 200 * 1024) return -1;
  auto kern = block_topk_kernel<T, HD, TG, SELECT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, a.B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// float4 chunks per lane: ceil(K·HD / 128), taken TG at a time (at least
// the parts() of one kv head's row, so a head's sum ends inside a batch)
template <typename T, int HD, bool SELECT>
static int launch_tg(const Args& a, cudaStream_t stream) {
  constexpr int P = parts<HD>();
  const int n_t = (a.K * HD / 4 + 31) / 32;
  if constexpr (P <= 1)
    if (n_t <= 1) return launch<T, HD, 1, SELECT>(a, stream);
  if constexpr (P <= 2)
    if (n_t <= 2) return launch<T, HD, 2, SELECT>(a, stream);
  if (n_t <= 4) return launch<T, HD, 4, SELECT>(a, stream);
  return launch<T, HD, 8, SELECT>(a, stream);
}

template <bool SELECT>
static int dispatch(int dtype, int h, const Args& a, cudaStream_t s) {
#define BT_CASE(T, HD) \
  if (h == HD) return launch_tg<T, HD, SELECT>(a, s);
  if (dtype == 0) {
    BT_CASE(float, 32) BT_CASE(float, 64) BT_CASE(float, 128)
    BT_CASE(float, 256)
  } else if (dtype == 1) {
    BT_CASE(__nv_bfloat16, 32) BT_CASE(__nv_bfloat16, 64)
    BT_CASE(__nv_bfloat16, 128) BT_CASE(__nv_bfloat16, 256)
  }
#undef BT_CASE
  return -1;
}

// Scores given: the ranking and compaction of select mode on scores [B, nb]
// that another pass wrote (over several tensor-parallel ranks, the max of
// each rank's score pass over its own heads). One CTA per slot: its keys
// are built from the scores exactly as score_share builds them, then
// rank_and_compact runs as in the fused launch, so the outputs are
// bit-identical to select_kv_blocks on the same scores.
__global__ void __launch_bounds__(THREADS) select_given_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  const int nb = a.nb, b = blockIdx.x, P2 = sort_width(nb);
  unsigned char* flags = reinterpret_cast<unsigned char*>(keys + P2);
  const int L = a.lens[b];
  const int n_res = floor_div(L + a.bs - 1, a.bs);
  const float* sc = a.scores + (size_t)b * nb;
  for (int j = threadIdx.x; j < P2; j += THREADS) {
    if (j < nb) {
      const bool res = (long long)j * a.bs < L;
      const bool forced = j < a.sink || j >= n_res - a.recent;
      const float adj =
          !res ? neg_inf() : (forced ? pos_inf() : __ldg(sc + j));
      keys[j] = ((unsigned long long)desc_code(adj) << 32) | (unsigned)j;
      flags[j] = 0;
    } else {
      keys[j] = ~0ull;
    }
  }
  if (a.aux != nullptr && b == 0) step_stats(a);   // uniform over the CTA
  __syncthreads();
  rank_and_compact(a, keys, flags, b, L, n_res);
}

static int launch_given(const Args& a, cudaStream_t stream) {
  int cluster = 0, per = 0;
  if (plan(a.nb, &cluster, &per) != 0) return -1;
  const size_t smem = (size_t)sort_width(a.nb) * 8 + align16(a.nb);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        select_given_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  select_given_kernel<<<a.B, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace topk

// The plan of a width-nb table: → 0 and (*cluster, *per), or -1 past the
// limit.
extern "C" int block_topk_plan(int nb, int* cluster, int* per) {
  return topk::plan(nb, cluster, per);
}

// dtype (of q): 0 = float32, 1 = bfloat16; summaries are float32. Returns 0
// on success, a cudaError_t value after a failed launch, or -1 for a shape
// the kernel does not take.
extern "C" int block_topk_launch(int dtype, const void* q, const void* kmin,
                                 const void* kmax, const void* tables,
                                 const void* lens, void* out, int B, int K,
                                 int G, int h, int nb, int bs, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || G < 1 || nb < 1 || bs < 1) return -1;
  topk::Args a = {};
  a.q = q;
  a.kmin = static_cast<const float*>(kmin);
  a.kmax = static_cast<const float*>(kmax);
  a.tables = static_cast<const int*>(tables);
  a.lens = static_cast<const int*>(lens);
  a.scores = static_cast<float*>(out);
  a.B = B, a.K = K, a.G = G, a.nb = nb, a.bs = bs;
  return topk::dispatch<false>(dtype, h, a, static_cast<cudaStream_t>(stream));
}

// The scores and the selection in one launch. use_frac != 0 takes the
// per-slot budget ceil(frac · n_res) floored at sink + recent; otherwise
// k_static. 1 <= k_static <= nb. With aux, the step's stats [Σ mask·n_res,
// Σ mask·m, 0, 0] (mask null: every slot live).
extern "C" int block_topk_select_launch(
    int dtype, const void* q, const void* kmin, const void* kmax,
    const void* tables, const void* lens, void* scores, void* new_tables,
    void* new_lens, void* m, void* selected, const void* mask, void* aux,
    int B, int K, int G, int h, int nb, int bs, int k_static, int use_frac,
    float frac, int sink, int recent, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || G < 1 || nb < 1 || bs < 1 ||
      k_static < 1 || k_static > nb)
    return -1;
  topk::Args a = {};
  a.q = q;
  a.kmin = static_cast<const float*>(kmin);
  a.kmax = static_cast<const float*>(kmax);
  a.tables = static_cast<const int*>(tables);
  a.lens = static_cast<const int*>(lens);
  a.scores = static_cast<float*>(scores);
  a.new_tables = static_cast<int*>(new_tables);
  a.new_lens = static_cast<int*>(new_lens);
  a.m = static_cast<int*>(m);
  a.selected = static_cast<unsigned char*>(selected);
  a.mask = static_cast<const unsigned char*>(mask);
  a.aux = static_cast<float*>(aux);
  a.B = B, a.K = K, a.G = G, a.nb = nb, a.bs = bs;
  a.k_static = k_static, a.use_frac = use_frac, a.frac = frac;
  a.sink = sink, a.recent = recent;
  return topk::dispatch<true>(dtype, h, a, static_cast<cudaStream_t>(stream));
}

// The ranking and compaction of block_topk_select_launch on given float32
// scores [B, nb] (no score pass): the same budget, keys, sort, mask,
// compacted table, lens, counts and stats. Returns as the other entries.
extern "C" int block_topk_select_scores_launch(
    const void* scores, const void* tables, const void* lens,
    void* new_tables, void* new_lens, void* m, void* selected,
    const void* mask, void* aux, int B, int nb, int bs, int k_static,
    int use_frac, float frac, int sink, int recent, void* stream) {
  if (B < 1 || nb < 1 || bs < 1 || k_static < 1 || k_static > nb) return -1;
  topk::Args a = {};
  a.tables = static_cast<const int*>(tables);
  a.lens = static_cast<const int*>(lens);
  a.scores = static_cast<float*>(const_cast<void*>(scores));
  a.new_tables = static_cast<int*>(new_tables);
  a.new_lens = static_cast<int*>(new_lens);
  a.m = static_cast<int*>(m);
  a.selected = static_cast<unsigned char*>(selected);
  a.mask = static_cast<const unsigned char*>(mask);
  a.aux = static_cast<float*>(aux);
  a.B = B, a.nb = nb, a.bs = bs;
  a.k_static = k_static, a.use_frac = use_frac, a.frac = frac;
  a.sink = sink, a.recent = recent;
  return topk::launch_given(a, static_cast<cudaStream_t>(stream));
}
