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
// rows of the GQA group), far below the ~20 flop/byte where float32 compute
// would take over. The design therefore reads each resident block exactly
// once and nothing else:
//   * one CTA per (sequence, kv head); the G query rows of the group sit in
//     shared memory, so one K/V tile read serves all G rows (G = 6 on
//     full-width qwen2-1.5b);
//   * the CTA reads its own table entries and loops only over blocks
//     j < ceil(lens / bs). Unlike the TPU kernel, whose grid fetches every
//     tabled block and skips only the compute, blocks past `lens` are never
//     touched;
//   * each [bs, h] tile is contiguous, loaded with 16-byte coalesced loads;
//   * online softmax in float32 with NEG_INF = -1e30 and l clamped at 1e-30,
//     as paged_decode.py:41 and :94 do.
//
// QuantPlane (int8 arenas, paged_decode.py:50-90): the pages are int8 and
// each block carries float32 scale rows, per-channel seal scales [N, K, h]
// and per-token scales [N, K, bs]. Before a block's tile is loaded, its K
// and V scale rows go into shared memory; each element is dequantized as it
// is written to shared memory (q · (scale != 0 ? scale : tok), one float32
// product, per channel), so the online softmax is the float path's. Only
// resident blocks' scale rows are read. An int8 block moves a quarter of a
// float32 block's payload bytes plus 2·(h + bs)·4 bytes of scales.
// Not done yet (later work): splitting the blocks of one sequence across
// CTAs (B·K = 12 CTAs on the main path leave most of the 132 SMs idle),
// cp.async/TMA double buffering, tensor-core products.
#include "attn_tile.cuh"

using namespace paged;

// T: q and out (float / bf16); KV: the arena payload (T, or int8_t with the
// scale plane ks/kt/vs/vt, null otherwise).
template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                    const KV* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ kt, const float* __restrict__ vs,
                    const float* __restrict__ vt,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens, T* __restrict__ out, int K,
                    int G, int bs, int nb, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = HD + 1;
  const int b = blockIdx.x, kh = blockIdx.y;
  float* Qs = smem;
  float* Ks = Qs + G * LD;
  float* Vs = Ks + bs * LD;
  float* P = Vs + bs * HD;
  float* M = P + G * bs;
  float* L = M + G;
  float* C = L + G;
  float* Ksc = C + G;        // scale rows (int8 arenas only)
  float* Ktk = Ksc + HD;
  float* Vsc = Ktk + bs;
  float* Vtk = Vsc + HD;

  const size_t qoff = ((size_t)b * K + kh) * G * HD;
  load_tile<T, HD>(Qs, LD, q + qoff, G, G);
  for (int r = threadIdx.x; r < G; r += NT) {
    M[r] = NEG_INF;
    L[r] = 0.f;
  }
  float acc[MAXR];
#pragma unroll
  for (int k = 0; k < MAXR; ++k) acc[k] = 0.f;
  const int len = lens[b];
  const int nblk = min((len + bs - 1) / bs, nb);
  __syncthreads();

  for (int j = 0; j < nblk; ++j) {
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
    const int slot0 = j * bs;
    tile_step<HD>(Qs, Ks, Vs, P, M, L, C, acc, G, bs, scale,
                  [=](int, int t) { return slot0 + t < len; });
  }
  store_rows<T, HD>(out + qoff, acc, L, G);
}

template <typename T, typename KV, int HD>
static int launch(const void* q, const void* kp, const void* vp,
                  const float* ks, const float* kt, const float* vs,
                  const float* vt, const void* tables, const void* lens,
                  void* out, int B, int K, int G, int bs, int nb, float scale,
                  cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(G, bs, HD) +
                      sizeof(float) * scale_smem_floats<KV>(HD, bs);
  auto kern = paged_decode_kernel<T, KV, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, K);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), ks, kt, vs, vt,
      static_cast<const int*>(tables), static_cast<const int*>(lens),
      static_cast<T*>(out), K, G, bs, nb, scale);
  return (int)cudaGetLastError();
}

// KV = T when `int8` is 0, else int8_t with the scale plane.
static int dispatch(int dtype, bool int8, const void* q, const void* kp,
                    const void* vp, const float* ks, const float* kt,
                    const float* vs, const float* vt, const void* tables,
                    const void* lens, void* out, int B, int K, int G, int h,
                    int bs, int nb, float scale, void* stream) {
  if (G < 1 || G > MAXR * (NT / h) || bs < 1 || nb < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PD_CASE(T, HD)                                                     \
  if (h == HD)                                                             \
    return int8 ? launch<T, int8_t, HD>(q, kp, vp, ks, kt, vs, vt, tables, \
                                        lens, out, B, K, G, bs, nb, scale, \
                                        s)                                 \
                : launch<T, T, HD>(q, kp, vp, ks, kt, vs, vt, tables, lens, \
                                   out, B, K, G, bs, nb, scale, s);
  if (dtype == 0) {
    PD_CASE(float, 32) PD_CASE(float, 64) PD_CASE(float, 128)
  } else if (dtype == 1) {
    PD_CASE(__nv_bfloat16, 32) PD_CASE(__nv_bfloat16, 64)
    PD_CASE(__nv_bfloat16, 128)
  }
#undef PD_CASE
  return -1;
}

// dtype (of q and out): 0 = float32, 1 = bfloat16; the pages have the same
// type. Returns 0 on success, a cudaError_t value after a failed launch, or
// -1 for a shape the kernel does not take.
extern "C" int paged_decode_launch(int dtype, const void* q, const void* kp,
                                   const void* vp, const void* tables,
                                   const void* lens, void* out, int B, int K,
                                   int G, int h, int bs, int nb, float scale,
                                   void* stream) {
  return dispatch(dtype, false, q, kp, vp, nullptr, nullptr, nullptr,
                  nullptr, tables, lens, out, B, K, G, h, bs, nb, scale,
                  stream);
}

// The same over int8 pages with their scale plane: ks/vs [N, K, h] and
// kt/vt [N, K, bs], float32.
extern "C" int paged_decode_int8_launch(int dtype, const void* q,
                                        const void* kp, const void* vp,
                                        const void* ks, const void* kt,
                                        const void* vs, const void* vt,
                                        const void* tables, const void* lens,
                                        void* out, int B, int K, int G, int h,
                                        int bs, int nb, float scale,
                                        void* stream) {
  return dispatch(dtype, true, q, kp, vp, static_cast<const float*>(ks),
                  static_cast<const float*>(kt), static_cast<const float*>(vs),
                  static_cast<const float*>(vt), tables, lens, out, B, K, G, h,
                  bs, nb, scale, stream);
}
