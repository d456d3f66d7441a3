// Flash-decode: the dense serving step's attention of head-packed
// block-diagonal queries (N, Hp, Q, PD) against contiguous head-packed
// caches (N, Hp, T, W), each sequence masked to its own length: plain
// decode (q_tokens = 1) and the speculative verify step's causal ladder
// (q_tokens > 1), over fp32/bf16 caches (W = PD), int8 caches (W = PD) or
// packed-nibble int4 caches (W = PD / 2) with fp32 scale planes
// (N, Hp, T, P). See decode_common.cuh for the math and the design.
//
// Replaces singa_tpu/ops/attention.py `_flash_decode_kernel` (launched by
// `_flash_decode_pallas`), every branch of it. The TPU grid (n, hp, t
// block) runs in order and carries the online softmax in VMEM scratch
// across t; here the T axis is split over blocks: `flash_decode_kernel`,
// grid (splits x row tiles, Hp, N), writes one partial per (n, hp, split,
// row) into the caller's workspace, and `flash_decode_kernel_merge`, grid
// (output blocks, Hp, N), combines them. Rows beyond 16 (the ladder at
// q_tokens * P * G > 16, up to 64) take further row tiles, each reading
// the same cache rows (from L2 after the first).
//
// Bound on the H100: bytes. Each live cache row and its scales are read
// once (2 * len * (W * sizeof(element) + 4 P) bytes per (n, hp)) for
// 4 * Q * PD flops per position, far below the card's ~295 flops per
// byte, so the floor is those bytes over 3.35 TB/s. The split puts
// N * Hp * splits blocks on the card (the host plans at least 2 x 132 where
// T allows) so a long sequence no longer sets the pace alone; the cp.async
// ring keeps 16-byte loads STAGES - 1 tiles ahead. Left out: skipping the
// block-diagonal zeros (it would change the function for dense q), tensor
// cores for the ladder's rows, and TMA.

#include "decode_common.cuh"

namespace {

template <bool SCALED>
struct DenseRows {
  static constexpr bool kScaled = SCALED, kTable = false;
  const uint8_t* K;   // this (n, hp)'s (T, W) slabs, as bytes
  const uint8_t* V;
  const float* KS;    // this (n, hp)'s (T, P) scale slabs (quantized)
  const float* VS;
  __device__ void prepare(long long*, int, int) const {}
  __device__ size_t row(const long long*, int, int t) const { return t; }
};

template <typename T, typename KV, bool SCALED>
__global__ void __launch_bounds__(sg_decode::NT, sg_decode::MINB)
flash_decode_kernel(const T* __restrict__ q, const KV* __restrict__ K,
                    const KV* __restrict__ V, const float* __restrict__ KS,
                    const float* __restrict__ VS,
                    const int* __restrict__ lengths, float* __restrict__ ws,
                    int Hp, int Q, int Tc, int PD, int P, int G,
                    int q_tokens, int chunk, int splits, float scale,
                    int vec16) {
  const int hp = blockIdx.y, n = blockIdx.z;
  const int len = max(lengths[n], 1);
  const size_t bo = (size_t)n * Hp + hp;
  const size_t slab = bo * Tc * sg_decode::Kv<KV>::row_bytes(PD);
  const DenseRows<SCALED> rows{
      reinterpret_cast<const uint8_t*>(K) + slab,
      reinterpret_cast<const uint8_t*>(V) + slab,
      SCALED ? KS + bo * Tc * P : nullptr,
      SCALED ? VS + bo * Tc * P : nullptr};
  const size_t parts = (size_t)gridDim.z * Hp * splits * Q;
  sg_decode::attend<T, KV>(q + bo * Q * PD, ws + bo * splits * Q * PD,
                           ws + parts * PD + bo * splits * Q * 2, Q, PD, len,
                           Tc, scale, q_tokens, P, G, chunk, splits,
                           vec16 != 0, rows);
}

template <typename T>
__global__ void __launch_bounds__(sg_decode::NT)
flash_decode_kernel_merge(const float* __restrict__ ws, T* __restrict__ o,
                          int Q, int PD, int splits) {
  const size_t bo = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t parts = (size_t)gridDim.z * gridDim.y * splits * Q;
  sg_decode::merge(ws + bo * splits * Q * PD,
                   ws + parts * PD + bo * splits * Q * 2, o + bo * Q * PD, Q,
                   PD, splits);
}

template <typename T, typename KV, bool SCALED>
cudaError_t launch(const void* q, const void* K, const void* V,
                   const void* KS, const void* VS, const void* lengths,
                   void* o, void* ws, int N, int Hp, int Q, int Tc, int PD,
                   int P, int G, int q_tokens, int chunk, int splits,
                   float scale, cudaStream_t stream) {
  using namespace sg_decode;
  const Geo geo(Kv<KV>::row_bytes(PD), Kv<KV>::LPC, SCALED ? P : 0,
                min(QT, Q), chunk, false);
  auto kern = flash_decode_kernel<T, KV, SCALED>;
  static SmemLimit limit, merge_limit;
  cudaError_t err =
      limit.need(reinterpret_cast<const void*>(kern), geo.bytes);
  if (err != cudaSuccess) return err;
  const int vec16 = geo.RB % 16 == 0 && aligned16(K) && aligned16(V);
  const dim3 grid(splits * ((Q + QT - 1) / QT), Hp, N);
  kern<<<grid, NT, geo.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(K),
      static_cast<const KV*>(V), static_cast<const float*>(KS),
      static_cast<const float*>(VS), static_cast<const int*>(lengths),
      static_cast<float*>(ws), Hp, Q, Tc, PD, P, G, q_tokens, chunk, splits,
      scale, vec16);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_merge(flash_decode_kernel_merge<T>, merge_limit,
                      static_cast<const float*>(ws), static_cast<T*>(o), N,
                      Hp, Q, PD, splits, stream);
}

template <typename T>
int dispatch(int kv, const void* q, const void* K, const void* V,
             const void* KS, const void* VS, const void* lengths, void* o,
             void* ws, int N, int Hp, int Q, int Tc, int PD, int P, int G,
             int q_tokens, int chunk, int splits, float scale,
             cudaStream_t s) {
  if (kv == sg_decode::KV_FP)
    return launch<T, T, false>(q, K, V, KS, VS, lengths, o, ws, N, Hp, Q, Tc,
                               PD, P, G, q_tokens, chunk, splits, scale, s);
  if (kv == sg_decode::KV_INT8)
    return launch<T, int8_t, true>(q, K, V, KS, VS, lengths, o, ws, N, Hp, Q,
                                   Tc, PD, P, G, q_tokens, chunk, splits,
                                   scale, s);
  if (kv == sg_decode::KV_INT4)
    return launch<T, uint8_t, true>(q, K, V, KS, VS, lengths, o, ws, N, Hp,
                                    Q, Tc, PD, P, G, q_tokens, chunk, splits,
                                    scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (N, Hp, Q, PD) and o like it, fp32 or bf16 (`dtype`); K/V (N, Hp, Tc,
// W) of q's type (kv = 0), int8 (kv = 1, W = PD) or packed uint8 (kv = 2,
// W = PD / 2); KS/VS (N, Hp, Tc, P) fp32 for kv 1 and 2, else unused;
// lengths (N,) int32, counted at the last query token; rows (q_tokens, P,
// G); ws fp32, N * Hp * splits * Q * (PD + 2) floats (the partials; no
// need to clear); splits * chunk >= Tc, chunk a multiple of 64. All
// contiguous; Q <= 64 and PD <= 256 (checked by the caller). Launches the
// split kernel, then the merge.
extern "C" int sg_flash_decode(const void* q, const void* K, const void* V,
                               const void* KS, const void* VS,
                               const void* lengths, void* o, void* ws, int N,
                               int Hp, int Q, int Tc, int PD, int P, int G,
                               int q_tokens, int chunk, int splits,
                               float scale, int dtype, int kv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == SG_F32)
    return dispatch<float>(kv, q, K, V, KS, VS, lengths, o, ws, N, Hp, Q, Tc,
                           PD, P, G, q_tokens, chunk, splits, scale, s);
  if (dtype == SG_BF16)
    return dispatch<__nv_bfloat16>(kv, q, K, V, KS, VS, lengths, o, ws, N,
                                   Hp, Q, Tc, PD, P, G, q_tokens, chunk,
                                   splits, scale, s);
  return (int)cudaErrorInvalidValue;
}
