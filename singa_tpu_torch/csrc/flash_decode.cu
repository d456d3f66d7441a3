// Flash-decode: the dense serving step's attention of head-packed
// block-diagonal queries (N, Hp, Q, PD) against contiguous head-packed
// caches (N, Hp, T, W), each sequence masked to its own length: plain
// decode (q_tokens = 1) and the speculative verify step's causal ladder
// (q_tokens > 1), over fp32/bf16 caches (W = PD), int8 caches (W = PD) or
// packed-nibble int4 caches (W = PD / 2) with fp32 scale planes
// (N, Hp, T, P). See decode_common.cuh for the math.
//
// Replaces singa_tpu/ops/attention.py `_flash_decode_kernel` (launched by
// `_flash_decode_pallas`), every branch of it. The TPU grid (n, hp, t
// block) carries the online softmax in VMEM scratch across t and elides
// the DMA of blocks past the length; here one block per (n, hp, 16-row
// tile) loops over 64-position tiles up to the length and never reads past
// it. Rows beyond 16 (the ladder at q_tokens * P * G > 16, up to 64) take
// further blocks on the grid's z dimension, each reading the same cache
// rows (from L2 after the first).
//
// Bound on the H100: bytes. Each live cache row and its scales are read
// once (2 * len * (W * sizeof(element) + 4 P) bytes per (n, hp)) for
// 4 * Q * PD flops per position, far below the card's ~295 flops per byte,
// so the floor is those bytes over 3.35 TB/s. The simple design leaves on
// the table: N * Hp blocks only (48 at GPT-2-small with 8 slots, for 132
// SMs: split-K over T with a second merge pass would fill the card),
// vectorised 16-byte loads or TMA into a double-buffered tile ring, and
// skipping the block-diagonal zeros.

#include "decode_common.cuh"

namespace {

template <typename KV, bool SCALED>
struct DenseRows {
  static constexpr bool kScaled = SCALED;
  const KV* K;        // this (n, hp)'s (T, W) slabs
  const KV* V;
  const float* KS;    // this (n, hp)'s (T, P) scale slabs (quantized)
  const float* VS;
  int W, P;
  __device__ const KV* k(int t) const { return K + (size_t)t * W; }
  __device__ const KV* v(int t) const { return V + (size_t)t * W; }
  __device__ const float* ks(int t) const { return KS + (size_t)t * P; }
  __device__ const float* vs(int t) const { return VS + (size_t)t * P; }
};

template <typename T, typename KV, bool SCALED>
__global__ void __launch_bounds__(sg_decode::NT, 1)
flash_decode_kernel(const T* __restrict__ q, const KV* __restrict__ K,
                    const KV* __restrict__ V, const float* __restrict__ KS,
                    const float* __restrict__ VS,
                    const int* __restrict__ lengths, T* __restrict__ o,
                    int Hp, int Q, int Tc, int PD, int P, int G,
                    int q_tokens, float scale) {
  const int hp = blockIdx.x, n = blockIdx.y;
  const int len = max(lengths[n], 1);
  const size_t bo = (size_t)n * Hp + hp;
  const int W = sg_decode::row_width<KV>(PD);
  const DenseRows<KV, SCALED> rows{
      K + bo * Tc * W, V + bo * Tc * W,
      SCALED ? KS + bo * Tc * P : nullptr,
      SCALED ? VS + bo * Tc * P : nullptr, W, P};
  sg_decode::attend(q + bo * Q * PD, o + bo * Q * PD, Q, PD, len, Tc, scale,
                    q_tokens, P, G, rows);
}

template <typename T, typename KV, bool SCALED>
cudaError_t launch(const void* q, const void* K, const void* V,
                   const void* KS, const void* VS, const void* lengths,
                   void* o, int N, int Hp, int Q, int Tc, int PD, int P,
                   int G, int q_tokens, float scale, cudaStream_t stream) {
  const size_t smem = sg_decode::smem_bytes(PD, SCALED ? P : 0);
  auto kern = flash_decode_kernel<T, KV, SCALED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hp, N, (Q + sg_decode::QT - 1) / sg_decode::QT);
  kern<<<grid, sg_decode::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(K),
      static_cast<const KV*>(V), static_cast<const float*>(KS),
      static_cast<const float*>(VS), static_cast<const int*>(lengths),
      static_cast<T*>(o), Hp, Q, Tc, PD, P, G, q_tokens, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int kv, const void* q, const void* K, const void* V,
             const void* KS, const void* VS, const void* lengths, void* o,
             int N, int Hp, int Q, int Tc, int PD, int P, int G,
             int q_tokens, float scale, cudaStream_t s) {
  if (kv == sg_decode::KV_FP)
    return launch<T, T, false>(q, K, V, KS, VS, lengths, o, N, Hp, Q, Tc,
                               PD, P, G, q_tokens, scale, s);
  if (kv == sg_decode::KV_INT8)
    return launch<T, int8_t, true>(q, K, V, KS, VS, lengths, o, N, Hp, Q,
                                   Tc, PD, P, G, q_tokens, scale, s);
  if (kv == sg_decode::KV_INT4)
    return launch<T, uint8_t, true>(q, K, V, KS, VS, lengths, o, N, Hp, Q,
                                    Tc, PD, P, G, q_tokens, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (N, Hp, Q, PD) and o like it, fp32 or bf16 (`dtype`); K/V (N, Hp, Tc,
// W) of q's type (kv = 0), int8 (kv = 1, W = PD) or packed uint8 (kv = 2,
// W = PD / 2); KS/VS (N, Hp, Tc, P) fp32 for kv 1 and 2, else unused;
// lengths (N,) int32, counted at the last query token; rows (q_tokens, P,
// G). All contiguous; Q <= 64 and PD <= 256 (checked by the caller).
extern "C" int sg_flash_decode(const void* q, const void* K, const void* V,
                               const void* KS, const void* VS,
                               const void* lengths, void* o, int N, int Hp,
                               int Q, int Tc, int PD, int P, int G,
                               int q_tokens, float scale, int dtype, int kv,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == SG_F32)
    return dispatch<float>(kv, q, K, V, KS, VS, lengths, o, N, Hp, Q, Tc,
                           PD, P, G, q_tokens, scale, s);
  if (dtype == SG_BF16)
    return dispatch<__nv_bfloat16>(kv, q, K, V, KS, VS, lengths, o, N, Hp,
                                   Q, Tc, PD, P, G, q_tokens, scale, s);
  return (int)cudaErrorInvalidValue;
}
