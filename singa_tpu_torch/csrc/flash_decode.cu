// Flash-decode: the dense serving step's attention of head-packed
// block-diagonal queries (N, Hp, Q, PD) against contiguous head-packed
// caches (N, Hp, T, PD), each sequence masked to its own length.
//
// Replaces singa_tpu/ops/attention.py `_flash_decode_kernel` (launched by
// `_flash_decode_pallas`) for fp32/bf16 caches and q_tokens = 1. The TPU
// grid (n, hp, t block) carries the online softmax in VMEM scratch across t
// and elides the DMA of blocks past the length; here one block per (n, hp)
// loops over 64-position tiles up to lengths[n] and never reads past it.
//
// Bound on the H100: bytes. Each live cache row is read once (2 * len * PD
// elements per (n, hp)) for 4 * Q * PD flops per position, far below the
// card's ~295 flops per byte, so the floor is the cache bytes over
// 3.35 TB/s. The simple design leaves on the table: N * Hp blocks only
// (48 at GPT-2-small with 8 slots, for 132 SMs: split-K over T with a
// second merge pass would fill the card), vectorised 16-byte loads or TMA
// into a double-buffered tile ring, and skipping the block-diagonal zeros.
// Int8/int4 caches and the q_tokens > 1 verify ladder are not ported yet:
// the wrapper raises on them.

#include "decode_common.cuh"

namespace {

template <typename T>
struct DenseRows {
  const T* K;  // this (n, hp)'s (T, PD) slab
  const T* V;
  int PD;
  __device__ const T* k(int t) const { return K + (size_t)t * PD; }
  __device__ const T* v(int t) const { return V + (size_t)t * PD; }
};

template <typename T>
__global__ void __launch_bounds__(sg_decode::NT)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ K,
                    const T* __restrict__ V, const int* __restrict__ lengths,
                    T* __restrict__ o, int Hp, int Q, int Tc, int PD,
                    float scale) {
  const int hp = blockIdx.x, n = blockIdx.y;
  const int len = min(max(lengths[n], 1), Tc);
  const size_t bo = (size_t)n * Hp + hp;
  const DenseRows<T> rows{K + bo * Tc * PD, V + bo * Tc * PD, PD};
  sg_decode::attend(q + bo * Q * PD, o + bo * Q * PD, Q, PD, len, scale,
                    rows);
}

template <typename T>
cudaError_t launch(const void* q, const void* K, const void* V,
                   const void* lengths, void* o, int N, int Hp, int Q, int Tc,
                   int PD, float scale, cudaStream_t stream) {
  const size_t smem = sg_decode::smem_bytes(Q, PD);
  auto kern = flash_decode_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Hp, N), sg_decode::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(K),
      static_cast<const T*>(V), static_cast<const int*>(lengths),
      static_cast<T*>(o), Hp, Q, Tc, PD, scale);
  return cudaGetLastError();
}

}  // namespace

// q (N, Hp, Q, PD), K/V (N, Hp, T, PD), lengths (N,) int32, o like q; all
// contiguous. Q <= 16 and PD <= 256 (checked by the caller).
extern "C" int sg_flash_decode(const void* q, const void* K, const void* V,
                               const void* lengths, void* o, int N, int Hp,
                               int Q, int Tc, int PD, float scale, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == SG_F32)
    return launch<float>(q, K, V, lengths, o, N, Hp, Q, Tc, PD, scale, s);
  if (dtype == SG_BF16)
    return launch<__nv_bfloat16>(q, K, V, lengths, o, N, Hp, Q, Tc, PD,
                                 scale, s);
  return (int)cudaErrorInvalidValue;
}
