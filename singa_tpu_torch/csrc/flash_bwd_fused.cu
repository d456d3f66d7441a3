// Flash-attention backward, fused: dQ, dK and dV in one pass over the tiles.
//
// Replaces singa_tpu/ops/attention.py `_flash_bwd_fused_kernel` (launched by
// `_flash_bwd_fused`). The TPU grid (bh, k block, q block) runs in order and
// keeps dQ for a whole (Sq, D) row of heads in a persistent VMEM scratch,
// flushed at each q block's diagonal step. Here blocks run in parallel and
// in no order, and a 1024 x 128 fp32 dQ (512 KB) does not fit one block's
// 227 KB of shared memory, so dQ goes the FlashAttention-2 way: each block
// owns one (bh, 64-key tile), walks the q tiles from the diagonal on with
// dK and dV in registers (flash_bwd.cuh), and adds its dS k partials into a
// zeroed fp32 (BH, Sq, D) workspace with atomicAdd; a second kernel writes
// dQ = workspace * scale in q's dtype. The order of those atomic additions
// changes from run to run, so dQ is not bitwise reproducible (dK and dV
// are): its tolerance against the plain version is stated for that reason.
//
// Bound on the H100 at the training shape (8, 16, 1024, 128) bf16 causal:
// about 86 GFLOP (2.5x the forward's 34), 0.087 ms at 989 TFLOP/s, and
// about 268 MB moved (q, k, v, O, dO read; dq, dk, dv written), 0.080 ms at
// 3.35 TB/s: near the ridge. This simple design runs every product on the
// CUDA cores in fp32 from shared memory, one block per key tile (1 block an
// SM at D = 128 for its 162 KB of shared memory), and spends a 4 B atomic
// per dQ element per tile. It leaves on the table: wgmma tensor-core
// products on bf16 tiles, TMA loads with a pipelined ring of q/dO tiles,
// keeping dQ partials in shared memory across neighbouring key tiles, and
// the second pass (the workspace cast) folded into a last-block epilogue.

#include "flash_bwd.cuh"

namespace {

template <typename T>
__global__ void scale_cast_kernel(const float* __restrict__ src,
                                  T* __restrict__ dst, size_t n,
                                  float scale) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = from_f32<T>(src[i] * scale);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dO, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, void* dq_acc, int BH,
                   int Sq, int Sk, int causal, float scale,
                   cudaStream_t stream) {
  cudaError_t err = fbwd::launch_kv<T, D, true>(
      q, k, v, dO, lse, delta, dk, dv, dq_acc, BH, Sq, Sk, causal, stream);
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)BH * Sq * D;
  const int blocks = (int)((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
  scale_cast_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(dq_acc), static_cast<T*>(dq), n, scale);
  return cudaGetLastError();
}

}  // namespace

// q (pre-scaled), dO (BH, Sq, D); k, v (BH, Sk, D); contiguous, dtype SG_F32
// or SG_BF16; lse, delta (BH, Sq) fp32; dq like q, dk/dv like k; dq_acc a
// ZEROED fp32 (BH, Sq, D) workspace. D must be 64 or 128 (checked by the
// caller).
extern "C" int sg_flash_bwd_fused(const void* q, const void* k,
                                  const void* v, const void* dO,
                                  const void* lse, const void* delta,
                                  void* dq, void* dk, void* dv, void* dq_acc,
                                  int BH, int Sq, int Sk, int D, int causal,
                                  float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SG_ARGS q, k, v, dO, lse, delta, dq, dk, dv, dq_acc, BH, Sq, Sk, \
                causal, scale, s
  if (dtype == SG_F32 && D == 64) return launch<float, 64>(SG_ARGS);
  if (dtype == SG_F32 && D == 128) return launch<float, 128>(SG_ARGS);
  if (dtype == SG_BF16 && D == 64) return launch<__nv_bfloat16, 64>(SG_ARGS);
  if (dtype == SG_BF16 && D == 128)
    return launch<__nv_bfloat16, 128>(SG_ARGS);
#undef SG_ARGS
  return (int)cudaErrorInvalidValue;
}
