// Flash-attention backward, fused (K2a): dQ, dK and dV in one pass over the
// tiles, from q PRE-SCALED by the softmax scale, k, v, dO and the forward's
// lse and delta = rowsum(dO * O).
//
// Replaces singa_tpu/ops/attention.py:351 `_flash_bwd_fused_kernel`
// (launched by `_flash_bwd_fused` :423). The TPU grid (bh, k block, q
// block) runs in order and keeps dQ for a whole (Sq, D) row of heads in a
// persistent VMEM scratch. Here blocks run in parallel and in no order, and
// a 1024 x 128 fp32 dQ (512 KB) does not fit one block's 227 KB of shared
// memory, so dQ goes the FlashAttention-2 way: each block owns one (bh, key
// tile), walks the q tiles that see it with dK and dV in registers, and
// adds each tile's dS k partial into a zeroed fp32 (BH, Sq, D) workspace; a
// second kernel writes dQ = workspace * scale in q's dtype. The order of
// those additions changes from run to run, so dQ is not bitwise
// reproducible (dK and dV are); its tolerance says so.
//
// Bound on the H100 at the training shape (8, 16, 1024, 128) bf16 causal:
// five score-sized products, about 86 GFLOP, 0.087 ms at 989 TFLOP/s; about
// 268 MB moved (q, k, v, dO read; dq, dk, dv written), 0.080 ms at 3.35
// TB/s: near the ridge.
//
// bf16: `flash_bwd_fused_tc_kernel`, on the tensor cores: the key-block
// walk of flash_bwd_tc.cuh with its dQ branch (the same body, without dQ,
// is K2c's bf16 kernel). A block owns 128 keys, two warpgroups of 64 with
// dK and dV in registers, and streams 64-row q tiles through a two-stage
// cp.async ring; S^T, dP^T by wgmma from shared memory, P^T and dS^T as
// register A operands of dV and dK, dS^T through shared memory for
// dQ = dS K, whose 64 x D fp32 partial is staged and added into the
// workspace by bulk asynchronous reductions, one row each. 179 KB of shared
// memory at D 128, one block an SM.
// It leaves for later: TMA loads from a producer warp with setmaxnreg,
// overlapping one warpgroup's elementwise work with the other's products,
// keeping dQ partials of neighbouring key tiles together, folding the
// scale-and-cast pass into a last-block epilogue, and an FP8 path.
//
// fp32: `flash_bwd_kv_kernel` (flash_bwd.cuh, shared with K2c's fp32
// path), kept as it was, because wgmma on fp32 inputs runs in TF32: every
// product on the CUDA cores in fp32 from shared memory, 64-key blocks, dQ
// by a 4-byte atomicAdd an element a tile.

#include "flash_bwd.cuh"
#include "flash_bwd_tc.cuh"

namespace {

template <typename T>
__global__ void scale_cast_kernel(const float* __restrict__ src,
                                  T* __restrict__ dst, size_t n,
                                  float scale) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = from_f32<T>(src[i] * scale);
}

template <typename T>
cudaError_t scale_cast(const void* dq_acc, void* dq, size_t n, float scale,
                       cudaStream_t stream) {
  const int blocks = (int)((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
  scale_cast_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(dq_acc), static_cast<T*>(dq), n, scale);
  return cudaGetLastError();
}

using bwd_tc::bf16;

template <int D>
__global__ void __launch_bounds__(bwd_tc::NT, 1)
flash_bwd_fused_tc_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dO,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          float* __restrict__ dq_acc, int Sq, int Sk,
                          int causal) {
  bwd_tc::key_block<D, true>(q, k, v, dO, lse, delta, dk, dv, dq_acc, Sq,
                             Sk, causal);
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* dO, const void* lse, const void* delta,
                      void* dq, void* dk, void* dv, void* dq_acc, int BH,
                      int Sq, int Sk, int causal, float scale,
                      cudaStream_t stream) {
  cudaError_t err = bwd_tc::launch<D, true>(
      flash_bwd_fused_tc_kernel<D>, q, k, v, dO, lse, delta, dk, dv, dq_acc,
      BH, Sq, Sk, causal, stream);
  if (err != cudaSuccess) return err;
  return scale_cast<bf16>(dq_acc, dq, (size_t)BH * Sq * D, scale, stream);
}

template <int D>
cudaError_t launch_fp(const void* q, const void* k, const void* v,
                      const void* dO, const void* lse, const void* delta,
                      void* dq, void* dk, void* dv, void* dq_acc, int BH,
                      int Sq, int Sk, int causal, float scale,
                      cudaStream_t stream) {
  cudaError_t err = fbwd::launch_kv<D, true>(
      q, k, v, dO, lse, delta, dk, dv, dq_acc, BH, Sq, Sk, causal, stream);
  if (err != cudaSuccess) return err;
  return scale_cast<float>(dq_acc, dq, (size_t)BH * Sq * D, scale, stream);
}

}  // namespace

// q (pre-scaled), dO (BH, Sq, D); k, v (BH, Sk, D); contiguous, dtype SG_F32
// or SG_BF16; lse, delta (BH, Sq) fp32; dq like q, dk/dv like k; dq_acc a
// ZEROED fp32 (BH, Sq, D) workspace. D must be 64 or 128 (checked by the
// caller). bf16 runs the tensor-core kernel, fp32 the CUDA-core one.
extern "C" int sg_flash_bwd_fused(const void* q, const void* k,
                                  const void* v, const void* dO,
                                  const void* lse, const void* delta,
                                  void* dq, void* dk, void* dv, void* dq_acc,
                                  int BH, int Sq, int Sk, int D, int causal,
                                  float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SG_ARGS q, k, v, dO, lse, delta, dq, dk, dv, dq_acc, BH, Sq, Sk, \
                causal, scale, s
  if (dtype == SG_F32 && D == 64) return launch_fp<64>(SG_ARGS);
  if (dtype == SG_F32 && D == 128) return launch_fp<128>(SG_ARGS);
  if (dtype == SG_BF16 && D == 64) return launch_tc<64>(SG_ARGS);
  if (dtype == SG_BF16 && D == 128) return launch_tc<128>(SG_ARGS);
#undef SG_ARGS
  return (int)cudaErrorInvalidValue;
}
