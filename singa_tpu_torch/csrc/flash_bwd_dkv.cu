// Flash-attention backward, split half 2 of 2: dK and dV.
//
// Replaces singa_tpu/ops/attention.py `_flash_bwd_dkv_kernel` (the second
// `pl.pallas_call` of `_flash_bwd_pallas`), which the JAX dispatch takes
// when the fused kernel's (Sq, D) fp32 dQ scratch would pass its 4 MB cap
// (S > 8192 at D = 128). The TPU grid (bh, k block, q block) carries dK/dV
// accumulators in VMEM scratch across the sequential q dimension; here one
// block owns one (bh, 64-key tile) and walks the q tiles from the causal
// diagonal on in a loop, with dK and dV in registers (flash_bwd.cuh). Each
// row of dK/dV is written by one block, with no atomics, so the result is
// deterministic. dQ comes from flash_bwd_dq.cu.
//
// Bound on the H100 at the long-context shape (1, 16, 16384, 128) bf16
// causal: 4 of the backward's 5 products (S, dP, dV, dK), about 2.2 TFLOP
// (2.2 ms at 989 TFLOP/s) against 0.40 GB moved (0.12 ms at 3.35 TB/s):
// bound by operations. This simple design runs them on the CUDA cores in
// fp32 from shared memory; wgmma tensor-core tiles, TMA loads and a
// pipelined ring of q/dO tiles are left for later work.

#include "flash_bwd.cuh"

// q (pre-scaled), dO (BH, Sq, D); k, v (BH, Sk, D); contiguous, dtype SG_F32
// or SG_BF16; lse, delta (BH, Sq) fp32; dk/dv like k. D must be 64 or 128
// (checked by the caller).
extern "C" int sg_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dO, const void* lse,
                                const void* delta, void* dk, void* dv,
                                int BH, int Sq, int Sk, int D, int causal,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SG_ARGS q, k, v, dO, lse, delta, dk, dv, nullptr, BH, Sq, Sk, causal, s
  if (dtype == SG_F32 && D == 64)
    return fbwd::launch_kv<float, 64, false>(SG_ARGS);
  if (dtype == SG_F32 && D == 128)
    return fbwd::launch_kv<float, 128, false>(SG_ARGS);
  if (dtype == SG_BF16 && D == 64)
    return fbwd::launch_kv<__nv_bfloat16, 64, false>(SG_ARGS);
  if (dtype == SG_BF16 && D == 128)
    return fbwd::launch_kv<__nv_bfloat16, 128, false>(SG_ARGS);
#undef SG_ARGS
  return (int)cudaErrorInvalidValue;
}
