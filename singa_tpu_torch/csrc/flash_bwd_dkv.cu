// Flash-attention backward, split half 2 of 2 (K2c): dK and dV.
//
// Replaces singa_tpu/ops/attention.py:308 `_flash_bwd_dkv_kernel` (the
// second `pl.pallas_call` of `_flash_bwd_pallas` :476, at :520), which the
// JAX dispatch takes when the fused kernel's (Sq, D) fp32 dQ scratch would
// pass its 4 MB cap (S > 8192 at D = 128). The TPU grid (bh, k block, q
// block) carries dK/dV accumulators in VMEM scratch across the sequential q
// dimension; here one block owns one (bh, key tile) and walks the q tiles
// from the causal diagonal on in a loop, with dK and dV in registers. Each
// row of dK/dV is written once by one block, with no atomics, so the result
// is bitwise reproducible. dQ comes from flash_bwd_dq.cu.
//
// Bound on the H100 at the long-context shape (1, 16, 16384, 128) bf16
// causal: 4 of the backward's 5 products (S, dP, dV, dK), about 2.2 TFLOP
// (2.2236 ms at 989 TFLOP/s) against 0.40 GB moved (0.12 ms at 3.35 TB/s):
// bound by the tensor cores' operations.
//
// bf16: `flash_bwd_dkv_tc_kernel`, the key-block walk of flash_bwd_tc.cuh
// without its dQ branch: the body of K2a's bf16 kernel, so dK and dV equal
// K2a's bit for bit on the same inputs. 128 keys a block (two warpgroups of
// 64, dK and dV in fp32 registers), 64-row q tiles (q, dO, lse, delta) in a
// two-stage cp.async ring filled one tile ahead, one barrier a tile.
// S^T = K Q^T and dP^T = V dO^T by wgmma from shared memory (keys as M);
// P^T and dS^T computed in the accumulator fragment, rounded to bf16 and
// used as the register A operand of dV += P^T dO and dK += dS^T q (dO and
// q read MN-major). Without the dS^T and dQ staging tiles it needs 129 KB
// of shared memory at D 128 (K2a: 179 KB); a third ring stage (162 KB) ran
// no faster at the long-context shape on the H100.
// It leaves for later: TMA loads from a producer warp with setmaxnreg (the
// copies now take the computing threads' instruction slots), two warpgroups
// overlapping one's products with the other's exp, and persistent blocks
// that balance the causal walk's uneven lengths.
//
// fp32: `flash_bwd_kv_kernel` (flash_bwd.cuh, shared with K2a's fp32 path),
// every product on the CUDA cores in fp32, because wgmma on fp32 inputs runs
// in TF32.

#include "flash_bwd.cuh"
#include "flash_bwd_tc.cuh"

namespace {

using bwd_tc::bf16;

template <int D>
__global__ void __launch_bounds__(bwd_tc::NT, 1)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        float* __restrict__ dq_acc, int Sq, int Sk,
                        int causal) {
  bwd_tc::key_block<D, false>(q, k, v, dO, lse, delta, dk, dv, dq_acc, Sq,
                              Sk, causal);
}

}  // namespace

// q (pre-scaled), dO (BH, Sq, D); k, v (BH, Sk, D); contiguous, dtype SG_F32
// or SG_BF16; lse, delta (BH, Sq) fp32; dk/dv like k. D must be 64 or 128
// (checked by the caller). bf16 runs the tensor-core kernel, fp32 the
// CUDA-core one.
extern "C" int sg_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dO, const void* lse,
                                const void* delta, void* dk, void* dv,
                                int BH, int Sq, int Sk, int D, int causal,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SG_ARGS q, k, v, dO, lse, delta, dk, dv, nullptr, BH, Sq, Sk, causal, s
  if (dtype == SG_F32 && D == 64) return fbwd::launch_kv<64, false>(SG_ARGS);
  if (dtype == SG_F32 && D == 128)
    return fbwd::launch_kv<128, false>(SG_ARGS);
  if (dtype == SG_BF16 && D == 64)
    return bwd_tc::launch<64, false>(flash_bwd_dkv_tc_kernel<64>, SG_ARGS);
  if (dtype == SG_BF16 && D == 128)
    return bwd_tc::launch<128, false>(flash_bwd_dkv_tc_kernel<128>, SG_ARGS);
#undef SG_ARGS
  return (int)cudaErrorInvalidValue;
}
