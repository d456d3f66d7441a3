// Flash-attention backward, split half 1 of 2: dQ.
//
// Replaces singa_tpu/ops/attention.py `_flash_bwd_dq_kernel` (the first
// `pl.pallas_call` of `_flash_bwd_pallas`), which the JAX dispatch takes
// when the fused kernel's (Sq, D) fp32 dQ scratch would pass its 4 MB cap
// (S > 8192 at D = 128). The TPU grid (bh, q block, k block) carries a dQ
// accumulator in VMEM scratch across the sequential k dimension; here one
// block owns one (bh, 64-row q tile), keeps its q and dO tiles in shared
// memory and dQ in registers, and walks the K/V tiles up to the causal
// diagonal in a loop, recomputing P and dS per tile (flash_bwd.cuh). It
// writes dQ * scale once, with no atomics. dK and dV come from
// flash_bwd_dkv.cu, which recomputes the same P and dS: the split pays the
// two score products twice to avoid the fused kernel's atomics.
//
// Bound on the H100 at the long-context shape (1, 16, 16384, 128) bf16
// causal: 3 of the backward's 5 products (S, dP, dQ), about 1.65 TFLOP
// (1.67 ms at 989 TFLOP/s) against 0.34 GB moved (0.10 ms at 3.35 TB/s):
// bound by operations. This simple design runs them on the CUDA cores in
// fp32 from shared memory; wgmma tensor-core tiles, TMA loads and a
// pipelined ring of K/V tiles are left for later work.

#include "flash_bwd.cuh"

namespace {

using namespace fbwd;

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int causal, float scale) {
  extern __shared__ float smem[];
  const Tiles<D> t(smem);
  constexpr int DJ = D / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;

  load_tile<T, D>(t.q, q + qoff, q0, Sq);
  load_tile<T, D>(t.dO, dO + qoff, q0, Sq);
  load_stats(t.lse, t.delta, lse + (size_t)bh * Sq, delta + (size_t)bh * Sq,
             q0, Sq);

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // causal: keys past this tile's last row are masked for every row
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(t.k, k + koff, k0, Sk);
    load_tile<T, D>(t.v, v + koff, k0, Sk);
    __syncthreads();
    tile_p_ds<D>(t, q0, k0, Sq, Sk, causal);
    __syncthreads();
    acc_dq<D>(t, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    T* dst = dq + qoff + (size_t)row * D + tx;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dst[16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dO, const void* lse, const void* delta,
                   void* dq, int BH, int Sq, int Sk, int causal, float scale,
                   cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<D>::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  kern<<<grid, NT, Smem<D>::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), Sq, Sk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q (pre-scaled), dO (BH, Sq, D); k, v (BH, Sk, D); contiguous, dtype SG_F32
// or SG_BF16; lse, delta (BH, Sq) fp32; dq like q. D must be 64 or 128
// (checked by the caller).
extern "C" int sg_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dO, const void* lse,
                               const void* delta, void* dq, int BH, int Sq,
                               int Sk, int D, int causal, float scale,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SG_ARGS q, k, v, dO, lse, delta, dq, BH, Sq, Sk, causal, scale, s
  if (dtype == SG_F32 && D == 64) return launch<float, 64>(SG_ARGS);
  if (dtype == SG_F32 && D == 128) return launch<float, 128>(SG_ARGS);
  if (dtype == SG_BF16 && D == 64) return launch<__nv_bfloat16, 64>(SG_ARGS);
  if (dtype == SG_BF16 && D == 128)
    return launch<__nv_bfloat16, 128>(SG_ARGS);
#undef SG_ARGS
  return (int)cudaErrorInvalidValue;
}
