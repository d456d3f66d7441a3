// Flash-attention backward, split half 1 of 2 (K2b): dQ.
//
// Replaces singa_tpu/ops/attention.py:269 `_flash_bwd_dq_kernel` (the first
// `pl.pallas_call` of `_flash_bwd_pallas` :476, at :502), which the JAX
// dispatch takes when the fused kernel's (Sq, D) fp32 dQ scratch would pass
// its 4 MB cap (S > 8192 at D = 128). The TPU grid (bh, q block, k block)
// carries a dQ accumulator in VMEM scratch across the sequential k
// dimension; here one block owns one (bh, q tile), keeps its q and dO tiles
// in shared memory and dQ in registers, and walks the K/V tiles up to the
// causal diagonal in a loop, recomputing P and dS per tile. It writes
// dQ * scale once, with no atomics, so dQ is bitwise reproducible. dK and
// dV come from flash_bwd_dkv.cu, which recomputes the same P and dS: the
// split pays the two score products twice to avoid the fused kernel's
// order-dependent dQ sums.
//
// Bound on the H100 at the long-context shape (1, 16, 16384, 128) bf16
// causal: 3 of the backward's 5 products (S, dP, dQ), about 1.65 TFLOP
// (1.6677 ms at 989 TFLOP/s) against 0.34 GB moved (0.10 ms at 3.35 TB/s):
// bound by the tensor cores' operations.
//
// bf16: `flash_bwd_dq_tc_kernel`, on the tensor cores (flash_tc.cuh), the
// structure of K1's `flash_fwd_kernel_tc` with two products in front. A
// block owns 128 q rows, two warpgroups of 64 rows, with q and dO resident
// in shared memory in the swizzled layout and each row's lse and delta in
// registers; it walks 64-key tiles of K and V through a four-stage
// cp.async ring filled three tiles ahead (193 KB of shared memory at
// D 128), one barrier a tile:
// - S = Q K^T and dP = dO V^T by wgmma from shared memory (K and V
//   K-major as stored);
// - P = exp2(S log2e - lse log2e) and dS = P (dP - delta) in the
//   accumulator fragment, masked only on diagonal and ragged tiles;
// - dS rounded to bf16 is the register A operand of dQ += dS K, K read
//   MN-major (transpose bit), as K1 reads V for O += P V.
// dQ stays in fp32 registers (64 x D a warpgroup, D / 2 a thread) and the
// epilogue writes dQ * scale in bf16 once. 64-key tiles keep S and dP at 32
// registers a thread each beside dQ's 64; 128 keys would spill. Causal: key
// tiles above the diagonal are skipped (a warpgroup whose 64 rows all lie
// above a tile skips its products), and the longest q tiles launch first.
// It leaves for later: TMA loads from a producer warp with setmaxnreg, two
// warpgroups overlapping one's products with the other's exp, and
// persistent blocks.
//
// fp32: `flash_bwd_dq_kernel`, every product on the CUDA cores in fp32
// from shared memory (flash_bwd.cuh), because wgmma on fp32 inputs runs in
// TF32.

#include "flash_bwd.cuh"
#include "flash_tc.cuh"

namespace {

using namespace fbwd;

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Sq, int Sk, int causal, float scale) {
  extern __shared__ float smem[];
  const Tiles<D> t(smem);
  constexpr int DJ = D / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;

  load_tile<D>(t.q, q + qoff, q0, Sq);
  load_tile<D>(t.dO, dO + qoff, q0, Sq);
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
    load_tile<D>(t.k, k + koff, k0, Sk);
    load_tile<D>(t.v, v + koff, k0, Sk);
    __syncthreads();
    tile_p_ds<D>(t, q0, k0, Sq, Sk, causal);
    __syncthreads();
    acc_dq<D>(t, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    float* dst = dq + qoff + (size_t)row * D + tx;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dst[16 * j] = acc[i][j] * scale;
  }
}

template <int D>
cudaError_t launch_fp(const void* q, const void* k, const void* v,
                      const void* dO, const void* lse, const void* delta,
                      void* dq, int BH, int Sq, int Sk, int causal,
                      float scale, cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<D>::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  kern<<<grid, NT, Smem<D>::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), Sq, Sk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

namespace dq_tc {

using tc::bf16;
constexpr int BQ = 128;  // q rows a block: two warpgroups of 64
constexpr int BK = 64;   // keys a tile
constexpr int NS = 4;    // K/V ring stages (faster than 2 or 3 on the H100)
constexpr int NT = 256;

template <int D>
struct Smem {
  static constexpr uint32_t Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  // Q, dO, then K in NS stages, then V in NS stages; + alignment slack
  static constexpr uint32_t Q = 0, DO = Q_BYTES, K = 2 * Q_BYTES,
                            V = K + NS * KV_BYTES;
  static constexpr size_t bytes = 1024 + 2 * Q_BYTES + 2 * NS * KV_BYTES;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dO,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int Sq, int Sk, int causal, float scale) {
  using S_ = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sb = tc::smem_u32(tc::align_1k(smem_raw));
  const uint32_t sQ = sb + S_::Q, sO = sb + S_::DO, sK = sb + S_::K,
                 sV = sb + S_::V;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int n_qt = (Sq + BQ - 1) / BQ;
  // causal: the longest q tiles (most key tiles) first
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x)
                 * BQ;
  const int bh = blockIdx.y;
  const size_t qoff = (size_t)bh * Sq * D;
  const bf16* kb = k + (size_t)bh * Sk * D;
  const bf16* vb = v + (size_t)bh * Sk * D;
  // causal: keys past this tile's last row are masked for every row
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_kt = (k_end + BK - 1) / BK;

  auto load_kv = [&](int it) {
    const uint32_t st = (it % NS) * S_::KV_BYTES;
    tc::load_tile<BK, D, NT>(sK + st, kb, it * BK, Sk, tid);
    tc::load_tile<BK, D, NT>(sV + st, vb, it * BK, Sk, tid);
  };
  // Q, dO and key tiles 0 .. NS - 2, one commit group a tile (Q and dO
  // ride with the first), so that iteration it waits for all but the
  // NS - 2 newest
  tc::load_tile<BQ, D, NT>(sQ, q + qoff, q0, Sq, tid);
  tc::load_tile<BQ, D, NT>(sO, dO + qoff, q0, Sq, tid);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_kt) load_kv(s);
    tc::cp_commit();
  }

  // this thread's rows row0 and row0 + 8, columns 8 j + col0 + {0, 1}
  const int wrow = q0 + wg * 64;
  const int row0 = wrow + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  // lse in log2 units and delta of those rows (0 past Sq: those rows'
  // q and dO are zero, so their dS is 0 and they are not written)
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    const bool ok = r < Sq;
    l2[i] = ok ? lse[(size_t)bh * Sq + r] * tc::LOG2E : 0.f;
    dl[i] = ok ? delta[(size_t)bh * Sq + r] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t qa = sQ + wg * 64 * 128;  // this warpgroup's Q rows
  const uint32_t oa = sO + wg * 64 * 128;  // and dO rows

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * BK;
    const uint32_t stage = (it % NS) * S_::KV_BYTES;
    tc::cp_wait<NS - 2>();
    tc::fence_async_smem();
    __syncthreads();
    // stage (it - 1) % NS was last read in iteration it - 1, which every
    // thread has left (the barrier above)
    if (it + NS - 1 < n_kt) load_kv(it + NS - 1);
    tc::cp_commit();
    // causal: a tile wholly above this warpgroup's rows adds nothing
    if (causal && k0 > wrow + 63) continue;

    // S = Q K^T, dP = dO V^T (64 q rows x 64 keys each), fp32
    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
    tc::reg_fence(s);
    tc::reg_fence(dp);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t ra = (kk >> 2) * (BQ * 128) + (kk & 3) * 32;
      const uint32_t ka = stage + (kk >> 2) * (BK * 128) + (kk & 3) * 32;
      tc::wgmma_ss<0, 0>(s, tc::desc(qa + ra, 16, 1024),
                         tc::desc(sK + ka, 16, 1024), 1);
      tc::wgmma_ss<0, 0>(dp, tc::desc(oa + ra, 16, 1024),
                         tc::desc(sV + ka, 16, 1024), 1);
    }
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::reg_fence(s);
    tc::reg_fence(dp);

    // P and dS in place; masked on the diagonal and ragged tiles: keys
    // past Sk, or past the row
    const bool need_mask = k0 + BK > Sk || (causal && k0 + BK - 1 > wrow);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          float p = tc::fast_exp2(fmaf(s[e], tc::LOG2E, -l2[i]));
          if (need_mask) {
            const int col = k0 + 8 * j + col0 + c;
            if (col >= Sk || (causal && col > row0 + 8 * i)) p = 0.f;
          }
          dp[e] = p * (dp[e] - dl[i]);
        }

    // dQ += dS K, dS rounded to bf16 in registers, K read MN-major
    uint32_t dsa[BK / 16][4];
    tc::acc_to_a(dp, dsa);
    tc::reg_fence(acc);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      tc::wgmma_rs<1>(acc, dsa[kk],
                      tc::desc(sK + stage + kk * 2048, BK * 128, 1024), 1);
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::reg_fence(acc);
  }
  tc::cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= Sq) continue;
    bf16* drow = dq + qoff + (size_t)r * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(drow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * scale,
                                acc[4 * j + 2 * i + 1] * scale);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dO, const void* lse, const void* delta,
                   void* dq, int BH, int Sq, int Sk, int causal, float scale,
                   cudaStream_t stream) {
  auto kern = flash_bwd_dq_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<D>::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  kern<<<grid, NT, Smem<D>::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), Sq, Sk, causal, scale);
  return cudaGetLastError();
}

}  // namespace dq_tc

// q (pre-scaled), dO (BH, Sq, D); k, v (BH, Sk, D); contiguous, dtype SG_F32
// or SG_BF16; lse, delta (BH, Sq) fp32; dq like q. D must be 64 or 128
// (checked by the caller). bf16 runs the tensor-core kernel, fp32 the
// CUDA-core one.
extern "C" int sg_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dO, const void* lse,
                               const void* delta, void* dq, int BH, int Sq,
                               int Sk, int D, int causal, float scale,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SG_ARGS q, k, v, dO, lse, delta, dq, BH, Sq, Sk, causal, scale, s
  if (dtype == SG_F32 && D == 64) return launch_fp<64>(SG_ARGS);
  if (dtype == SG_F32 && D == 128) return launch_fp<128>(SG_ARGS);
  if (dtype == SG_BF16 && D == 64) return dq_tc::launch<64>(SG_ARGS);
  if (dtype == SG_BF16 && D == 128) return dq_tc::launch<128>(SG_ARGS);
#undef SG_ARGS
  return (int)cudaErrorInvalidValue;
}
