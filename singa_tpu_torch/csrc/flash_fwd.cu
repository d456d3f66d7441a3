// Flash-attention forward: O = softmax(scale * Q K^T [+ causal mask]) V and
// the per-row logsumexp, over (BH, S, D) rows, fp32 or bf16 in, fp32 math.
//
// Replaces singa_tpu/ops/attention.py `_flash_fwd_kernel` (launched by
// `_flash_fwd_pallas`). The TPU grid (bh, q block, k block) runs in order
// and carries the online-softmax state in VMEM scratch across the k
// dimension; here one block owns one (bh, 64-row q tile) and walks the K/V
// tiles in a loop, with the running max, sum and accumulator in registers.
// Unlike the TPU dispatch, any S runs the kernel: the ragged last q tile and
// k tile are masked here instead of falling back to the O(S^2) reference.
//
// Bound on the H100: at the serving shapes (S <= 1024, D = 64) the work is
// 4*S^2/2*D flops per head against 4*S*D*bytes moved, so short prompts are
// bound by bytes and long ones by operations (989 TFLOP/s in bf16 on the
// tensor cores). This simple design runs the two products on the CUDA cores
// in fp32 from shared memory (K tile padded to D+1 floats a row so the 32
// lanes of a warp read 32 banks), 8 warps each owning 8 rows of the q tile.
// It leaves on the table: wgmma tensor-core products, TMA loads of the tiles
// with a double-buffered pipeline, and bf16 tiles in shared memory.

#include "common.cuh"

namespace {

constexpr int BQ = 64;            // q rows per block
constexpr int BK = 64;            // keys per tile (two per lane)
constexpr int NT = 256;           // threads per block
constexpr int RPW = BQ / (NT / 32);  // q rows per warp

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int causal,
                 float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // BQ x D, pre-scaled
  float* Ks = Qs + BQ * D;           // BK x (D + 1)
  float* Vs = Ks + BK * (D + 1);     // BK x D
  float* Ps = Vs + BK * D;           // BQ x BK probabilities

  constexpr int DL = D / 32;         // output dims per lane
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D;
    Qs[e] = (q0 + r < Sq) ? to_f32(qb[(size_t)(q0 + r) * D + d]) * scale
                          : 0.f;
  }

  float acc[RPW][DL];
  float m[RPW], l[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = SG_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DL; ++j) acc[i][j] = 0.f;
  }

  // causal: keys past this tile's last row are masked for every row
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, d = e % D;
      const bool ok = k0 + r < Sk;
      const size_t g = (size_t)(k0 + r) * D + d;
      Ks[r * (D + 1) + d] = ok ? to_f32(kb[g]) : 0.f;
      Vs[e] = ok ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      const int qi = q0 + r;
      const float* qr = Qs + r * D;
      const float* ka = Ks + lane * (D + 1);
      const float* kc = Ks + (lane + 32) * (D + 1);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float qd = qr[d];
        s0 = fmaf(qd, ka[d], s0);
        s1 = fmaf(qd, kc[d], s1);
      }
      const int c0 = k0 + lane, c1 = k0 + lane + 32;
      if (c0 >= Sk || (causal && c0 > qi)) s0 = SG_NEG_INF;
      if (c1 >= Sk || (causal && c1 > qi)) s1 = SG_NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s0, s1)));
      const float p0 = __expf(s0 - m_new), p1 = __expf(s1 - m_new);
      const float corr = __expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p0 + p1);
      m[i] = m_new;
      Ps[r * BK + lane] = p0;
      Ps[r * BK + lane + 32] = p1;
#pragma unroll
      for (int j = 0; j < DL; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // each warp reads back only its own rows of Ps

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float* pr = Ps + (warp * RPW + i) * BK;
      for (int c = 0; c < BK; ++c) {
        const float p = pr[c];
        const float* vr = Vs + c * D + lane;
#pragma unroll
        for (int j = 0; j < DL; ++j) acc[i][j] = fmaf(p, vr[32 * j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int qi = q0 + warp * RPW + i;
    if (qi >= Sq) continue;
    const float li = fmaxf(l[i], 1e-20f);
    const float inv = 1.f / li;
    T* orow = o + ((size_t)bh * Sq + qi) * D + lane;
#pragma unroll
    for (int j = 0; j < DL; ++j) orow[32 * j] = from_f32<T>(acc[i][j] * inv);
    if (lane == 0) lse[(size_t)bh * Sq + qi] = m[i] + logf(li);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int BH, int Sq, int Sk, int causal,
                   float scale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(BQ * D + BK * (D + 1) + BK * D + BQ * BK) * sizeof(float);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), Sq, Sk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q (BH, Sq, D), k/v (BH, Sk, D) contiguous, dtype SG_F32 or SG_BF16;
// o like q; lse (BH, Sq) fp32. D must be 64 or 128 (checked by the caller).
extern "C" int sg_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int BH, int Sq, int Sk, int D,
                            int causal, float scale, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == SG_F32 && D == 64)
    return launch<float, 64>(q, k, v, o, lse, BH, Sq, Sk, causal, scale, s);
  if (dtype == SG_F32 && D == 128)
    return launch<float, 128>(q, k, v, o, lse, BH, Sq, Sk, causal, scale, s);
  if (dtype == SG_BF16 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, BH, Sq, Sk, causal,
                                     scale, s);
  if (dtype == SG_BF16 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, BH, Sq, Sk, causal,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}
