// Flash-attention forward (K1): O = softmax(scale * Q K^T [+ causal mask]) V
// and the per-row logsumexp of the scaled scores (natural log), over
// (BH, S, D) rows, D 64 or 128, any S.
//
// Replaces singa_tpu/ops/attention.py:112 `_flash_fwd_kernel` (launched by
// `_flash_fwd_pallas` :220). The TPU grid (bh, q block, k block) runs in
// order and carries the online-softmax state in VMEM scratch across the k
// dimension; here one block owns one (bh, q tile) and walks the K/V tiles
// in a loop with that state in registers. Unlike the TPU dispatch, any S
// runs the kernel: ragged q and k tiles are masked, never sent to the
// O(S^2) reference.
//
// Bound on the H100: 4 S^2 D / 2 flops a head (causal) against 4 S D
// elements moved. bf16 at the training shape (8, 16, 1024, 128): 34 GFLOP,
// 0.035 ms at 989 TFLOP/s on the tensor cores, against 134 MB, 0.040 ms at
// 3.35 TB/s, so near the ridge; the prefill shape (8, 12, 128, 64) is bound
// by bytes (0.0019 ms).
//
// bf16: `flash_fwd_kernel_tc`, on the tensor cores. A block has two
// warpgroups of 64 q rows each (a 128-row q tile) and walks 128-key tiles:
// - Q, K and V sit in shared memory as bf16 in the 128-byte-swizzled layout
//   (flash_tc.cuh); K and V in a two-stage ring that cp.async fills with
//   the next tile while the current one is computed (160 KB at D 128).
// - S = Q K^T by wgmma from shared memory into fp32 registers (K as stored
//   is K-major for the B operand).
// - The online softmax runs on the accumulator fragment: a row lives in
//   the 4 lanes of a quad, so its max and sum take two shuffles. exp2 with
//   log2(e) folded into the scale; lse is converted back to natural log.
// - P is rounded to bf16 in registers (as the plain version rounds it
//   before P V) and fed as the register A operand of O += P V, with V read
//   MN-major (transpose bit set).
// - Causal: key tiles above the diagonal are skipped, the longest q tiles
//   are launched first, and only the diagonal and ragged tiles are masked.
// It leaves for later: TMA loads from a producer warp with setmaxnreg,
// overlapping one warpgroup's softmax with the other's products (pingpong),
// persistent blocks, and an FP8 path.
//
// fp32: `flash_fwd_kernel`, the first design kept as it was, because wgmma
// on fp32 inputs runs in TF32 and would break the fp32 checks: both
// products on the CUDA cores in fp32 from shared memory (the K tile padded
// to D + 1 floats a row), 8 warps each owning 8 rows of a 64-row q tile.

#include "flash_tc.cuh"

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
cudaError_t launch_fp(const void* q, const void* k, const void* v, void* o,
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

namespace fwd_tc {

using tc::bf16;
constexpr int BQ = 128;  // q rows a block: two warpgroups of 64
constexpr int BK = 128;  // keys a tile
constexpr int NT = 256;

template <int D>
struct Smem {
  static constexpr uint32_t Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  // Q, then K in two stages, then V in two stages; + alignment slack
  static constexpr size_t bytes = 1024 + Q_BYTES + 4 * KV_BYTES;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int Sq, int Sk, int causal,
                    float scale) {
  using S_ = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = tc::smem_u32(tc::align_1k(smem_raw));
  const uint32_t sK = sQ + S_::Q_BYTES;
  const uint32_t sV = sK + 2 * S_::KV_BYTES;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int n_qt = (Sq + BQ - 1) / BQ;
  // causal: the longest q tiles (most key tiles) first
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x)
                 * BQ;
  const int bh = blockIdx.y;
  const bf16* qb = q + (size_t)bh * Sq * D;
  const bf16* kb = k + (size_t)bh * Sk * D;
  const bf16* vb = v + (size_t)bh * Sk * D;
  // causal: keys past this tile's last row are masked for every row
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_kt = (k_end + BK - 1) / BK;

  tc::load_tile<BQ, D, NT>(sQ, qb, q0, Sq, tid);
  tc::load_tile<BK, D, NT>(sK, kb, 0, Sk, tid);
  tc::load_tile<BK, D, NT>(sV, vb, 0, Sk, tid);
  tc::cp_commit();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {SG_NEG_INF, SG_NEG_INF}, l[2] = {0.f, 0.f};
  const float sl2 = scale * tc::LOG2E;
  // this thread's rows row0 and row0 + 8, columns 8 j + col0 + {0, 1}
  const int wrow = q0 + wg * 64;
  const int row0 = wrow + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const uint32_t qa = sQ + wg * 64 * 128;  // this warpgroup's Q rows

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * BK;
    const uint32_t stage = (it & 1) * S_::KV_BYTES;
    if (it + 1 < n_kt) {
      // the other stage was last read in iteration it - 1, which every
      // thread has left (the barrier that ends it)
      const uint32_t next = ((it + 1) & 1) * S_::KV_BYTES;
      tc::load_tile<BK, D, NT>(sK + next, kb, k0 + BK, Sk, tid);
      tc::load_tile<BK, D, NT>(sV + next, vb, k0 + BK, Sk, tid);
      tc::cp_commit();
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    tc::fence_async_smem();
    __syncthreads();

    // S = Q K^T (raw scores, fp32)
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    tc::reg_fence(s);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk & 3) * 32;
      tc::wgmma_ss<0, 0>(
          s, tc::desc(qa + (kk >> 2) * (BQ * 128) + col, 16, 1024),
          tc::desc(sK + stage + (kk >> 2) * (BK * 128) + col, 16, 1024), 1);
    }
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::reg_fence(s);

    // the diagonal and ragged tiles: keys past Sk, or past the row
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > wrow)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = k0 + 8 * j + col0 + c;
            if (col >= Sk || (causal && col > row0 + 8 * i))
              s[4 * j + 2 * i + c] = SG_NEG_INF;
          }
    }
    // online softmax, one row at a time (i), across the quad's 4 lanes
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = tc::fast_exp2((m[i] - mx) * sl2);
      const float ms = mx * sl2;
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = tc::fast_exp2(fmaf(s[4 * j + 2 * i + c], sl2, -ms));
          s[4 * j + 2 * i + c] = p;
          sum += p;
        }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 2 * i] *= corr;
        acc[4 * j + 2 * i + 1] *= corr;
      }
    }

    // O += P V, P rounded to bf16 in registers
    uint32_t pa[BK / 16][4];
    tc::acc_to_a(s, pa);
    tc::reg_fence(acc);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      tc::wgmma_rs<1>(acc, pa[kk],
                      tc::desc(sV + stage + kk * 2048, BK * 128, 1024), 1);
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::reg_fence(acc);
    __syncthreads();  // both warpgroups are done with this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt = fmaxf(lt, 1e-20f);
    const int r = row0 + 8 * i;
    if (r >= Sq) continue;
    const float inv = 1.f / lt;
    bf16* orow = o + ((size_t)bh * Sq + r) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv,
                                acc[4 * j + 2 * i + 1] * inv);
    if ((lane & 3) == 0) lse[(size_t)bh * Sq + r] = m[i] * scale + logf(lt);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int BH, int Sq, int Sk, int causal,
                   float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel_tc<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<D>::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  kern<<<grid, NT, Smem<D>::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), Sq, Sk, causal, scale);
  return cudaGetLastError();
}

}  // namespace fwd_tc


// q (BH, Sq, D), k/v (BH, Sk, D) contiguous, dtype SG_F32 or SG_BF16;
// o like q; lse (BH, Sq) fp32. D must be 64 or 128 (checked by the caller).
// bf16 runs the tensor-core kernel, fp32 the CUDA-core one.
extern "C" int sg_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int BH, int Sq, int Sk, int D,
                            int causal, float scale, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == SG_F32 && D == 64)
    return launch_fp<float, 64>(q, k, v, o, lse, BH, Sq, Sk, causal, scale,
                                s);
  if (dtype == SG_F32 && D == 128)
    return launch_fp<float, 128>(q, k, v, o, lse, BH, Sq, Sk, causal,
                                 scale, s);
  if (dtype == SG_BF16 && D == 64)
    return fwd_tc::launch<64>(q, k, v, o, lse, BH, Sq, Sk, causal, scale,
                              s);
  if (dtype == SG_BF16 && D == 128)
    return fwd_tc::launch<128>(q, k, v, o, lse, BH, Sq, Sk, causal, scale,
                               s);
  return (int)cudaErrorInvalidValue;
}
