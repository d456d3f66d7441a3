// Flash-attention backward in fp32 on the CUDA cores: the tile math of the
// three backward kernels' fp32 paths (flash_bwd_fused.cu, flash_bwd_dq.cu,
// flash_bwd_dkv.cu). Their bf16 paths run on the tensor cores
// (flash_bwd_tc.cuh, flash_bwd_dq.cu); fp32 stays here because wgmma on
// fp32 inputs runs in TF32.
//
// Inputs, all fp32 (BH, S, D) rows: q PRE-SCALED by the softmax
// scale (as `_flash_bwd_pallas` hands it to the TPU kernels), k, v, dO; and
// fp32 (BH, Sq) rows lse (the forward's logsumexp of the scaled scores) and
// delta = rowsum(dO * O). For each (64 q rows) x (64 keys) tile:
//
//   P  = exp(q k^T - lse)      (masked: causal, ragged rows and keys -> 0)
//   dP = dO v^T
//   dS = P * (dP - delta)
//   dV += P^T dO,  dK += dS^T q,  dQ += dS k   (dQ scaled by `scale` last)
//
// Arithmetic is fp32 on the CUDA cores from shared memory; tiles are held
// with rows padded to D + 1 floats, so that a warp's 16 lanes that
// read 16 different rows at one column hit 16 different banks. A block has
// 256 threads as a 16 x 16 grid (tx, ty): in the score tile each thread
// owns rows ty + 16 i and keys tx + 16 j (i, j < 4); in a (64, D)
// accumulator it owns rows ty + 16 i and columns tx + 16 j (j < D / 16).
//
// Shared memory per block: q, dO, k, v tiles (4 x 64 x (D+1) floats), the
// P and dS tiles (2 x 64 x 65) and the row statistics (2 x 64): 162 KB at
// D = 128 and 98 KB at D = 64, above the 48 KB static limit, so every
// launch opts in with cudaFuncSetAttribute first.
#pragma once

#include "common.cuh"

namespace fbwd {

constexpr int BQ = 64;         // q rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int NT = 256;        // threads per block
constexpr int PS = BK + 1;     // row stride of the P and dS tiles

template <int D>
struct Smem {
  static constexpr int LD = D + 1;  // row stride of the (64, D) tiles
  static constexpr size_t bytes =
      (size_t)(4 * 64 * LD + 2 * 64 * PS + 2 * 64) * sizeof(float);
};

// Pointers into one block's shared memory.
template <int D>
struct Tiles {
  float *q, *dO, *k, *v, *p, *ds, *lse, *delta;
  __device__ explicit Tiles(float* s) {
    constexpr int LD = D + 1;
    q = s;
    dO = q + 64 * LD;
    k = dO + 64 * LD;
    v = k + 64 * LD;
    p = v + 64 * LD;
    ds = p + 64 * PS;
    lse = ds + 64 * PS;
    delta = lse + 64;
  }
};

// Rows [r0, r0 + 64) of a (S, D) matrix into a 64 x (D + 1) tile; rows at
// or past S are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int S) {
  for (int e = threadIdx.x; e < 64 * D; e += NT) {
    const int r = e / D, d = e % D;
    dst[r * (D + 1) + d] = (r0 + r < S) ? src[(size_t)(r0 + r) * D + d] : 0.f;
  }
}

// lse and delta of rows [q0, q0 + 64); zero past Sq (those rows' P is
// masked to 0 anyway, so a padded row never reads a stale statistic).
__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s,
                                           const float* lse,
                                           const float* delta, int q0,
                                           int Sq) {
  const int t = threadIdx.x;
  if (t < 64) {
    const bool ok = q0 + t < Sq;
    lse_s[t] = ok ? lse[q0 + t] : 0.f;
    delta_s[t] = ok ? delta[q0 + t] : 0.f;
  }
}

// P and dS of the tile (q rows q0.., keys k0..) into t.p and t.ds.
template <int D>
__device__ __forceinline__ void tile_p_ds(const Tiles<D>& t, int q0, int k0,
                                          int Sq, int Sk, int causal) {
  constexpr int LD = D + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = t.q[(ty + 16 * i) * LD + d];
      ov[i] = t.dO[(ty + 16 * i) * LD + d];
      kv[i] = t.k[(tx + 16 * i) * LD + d];
      vv[i] = t.v[(tx + 16 * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    const float l = t.lse[r], dl = t.delta[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, col = k0 + c;
      const bool ok = row < Sq && col < Sk && (!causal || col <= row);
      const float p = ok ? __expf(s[i][j] - l) : 0.f;
      t.p[r * PS + c] = p;
      t.ds[r * PS + c] = p * (dp[i][j] - dl);
    }
  }
}

// dV[c] += sum_r P[r, c] dO[r];  dK[c] += sum_r dS[r, c] q[r]
// over the 64 q rows of the tile (c = ty + 16 i, columns tx + 16 j).
template <int D>
__device__ __forceinline__ void acc_dkv(const Tiles<D>& t,
                                        float (&dk)[4][D / 16],
                                        float (&dv)[4][D / 16]) {
  constexpr int LD = D + 1, DJ = D / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int r = 0; r < BQ; ++r) {
    float p[4], ds[4], qv[DJ], ov[DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = t.p[r * PS + ty + 16 * i];
      ds[i] = t.ds[r * PS + ty + 16 * i];
    }
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      qv[j] = t.q[r * LD + tx + 16 * j];
      ov[j] = t.dO[r * LD + tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dv[i][j] = fmaf(p[i], ov[j], dv[i][j]);
        dk[i][j] = fmaf(ds[i], qv[j], dk[i][j]);
      }
  }
}

// dQ[r] += sum_c dS[r, c] k[c] over the 64 keys of the tile
// (r = ty + 16 i, columns tx + 16 j); unscaled.
template <int D>
__device__ __forceinline__ void acc_dq(const Tiles<D>& t,
                                       float (&dq)[4][D / 16]) {
  constexpr int LD = D + 1, DJ = D / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int c = 0; c < BK; ++c) {
    float ds[4], kv[DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) ds[i] = t.ds[(ty + 16 * i) * PS + c];
#pragma unroll
    for (int j = 0; j < DJ; ++j) kv[j] = t.k[c * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) dq[i][j] = fmaf(ds[i], kv[j], dq[i][j]);
  }
}

// One block per (bh, 64-key tile): walks the q tiles that see its keys
// (causal: from the diagonal tile on) and accumulates dK, dV in registers,
// written once at the end, so no two blocks write one row. FUSED also adds
// each tile's dS k into the zeroed fp32 dq_acc (BH, Sq, D) with atomics.
template <int D, bool FUSED>
__global__ void __launch_bounds__(NT)
flash_bwd_kv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, float* __restrict__ dq_acc, int Sq,
                    int Sk, int causal) {
  extern __shared__ float smem[];
  const Tiles<D> t(smem);
  constexpr int DJ = D / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;

  load_tile<D>(t.k, k + koff, k0, Sk);
  load_tile<D>(t.v, v + koff, k0, Sk);

  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: q rows before k0 see none of these keys; BQ == BK, so the
  // first q tile that does is the diagonal one
  const int q_begin = causal ? k0 : 0;
  for (int q0 = q_begin; q0 < Sq; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(t.q, q + qoff, q0, Sq);
    load_tile<D>(t.dO, dO + qoff, q0, Sq);
    load_stats(t.lse, t.delta, lse + (size_t)bh * Sq,
               delta + (size_t)bh * Sq, q0, Sq);
    __syncthreads();
    tile_p_ds<D>(t, q0, k0, Sq, Sk, causal);
    __syncthreads();
    acc_dkv<D>(t, dk_acc, dv_acc);
    if (FUSED) {
      float dq[4][DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) dq[i][j] = 0.f;
      acc_dq<D>(t, dq);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= Sq) continue;
        float* dst = dq_acc + qoff + (size_t)row * D + tx;
#pragma unroll
        for (int j = 0; j < DJ; ++j) atomicAdd(dst + 16 * j, dq[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Sk) continue;
    const size_t o = koff + (size_t)row * D + tx;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[o + 16 * j] = dk_acc[i][j];
      dv[o + 16 * j] = dv_acc[i][j];
    }
  }
}

template <int D, bool FUSED>
cudaError_t launch_kv(const void* q, const void* k, const void* v,
                      const void* dO, const void* lse, const void* delta,
                      void* dk, void* dv, void* dq_acc, int BH, int Sq,
                      int Sk, int causal, cudaStream_t stream) {
  auto kern = flash_bwd_kv_kernel<D, FUSED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<D>::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + BK - 1) / BK, BH);
  kern<<<grid, NT, Smem<D>::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dq_acc),
      Sq, Sk, causal);
  return cudaGetLastError();
}

}  // namespace fbwd
