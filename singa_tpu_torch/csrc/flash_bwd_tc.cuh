// The tensor-core flash backward's key-block walk (bf16), one body for two
// kernels: K2a `flash_bwd_fused_tc_kernel` (flash_bwd_fused.cu, DQ true)
// and K2c `flash_bwd_dkv_tc_kernel` (flash_bwd_dkv.cu, DQ false). Building
// blocks in flash_tc.cuh.
//
// Inputs: q PRE-SCALED by the softmax scale, k, v, dO, all bf16 (BH, S, D)
// rows; fp32 (BH, Sq) lse and delta = rowsum(dO * O). A block owns 128 keys,
// two warpgroups of 64 keys each with their dK and dV fp32 accumulators in
// registers, and streams 64-row q tiles (q, dO, lse, delta) through a
// two-stage ring that cp.async fills one tile ahead (a third stage, which
// K2c's shared memory has room for, measured no faster on the H100).
// - Transposed products, keys as the M rows: S^T = K Q^T and
//   dP^T = V dO^T by wgmma from shared memory. P^T = exp(S^T - lse) and
//   dS^T = P^T (dP^T - delta) then come out in the accumulator layout,
//   which rounded to bf16 is directly the register A operand of
//   dV += P^T dO and dK += dS^T q (dO and q read MN-major).
// - DQ (K2a): dQ = dS K needs q rows as M: dS^T goes to shared memory in
//   bf16 and wgmma reads it MN-major (transpose bit on A) against K, also
//   MN-major; at D 128 each warpgroup takes 64 of dQ's columns. The 64 x D
//   fp32 partial is staged in shared memory and added into the zeroed fp32
//   workspace dq_acc by bulk asynchronous reductions, one 4 D-byte row each
//   (no per-element atomics, but an order that changes from run to run).
//   Without DQ (K2c) the dS^T and staging tiles and their two barriers a
//   tile drop out, and nothing is added anywhere: every dK/dV row is
//   written once by one block, bitwise reproducible. With the same tiles,
//   order and rounding, K2c's dK and dV equal K2a's bit for bit.
// - Causal: the walk starts at the q tile holding row k0 (the first that
//   sees these keys); only tiles crossing the diagonal or the ragged ends
//   are masked.
// - dK, dV (128), S^T and dP^T (64) fp32 registers a thread at the peak.
#pragma once

#include "flash_tc.cuh"

namespace bwd_tc {

using tc::bf16;
constexpr int BK = 128;  // keys a block: two warpgroups of 64
constexpr int BQ = 64;   // q rows a tile
constexpr int NT = 256;
constexpr int NS = 2;    // q/dO ring stages

// K, V; q and dO in NS stages; with DQ the dS^T tile and the dQ staging
// tile; lse and delta in NS stages; + alignment slack
template <int D, bool DQ>
struct Smem {
  static constexpr uint32_t K_BYTES = BK * D * 2, Q_BYTES = BQ * D * 2;
  static constexpr uint32_t DS_BYTES = DQ ? BK * BQ * 2 : 0;
  static constexpr int DQ_LD = D + 4;  // staging row stride, floats
  static constexpr uint32_t DQ_BYTES = DQ ? BQ * DQ_LD * 4 : 0;
  static constexpr uint32_t K = 0, V = K_BYTES, Q = 2 * K_BYTES,
                            DO = Q + NS * Q_BYTES, DS = DO + NS * Q_BYTES,
                            DQS = DS + DS_BYTES, LSE = DQS + DQ_BYTES,
                            DELTA = LSE + NS * BQ * 4,
                            END = DELTA + NS * BQ * 4;
  static constexpr size_t bytes = 1024 + END;
};

template <int D, bool DQ>
__device__ __forceinline__ void key_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ dq_acc, int Sq, int Sk, int causal) {
  using S_ = Smem<D, DQ>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = tc::align_1k(smem_raw);
  const uint32_t sb = tc::smem_u32(base);
  const uint32_t sK = sb + S_::K, sV = sb + S_::V, sDS = sb + S_::DS,
                 sDQ = sb + S_::DQS;
  const float* lse_s = reinterpret_cast<const float*>(base + S_::LSE);
  const float* delta_s = reinterpret_cast<const float*>(base + S_::DELTA);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;
  const float* lse_b = lse + (size_t)bh * Sq;
  const float* delta_b = delta + (size_t)bh * Sq;

  // q tile `it` (rows q_begin + BQ it ..) into ring stage it % NS: q, dO by
  // 16-byte copies, lse and delta by 4-byte ones (rows may be unaligned)
  const int q_begin = causal ? k0 - k0 % BQ : 0;
  const int n_qt = q_begin < Sq ? (Sq - q_begin + BQ - 1) / BQ : 0;
  auto load_q = [&](int it) {
    const int q0 = q_begin + it * BQ, st = it % NS;
    tc::load_tile<BQ, D, NT>(sb + S_::Q + st * S_::Q_BYTES, q + qoff, q0, Sq,
                             tid);
    tc::load_tile<BQ, D, NT>(sb + S_::DO + st * S_::Q_BYTES, dO + qoff, q0,
                             Sq, tid);
    if (tid < 2 * BQ) {
      const int r = tid % BQ;
      const bool ok = q0 + r < Sq;
      const float* src = (tid < BQ ? lse_b : delta_b) + (ok ? q0 + r : 0);
      tc::cp4(sb + (tid < BQ ? S_::LSE : S_::DELTA) + (st * BQ + r) * 4, src,
              ok ? 4 : 0);
    }
  };

  // q tiles 0 .. NS - 2, one commit group each (K and V ride with the
  // first), so that iteration it waits for all but the NS - 2 newest
  tc::load_tile<BK, D, NT>(sK, k + koff, k0, Sk, tid);
  tc::load_tile<BK, D, NT>(sV, v + koff, k0, Sk, tid);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_qt) load_q(s);
    tc::cp_commit();
  }

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  // this thread's keys (accumulator rows) k0 + krow and + 8, q columns
  // 8 j + col0 + {0, 1} of the tile
  const int krow = wg * 64 + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const uint32_t kw = wg * 64 * 128;  // this warpgroup's K, V rows

  for (int it = 0; it < n_qt; ++it) {
    const int q0 = q_begin + it * BQ, st = it % NS;
    const uint32_t sQ = sb + S_::Q + st * S_::Q_BYTES;
    const uint32_t sO = sb + S_::DO + st * S_::Q_BYTES;
    // the staging tile's last bulk reads are done before the barrier below
    if (DQ && tid < BQ) tc::bulk_wait_read();
    tc::cp_wait<NS - 2>();
    tc::fence_async_smem();
    __syncthreads();
    // stage (it - 1) % NS was last read in iteration it - 1, which every
    // thread has left (the barrier above)
    if (it + NS - 1 < n_qt) load_q(it + NS - 1);
    tc::cp_commit();

    // S^T = K Q^T, dP^T = V dO^T (64 keys x 64 q rows each)
    float s[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
    tc::reg_fence(s);
    tc::reg_fence(dp);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t ka = (kk >> 2) * (BK * 128) + kw + (kk & 3) * 32;
      const uint32_t qa = (kk >> 2) * (BQ * 128) + (kk & 3) * 32;
      tc::wgmma_ss<0, 0>(s, tc::desc(sK + ka, 16, 1024),
                         tc::desc(sQ + qa, 16, 1024), 1);
      tc::wgmma_ss<0, 0>(dp, tc::desc(sV + ka, 16, 1024),
                         tc::desc(sO + qa, 16, 1024), 1);
    }
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::reg_fence(s);
    tc::reg_fence(dp);

    // P^T and dS^T in place; masked: causal, ragged q rows and keys
    const bool need_mask =
        q0 + BQ > Sq || k0 + BK > Sk || (causal && q0 < k0 + BK - 1);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qc = 8 * j + col0 + c;
        const float l2 = lse_s[st * BQ + qc] * tc::LOG2E;
        const float dl = delta_s[st * BQ + qc];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * j + 2 * i + c;
          float p = tc::fast_exp2(fmaf(s[e], tc::LOG2E, -l2));
          if (need_mask) {
            const int kr = k0 + krow + 8 * i, qr = q0 + qc;
            if (qr >= Sq || kr >= Sk || (causal && kr > qr)) p = 0.f;
          }
          s[e] = p;
          dp[e] = p * (dp[e] - dl);
        }
      }
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
    tc::acc_to_a(s, pa);
    tc::acc_to_a(dp, dsa);
    if constexpr (DQ) {
      // dS^T rows (keys) of 64 q in bf16, swizzled 128-byte rows: the
      // value pair of accumulator chunk j, row i is dsa[j / 2][2 (j % 2) + i]
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = krow + 8 * i;
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
          tc::st_shared_b32(
              sDS + row * 128 + ((j ^ (row & 7)) << 4) + col0 * 2,
              dsa[j >> 1][2 * (j & 1) + i]);
      }
      tc::fence_async_smem();
    }

    // dV += P^T dO, dK += dS^T q
    tc::reg_fence(dva);
    tc::reg_fence(dka);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      tc::wgmma_rs<1>(dva, pa[kk], tc::desc(sO + kk * 2048, BQ * 128, 1024),
                      1);
      tc::wgmma_rs<1>(dka, dsa[kk], tc::desc(sQ + kk * 2048, BQ * 128, 1024),
                      1);
    }
    tc::wg_commit();
    if constexpr (!DQ) {
      tc::wg_wait<0>();
      tc::reg_fence(dva);
      tc::reg_fence(dka);
    } else {
      __syncthreads();  // dS^T of both warpgroups is in shared memory

      // dQ (64 q x D) = dS K, warpgroup wg taking columns 64 wg.. (D 128)
      if (D == 128 || wg == 0) {
        float dq[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) dq[i] = 0.f;
        tc::reg_fence(dq);
        tc::wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          tc::wgmma_ss<1, 1>(
              dq, tc::desc(sDS + kk * 2048, BK * 128, 1024),
              tc::desc(sK + wg * (BK * 128) + kk * 2048, BK * 128, 1024), 1);
        tc::wg_commit();
        tc::wg_wait<0>();
        tc::reg_fence(dq);
        tc::reg_fence(dva);
        tc::reg_fence(dka);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = warp * 16 + (lane >> 2) + 8 * i;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            tc::st_shared_f32x2(
                sDQ + (r * S_::DQ_LD + wg * 64 + 8 * j + col0) * 4,
                dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]);
        }
      } else {
        tc::wg_wait<0>();
        tc::reg_fence(dva);
        tc::reg_fence(dka);
      }
      tc::fence_async_smem();
      __syncthreads();  // the staging tile is complete
      if (tid < BQ && q0 + tid < Sq) {
        tc::bulk_add_f32(dq_acc + qoff + (size_t)(q0 + tid) * D,
                         sDQ + tid * S_::DQ_LD * 4, D * 4);
        tc::bulk_commit();
      }
    }
  }
  tc::cp_wait<0>();
  if (DQ && tid < BQ) tc::bulk_wait();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kr = k0 + krow + 8 * i;
    if (kr >= Sk) continue;
    const size_t off = koff + (size_t)kr * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
          __floats2bfloat162_rn(dka[4 * j + 2 * i], dka[4 * j + 2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
    }
  }
}

// A __global__ wrapper of key_block: its own name in a profile.
using Kernel = void (*)(const bf16*, const bf16*, const bf16*, const bf16*,
                        const float*, const float*, bf16*, bf16*, float*, int,
                        int, int);

// One block per (bh, 128-key tile), NT threads, Smem<D, DQ> bytes.
template <int D, bool DQ>
cudaError_t launch(Kernel kern, const void* q, const void* k, const void* v,
                   const void* dO, const void* lse, const void* delta,
                   void* dk, void* dv, void* dq_acc, int BH, int Sq, int Sk,
                   int causal, cudaStream_t stream) {
  constexpr size_t bytes = Smem<D, DQ>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + BK - 1) / BK, BH);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dq_acc), Sq, Sk, causal);
  return cudaGetLastError();
}

}  // namespace bwd_tc
