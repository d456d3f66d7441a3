// The decode-attention body shared by flash_decode.cu and
// paged_attention.cu: one block attends one (sequence n, packed head hp)'s
// tile of up to QT packed query rows over its live cache positions, with
// the online softmax over tiles of DT positions. The two kernels differ
// only in where cache position t of (n, hp) lives: a contiguous slab for
// the dense cache, a page found through the page table for the paged pool.
// `Rows` supplies that address, for the K/V rows and their scales.
//
// Layout (as in the JAX package): queries are head-packed and
// block-diagonal, (Q, PD) with PD = P*D lanes. The zeros off the diagonal
// blocks make the score over all PD lanes exactly the own-head score, and
// every PD lane of the output is written, as the TPU kernels do; the caller
// keeps the diagonal blocks. Skipping the zero blocks (P times fewer
// flops and shared-memory reads) is later work.
//
// Cache modes: fp32/bf16 rows of PD elements; int8 rows of PD bytes; int4
// rows of PD/2 bytes, split-half nibbles (byte j holds lane j in its low
// nibble and lane j + PD/2 in its high one, sign-extended through the 0x8
// test: ops.attention.nibble_pack). The quantized modes carry fp32 scales
// per (position, lane block), (…, P). Rows are dequantized as the tile is
// loaded, so device memory streams the quantized bytes; the shared tiles
// and all arithmetic are fp32. The scales fold in where the TPU kernel
// folds them: row r's score at position t is multiplied by K's scale of
// r's lane block after the dot product and before the mask, and its
// probability by V's scale after the running sum takes it, for the
// accumulator only.
//
// The verify ladder (q_tokens > 1): rows are laid out (q_tokens, P, G);
// row r belongs to token ti = min(r / rows_per_token, q_tokens - 1) and
// sees positions < len - (q_tokens - 1 - ti), from the unclamped length;
// only the loop over tiles stops at the cache horizon. A row whose limit
// is <= 0 (an inactive engine slot under the ladder) sees no position and
// writes finite values that the caller discards, as the TPU kernel does.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace sg_decode {

constexpr int DT = 64;                    // cache positions per tile
constexpr int NT = 128;                   // threads per block
constexpr int QT = 16;                    // packed query rows per block
constexpr int MAXQ = 64;                  // packed query rows per call
constexpr int MAXPD = 256;                // packed lanes
constexpr int MAXE = QT * MAXPD / NT;     // output elements per thread
// The kernels declare __launch_bounds__(NT, 1): without the one-block
// floor ptxas held them to 64-72 registers and spilled 8-24 bytes (sm_90a,
// nvcc 12.9); with it they take 108-122 registers and spill nothing. Two
// blocks fit an SM by shared memory at PD = 128 either way.

// cache modes passed from Python (ops/attention.py _KV_MODE)
enum { KV_FP = 0, KV_INT8 = 1, KV_INT4 = 2 };

// lane d of a cache row as fp32; `half` = PD / 2 (used by int4 only)
__device__ __forceinline__ float kv_at(const float* row, int d, int) {
  return row[d];
}
__device__ __forceinline__ float kv_at(const __nv_bfloat16* row, int d,
                                       int) {
  return __bfloat162float(row[d]);
}
__device__ __forceinline__ float kv_at(const int8_t* row, int d, int) {
  return (float)row[d];
}
__device__ __forceinline__ float kv_at(const uint8_t* row, int d, int half) {
  const bool hi = d >= half;
  const int b = row[hi ? d - half : d];
  const int nib = hi ? (b >> 4) & 0xF : b & 0xF;
  return (float)(nib - ((nib & 0x8) << 1));
}

// cache row width in elements of the stored type
template <typename KV>
__host__ __device__ constexpr int row_width(int PD) {
  return PD;
}
template <>
__host__ __device__ constexpr int row_width<uint8_t>(int PD) {
  return PD / 2;
}

inline size_t smem_bytes(int PD, int P) {
  return (size_t)(QT * PD + DT * (PD + 1) + DT * PD + QT * DT + 3 * QT +
                  2 * DT * P) *
         sizeof(float);
}

// q/o: this (n, hp)'s (Q, PD) rows; the block takes rows r0 .. r0 + QT - 1
// with r0 = blockIdx.z * QT. len: the unclamped live length (>= 1);
// horizon: the positions the cache holds. Rows::kScaled selects the
// quantized modes, whose rows also give ks(t)/vs(t), P fp32 scales each.
template <typename T, typename Rows>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       T* __restrict__ o, int Q, int PD,
                                       int len, int horizon, float scale,
                                       int q_tokens, int P, int G,
                                       const Rows& rows) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // QT x PD, pre-scaled
  float* Ks = Qs + QT * PD;         // DT x (PD + 1)
  float* Vs = Ks + DT * (PD + 1);   // DT x PD
  float* Ps = Vs + DT * PD;         // QT x DT weights (V-scaled)
  float* Ms = Ps + QT * DT;         // running max per row
  float* Ls = Ms + QT;              // running sum per row
  float* Cs = Ls + QT;              // this tile's rescale factor per row
  float* KSs = Cs + QT;             // DT x P K scales (quantized modes)
  float* VSs = KSs + DT * P;        // DT x P V scales

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.z * QT;
  const int Qt = min(QT, Q - r0);
  const int QPD = Qt * PD;
  const int half = PD / 2;
  const int rpt = Q / q_tokens;          // rows per token
  const int PG = P * G;                  // rows per token that read scales
  const int hz = min(len, horizon);      // positions the loop visits
  q += (size_t)r0 * PD;
  o += (size_t)r0 * PD;
  for (int e = tid; e < QPD; e += NT) Qs[e] = to_f32(q[e]) * scale;
  if (tid < Qt) {
    Ms[tid] = SG_NEG_INF;
    Ls[tid] = 0.f;
  }
  float acc[MAXE];
#pragma unroll
  for (int j = 0; j < MAXE; ++j) acc[j] = 0.f;

  for (int t0 = 0; t0 < hz; t0 += DT) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < DT * PD; e += NT) {
      const int r = e / PD, d = e % PD;
      const int t = t0 + r;
      float kv = 0.f, vv = 0.f;
      if (t < hz) {
        kv = kv_at(rows.k(t), d, half);
        vv = kv_at(rows.v(t), d, half);
      }
      Ks[r * (PD + 1) + d] = kv;
      Vs[e] = vv;
    }
    if constexpr (Rows::kScaled) {
      for (int e = tid; e < DT * P; e += NT) {
        const int r = e / P, c = e % P;
        const int t = t0 + r;
        KSs[e] = t < hz ? rows.ks(t)[c] : 0.f;
        VSs[e] = t < hz ? rows.vs(t)[c] : 0.f;
      }
    }
    __syncthreads();

    for (int r = warp; r < Qt; r += NT / 32) {
      const int rg = r0 + r;
      const int ti = min(rg / rpt, q_tokens - 1);
      const int lim = min(len - (q_tokens - 1 - ti), hz);
      const float* qr = Qs + r * PD;
      const float* ka = Ks + lane * (PD + 1);
      const float* kc = Ks + (lane + 32) * (PD + 1);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
      for (int d = 0; d < PD; ++d) {
        const float qd = qr[d];
        s0 = fmaf(qd, ka[d], s0);
        s1 = fmaf(qd, kc[d], s1);
      }
      // lane block of this row: padding rows past q_tokens * P * G read
      // factor 1, as the TPU kernel's _paged_factors gives them
      const int blk = rg < q_tokens * PG ? (rg % PG) / G : -1;
      if constexpr (Rows::kScaled) {
        if (blk >= 0) {
          s0 *= KSs[lane * P + blk];
          s1 *= KSs[(lane + 32) * P + blk];
        }
      }
      if (t0 + lane >= lim) s0 = SG_NEG_INF;
      if (t0 + lane + 32 >= lim) s1 = SG_NEG_INF;
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      float p0 = __expf(s0 - m_new), p1 = __expf(s1 - m_new);
      const float corr = __expf(m_old - m_new);
      const float psum = warp_sum(p0 + p1);  // every lane has read Ms[r]
      if constexpr (Rows::kScaled) {
        if (blk >= 0) {
          p0 *= VSs[lane * P + blk];
          p1 *= VSs[(lane + 32) * P + blk];
        }
      }
      Ps[r * DT + lane] = p0;
      Ps[r * DT + lane + 32] = p1;
      if (lane == 0) {
        Ls[r] = Ls[r] * corr + psum;
        Ms[r] = m_new;
        Cs[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < MAXE; ++j) {
      const int e = tid + j * NT;
      if (e < QPD) {
        const int r = e / PD, d = e % PD;
        const float* pr = Ps + r * DT;
        float a = acc[j] * Cs[r];
        for (int c = 0; c < DT; ++c) a = fmaf(pr[c], Vs[c * PD + d], a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < MAXE; ++j) {
    const int e = tid + j * NT;
    if (e < QPD)
      o[e] = from_f32<T>(__fdividef(acc[j], fmaxf(Ls[e / PD], 1e-20f)));
  }
}

}  // namespace sg_decode
