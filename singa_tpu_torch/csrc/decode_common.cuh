// The decode-attention body shared by flash_decode.cu and
// paged_attention.cu: one block attends one (sequence n, packed head hp)'s
// Q packed query rows over its first `len` cache positions, with the online
// softmax over tiles of DT positions. The two kernels differ only in where
// cache position t of (n, hp) lives: a contiguous (T, PD) slab for the dense
// cache, a page found through the page table for the paged pool. `Rows`
// supplies that address.
//
// Layout (as in the JAX package): queries are head-packed and
// block-diagonal, (Q, PD) with PD = P*D lanes. The zeros off the diagonal
// blocks make the score over all PD lanes exactly the own-head score, and
// every PD lane of the output is written, as the TPU kernels do; the caller
// keeps the diagonal blocks. Skipping the zero blocks (P times fewer
// flops and shared-memory reads) is later work.
#pragma once

#include "common.cuh"

namespace sg_decode {

constexpr int DT = 64;                    // cache positions per tile
constexpr int NT = 128;                   // threads per block
constexpr int MAXQ = 16;                  // packed query rows
constexpr int MAXPD = 256;                // packed lanes
constexpr int MAXE = MAXQ * MAXPD / NT;   // output elements per thread

inline size_t smem_bytes(int Q, int PD) {
  return (size_t)(Q * PD + DT * (PD + 1) + DT * PD + Q * DT + 3 * Q) *
         sizeof(float);
}

template <typename T, typename Rows>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       T* __restrict__ o, int Q, int PD,
                                       int len, float scale,
                                       const Rows& rows) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // Q x PD, pre-scaled
  float* Ks = Qs + Q * PD;          // DT x (PD + 1)
  float* Vs = Ks + DT * (PD + 1);   // DT x PD
  float* Ps = Vs + DT * PD;         // Q x DT probabilities
  float* Ms = Ps + Q * DT;          // running max per row
  float* Ls = Ms + Q;               // running sum per row
  float* Cs = Ls + Q;               // this tile's rescale factor per row

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int QPD = Q * PD;
  for (int e = tid; e < QPD; e += NT) Qs[e] = to_f32(q[e]) * scale;
  if (tid < Q) {
    Ms[tid] = SG_NEG_INF;
    Ls[tid] = 0.f;
  }
  float acc[MAXE];
#pragma unroll
  for (int j = 0; j < MAXE; ++j) acc[j] = 0.f;

  for (int t0 = 0; t0 < len; t0 += DT) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < DT * PD; e += NT) {
      const int r = e / PD, d = e % PD;
      const int t = t0 + r;
      float kv = 0.f, vv = 0.f;
      if (t < len) {
        kv = to_f32(rows.k(t)[d]);
        vv = to_f32(rows.v(t)[d]);
      }
      Ks[r * (PD + 1) + d] = kv;
      Vs[e] = vv;
    }
    __syncthreads();

    for (int r = warp; r < Q; r += NT / 32) {
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
      if (t0 + lane >= len) s0 = SG_NEG_INF;
      if (t0 + lane + 32 >= len) s1 = SG_NEG_INF;
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = __expf(s0 - m_new), p1 = __expf(s1 - m_new);
      const float corr = __expf(m_old - m_new);
      const float psum = warp_sum(p0 + p1);  // every lane has read Ms[r]
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
    if (e < QPD) o[e] = from_f32<T>(acc[j] / fmaxf(Ls[e / PD], 1e-20f));
  }
}

}  // namespace sg_decode
