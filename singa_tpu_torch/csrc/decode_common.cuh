// The decode-attention body shared by flash_decode.cu and
// paged_attention.cu, and the merge that ends every call.
//
// What bounds it on the H100: bytes. A decode step reads each live cache
// row (and its scales) once for 4 * Q * PD flops a position: 2 flops a
// byte at Q = 2, 10 on the ladder's Q = 10, against the card's ~295 at its
// ridge. So the design keeps bytes in flight and spreads them over the
// card (flash-decoding):
//
// - Split the cache axis over blocks. Block (split, row tile, hp, n)
//   attends its row tile of up to QT packed query rows over one chunk of
//   `chunk` positions (a multiple of 64 and, paged, of the page size; the
//   host plans chunk and splits from the shapes alone, never from the
//   lengths, which live on the device). It writes a partial per row: the
//   running max m, the sum l and the unnormalised accumulator over all PD
//   lanes, fp32, into a workspace the caller allocates. A block whose
//   chunk starts at or past min(len, horizon) writes the empty partial
//   (m = SG_NEG_INF, l = 0) and returns. The merge kernel, launched by the
//   same C entry point, combines each row's partials in split order (no
//   atomics: the result is deterministic), skips the empty ones (l = 0,
//   whose accumulators are never written), divides by max(l, 1e-20) and
//   rounds to q's type once. A call so launches two CUDA kernels; the
//   Python wrapper counts it as one launch.
// - Load 16 bytes at a time, tiles ahead. A ring of STAGES tiles of DT
//   positions holds the cache's raw bytes (fp32, bf16, int8 or packed
//   int4) in shared memory, filled by cp.async of 16-byte chunks issued
//   STAGES - 1 tiles ahead of the tile being computed; positions past the
//   chunk's live end are zero-filled. A paged chunk's pool row of every
//   position is worked out once per block (one page-table read and one
//   division a position) into a table in shared memory. Values are
//   dequantised in registers where they are used.
// - Keep the threads busy at small Q, and their latencies overlapped.
//   Scores map threads to (2 positions, 16 slots): GS threads share a
//   position pair, each takes the dots of its slots with two query rows at
//   a time, so every query value read from shared memory feeds two
//   products, and a shuffle reduction over the GS lanes gives the scores.
//   The softmax takes a warp's rows together, one lane per position of the
//   tile (DT = 32). P V maps threads to (4 rows, 4 output slots, position
//   phase): a thread decodes each value once for 4 rows, whose weights are
//   one float4; with few rows the positions of a tile are split into
//   phases that are added up once, at the end of the block. Accumulators
//   stay in registers.
// At the serving shapes a block streams one or two tiles, so what is left
// is latency (the first tile's load, a tile's three barriers) and the two
// launches, not bandwidth: PERF.md has the times beside the bound.
//
// Slots. A row of the cache is CH 16-byte chunks; slot s is the s-th
// value in chunk order (LPC values a chunk). For fp32, bf16 and int8, slot
// s is lane s. For int4 (split-half nibbles: byte j holds lane j in its
// low nibble and lane j + PD/2 in its high one, sign-extended through the
// 0x8 test, ops.attention.nibble_pack) chunk c holds, in slots 32c..32c+15,
// the low nibbles of bytes 16c..16c+15 (lanes 16c + i) and in slots
// 32c+16..32c+31 their high nibbles (lanes PD/2 + 16c + i): one chunk feeds
// two lane ranges. The queries are copied into shared memory in slot
// order, pre-scaled, and the partials are written back in lane order.
// Padding slots (a row whose bytes are not a multiple of 16) have a zero
// query and no lane. Such rows, or caches not 16-byte aligned, are copied
// by plain loads instead of cp.async (`vec16` false).
//
// The math is the TPU kernel's, unchanged. Queries are head-packed and
// block-diagonal, (Q, PD) with PD = P*D lanes; the score is the full PD-lane
// dot product (the zeros off the diagonal blocks make it the own-head
// score) and every PD lane of the output is written; the caller keeps the
// diagonal blocks. The quantized modes carry fp32 scales per (position,
// lane block), (…, P): row r's score at position t is multiplied by K's
// scale of r's lane block after the dot product and before the mask, and
// its probability by V's scale after the running sum takes it, for the
// accumulator only. Padding rows past q_tokens*P*G take factor 1.
//
// The verify ladder (q_tokens > 1): rows are laid out (q_tokens, P, G);
// row r belongs to token ti = min(r / rows_per_token, q_tokens - 1) and
// sees positions < len - (q_tokens - 1 - ti), from the unclamped length;
// only the loads stop at the cache horizon. A row whose limit is <= 0 (an
// inactive engine slot under the ladder) sees no position: its partials
// keep m = SG_NEG_INF, merge with weight 1, and it writes finite values
// that the caller discards, as the TPU kernel does.
#pragma once

#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace sg_decode {

// The kernels' __launch_bounds__ floor of blocks per SM. At 3 they take
// 122-167 registers and spill nothing (sm_90a, nvcc 12.9; chip_smoke.py's
// phase 1 prints ptxas's report); a floor of 4 (<= 128 registers) makes
// the int8 kernels spill. Three 128-thread blocks fit an SM by registers,
// and by shared memory up to ~75 KB a block (the bf16 PD-128 ring is
// 48 KB).
constexpr int MINB = 3;

constexpr int DT = 32;        // cache positions per tile: one per lane
constexpr int NT = 128;       // threads per block
constexpr int QT = 16;        // packed query rows per block
constexpr int STAGES = 3;     // tiles in the cp.async ring
constexpr int MAXQ = 64;      // packed query rows per call
constexpr int MAXPD = 256;    // packed lanes
constexpr int MAXS = MAXPD;   // slots a row (<= 256 for PD <= 256)
constexpr int MAXE = QT * MAXS / 16 / NT;  // P V items (4 x 4) a thread

// cache modes passed from Python (ops/attention.py _KV_MODE)
enum { KV_FP = 0, KV_INT8 = 1, KV_INT4 = 2 };

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
// byte k of w as a signed int8, and nibble k (0..7) as a signed int4
__device__ __forceinline__ float s8(uint32_t w, int k) {
  return (float)((int)(w << (24 - 8 * k)) >> 24);
}
__device__ __forceinline__ float s4(uint32_t w, int k) {
  return (float)((int)(w << (28 - 4 * k)) >> 28);
}

// Per stored type: LPC slots a 16-byte chunk, the row's bytes, a chunk's
// values in slot order, four slots (quad g of a chunk) and the lane of slot
// s (-1: padding).
template <typename KV>
struct Kv;

template <>
struct Kv<float> {
  static constexpr int LPC = 4;
  __host__ __device__ static int row_bytes(int PD) { return PD * 4; }
  __device__ static void chunk(const uint8_t* c, float (&f)[LPC]) {
    const float4 v = *reinterpret_cast<const float4*>(c);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
  __device__ static void quad(const uint8_t* c, int, float (&f)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(c);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
  __device__ static int lane(int s, int PD) { return s < PD ? s : -1; }
};

template <>
struct Kv<__nv_bfloat16> {
  static constexpr int LPC = 8;
  __host__ __device__ static int row_bytes(int PD) { return PD * 2; }
  __device__ static void chunk(const uint8_t* c, float (&f)[LPC]) {
    const uint4 u = *reinterpret_cast<const uint4*>(c);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[2 * i] = bf16_lo(w[i]), f[2 * i + 1] = bf16_hi(w[i]);
  }
  __device__ static void quad(const uint8_t* c, int g, float (&f)[4]) {
    const uint2 u = *reinterpret_cast<const uint2*>(c + 8 * g);
    f[0] = bf16_lo(u.x), f[1] = bf16_hi(u.x);
    f[2] = bf16_lo(u.y), f[3] = bf16_hi(u.y);
  }
  __device__ static int lane(int s, int PD) { return s < PD ? s : -1; }
};

template <>
struct Kv<int8_t> {
  static constexpr int LPC = 16;
  __host__ __device__ static int row_bytes(int PD) { return PD; }
  __device__ static void chunk(const uint8_t* c, float (&f)[LPC]) {
    const uint4 u = *reinterpret_cast<const uint4*>(c);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) f[4 * i + k] = s8(w[i], k);
  }
  __device__ static void quad(const uint8_t* c, int g, float (&f)[4]) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(c + 4 * g);
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = s8(w, k);
  }
  __device__ static int lane(int s, int PD) { return s < PD ? s : -1; }
};

// int4: packed uint8, two lanes a byte (split-half)
template <>
struct Kv<uint8_t> {
  static constexpr int LPC = 32;
  __host__ __device__ static int row_bytes(int PD) { return PD / 2; }
  __device__ static void chunk(const uint8_t* c, float (&f)[LPC]) {
    const uint4 u = *reinterpret_cast<const uint4*>(c);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        f[4 * i + k] = s4(w[i], 2 * k);           // low nibble of byte 4i+k
        f[16 + 4 * i + k] = s4(w[i], 2 * k + 1);  // its high nibble
      }
  }
  // quad g < 4: low nibbles of bytes 4g..4g+3; g >= 4: high nibbles of
  // bytes 4(g-4)..
  __device__ static void quad(const uint8_t* c, int g, float (&f)[4]) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(c + 4 * (g & 3));
    const int hi = g >> 2;
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = s4(w, 2 * k + hi);
  }
  __device__ static int lane(int s, int PD) {
    const int i = s & 31, b = (s >> 5) * 16 + (i & 15);
    return b < PD / 2 ? (i < 16 ? b : b + PD / 2) : -1;
  }
};

__host__ __device__ constexpr int align16(int b) { return (b + 15) & ~15; }

// Per stored type, the score pass's shape: NP positions a thread (2, so
// each query value read from shared memory feeds two products; 1 for int4,
// whose 32-slot chunk fills the registers alone), SPT slots of each, CPT
// chunks.
template <int LPC>
struct Score {
  static constexpr int NP = LPC < 32 ? 2 : 1;
  static constexpr int SPT = LPC < 32 ? 16 : 32;
  static constexpr int CPT = SPT / LPC;
};

// The block's geometry and shared-memory layout, computed alike on the host
// (to size the launch) and in the kernel. `lpc`: slots a chunk; `Qa` =
// min(QT, Q), the largest row tile; `Pn` = P for the quantized modes, else
// 0; `table` for the paged kernel's row table of `chunk` positions.
struct Geo {
  int RB;       // bytes of a cache row
  int CH;       // 16-byte chunks of a row (its stride in shared memory)
  int S;        // slots of a row
  int lg;       // log2(GS)
  int GS;       // threads of a score group (one position)
  int PPP;      // positions of a score pass
  int passes;   // score passes a tile
  int kv_bytes, stage_bytes, qs_off, sc_off, pt_off, ml_off, lim_off;
  int tab_off, bytes;
  __host__ __device__ Geo(int row_bytes, int lpc, int Pn, int Qa, int chunk,
                          bool table) {
    RB = row_bytes;
    CH = (RB + 15) / 16;
    S = CH * lpc;
    const int cpt = lpc < 32 ? 16 / lpc : 1;   // Score<lpc>::CPT
    lg = 0;
    while ((1 << lg) * cpt < CH && lg < 5) ++lg;
    GS = 1 << lg;
    PPP = NT >> lg;
    passes = (DT + PPP - 1) / PPP;
    kv_bytes = DT * CH * 16;
    stage_bytes = 2 * kv_bytes + align16(2 * DT * Pn * 4);
    // the ring, also the phase sums (NT x 16 floats) once it is drained
    qs_off = max(STAGES * stage_bytes, NT * 64);
    sc_off = qs_off + Qa * S * 4;           // Qa x S queries, slot order
    pt_off = sc_off + Qa * DT * 4;          // Qa x DT scores
    ml_off = pt_off + DT * QT * 4;          // DT x QT weights
    lim_off = ml_off + 4 * QT * 4;          // m, l, corr: QT each
    tab_off = lim_off + 2 * QT * 4;         // row limits, scale blocks
    bytes = tab_off + (table ? chunk * 8 : 0);   // chunk pool rows (paged)
  }
};

// Four bytes at b[0..3] (any alignment, n of them live) as a word, the rest
// zero.
__device__ __forceinline__ uint32_t bytes4(const uint8_t* b, int n) {
  uint32_t w = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < n) w |= (uint32_t)b[k] << (8 * k);
  return w;
}

// One block's partial: rows r0 .. r0 + Qt - 1 of this (n, hp)'s (Q, PD)
// queries `q` over positions [c0, c0 + chunk) of the split blockIdx.x %
// splits, into `acc_out` (splits, Q, PD) and `ml_out` (splits, Q, 2) of
// this (n, hp). len: the unclamped live length (>= 1); horizon: the
// positions the cache holds. Rows gives position t's pool row (`row`,
// after `prepare` filled the table) and the row bases K, V (bytes) and KS,
// VS (P fp32 scales a row, Rows::kScaled).
//
// Threads. Scores: GS threads a position; thread li of the group scores
// SPT slots (CPT chunks, li + GS * m' for m' = (m + position) % CPT, so the
// two positions a quarter-warp reads hit different banks) of NP positions
// at once, two rows at a time; the group sums by a shuffle reduction whose
// first level also splits the NP positions between the two halves of the
// group. The softmax takes each warp's rows (up to 4) together. P V: item
// (row group of 4, quad of 4 slots, phase): the quad's values are decoded
// once for 4 rows (the 4 weights one float4), over its phase's positions.
template <typename T, typename KV, typename Rows>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       float* __restrict__ acc_out,
                                       float* __restrict__ ml_out, int Q,
                                       int PD, int len, int horizon,
                                       float scale, int q_tokens, int P,
                                       int G, int chunk, int splits,
                                       bool vec16, const Rows& rows) {
  using KT = Kv<KV>;
  constexpr int LPC = KT::LPC;
  constexpr int NP = Score<LPC>::NP, CPT = Score<LPC>::CPT;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x % splits;
  const int r0 = blockIdx.x / splits * QT;
  const int Qt = min(QT, Q - r0);
  const int hz = min(len, horizon);
  const int c0 = split * chunk;
  float* ml = ml_out + ((size_t)split * Q + r0) * 2;
  if (c0 >= hz) {  // the empty partial
    if (tid < Qt) ml[2 * tid] = SG_NEG_INF, ml[2 * tid + 1] = 0.f;
    return;
  }
  const int cend = min(c0 + chunk, hz);
  const int ntiles = (cend - c0 + DT - 1) / DT;
  const Geo geo(KT::row_bytes(PD), LPC, Rows::kScaled ? P : 0, min(QT, Q),
                chunk, Rows::kTable);
  const int RB = geo.RB, CH = geo.CH, RBS = 16 * geo.CH, S = geo.S;
  const int lg = geo.lg, GS = geo.GS, PPP = geo.PPP;
  float* qs = reinterpret_cast<float*>(smem + geo.qs_off);
  float* sc = reinterpret_cast<float*>(smem + geo.sc_off);
  float4* pt = reinterpret_cast<float4*>(smem + geo.pt_off);
  float* mls = reinterpret_cast<float*>(smem + geo.ml_off);
  int* lims = reinterpret_cast<int*>(smem + geo.lim_off);
  long long* tab = reinterpret_cast<long long*>(smem + geo.tab_off);

  // tile j -> stage j % STAGES: thread (g, li) copies the chunks li,
  // li + GS, .. of positions g, g + PPP, .. of K and of V, zero past the
  // chunk's live end
  const int g = tid >> lg, li = tid & (GS - 1);
  auto issue = [&](int j) {
    uint8_t* st = smem + (j % STAGES) * geo.stage_bytes;
    const int t0 = c0 + j * DT;
    for (int k = 0; k < geo.passes; ++k) {
      const int tt = g + k * PPP;
      if (tt >= DT) break;
      const int t = t0 + tt;
      const bool ok = t < cend;
      const size_t row = ok ? rows.row(tab, c0, t) : 0;
      const uint8_t* src[2] = {rows.K + row * RB, rows.V + row * RB};
      for (int c = li; c < CH; c += GS) {
        const int n = ok ? min(16, RB - 16 * c) : 0;
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          uint8_t* dst = st + kv * geo.kv_bytes + tt * RBS + 16 * c;
          const uint8_t* b = src[kv] + 16 * c;
          if (vec16)
            cp16(smem_u32(dst), b, n);
          else
            *reinterpret_cast<uint4*>(dst) = make_uint4(
                bytes4(b, n), bytes4(b + 4, n - 4), bytes4(b + 8, n - 8),
                bytes4(b + 12, n - 12));
        }
      }
    }
    if constexpr (Rows::kScaled) {
      float* kss = reinterpret_cast<float*>(st + 2 * geo.kv_bytes);
      for (int e = tid; e < DT * P; e += NT) {
        const int tt = e / P, c = e - tt * P, t = t0 + tt;
        const bool ok = t < cend;
        const size_t row = ok ? rows.row(tab, c0, t) : 0;
        cp4(smem_u32(kss + e), rows.KS + row * P + c, ok ? 4 : 0);
        cp4(smem_u32(kss + DT * P + e), rows.VS + row * P + c, ok ? 4 : 0);
      }
    }
  };

  // the first tiles are on their way while the queries are set up
  rows.prepare(tab, c0, cend);
  if constexpr (Rows::kTable) __syncthreads();
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < ntiles) issue(j);
    cp_commit();
  }
  // queries in slot order, float4 i of chunk c of row r at float4
  // (r * LPC/4 + i) * CH + c: a score group's lanes read neighbouring
  // float4s
  for (int e = tid; e < Qt * S; e += NT) {
    const int r = e / S, s = e - r * S, c = s / LPC, i = s % LPC;
    const int d = KT::lane(s, PD);
    qs[((r * (LPC / 4) + i / 4) * CH + c) * 4 + i % 4] =
        d >= 0 ? to_f32(q[(size_t)(r0 + r) * PD + d]) * scale : 0.f;
  }
  for (int e = tid; e < DT * QT / 4; e += NT) pt[e] = make_float4(0, 0, 0, 0);
  if (tid < QT) {
    // row r's limit (from the unclamped length) and K/V scale block:
    // padding rows past q_tokens * P * G read factor 1
    const int rg = r0 + tid, PG = P * G;
    const int ti = min(rg / (Q / q_tokens), q_tokens - 1);
    lims[tid] = min(len - (q_tokens - 1 - ti), hz);
    lims[QT + tid] = rg < q_tokens * PG ? (rg % PG) / G : -1;
    mls[tid] = SG_NEG_INF, mls[QT + tid] = 0.f, mls[2 * QT + tid] = 1.f;
  }

  // P V items: w = tid + e*NT -> (phase, row group, quad); with few items
  // the tile's positions are split into NPH phases, summed at the end
  const int nq = S / 4, I = (Qt + 3) / 4 * nq;
  int NPH = 1;
  while (NPH * 2 <= DT && I * NPH * 2 <= NT) NPH *= 2;
  int item[MAXE];   // quad | row group << 8 | phase << 16, or -1
  float acc[MAXE][4][4];
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    const int w = tid + e * NT;
    const int ph = w / I, it = w - ph * I, rg = it / nq;
    item[e] = w < I * NPH ? (it - rg * nq) | rg << 8 | ph << 16 : -1;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[e][i][k] = 0.f;
  }

  for (int j = 0; j < ntiles; ++j) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // tile j has landed; tile j - 1's readers are done
    if (j + STAGES - 1 < ntiles) issue(j + STAGES - 1);
    cp_commit();
    const uint8_t* st = smem + (j % STAGES) * geo.stage_bytes;
    const int t0 = c0 + j * DT;

    // scores: the GS threads of positions tt[0..NP) reduce their slots'
    // dots; the first shuffle level sends the upper half of the group
    // position 1's sums and the lower half position 0's
    for (int k = 0; k < geo.passes; k += NP) {
      int tt[NP];
      float kf[NP][CPT][LPC];
      int qo[CPT];    // the chunks' first query slot (-1: none)
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int c = li + ((m + g) % CPT) * GS;
        qo[m] = c < CH ? c * LPC : -1;
      }
#pragma unroll
      for (int u = 0; u < NP; ++u) {
        tt[u] = k + u < geo.passes ? g + (k + u) * PPP : DT;
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          if (tt[u] < DT && qo[m] >= 0) {
            KT::chunk(st + tt[u] * RBS + 16 * (qo[m] / LPC), kf[u][m]);
          } else {
#pragma unroll
            for (int i = 0; i < LPC; ++i) kf[u][m][i] = 0.f;
          }
        }
      }
      for (int r = 0; r < Qt; r += 2) {
        const int r1 = min(r + 1, Qt - 1);
        float s[2][NP][2] = {};   // row, position, two partial sums
#pragma unroll
        for (int m = 0; m < CPT; ++m) {
          if (qo[m] < 0) continue;
          const float4* qa = reinterpret_cast<const float4*>(qs) +
                             r * (LPC / 4) * CH + qo[m] / LPC;
          const float4* qb = reinterpret_cast<const float4*>(qs) +
                             r1 * (LPC / 4) * CH + qo[m] / LPC;
#pragma unroll
          for (int i = 0; i < LPC / 4; ++i) {
            const float4 a = qa[i * CH], b = qb[i * CH];
#pragma unroll
            for (int u = 0; u < NP; ++u) {
              const float* f = kf[u][m] + 4 * i;
              s[0][u][0] = fmaf(a.x, f[0], fmaf(a.y, f[1], s[0][u][0]));
              s[0][u][1] = fmaf(a.z, f[2], fmaf(a.w, f[3], s[0][u][1]));
              s[1][u][0] = fmaf(b.x, f[0], fmaf(b.y, f[1], s[1][u][0]));
              s[1][u][1] = fmaf(b.z, f[2], fmaf(b.w, f[3], s[1][u][1]));
            }
          }
        }
        float sa = s[0][0][0] + s[0][0][1], sb = s[1][0][0] + s[1][0][1];
        int wt = tt[0];   // the position this lane's sums end at
        if (NP == 2 && GS > 1) {
          const int h = GS >> 1;
          const bool up = li & h;
          const float ua = s[0][NP - 1][0] + s[0][NP - 1][1];
          const float ub = s[1][NP - 1][0] + s[1][NP - 1][1];
          const float ka = up ? ua : sa, kb = up ? ub : sb;
          sa = ka + __shfl_xor_sync(0xffffffffu, up ? sa : ua, h);
          sb = kb + __shfl_xor_sync(0xffffffffu, up ? sb : ub, h);
          if (up) wt = tt[NP - 1];
          for (int o = h >> 1; o > 0; o >>= 1) {
            sa += __shfl_xor_sync(0xffffffffu, sa, o);
            sb += __shfl_xor_sync(0xffffffffu, sb, o);
          }
          if ((li & (h - 1)) == 0 && wt < DT) {
            sc[r * DT + wt] = sa;
            sc[r1 * DT + wt] = sb;
          }
        } else {
          for (int o = GS >> 1; o > 0; o >>= 1) {
            sa += __shfl_xor_sync(0xffffffffu, sa, o);
            sb += __shfl_xor_sync(0xffffffffu, sb, o);
          }
          if (li == 0 && wt < DT) {
            sc[r * DT + wt] = sa;
            sc[r1 * DT + wt] = sb;
          }
          if (NP == 2 && tt[NP - 1] < DT) {   // GS == 1: both are whole
            sc[r * DT + tt[NP - 1]] = s[0][NP - 1][0] + s[0][NP - 1][1];
            sc[r1 * DT + tt[NP - 1]] = s[1][NP - 1][0] + s[1][NP - 1][1];
          }
        }
      }
    }
    __syncthreads();

    // the online softmax: a warp's rows (r = warp + 4i) together, one lane
    // a position
    const float* kss = reinterpret_cast<const float*>(st + 2 * geo.kv_bytes);
    float* pw = reinterpret_cast<float*>(pt);
    constexpr int RW = QT / (NT / 32);   // rows a warp at most
    float sr[RW], mo[RW], mx[RW], sm[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = min(warp + 4 * i, Qt - 1);
      float v = sc[r * DT + lane];
      if constexpr (Rows::kScaled) {
        const int blk = lims[QT + r];
        if (blk >= 0) v *= kss[lane * P + blk];
      }
      sr[i] = t0 + lane >= lims[r] ? SG_NEG_INF : v;
      mo[i] = mls[r];
      mx[i] = sr[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < RW; ++i)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      mx[i] = fmaxf(mo[i], mx[i]);          // the new running max
      sr[i] = __expf(sr[i] - mx[i]);        // p
      sm[i] = sr[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < RW; ++i)
        sm[i] += __shfl_xor_sync(0xffffffffu, sm[i], o);
    __syncwarp();   // every lane has read mls of its rows
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = warp + 4 * i;
      if (r >= Qt) continue;
      float p = sr[i];
      if constexpr (Rows::kScaled) {
        const int blk = lims[QT + r];
        if (blk >= 0) p *= kss[DT * P + lane * P + blk];
      }
      pw[lane * QT + r] = p;
      if (lane == 0) {
        const float corr = __expf(mo[i] - mx[i]);
        mls[QT + r] = mls[QT + r] * corr + sm[i];
        mls[r] = mx[i];
        mls[2 * QT + r] = corr;
      }
    }
    __syncthreads();

    // P V: each item's quad for its 4 rows over its phase's positions
    const uint8_t* vt = st + geo.kv_bytes;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      if (item[e] < 0) continue;
      const int qd = item[e] & 0xff, rg = (item[e] >> 8) & 0xff;
      const int ph = item[e] >> 16;
      const float4 corr = reinterpret_cast<const float4*>(mls + 2 * QT)[rg];
      const float cf[4] = {corr.x, corr.y, corr.z, corr.w};
      float a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) a[i][k] = acc[e][i][k] * cf[i];
      const uint8_t* vq = vt + qd * 4 / LPC * 16;
      const int gq = qd % (LPC / 4);
#pragma unroll 4
      for (int tt = ph; tt < DT; tt += NPH) {
        const float4 p = pt[tt * (QT / 4) + rg];
        const float pr[4] = {p.x, p.y, p.z, p.w};
        float v[4];
        KT::quad(vq + tt * RBS, gq, v);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) a[i][k] = fmaf(pr[i], v[k], a[i][k]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[e][i][k] = a[i][k];
    }
  }

  // the phases' sums (NPH > 1: one item a thread), in the drained ring
  if (NPH > 1) {
    float4* red = reinterpret_cast<float4*>(smem);
    __syncthreads();
    if (item[0] >= 0)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[tid * 4 + i] = make_float4(acc[0][i][0], acc[0][i][1],
                                       acc[0][i][2], acc[0][i][3]);
    __syncthreads();
    if (tid < I) {
      for (int ph = 1; ph < NPH; ++ph)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 b = red[(ph * I + tid) * 4 + i];
          acc[0][i][0] += b.x, acc[0][i][1] += b.y, acc[0][i][2] += b.z,
              acc[0][i][3] += b.w;
        }
    }
  }
  // the partial, in lane order
  float* out = acc_out + ((size_t)split * Q + r0) * PD;
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    if (item[e] < 0 || (item[e] >> 16) != 0) continue;
    const int qd = item[e] & 0xff, rg = (item[e] >> 8) & 0xff;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = KT::lane(4 * qd + k, PD);
      if (d < 0) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * rg + i < Qt) out[(size_t)(4 * rg + i) * PD + d] = acc[e][i][k];
    }
  }
  if (tid < Qt) ml[2 * tid] = mls[tid], ml[2 * tid + 1] = mls[QT + tid];
}

// The merge of one (n, hp)'s partials `acc` (splits, Q, PD) and `ml`
// (splits, Q, 2) into `o` (Q, PD), NT output elements a block (block x of
// the merge grid): each row's weights exp(m_i - M) (the empty partials,
// l = 0, weigh 0 and are not read), and each element's sum over the splits
// in split order, divided by max(sum of l_i weights, 1e-20). A row's max and
// sum are warp reductions over the splits, in a fixed order too; the
// splits' loads of an element are issued eight at a time. Shared memory:
// merge_smem(Q, PD, splits).
template <typename T>
__device__ __forceinline__ void merge(const float* __restrict__ acc,
                                      const float* __restrict__ ml,
                                      T* __restrict__ o, int Q, int PD,
                                      int splits) {
  extern __shared__ float wts[];   // R x splits weights, R denominators
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int e0 = blockIdx.x * NT;
  const int ra = e0 / PD, rb = min(Q, (e0 + NT - 1) / PD + 1);
  float* den = wts + (rb - ra) * splits;
  for (int r = ra + warp; r < rb; r += NT / 32) {
    float M = SG_NEG_INF;
    for (int i = lane; i < splits; i += 32) {
      const float* p = ml + ((size_t)i * Q + r) * 2;
      if (p[1] > 0.f) M = fmaxf(M, p[0]);
    }
    M = warp_max(M);
    float L = 0.f;
    for (int i = lane; i < splits; i += 32) {
      const float* p = ml + ((size_t)i * Q + r) * 2;
      const float w = p[1] > 0.f ? __expf(p[0] - M) : 0.f;
      wts[(r - ra) * splits + i] = w;
      L = fmaf(p[1], w, L);
    }
    L = warp_sum(L);
    if (lane == 0) den[r - ra] = fmaxf(L, 1e-20f);
  }
  __syncthreads();
  const int e = e0 + tid;
  if (e >= Q * PD) return;
  const float* w = wts + (e / PD - ra) * splits;
  float a = 0.f;
  for (int i0 = 0; i0 < splits; i0 += 8) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = i0 + k;
      v[k] = i < splits && w[i] != 0.f ? acc[(size_t)i * Q * PD + e] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (i0 + k < splits) a = fmaf(w[i0 + k], v[k], a);
  }
  o[e] = from_f32<T>(__fdividef(a, den[e / PD - ra]));
}

// One kernel's dynamic shared-memory limit, raised on the current device
// only when a launch needs more than the limit already set there: the
// attribute is a ceiling, so a kernel instantiation costs one
// cudaFuncSetAttribute per device and size it grows to, not one per
// launch (a decode step is bound by the host's launch path). Each launcher
// keeps one of these as a static beside its kernel.
struct SmemLimit {
  static constexpr int kDevices = 64;
  std::atomic<int> bytes[kDevices] = {};
  cudaError_t need(const void* kern, int want) {
    if (want <= 48 * 1024) return cudaSuccess;   // the default limit
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kDevices && bytes[dev].load(std::memory_order_relaxed) >= want)
      return cudaSuccess;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, want);
    if (err == cudaSuccess && dev < kDevices) {
      int have = bytes[dev].load(std::memory_order_relaxed);
      while (have < want && !bytes[dev].compare_exchange_weak(have, want)) {
      }
    }
    return err;
  }
};

// The merge's launch after the split kernel on `stream`: grid (output
// blocks, Hp, N), NT threads, the rows a block spans times (splits + 1)
// floats of shared memory.
template <typename T>
cudaError_t launch_merge(void (*kern)(const float*, T*, int, int, int),
                         SmemLimit& limit, const float* ws, T* o, int N,
                         int Hp, int Q, int PD, int splits,
                         cudaStream_t stream) {
  const int rows = min(Q, (NT + PD - 1) / PD + 1);
  const size_t smem = (size_t)rows * (splits + 1) * sizeof(float);
  cudaError_t err =
      limit.need(reinterpret_cast<const void*>(kern), (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((Q * PD + NT - 1) / NT, Hp, N), NT, smem, stream>>>(
      ws, o, Q, PD, splits);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace sg_decode
