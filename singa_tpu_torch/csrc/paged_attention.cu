// Paged decode attention: the serving engine's step. Head-packed
// block-diagonal queries (N, Hp, Q, PD) attend over each sequence's pages
// of shared pools (n_pages, Hp, page_size, W), found through an (N, M)
// int32 page table, each sequence masked to its own length: plain decode
// (q_tokens = 1) and the speculative verify step's causal ladder
// (q_tokens > 1), over fp32/bf16 pools (W = PD), int8 pools (W = PD) or
// packed-nibble int4 pools (W = PD / 2) with fp32 scale pools
// (n_pages, Hp, page_size, P). See decode_common.cuh for the math.
//
// Replaces singa_tpu/ops/attention.py `_paged_fwd_kernel` (launched by
// `_paged_fwd_pallas`), every branch of it. On the TPU the page table and
// lengths arrive by scalar prefetch and the grid (n, hp, page) streams one
// page per step; here one block per (n, hp, 16-row tile) reads its own row
// of the page table and walks the pages up to ceil(len / page_size), 64
// positions (several pages) per tile.
//
// Bound on the H100: bytes, as for flash-decode: every live row of the
// sequence's pages and its scales are read once for 4 * Q * PD flops a
// position. The simple design leaves on the table: split-K over pages for
// more than N * Hp blocks, 16-byte vector or TMA loads of whole pages, and
// skipping the block-diagonal zeros. Page ids are trusted: the engine owns
// the table and writes only ids it allocated.

#include "decode_common.cuh"

namespace {

template <typename KV, bool SCALED>
struct PagedRows {
  static constexpr bool kScaled = SCALED;
  const KV* K;        // pools (n_pages, Hp, ps, W)
  const KV* V;
  const float* KS;    // scale pools (n_pages, Hp, ps, P) (quantized)
  const float* VS;
  const int* pt;      // this sequence's row of the page table
  int Hp, hp, ps, W, P;
  __device__ size_t row(int t) const {
    return ((size_t)pt[t / ps] * Hp + hp) * ps + t % ps;
  }
  __device__ const KV* k(int t) const { return K + row(t) * W; }
  __device__ const KV* v(int t) const { return V + row(t) * W; }
  __device__ const float* ks(int t) const { return KS + row(t) * P; }
  __device__ const float* vs(int t) const { return VS + row(t) * P; }
};

template <typename T, typename KV, bool SCALED>
__global__ void __launch_bounds__(sg_decode::NT, 1)
paged_kernel(const T* __restrict__ q, const KV* __restrict__ K,
             const KV* __restrict__ V, const float* __restrict__ KS,
             const float* __restrict__ VS,
             const int* __restrict__ page_table,
             const int* __restrict__ lengths, T* __restrict__ o, int Hp,
             int Q, int M, int ps, int PD, int P, int G, int q_tokens,
             float scale) {
  const int hp = blockIdx.x, n = blockIdx.y;
  const int len = max(lengths[n], 1);
  const size_t bo = (size_t)n * Hp + hp;
  const PagedRows<KV, SCALED> rows{
      K, V, KS, VS, page_table + (size_t)n * M, Hp, hp, ps,
      sg_decode::row_width<KV>(PD), P};
  sg_decode::attend(q + bo * Q * PD, o + bo * Q * PD, Q, PD, len, M * ps,
                    scale, q_tokens, P, G, rows);
}

template <typename T, typename KV, bool SCALED>
cudaError_t launch(const void* q, const void* K, const void* V,
                   const void* KS, const void* VS, const void* page_table,
                   const void* lengths, void* o, int N, int Hp, int Q, int M,
                   int ps, int PD, int P, int G, int q_tokens, float scale,
                   cudaStream_t stream) {
  const size_t smem = sg_decode::smem_bytes(PD, SCALED ? P : 0);
  auto kern = paged_kernel<T, KV, SCALED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hp, N, (Q + sg_decode::QT - 1) / sg_decode::QT);
  kern<<<grid, sg_decode::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(K),
      static_cast<const KV*>(V), static_cast<const float*>(KS),
      static_cast<const float*>(VS), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<T*>(o), Hp, Q, M, ps,
      PD, P, G, q_tokens, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int kv, const void* q, const void* K, const void* V,
             const void* KS, const void* VS, const void* page_table,
             const void* lengths, void* o, int N, int Hp, int Q, int M,
             int ps, int PD, int P, int G, int q_tokens, float scale,
             cudaStream_t s) {
  if (kv == sg_decode::KV_FP)
    return launch<T, T, false>(q, K, V, KS, VS, page_table, lengths, o, N,
                               Hp, Q, M, ps, PD, P, G, q_tokens, scale, s);
  if (kv == sg_decode::KV_INT8)
    return launch<T, int8_t, true>(q, K, V, KS, VS, page_table, lengths, o,
                                   N, Hp, Q, M, ps, PD, P, G, q_tokens,
                                   scale, s);
  if (kv == sg_decode::KV_INT4)
    return launch<T, uint8_t, true>(q, K, V, KS, VS, page_table, lengths, o,
                                    N, Hp, Q, M, ps, PD, P, G, q_tokens,
                                    scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (N, Hp, Q, PD) and o like it, fp32 or bf16 (`dtype`); pools (n_pages,
// Hp, ps, W) of q's type (kv = 0), int8 (kv = 1, W = PD) or packed uint8
// (kv = 2, W = PD / 2); KS/VS (n_pages, Hp, ps, P) fp32 for kv 1 and 2,
// else unused; page_table (N, M) int32, lengths (N,) int32 counted at the
// last query token; rows (q_tokens, P, G). All contiguous; Q <= 64,
// PD <= 256.
extern "C" int sg_paged_attention(const void* q, const void* K,
                                  const void* V, const void* KS,
                                  const void* VS, const void* page_table,
                                  const void* lengths, void* o, int N, int Hp,
                                  int Q, int M, int ps, int PD, int P, int G,
                                  int q_tokens, float scale, int dtype,
                                  int kv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == SG_F32)
    return dispatch<float>(kv, q, K, V, KS, VS, page_table, lengths, o, N,
                           Hp, Q, M, ps, PD, P, G, q_tokens, scale, s);
  if (dtype == SG_BF16)
    return dispatch<__nv_bfloat16>(kv, q, K, V, KS, VS, page_table, lengths,
                                   o, N, Hp, Q, M, ps, PD, P, G, q_tokens,
                                   scale, s);
  return (int)cudaErrorInvalidValue;
}
