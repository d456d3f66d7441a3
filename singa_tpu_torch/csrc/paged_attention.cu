// Paged decode attention: the serving engine's step. Head-packed
// block-diagonal queries (N, Hp, Q, PD) attend over each sequence's pages
// of shared pools (n_pages, Hp, page_size, W), found through an (N, M)
// int32 page table, each sequence masked to its own length: plain decode
// (q_tokens = 1) and the speculative verify step's causal ladder
// (q_tokens > 1), over fp32/bf16 pools (W = PD), int8 pools (W = PD) or
// packed-nibble int4 pools (W = PD / 2) with fp32 scale pools
// (n_pages, Hp, page_size, P). See decode_common.cuh for the math and the
// design.
//
// Replaces singa_tpu/ops/attention.py `_paged_fwd_kernel` (launched by
// `_paged_fwd_pallas`), every branch of it. On the TPU the page table and
// lengths arrive by scalar prefetch and the grid (n, hp, page) streams one
// page per step in order; here `paged_kernel`, grid (splits x row tiles,
// Hp, N), attends one chunk of whole pages per block (the chunk is a
// multiple of the page size), and `paged_kernel_merge` combines the
// partials. A block reads its chunk's page-table entries once, into a
// table of pool rows in shared memory, so the ring's 16-byte copies take
// their addresses from it.
//
// Bound on the H100: bytes, as for flash-decode: every live row of the
// sequence's pages and its scales are read once for 4 * Q * PD flops a
// position. The split and the cp.async ring are flash-decode's; a page of
// one packed head is ps contiguous rows, so neighbouring threads still
// copy neighbouring 16 bytes. Left out: one bulk copy per page (TMA's
// cp.async.bulk) and skipping the block-diagonal zeros. Page ids are
// trusted: the engine owns the table and writes only ids it allocated.

#include "decode_common.cuh"

namespace {

template <bool SCALED>
struct PagedRows {
  static constexpr bool kScaled = SCALED, kTable = true;
  const uint8_t* K;   // pools (n_pages, Hp, ps, W), as bytes
  const uint8_t* V;
  const float* KS;    // scale pools (n_pages, Hp, ps, P) (quantized)
  const float* VS;
  const int* pt;      // this sequence's row of the page table
  int Hp, hp, ps;
  // pool rows of positions [c0, cend) into tab
  __device__ void prepare(long long* tab, int c0, int cend) const {
    for (int t = c0 + (int)threadIdx.x; t < cend; t += blockDim.x)
      tab[t - c0] = ((long long)pt[t / ps] * Hp + hp) * ps + t % ps;
  }
  __device__ size_t row(const long long* tab, int c0, int t) const {
    return tab[t - c0];
  }
};

template <typename T, typename KV, bool SCALED>
__global__ void __launch_bounds__(sg_decode::NT, sg_decode::MINB)
paged_kernel(const T* __restrict__ q, const KV* __restrict__ K,
             const KV* __restrict__ V, const float* __restrict__ KS,
             const float* __restrict__ VS,
             const int* __restrict__ page_table,
             const int* __restrict__ lengths, float* __restrict__ ws, int Hp,
             int Q, int M, int ps, int PD, int P, int G, int q_tokens,
             int chunk, int splits, float scale, int vec16) {
  const int hp = blockIdx.y, n = blockIdx.z;
  const int len = max(lengths[n], 1);
  const size_t bo = (size_t)n * Hp + hp;
  const PagedRows<SCALED> rows{reinterpret_cast<const uint8_t*>(K),
                               reinterpret_cast<const uint8_t*>(V), KS, VS,
                               page_table + (size_t)n * M, Hp, hp, ps};
  const size_t parts = (size_t)gridDim.z * Hp * splits * Q;
  sg_decode::attend<T, KV>(q + bo * Q * PD, ws + bo * splits * Q * PD,
                           ws + parts * PD + bo * splits * Q * 2, Q, PD, len,
                           M * ps, scale, q_tokens, P, G, chunk, splits,
                           vec16 != 0, rows);
}

template <typename T>
__global__ void __launch_bounds__(sg_decode::NT)
paged_kernel_merge(const float* __restrict__ ws, T* __restrict__ o, int Q,
                   int PD, int splits) {
  const size_t bo = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t parts = (size_t)gridDim.z * gridDim.y * splits * Q;
  sg_decode::merge(ws + bo * splits * Q * PD,
                   ws + parts * PD + bo * splits * Q * 2, o + bo * Q * PD, Q,
                   PD, splits);
}

template <typename T, typename KV, bool SCALED>
cudaError_t launch(const void* q, const void* K, const void* V,
                   const void* KS, const void* VS, const void* page_table,
                   const void* lengths, void* o, void* ws, int N, int Hp,
                   int Q, int M, int ps, int PD, int P, int G, int q_tokens,
                   int chunk, int splits, float scale, cudaStream_t stream) {
  using namespace sg_decode;
  const Geo geo(Kv<KV>::row_bytes(PD), Kv<KV>::LPC, SCALED ? P : 0,
                min(QT, Q), chunk, true);
  auto kern = paged_kernel<T, KV, SCALED>;
  static SmemLimit limit, merge_limit;
  cudaError_t err =
      limit.need(reinterpret_cast<const void*>(kern), geo.bytes);
  if (err != cudaSuccess) return err;
  const int vec16 = geo.RB % 16 == 0 && aligned16(K) && aligned16(V);
  const dim3 grid(splits * ((Q + QT - 1) / QT), Hp, N);
  kern<<<grid, NT, geo.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(K),
      static_cast<const KV*>(V), static_cast<const float*>(KS),
      static_cast<const float*>(VS), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<float*>(ws), Hp, Q, M,
      ps, PD, P, G, q_tokens, chunk, splits, scale, vec16);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_merge(paged_kernel_merge<T>, merge_limit,
                      static_cast<const float*>(ws), static_cast<T*>(o), N,
                      Hp, Q, PD, splits, stream);
}

template <typename T>
int dispatch(int kv, const void* q, const void* K, const void* V,
             const void* KS, const void* VS, const void* page_table,
             const void* lengths, void* o, void* ws, int N, int Hp, int Q,
             int M, int ps, int PD, int P, int G, int q_tokens, int chunk,
             int splits, float scale, cudaStream_t s) {
  if (kv == sg_decode::KV_FP)
    return launch<T, T, false>(q, K, V, KS, VS, page_table, lengths, o, ws,
                               N, Hp, Q, M, ps, PD, P, G, q_tokens, chunk,
                               splits, scale, s);
  if (kv == sg_decode::KV_INT8)
    return launch<T, int8_t, true>(q, K, V, KS, VS, page_table, lengths, o,
                                   ws, N, Hp, Q, M, ps, PD, P, G, q_tokens,
                                   chunk, splits, scale, s);
  if (kv == sg_decode::KV_INT4)
    return launch<T, uint8_t, true>(q, K, V, KS, VS, page_table, lengths, o,
                                    ws, N, Hp, Q, M, ps, PD, P, G, q_tokens,
                                    chunk, splits, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (N, Hp, Q, PD) and o like it, fp32 or bf16 (`dtype`); pools (n_pages,
// Hp, ps, W) of q's type (kv = 0), int8 (kv = 1, W = PD) or packed uint8
// (kv = 2, W = PD / 2); KS/VS (n_pages, Hp, ps, P) fp32 for kv 1 and 2,
// else unused; page_table (N, M) int32, lengths (N,) int32 counted at the
// last query token; rows (q_tokens, P, G); ws fp32, N * Hp * splits * Q *
// (PD + 2) floats; splits * chunk >= M * ps, chunk a multiple of 64 and
// of ps. All contiguous; Q <= 64, PD <= 256. Launches the split kernel,
// then the merge.
extern "C" int sg_paged_attention(const void* q, const void* K,
                                  const void* V, const void* KS,
                                  const void* VS, const void* page_table,
                                  const void* lengths, void* o, void* ws,
                                  int N, int Hp, int Q, int M, int ps,
                                  int PD, int P, int G, int q_tokens,
                                  int chunk, int splits, float scale,
                                  int dtype, int kv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == SG_F32)
    return dispatch<float>(kv, q, K, V, KS, VS, page_table, lengths, o, ws,
                           N, Hp, Q, M, ps, PD, P, G, q_tokens, chunk,
                           splits, scale, s);
  if (dtype == SG_BF16)
    return dispatch<__nv_bfloat16>(kv, q, K, V, KS, VS, page_table, lengths,
                                   o, ws, N, Hp, Q, M, ps, PD, P, G,
                                   q_tokens, chunk, splits, scale, s);
  return (int)cudaErrorInvalidValue;
}
