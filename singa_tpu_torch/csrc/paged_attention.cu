// Paged decode attention: the serving engine's step. Head-packed
// block-diagonal queries (N, Hp, Q, PD) attend over each sequence's pages
// of shared pools (n_pages, Hp, page_size, PD), found through an (N, M)
// int32 page table, each sequence masked to its own length.
//
// Replaces singa_tpu/ops/attention.py `_paged_fwd_kernel` (launched by
// `_paged_fwd_pallas`) for fp32/bf16 pools and q_tokens = 1. On the TPU the
// page table and lengths arrive by scalar prefetch and the grid
// (n, hp, page) streams one page per step; here one block per (n, hp) reads
// its own row of the page table and walks the pages up to
// ceil(len / page_size), 64 positions (several pages) per tile.
//
// Bound on the H100: bytes, as for flash-decode: every live row of the
// sequence's pages is read once for 4 * Q * PD flops a position. The simple
// design leaves on the table: split-K over pages for more than N * Hp
// blocks, 16-byte vector or TMA loads of whole pages, and skipping the
// block-diagonal zeros. Quantized pools and the q_tokens > 1 verify ladder
// are not ported yet: the wrapper raises on them. Page ids are trusted:
// the engine owns the table and writes only ids it allocated.

#include "decode_common.cuh"

namespace {

template <typename T>
struct PagedRows {
  const T* K;       // pools (n_pages, Hp, ps, PD)
  const T* V;
  const int* pt;    // this sequence's row of the page table
  int Hp, hp, ps, PD;
  __device__ size_t off(int t) const {
    return (((size_t)pt[t / ps] * Hp + hp) * ps + t % ps) * PD;
  }
  __device__ const T* k(int t) const { return K + off(t); }
  __device__ const T* v(int t) const { return V + off(t); }
};

template <typename T>
__global__ void __launch_bounds__(sg_decode::NT)
paged_kernel(const T* __restrict__ q, const T* __restrict__ K,
             const T* __restrict__ V, const int* __restrict__ page_table,
             const int* __restrict__ lengths, T* __restrict__ o, int Hp,
             int Q, int M, int ps, int PD, float scale) {
  const int hp = blockIdx.x, n = blockIdx.y;
  const int len = min(max(lengths[n], 1), M * ps);
  const size_t bo = (size_t)n * Hp + hp;
  const PagedRows<T> rows{K, V, page_table + (size_t)n * M, Hp, hp, ps, PD};
  sg_decode::attend(q + bo * Q * PD, o + bo * Q * PD, Q, PD, len, scale,
                    rows);
}

template <typename T>
cudaError_t launch(const void* q, const void* K, const void* V,
                   const void* page_table, const void* lengths, void* o,
                   int N, int Hp, int Q, int M, int ps, int PD, float scale,
                   cudaStream_t stream) {
  const size_t smem = sg_decode::smem_bytes(Q, PD);
  auto kern = paged_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Hp, N), sg_decode::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(K),
      static_cast<const T*>(V), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<T*>(o), Hp, Q, M, ps, PD,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q (N, Hp, Q, PD), pools (n_pages, Hp, ps, PD), page_table (N, M) int32,
// lengths (N,) int32, o like q; all contiguous. Q <= 16, PD <= 256.
extern "C" int sg_paged_attention(const void* q, const void* K,
                                  const void* V, const void* page_table,
                                  const void* lengths, void* o, int N, int Hp,
                                  int Q, int M, int ps, int PD, float scale,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == SG_F32)
    return launch<float>(q, K, V, page_table, lengths, o, N, Hp, Q, M, ps,
                         PD, scale, s);
  if (dtype == SG_BF16)
    return launch<__nv_bfloat16>(q, K, V, page_table, lengths, o, N, Hp, Q,
                                 M, ps, PD, scale, s);
  return (int)cudaErrorInvalidValue;
}
