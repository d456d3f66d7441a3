// Self-check of the wgmma building blocks in flash_tc.cuh: one warpgroup
// computes a single 64 x N product from bf16 inputs through the same tile
// loader, descriptors and fragment layouts the flash kernels use, so that
// ops/wgmma_probe.py can hold each operand flavour against torch.matmul.
// A wrong descriptor (byte offsets, swizzle, transpose bit) gives finite,
// plausible and wrong numbers; here it shows on one product, apart from
// any attention arithmetic.
//
// Modes (row-major inputs; C is 64 x N fp32):
//   0  A (64, 128), Bt (128, 128): C = A Bt^T, both K-major, N 128 (K1's S)
//   1  A (64, 128), Bt (64, 128): C = A Bt^T, N 64 (K2a's S^T and dP^T)
//   2  A (64, 128) in registers, B (128, 128) MN-major: C = A B (K1's P V)
//   3  A (64, 128) in registers, B (128, 64) MN-major (K2a's dV, dK at D 64)
//   4  At (128, 64) MN-major, B (128, 128) MN-major, its columns 64..127:
//      C = At^T B[:, 64:] (K2a's dQ, second warpgroup)

#include "flash_tc.cuh"

namespace {

using tc::bf16;

template <int MODE>
__global__ void __launch_bounds__(128)
wgmma_probe_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                   float* __restrict__ c) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sA = tc::smem_u32(tc::align_1k(smem_raw));
  const uint32_t sB = sA + 64 * 128 * 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int N = (MODE == 0 || MODE == 2) ? 128 : 64;
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;

  if (MODE == 0 || MODE == 1) {
    tc::load_tile<64, 128, 128>(sA, a, 0, 64, tid);
    tc::load_tile<N, 128, 128>(sB, b, 0, N, tid);
  } else if (MODE == 2 || MODE == 3) {
    tc::load_tile<128, N, 128>(sB, b, 0, 128, tid);
  } else {
    tc::load_tile<128, 64, 128>(sA, a, 0, 128, tid);
    tc::load_tile<128, 128, 128>(sB, b, 0, 128, tid);
  }
  tc::cp_commit();
  tc::cp_wait<0>();
  tc::fence_async_smem();
  __syncthreads();

  uint32_t ar[8][4];
  if (MODE == 2 || MODE == 3) {
    // the register fragment of A: rows 16 w + l/4 (+8), columns
    // 16 kk + 2 (l%4) (+8)
    const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = warp * 16 + (lane >> 2) + 8 * (r & 1);
        const int col = 16 * kk + 2 * (lane & 3) + 8 * (r >> 1);
        ar[kk][r] = a32[(row * 128 + col) / 2];
      }
  }
  tc::reg_fence(d);
  tc::wg_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (MODE == 0 || MODE == 1) {
      const uint32_t off = (kk & 3) * 32;
      tc::wgmma_ss<0, 0>(
          d, tc::desc(sA + (kk >> 2) * (64 * 128) + off, 16, 1024),
          tc::desc(sB + (kk >> 2) * (N * 128) + off, 16, 1024), 1);
    } else if (MODE == 2 || MODE == 3) {
      tc::wgmma_rs<1>(d, ar[kk], tc::desc(sB + kk * 2048, 128 * 128, 1024),
                      1);
    } else {
      tc::wgmma_ss<1, 1>(
          d, tc::desc(sA + kk * 2048, 128 * 128, 1024),
          tc::desc(sB + 128 * 128 + kk * 2048, 128 * 128, 1024), 1);
    }
  }
  tc::wg_commit();
  tc::wg_wait<0>();
  tc::reg_fence(d);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc)
        c[(warp * 16 + (lane >> 2) + 8 * i) * N + 8 * j + 2 * (lane & 3)
          + cc] = d[4 * j + 2 * i + cc];
}

template <int MODE>
cudaError_t launch(const void* a, const void* b, void* c,
                   cudaStream_t stream) {
  constexpr int smem = 1024 + 64 * 128 * 2 + 128 * 128 * 2;
  auto kern = wgmma_probe_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<1, 128, smem, stream>>>(static_cast<const bf16*>(a),
                                 static_cast<const bf16*>(b),
                                 static_cast<float*>(c));
  return cudaGetLastError();
}

}  // namespace

// a, b bf16 and c fp32, contiguous, at the shapes of `mode` (above).
extern "C" int sg_wgmma_probe(const void* a, const void* b, void* c,
                              int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<0>(a, b, c, s);
    case 1: return launch<1>(a, b, c, s);
    case 2: return launch<2>(a, b, c, s);
    case 3: return launch<3>(a, b, c, s);
    case 4: return launch<4>(a, b, c, s);
  }
  return (int)cudaErrorInvalidValue;
}
