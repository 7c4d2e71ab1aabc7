// Block-sparse (BSR) matmul with a fused epilogue, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/block_sparse_matmul.py, bsr_matmul_kernel /
// bsr_matmul_pallas (the TPU kernel of every packed projection).
//
// y = act(x @ W_bsr + bias) * mult + residual for x (M, K); the kernel
// body, its bound on the H100 and what its design does about it are in
// bsr_body.cuh.  Grid: (grid_n x 32-column stripes, row tiles).
#include "bsr_body.cuh"

using namespace repro;

namespace {

template <typename T, int BM, int KC>
__global__ void __launch_bounds__(bsr::kThreads)
    bsr_matmul_kernel(const T* __restrict__ x, const T* __restrict__ blocks,
                      const int* __restrict__ indices,
                      const int* __restrict__ slots,
                      const float* __restrict__ bias,
                      const T* __restrict__ mult, const T* __restrict__ res,
                      T* __restrict__ out, int M, int K, int N, int bk, int bn,
                      int max_nnz, int stripes, int act) {
  bsr::tile<T, BM, KC>(x, blocks, indices, slots, bias, mult, res, out, M, K,
                       N, bk, bn, max_nnz, stripes, act);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* blocks, const void* indices,
                     const void* slots, const void* bias, const void* mult,
                     const void* res, void* out, int M, int K, int N, int bk,
                     int bn, int grid_n, int max_nnz, int act,
                     cudaStream_t stream) {
  return bsr::with_tile(M, bk, [&](auto bm, auto kc) {
    constexpr int BM = decltype(bm)::value, KC = decltype(kc)::value;
    const int stripes = (bn + bsr::kStripe - 1) / bsr::kStripe;
    const dim3 grid(grid_n * stripes, (M + BM - 1) / BM);
    if (grid.y > 65535 || max_nnz > bsr::kMaxSlots)
      return cudaErrorInvalidConfiguration;
    bsr_matmul_kernel<T, BM, KC><<<grid, bsr::kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(blocks),
        static_cast<const int*>(indices), static_cast<const int*>(slots),
        static_cast<const float*>(bias), static_cast<const T*>(mult),
        static_cast<const T*>(res), static_cast<T*>(out), M, K, N, bk, bn,
        max_nnz, stripes, act);
    return cudaGetLastError();
  });
}

}  // namespace

// x, blocks, mult, res and out share one dtype; bias is fp32; a null
// bias/mult/res pointer leaves that epilogue step out.  max_nnz must not
// exceed 1024 (the per-column slot map is held in shared memory).
extern "C" int bsr_matmul_launch(int dtype, const void* x, const void* blocks,
                                 const void* indices, const void* slots,
                                 const void* bias, const void* mult,
                                 const void* res, void* out, int M, int K,
                                 int N, int bk, int bn, int grid_n,
                                 int max_nnz, int act, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32)
    err = dispatch<float>(x, blocks, indices, slots, bias, mult, res, out, M,
                          K, N, bk, bn, grid_n, max_nnz, act, st);
  else if (dtype == kBFloat16)
    err = dispatch<__nv_bfloat16>(x, blocks, indices, slots, bias, mult, res,
                                  out, M, K, N, bk, bn, grid_n, max_nnz, act,
                                  st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
