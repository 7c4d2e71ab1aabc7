// Block-sparse (BSR) matmul with a fused epilogue, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/block_sparse_matmul.py, bsr_matmul_kernel /
// bsr_matmul_pallas (the TPU kernel of every packed projection).
//
// y = act(x @ W_bsr + bias) * mult + residual for x (M, K).  The kernel
// body, its bound on the H100, what its design does about it and its
// batch-invariance contract are in bsr_split.cuh.  Grid: (grid_n x
// 32-column stripes, slot groups, row tiles), one cluster per output tile
// over its slot groups; launched once per call.
#include "bsr_split.cuh"

using namespace repro;

namespace {

template <typename T, int BM, bool kVec>
__global__ void __launch_bounds__(bsr_split::kThreads)
    bsr_split_kernel(const T* __restrict__ x, const T* __restrict__ blocks,
                     const int* __restrict__ indices,
                     const int* __restrict__ slots,
                     const float* __restrict__ bias,
                     const T* __restrict__ mult, const T* __restrict__ res,
                     T* __restrict__ out, int M, int K, int N, int bk, int bn,
                     int max_nnz, int stripes, int group_slots, int act) {
  const int m0 = blockIdx.z * BM;
  const int rows = min(BM, M - m0);
  bsr_split::split_tile<T, BM, kVec>(x, blocks, indices, slots, bias, mult,
                                     res, out, K, N, bk, bn, max_nnz, stripes,
                                     group_slots, act, m0, rows, rows);
}

struct Args {
  const void *x, *blocks, *indices, *slots, *bias, *mult, *res;
  void* out;
  int M, K, N, bk, bn, grid_n, max_nnz, groups, group_slots, act;
  cudaStream_t stream;
};

template <typename T, int BM, bool kVec>
cudaError_t launch(const Args& a) {
  using namespace bsr_split;
  const int stripes = (a.bn + kStripe - 1) / kStripe;
  const dim3 grid(a.grid_n * stripes, a.groups, (a.M + BM - 1) / BM);
  return launch_clustered(
      bsr_split_kernel<T, BM, kVec>, Smem<T, BM>::bytes, grid, a.groups,
      a.stream, static_cast<const T*>(a.x), static_cast<const T*>(a.blocks),
      static_cast<const int*>(a.indices), static_cast<const int*>(a.slots),
      static_cast<const float*>(a.bias), static_cast<const T*>(a.mult),
      static_cast<const T*>(a.res), static_cast<T*>(a.out), a.M, a.K, a.N,
      a.bk, a.bn, a.max_nnz, stripes, a.group_slots, a.act);
}

template <typename T>
cudaError_t dispatch(const Args& a, int bm) {
  using namespace bsr_split;
  if (!groups_ok(a.groups, a.group_slots, a.max_nnz))
    return cudaErrorInvalidValue;
  const bool vec = vec_ok<T>(a.x, a.blocks, a.K, a.bk, a.bn);
  return with_row_tile<T>(bm, [&](auto tile) {
    constexpr int BM = decltype(tile)::value;
    return vec ? launch<T, BM, true>(a) : launch<T, BM, false>(a);
  });
}

}  // namespace

// x, blocks, mult, res and out share one dtype; bias is fp32; a null
// bias/mult/res pointer leaves that epilogue step out.  bm is the row
// tile, groups x group_slots >= max_nnz the slot-group partition (both
// from the wrapper: kernels/block_sparse_matmul.py).
extern "C" int bsr_matmul_launch(int dtype, const void* x, const void* blocks,
                                 const void* indices, const void* slots,
                                 const void* bias, const void* mult,
                                 const void* res, void* out, int M, int K,
                                 int N, int bk, int bn, int grid_n,
                                 int max_nnz, int bm, int groups,
                                 int group_slots, int act, void* stream) {
  const Args a{x, blocks, indices, slots, bias, mult, res, out,
               M, K, N, bk, bn, grid_n, max_nnz, groups, group_slots, act,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == kFloat32)
    err = dispatch<float>(a, bm);
  else if (dtype == kBFloat16)
    err = dispatch<__nv_bfloat16>(a, bm);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
