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

struct Args {
  const void *x, *blocks, *indices, *slots, *bias, *mult, *res;
  void* out;
  int M, K, N, bk, bn, grid_n, max_nnz, groups, group_slots, act;
  cudaStream_t stream;
};

template <typename T, int BM, bool kVec>
cudaError_t launch(const Args& a) {
  using namespace bsr_split;
  auto kernel = bsr_split_kernel<T, BM, kVec>;
  const size_t smem = Smem<T, BM>::bytes;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int stripes = (a.bn + kStripe - 1) / kStripe;
  const int row_tiles = (a.M + BM - 1) / BM;
  if (row_tiles > 65535) return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.grid_n * stripes, a.groups, row_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;  // a cluster = one output tile's groups
  attr[0].val.clusterDim.y = a.groups;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.x),
      static_cast<const T*>(a.blocks), static_cast<const int*>(a.indices),
      static_cast<const int*>(a.slots), static_cast<const float*>(a.bias),
      static_cast<const T*>(a.mult), static_cast<const T*>(a.res),
      static_cast<T*>(a.out), a.M, a.K, a.N, a.bk, a.bn, a.max_nnz, stripes,
      a.group_slots, a.act);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int BM>
cudaError_t with_vec(const Args& a) {
  const bool vec = aligned16(a.x) && aligned16(a.blocks) &&
                   (a.K * sizeof(T)) % 16 == 0 &&
                   (a.bk * sizeof(T)) % 16 == 0 &&
                   (a.bn * sizeof(T)) % 16 == 0;
  return vec ? launch<T, BM, true>(a) : launch<T, BM, false>(a);
}

// row tile bm as chosen by the wrapper: fp32 4/8/16/64, bf16 16/64
template <typename T>
cudaError_t dispatch(const Args& a, int bm) {
  using namespace bsr_split;
  if (a.groups < 1 || a.groups > kMaxGroups || a.group_slots < 1 ||
      a.group_slots > kMaxSlots ||
      static_cast<long long>(a.groups) * a.group_slots < a.max_nnz)
    return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value) {
    if (bm == 4) return with_vec<T, 4>(a);
    if (bm == 8) return with_vec<T, 8>(a);
  }
  if (bm == 16) return with_vec<T, 16>(a);
  if (bm == 64) return with_vec<T, 64>(a);
  return cudaErrorInvalidValue;
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
