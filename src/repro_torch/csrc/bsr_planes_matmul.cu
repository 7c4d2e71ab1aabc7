// Per-plane (MoE expert) BSR matmul with a fused epilogue, for Hopper
// (sm_90a): every plane of the stack in ONE launch.
//
// Replaces: src/repro/kernels/block_sparse_matmul.py,
// bsr_planes_matmul_kernel / bsr_planes_matmul_pallas (the TPU kernel of
// the packed expert FFN: experts_up, experts_gate with its silu * up
// epilogue, experts_down).
//
// y[e] = act(x[e] @ W_bsr[e] + bias) * mult[e] + residual[e] for x
// (E, M, K) and a BSRPlanes stack: blocks (E, nnz_pad, bk, bn),
// indices/slots (E, grid_n, max_nnz), the bias (N,) shared by every
// plane, mult/res/out (E, M, N).  The TPU grid's plane axis becomes
// blockIdx.z; inside a plane each block runs the BSR body of
// bsr_body.cuh on that plane's offsets; the bound (bytes: every live
// expert tile is read once for a few capacity rows) and the design are
// described there.  A dead plane (every slot
// -1) loads nothing and writes epilogue(0), as the TPU kernel applies its
// epilogue at the last slot step whether or not the plane is live.  Like
// the reference, it computes every plane of the capacity buffer, routed
// tokens or not (skipping empty experts is later work).
#include "bsr_body.cuh"

using namespace repro;

namespace {

template <typename T, int BM, int KC>
__global__ void __launch_bounds__(bsr::kThreads)
    bsr_planes_matmul_kernel(const T* __restrict__ x,
                             const T* __restrict__ blocks,
                             const int* __restrict__ indices,
                             const int* __restrict__ slots,
                             const float* __restrict__ bias,
                             const T* __restrict__ mult,
                             const T* __restrict__ res, T* __restrict__ out,
                             int M, int K, int N, int bk, int bn, int grid_n,
                             int max_nnz, int nnz_pad, int stripes, int act) {
  const size_t e = blockIdx.z;
  const size_t mn = e * M * N;                     // this plane's (M, N)
  const size_t map = e * grid_n * max_nnz;         // and its slot map
  bsr::tile<T, BM, KC>(x + e * M * K, blocks + e * nnz_pad * bk * bn,
                       indices + map, slots + map, bias,
                       mult != nullptr ? mult + mn : nullptr,
                       res != nullptr ? res + mn : nullptr, out + mn, M, K, N,
                       bk, bn, max_nnz, stripes, act);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* blocks, const void* indices,
                     const void* slots, const void* bias, const void* mult,
                     const void* res, void* out, int E, int M, int K, int N,
                     int bk, int bn, int grid_n, int max_nnz, int nnz_pad,
                     int act, cudaStream_t stream) {
  return bsr::with_tile(M, bk, [&](auto bm, auto kc) {
    constexpr int BM = decltype(bm)::value, KC = decltype(kc)::value;
    const int stripes = (bn + bsr::kStripe - 1) / bsr::kStripe;
    const dim3 grid(grid_n * stripes, (M + BM - 1) / BM, E);
    if (grid.y > 65535 || grid.z > 65535 || max_nnz > bsr::kMaxSlots)
      return cudaErrorInvalidConfiguration;
    bsr_planes_matmul_kernel<T, BM, KC><<<grid, bsr::kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(blocks),
        static_cast<const int*>(indices), static_cast<const int*>(slots),
        static_cast<const float*>(bias), static_cast<const T*>(mult),
        static_cast<const T*>(res), static_cast<T*>(out), M, K, N, bk, bn,
        grid_n, max_nnz, nnz_pad, stripes, act);
    return cudaGetLastError();
  });
}

}  // namespace

// x, blocks, mult, res and out share one dtype; bias is fp32 and shared
// by the planes; a null bias/mult/res pointer leaves that epilogue step
// out.  E <= 65535 and max_nnz <= 1024.
extern "C" int bsr_planes_matmul_launch(
    int dtype, const void* x, const void* blocks, const void* indices,
    const void* slots, const void* bias, const void* mult, const void* res,
    void* out, int E, int M, int K, int N, int bk, int bn, int grid_n,
    int max_nnz, int nnz_pad, int act, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32)
    err = dispatch<float>(x, blocks, indices, slots, bias, mult, res, out, E,
                          M, K, N, bk, bn, grid_n, max_nnz, nnz_pad, act, st);
  else if (dtype == kBFloat16)
    err = dispatch<__nv_bfloat16>(x, blocks, indices, slots, bias, mult, res,
                                  out, E, M, K, N, bk, bn, grid_n, max_nnz,
                                  nnz_pad, act, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
