// Per-tile L2 norms of a weight, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/structure_norms.py, structure_norms_kernel /
// structure_norms_pallas.
//
// norms[i, j] = sqrt(sum over the (bk, bn) tile (i, j) of w^2) in fp32
// for w (K, N) in fp32 or bf16; tail tiles read 0 outside (K, N), as the
// reference zero-pads.  Output (grid_k, grid_n) fp32.
//
// Bound on the H100: bytes.  Each weight element is read once and takes
// two operations, so the kernel can at best stream the weight at the
// card's memory rate.  What the design does: one block of 256 threads per
// tile (the TPU grid's (i, j) steps run in parallel); neighbouring
// threads read neighbouring columns of a tile row, so a warp's loads are
// coalesced for bn >= 32; each thread sums its squares in fp32 in a fixed
// order (element tid, tid + 256, ...), then a fixed-shape shared-memory
// tree reduces the 256 partial sums, so the result does not depend on
// the launch.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    structure_norms_kernel(const T* __restrict__ w, float* __restrict__ out,
                           int K, int N, int bk, int bn, int grid_n) {
  __shared__ float part[kThreads];
  const int tid = threadIdx.x;
  const int i = blockIdx.x / grid_n, j = blockIdx.x % grid_n;
  const int r0 = i * bk, c0 = j * bn;
  const int elems = bk * bn;
  float sq = 0.f;
  for (int e = tid; e < elems; e += kThreads) {
    const int r = r0 + e / bn, c = c0 + e % bn;
    if (r < K && c < N) {
      const float v = to_float(w[static_cast<size_t>(r) * N + c]);
      sq = fmaf(v, v, sq);
    }
  }
  part[tid] = sq;
  __syncthreads();
#pragma unroll
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (tid < h) part[tid] += part[tid + h];
    __syncthreads();
  }
  if (tid == 0) out[blockIdx.x] = sqrtf(part[0]);
}

template <typename T>
cudaError_t launch(const void* w, void* out, int K, int N, int bk, int bn,
                   cudaStream_t stream) {
  const int grid_k = (K + bk - 1) / bk, grid_n = (N + bn - 1) / bn;
  const long long tiles = static_cast<long long>(grid_k) * grid_n;
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;
  structure_norms_kernel<T><<<static_cast<unsigned>(tiles), kThreads, 0,
                              stream>>>(static_cast<const T*>(w),
                                        static_cast<float*>(out), K, N, bk, bn,
                                        grid_n);
  return cudaGetLastError();
}

}  // namespace

// w (K, N) contiguous in dtype; out (ceil(K/bk), ceil(N/bn)) fp32; bk and
// bn already clamped to K and N.
extern "C" int structure_norms_launch(int dtype, const void* w, void* out,
                                      int K, int N, int bk, int bn,
                                      void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32)
    err = launch<float>(w, out, K, N, bk, bn, st);
  else if (dtype == kBFloat16)
    err = launch<__nv_bfloat16>(w, out, K, N, bk, bn, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
