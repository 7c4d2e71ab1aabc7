// Kernel body of the BSR planes matmul, for Hopper (sm_90a):
// bsr_planes_matmul.cu (a stack of per-plane weights, one launch) runs
// `tile` below on each plane.  The 2-D kernel has its own body
// (bsr_split.cuh) and shares only the activation codes and `activate`.
//
// `tile` computes one block of y = act(x @ W_bsr + bias) * mult + residual
// for x (M, K) and a BSR weight stored as the packed flat store blocks
// (nnz, bk, bn) plus the per-column map indices/slots (grid_n, max_nnz)
// (-1 marks a padding slot).  blockIdx.x is a (BSR block column, 32-column
// stripe) pair, blockIdx.y a row tile.  It accumulates in fp32 (fp32 FMA
// for fp32 operands, never TF32), applies the epilogue in fp32 and writes
// x's dtype.
//
// Bound on the H100: bytes.  At the main paths' shapes (decode M = 4 live
// slots or an 8-row expert capacity buffer, prefill M = one prompt tail)
// every live weight tile is read once per call and used for only M rows,
// far below the ~295 operations per byte where the tensor cores would
// bound it, so the kernel must keep many bytes in flight.  What the
// design does:
//  * it reads only live tiles: padding slots are skipped before any load,
//    so pruned structures cost neither bytes nor operations;
//  * one block per (row tile, 32-column stripe of a BSR block column):
//    a 128-wide block column is served by 4 blocks, so a decode-shaped
//    call puts 4 x grid_n blocks on the SMs instead of grid_n;
//  * each step stages a (KC x 32) weight stripe and the (BM x KC) x panel
//    through registers into shared memory, and the next step's loads are
//    issued before this step's FMAs (software double buffering), so
//    load latency overlaps the math;
//  * the (M, N) intermediate stays in registers through the epilogue
//    (bias, SwiGLU gate and residual never round-trip to device memory);
//  * the row tile follows M: 16 rows for decode, 64 for prefill.
// Not yet done (later PRs): TMA/cp.async, wgmma for large M, split-K.
//
// Each output element is summed by one thread, in slot order, then in K
// order inside a tile, whatever the tile sizes: a row's result does not
// depend on how many other rows share the call.  A column with no live
// slot (a dead plane) still writes epilogue(0).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace repro {
namespace bsr {

constexpr int kThreads = 256;   // 8 warps stacked over the rows
constexpr int kStripe = 32;     // output columns per block: one per lane
constexpr int kMaxSlots = 1024; // per-column slot map held in shared memory

enum Act : int { kNone = 0, kSilu = 1, kGelu = 2, kRelu = 3, kSigmoid = 4 };

__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case kSilu:
      return y / (1.f + expf(-y));
    case kGelu: {  // jax.nn.gelu's default tanh approximation
      const float c = 0.7978845608028654f;
      return 0.5f * y * (1.f + tanhf(c * (y + 0.044715f * y * y * y)));
    }
    case kRelu:
      return fmaxf(y, 0.f);
    case kSigmoid:
      return 1.f / (1.f + expf(-y));
    default:
      return y;
  }
}

// One block of the product; the pointers are those of one plane.
template <typename T, int BM, int KC>
__device__ __forceinline__ void tile(
    const T* __restrict__ x, const T* __restrict__ blocks,
    const int* __restrict__ indices, const int* __restrict__ slots,
    const float* __restrict__ bias, const T* __restrict__ mult,
    const T* __restrict__ res, T* __restrict__ out, int M, int K, int N,
    int bk, int bn, int max_nnz, int stripes, int act) {
  constexpr int RM = BM / 8;                   // rows per thread
  constexpr int XL = BM * KC / kThreads;       // x values staged per thread
  constexpr int WL = KC * kStripe / kThreads;  // weights staged per thread
  static_assert(XL * kThreads == BM * KC && WL * kThreads == KC * kStripe,
                "tile sizes must divide the block");
  __shared__ float xs[BM][KC + 1];
  __shared__ float ws[KC][kStripe];
  __shared__ int s_kb[kMaxSlots];
  __shared__ int s_slot[kMaxSlots];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j = blockIdx.x / stripes;                  // BSR block column
  const int c0 = (blockIdx.x % stripes) * kStripe;     // stripe inside it
  const int m0 = blockIdx.y * BM;

  for (int s = tid; s < max_nnz; s += kThreads) {
    s_kb[s] = indices[j * max_nnz + s];
    s_slot[s] = slots[j * max_nnz + s];
  }
  __syncthreads();

  float acc[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) acc[i] = 0.f;
  float xr[XL], wr[WL];

  // stage step (slot s, K offset kc) into registers; masked edges read 0
  auto load = [&](int s, int kc) {
    const int kbase = s_kb[s] * bk;
    const T* w = blocks + static_cast<size_t>(s_slot[s]) * bk * bn;
#pragma unroll
    for (int u = 0; u < XL; ++u) {
      const int e = tid + u * kThreads;
      const int r = e / KC, kk = kc + e % KC;
      const int row = m0 + r, col = kbase + kk;
      xr[u] = (row < M && kk < bk && col < K)
                  ? to_float(x[static_cast<size_t>(row) * K + col])
                  : 0.f;
    }
#pragma unroll
    for (int u = 0; u < WL; ++u) {
      const int e = tid + u * kThreads;
      const int kk = kc + e / kStripe, cc = c0 + e % kStripe;
      wr[u] = (kk < bk && cc < bn)
                  ? to_float(w[static_cast<size_t>(kk) * bn + cc])
                  : 0.f;
    }
  };
  // next live slot at or after s (padding slots are skipped, never read)
  auto next_live = [&](int s) {
    while (s < max_nnz && s_kb[s] < 0) ++s;
    return s;
  };

  int s = next_live(0), kc = 0;
  if (s < max_nnz) load(s, kc);
  while (s < max_nnz) {
#pragma unroll
    for (int u = 0; u < XL; ++u) {
      const int e = tid + u * kThreads;
      xs[e / KC][e % KC] = xr[u];
    }
#pragma unroll
    for (int u = 0; u < WL; ++u) {
      const int e = tid + u * kThreads;
      ws[e / kStripe][e % kStripe] = wr[u];
    }
    __syncthreads();
    int s2 = s, kc2 = kc + KC;
    if (kc2 >= bk) {
      kc2 = 0;
      s2 = next_live(s + 1);
    }
    if (s2 < max_nnz) load(s2, kc2);   // in flight during the FMAs below
#pragma unroll 16
    for (int kk = 0; kk < KC; ++kk) {
      const float b = ws[kk][lane];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        acc[i] = fmaf(xs[warp * RM + i][kk], b, acc[i]);
    }
    __syncthreads();
    s = s2;
    kc = kc2;
  }

  // fused epilogue on the fp32 accumulator: bias -> act -> mult -> residual
  const int lc = c0 + lane;
  const int col = j * bn + lc;
  if (lc >= bn || col >= N) return;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + warp * RM + i;
    if (row >= M) continue;
    const size_t o = static_cast<size_t>(row) * N + col;
    float y = acc[i];
    if (bias != nullptr) y += bias[col];
    y = activate(y, act);
    if (mult != nullptr) y *= to_float(mult[o]);
    if (res != nullptr) y += to_float(res[o]);
    out[o] = from_float<T>(y);
  }
}

// Row tile by M (16 for decode-shaped calls, 64 for prefill), K step by
// the tile depth (no staging of rows past bk for small tiles): calls
// launch(BM, KC) with both as std::integral_constant.
template <typename Launch>
cudaError_t with_tile(int M, int bk, Launch&& launch) {
  using std::integral_constant;
  if (M <= 16) {
    if (bk <= 32)
      return launch(integral_constant<int, 16>(), integral_constant<int, 32>());
    if (bk <= 64)
      return launch(integral_constant<int, 16>(), integral_constant<int, 64>());
    return launch(integral_constant<int, 16>(), integral_constant<int, 128>());
  }
  if (bk <= 32)
    return launch(integral_constant<int, 64>(), integral_constant<int, 32>());
  return launch(integral_constant<int, 64>(), integral_constant<int, 64>());
}

}  // namespace bsr
}  // namespace repro
