// Per-plane (MoE expert) BSR matmul with a fused epilogue, for Hopper
// (sm_90a): every plane of the stack in ONE launch, with per-segment row
// counts from the MoE dispatch.
//
// Replaces: src/repro/kernels/block_sparse_matmul.py,
// bsr_planes_matmul_kernel / bsr_planes_matmul_pallas (the TPU kernel of
// the packed expert FFN: experts_up, experts_gate with its silu * up
// epilogue, experts_down).
//
// y[e] = act(x[e] @ W_bsr[e] + bias) * mult[e] + residual[e] for x
// (E, M, K) and a BSRPlanes stack: blocks (E, nnz_pad, bk, bn),
// indices/slots (E, grid_n, max_nnz), the bias (N,) shared by every
// plane, mult/res/out (E, M, N).  The rows of a plane are S segments of
// C = M / S rows (the (group, expert) segments of the MoE capacity
// buffer); counts (E, S) int32, when given, says how many leading rows of
// each segment are live.  Rows at or past their segment's count are taken
// as zero rows of x: no weight tile is loaded and nothing is multiplied
// for them, and they get epilogue(0).  counts == null: every row is live.
//
// Bound on the H100: bytes.  A decode call (32 experts x 8 capacity rows)
// streams every live expert tile once for at most 8 rows: 177 live tiles
// of experts_up are 11.6 MB in fp32, 3.5 us at 3.35 TB/s, and far below
// the fp32 FFMA rate.  The TPU design computes every row of the capacity
// buffer, yet only min(routed, cap) rows of a segment hold a token: at
// decode 32 of 256 rows, and about a third of the experts get no token at
// all; at a 47-token prefill (capacity 47) 376 of 1504 rows.
// What the design does about it:
//  * the row counts come from the dispatch on the device (no host sync):
//    a row tile with no live row reads no weight tile and exits, so an
//    expert no token was routed to costs no weight bytes;
//  * row tiles follow the segment length C, not M: 8 rows for the decode
//    buffer (C 8), 16 for prompt tails (C 15 or 47), and never straddle
//    two segments;
//  * the tile itself is bsr_split.cuh's body (a 4-stage 16-byte cp.async
//    ring, K split into warp quarters, bf16 on mma.sync, slot groups
//    reduced through a cluster's distributed shared memory); the plane,
//    segment and row tile share grid.z.  The slot-group cut depends on the
//    layout alone (planes, grid_n, max_nnz, bn): at granite's shapes
//    E x grid_n x stripes is 512 or 1024 CTAs per row tile, so one group
//    fills the card and no cluster reduction is needed (2 or 4 groups
//    were measured slower, and so was an 8-stage ring).
//
// Batch invariance (the argument of bsr_split.cuh): a row's sum depends
// on its plane's layout and its own x row only, never on M, C, the row
// tile or the counts of other rows; a live row sums the same with and
// without counts.
#include "bsr_split.cuh"

using namespace repro;

namespace {

// the planes kernel's K chunk, 64 in both dtypes: in fp32 the 2-D
// kernel's 32 ran slower on the 8-row decode buffers, whose CTAs walk a
// few steps each, bounded by per-step barriers (prefill ran a little
// faster at 32).  Fixed per dtype, so a row sums in the same order at
// every C.
constexpr int kPlaneKC = 64;

template <typename T, int BM, bool kVec>
__global__ void __launch_bounds__(bsr_split::kThreads)
    bsr_planes_kernel(const T* __restrict__ x, const T* __restrict__ blocks,
                      const int* __restrict__ indices,
                      const int* __restrict__ slots,
                      const float* __restrict__ bias,
                      const T* __restrict__ mult, const T* __restrict__ res,
                      T* __restrict__ out, const int* __restrict__ counts,
                      int M, int K, int N, int bk, int bn, int grid_n,
                      int max_nnz, int nnz_pad, int stripes, int group_slots,
                      int act, int segs, int seg_tiles) {
  // grid.z = (plane, segment, row tile of the segment)
  const int z = blockIdx.z;
  const int e = z / (segs * seg_tiles);
  const int s = (z / seg_tiles) % segs;
  const int r0 = (z % seg_tiles) * BM;
  const int C = M / segs;
  const int rows = min(BM, C - r0);
  const int live =
      counts == nullptr ? rows : max(0, min(rows, counts[e * segs + s] - r0));
  const size_t pe = e;
  const size_t mn = pe * M * N;
  const size_t map = pe * grid_n * max_nnz;
  bsr_split::split_tile<T, BM, kVec, kPlaneKC, true>(
      x + pe * M * K, blocks + pe * nnz_pad * bk * bn, indices + map,
      slots + map, bias, mult != nullptr ? mult + mn : nullptr,
      res != nullptr ? res + mn : nullptr, out + mn, K, N, bk, bn, max_nnz,
      stripes, group_slots, act, s * C + r0, rows, live);
}

struct Args {
  const void *x, *blocks, *indices, *slots, *bias, *mult, *res;
  void* out;
  const void* counts;
  int E, M, K, N, bk, bn, grid_n, max_nnz, nnz_pad, segs, groups,
      group_slots, act;
  cudaStream_t stream;
};

template <typename T, int BM, bool kVec>
cudaError_t launch(const Args& a) {
  using namespace bsr_split;
  const int stripes = (a.bn + kStripe - 1) / kStripe;
  const int seg_tiles = (a.M / a.segs + BM - 1) / BM;
  const long long z = static_cast<long long>(a.E) * a.segs * seg_tiles;
  if (z > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(a.grid_n * stripes, a.groups, static_cast<unsigned>(z));
  return launch_clustered(
      bsr_planes_kernel<T, BM, kVec>, Smem<T, BM, kPlaneKC>::bytes, grid,
      a.groups,
      a.stream, static_cast<const T*>(a.x), static_cast<const T*>(a.blocks),
      static_cast<const int*>(a.indices), static_cast<const int*>(a.slots),
      static_cast<const float*>(a.bias), static_cast<const T*>(a.mult),
      static_cast<const T*>(a.res), static_cast<T*>(a.out),
      static_cast<const int*>(a.counts), a.M, a.K, a.N, a.bk, a.bn, a.grid_n,
      a.max_nnz, a.nnz_pad, stripes, a.group_slots, a.act, a.segs, seg_tiles);
}

template <typename T>
cudaError_t dispatch(const Args& a, int bm) {
  using namespace bsr_split;
  if (!groups_ok(a.groups, a.group_slots, a.max_nnz) || a.segs < 1 ||
      a.M % a.segs != 0)
    return cudaErrorInvalidValue;
  const bool vec = vec_ok<T>(a.x, a.blocks, a.K, a.bk, a.bn);
  return with_row_tile<T>(bm, [&](auto tile) {
    constexpr int BM = decltype(tile)::value;
    return vec ? launch<T, BM, true>(a) : launch<T, BM, false>(a);
  });
}

}  // namespace

// x, blocks, mult, res and out share one dtype; bias is fp32 and shared
// by the planes; a null bias/mult/res pointer leaves that epilogue step
// out.  counts (E, segs) int32 or null; segs divides M.  bm is the row
// tile, groups x group_slots >= max_nnz the slot-group partition (both
// from the wrapper: kernels/block_sparse_matmul.py).
extern "C" int bsr_planes_matmul_launch(
    int dtype, const void* x, const void* blocks, const void* indices,
    const void* slots, const void* bias, const void* mult, const void* res,
    void* out, const void* counts, int E, int M, int K, int N, int bk, int bn,
    int grid_n, int max_nnz, int nnz_pad, int segs, int bm, int groups,
    int group_slots, int act, void* stream) {
  const Args a{x, blocks, indices, slots, bias, mult, res, out, counts,
               E, M, K, N, bk, bn, grid_n, max_nnz, nnz_pad, segs, groups,
               group_slots, act, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == kFloat32)
    err = dispatch<float>(a, bm);
  else if (dtype == kBFloat16)
    err = dispatch<__nv_bfloat16>(a, bm);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// shared memory of one CTA (bytes: dynamic + static), for reports
extern "C" long long bsr_planes_smem_bytes(int dtype, int bm) {
  using namespace bsr_split;
  long long dyn = -1;
  if (dtype == kFloat32) {
    if (bm == 4) dyn = Smem<float, 4, kPlaneKC>::bytes;
    if (bm == 8) dyn = Smem<float, 8, kPlaneKC>::bytes;
    if (bm == 16) dyn = Smem<float, 16, kPlaneKC>::bytes;
    if (bm == 64) dyn = Smem<float, 64, kPlaneKC>::bytes;
  } else if (dtype == kBFloat16) {
    if (bm == 16) dyn = Smem<__nv_bfloat16, 16, kPlaneKC>::bytes;
    if (bm == 64) dyn = Smem<__nv_bfloat16, 64, kPlaneKC>::bytes;
  }
  return dyn < 0 ? -1 : dyn + static_cast<long long>(kStaticSmem);
}
