// Kernel body of the block-sparse (BSR) matmuls for Hopper (sm_90a):
// y = act(x @ W_bsr + bias) * mult + residual for x (M, K) and a BSR
// weight stored as the flat live-tile store blocks (nnz, bk, bn) plus the
// per-column map indices/slots (grid_n, max_nnz) (-1 marks a padding
// slot).  `split_tile` below computes one CTA's output tile; two kernels
// call it: bsr_matmul.cu (one weight) and bsr_planes_matmul.cu (a stack
// of expert planes, the plane on a grid axis, with per-segment row counts).
//
// Replaces: src/repro/kernels/block_sparse_matmul.py, bsr_matmul_kernel /
// bsr_matmul_pallas and bsr_planes_matmul_kernel /
// bsr_planes_matmul_pallas.
//
// Bound on the H100: bytes.  At the main paths' shapes (decode M = 4
// slots or an 8-row expert capacity buffer, prefill M = one prompt tail)
// every live weight tile is read once per call and used for a few rows,
// far below the ~295 operations per byte at which the bf16 tensor cores
// would bound it (fp32: ~20 per byte).  A decode call moves 0.5-12 MB, a
// few microseconds of HBM time at most, so the kernel must put every SM
// to work at once and keep bytes in flight.  What the design does:
//  * the grid is (BSR block column x 32-column stripe, slot group, row
//    tile [x plane]).  A column's slots are cut into `groups` consecutive
//    groups of `group_slots` (the wrapper picks them from the layout
//    alone: grid_n, max_nnz, the stripe count and the number of planes,
//    so that a decode call puts a CTA on every SM); each CTA walks only
//    its group's live slots, skipping padding before any load;
//  * the groups of one output tile form a thread-block cluster (at most
//    8): each CTA leaves its partial sum in shared memory, and after a
//    cluster barrier the CTAs add the partials through distributed shared
//    memory in group order and apply the epilogue, in the same launch;
//  * every (K chunk x 32) weight stripe and (BM x K chunk) x panel is
//    copied with 16-byte cp.async into a ring of 4 shared-memory stages,
//    one barrier per stage, so three stages are in flight during the math
//    (layouts that are not 16-byte aligned copy through registers into the
//    same ring);
//  * 4 warps split each K chunk into quarters, so a decode CTA (BM 4 or 8
//    rows) keeps all its threads busy; their partials are added through
//    shared memory in warp order.  The K chunk is fixed per kernel and
//    dtype (fp32: 32 in the 2-D kernel, 64 in the planes kernel; bf16:
//    64).  Row tiles follow the rows (the wrappers' bsr_row_tile /
//    bsr_planes_row_tile): fp32 4, 8, 16 up to 48 rows, then 64; bf16 16,
//    64;
//  * rows of the tile at or past `live` are taken as zero rows of x: they
//    are zero-filled, never loaded, and get epilogue(0).  A tile with no
//    live row loads no weight tile at all: it writes epilogue(0) and exits
//    (the planes kernel's row counts make most capacity rows such rows);
//  * bf16 operands go through the tensor cores: mma.sync m16n8k16, bf16
//    in, fp32 accumulate (one k16 step per warp and chunk).  fp32 operands
//    stay on FFMA, never TF32;
//  * the (M, N) intermediate stays in registers and shared memory through
//    the fused epilogue (bias, SwiGLU gate, residual), in fp32.
//
// Batch invariance: a row's result is the same bit for bit whatever else
// is in the call.  Output element (r, c) is
//     sum over groups g in order of
//       ((q0 + q1) + q2) + q3, q_w = the serial FMA chain, from 0, over
//       the group's live slots in slot order and, inside each, over the
//       rows of every K chunk that fall in warp w's quarter, in K order
// (bf16: the chain is one tensor-core step per k16 quarter).  The groups
// and the quarters are fixed by the layout (grid_n, max_nnz, bk, bn, the
// plane count), the kernel's K chunk and the slot index, never by M, BM,
// the row tile or the row counts; rows never mix.  A row below its count therefore sums the
// same with and without counts.  A column with no live slot, and a row
// that is not live, writes epilogue(0).
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace repro {
namespace bsr_split {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;    // 4 warps, one K quarter each
constexpr int kWarps = kThreads / 32;
constexpr int kStripe = 32;      // output columns per CTA
constexpr int kStages = 4;       // cp.async ring depth
constexpr int kMaxGroups = 8;    // portable thread-block cluster size
constexpr int kMaxSlots = 1024;  // slots of one group held in shared memory
// split_tile's static shared memory: the slot list and its count
constexpr size_t kStaticSmem = (2 * kMaxSlots + 4) * sizeof(int);

// activation codes shared with the Python wrappers (ACT_CODES)
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

// fused epilogue on the fp32 sum: bias -> act -> mult -> residual
template <typename T>
__device__ __forceinline__ void finish(float y, int col, size_t o,
                                       const float* __restrict__ bias,
                                       const T* __restrict__ mult,
                                       const T* __restrict__ res,
                                       T* __restrict__ out, int act) {
  if (bias != nullptr) y += bias[col];
  y = activate(y, act);
  if (mult != nullptr) y *= to_float(mult[o]);
  if (res != nullptr) y += to_float(res[o]);
  out[o] = from_float<T>(y);
}

// K chunk of one stage (KC) and shared-memory row strides (elements).
// fp32: a 32-deep chunk by default, KC / 4 rows per warp.  bf16: a 64-deep
// chunk, one k16 mma step per warp; rows padded by 16 bytes so the
// fragment loads miss no bank.
template <typename T>
constexpr int kDefaultKC = std::is_same<T, float>::value ? 32 : 64;

template <typename T, int KC_>
struct Layout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static_assert(kF32 ? KC_ % 32 == 0 : KC_ == 64, "K chunk per dtype");
  static constexpr int KC = KC_;
  static constexpr int XLD = kF32 ? KC : KC + 8;
  static constexpr int WLD = kF32 ? kStripe : kStripe + 8;
};

template <typename T, int BM, int KC = kDefaultKC<T>>
struct Smem {
  using L = Layout<T, KC>;
  static constexpr size_t w_elems = L::KC * L::WLD;
  static constexpr size_t x_elems = BM * L::XLD;
  static constexpr size_t stage = (w_elems + x_elems) * sizeof(T);
  static constexpr size_t ring = kStages * stage;
  // after the ring drains: per-warp partials, then the CTA's partial
  static constexpr size_t red = kWarps * BM * kStripe * sizeof(float);
  static constexpr size_t part = ring > red ? ring : red;
  static constexpr size_t bytes = part + BM * kStripe * sizeof(float);
};

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One CTA: output rows [m0, m0 + rows) of x (., K) / out (., N) (the
// pointers of one weight or plane), stripe c0.. of block column j
// (blockIdx.x), slot group blockIdx.y of gridDim.y (= the rank in the
// cluster).  Rows r < live are read from x; rows live <= r < rows are
// zero rows.  Every rank of a cluster gets the same (m0, rows, live).
// kVec: x, blocks, K, bk and bn are 16-byte aligned, so every stage is
// copied with cp.async.  kDeadTiles: a tile may have no live row (the
// planes kernel's row counts); the 2-D kernel, whose every tile is live,
// compiles the check out (with it, the fp32 BM 16 instance spilled
// registers and ran slower).
template <typename T, int BM, bool kVec, int KC_ = kDefaultKC<T>,
          bool kDeadTiles = false>
__device__ __forceinline__ void split_tile(
    const T* __restrict__ x, const T* __restrict__ blocks,
    const int* __restrict__ indices, const int* __restrict__ slots,
    const float* __restrict__ bias, const T* __restrict__ mult,
    const T* __restrict__ res, T* __restrict__ out, int K, int N, int bk,
    int bn, int max_nnz, int stripes, int group_slots, int act, int m0,
    int rows, int live) {
  using L = Layout<T, KC_>;
  using S = Smem<T, BM, KC_>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int KC = L::KC, XLD = L::XLD, WLD = L::WLD;
  static_assert(kF32 || BM % 16 == 0, "bf16 row tiles are mma m16 tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_kb[kMaxSlots];
  __shared__ int s_slot[kMaxSlots];
  __shared__ int s_live;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.x / stripes;               // BSR block column
  const int c0 = (blockIdx.x % stripes) * kStripe;  // stripe inside it
  const int grp = blockIdx.y, n_grp = gridDim.y;    // = rank in the cluster
  constexpr int kTile = BM * kStripe;

  // this rank's epilogue operands go to L2 while the slots and weights
  // load, so the epilogue waits on no device-memory round trip
  for (int e = grp + n_grp * tid; e < kTile; e += n_grp * kThreads) {
    const int r = e / kStripe, lc = c0 + e % kStripe;
    const int col = j * bn + lc;
    if (r >= rows || lc >= bn || col >= N) continue;
    const size_t o = static_cast<size_t>(m0 + r) * N + col;
    if (mult != nullptr) prefetch_l2(mult + o);
    if (res != nullptr) prefetch_l2(res + o);
  }

  // this group's live slots in slot order, compacted by warp 0
  if (warp == 0) {
    const int s_end = min(max_nnz, (grp + 1) * group_slots);
    int n = 0;
    for (int s0 = grp * group_slots; s0 < s_end; s0 += 32) {
      const int s = s0 + lane;
      const size_t o = static_cast<size_t>(j) * max_nnz + s;
      const int kb = s < s_end ? indices[o] : -1;
      const unsigned lv = __ballot_sync(0xffffffffu, kb >= 0);
      if (kb >= 0) {
        const int at = n + __popc(lv & ((1u << lane) - 1u));
        s_kb[at] = kb;
        s_slot[at] = slots[o];
      }
      n += __popc(lv);
    }
    if (lane == 0) s_live = n;
  }
  __syncthreads();

  // no live row: epilogue(0), and no weight tile is read.  (The slot map
  // above is read anyway: its load overlaps the caller's row-count load.)
  if (kDeadTiles && live <= 0) {
    for (int e = grp + n_grp * tid; e < kTile; e += n_grp * kThreads) {
      const int r = e / kStripe, lc = c0 + e % kStripe;
      const int col = j * bn + lc;
      if (r >= rows || lc >= bn || col >= N) continue;
      finish(0.f, col, static_cast<size_t>(m0 + r) * N + col, bias, mult, res,
             out, act);
    }
    return;
  }
  const int chunks = (bk + KC - 1) / KC;
  const int steps = s_live * chunks;

  auto w_buf = [&](int st) { return reinterpret_cast<T*>(smem + st * S::stage); };
  auto x_buf = [&](int st) { return w_buf(st) + S::w_elems; };

  // stage step t (live slot t / chunks, K chunk t % chunks); masked
  // edges and rows that are not live are written as zeros and never read
  auto issue = [&](int t) {
    const int li = t / chunks, kc = (t % chunks) * KC;
    const int kb = s_kb[li];
    const T* w = blocks + static_cast<size_t>(s_slot[li]) * bk * bn;
    T* ws = w_buf(t % kStages);
    T* xs = x_buf(t % kStages);
    if constexpr (kVec) {
      constexpr int E = 16 / sizeof(T);
      constexpr int WC = kStripe / E, XC = KC / E;
      for (int e = tid; e < KC * WC; e += kThreads) {
        const int r = e / WC, cc = (e % WC) * E;
        const int kk = kc + r, col = c0 + cc;
        const bool ok = kk < bk && col < bn;
        cp_async16(ws + r * WLD + cc,
                   ok ? w + static_cast<size_t>(kk) * bn + col : w, ok ? 16 : 0);
      }
      for (int e = tid; e < BM * XC; e += kThreads) {
        const int r = e / XC, cc = (e % XC) * E;
        const int kk = kc + cc, col = kb * bk + kk;
        const bool ok = r < live && kk < bk && col < K;
        cp_async16(xs + r * XLD + cc,
                   ok ? x + static_cast<size_t>(m0 + r) * K + col : x,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < KC * kStripe; e += kThreads) {
        const int r = e / kStripe, cc = e % kStripe;
        const int kk = kc + r, col = c0 + cc;
        ws[r * WLD + cc] = (kk < bk && col < bn)
                               ? w[static_cast<size_t>(kk) * bn + col]
                               : from_float<T>(0.f);
      }
      for (int e = tid; e < BM * KC; e += kThreads) {
        const int r = e / KC, cc = e % KC;
        const int kk = kc + cc, col = kb * bk + kk;
        xs[r * XLD + cc] = (r < live && kk < bk && col < K)
                               ? x[static_cast<size_t>(m0 + r) * K + col]
                               : from_float<T>(0.f);
      }
    }
  };

  // fp32: acc[r] is (row r, column lane).  bf16: acc[(mt * 4 + nt) * 4 +
  // i] is the mma m16n8 accumulator fragment of row tile mt, n-tile nt.
  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;

  auto compute = [&](int st) {
    if constexpr (kF32) {
      constexpr int KW = KC / kWarps;  // rows of the chunk per warp
      const float* ws = w_buf(st) + warp * KW * WLD + lane;
      const float* xs = x_buf(st) + warp * KW;
      float wv[KW];
#pragma unroll
      for (int i = 0; i < KW; ++i) wv[i] = ws[i * WLD];
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        float s = acc[r];
#pragma unroll
        for (int i = 0; i < KW; i += 4) {
          const float4 a = *reinterpret_cast<const float4*>(xs + r * XLD + i);
          s = fmaf(a.x, wv[i], s);
          s = fmaf(a.y, wv[i + 1], s);
          s = fmaf(a.z, wv[i + 2], s);
          s = fmaf(a.w, wv[i + 3], s);
        }
        acc[r] = s;
      }
    } else {
      const __nv_bfloat16* ws = w_buf(st);
      const __nv_bfloat16* xs = x_buf(st);
      const int g = lane >> 2, tg = lane & 3;
      const int k0 = warp * 16;  // this warp's k16 quarter of the chunk
      uint32_t bf[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* wc = ws + (k0 + tg * 2) * WLD + nt * 8 + g;
        bf[nt][0] = pack_bf16(wc[0], wc[WLD]);
        bf[nt][1] = pack_bf16(wc[8 * WLD], wc[9 * WLD]);
      }
#pragma unroll
      for (int mt = 0; mt < BM / 16; ++mt) {
        const __nv_bfloat16* xa = xs + (mt * 16 + g) * XLD + k0 + tg * 2;
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(xa);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(xa + 8 * XLD);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(xa + 8);
        const uint32_t a3 =
            *reinterpret_cast<const uint32_t*>(xa + 8 * XLD + 8);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc + (mt * 4 + nt) * 4, a0, a1, a2, a3, bf[nt][0],
                   bf[nt][1]);
      }
    }
  };

  // the ring: stage t lands while stages t+1..t+3 are in flight
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < steps) issue(t);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t visible; stage t-1's buffer free
    if (t + kStages - 1 < steps) issue(t + kStages - 1);
    cp_async_commit();
    compute(t % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();

  // warp partials -> the CTA's partial, added in warp order
  float* red = reinterpret_cast<float*>(smem);
  float* wred = red + warp * kTile;
  if constexpr (kF32) {
#pragma unroll
    for (int r = 0; r < BM; ++r) wred[r * kStripe + lane] = acc[r];
  } else {
    const int g = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int mt = 0; mt < BM / 16; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* d = acc + (mt * 4 + nt) * 4;
        float* o = wred + (mt * 16 + g) * kStripe + nt * 8 + tg * 2;
        o[0] = d[0];
        o[1] = d[1];
        o[8 * kStripe] = d[2];
        o[8 * kStripe + 1] = d[3];
      }
  }
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem + S::part);
  for (int e = tid; e < kTile; e += kThreads)
    part[e] = ((red[e] + red[kTile + e]) + red[2 * kTile + e]) +
              red[3 * kTile + e];

  // the cluster's groups -> one output, added in group order; rank grp
  // finishes every n_grp-th element
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int e = grp + n_grp * tid; e < kTile; e += n_grp * kThreads) {
    const int r = e / kStripe, lc = c0 + e % kStripe;
    const int col = j * bn + lc;
    if (r >= rows || lc >= bn || col >= N) continue;
    float v[kMaxGroups];  // every rank's partial in flight at once
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g)
      if (g < n_grp) v[g] = *cluster.map_shared_rank(part + e, g);
    float y = v[0];
#pragma unroll
    for (int g = 1; g < kMaxGroups; ++g)
      if (g < n_grp) y += v[g];
    finish(y, col, static_cast<size_t>(m0 + r) * N + col, bias, mult, res, out,
           act);
  }
  cluster.sync();  // peers' partials stay alive until every rank has read
}

// Launch `kernel` on grid (x, groups, z) with one cluster per output
// tile over its slot groups (1, groups, 1).
template <typename Kernel, typename... Args>
cudaError_t launch_clustered(Kernel kernel, size_t smem, dim3 grid, int groups,
                             cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, smem, kStaticSmem);
  if (err != cudaSuccess) return err;
  if (grid.z > 65535 || groups < 1 || groups > kMaxGroups)
    return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = groups;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the operand layout lets every stage go through cp.async
template <typename T>
inline bool vec_ok(const void* x, const void* blocks, int K, int bk, int bn) {
  return aligned16(x) && aligned16(blocks) && (K * sizeof(T)) % 16 == 0 &&
         (bk * sizeof(T)) % 16 == 0 && (bn * sizeof(T)) % 16 == 0;
}

// calls f(integral_constant<int, BM>) for the row tile bm chosen by the
// wrapper: fp32 4/8/16/64, bf16 16/64
template <typename T, typename F>
cudaError_t with_row_tile(int bm, F&& f) {
  using std::integral_constant;
  if constexpr (std::is_same<T, float>::value) {
    if (bm == 4) return f(integral_constant<int, 4>());
    if (bm == 8) return f(integral_constant<int, 8>());
  }
  if (bm == 16) return f(integral_constant<int, 16>());
  if (bm == 64) return f(integral_constant<int, 64>());
  return cudaErrorInvalidValue;
}

inline bool groups_ok(int groups, int group_slots, int max_nnz) {
  return groups >= 1 && groups <= kMaxGroups && group_slots >= 1 &&
         group_slots <= kMaxSlots &&
         static_cast<long long>(groups) * group_slots >= max_nnz;
}

}  // namespace bsr_split
}  // namespace repro
