// Kernel body of the 2-D block-sparse (BSR) matmul for Hopper (sm_90a):
// y = act(x @ W_bsr + bias) * mult + residual for x (M, K) and a BSR
// weight stored as the flat live-tile store blocks (nnz, bk, bn) plus the
// per-column map indices/slots (grid_n, max_nnz) (-1 marks a padding
// slot).  Entry point: bsr_matmul.cu.  (The planes kernel keeps its own
// body, bsr_body.cuh.)
//
// Replaces: src/repro/kernels/block_sparse_matmul.py, bsr_matmul_kernel /
// bsr_matmul_pallas (the TPU kernel of every packed projection).
//
// Bound on the H100: bytes.  At the main paths' shapes (decode M = 4
// slots, prefill M = one prompt tail) every live weight tile is read once
// per call and used for M rows, far below the ~295 operations per byte at
// which the bf16 tensor cores would bound it (fp32: ~20 per byte).  A
// decode call moves 0.5-3 MB, under a microsecond of HBM time, so the
// kernel must put every SM to work at once and keep bytes in flight.
// What the design does:
//  * the grid is (BSR block column x 32-column stripe, slot group, row
//    tile).  A column's slots are cut into `groups` consecutive groups of
//    `group_slots` (the wrapper picks them from grid_n, max_nnz and the
//    stripe count alone, so that a decode call puts a CTA on every SM);
//    each CTA walks only its group's live slots, skipping padding before
//    any load;
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
//    shared memory in warp order.  Row tiles follow M (the wrapper's
//    bsr_row_tile): fp32 4, 8, 16 up to 48 rows, then 64; bf16 16, 64;
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
// and the quarters are fixed by (grid_n, max_nnz, bk, bn) and the slot
// index, never by M, BM or the row tile; rows never mix.  A column with no
// live slot writes epilogue(0).
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "bsr_body.cuh"  // activation codes and activate()

namespace repro {
namespace bsr_split {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;    // 4 warps, one K quarter each
constexpr int kWarps = kThreads / 32;
constexpr int kStripe = 32;      // output columns per CTA
constexpr int kStages = 4;       // cp.async ring depth
constexpr int kMaxGroups = 8;    // portable thread-block cluster size
constexpr int kMaxSlots = 1024;  // slots of one group held in shared memory

// K chunk of one stage and shared-memory row strides (elements).  fp32: a
// 32-deep chunk, 8 rows per warp.  bf16: a 64-deep chunk, one k16 mma step
// per warp; rows padded by 16 bytes so the fragment loads miss no bank.
template <typename T>
struct Layout;
template <>
struct Layout<float> {
  static constexpr int KC = 32, XLD = 32, WLD = kStripe;
};
template <>
struct Layout<__nv_bfloat16> {
  static constexpr int KC = 64, XLD = 64 + 8, WLD = kStripe + 8;
};

template <typename T, int BM>
struct Smem {
  using L = Layout<T>;
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

// One CTA: output tile (rows m0.., stripe c0.. of block column j), slot
// group blockIdx.y of gridDim.y.  kVec: x, blocks, K, bk and bn are
// 16-byte aligned, so every stage is copied with cp.async.
template <typename T, int BM, bool kVec>
__global__ void __launch_bounds__(kThreads)
    bsr_split_kernel(const T* __restrict__ x, const T* __restrict__ blocks,
                     const int* __restrict__ indices,
                     const int* __restrict__ slots,
                     const float* __restrict__ bias,
                     const T* __restrict__ mult, const T* __restrict__ res,
                     T* __restrict__ out, int M, int K, int N, int bk, int bn,
                     int max_nnz, int stripes, int group_slots, int act) {
  using L = Layout<T>;
  using S = Smem<T, BM>;
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
  const int m0 = blockIdx.z * BM;
  constexpr int kTile = BM * kStripe;

  // this rank's epilogue operands go to L2 while the slots and weights
  // load, so the epilogue waits on no device-memory round trip
  for (int e = grp + n_grp * tid; e < kTile; e += n_grp * kThreads) {
    const int row = m0 + e / kStripe, lc = c0 + e % kStripe;
    const int col = j * bn + lc;
    if (row >= M || lc >= bn || col >= N) continue;
    const size_t o = static_cast<size_t>(row) * N + col;
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
      const unsigned live = __ballot_sync(0xffffffffu, kb >= 0);
      if (kb >= 0) {
        const int at = n + __popc(live & ((1u << lane) - 1u));
        s_kb[at] = kb;
        s_slot[at] = slots[o];
      }
      n += __popc(live);
    }
    if (lane == 0) s_live = n;
  }
  __syncthreads();
  const int chunks = (bk + KC - 1) / KC;
  const int steps = s_live * chunks;

  auto w_buf = [&](int st) { return reinterpret_cast<T*>(smem + st * S::stage); };
  auto x_buf = [&](int st) { return w_buf(st) + S::w_elems; };

  // stage step t (live slot t / chunks, K chunk t % chunks); masked
  // edges are written as zeros and never read
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
        const int row = m0 + r, kk = kc + cc, col = kb * bk + kk;
        const bool ok = row < M && kk < bk && col < K;
        cp_async16(xs + r * XLD + cc,
                   ok ? x + static_cast<size_t>(row) * K + col : x, ok ? 16 : 0);
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
        const int row = m0 + r, kk = kc + cc, col = kb * bk + kk;
        xs[r * XLD + cc] = (row < M && kk < bk && col < K)
                               ? x[static_cast<size_t>(row) * K + col]
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
      constexpr int KW = KC / kWarps;  // 8 rows of the chunk per warp
      const float* ws = w_buf(st) + warp * KW * WLD + lane;
      const float* xs = x_buf(st) + warp * KW;
      float wv[KW];
#pragma unroll
      for (int i = 0; i < KW; ++i) wv[i] = ws[i * WLD];
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(xs + r * XLD);
        const float4 c = *reinterpret_cast<const float4*>(xs + r * XLD + 4);
        float s = acc[r];
        s = fmaf(a.x, wv[0], s);
        s = fmaf(a.y, wv[1], s);
        s = fmaf(a.z, wv[2], s);
        s = fmaf(a.w, wv[3], s);
        s = fmaf(c.x, wv[4], s);
        s = fmaf(c.y, wv[5], s);
        s = fmaf(c.z, wv[6], s);
        s = fmaf(c.w, wv[7], s);
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
    const int row = m0 + r, col = j * bn + lc;
    if (row >= M || lc >= bn || col >= N) continue;
    float v[kMaxGroups];  // every rank's partial in flight at once
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g)
      if (g < n_grp) v[g] = *cluster.map_shared_rank(part + e, g);
    float y = v[0];
#pragma unroll
    for (int g = 1; g < kMaxGroups; ++g)
      if (g < n_grp) y += v[g];
    // fused epilogue on the fp32 sum: bias -> act -> mult -> residual
    const size_t o = static_cast<size_t>(row) * N + col;
    if (bias != nullptr) y += bias[col];
    y = bsr::activate(y, act);
    if (mult != nullptr) y *= to_float(mult[o]);
    if (res != nullptr) y += to_float(res[o]);
    out[o] = from_float<T>(y);
  }
  cluster.sync();  // peers' partials stay alive until every rank has read
}

}  // namespace bsr_split
}  // namespace repro
