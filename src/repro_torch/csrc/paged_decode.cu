// Fused paged-attention decode for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py, _decode_kernel /
// paged_attention_decode_pallas (every decode tick, every layer).
//
// One query token per row attends over its cached positions [0, cache_len)
// (clipped to the table's max_pages * ps) plus the new token, whose K/V
// never goes through the pool: it is the seed state (m = q.k_new * scale,
// l = 1, acc = v_new), so every row has a non-empty softmax even at
// cache_len == 0.  All arithmetic is fp32.  Masked positions get the
// finite score -1e30 AND a zeroed V (zero-filled, never read), so NaN in a
// null or freed page cannot leak through 0 * NaN; only pages below
// ceil(cache_len / ps) are read.
//
// Bound on the H100: bytes at long contexts (each K/V element read is
// used for 2 * G flops, G query heads per KV head: 2 * cache_len * KV * dh
// elements per row), latency at the main paths' 54-68 cached positions,
// where a call moves under 1 MB.  The previous design ran one CTA per
// (row, KV head), 32-64 CTAs on 132 SMs, walked the pages one at a time
// with three barriers each and nothing in flight during the math, and left
// most threads idle on the G x ps scores.  What this design does:
//  * the context is cut into chunks of CH positions, a multiple of ps
//    fixed by (ps, dh) alone (kernels/paged_attention.py: decode_chunk,
//    32 positions at ps 4, 8, 16).  Chunk c belongs to virtual rank c % 8;
//    a virtual rank walks its chunks c, c + 8, c + 16, ... in order with
//    an online softmax;
//  * grid (R, KV heads, rows): the R CTAs of a (row, KV head) form one
//    thread-block cluster, R = min(8, table chunks) from the table width
//    (no host sync on cache_len); CTA r runs virtual ranks r, r + R, ...
//    A CTA whose virtual ranks hold no chunk of its row does no loads;
//  * each chunk's page ids are read once per warp (lane j: page j, one
//    coalesced load; the first chunk's together with cache_len, not after
//    it), and the whole chunk's K and V are issued as 16-byte cp.async
//    copies before any math, in two stages: chunk i + 1 is in flight
//    while chunk i computes (a third stage, tried, was slower: fewer CTAs
//    fit an SM); two barriers per chunk;
//  * scores: warps over positions, 8 lanes over dh per position (16-byte
//    loads from shared memory, 4 positions per warp at a time), an
//    xor-shuffle sum inside the 8 lanes whose first lane's total is
//    broadcast, so every lane holds the same bits; then the chunk max, p,
//    l and P.V with warps over positions and lanes over dh: each warp
//    keeps its own running (l, acc) over its positions, rescaled by the
//    shared running max;
//  * combine in the same launch: each virtual rank's state lands in its
//    CTA's shared memory; after a cluster barrier each CTA merges, for its
//    share of the (head, dh) outputs, the seed and the 8 virtual states in
//    rank order through distributed shared memory.  One launch per layer
//    per tick, no workspace, no second kernel.
//
// Batch invariance: a row's output depends on its own q, new K/V, pages and
// cache_len only, never on B, the table width or the cluster size R.  A
// position's score is a fixed reduction; for P.V chunk c's positions are
// split over warps by t % 4; virtual rank v's state is its warps' states, each the
// online softmax over chunks v, v + 8, ... in order, added in warp order;
// the output merges the seed, then virtual ranks 0..7 in order.  R only
// decides which CTA computes a virtual rank, not how.
#include <cooperative_groups.h>

#include "common.cuh"

using namespace repro;
namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRanks = 8;  // virtual ranks: chunk c belongs to c % 8
constexpr int kLanesPerPos = 8;  // a score's dh is split over 8 lanes
constexpr unsigned kFull = 0xffffffffu;

// shared-memory offsets (bytes), each 16-byte aligned: the K/V ring first
struct Layout {
  size_t ring, q, acc, vst, kn, vn, s, snew, mw, lw, bytes;
  __host__ __device__ Layout(int G, int CH, int DH, int tp_bytes, int nslot) {
    size_t o = 0;
    auto take = [&o](size_t n) {
      const size_t at = o;
      o = (o + n + 15) & ~static_cast<size_t>(15);
      return at;
    };
    // two stages x (K, V) x CH x DH
    ring = take(4 * static_cast<size_t>(CH) * DH * tp_bytes);
    q = take(static_cast<size_t>(G) * DH * 4);          // [G][DH] queries
    acc = take(static_cast<size_t>(kWarps) * G * DH * 4);  // [warp][G][DH]
    // [nslot][m G | l G | acc G x DH]: this CTA's virtual-rank states
    vst = take(static_cast<size_t>(nslot) * (2 * G + G * DH) * 4);
    kn = take(DH * 4);                                  // [DH] new K
    vn = take(DH * 4);                                  // [DH] new V
    s = take(static_cast<size_t>(G) * CH * 4);          // [G][CH] scores
    snew = take(G * 4);                                 // [G] seed scores
    mw = take(kWarps * G * 4);  // [warp][G] running max (equal in all warps)
    lw = take(kWarps * G * 4);  // [warp][G] each warp's running normalizer
    bytes = o;
  }
};

template <int NV>
__device__ __forceinline__ void load_nv(const float* p, float* v) {
  if constexpr (NV == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
}

template <int NV>
__device__ __forceinline__ void load_nv(const __nv_bfloat16* p, float* v) {
  if constexpr (NV == 2) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = a.x;
    v[1] = a.y;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
}

// EPL consecutive elements, 16 bytes at a time
template <int EPL>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < EPL; i += 4) load_nv<4>(p + i, v + i);
}
template <int EPL>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
#pragma unroll
  for (int i = 0; i < EPL; i += 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + i);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[h]));
      v[i + 2 * h] = f.x;
      v[i + 2 * h + 1] = f.y;
    }
  }
}

// q . k over dh split into kLanesPerPos lanes of EPL elements: each lane's
// serial FMA chain, an xor-shuffle sum inside the lane group, and the
// group's first lane's total for all its lanes (the same bits everywhere)
template <int EPL>
__device__ __forceinline__ float dot_group(const float* q, const float* k,
                                           int lane) {
  float part = q[0] * k[0];
#pragma unroll
  for (int i = 1; i < EPL; ++i) part = fmaf(q[i], k[i], part);
#pragma unroll
  for (int o = kLanesPerPos / 2; o > 0; o >>= 1)
    part += __shfl_xor_sync(kFull, part, o);
  return __shfl_sync(kFull, part, lane & ~(kLanesPerPos - 1));
}

template <typename T, typename TP, int DH>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                        const T* __restrict__ v_new,
                        const TP* __restrict__ k_pool,
                        const TP* __restrict__ v_pool,
                        const int* __restrict__ page_table,
                        const int* __restrict__ cache_len,
                        float* __restrict__ out, int H, int KV, int ps,
                        int max_pages, int CH, int nslot, float scale) {
  constexpr int NV = DH / 32;  // dh elements per lane (P.V)
  constexpr int EPL = DH / kLanesPerPos;  // dh elements per lane (scores)
  constexpr int PPW = 32 / kLanesPerPos;  // positions per warp and pass
  const int rank = blockIdx.x, R = gridDim.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lo(G, CH, DH, sizeof(TP), nslot);
  TP* ring = reinterpret_cast<TP*>(smem + lo.ring);
  float* q_s = reinterpret_cast<float*>(smem + lo.q);
  float* acc_w = reinterpret_cast<float*>(smem + lo.acc);
  float* vst = reinterpret_cast<float*>(smem + lo.vst);
  float* kn_s = reinterpret_cast<float*>(smem + lo.kn);
  float* vn_s = reinterpret_cast<float*>(smem + lo.vn);
  float* s_s = reinterpret_cast<float*>(smem + lo.s);
  float* snew = reinterpret_cast<float*>(smem + lo.snew);
  float* m_w = reinterpret_cast<float*>(smem + lo.mw);
  float* l_w = reinterpret_cast<float*>(smem + lo.lw);
  const int slot_floats = 2 * G + G * DH;

  const int* tbl = page_table + static_cast<size_t>(b) * max_pages;
  const int pages_per_chunk = CH / ps;  // <= 32 (the wrapper's decode_chunk)
  // lane j: page j of chunk c, read whatever the row's length (a table
  // entry is always readable)
  auto page_ids = [&](int c) {
    const int p = c * pages_per_chunk + lane;
    return lane < pages_per_chunk && p < max_pages ? tbl[p] : 0;
  };
  // this CTA's first chunk, if it has one, is chunk `rank`: its page ids
  // load together with cache_len, not after it
  const int first_pids = page_ids(rank);
  const int len = max(0, min(cache_len[b], max_pages * ps));
  const int n_chunks = (len + CH - 1) / CH;

  // gather chunk c into stage st: K and V rows of its positions below len,
  // the rest zero-filled without a read
  auto issue = [&](int c, int st, int my_pid) {
    TP* ks = ring + static_cast<size_t>(st) * 2 * CH * DH;
    TP* vs = ks + static_cast<size_t>(CH) * DH;
    constexpr int E = 16 / sizeof(TP), CPR = DH / E;
    const int total = CH * CPR;
    for (int base = warp * 32; base < total; base += kThreads) {
      const int e = base + lane;
      const int t = e / CPR, cc = (e % CPR) * E;
      const int pid = __shfl_sync(kFull, my_pid, min(t / ps, 31));
      if (e >= total) continue;
      const int pos = c * CH + t;
      const bool ok = pos < len;
      const size_t off =
          ok ? ((static_cast<size_t>(pid) * ps + pos % ps) * KV + kh) * DH + cc
             : 0;
      cp_async16(ks + t * DH + cc, k_pool + off, ok ? 16 : 0);
      cp_async16(vs + t * DH + cc, v_pool + off, ok ? 16 : 0);
    }
  };

  // the work list: slot i is virtual rank rank + i * R, which owns chunks
  // v, v + 8, ... below n_chunks
  auto count = [&](int i) {
    const int v = rank + i * R;
    return (v < kRanks && v < n_chunks) ? (n_chunks - v + kRanks - 1) / kRanks
                                        : 0;
  };
  auto advance = [&](int& i, int& j) {
    ++j;
    while (i < nslot && j >= count(i)) {
      ++i;
      j = 0;
    }
  };
  auto chunk = [&](int i, int j) { return rank + i * R + kRanks * j; };
  auto reset_warps = [&]() {
    for (int e = tid; e < kWarps * G * DH; e += kThreads) acc_w[e] = 0.f;
    for (int e = tid; e < kWarps * G; e += kThreads) {
      m_w[e] = kNegInf;
      l_w[e] = 0.f;
    }
  };

  // the first chunk is issued before anything else is read
  int ci = 0, cj = -1;
  advance(ci, cj);
  if (ci < nslot) issue(rank, 0, first_pids);  // chunk(ci, cj) == rank
  cp_async_commit();

  const size_t qbase = (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * G) * DH;
  const size_t nbase = (static_cast<size_t>(b) * KV + kh) * DH;
  for (int e = tid; e < G * DH; e += kThreads) q_s[e] = to_float(q[qbase + e]);
  for (int d = tid; d < DH; d += kThreads) {
    kn_s[d] = to_float(k_new[nbase + d]);
    vn_s[d] = to_float(v_new[nbase + d]);
  }
  for (int e = tid; e < nslot * slot_floats; e += kThreads)
    vst[e] = e % slot_floats < G ? kNegInf : 0.f;  // empty: m, l, acc
  reset_warps();
  __syncthreads();
  for (int g0 = warp * PPW; g0 < G; g0 += kWarps * PPW) {  // the seed scores
    const int g = g0 + lane / kLanesPerPos, sl = lane % kLanesPerPos;
    float qv[EPL], kv[EPL];
    load_vec<EPL>(q_s + min(g, G - 1) * DH + sl * EPL, qv);
    load_vec<EPL>(kn_s + sl * EPL, kv);
    const float s = dot_group<EPL>(qv, kv, lane);
    if (sl == 0 && g < G) snew[g] = s * scale;
  }

  for (int step = 0; ci < nslot; ++step) {
    int ai = ci, aj = cj;  // the next step
    advance(ai, aj);
    cp_async_wait<0>();
    __syncthreads();  // this chunk's K/V visible; the other stage free
    if (ai < nslot)
      issue(chunk(ai, aj), (step + 1) & 1, page_ids(chunk(ai, aj)));
    cp_async_commit();

    const int cpos = chunk(ci, cj) * CH;
    const TP* ks = ring + static_cast<size_t>(step & 1) * 2 * CH * DH;
    const TP* vs = ks + static_cast<size_t>(CH) * DH;
    // scores: a warp takes 4 positions at a time, 8 lanes over dh each
    for (int t0 = warp * PPW; t0 < CH; t0 += kWarps * PPW) {
      const int t = t0 + lane / kLanesPerPos, sl = lane % kLanesPerPos;
      float kv[EPL];
      load_vec<EPL>(ks + min(t, CH - 1) * DH + sl * EPL, kv);
      const bool valid = cpos + t < len;
      for (int g = 0; g < G; ++g) {
        float qv[EPL];
        load_vec<EPL>(q_s + g * DH + sl * EPL, qv);
        const float s = dot_group<EPL>(qv, kv, lane);
        if (sl == 0 && t < CH) s_s[g * CH + t] = valid ? s * scale : kNegInf;
      }
    }
    __syncthreads();  // the chunk's scores visible to every warp
    for (int g = 0; g < G; ++g) {
      float mx = kNegInf;
      for (int t = lane; t < CH; t += 32) mx = fmaxf(mx, s_s[g * CH + t]);
      mx = warp_max(mx);
      const float m_old = m_w[warp * G + g];
      const float m_new = fmaxf(m_old, mx);
      const float r = expf(m_old - m_new);
      float pv[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) pv[i] = 0.f;
      float psum = 0.f;
      for (int t = warp; t < CH; t += kWarps) {
        const float p =
            cpos + t < len ? expf(s_s[g * CH + t] - m_new) : 0.f;
        psum += p;
        float vv[NV];
        load_nv<NV>(vs + t * DH + lane * NV, vv);
#pragma unroll
        for (int i = 0; i < NV; ++i) pv[i] = fmaf(p, vv[i], pv[i]);
      }
      float* a = acc_w + (warp * G + g) * DH + lane * NV;
#pragma unroll
      for (int i = 0; i < NV; ++i) a[i] = fmaf(a[i], r, pv[i]);
      __syncwarp();
      if (lane == 0) {
        l_w[warp * G + g] = fmaf(l_w[warp * G + g], r, psum);
        m_w[warp * G + g] = m_new;
      }
      __syncwarp();
    }

    if (ai != ci) {  // the last chunk of slot ci: fold its warps' states
      __syncthreads();
      float* st = vst + ci * slot_floats;
      for (int e = tid; e < G * DH; e += kThreads) {
        const int g = e / DH, d = e % DH;
        const float* a = acc_w + g * DH + d;
        st[2 * G + e] = ((a[0] + a[G * DH]) + a[2 * G * DH]) + a[3 * G * DH];
      }
      for (int g = tid; g < G; g += kThreads) {
        st[g] = m_w[g];
        st[G + g] = ((l_w[g] + l_w[G + g]) + l_w[2 * G + g]) + l_w[3 * G + g];
      }
      __syncthreads();
      reset_warps();
    }
    ci = ai;
    cj = aj;
  }

  // merge: the seed, then virtual ranks 0..7 in order; CTA `rank`
  // finishes every R-th (head, dh) output
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int e = rank + R * tid; e < G * DH; e += R * kThreads) {
    const int g = e / DH, d = e % DH;
    float mv[kRanks], lv[kRanks], av[kRanks];
#pragma unroll
    for (int v = 0; v < kRanks; ++v) {
      const float* st =
          cluster.map_shared_rank(vst, v % R) + (v / R) * slot_floats;
      mv[v] = st[g];
      lv[v] = st[G + g];
      av[v] = st[2 * G + e];
    }
    float M = snew[g];
#pragma unroll
    for (int v = 0; v < kRanks; ++v) M = fmaxf(M, mv[v]);
    const float w0 = expf(snew[g] - M);
    float L = w0, A = w0 * vn_s[d];
#pragma unroll
    for (int v = 0; v < kRanks; ++v) {
      const float w = expf(mv[v] - M);
      L = fmaf(lv[v], w, L);
      A = fmaf(av[v], w, A);
    }
    out[qbase + e] = A / L;
  }
  cluster.sync();  // peers' states stay alive until every CTA has read
}

template <typename T, typename TP, int DH>
cudaError_t launch_dh(const void* q, const void* k_new, const void* v_new,
                      const void* k_pool, const void* v_pool,
                      const void* page_table, const void* cache_len,
                      void* out, int B, int H, int KV, int ps, int max_pages,
                      int CH, int R, float scale, cudaStream_t stream) {
  const int nslot = (kRanks + R - 1) / R;
  const Layout lo(H / KV, CH, DH, sizeof(TP), nslot);
  auto kernel = paged_decode_kernel<T, TP, DH>;
  cudaError_t err = allow_smem(kernel, lo.bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R, KV, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = lo.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;  // a cluster = one (row, KV head)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const TP*>(k_pool),
      static_cast<const TP*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(cache_len), static_cast<float*>(out), H, KV, ps,
      max_pages, CH, nslot, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, typename TP>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* k_pool, const void* v_pool,
                   const void* page_table, const void* cache_len, void* out,
                   int B, int H, int KV, int dh, int ps, int max_pages,
                   int CH, int R, float scale, cudaStream_t stream) {
  if (!aligned16(k_pool) || !aligned16(v_pool))
    return cudaErrorMisalignedAddress;
  if (KV < 1 || H % KV != 0 || ps < 1 || CH < ps || CH % ps != 0 ||
      CH / ps > 32 || R < 1 || R > kRanks || B > 65535 || KV > 65535)
    return cudaErrorInvalidValue;
  if (dh == 64)
    return launch_dh<T, TP, 64>(q, k_new, v_new, k_pool, v_pool, page_table,
                                cache_len, out, B, H, KV, ps, max_pages, CH, R,
                                scale, stream);
  if (dh == 128)
    return launch_dh<T, TP, 128>(q, k_new, v_new, k_pool, v_pool, page_table,
                                 cache_len, out, B, H, KV, ps, max_pages, CH,
                                 R, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q/k_new/v_new share dtype `dtype`; the pools have dtype `pool_dtype`;
// out is fp32 (B, H, dh).  dh is 64 or 128; chunk (positions per chunk, a
// multiple of ps) and ranks (CTAs per cluster) come from the wrapper
// (kernels/paged_attention.py: decode_chunk, decode_grid).
extern "C" int paged_decode_launch(int dtype, int pool_dtype, const void* q,
                                   const void* k_new, const void* v_new,
                                   const void* k_pool, const void* v_pool,
                                   const void* page_table,
                                   const void* cache_len, void* out, int B,
                                   int H, int KV, int dh, int ps,
                                   int max_pages, int chunk, int ranks,
                                   float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kFloat32 && pool_dtype == kFloat32)
    err = launch<float, float>(q, k_new, v_new, k_pool, v_pool, page_table,
                               cache_len, out, B, H, KV, dh, ps, max_pages,
                               chunk, ranks, scale, st);
  else if (dtype == kBFloat16 && pool_dtype == kFloat32)
    err = launch<__nv_bfloat16, float>(q, k_new, v_new, k_pool, v_pool,
                                       page_table, cache_len, out, B, H, KV,
                                       dh, ps, max_pages, chunk, ranks, scale,
                                       st);
  else if (dtype == kFloat32 && pool_dtype == kBFloat16)
    err = launch<float, __nv_bfloat16>(q, k_new, v_new, k_pool, v_pool,
                                       page_table, cache_len, out, B, H, KV,
                                       dh, ps, max_pages, chunk, ranks, scale,
                                       st);
  else if (dtype == kBFloat16 && pool_dtype == kBFloat16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_new, v_new, k_pool, v_pool, page_table, cache_len, out, B, H, KV,
        dh, ps, max_pages, chunk, ranks, scale, st);
  return static_cast<int>(err);
}

// dynamic shared memory of one CTA (bytes), for reports
extern "C" long long paged_decode_smem_bytes(int G, int chunk, int dh,
                                             int pool_bytes, int ranks) {
  if (ranks < 1) return -1;
  return static_cast<long long>(
      Layout(G, chunk, dh, pool_bytes, (kRanks + ranks - 1) / ranks).bytes);
}
