// Fused causal paged-attention prefill for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py, _prefill_kernel /
// paged_attention_prefill_pallas (every admission, every layer).
//
// Queries sit at logical positions [q_offset, q_offset + S) (q_offset > 0
// is the tail-only prefill of a prefix-cache hit) and attend causally over
// the row's pages from logical position 0: valid iff kvpos <= qpos,
// kvpos < len and qpos < len.  fp32 online softmax; masked V is zeroed so
// NaN in unallocated pages cannot leak; rows at or past their length
// give 0 (the l == 0 guard).  fp32 output.
//
// Bound on the H100: latency, then bytes.  At the main paths' shapes
// (prompt tails of at most 64 tokens, head_dim 64) the whole call moves
// under 1 MB and does a few MFLOP: a fraction of a microsecond on either
// roof, so what costs is the number of dependent steps each CTA takes
// and how much of the card is working.  What the design does:
//  * one CTA per (row, KV head, tile of 16 query rows), a query row being
//    a (position, head of the GQA group) pair: qwen's and granite's
//    47-token prompts give 48 CTAs (the previous design gave 16);
//  * keys are taken in steps of 64 (8 pages at page size 8, the
//    reference's pages_per_step), each step's K and V gathered from the
//    pages into shared memory with 16-byte cp.async; two buffers, so
//    step j+1 is in flight while step j computes; two barriers per step;
//  * the page ids of the next two steps are prefetched into L2, so a
//    step's gather waits on one device-memory round trip, not two;
//  * register tiles: each thread owns 2 rows x 4 keys of the scores (a
//    serial FFMA chain over head_dim; each K load feeds both rows) and
//    2 rows x 4 head_dim columns of P.V; row max and sum are shuffles
//    inside a half-warp; P goes through shared memory only within its
//    warp.  All products are fp32 FFMA (bf16 inputs are widened on load).
// Not done: a split over key steps for long prompts at few query tiles.
//
// Batch invariance: a query row's output depends only on its absolute
// position, its row's length and its pages; not on S, q_offset, B or the
// tile it falls in.  Key steps start at absolute multiples of 64 from
// position 0 whatever the tile; inside a step every reduction runs in an
// order fixed by the key's index in the step (scores over head_dim in
// order, max and sum over a fixed shuffle tree whose result is broadcast
// from one lane, P.V over the step's keys in order); a step fully masked
// for a row leaves its (m, l, acc) exactly unchanged (its scores are the
// finite mask value, so m stays, the rescale is exp(0) = 1 and every p is
// 0).
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 128;  // 4 warps x 4 query rows
constexpr int kRows = 16;      // query rows per CTA
constexpr int kKeys = 64;      // keys per step

template <typename TP, int DH>
struct Smem {
  static constexpr int KLD = DH + 16 / sizeof(TP);  // K rows padded 16 bytes
  static constexpr size_t k_elems = kKeys * KLD;
  static constexpr size_t buf = (k_elems + kKeys * DH) * sizeof(TP);
  static constexpr size_t q_off = 2 * buf;  // two K/V buffers, then q, p
  static constexpr size_t p_off = q_off + kRows * DH * sizeof(float);
  static constexpr size_t bytes = p_off + kRows * kKeys * sizeof(float);
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void fma4(float* acc, float a, float4 v) {
  acc[0] = fmaf(a, v.x, acc[0]);
  acc[1] = fmaf(a, v.y, acc[1]);
  acc[2] = fmaf(a, v.z, acc[2]);
  acc[3] = fmaf(a, v.w, acc[3]);
}

template <typename T, typename TP, int DH>
__global__ void __launch_bounds__(kThreads)
    paged_prefill_kernel(const T* __restrict__ q, const TP* __restrict__ k_pool,
                         const TP* __restrict__ v_pool,
                         const int* __restrict__ page_table,
                         const int* __restrict__ lengths,
                         float* __restrict__ out, int S, int H, int KV, int ps,
                         int max_pages, int q_offset, float scale) {
  using Sm = Smem<TP, DH>;
  constexpr int KLD = Sm::KLD;
  constexpr int NV = DH / 64;  // float4 groups of head_dim per thread and row
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + Sm::q_off);  // [kRows][DH]
  float* p_s = reinterpret_cast<float*>(smem + Sm::p_off);  // [kRows][kKeys]

  const int b = blockIdx.x, kh = blockIdx.y, tile = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kg = lane & 15;                  // key / head_dim group
  const int r0 = warp * 4 + (lane >> 4) * 2;  // this thread's rows r0, r0+1
  const int* tbl = page_table + static_cast<size_t>(b) * max_pages;

  // page ids of key step j, into L2 ahead of the gather that reads them
  auto prefetch_pages = [&](int j) {
    const int p0 = j * kKeys / ps;
    const int p1 = min(max_pages, (j * kKeys + kKeys - 1) / ps + 1);
    for (int p = p0 + tid * 32; p < p1; p += 32 * kThreads) prefetch_l2(tbl + p);
    if (tid == 0 && p0 < p1) prefetch_l2(tbl + p1 - 1);
  };
  prefetch_pages(0);
  prefetch_pages(1);
  const int len = lengths[b];
  const int key_end = min(len, max_pages * ps);  // keys past the table: none

  // row r of the tile is query (position r_sp, head kh * G + r_hq)
  int sp[2], hq[2], qpos[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = tile * kRows + r0 + h;
    sp[h] = gr / G;
    hq[h] = gr % G;
    qpos[h] = q_offset + sp[h];
    live[h] = sp[h] < S && qpos[h] < len;
  }
  // keys the tile needs: up to its last position's causal horizon
  const int last_sp = min((tile * kRows + kRows - 1) / G, S - 1);
  const int horizon = min(key_end, q_offset + last_sp + 1);
  const int n_steps = horizon > 0 ? (horizon + kKeys - 1) / kKeys : 0;

  // gather step j's K and V (kKeys x DH each) from the pages; keys past
  // the row's length are zero-filled without a read
  auto issue = [&](int j) {
    TP* ks = reinterpret_cast<TP*>(smem + (j & 1) * Sm::buf);
    TP* vs = ks + Sm::k_elems;
    constexpr int E = 16 / sizeof(TP), CPR = DH / E;
    for (int e = tid; e < kKeys * CPR; e += kThreads) {
      const int key = e / CPR, c = (e % CPR) * E;
      const int kv = j * kKeys + key;
      size_t off = 0;
      int bytes = 0;
      if (kv < key_end) {
        const int pid = tbl[kv / ps];
        off = ((static_cast<size_t>(pid) * ps + kv % ps) * KV + kh) * DH + c;
        bytes = 16;
      }
      cp_async16(ks + key * KLD + c, k_pool + off, bytes);
      cp_async16(vs + key * DH + c, v_pool + off, bytes);
    }
  };

  if (n_steps > 0) issue(0);
  cp_async_commit();
  for (int e = tid; e < kRows * DH; e += kThreads) {
    const int qr = tile * kRows + e / DH, p = qr / G;
    q_s[e] = p < S ? to_float(q[((static_cast<size_t>(b) * S + p) * H + kh * G +
                                 qr % G) * DH + e % DH])
                   : 0.f;
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[2][4 * NV];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) acc[h][c] = 0.f;

  for (int j = 0; j < n_steps; ++j) {
    if (j + 2 < n_steps) prefetch_pages(j + 2);
    if (j + 1 < n_steps) issue(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // step j's K/V (and the q tile) visible
    const TP* ks = reinterpret_cast<const TP*>(smem + (j & 1) * Sm::buf);
    const TP* vs = ks + Sm::k_elems;

    // scores of rows r0, r0+1 against keys kg + 16 i, serial over head_dim
    float sc[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[h][i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(q_s + r0 * DH + d);
      const float4 qb = *reinterpret_cast<const float4*>(q_s + (r0 + 1) * DH + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 k = load4(ks + (kg + 16 * i) * KLD + d);
        sc[0][i] = fmaf(qa.x, k.x, sc[0][i]);
        sc[0][i] = fmaf(qa.y, k.y, sc[0][i]);
        sc[0][i] = fmaf(qa.z, k.z, sc[0][i]);
        sc[0][i] = fmaf(qa.w, k.w, sc[0][i]);
        sc[1][i] = fmaf(qb.x, k.x, sc[1][i]);
        sc[1][i] = fmaf(qb.y, k.y, sc[1][i]);
        sc[1][i] = fmaf(qb.z, k.z, sc[1][i]);
        sc[1][i] = fmaf(qb.w, k.w, sc[1][i]);
      }
    }

    // online softmax per row over the half-warp holding its 64 keys
    float rescale[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kv = j * kKeys + kg + 16 * i;
        ok[i] = live[h] && kv <= qpos[h] && kv < key_end;
        sc[h][i] = ok[i] ? sc[h][i] * scale : kNegInf;
        mx = fmaxf(mx, sc[h][i]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m2 = fmaxf(m[h], mx);
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ok[i] ? expf(sc[h][i] - m2) : 0.f;
      float psum = ((p[0] + p[1]) + p[2]) + p[3];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      psum = __shfl_sync(0xffffffffu, psum, lane & 16);  // one lane's order
      rescale[h] = expf(m[h] - m2);
      l[h] = fmaf(l[h], rescale[h], psum);
      m[h] = m2;
#pragma unroll
      for (int i = 0; i < 4; ++i) p_s[(r0 + h) * kKeys + kg + 16 * i] = p[i];
    }
    __syncwarp();  // a warp reads back only its own rows of p

    // P.V: rows r0, r0+1 x head_dim 4 kg + 64 u, serial over the keys
    float pv[2][4 * NV];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4 * NV; ++c) pv[h][c] = 0.f;
#pragma unroll 4
    for (int key = 0; key < kKeys; ++key) {
      const float pa = p_s[r0 * kKeys + key], pb = p_s[(r0 + 1) * kKeys + key];
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const float4 v = load4(vs + key * DH + 64 * u + 4 * kg);
        fma4(pv[0] + 4 * u, pa, v);
        fma4(pv[1] + 4 * u, pb, v);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4 * NV; ++c)
        acc[h][c] = fmaf(acc[h][c], rescale[h], pv[h][c]);
    __syncthreads();  // buffer j & 1 and p free for step j + 2 / j + 1
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (sp[h] >= S) continue;
    float* o = out + ((static_cast<size_t>(b) * S + sp[h]) * H + kh * G + hq[h]) * DH;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (l[h] != 0.f)
        v = make_float4(acc[h][4 * u] / l[h], acc[h][4 * u + 1] / l[h],
                        acc[h][4 * u + 2] / l[h], acc[h][4 * u + 3] / l[h]);
      *reinterpret_cast<float4*>(o + 64 * u + 4 * kg) = v;
    }
  }
}

template <typename T, typename TP, int DH>
cudaError_t launch_dh(const void* q, const void* k_pool, const void* v_pool,
                      const void* page_table, const void* lengths, void* out,
                      int B, int S, int H, int KV, int ps, int max_pages,
                      int q_offset, float scale, cudaStream_t stream) {
  auto kernel = paged_prefill_kernel<T, TP, DH>;
  const size_t smem = Smem<TP, DH>::bytes;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (static_cast<long long>(S) * (H / KV) + kRows - 1) / kRows;
  if (tiles > 65535 || KV > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(B, KV, static_cast<unsigned>(tiles));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TP*>(k_pool),
      static_cast<const TP*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<float*>(out), S, H, KV, ps,
      max_pages, q_offset, scale);
  return cudaGetLastError();
}

template <typename T, typename TP>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* page_table, const void* lengths, void* out,
                   int B, int S, int H, int KV, int dh, int ps, int max_pages,
                   int q_offset, float scale, cudaStream_t stream) {
  if (!aligned16(k_pool) || !aligned16(v_pool) || !aligned16(out))
    return cudaErrorMisalignedAddress;
  if (dh == 64)
    return launch_dh<T, TP, 64>(q, k_pool, v_pool, page_table, lengths, out, B,
                                S, H, KV, ps, max_pages, q_offset, scale, stream);
  if (dh == 128)
    return launch_dh<T, TP, 128>(q, k_pool, v_pool, page_table, lengths, out,
                                 B, S, H, KV, ps, max_pages, q_offset, scale,
                                 stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, S, H, dh) has dtype `dtype`; the pools (P, ps, KV, dh) have
// `pool_dtype`; out is fp32 (B, S, H, dh).  dh is 64 or 128; `rows` must
// be the kernel's query rows per CTA (the wrapper's PREFILL_ROWS).
extern "C" int paged_prefill_launch(int dtype, int pool_dtype, const void* q,
                                    const void* k_pool, const void* v_pool,
                                    const void* page_table,
                                    const void* lengths, void* out, int B,
                                    int S, int H, int KV, int dh, int ps,
                                    int max_pages, int q_offset, int rows,
                                    float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (rows != kRows) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kFloat32 && pool_dtype == kFloat32)
    err = launch<float, float>(q, k_pool, v_pool, page_table, lengths, out, B,
                               S, H, KV, dh, ps, max_pages, q_offset, scale,
                               st);
  else if (dtype == kBFloat16 && pool_dtype == kFloat32)
    err = launch<__nv_bfloat16, float>(q, k_pool, v_pool, page_table, lengths,
                                       out, B, S, H, KV, dh, ps, max_pages,
                                       q_offset, scale, st);
  else if (dtype == kFloat32 && pool_dtype == kBFloat16)
    err = launch<float, __nv_bfloat16>(q, k_pool, v_pool, page_table, lengths,
                                       out, B, S, H, KV, dh, ps, max_pages,
                                       q_offset, scale, st);
  else if (dtype == kBFloat16 && pool_dtype == kBFloat16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, v_pool, page_table, lengths, out, B, S, H, KV, dh, ps,
        max_pages, q_offset, scale, st);
  return static_cast<int>(err);
}
