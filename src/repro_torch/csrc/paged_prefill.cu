// Fused causal paged-attention prefill for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py, _prefill_kernel /
// paged_attention_prefill_pallas (every admission, every layer).
//
// Queries sit at logical positions [q_offset, q_offset + S) (q_offset > 0
// is the tail-only prefill of a prefix-cache hit) and attend causally over
// the row's pages from logical position 0: valid iff kvpos <= qpos,
// kvpos < len and qpos < len.  One block per (row, KV head, query tile of
// BQ positions x G heads) walks the pages while j * ps < min(len,
// q_offset + (i + 1) * BQ), with an fp32 online softmax.  Masked V is
// zeroed so NaN in unallocated pages cannot leak; rows at or past their
// length give 0 (the l == 0 guard).
//
// Bound on the H100: bytes at the main path's shapes (prompt tails of tens
// of tokens, head_dim 64): each K/V page is used by at most BQ * G query
// rows.  What the design does about it: the query tile covers the whole
// GQA group and up to 64 rows, so each K/V page is loaded into shared
// memory once per tile and reused by every row of it; pages past the
// tile's causal horizon are never read.  Not yet done (later PRs): wgmma
// for the two products at long prompts, and double-buffered page loads.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 128;
constexpr int kTargetRows = 64;  // query rows (positions x heads) per tile

size_t smem_bytes(int R, int dh, int ps) {
  return sizeof(float) * (static_cast<size_t>(R) * (dh + 1) + ps * (dh + 1) +
                          ps * dh + R * ps + 2 * R + R * dh);
}

template <typename T, typename TP>
__global__ void __launch_bounds__(kThreads)
    paged_prefill_kernel(const T* __restrict__ q, const TP* __restrict__ k_pool,
                         const TP* __restrict__ v_pool,
                         const int* __restrict__ page_table,
                         const int* __restrict__ lengths,
                         float* __restrict__ out, int S, int H, int KV, int dh,
                         int ps, int max_pages, int q_offset, int BQ,
                         float scale) {
  const int b = blockIdx.x, kh = blockIdx.y, i = blockIdx.z;
  const int G = H / KV;
  const int R = BQ * G;  // row r: position i*BQ + r / G, head kh*G + r % G
  const int ldk = dh + 1;
  extern __shared__ float sm[];
  float* q_s = sm;                  // [R][ldk]
  float* k_s = q_s + R * ldk;       // [ps][ldk]
  float* v_s = k_s + ps * ldk;      // [ps][dh]
  float* p_s = v_s + ps * dh;       // [R][ps]
  float* m_s = p_s + R * ps;        // [R]
  float* l_s = m_s + R;             // [R]
  float* acc = l_s + R;             // [R][dh]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int len = lengths[b];
  const int pos0 = i * BQ;  // first local query position of this tile

  for (int e = tid; e < R * dh; e += blockDim.x) {
    const int r = e / dh, d = e % dh;
    const int sp = pos0 + r / G;
    q_s[r * ldk + d] =
        sp < S ? to_float(q[((static_cast<size_t>(b) * S + sp) * H + kh * G +
                             r % G) * dh + d])
               : 0.f;
    acc[e] = 0.f;
  }
  for (int r = tid; r < R; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  // pages this tile needs: kvpos <= qpos < min(len, q_offset + (i+1)*BQ)
  const int qhi = min(len, q_offset + (i + 1) * BQ);
  int n_pg = qhi > 0 ? (qhi + ps - 1) / ps : 0;
  if (n_pg > max_pages) n_pg = max_pages;
  for (int j = 0; j < n_pg; ++j) {
    const int pid = page_table[static_cast<size_t>(b) * max_pages + j];
    for (int e = tid; e < ps * dh; e += blockDim.x) {
      const int t = e / dh, d = e % dh;
      const bool live = j * ps + t < len;
      const size_t off =
          ((static_cast<size_t>(pid) * ps + t) * KV + kh) * dh + d;
      k_s[t * ldk + d] = live ? to_float(k_pool[off]) : 0.f;
      v_s[t * dh + d] = live ? to_float(v_pool[off]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < R * ps; e += blockDim.x) {
      const int r = e / ps, t = e % ps;
      const int qpos = q_offset + pos0 + r / G;
      const int kvpos = j * ps + t;
      float s = kNegInf;
      if (kvpos <= qpos && kvpos < len && qpos < len) {
        float a = 0.f;
        for (int d = 0; d < dh; ++d) a = fmaf(q_s[r * ldk + d], k_s[t * ldk + d], a);
        s = a * scale;
      }
      p_s[r * ps + t] = s;
    }
    __syncthreads();
    for (int r = warp; r < R; r += nwarps) {
      const int qpos = q_offset + pos0 + r / G;
      float mx = kNegInf;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, p_s[r * ps + t]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m2 = fmaxf(m_old, mx);
      const float rr = expf(m_old - m2);
      float psum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const int kvpos = j * ps + t;
        const bool valid = kvpos <= qpos && kvpos < len && qpos < len;
        const float p = valid ? expf(p_s[r * ps + t] - m2) : 0.f;
        p_s[r * ps + t] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      __syncwarp();
      for (int d = lane; d < dh; d += 32) {
        float a = 0.f;
        for (int t = 0; t < ps; ++t) a = fmaf(p_s[r * ps + t], v_s[t * dh + d], a);
        acc[r * dh + d] = acc[r * dh + d] * rr + a;
      }
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m2;
        l_s[r] = l_s[r] * rr + psum;
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < R * dh; e += blockDim.x) {
    const int r = e / dh, d = e % dh;
    const int sp = pos0 + r / G;
    if (sp >= S) continue;
    const float l = l_s[r];
    out[((static_cast<size_t>(b) * S + sp) * H + kh * G + r % G) * dh + d] =
        l == 0.f ? 0.f : acc[e] / l;
  }
}

template <typename T, typename TP>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* page_table, const void* lengths, void* out,
                   int B, int S, int H, int KV, int dh, int ps, int max_pages,
                   int q_offset, float scale, cudaStream_t stream) {
  const int G = H / KV;
  int BQ = kTargetRows / G > 0 ? kTargetRows / G : 1;
  if (BQ > S) BQ = S;
  while (BQ > 1 && smem_bytes(BQ * G, dh, ps) > 48 * 1024) BQ /= 2;
  const size_t smem = smem_bytes(BQ * G, dh, ps);
  auto kernel = paged_prefill_kernel<T, TP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, KV, (S + BQ - 1) / BQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TP*>(k_pool),
      static_cast<const TP*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<float*>(out), S, H, KV, dh,
      ps, max_pages, q_offset, BQ, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, S, H, dh) has dtype `dtype`; the pools (P, ps, KV, dh) have
// `pool_dtype`; out is fp32 (B, S, H, dh).
extern "C" int paged_prefill_launch(int dtype, int pool_dtype, const void* q,
                                    const void* k_pool, const void* v_pool,
                                    const void* page_table,
                                    const void* lengths, void* out, int B,
                                    int S, int H, int KV, int dh, int ps,
                                    int max_pages, int q_offset, float scale,
                                    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
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
