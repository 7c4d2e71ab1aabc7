// Fused paged-attention decode for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py, _decode_kernel /
// paged_attention_decode_pallas (every decode tick, every layer).
//
// One query token per row attends over its cached positions [0, cache_len)
// by walking the row's page table with an online softmax, all in fp32.
// The new token's K/V never goes through the pool: it seeds the state
// (m = q.k_new * scale, l = 1, acc = v_new), so every row has a non-empty
// softmax even at cache_len == 0.  Masked positions get the finite score
// -1e30 AND a zeroed V, so NaN in a null or freed page cannot leak through
// 0 * NaN.  Only pages below ceil(cache_len / page_size) are read.
//
// Bound on the H100: bytes.  Each K/V element read is used for 2*G flops
// (G query heads per KV head), so the kernel streams the live K/V pages
// (2 * cache_len * K * dh elements per row) and little else.  What the
// design does about it: one block per (row, KV head) covers the whole GQA
// group, so each K/V page is loaded once into shared memory for all G
// heads; dead pages past cache_len are never touched, so traffic scales
// with the live context and not with the table width.  Not yet done
// (later PRs): splitting a long context over several blocks, and
// overlapping the next page's load with this page's math.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 128;

template <typename T, typename TP>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                        const T* __restrict__ v_new,
                        const TP* __restrict__ k_pool,
                        const TP* __restrict__ v_pool,
                        const int* __restrict__ page_table,
                        const int* __restrict__ cache_len,
                        float* __restrict__ out, int H, int KV, int dh,
                        int ps, int max_pages, float scale) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int G = H / KV;
  const int ldk = dh + 1;  // padded rows: no bank conflicts across t
  extern __shared__ float sm[];
  float* q_s = sm;                  // [G][ldk]
  float* k_s = q_s + G * ldk;       // [ps][ldk]
  float* v_s = k_s + ps * ldk;      // [ps][dh]
  float* p_s = v_s + ps * dh;       // [G][ps] scores, then probabilities
  float* m_s = p_s + G * ps;        // [G] running max
  float* l_s = m_s + G;             // [G] running normalizer
  float* acc = l_s + G;             // [G][dh] running weighted values

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int clen = cache_len[b];
  const size_t qbase = (static_cast<size_t>(b) * H + kh * G) * dh;
  const size_t nbase = (static_cast<size_t>(b) * KV + kh) * dh;

  for (int e = tid; e < G * dh; e += blockDim.x)
    q_s[(e / dh) * ldk + e % dh] = to_float(q[qbase + e]);
  for (int d = tid; d < dh; d += blockDim.x) {
    k_s[d] = to_float(k_new[nbase + d]);
    v_s[d] = to_float(v_new[nbase + d]);
  }
  __syncthreads();

  // seed from the in-register current token: m = s_new, l = 1, acc = v_new
  for (int g = warp; g < G; g += nwarps) {
    float part = 0.f;
    for (int d = lane; d < dh; d += 32) part = fmaf(q_s[g * ldk + d], k_s[d], part);
    const float s_new = warp_sum(part) * scale;
    for (int d = lane; d < dh; d += 32) acc[g * dh + d] = v_s[d];
    if (lane == 0) {
      m_s[g] = s_new;
      l_s[g] = 1.f;
    }
  }
  __syncthreads();

  int live = (clen + ps - 1) / ps;
  if (live > max_pages) live = max_pages;
  for (int j = 0; j < live; ++j) {
    const int pid = page_table[static_cast<size_t>(b) * max_pages + j];
    for (int e = tid; e < ps * dh; e += blockDim.x) {
      const int t = e / dh, d = e % dh;
      const bool valid = j * ps + t < clen;
      const size_t off =
          ((static_cast<size_t>(pid) * ps + t) * KV + kh) * dh + d;
      k_s[t * ldk + d] = valid ? to_float(k_pool[off]) : 0.f;
      v_s[t * dh + d] = valid ? to_float(v_pool[off]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < G * ps; e += blockDim.x) {
      const int g = e / ps, t = e % ps;
      float s = kNegInf;
      if (j * ps + t < clen) {
        float a = 0.f;
        for (int d = 0; d < dh; ++d) a = fmaf(q_s[g * ldk + d], k_s[t * ldk + d], a);
        s = a * scale;
      }
      p_s[g * ps + t] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += nwarps) {
      float mx = kNegInf;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, p_s[g * ps + t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m2 = fmaxf(m_old, mx);
      const float r = expf(m_old - m2);
      float psum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float p = (j * ps + t < clen) ? expf(p_s[g * ps + t] - m2) : 0.f;
        p_s[g * ps + t] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      __syncwarp();
      for (int d = lane; d < dh; d += 32) {
        float a = 0.f;
        for (int t = 0; t < ps; ++t) a = fmaf(p_s[g * ps + t], v_s[t * dh + d], a);
        acc[g * dh + d] = acc[g * dh + d] * r + a;
      }
      __syncwarp();
      if (lane == 0) {
        m_s[g] = m2;
        l_s[g] = l_s[g] * r + psum;
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < G * dh; e += blockDim.x)
    out[qbase + e] = acc[e] / l_s[e / dh];
}

template <typename T, typename TP>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* k_pool, const void* v_pool,
                   const void* page_table, const void* cache_len, void* out,
                   int B, int H, int KV, int dh, int ps, int max_pages,
                   float scale, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(G) * (dh + 1) + ps * (dh + 1) + ps * dh + G * ps +
       2 * G + G * dh);
  auto kernel = paged_decode_kernel<T, TP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, KV), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const TP*>(k_pool),
      static_cast<const TP*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(cache_len), static_cast<float*>(out), H, KV, dh,
      ps, max_pages, scale);
  return cudaGetLastError();
}

}  // namespace

// q/k_new/v_new share dtype `dtype`; the pools have dtype `pool_dtype`;
// out is fp32 (B, H, dh).
extern "C" int paged_decode_launch(int dtype, int pool_dtype, const void* q,
                                   const void* k_new, const void* v_new,
                                   const void* k_pool, const void* v_pool,
                                   const void* page_table,
                                   const void* cache_len, void* out, int B,
                                   int H, int KV, int dh, int ps,
                                   int max_pages, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kFloat32 && pool_dtype == kFloat32)
    err = launch<float, float>(q, k_new, v_new, k_pool, v_pool, page_table,
                               cache_len, out, B, H, KV, dh, ps, max_pages,
                               scale, st);
  else if (dtype == kBFloat16 && pool_dtype == kFloat32)
    err = launch<__nv_bfloat16, float>(q, k_new, v_new, k_pool, v_pool,
                                       page_table, cache_len, out, B, H, KV,
                                       dh, ps, max_pages, scale, st);
  else if (dtype == kFloat32 && pool_dtype == kBFloat16)
    err = launch<float, __nv_bfloat16>(q, k_new, v_new, k_pool, v_pool,
                                       page_table, cache_len, out, B, H, KV,
                                       dh, ps, max_pages, scale, st);
  else if (dtype == kBFloat16 && pool_dtype == kBFloat16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_new, v_new, k_pool, v_pool, page_table, cache_len, out, B, H, KV,
        dh, ps, max_pages, scale, st);
  return static_cast<int>(err);
}
