// Paged GQA flash-decode for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the three Pallas TPU kernels of
// repro/kernels/paged_decode_attention/kernel.py:
//   * paged_decode_attention_kernel (single)   -> PPB = 1
//   * paged_decode_attention_blocked_kernel    -> PPB = pages_per_block
//   * fused_paged_decode_attention_kernel      -> APPEND = true
// One decode query per row b attends over that row's KV pages, read in
// place from the pool (P, page, Hkv, Dh) through page_table[b, i]; token j
// of page i sits at position i*page + j and is valid while <= lengths[b].
// Rows with lengths[b] < 0 are padding: they read nothing, write nothing
// and return out = 0, (m, l) = (NEG_INF, 0).  Outputs: out in q's dtype,
// m and l in f32 (the log-sum-exp state of kernels/common.py).
//
// What bounds it on the H100: bytes.  Each live page is read once per
// (row, kv head) and does 4*G*Dh FLOPs per token against 2*Dh pool
// elements (f32 on the engine's path), about 1 FLOP/byte, so the bound is
// the pool bytes over the 3.35 TB/s memory rate (~10 us for the engine's
// B=8, 65 pages a row, at full width).  What the design does: the pool is
// read straight from its storage dtype (f32 or bf16) with no cast pass
// and no dense gather; one block per (row, kv head) covers the G query
// heads that share those pages, so every page byte is read once; PPB
// pages are staged in shared memory per iteration.  Rows stop at their
// own last page (early-out).  This first version walks a row's pages in
// one block, so a launch has only B*Hkv blocks; splitting a row's pages
// across blocks (flash-decoding) is later work (PERF.md).
//
// Bitwise contract: every (query row, key) logit is formed by the same
// code whatever PPB is, and the online-softmax update runs page by page
// in page order, so PPB = 1 and PPB > 1 give identical bits.  With APPEND
// each block first writes its own head slice of the new token's K/V into
// pool[page_table[b, len / page], len % page, h, :] and then syncs, so the
// block's reads see the write.  No other block reads that slot: the
// engine makes the write page private to row b before the step
// (PagedKVCache.prepare_appends), and blocks of other heads touch other
// head slices.  The fused result therefore equals scatter-then-attend bit
// for bit.  Pool pointers are not __restrict__/read-only: the APPEND
// variant reads what it wrote.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPairs = 4;          // (query row, column) pairs per thread

size_t smem_bytes(int G, int Dh, int ps, int ppb) {
  return sizeof(float) *
         ((size_t)G * Dh + 2 * (size_t)ppb * ps * Dh + (size_t)G * ppb * ps);
}

template <typename TQ, typename TP, int PPB, bool APPEND>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, TP* k_pages, TP* v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths,
                    const TP* __restrict__ k_new, const TP* __restrict__ v_new,
                    TQ* __restrict__ out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int H, int Hkv, int Dh, int ps,
                    int n_pages, float scale) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int nkeys = PPB * ps;
  float* q_s = smem;                              // [G][Dh]
  float* k_s = q_s + G * Dh;                      // [PPB*ps][Dh]
  float* v_s = k_s + nkeys * Dh;                  // [PPB*ps][Dh]
  float* s_s = v_s + nkeys * Dh;                  // [G][PPB*ps]

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = lengths[b];
  const int* pt = page_table + (size_t)b * n_pages;
  // pages holding positions <= len (the per-row early-out); 0 for padding
  const int np_b = len < 0 ? 0 : min(len / ps + 1, n_pages);

  if (APPEND && len >= 0 && len / ps < n_pages) {
    // gated, never clamped: a padding row writes nothing
    const size_t dst = (((size_t)pt[len / ps] * ps + len % ps) * Hkv + h) * Dh;
    const size_t src = ((size_t)b * Hkv + h) * Dh;
    for (int d = tid; d < Dh; d += kThreads) {
      k_pages[dst + d] = k_new[src + d];
      v_pages[dst + d] = v_new[src + d];
    }
  }
  // query heads h*G .. h*G+G-1 of row b are contiguous
  for (int i = tid; i < G * Dh; i += kThreads)
    q_s[i] = repro::to_float(q[((size_t)b * H + (size_t)h * G) * Dh + i]);

  float acc[kMaxPairs], m[kMaxPairs], l[kMaxPairs];
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    acc[p] = 0.0f;
    m[p] = REPRO_NEG_INF;
    l[p] = 0.0f;
  }

  for (int i0 = 0; i0 < np_b; i0 += PPB) {
    __syncthreads();        // the append and the last iteration are done
    for (int e = tid; e < nkeys * Dh; e += kThreads) {
      const int key = e / Dh, d = e % Dh, pi = i0 + key / ps;
      if (pi < np_b) {
        const size_t off =
            (((size_t)pt[pi] * ps + key % ps) * Hkv + h) * Dh + d;
        k_s[e] = repro::to_float(k_pages[off]);
        v_s[e] = repro::to_float(v_pages[off]);
      }
    }
    __syncthreads();
    // logits: one warp per (query row, key) dot product
    for (int t = warp; t < G * nkeys; t += kWarps) {
      const int g = t / nkeys, key = t % nkeys, pi = i0 + key / ps;
      if (pi >= np_b) continue;                 // warp-uniform
      float part = 0.0f;
      for (int d = lane; d < Dh; d += 32)
        part = fmaf(q_s[g * Dh + d], k_s[key * Dh + d], part);
      part = repro::warp_sum(part);
      if (lane == 0) {
        const int pos = pi * ps + key % ps;
        s_s[g * nkeys + key] = pos <= len ? part * scale : REPRO_NEG_INF;
      }
    }
    __syncthreads();
    // the online-softmax update, one page at a time in page order
    for (int jj = 0; jj < PPB; ++jj) {
      const int pi = i0 + jj;
      if (pi >= np_b) break;
#pragma unroll
      for (int p = 0; p < kMaxPairs; ++p) {
        const int idx = tid + p * kThreads;
        if (idx >= G * Dh) break;
        const int g = idx / Dh, d = idx % Dh;
        const float* srow = s_s + g * nkeys + jj * ps;
        float chunk_max = srow[0];
        for (int j = 1; j < ps; ++j) chunk_max = fmaxf(chunk_max, srow[j]);
        const float alpha = repro::online_softmax_rescale(m[p], chunk_max);
        float psum = 0.0f, pv = 0.0f;
        for (int j = 0; j < ps; ++j) {
          const float pj = pi * ps + j <= len ? expf(srow[j] - m[p]) : 0.0f;
          psum += pj;
          pv = fmaf(pj, v_s[(jj * ps + j) * Dh + d], pv);
        }
        l[p] = alpha * l[p] + psum;
        acc[p] = acc[p] * alpha + pv;
      }
    }
  }

#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    const int idx = tid + p * kThreads;
    if (idx >= G * Dh) break;
    const int g = idx / Dh, d = idx % Dh;
    const size_t row = (size_t)b * H + (size_t)h * G + g;
    float o, m_fin;
    repro::finalize_online_softmax(acc[p], m[p], l[p], &o, &m_fin);
    out[row * Dh + d] = repro::from_float<TQ>(o);
    if (d == 0) {
      m_out[row] = m_fin;
      l_out[row] = l[p];
    }
  }
}

struct Args {
  const void* q;
  void* k_pages;
  void* v_pages;
  const int* page_table;
  const int* lengths;
  const void* k_new;
  const void* v_new;
  void* out;
  float* m;
  float* l;
  int B, H, Hkv, Dh, ps, n_pages;
  cudaStream_t stream;
};

template <typename TQ, typename TP, int PPB, bool APPEND>
cudaError_t launch(const Args& a) {
  auto kern = paged_decode_kernel<TQ, TP, PPB, APPEND>;
  const size_t smem = smem_bytes(a.H / a.Hkv, a.Dh, a.ps, PPB);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(a.B, a.Hkv);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<TP*>(a.k_pages),
      static_cast<TP*>(a.v_pages), a.page_table, a.lengths,
      static_cast<const TP*>(a.k_new), static_cast<const TP*>(a.v_new),
      static_cast<TQ*>(a.out), a.m, a.l, a.H, a.Hkv, a.Dh, a.ps, a.n_pages,
      1.0f / sqrtf((float)a.Dh));
  return cudaGetLastError();
}

template <typename TQ, typename TP, bool APPEND>
cudaError_t dispatch_ppb(const Args& a, int ppb) {
  switch (ppb) {
    case 1: return launch<TQ, TP, 1, APPEND>(a);
    case 2: return launch<TQ, TP, 2, APPEND>(a);
    case 3: return launch<TQ, TP, 3, APPEND>(a);
    case 4: return launch<TQ, TP, 4, APPEND>(a);
    case 8: return launch<TQ, TP, 8, APPEND>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TP>
cudaError_t dispatch_append(const Args& a, int ppb, int append) {
  return append ? dispatch_ppb<TQ, TP, true>(a, ppb)
                : dispatch_ppb<TQ, TP, false>(a, ppb);
}

}  // namespace

// q_dtype / pool_dtype: 0 = float32, 1 = bfloat16.  k_new/v_new (B,Hkv,Dh)
// are read only when append != 0 and are in the pool's dtype.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int paged_decode_attention_fwd(
    const void* q, void* k_pages, void* v_pages, const int* page_table,
    const int* lengths, const void* k_new, const void* v_new, void* out,
    float* m, float* l, int B, int H, int Hkv, int Dh, int ps, int n_pages,
    int ppb, int append, int q_dtype, int pool_dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || ps <= 0 || n_pages <= 0 ||
      (H / Hkv) * Dh > kMaxPairs * kThreads)
    return (int)cudaErrorInvalidValue;
  const Args a{q,       k_pages, v_pages, page_table, lengths, k_new,
               v_new,   out,     m,       l,          B,       H,
               Hkv,     Dh,      ps,      n_pages,
               static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && pool_dtype == 0)
    return (int)dispatch_append<float, float>(a, ppb, append);
  if (q_dtype == 1 && pool_dtype == 0)
    return (int)dispatch_append<__nv_bfloat16, float>(a, ppb, append);
  if (q_dtype == 0 && pool_dtype == 1)
    return (int)dispatch_append<float, __nv_bfloat16>(a, ppb, append);
  if (q_dtype == 1 && pool_dtype == 1)
    return (int)dispatch_append<__nv_bfloat16, __nv_bfloat16>(a, ppb, append);
  return (int)cudaErrorInvalidValue;
}
