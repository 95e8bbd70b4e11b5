// Paged GQA flash-decode for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the three Pallas TPU kernels of
// repro/kernels/paged_decode_attention/kernel.py:
//   * paged_decode_attention_kernel (single)   -> stage of 1 page
//   * paged_decode_attention_blocked_kernel    -> stage of pages_per_block
//   * fused_paged_decode_attention_kernel      -> append != 0
// One decode query per row b attends over that row's KV pages, read in
// place from the pool (P, page, Hkv, Dh) through page_table[b, i]; token j
// of page i sits at position i*page + j and is valid while <= lengths[b].
// Rows with lengths[b] < 0 are padding: they read nothing, write nothing
// and return out = 0, (m, l) = (NEG_INF, 0).  Outputs: out in q's dtype,
// m and l in f32 (the log-sum-exp state of kernels/common.py).
//
// What bounds it on the H100: bytes.  Each live page is read once per
// (row, kv head) and does 4*G*Dh FLOPs per token against 2*Dh pool
// elements: with qwen3's G = 2 query rows per KV head over an f32 pool
// that is 1 FLOP/byte, far under the f32 CUDA-core ridge of 67 TFLOP/s /
// 3.35 TB/s = 20 FLOP/byte, so the kernel runs on the CUDA cores; tensor
// cores would need at least 16 query rows a tile and TF32 for an f32 pool.
// The bound is the live pool bytes over the memory rate (10.2 us for the
// engine's B=8 rows of 65 pages at full width).
//
// What the design does (flash-decoding over pages): a row's pages are
// split into chunks of whole pages across blocks, a grid of (row b, KV
// head, chunk) with four warps each.  The chunk (chunk_pages) is planned
// from the page size and Dh alone (paged_decode_attention/ops.py:
// plan_chunk_pages), never from B, the table's width or the lengths, so a
// row's order of summation does not change with its batch.  A row's
// blocks past its last page exit at once.  A block reads its chunk's page
// ids beside the row's length (the two latencies overlap), then stages its
// pages through a two-stage ring of 16-byte cp.async copies on
// neighbouring threads (one head's slice of a token is contiguous: Dh*4
// bytes in f32, Dh*2 in bf16), so one stage's loads are in flight while
// the other is computed; only pages at or below the row's last page are
// read.  The ring is two stages of at most 16 KB, not deeper: on the
// engine's shape that keeps five blocks an SM and the grid in one wave,
// which measured faster than three or four stages.  QK^T runs on groups
// of up to 8 lanes per key that split Dh (one 16-byte vector each), two
// query rows at a time, and sums by shuffles; one warp per query row then
// forms each page's max, each p and each page's sum once and leaves p in
// shared memory; PV runs one thread per (row, 16-byte column vector)
// reading p.  With one chunk in the grid the block writes out, m and l;
// with more it writes its chunk's unnormalised partial (acc, m, l) to
// scratch the wrapper allocates (one f32 allocation with m, l and the
// tickets), and the last of a (row, head)'s blocks to finish, by an
// atomic ticket, merges the row's chunks by log-sum-exp, counting only
// the row's own chunks from lengths[b]; no second launch.
//
// Bitwise contract: every (query row, key) logit, every page's max and
// sum and every p are formed by the same code whatever the stage size is,
// and within a chunk the online-softmax update runs page by page in page
// order; the merge takes chunks in chunk order, never arrival order, so
// the bits do not depend on scheduling.  So single (stages of 1 page) and
// blocked (stages of pages_per_block pages) give identical bits, and a row
// gives the same bits alone and in any batch (a row with one chunk merges
// to acc / l exactly, as the direct path writes it).  With append each
// (row, head) block whose chunk holds page lengths[b] / page first writes
// its head slice of the new token's K/V into pool[page_table[b, len /
// page], len % page, h, :], then barriers, then stages; no other block
// reads that slot: the engine makes the write page private to row b
// before the step (PagedKVCache.prepare_appends), only this chunk covers
// that page, and blocks of other heads touch other head slices.  The
// fused result therefore equals scatter-then-attend bit for bit.  Pool
// pointers are not __restrict__/read-only: the append variant reads what
// it wrote.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;          // four warps, whatever G is
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;             // the copy ring
constexpr int kMaxGroup = 16;          // query heads per KV head
constexpr int kMaxChunks = 65535;      // the grid's third dimension

template <typename TP, int DH>
struct Shape {
  static constexpr int VEC = 16 / sizeof(TP);     // elements per vector
  static constexpr int NV = DH / VEC;             // vectors per head slice
  static constexpr int L = NV < 8 ? NV : 8;       // lanes per key in QK^T
  static constexpr int VPL = NV / L;              // vectors per lane
  static constexpr int KPW = 32 / L;              // keys per warp per pass
  // (row, vector) pairs of PV per thread, at most
  static constexpr int PPT = (kMaxGroup * NV + kThreads - 1) / kThreads;
};

// keys of a chunk, rounded up to even so that the 8-byte row offsets
// keep the floats after them 16-byte aligned
__host__ __device__ __forceinline__ int chunk_slots(int cp, int ps) {
  return (cp * ps + 1) & ~1;
}

size_t smem_bytes(int elem, int Dh, int G, int ps, int sp, int cp) {
  const size_t sk = (size_t)sp * ps;
  return (size_t)kStages * 2 * sk * Dh * elem +
         sizeof(long long) * (size_t)chunk_slots(cp, ps) +
         sizeof(float) * ((size_t)G * Dh + G * sk + (size_t)G * sp + 2 * G) +
         sizeof(int) * (size_t)cp;
}

// Pages holding positions <= len, 0 for a padding row.
__device__ __forceinline__ int live_pages(int len, int ps, int n_pages) {
  return len < 0 ? 0 : min(len / ps + 1, n_pages);
}

// One block: row b = blockIdx.x, KV head h = blockIdx.y, pages
// [c*chunk_pages, (c+1)*chunk_pages) of the row with c = blockIdx.z,
// staged stage_pages at a time.
template <typename TP, int DH>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const void* __restrict__ q, int q_bf16, TP* k_pages,
                   TP* v_pages, const int* __restrict__ page_table,
                   const int* __restrict__ lengths,
                   const TP* __restrict__ k_new, const TP* __restrict__ v_new,
                   int append, void* __restrict__ out,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   float* __restrict__ part, int* __restrict__ tickets,
                   int H, int Hkv, int ps, int n_pages, int chunk_pages,
                   int stage_pages, float scale) {
  using S = Shape<TP, DH>;
  constexpr int VEC = S::VEC, NV = S::NV, L = S::L, VPL = S::VPL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / Hkv;
  const int SK = stage_pages * ps;                     // keys a stage holds
  TP* ring = reinterpret_cast<TP*>(smem_raw);          // [kStages][2][SK][DH]
  // each key slot's element offset in the pool: [chunk_pages * ps]
  long long* off_s =
      reinterpret_cast<long long*>(ring + (size_t)kStages * 2 * SK * DH);
  float* q_s = reinterpret_cast<float*>(off_s + chunk_slots(chunk_pages, ps));
  float* s_s = q_s + G * DH;                           // [G][SK] logits, p
  float* a_s = s_s + G * SK;                           // [G][stage_pages]
  float* m_s = a_s + G * stage_pages;                  // [G]
  float* l_s = m_s + G;                                // [G]
  int* pid_s = reinterpret_cast<int*>(l_s + G);        // [chunk_pages]
  __shared__ int last_s;

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int c = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pg0 = c * chunk_pages;
  const int* pt = page_table + (size_t)b * n_pages;
  // the chunk's page ids are read beside the length: their addresses do
  // not depend on it, so the two reads' latencies overlap
  const int len = lengths[b];
  for (int i = tid; i < chunk_pages; i += kThreads)
    pid_s[i] = pg0 + i < n_pages ? pt[pg0 + i] : 0;
  const int np_b = live_pages(len, ps, n_pages);
  const int nc_b = (np_b + chunk_pages - 1) / chunk_pages;
  if (n_split > 1 && c >= nc_b) {
    // past the row's last page: nothing to read or write; chunk 0 of a
    // padding row pins its output (out 0, m NEG_INF, l 0)
    if (c == 0) {
      const size_t row0 = (size_t)b * H + (size_t)h * G;
      for (int i = tid; i < G * DH; i += kThreads) {
        if (q_bf16)
          static_cast<__nv_bfloat16*>(out)[row0 * DH + i] =
              __float2bfloat16(0.0f);
        else
          static_cast<float*>(out)[row0 * DH + i] = 0.0f;
      }
      if (tid < G) {
        m_out[row0 + tid] = REPRO_NEG_INF;
        l_out[row0 + tid] = 0.0f;
      }
    }
    return;
  }
  const int n_pg = max(0, min(np_b, pg0 + chunk_pages) - pg0);

  if (append && len >= 0 && len / ps < n_pages &&
      (len / ps) / chunk_pages == c) {
    // gated, never clamped: a padding row writes nothing
    const size_t dst = (((size_t)pt[len / ps] * ps + len % ps) * Hkv + h) * DH;
    const size_t src = ((size_t)b * Hkv + h) * DH;
    for (int x = tid; x < NV; x += kThreads) {
      reinterpret_cast<uint4*>(k_pages + dst)[x] =
          reinterpret_cast<const uint4*>(k_new + src)[x];
      reinterpret_cast<uint4*>(v_pages + dst)[x] =
          reinterpret_cast<const uint4*>(v_new + src)[x];
    }
  }
  // query heads h*G .. h*G+G-1 of row b are contiguous
  const size_t q0 = ((size_t)b * H + (size_t)h * G) * DH;
  for (int i = tid; i < G * DH; i += kThreads)
    q_s[i] = q_bf16
                 ? __bfloat162float(
                       static_cast<const __nv_bfloat16*>(q)[q0 + i])
                 : static_cast<const float*>(q)[q0 + i];
  if (tid < G) {
    m_s[tid] = REPRO_NEG_INF;
    l_s[tid] = 0.0f;
  }
  __syncthreads();          // the append, q and the page ids are in place
  for (int r = tid; r < n_pg * ps; r += kThreads)
    off_s[r] = (((long long)pid_s[r / ps] * ps + r % ps) * Hkv + h) * DH;
  __syncthreads();

  const int n_st = (n_pg + stage_pages - 1) / stage_pages;
  // lanes a page takes in the softmax: the power of two at or above the
  // page size, at most 32
  int W = 1;
  while (W < ps && W < 32) W <<= 1;
  // stage st of the chunk into ring slot st % kStages; one commit group a
  // stage, empty past the end, so the wait count stays fixed
  auto load_stage = [&](int st) {
    if (st < n_st) {
      TP* kb = ring + (size_t)(st % kStages) * 2 * SK * DH;
      TP* vb = kb + (size_t)SK * DH;
      const long long* off = off_s + st * SK;
      const int n = min(stage_pages, n_pg - st * stage_pages) * ps * NV;
      for (int i = tid; i < n; i += kThreads) {
        const int r = i / NV, x = i % NV;
        repro::cp_async16(kb + r * DH + x * VEC, k_pages + off[r] + x * VEC);
        repro::cp_async16(vb + r * DH + x * VEC, v_pages + off[r] + x * VEC);
      }
    }
    repro::cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) load_stage(st);

  float acc[S::PPT][VEC];
#pragma unroll
  for (int j = 0; j < S::PPT; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.0f;

  for (int st = 0; st < n_st; ++st) {
    repro::cp_async_wait<kStages - 2>();
    __syncthreads();        // stage st landed; stage st-1 fully consumed
    load_stage(st + kStages - 1);
    const TP* kb = ring + (size_t)(st % kStages) * 2 * SK * DH;
    const TP* vb = kb + (size_t)SK * DH;
    const int p_lo = pg0 + st * stage_pages;       // the row's page index
    const int np = min(stage_pages, pg0 + n_pg - p_lo);
    // positions p_lo*ps + r run on without gaps: keys r < nk are valid
    const int nk = min(np * ps, len - p_lo * ps + 1);

    // logits: a group of L lanes per key, each lane VPL vectors of Dh
    for (int r0 = warp * S::KPW; r0 < nk; r0 += kWarps * S::KPW) {
      const int r = r0 + lane / L, lig = lane % L;
      const bool act = r < nk;
      float kf[VPL][VEC];
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        if (act) {
          repro::unpack16<TP>(*reinterpret_cast<const uint4*>(
                                  kb + r * DH + (lig + u * L) * VEC),
                              kf[u]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kf[u][e] = 0.0f;
        }
      }
      // two rows at a time (an odd G repeats its last row), their lane
      // sums together, so the two shuffle chains overlap; a loop, not an
      // unrolled bound of kMaxGroup rows, so G = 2 issues one pass
      for (int g0 = 0; g0 < G; g0 += 2) {
        const int g1 = min(g0 + 1, G - 1);
        float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          const float* q0v = q_s + g0 * DH + (lig + u * L) * VEC;
          const float* q1v = q_s + g1 * DH + (lig + u * L) * VEC;
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 a4 = *reinterpret_cast<const float4*>(q0v + e);
            const float4 b4 = *reinterpret_cast<const float4*>(q1v + e);
            d0 = fmaf(a4.x, kf[u][e], d0);
            d1 = fmaf(b4.x, kf[u][e], d1);
            d0 = fmaf(a4.y, kf[u][e + 1], d0);
            d1 = fmaf(b4.y, kf[u][e + 1], d1);
            d0 = fmaf(a4.z, kf[u][e + 2], d0);
            d1 = fmaf(b4.z, kf[u][e + 2], d1);
            d0 = fmaf(a4.w, kf[u][e + 3], d0);
            d1 = fmaf(b4.w, kf[u][e + 3], d1);
          }
        }
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1) {
          d0 += __shfl_xor_sync(0xffffffffu, d0, off);
          d1 += __shfl_xor_sync(0xffffffffu, d1, off);
        }
        if (act && lig == 0) {
          s_s[g0 * SK + r] = d0 * scale;
          s_s[g1 * SK + r] = d1 * scale;
        }
      }
    }
    __syncthreads();

    // the online-softmax update, page by page in page order: warp w owns
    // rows w, w+4, ...  A window of the warp holds 32 / W whole pages, W
    // lanes a page (the power of two at or above the page size, at most
    // 32; lanes stride a longer page by 32): each page's max by a
    // shuffle tree over its lanes, the running max after each page by a
    // prefix max over the window (max is exact in any order), each p once,
    // each page's sum by a shuffle tree over its lanes, then l page by
    // page.  A page's numbers do not depend on the window it sits in, and
    // a slot past the stage's last page leaves m and l as they are
    // (alpha = 1, sum = 0), so any stage size gives the same bits.
    for (int g = warp; g < G; g += kWarps) {
      float m = m_s[g], l = l_s[g];
      float* srow = s_s + g * SK;
      for (int i0 = 0; i0 < np; i0 += 32 / W) {
        const int i = i0 + lane / W, jl = lane % W, j0 = i * ps;
        const int jn = i < np ? min(ps, nk - j0) : 0;
        float mx = -INFINITY;
        for (int j = jl; j < jn; j += W) mx = fmaxf(mx, srow[j0 + j]);
        for (int off = W / 2; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float mi = fmaxf(m, mx);           // m after page i
        for (int off = W; off < 32; off <<= 1) {
          const float o = __shfl_up_sync(0xffffffffu, mi, off);
          if (lane >= off) mi = fmaxf(mi, o);
        }
        float mp = __shfl_up_sync(0xffffffffu, mi, W);   // before page i
        if (lane < W) mp = m;
        const float alpha = expf(mp - mi);
        float psum = 0.0f;
        for (int j = jl; j < jn; j += W) {
          const float p = expf(srow[j0 + j] - mi);
          srow[j0 + j] = p;
          psum += p;
        }
        for (int off = W / 2; off > 0; off >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        for (int k = 0; k < 32; k += W)
          l = __shfl_sync(0xffffffffu, alpha, k) * l +
              __shfl_sync(0xffffffffu, psum, k);
        if (jl == 0 && i < np) a_s[g * stage_pages + i] = alpha;
        m = __shfl_sync(0xffffffffu, mi, 31);
      }
      if (lane == 0) {
        m_s[g] = m;
        l_s[g] = l;
      }
    }
    __syncthreads();

    // PV: one thread per (row, 16-byte column vector), page by page
#pragma unroll
    for (int j = 0; j < S::PPT; ++j) {
      const int e = tid + j * kThreads;
      if (e < G * NV) {
        const int g = e / NV, x = e % NV;
        const float* prow = s_s + g * SK;
        for (int i = 0; i < np; ++i) {
          const float alpha = a_s[g * stage_pages + i];
#pragma unroll
          for (int w = 0; w < VEC; ++w) acc[j][w] *= alpha;
          const int j0 = i * ps, jn = min(ps, nk - j0);
          for (int r = j0; r < j0 + jn; ++r) {
            const float p = prow[r];
            float vf[VEC];
            repro::unpack16<TP>(
                *reinterpret_cast<const uint4*>(vb + r * DH + x * VEC), vf);
#pragma unroll
            for (int w = 0; w < VEC; ++w)
              acc[j][w] = fmaf(p, vf[w], acc[j][w]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < S::PPT; ++j) {
    const int e = tid + j * kThreads;
    if (e >= G * NV) continue;
    const int g = e / NV, x = e % NV;
    const size_t row = (size_t)b * H + (size_t)h * G + g;
    const float m = m_s[g], l = l_s[g];
    if (n_split == 1) {
      const bool empty = l == 0.0f;
#pragma unroll
      for (int w = 0; w < VEC; ++w) {
        const float o = empty ? 0.0f : acc[j][w] / l;
        const size_t at = row * DH + x * VEC + w;
        if (q_bf16)
          static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(o);
        else
          static_cast<float*>(out)[at] = o;
      }
      if (x == 0) {
        m_out[row] = empty ? REPRO_NEG_INF : m;
        l_out[row] = l;
      }
    } else {
      // scratch: part_acc (B*H, n_split, DH), then part_m, part_l
      float* pa = part + (row * n_split + c) * DH + x * VEC;
#pragma unroll
      for (int w = 0; w < VEC; w += 4)
        *reinterpret_cast<float4*>(pa + w) = make_float4(
            acc[j][w], acc[j][w + 1], acc[j][w + 2], acc[j][w + 3]);
      if (x == 0) {
        const size_t n_rows = (size_t)gridDim.x * H;
        float* part_m = part + n_rows * n_split * DH;
        part_m[row * n_split + c] = m;
        part_m[n_rows * n_split + row * n_split + c] = l;
      }
    }
  }
  if (n_split == 1) return;

  // the last of the row's chunks to finish, by an atomic ticket, merges
  // them; the merge takes the chunks in chunk order, never arrival order
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_s = atomicAdd(tickets + (size_t)b * Hkv + h, 1) == nc_b - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const size_t n_rows = (size_t)gridDim.x * H;
#pragma unroll
  for (int j = 0; j < S::PPT; ++j) {
    const int e = tid + j * kThreads;
    if (e >= G * NV) continue;
    const int g = e / NV, x = e % NV;
    const size_t row = (size_t)b * H + (size_t)h * G + g;
    const float* pm = part + n_rows * n_split * DH + row * n_split;
    const float* pl = pm + n_rows * n_split;
    const float* pa = part + row * n_split * DH + x * VEC;
    float m = REPRO_NEG_INF;
#pragma unroll 8
    for (int i = 0; i < nc_b; ++i) m = fmaxf(m, __ldcg(pm + i));
    float l = 0.0f, o[VEC];
#pragma unroll
    for (int w = 0; w < VEC; ++w) o[w] = 0.0f;
#pragma unroll 8
    for (int i = 0; i < nc_b; ++i) {
      const float wi = expf(__ldcg(pm + i) - m);
      l = fmaf(wi, __ldcg(pl + i), l);
#pragma unroll
      for (int w = 0; w < VEC; w += 4) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(
            pa + (size_t)i * DH + w));
        o[w] = fmaf(wi, v.x, o[w]);
        o[w + 1] = fmaf(wi, v.y, o[w + 1]);
        o[w + 2] = fmaf(wi, v.z, o[w + 2]);
        o[w + 3] = fmaf(wi, v.w, o[w + 3]);
      }
    }
#pragma unroll
    for (int w = 0; w < VEC; ++w) {
      const size_t at = row * DH + x * VEC + w;
      if (q_bf16)
        static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(o[w] / l);
      else
        static_cast<float*>(out)[at] = o[w] / l;
    }
    if (x == 0) {
      m_out[row] = m;
      l_out[row] = l;
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
  float* part;
  int B, H, Hkv, ps, n_pages, chunk_pages, stage_pages, append, q_bf16;
  cudaStream_t stream;
};

template <typename TP, int DH>
cudaError_t launch(const Args& a) {
  auto kern = paged_split_kernel<TP, DH>;
  const size_t smem = smem_bytes(sizeof(TP), DH, a.H / a.Hkv, a.ps,
                                 a.stage_pages, a.chunk_pages);
  static size_t allowed[8] = {0};
  cudaError_t e = repro::allow_smem(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  const int n_split = (a.n_pages + a.chunk_pages - 1) / a.chunk_pages;
  if (n_split > kMaxChunks || (n_split > 1 && a.part == nullptr))
    return cudaErrorInvalidValue;
  // scratch past the partials: one ticket per (row, KV head), zeroed here
  int* tickets = nullptr;
  if (n_split > 1) {
    tickets = reinterpret_cast<int*>(a.part + (size_t)a.B * a.H * n_split *
                                                  (DH + 2));
    e = cudaMemsetAsync(tickets, 0, sizeof(int) * a.B * a.Hkv, a.stream);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(a.B, a.Hkv, n_split);
  kern<<<grid, kThreads, smem, a.stream>>>(
      a.q, a.q_bf16, static_cast<TP*>(a.k_pages), static_cast<TP*>(a.v_pages),
      a.page_table, a.lengths, static_cast<const TP*>(a.k_new),
      static_cast<const TP*>(a.v_new), a.append, a.out, a.m, a.l, a.part,
      tickets, a.H, a.Hkv, a.ps, a.n_pages, a.chunk_pages, a.stage_pages,
      1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

template <typename TP>
cudaError_t dispatch_dh(const Args& a, int Dh) {
  switch (Dh) {
    case 8: return launch<TP, 8>(a);
    case 16: return launch<TP, 16>(a);
    case 32: return launch<TP, 32>(a);
    case 64: return launch<TP, 64>(a);
    case 128: return launch<TP, 128>(a);
    case 256: return launch<TP, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype / pool_dtype: 0 = float32, 1 = bfloat16.  k_new/v_new (B,Hkv,Dh)
// are read only when append != 0 and are in the pool's dtype.
// chunk_pages: pages per block; stage_pages: pages per stage of the copy
// ring.  part: float32 scratch of B*H*n_split*(Dh+2) + B*Hkv values when
// the table holds more than one chunk (n_split = ceil(n_pages /
// chunk_pages)), else unused (may be null).  The pools, k_new and v_new
// must be 16-byte aligned.  Returns the cudaError_t of the launch and of
// the tickets' memset (0 = success).
extern "C" int paged_decode_attention_fwd(
    const void* q, void* k_pages, void* v_pages, const int* page_table,
    const int* lengths, const void* k_new, const void* v_new, void* out,
    float* m, float* l, float* part, int B, int H, int Hkv, int Dh, int ps,
    int n_pages, int chunk_pages, int stage_pages, int append, int q_dtype,
    int pool_dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxGroup || ps <= 0 ||
      n_pages <= 0 || chunk_pages <= 0 || stage_pages <= 0 ||
      stage_pages > chunk_pages || (q_dtype != 0 && q_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{q,       k_pages,     v_pages,     page_table,
               lengths, k_new,       v_new,       out,
               m,       l,           part,        B,
               H,       Hkv,         ps,          n_pages,
               chunk_pages, stage_pages, append,  q_dtype,
               static_cast<cudaStream_t>(stream)};
  if (pool_dtype == 0) return (int)dispatch_dh<float>(a, Dh);
  if (pool_dtype == 1) return (int)dispatch_dh<__nv_bfloat16>(a, Dh);
  return (int)cudaErrorInvalidValue;
}
