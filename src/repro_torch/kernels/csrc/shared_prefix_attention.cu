// Shared-prefix (Hydragen-style) decode attention for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/shared_prefix_attention/
// kernel.py, prefix_attention_kernel (body _prefix_kernel): ONE prefix
// k/v (P,Hkv,Dh), shared by the whole batch, against every query row
// q (B,H,Dh).  The B*G query heads that share a KV head (G = H/Hkv) are
// the rows of one product, so each prefix byte is read once for the batch
// instead of once per row.  A key is masked only where its position is
// < 0: the prefix lies in the past of every decode query.  Outputs: the
// UNNORMALIZED partial acc (B,H,Dh) and its log-sum-exp state m, l (B,H),
// all f32, which the public op (shared_prefix_attention/ops.py) merges
// with the suffix pass; a row with no valid key is pinned to
// (0, NEG_INF, 0).  Logits and the online softmax in f32, masked keys
// contribute p = 0 (repro::online_softmax_rescale, common.cuh).
//
// What bounds it on the H100: bytes.  The prefix K and V are read once,
// 2*P*Hkv*Dh elements; at qwen3-1.7b's width with a 2048-token prefix
// (P=2048, Hkv=8, Dh=128, bf16) that is 8.39 MB, about 2.5 us at 3.35
// TB/s.  The work is 4*B*H*P*Dh FLOPs: 134 MFLOP at B=8, which the
// tensor cores would do in 0.14 us, but this kernel uses the CUDA cores in
// f32 (67 TFLOP/s): 2.0 us at B=8, 8.0 us at B=32, where the FLOPs become
// the larger term.  Reading the prefix once per row instead, as the paged
// decode kernel does for shared pages, moves B times the bytes (67 MB at
// B=8).
//
// What the design does: the Pallas kernel walks P in order on a grid of
// (Hkv, P blocks), carrying acc, m, l in VMEM scratch; copied onto the
// H100 that gives Hkv = 8 blocks on 132 SMs.  Here P is split across
// blocks instead: a grid of (KV head, P chunk, row tile).  Each block
// stages tiles of 64 keys (32 at Dh=256) of K and V in shared memory as
// f32 with 16-byte loads on neighbouring threads (K rows padded by one
// float so the 32 lanes reading 32 keys hit 32 banks), and reuses each
// tile for all the rows of its tile: 8 warps, each owning 1, 2 or 4 query
// rows (the template argument RPW); lanes split the keys for QK^T and the
// Dh columns for PV.  Each block writes its chunk's partial (acc, m, l)
// to scratch the wrapper allocates; a second small kernel combines the
// chunks of a row with the log-sum-exp rule and applies the empty-row
// pin, so the chunk combine stays in CUDA as it stayed in the Pallas
// kernel's body.  Any P works: the ragged last tile is masked.  No tensor
// cores (wgmma) and no TMA yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;               // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;               // query heads per KV head
constexpr int kMaxRows = 1024;              // B*G query rows per KV head
constexpr int kChunkQuantum = 64;           // a chunk is a multiple of this
constexpr int kMaxChunks = 8192;            // the combine's weights: 32 KB

// keys per shared-memory tile: 64 (two per lane), 32 at Dh=256 (one per
// lane) to keep the tiles of a block under ~100 KB
template <int DH>
__host__ __device__ constexpr int block_keys() {
  return DH == 256 ? 32 : 64;
}

template <int DH, int RPW>
size_t smem_bytes() {
  constexpr int BK = block_keys<DH>();
  return sizeof(float) * ((size_t)kWarps * RPW * DH + (size_t)BK * (DH + 1) +
                          (size_t)BK * DH) +
         sizeof(int) * BK;
}

// One block: KV head hk = blockIdx.x, keys [c*chunk, min((c+1)*chunk, P))
// with c = blockIdx.y, query rows [t*RT, t*RT + RT) of that head with
// t = blockIdx.z (row r = b*G + g is query head hk*G + g of row b).
template <typename T, int DH, int RPW>
__global__ void __launch_bounds__(kThreads, 2)
prefix_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ kpos,
                      float* __restrict__ part_acc,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      int P, int H, int Hkv, int R, int chunk, float scale) {
  constexpr int BK = block_keys<DH>();
  constexpr int KPL = BK / 32;              // keys per lane
  constexpr int DPL = DH / 32;              // output columns per lane
  constexpr int KS = DH + 1;                // padded K row stride
  constexpr int RT = kWarps * RPW;          // rows per block
  constexpr int VEC = 16 / sizeof(T);       // elements per 16-byte load
  constexpr int VPR = DH / VEC;             // 16-byte loads per key row
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                        // [RT][DH]
  float* k_s = q_s + RT * DH;               // [BK][KS]
  float* v_s = k_s + BK * KS;               // [BK][DH]
  int* kp_s = reinterpret_cast<int*>(v_s + BK * DH);  // [BK]

  const int hk = blockIdx.x;
  const int c = blockIdx.y;
  const int row0 = blockIdx.z * RT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int G = H / Hkv;
  const int kbeg = c * chunk;
  const int kend = min(kbeg + chunk, P);

  // the block's query rows, all of a thread's loads issued before any
  // store (rows past R are zeros and are never written back)
  constexpr int QITERS = RT * DH / kThreads;
  static_assert(QITERS * kThreads == RT * DH, "q rows split evenly");
  float qx[QITERS];
#pragma unroll
  for (int u = 0; u < QITERS; ++u) {
    const int i = tid + u * kThreads;
    const int r = row0 + i / DH, d = i % DH;
    qx[u] = r < R ? repro::to_float(q[((size_t)(r / G) * H +
                                       (size_t)hk * G + r % G) * DH + d])
                  : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < QITERS; ++u) q_s[tid + u * kThreads] = qx[u];

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = REPRO_NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int cc = 0; cc < DPL; ++cc) acc[i][cc] = 0.0f;
  }

  // a thread's 16-byte loads of a tile, issued in batches of up to four
  // K and four V loads before any is stored, so they are in flight
  // together
  constexpr int ITERS = BK * VPR / kThreads;
  constexpr int BATCH = ITERS < 4 ? ITERS : 4;
  static_assert(ITERS * kThreads == BK * VPR && ITERS % BATCH == 0,
                "a tile splits evenly over the threads");
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();                        // q loaded / last tile consumed
#pragma unroll
    for (int b0 = 0; b0 < ITERS; b0 += BATCH) {
      uint4 kraw[BATCH], vraw[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = tid + (b0 + u) * kThreads;
        const int kj = k0 + i / VPR;
        kraw[u] = vraw[u] = make_uint4(0u, 0u, 0u, 0u);   // zeros in T
        if (kj < kend) {
          const size_t off = ((size_t)kj * Hkv + hk) * DH + (i % VPR) * VEC;
          kraw[u] = *reinterpret_cast<const uint4*>(k + off);
          vraw[u] = *reinterpret_cast<const uint4*>(v + off);
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = tid + (b0 + u) * kThreads;
        const int j = i / VPR, d0 = (i % VPR) * VEC;
        float kk[VEC], vv[VEC];
        repro::unpack16<T>(kraw[u], kk);
        repro::unpack16<T>(vraw[u], vv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          k_s[j * KS + d0 + e] = kk[e];
          v_s[j * DH + d0 + e] = vv[e];
        }
      }
    }
    for (int j = tid; j < BK; j += kThreads)
      kp_s[j] = k0 + j < kend ? kpos[k0 + j] : -1;
    __syncthreads();

    // QK^T: lane holds keys lane + 32*t of the tile for each of its rows
    float dot[RPW][KPL];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int t = 0; t < KPL; ++t) dot[i][t] = 0.0f;
    const float* qw = q_s + w * RPW * DH;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      float kd[KPL][4];
#pragma unroll
      for (int t = 0; t < KPL; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          kd[t][e] = k_s[(lane + 32 * t) * KS + d + e];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        // the same address on all lanes: one broadcast
        const float4 q4 = *reinterpret_cast<const float4*>(qw + i * DH + d);
        const float qd[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int t = 0; t < KPL; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dot[i][t] = fmaf(qd[e], kd[t][e], dot[i][t]);
      }
    }
    bool ok[KPL];
#pragma unroll
    for (int t = 0; t < KPL; ++t) ok[t] = kp_s[lane + 32 * t] >= 0;

    // online softmax per row, then PV with p broadcast lane by lane
    float p[RPW][KPL];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      float smax = REPRO_NEG_INF;
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        dot[i][t] = ok[t] ? dot[i][t] * scale : REPRO_NEG_INF;
        smax = fmaxf(smax, dot[i][t]);
      }
      const float alpha =
          repro::online_softmax_rescale(m[i], repro::warp_max(smax));
      float psum = 0.0f;
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        p[i][t] = ok[t] ? expf(dot[i][t] - m[i]) : 0.0f;
        psum += p[i][t];
      }
      l[i] = alpha * l[i] + repro::warp_sum(psum);
#pragma unroll
      for (int cc = 0; cc < DPL; ++cc) acc[i][cc] *= alpha;
    }
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
#pragma unroll 4
      for (int jj = 0; jj < 32; ++jj) {
        const int j = 32 * t + jj;
        float pj[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i)
          pj[i] = __shfl_sync(0xffffffffu, p[i][t], jj);
#pragma unroll
        for (int cc = 0; cc < DPL; ++cc) {
          const float vj = v_s[j * DH + lane + 32 * cc];
#pragma unroll
          for (int i = 0; i < RPW; ++i)
            acc[i][cc] = fmaf(pj[i], vj, acc[i][cc]);
        }
      }
    }
  }

  // this chunk's partial, relative to its own max: part[(c,hk,r)]
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row0 + w * RPW + i;
    if (r >= R) continue;
    const size_t prow = ((size_t)c * Hkv + hk) * R + r;
#pragma unroll
    for (int cc = 0; cc < DPL; ++cc)
      part_acc[prow * DH + lane + 32 * cc] = acc[i][cc];
    if (lane == 0) {
      part_m[prow] = m[i];
      part_l[prow] = l[i];
    }
  }
}

// One block per (row r, KV head hk), Dh threads: the chunks' partials of
// the row combined by the log-sum-exp rule (a chunk with no valid key has
// m = NEG_INF, l = 0 and weighs nothing), then the pin of an empty row.
// Warp 0 puts each chunk's weight exp(m_c - m) in shared memory; then
// every thread sums its column with independent loads.
__global__ void prefix_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      float* __restrict__ acc,
                                      float* __restrict__ m_out,
                                      float* __restrict__ l_out,
                                      int n_chunks, int H, int Hkv, int R,
                                      int Dh) {
  extern __shared__ float w_s[];            // [n_chunks]
  __shared__ float ml_s[2];
  const int r = blockIdx.x, hk = blockIdx.y, d = threadIdx.x;
  const size_t stride = (size_t)Hkv * R;    // from one chunk to the next
  const size_t prow0 = (size_t)hk * R + r;
  if (d < 32) {
    float m = REPRO_NEG_INF;
    for (int c = d; c < n_chunks; c += 32)
      m = fmaxf(m, part_m[prow0 + c * stride]);
    m = repro::warp_max(m);
    float l = 0.0f;
    for (int c = d; c < n_chunks; c += 32) {
      const float wc = expf(part_m[prow0 + c * stride] - m);
      w_s[c] = wc;
      l = fmaf(wc, part_l[prow0 + c * stride], l);
    }
    l = repro::warp_sum(l);
    if (d == 0) {
      ml_s[0] = m;
      ml_s[1] = l;
    }
  }
  __syncthreads();
  float a = 0.0f;
#pragma unroll 8
  for (int c = 0; c < n_chunks; ++c)
    a = fmaf(w_s[c], part_acc[(prow0 + c * stride) * Dh + d], a);
  const float m = ml_s[0], l = ml_s[1];
  const int G = H / Hkv;
  const size_t row = (size_t)(r / G) * H + (size_t)hk * G + r % G;
  const bool empty = l == 0.0f;
  acc[row * Dh + d] = empty ? 0.0f : a;     // unnormalized: no division
  if (d == 0) {
    m_out[row] = empty ? REPRO_NEG_INF : m;
    l_out[row] = l;
  }
}

template <typename T, int DH, int RPW>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kpos, float* part_acc, float* part_m,
                   float* part_l, float* acc, float* m, float* l, int B,
                   int P, int H, int Hkv, int chunk, cudaStream_t stream) {
  auto kern = prefix_partial_kernel<T, DH, RPW>;
  const size_t smem = smem_bytes<DH, RPW>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int R = B * (H / Hkv);
  const int n_chunks = (P + chunk - 1) / chunk;
  const int RT = kWarps * RPW;
  const dim3 grid(Hkv, n_chunks, (R + RT - 1) / RT);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kpos, part_acc, part_m, part_l, P, H, Hkv, R,
      chunk, 1.0f / sqrtf((float)DH));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  prefix_combine_kernel<<<dim3(R, Hkv), DH, sizeof(float) * n_chunks,
                          stream>>>(
      part_acc, part_m, part_l, acc, m, l, n_chunks, H, Hkv, R, DH);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t dispatch_rows(const void* q, const void* k, const void* v,
                          const int* kpos, float* part_acc, float* part_m,
                          float* part_l, float* acc, float* m, float* l,
                          int B, int P, int H, int Hkv, int chunk, int rpw,
                          cudaStream_t s) {
  switch (rpw) {
    case 1:
      return launch<T, DH, 1>(q, k, v, kpos, part_acc, part_m, part_l, acc,
                              m, l, B, P, H, Hkv, chunk, s);
    case 2:
      return launch<T, DH, 2>(q, k, v, kpos, part_acc, part_m, part_l, acc,
                              m, l, B, P, H, Hkv, chunk, s);
    case 4:
      return launch<T, DH, 4>(q, k, v, kpos, part_acc, part_m, part_l, acc,
                              m, l, B, P, H, Hkv, chunk, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v,
                        const int* kpos, float* part_acc, float* part_m,
                        float* part_l, float* acc, float* m, float* l, int B,
                        int P, int H, int Hkv, int Dh, int chunk, int rpw,
                        cudaStream_t s) {
  switch (Dh) {
    case 64:
      return dispatch_rows<T, 64>(q, k, v, kpos, part_acc, part_m, part_l,
                                  acc, m, l, B, P, H, Hkv, chunk, rpw, s);
    case 128:
      return dispatch_rows<T, 128>(q, k, v, kpos, part_acc, part_m, part_l,
                                   acc, m, l, B, P, H, Hkv, chunk, rpw, s);
    case 256:
      return dispatch_rows<T, 256>(q, k, v, kpos, part_acc, part_m, part_l,
                                   acc, m, l, B, P, H, Hkv, chunk, rpw, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,Dh), k and v (P,Hkv,Dh) in one dtype: 0 = float32, 1 = bfloat16;
// kpos (P,) int32.  Scratch, allocated by the caller: part_acc
// (n_chunks,Hkv,B*G,Dh), part_m and part_l (n_chunks,Hkv,B*G) f32 with
// n_chunks = ceil(P / chunk).  Outputs acc (B,H,Dh), m and l (B,H) f32.
// chunk is a multiple of 64; rows_per_warp is 1, 2 or 4 (a block holds 8
// warps' rows).  Returns the cudaError_t of the launches (0 = success).
extern "C" int prefix_attention_fwd(const void* q, const void* k,
                                    const void* v, const int* kpos,
                                    float* part_acc, float* part_m,
                                    float* part_l, float* acc, float* m,
                                    float* l, int B, int P, int H, int Hkv,
                                    int Dh, int chunk, int rows_per_warp,
                                    int dtype, void* stream) {
  if (B <= 0 || P <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > kMaxGroup || B * (H / Hkv) > kMaxRows || chunk <= 0 ||
      chunk % kChunkQuantum != 0 ||
      (P + chunk - 1) / chunk > kMaxChunks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dh<float>(q, k, v, kpos, part_acc, part_m, part_l,
                                   acc, m, l, B, P, H, Hkv, Dh, chunk,
                                   rows_per_warp, s);
  if (dtype == 1)
    return (int)dispatch_dh<__nv_bfloat16>(q, k, v, kpos, part_acc, part_m,
                                           part_l, acc, m, l, B, P, H, Hkv,
                                           Dh, chunk, rows_per_warp, s);
  return (int)cudaErrorInvalidValue;
}
