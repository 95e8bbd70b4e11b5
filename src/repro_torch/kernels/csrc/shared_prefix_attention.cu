// Shared-prefix (Hydragen-style) decode attention for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/shared_prefix_attention/
// kernel.py, prefix_attention_kernel (body _prefix_kernel): ONE prefix
// k/v (P,Hkv,Dh), shared by the whole batch, against every query row
// q (B,H,Dh).  The B*G query heads that share a KV head (G = H/Hkv) are
// the rows of one product, so each prefix byte is read once for the batch
// instead of once per row.  A key is masked only where its position is
// < 0 (no position array: positions 0..P-1, all visible): the prefix lies
// in the past of every decode query.  The result is the UNNORMALIZED
// partial acc (B,H,Dh) and its log-sum-exp state m, l (B,H), all f32, a
// row with no valid key pinned to (0, NEG_INF, 0); or, given the suffix
// pass's (out_s, m_s, l_s) (decode attention with return_lse), the public
// op's output (B,H,Dh) in q's dtype, merged by the rule of the JAX op
// (shared_prefix_attention/ref.py: merge_prefix_suffix).  Logits and the
// online softmax in f32; masked keys contribute p = 0.
//
// What bounds it on the H100: bytes.  The prefix K and V are read once,
// 2*P*Hkv*Dh elements: at qwen3-1.7b's width with a 2048-token prefix
// (P=2048, Hkv=8, Dh=128, bf16) 8.39 MB, 2.5 us at 3.35 TB/s.  The work,
// 4*B*H*P*Dh FLOPs, is 134 MFLOP at B=8 and 537 at B=32; PV is done three
// times over (below).  On the CUDA cores in f32 (67 TFLOP/s) the same
// work took 2.0 us at B=8 and 8.0 at B=32.
//
// Two bodies, chosen by the wrapper (shared_prefix_attention/ops.py):
//
// * tensor cores (bf16, Dh 64/128/256), namespace tc.  A grid of (KV head,
//   P chunk, row tile of 64) in clusters of kCluster = 8 chunks of one
//   head; the chunk is planned from P, Dh, Hkv and the SM count, never B
//   (ops.py: plan_chunks): whole clusters a head, as many as the card runs
//   at once.  A block holds all the B*G rows of its KV head up to 64 (1, 2
//   or 4 m16 tiles), so each prefix byte is read once while B*G <= 64.
//   QK^T and PV run as mma.sync.m16n8k16 (bf16 in, f32 accumulate) in the
//   FA2 register layout of flash_attention.cu (common.cuh: swz, ldmatrix,
//   mma16816).  K and V stay bf16 in shared memory, XOR-swizzled, and
//   arrive by 16-byte cp.async in a four-stage ring of tiles of 16*KW keys,
//   so a chunk's tiles are in flight together and later tiles load while
//   earlier ones are computed.  In each m16 tile of rows, KW warps (4; 2
//   at Dh=256 to keep a warp's 16x256 f32 accumulator in registers) split
//   every tile's keys, 16 each, and merge their (acc, m, l) by log-sum-exp
//   through shared memory in warp order.  Accuracy: QK^T multiplies bf16
//   values exactly and sums in f32; P goes to PV as a three-term bf16
//   split p = hi + mid + lo (three MMAs into one accumulator), which leaves
//   about 2^-24 p: two terms left 2^-17 p, up to 3.7e-5 in acc at the
//   smoke's shapes, over the 2e-5 limit (tests/test_torch_kernels.py).
//   One launch, and the merges in its last blocks: the 8 chunks of a
//   cluster merge by log-sum-exp in chunk order through distributed
//   shared memory, block `rank` of the cluster taking slice `rank` of the
//   (row, column) values, so no SM reads a whole head's partials (one SM
//   read them at ~25 GB/s, 5 us of a 14 us kernel at B=8).  With one
//   cluster a head that is the result; with more, each slice's cluster
//   partial goes to scratch and the last block of the head's clusters to
//   finish that slice, by an atomic ticket, merges them in cluster order,
//   never arrival order, and resets its ticket for the next launch (no
//   memset).  The result is the partial or, with the suffix, the op's
//   output.  Bits: every row's logits, p and merges run the same
//   instructions whatever B is (mma rows are independent and the plan
//   ignores B), so a row gives the same bits alone and in any batch.
// * CUDA cores (float32), namespace simt: the first version, kept because
//   a tensor-core f32 product is TF32 and would break f32's limit.  A grid
//   of (KV head, P chunk, row tile); 8 warps of 1, 2 or 4 rows reuse each
//   tile of 64 keys (32 at Dh=256) staged as f32; lanes split the keys for
//   QK^T and the Dh columns for PV.  A second small kernel combines the
//   chunks in chunk order, with the same optional suffix merge.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit
// (chip_smoke.py, [kernels.shared_prefix.full], qwen3's width, P=2048):
// the tensor-core body 10.2 us on the card at B=8 and 18.5 at B=32, 4.0x
// and 7.0x the byte bound; the CUDA-core body it replaced for bf16 took
// 20.2 and 39.1 us.  The op (decode attention, then this kernel): 26.1
// and 50.7 us.  PERF.md section 6 has the breakdown.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxGroup = 16;               // query heads per KV head
constexpr int kMaxRows = 1024;              // B*G query rows per KV head
constexpr int kMaxChunks = 8192;            // the combine's weights: 32 KB

// keys a tile holds, and the quantum of a chunk: 64, 32 at Dh=256
__host__ __device__ constexpr int tile_keys(int dh) {
  return dh == 256 ? 32 : 64;
}

// Where a call's result goes: the partial (acc, m, l), or, given the
// suffix's (out_s, m_s, l_s), the op's output in T.  One value at a time:
// row is the query row b*H + h, d its column; (a, m, l) the merged prefix
// partial, pinned here when the row saw no valid key.
template <typename T>
struct Result {
  float* acc;
  float* m;
  float* l;
  const T* out_s;
  const float* m_s;
  const float* l_s;
  T* out;
  int dh;                                   // Dh, the row stride

  __device__ __forceinline__ void put(size_t row, int d, float a, float mp,
                                      float lp) const {
    const bool empty = lp == 0.0f;
    if (out_s == nullptr) {
      acc[row * dh + d] = empty ? 0.0f : a;
      if (d == 0) {
        m[row] = empty ? REPRO_NEG_INF : mp;
        l[row] = lp;
      }
      return;
    }
    // merge_prefix_suffix's arithmetic, each step rounded as torch does
    if (empty) {
      a = 0.0f;
      mp = REPRO_NEG_INF;
    }
    const float os = repro::to_float(out_s[row * dh + d]);
    const float ms = m_s[row], ls = l_s[row];
    const float op = __fdiv_rn(a, empty ? 1.0f : lp);
    const float mm = fmaxf(mp, ms);
    const float wp = __fmul_rn(expf(mp - mm), lp);
    const float ws = __fmul_rn(expf(ms - mm), ls);
    const float den = __fadd_rn(wp, ws);
    out[row * dh + d] = repro::from_float<T>(__fdiv_rn(
        __fadd_rn(__fmul_rn(op, wp), __fmul_rn(os, ws)),
        den == 0.0f ? 1.0f : den));
  }
};

}  // namespace

namespace simt {

constexpr int kThreads = 256;               // 8 warps
constexpr int kWarps = kThreads / 32;

template <int DH, int RPW>
size_t smem_bytes() {
  constexpr int BK = tile_keys(DH);
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
  constexpr int BK = tile_keys(DH);
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
      kp_s[j] = k0 + j >= kend ? -1 : kpos ? kpos[k0 + j] : 0;
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
// the row combined by the log-sum-exp rule in chunk order (a chunk with no
// valid key has m = NEG_INF, l = 0 and weighs nothing), then the result:
// the pinned partial, or the op's output merged with the suffix.  Warp 0
// puts each chunk's weight exp(m_c - m) in shared memory; then every
// thread sums its column with independent loads.
template <typename T>
__global__ void prefix_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      Result<T> res, int n_chunks, int H,
                                      int Hkv, int R, int Dh) {
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
  const int G = H / Hkv;
  res.put((size_t)(r / G) * H + (size_t)hk * G + r % G, d, a, ml_s[0],
          ml_s[1]);
}

template <int DH, int RPW>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* kpos, float* part, Result<float> res, int B,
                   int P, int H, int Hkv, int chunk, cudaStream_t stream) {
  auto kern = prefix_partial_kernel<float, DH, RPW>;
  static size_t allowed[8] = {0};
  cudaError_t e = repro::allow_smem(kern, smem_bytes<DH, RPW>(), allowed);
  if (e != cudaSuccess) return e;
  const int R = B * (H / Hkv);
  const int n_chunks = (P + chunk - 1) / chunk;
  const int RT = kWarps * RPW;
  const size_t n_part = (size_t)n_chunks * Hkv * R;
  float* part_m = part + n_part * DH;
  float* part_l = part_m + n_part;
  const dim3 grid(Hkv, n_chunks, (R + RT - 1) / RT);
  kern<<<grid, kThreads, smem_bytes<DH, RPW>(), stream>>>(
      q, k, v, kpos, part, part_m, part_l, P, H, Hkv, R, chunk,
      1.0f / sqrtf((float)DH));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  prefix_combine_kernel<float><<<dim3(R, Hkv), DH,
                                 sizeof(float) * n_chunks, stream>>>(
      part, part_m, part_l, res, n_chunks, H, Hkv, R, DH);
  return cudaGetLastError();
}

template <int DH>
cudaError_t dispatch_rows(const float* q, const float* k, const float* v,
                          const int* kpos, float* part, Result<float> res,
                          int B, int P, int H, int Hkv, int chunk,
                          cudaStream_t s) {
  // the fewest rows a warp (1, 2, 4) that cover the B*G rows in one tile
  const int R = B * (H / Hkv);
  if (R <= kWarps) return launch<DH, 1>(q, k, v, kpos, part, res, B, P, H,
                                        Hkv, chunk, s);
  if (R <= 2 * kWarps) return launch<DH, 2>(q, k, v, kpos, part, res, B, P,
                                            H, Hkv, chunk, s);
  return launch<DH, 4>(q, k, v, kpos, part, res, B, P, H, Hkv, chunk, s);
}

}  // namespace simt

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kStages = 4;                  // the copy ring, in tiles
constexpr int kRowTile = 64;                // rows a block holds, at most
constexpr int kCluster = 8;                 // chunks merged in a cluster

// warps that split a tile's keys, 16 each: 4, and 2 at Dh=256 (a warp's
// 16x256 f32 accumulator is 128 registers a thread)
template <int DH>
__host__ __device__ constexpr int key_warps() {
  return DH == 256 ? 2 : 4;
}

template <int DH, int MT>
struct Shape {
  static constexpr int KW = key_warps<DH>();
  static constexpr int BN = 16 * KW;        // keys a tile
  static_assert(BN == tile_keys(DH), "the tile is the chunk's quantum");
  static constexpr int NT = 32 * KW * MT;   // threads
  static constexpr int RT = 16 * MT;        // rows a block
  static_assert(RT <= kRowTile, "at most four m16 tiles of rows");
  static constexpr int OS = DH + 8;         // padded f32 row of the merge
  static constexpr size_t Q_BYTES = sizeof(bf16) * RT * DH;
  static constexpr size_t RING = sizeof(bf16) * kStages * 2 * BN * DH;
  static constexpr size_t MERGE = sizeof(float) * MT * KW * 16 * OS;
  static constexpr size_t BIG = RING > MERGE ? RING : MERGE;
  static constexpr size_t SMEM = Q_BYTES + BIG + sizeof(int) * kStages * BN +
                                 sizeof(float) * MT * KW * 2 * 16;
};

// p as three bf16 terms, hi + mid + lo, for a pair of neighbouring
// columns: each term is the bf16 rounding of what the ones before it
// leave, so the sum misses p by about 2^-24 p
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 md = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(md);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&md);
  lo = repro::pack_bf16(r0 - mf.x, r1 - mf.y);
}

// One block: KV head hk = blockIdx.x, keys [c*chunk, min((c+1)*chunk, P))
// with c = blockIdx.y, query rows [t*RT, t*RT + RT) of that head with
// t = blockIdx.z.  Warp w owns the m16 tile w / KW of rows and keys
// [16*(w % KW), 16*(w % KW) + 16) of every tile.
template <int DH, int MT>
__global__ void __cluster_dims__(1, kCluster, 1)
    __launch_bounds__(Shape<DH, MT>::NT, 1)
    prefix_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const int* __restrict__ kpos, float* __restrict__ part,
                     int* __restrict__ tickets, Result<bf16> res, int P,
                     int H, int Hkv, int R, int chunk, float scale) {
  using S = Shape<DH, MT>;
  constexpr int KW = S::KW, BN = S::BN, NT = S::NT, RT = S::RT, OS = S::OS;
  constexpr int CH = DH / 8;                // 16-byte chunks in a row
  constexpr int DB = DH / 8;                // 8-wide column blocks of O
  constexpr int C4 = DH / 4;                // 4-wide columns of the merges
  constexpr int ITEMS = RT * C4 / NT;       // (row, 4 columns) a thread
  static_assert(ITEMS * NT == RT * C4, "the merges split evenly");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);      // [RT][DH]
  bf16* ring = q_s + RT * DH;                          // [stage][K|V][BN][DH]
  float* o_x = reinterpret_cast<float*>(ring);         // [MT][KW][16][OS]
  int* kp_s = reinterpret_cast<int*>(smem_raw + S::Q_BYTES + S::BIG);
  float* ml_x = reinterpret_cast<float*>(kp_s + kStages * BN);  // [MT][KW][2][16]
  __shared__ int last_s;

  const int hk = blockIdx.x;
  const int c = blockIdx.y;
  const int row0 = blockIdx.z * RT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mt = warp / KW;                 // this warp's m16 tile
  const int kt = (warp % KW) * 16;          // its keys in every tile
  const int g = lane >> 2;                  // row in the 8-row half
  const int t4 = lane & 3;                  // column pair in the block
  const int G = H / Hkv;
  const int kbeg = c * chunk;
  const int kend = min(kbeg + chunk, P);
  const int n_tiles = max(0, (kend - kbeg + BN - 1) / BN);

  // the block's query rows (row r = b*G + gg is query head hk*G + gg of
  // row b); rows past R are zeros and are never written back
  for (int i = tid; i < RT * CH; i += NT) {
    const int rr = i / CH, cc = i % CH, r = row0 + rr;
    const bool ok = r < R;
    const size_t qrow = ok ? (size_t)(r / G) * H + (size_t)hk * G + r % G
                           : 0;
    repro::cp_async16(q_s + repro::swz<DH>(rr, cc), q + qrow * DH + cc * 8,
                      ok);
  }
  auto load_tile = [&](int i, int st) {
    const int k0 = kbeg + i * BN;
    bf16* kd = ring + st * 2 * BN * DH;
    bf16* vd = kd + BN * DH;
#pragma unroll 4
    for (int x = tid; x < BN * CH; x += NT) {
      const int r = x / CH, cc = x % CH, kj = k0 + r;
      const bool ok = kj < kend;
      const size_t off = ((size_t)(ok ? kj : 0) * Hkv + hk) * DH + cc * 8;
      repro::cp_async16(kd + repro::swz<DH>(r, cc), k + off, ok);
      repro::cp_async16(vd + repro::swz<DH>(r, cc), v + off, ok);
    }
    if (kpos != nullptr && tid < BN) {
      const int kj = k0 + tid;
      repro::cp_async4(kp_s + st * BN + tid, kpos + (kj < kend ? kj : 0),
                       kj < kend);
    }
  };
  // the first kStages - 1 tiles in flight (q joins the first group)
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    repro::cp_async_commit();
  }

  float o[DB][4], m[2], l[2];
#pragma unroll
  for (int db = 0; db < DB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[db][e] = 0.0f;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    m[hr] = REPRO_NEG_INF;
    l[hr] = 0.0f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    // the stage tile i - 1 used is free (the barrier closing it): refill
    if (i + kStages - 1 < n_tiles)
      load_tile(i + kStages - 1, (i + kStages - 1) % kStages);
    repro::cp_async_commit();
    repro::cp_async_wait<kStages - 1>();    // tile i (and q) arrived
    __syncthreads();
    const bf16* ks = ring + st * 2 * BN * DH;
    const bf16* vs = ks + BN * DH;
    const int k0 = kbeg + i * BN;

    // S = Q K^T: the warp's 16 rows and 16 keys, two 8-key blocks
    float s[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4], bb[4];
      repro::ldsm_x4(a, q_s + repro::swz<DH>(mt * 16 + (lane & 15),
                                             2 * kk + (lane >> 4)));
      repro::ldsm_x4(bb, ks + repro::swz<DH>(
                             kt + (lane & 7) + ((lane >> 4) << 3),
                             2 * kk + ((lane >> 3) & 1)));
      repro::mma16816(s[0], a, bb[0], bb[1]);
      repro::mma16816(s[1], a, bb[2], bb[3]);
    }

    // a key counts where it lies in the chunk and its position is >= 0;
    // element e of block nb is row g + 8*(e >> 1), key nb*8 + 2*t4 + (e&1)
    bool ok[2][2];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int j = kt + nb * 8 + 2 * t4 + e1;
        ok[nb][e1] = k0 + j < kend &&
                     (kpos == nullptr || kp_s[st * BN + j] >= 0);
      }
    float mx[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = ok[nb][e & 1] ? s[nb][e] * scale : REPRO_NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      alpha[hr] = repro::online_softmax_rescale(m[hr], mx[hr]);
    }
    float ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = ok[nb][e & 1] ? expf(s[nb][e] - m[e >> 1]) : 0.0f;
        ls[e >> 1] += s[nb][e];
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = alpha[hr] * l[hr] + ls[hr];
#pragma unroll
    for (int db = 0; db < DB; ++db)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[db][e] *= alpha[e >> 1];

    // O += P V: P as A fragments (a[2*nb + hr] holds row g + 8*hr, keys
    // nb*8 + 2*t4, +1), three terms; V through ldmatrix.trans
    uint32_t ph[4], pm[4], pl[4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
      split3(s[x >> 1][2 * (x & 1)], s[x >> 1][2 * (x & 1) + 1], ph[x],
             pm[x], pl[x]);
#pragma unroll
    for (int db = 0; db < DB; db += 2) {
      uint32_t bb[4];
      repro::ldsm_x4_t(bb, vs + repro::swz<DH>(
                               kt + (lane & 7) + (((lane >> 3) & 1) << 3),
                               db + (lane >> 4)));
      repro::mma16816(o[db], pl, bb[0], bb[1]);
      repro::mma16816(o[db], pm, bb[0], bb[1]);
      repro::mma16816(o[db], ph, bb[0], bb[1]);
      repro::mma16816(o[db + 1], pl, bb[2], bb[3]);
      repro::mma16816(o[db + 1], pm, bb[2], bb[3]);
      repro::mma16816(o[db + 1], ph, bb[2], bb[3]);
    }
    __syncthreads();                        // stage st free again
  }
  repro::cp_async_wait<0>();
  __syncthreads();                          // the ring is free

  // every warp's (o, m, l) to shared memory, l summed over its quad
  float* ow = o_x + (size_t)warp * 16 * OS;
#pragma unroll
  for (int db = 0; db < DB; ++db) {
    *reinterpret_cast<float2*>(ow + g * OS + db * 8 + 2 * t4) =
        make_float2(o[db][0], o[db][1]);
    *reinterpret_cast<float2*>(ow + (g + 8) * OS + db * 8 + 2 * t4) =
        make_float2(o[db][2], o[db][3]);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    if (t4 == 0) {
      ml_x[warp * 32 + g + 8 * hr] = m[hr];
      ml_x[warp * 32 + 16 + g + 8 * hr] = l[hr];
    }
  }
  __syncthreads();

  // the block's chunk partial: the KW warps of a row merged in warp order,
  // written over the first warp's slot (each value is read and written by
  // one thread), one (row, 4 columns) item at a time
  __shared__ float blk_m[RT], blk_l[RT];
  auto blk_row = [&](float* base, int rr) {
    return base + ((size_t)(rr / 16) * KW * 16 + rr % 16) * OS;
  };
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int it = tid + u * NT;
    const int rr = it / C4, c4 = it % C4;
    const int w0 = (rr / 16) * KW, row = rr % 16;
    float mm = REPRO_NEG_INF;
#pragma unroll
    for (int w = 0; w < KW; ++w) mm = fmaxf(mm, ml_x[(w0 + w) * 32 + row]);
    float ll = 0.0f, a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const float wt = expf(ml_x[(w0 + w) * 32 + row] - mm);
      ll = fmaf(wt, ml_x[(w0 + w) * 32 + 16 + row], ll);
      const float4 x = *reinterpret_cast<const float4*>(
          o_x + ((size_t)(w0 + w) * 16 + row) * OS + c4 * 4);
      a[0] = fmaf(wt, x.x, a[0]);
      a[1] = fmaf(wt, x.y, a[1]);
      a[2] = fmaf(wt, x.z, a[2]);
      a[3] = fmaf(wt, x.w, a[3]);
    }
    *reinterpret_cast<float4*>(blk_row(o_x, rr) + c4 * 4) =
        make_float4(a[0], a[1], a[2], a[3]);
    if (c4 == 0) {
      blk_m[rr] = mm;
      blk_l[rr] = ll;
    }
  }

  // the cluster's kCluster chunks merged in chunk order through
  // distributed shared memory; block `rank` takes the slice `rank` of the
  // (row, 4 columns) items
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  const int n_clusters = gridDim.y / kCluster;
  const int cl = blockIdx.y / kCluster;
  constexpr int SLICE = RT * C4 / kCluster;
  static_assert(SLICE * kCluster == RT * C4, "the cluster splits evenly");
  const size_t n_part = (size_t)Hkv * R * n_clusters;  // (head, row, cluster)
  float* part_m = part + n_part * DH;
  float* part_l = part_m + n_part;
  // first each row's max over the cluster and each chunk's weight
  // exp(m_c - m), a thread a row; then the items
  __shared__ float wt_s[RT][kCluster], row_m[RT], row_l[RT];
  for (int rr = tid; rr < RT; rr += NT) {
    float mk[kCluster], mm = REPRO_NEG_INF, ll = 0.0f;
#pragma unroll
    for (int pr = 0; pr < kCluster; ++pr) {
      mk[pr] = cluster.map_shared_rank(blk_m, pr)[rr];
      mm = fmaxf(mm, mk[pr]);
    }
#pragma unroll
    for (int pr = 0; pr < kCluster; ++pr) {
      wt_s[rr][pr] = expf(mk[pr] - mm);
      ll = fmaf(wt_s[rr][pr], cluster.map_shared_rank(blk_l, pr)[rr], ll);
    }
    row_m[rr] = mm;
    row_l[rr] = ll;
  }
  __syncthreads();
  for (int it = rank * SLICE + tid; it < (rank + 1) * SLICE; it += NT) {
    const int rr = it / C4, c4 = it % C4, r = row0 + rr;
    const float mm = row_m[rr], ll = row_l[rr];
    float4 x[kCluster];
#pragma unroll
    for (int pr = 0; pr < kCluster; ++pr)
      x[pr] = *reinterpret_cast<const float4*>(
          blk_row(cluster.map_shared_rank(o_x, pr), rr) + c4 * 4);
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int pr = 0; pr < kCluster; ++pr) {
      const float wt = wt_s[rr][pr];
      a[0] = fmaf(wt, x[pr].x, a[0]);
      a[1] = fmaf(wt, x[pr].y, a[1]);
      a[2] = fmaf(wt, x[pr].z, a[2]);
      a[3] = fmaf(wt, x[pr].w, a[3]);
    }
    if (r >= R) continue;
    if (n_clusters == 1) {
      const size_t qrow = (size_t)(r / G) * H + (size_t)hk * G + r % G;
#pragma unroll
      for (int j = 0; j < 4; ++j) res.put(qrow, c4 * 4 + j, a[j], mm, ll);
      continue;
    }
    const size_t prow = ((size_t)hk * R + r) * n_clusters + cl;
    *reinterpret_cast<float4*>(part + prow * DH + c4 * 4) =
        make_float4(a[0], a[1], a[2], a[3]);
    if (c4 == 0) {
      part_m[prow] = mm;
      part_l[prow] = ll;
    }
  }
  cluster.sync();                           // the peers' reads are done
  if (n_clusters == 1) return;

  // the last of the head's clusters to finish a slice, by an atomic ticket
  // per (KV head, row tile, slice), merges the slice's cluster partials in
  // cluster order, never arrival order, and resets the ticket for the next
  // launch on the stream
  __threadfence();
  __syncthreads();
  int* ticket =
      tickets + ((size_t)hk * gridDim.z + blockIdx.z) * kCluster + rank;
  if (tid == 0) last_s = atomicAdd(ticket, 1) == n_clusters - 1;
  __syncthreads();
  if (!last_s) return;
  if (tid == 0) *ticket = 0;
  __threadfence();
  for (int it = rank * SLICE + tid; it < (rank + 1) * SLICE; it += NT) {
    const int rr = it / C4, c4 = it % C4, r = row0 + rr;
    if (r >= R) continue;
    const size_t base = ((size_t)hk * R + r) * n_clusters;
    float mm = REPRO_NEG_INF;
    for (int k = 0; k < n_clusters; ++k)
      mm = fmaxf(mm, __ldcg(part_m + base + k));
    float ll = 0.0f, a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int k = 0; k < n_clusters; ++k) {
      const float wt = expf(__ldcg(part_m + base + k) - mm);
      ll = fmaf(wt, __ldcg(part_l + base + k), ll);
      const float4 x = __ldcg(reinterpret_cast<const float4*>(
          part + (base + k) * DH + c4 * 4));
      a[0] = fmaf(wt, x.x, a[0]);
      a[1] = fmaf(wt, x.y, a[1]);
      a[2] = fmaf(wt, x.z, a[2]);
      a[3] = fmaf(wt, x.w, a[3]);
    }
    const size_t qrow = (size_t)(r / G) * H + (size_t)hk * G + r % G;
#pragma unroll
    for (int j = 0; j < 4; ++j) res.put(qrow, c4 * 4 + j, a[j], mm, ll);
  }
}

template <int DH, int MT>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const int* kpos, float* part, int* tickets,
                   Result<bf16> res, int R, int P, int H, int Hkv, int chunk,
                   cudaStream_t stream) {
  using S = Shape<DH, MT>;
  auto kern = prefix_tc_kernel<DH, MT>;
  static size_t allowed[8] = {0};
  cudaError_t e = repro::allow_smem(kern, S::SMEM, allowed);
  if (e != cudaSuccess) return e;
  // whole clusters of chunks; a block past P walks nothing
  const int n_clusters = ((P + chunk - 1) / chunk + kCluster - 1) / kCluster;
  if (n_clusters > 1 && (part == nullptr || tickets == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid(Hkv, n_clusters * kCluster, (R + S::RT - 1) / S::RT);
  kern<<<grid, S::NT, S::SMEM, stream>>>(q, k, v, kpos, part, tickets, res,
                                         P, H, Hkv, R, chunk,
                                         1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

template <int DH>
cudaError_t dispatch_rows(const bf16* q, const bf16* k, const bf16* v,
                          const int* kpos, float* part, int* tickets,
                          Result<bf16> res, int R, int P, int H, int Hkv,
                          int chunk, cudaStream_t s) {
  // the fewest m16 tiles that hold the B*G rows, up to 4 (64 rows)
  if (R <= 16)
    return launch<DH, 1>(q, k, v, kpos, part, tickets, res, R, P, H, Hkv,
                         chunk, s);
  if (R <= 32)
    return launch<DH, 2>(q, k, v, kpos, part, tickets, res, R, P, H, Hkv,
                         chunk, s);
  return launch<DH, 4>(q, k, v, kpos, part, tickets, res, R, P, H, Hkv,
                       chunk, s);
}

}  // namespace tc

// q (B,H,Dh), k and v (P,Hkv,Dh) in one dtype: 0 = float32 (the CUDA-core
// body, tensor_cores = 0), 1 = bfloat16 (the tensor-core body,
// tensor_cores = 1); q, k, v 16-byte aligned.  kpos (P,) int32, or null
// for positions 0..P-1.  chunk: keys a block covers, a multiple of 64 (32
// at Dh=256), with at most 8192 chunks.  part: f32 scratch of
// n*Hkv*B*G*(Dh+2) values, n = n_chunks for the CUDA-core body and
// n = ceil(n_chunks / 8) clusters for the tensor-core body, which needs it
// only when n > 1, and then tickets, Hkv * ceil(B*G / 64) * 8 ints, zero
// before the launch and left zero by it (the last block of each (KV
// head, row tile, slice) resets its own).  Result: with out_s null, the
// partial acc (B,H,Dh), m and l (B,H) f32; else out_s (B,H,Dh) in q's
// dtype with m_s, l_s (B,H) f32, the suffix pass, and out (B,H,Dh) in q's
// dtype, the op's output.  Returns the cudaError_t of the launches (0 =
// success).
extern "C" int prefix_attention_fwd(
    const void* q, const void* k, const void* v, const int* kpos,
    float* part, int* tickets, float* acc, float* m, float* l,
    const void* out_s, const float* m_s, const float* l_s, void* out, int B,
    int P, int H, int Hkv, int Dh, int chunk, int tensor_cores, int dtype,
    void* stream) {
  if (B <= 0 || P <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > kMaxGroup || B * (H / Hkv) > kMaxRows || chunk <= 0 ||
      (Dh != 64 && Dh != 128 && Dh != 256) || chunk % tile_keys(Dh) != 0 ||
      (P + chunk - 1) / chunk > kMaxChunks ||
      (out_s == nullptr && (acc == nullptr || m == nullptr || l == nullptr)) ||
      (out_s != nullptr &&
       (m_s == nullptr || l_s == nullptr || out == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = B * (H / Hkv);
  if (tensor_cores) {
    using tc::bf16;
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    const Result<bf16> res{acc, m, l, static_cast<const bf16*>(out_s),
                           m_s, l_s, static_cast<bf16*>(out), Dh};
    const bf16* qb = static_cast<const bf16*>(q);
    const bf16* kb = static_cast<const bf16*>(k);
    const bf16* vb = static_cast<const bf16*>(v);
    switch (Dh) {
      case 64:
        return (int)tc::dispatch_rows<64>(qb, kb, vb, kpos, part, tickets,
                                          res, R, P, H, Hkv, chunk, s);
      case 128:
        return (int)tc::dispatch_rows<128>(qb, kb, vb, kpos, part, tickets,
                                           res, R, P, H, Hkv, chunk, s);
      default:
        return (int)tc::dispatch_rows<256>(qb, kb, vb, kpos, part, tickets,
                                           res, R, P, H, Hkv, chunk, s);
    }
  }
  if (dtype != 0 || part == nullptr) return (int)cudaErrorInvalidValue;
  const Result<float> res{acc, m, l, static_cast<const float*>(out_s),
                          m_s, l_s, static_cast<float*>(out), Dh};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  switch (Dh) {
    case 64:
      return (int)simt::dispatch_rows<64>(qf, kf, vf, kpos, part, res, B, P,
                                          H, Hkv, chunk, s);
    case 128:
      return (int)simt::dispatch_rows<128>(qf, kf, vf, kpos, part, res, B, P,
                                           H, Hkv, chunk, s);
    default:
      return (int)simt::dispatch_rows<256>(qf, kf, vf, kpos, part, res, B, P,
                                           H, Hkv, chunk, s);
  }
}
