// Backward of the flash prefill attention, for Hopper (sm_90a), hand-written
// CUDA C++.
//
// No Pallas counterpart: the JAX package trains through XLA attention
// (attention_xla, differentiated by XLA); its flash kernel,
// repro/kernels/flash_attention/kernel.py flash_attention_kernel, has no
// custom_vjp.  The port's forward on the card runs flash_attention.cu, so
// its training path needs the gradient of that same function: GQA
// attention of q (B,Sq,H,Dh) over k/v (B,Skv,Hkv,Dh) under the mask of
// explicit int32 positions (-1 = invalid slot; kp <= qp when causal;
// kp > qp - window when window > 0), softmax in f32, P cast to V's dtype
// before PV.  With P recomputed from the forward's row log-sum-exp:
//
//   dV = P_v^T dO            (P_v: P rounded to V's dtype, as the forward)
//   dS = P o (dP - D),  dP = dO V^T,  D = rowsum(P o dP), 0 where masked
//   dQ = dS K / sqrt(Dh),    dK = dS^T Q / sqrt(Dh)
//
// summed over the G query heads of each KV head.  A row with no valid key
// averaged V uniformly in the forward (its lse is NEG_INF): its P is 1/Skv
// on every key, its logits were masked by a `where`, so it gives dQ = 0,
// nothing to dK, and dO/Skv to every key's dV.
//
// FlashAttention-2's shape without atomics, so every output is written by
// one block and the result is the same on every run:
//   1. walk_q_kernel<kDelta>: D = rowsum(P o dP) in f32, a block per
//      (query tile, head, b) walking the KV tiles it can see.  FA2 takes
//      D = rowsum(dO o O) instead, the same number in exact arithmetic,
//      but in bfloat16 it reads the rounded O: emulated on the CPU at the
//      training shapes, that put dQ and dK up to 4.6x past the elementwise
//      bound the checks hold this kernel to (2e-3 + 8e-3 |ref|), so D costs
//      its own walk (two tile products);
//   2. dkdv_kernel: a block per (KV tile, KV head, b) holds its K and V
//      tile and its dK, dV sums, and walks the G heads of the group and
//      every query tile that can see the tile (by the tile's min/max valid
//      key position against the query tile's positions, as the forward's
//      tile skipping; a query tile holding a row with no valid key is
//      always visited, since that row reaches every key's dV);
//   3. walk_q_kernel<dQ>: the same walk as 1, now summing dS K.
// S and dP are recomputed in each walk: nine tile products where FA2 with
// atomics on dQ does five.

// What bounds it on the H100: operations.  At qwen3-1.7b's training shape
// (B=8, S=512, 16/8 heads, Dh=128, causal) the causal half of the five
// products a backward needs is about 21 GFLOP against about 84 MB of q,
// k, v, dO, the gradients and the lse rows: near the card's ridge point,
// so only the tensor cores come near the bound.  Two bodies, chosen by
// the wrapper (flash_attention/ops.py):
//
// * tensor cores (bfloat16 at Dh 64 and 128), namespace tc: the forward's
//   FA2 register layout (mma.sync.m16n8k16, bf16 in, f32 accumulate; tiles
//   in swizzled shared memory by 16-byte cp.async; ldmatrix, and
//   ldmatrix.trans for the operands a product reads down their rows).  The
//   dK/dV walk gives each warp 16 keys: S^T = K Q^T and dP^T = V dO^T in
//   registers over 32 queries a step, P^T re-packed as the A operand of
//   dV += P^T dO (rounded to bf16, as the forward rounds P before PV) and
//   dS^T as that of dK += dS^T Q.  The query walks give each warp 16 rows:
//   S = Q K^T and dP = dO V^T over 64 keys a step, then D's row sums or
//   dQ += dS K.  dS enters its products as two bf16 terms (hi + the
//   rounding error lo), about 16 bits of its f32 value, so dQ and dK keep
//   to the f32 plain version's rounding where one bf16 term would not.
// * CUDA cores (float32, whose tensor-core product would be TF32, and Dh
//   256, whose 16 x 256 dK and dV rows a warp would hold exceed its
//   registers), the first version: f32 FMAs fed from shared memory by a
//   16 x 16 thread grid that owns 4 x 4 (2 x 2 at Dh 256) register tiles.
//
// wgmma, TMA and warp specialisation are later work (ROADMAP).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;               // a 16 x 16 thread grid

// query rows and keys a tile: 32 at Dh=256 keeps the f32 tiles in shared
// memory and the register tiles in registers
template <int DH>
__host__ __device__ constexpr int block_rows() {
  return DH == 256 ? 32 : 64;
}

// shared memory rows are padded by one float: a column read by 16 threads
// of 16 rows hits 16 banks
template <int DH>
constexpr size_t dkdv_smem_bytes() {
  constexpr int BM = block_rows<DH>(), BN = block_rows<DH>();
  return sizeof(float) *
             (2 * (size_t)BN * (DH + 1) + 2 * (size_t)BM * (DH + 1) +
              2 * (size_t)BM * (BN + 1) + 2 * (size_t)BM) +
         sizeof(int) * (BM + BN);
}

template <int DH>
constexpr size_t dq_smem_bytes() {
  constexpr int BM = block_rows<DH>(), BN = block_rows<DH>();
  return sizeof(float) *
             (2 * (size_t)BN * (DH + 1) + 2 * (size_t)BM * (DH + 1) +
              (size_t)BM * (BN + 1) + 2 * (size_t)BM) +
         sizeof(int) * (BM + BN);
}

__device__ __forceinline__ bool no_valid_key(float lse) {
  return lse <= 0.5f * REPRO_NEG_INF;
}

__device__ __forceinline__ bool pair_ok(int qp, int kp, int causal,
                                        int window) {
  return kp >= 0 && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

// whether a query tile with positions in [qlo, qhi] and a KV tile with
// valid positions in [klo, khi] (khi < 0: none) hold a valid pair
__device__ __forceinline__ bool tiles_meet(int qlo, int qhi, int klo,
                                           int khi, int causal, int window) {
  return khi >= 0 && !(causal && klo > qhi) &&
         !(window > 0 && (long long)khi <= (long long)qlo - window);
}

// (rows, DH) of a (B,S,heads,DH) tensor into shared memory as f32, rows
// past S zero
template <typename T, int DH>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int b,
                                          int r0, int rows, int S, int heads,
                                          int head) {
  constexpr int LD = DH + 1;
  for (int x = threadIdx.x; x < rows * DH; x += kThreads) {
    const int r = x / DH, d = x % DH, ri = r0 + r;
    dst[r * LD + d] =
        ri < S ? repro::to_float(
                     src[(((size_t)b * S + ri) * heads + head) * DH + d])
               : 0.0f;
  }
}

// S = A B^T and dP = C E^T over DH for the thread's TM x TN register tile:
// rows ty + 16a of A and C, rows tx + 16c of B and E
template <int DH, int TM, int TN>
__device__ __forceinline__ void two_products(const float* a_s,
                                             const float* c_s,
                                             const float* b_s,
                                             const float* e_s, int ty, int tx,
                                             float (&s)[TM][TN],
                                             float (&dp)[TM][TN]) {
  constexpr int LD = DH + 1;
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int c = 0; c < TN; ++c) s[a][c] = dp[a][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float qa[TM], ga[TM], kb[TN], vb[TN];
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      qa[a] = a_s[(ty + 16 * a) * LD + d];
      ga[a] = c_s[(ty + 16 * a) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      kb[c] = b_s[(tx + 16 * c) * LD + d];
      vb[c] = e_s[(tx + 16 * c) * LD + d];
    }
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        s[a][c] = fmaf(qa[a], kb[c], s[a][c]);
        dp[a][c] = fmaf(ga[a], vb[c], dp[a][c]);
      }
  }
}

// one block: keys [blockIdx.x*BN, +BN) of KV head blockIdx.y, batch row
// blockIdx.z; dK and dV of those keys over the group's G heads
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
            T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H,
            int Hkv, int causal, int window, float scale) {
  constexpr int BM = block_rows<DH>(), BN = block_rows<DH>();
  constexpr int LD = DH + 1, LP = BN + 1;
  constexpr int TM = BM / 16, TN = BN / 16, TD = DH / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                        // [BN][LD]
  float* v_s = k_s + BN * LD;               // [BN][LD]
  float* q_s = v_s + BN * LD;               // [BM][LD]
  float* do_s = q_s + BM * LD;              // [BM][LD]
  float* p_s = do_s + BM * LD;              // [BM][LP]  P_v
  float* ds_s = p_s + BM * LP;              // [BM][LP]  dS
  float* lse_s = ds_s + BM * LP;            // [BM]
  float* dl_s = lse_s + BM;                 // [BM]
  int* qp_s = reinterpret_cast<int*>(dl_s + BM);  // [BM]
  int* kp_s = qp_s + BM;                    // [BN]
  __shared__ int klo_s, khi_s, visit_s;

  const int k0 = blockIdx.x * BN, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid & 31, warp = tid >> 5;
  // a row with no valid key: P = 1/Skv, rounded to V's dtype for PV
  const float p_uniform =
      repro::to_float(repro::from_float<T>(1.0f / (float)Skv));

  load_rows<T, DH>(k_s, k, b, k0, BN, Skv, Hkv, hk);
  load_rows<T, DH>(v_s, v, b, k0, BN, Skv, Hkv, hk);
  if (tid < BN)
    kp_s[tid] = k0 + tid < Skv ? kv_pos[(size_t)b * Skv + k0 + tid] : -1;
  __syncthreads();
  if (warp == 0) {
    int lo = INT_MAX, hi = -1;
    for (int j = lane; j < BN; j += 32) {
      const int kp = kp_s[j];
      if (kp >= 0) {
        lo = min(lo, kp);
        hi = max(hi, kp);
      }
    }
    lo = repro::warp_min_int(lo);
    hi = repro::warp_max_int(hi);
    if (lane == 0) {
      klo_s = lo;
      khi_s = hi;
    }
  }

  float acc_k[TN][TD], acc_v[TN][TD];
#pragma unroll
  for (int a = 0; a < TN; ++a)
#pragma unroll
    for (int c = 0; c < TD; ++c) acc_k[a][c] = acc_v[a][c] = 0.0f;

  const int n_qt = (Sq + BM - 1) / BM;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * BM;
      __syncthreads();                      // the last tile is consumed
      if (tid < BM) {
        const int qi = q0 + tid;
        const bool in = qi < Sq;
        const size_t row = ((size_t)b * H + h) * Sq + qi;
        qp_s[tid] = in ? q_pos[(size_t)b * Sq + qi] : 0;
        lse_s[tid] = in ? lse[row] : 0.0f;
        dl_s[tid] = in ? delta[row] : 0.0f;
      }
      __syncthreads();
      if (warp == 0) {
        int qlo = INT_MAX, qhi = INT_MIN;
        bool empty = false;
        for (int r = lane; r < BM; r += 32) {
          if (q0 + r >= Sq) continue;
          qlo = min(qlo, qp_s[r]);
          qhi = max(qhi, qp_s[r]);
          empty = empty || no_valid_key(lse_s[r]);
        }
        qlo = repro::warp_min_int(qlo);
        qhi = repro::warp_max_int(qhi);
        empty = __any_sync(0xffffffffu, empty);
        if (lane == 0)
          visit_s = empty || tiles_meet(qlo, qhi, klo_s, khi_s, causal,
                                        window);
      }
      __syncthreads();
      if (!visit_s) continue;
      load_rows<T, DH>(q_s, q, b, q0, BM, Sq, H, h);
      load_rows<T, DH>(do_s, dout, b, q0, BM, Sq, H, h);
      __syncthreads();

      float s[TM][TN], dp[TM][TN];
      two_products<DH, TM, TN>(q_s, do_s, k_s, v_s, ty, tx, s, dp);
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          const int i = ty + 16 * a, j = tx + 16 * c;
          float p = 0.0f, ds = 0.0f;
          if (q0 + i < Sq && k0 + j < Skv) {
            const float L = lse_s[i];
            if (no_valid_key(L)) {
              p = p_uniform;
            } else if (pair_ok(qp_s[i], kp_s[j], causal, window)) {
              const float pe = expf(s[a][c] * scale - L);
              p = repro::to_float(repro::from_float<T>(pe));
              ds = pe * (dp[a][c] - dl_s[i]);
            }
          }
          p_s[i * LP + j] = p;
          ds_s[i * LP + j] = ds;
        }
      __syncthreads();

      // dV += P_v^T dO and dK += dS^T Q for keys ty + 16a, columns tx + 16c
#pragma unroll 2
      for (int i = 0; i < BM; ++i) {
        float pa[TN], sa[TN], ob[TD], qb[TD];
#pragma unroll
        for (int a = 0; a < TN; ++a) {
          pa[a] = p_s[i * LP + ty + 16 * a];
          sa[a] = ds_s[i * LP + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < TD; ++c) {
          ob[c] = do_s[i * LD + tx + 16 * c];
          qb[c] = q_s[i * LD + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < TN; ++a)
#pragma unroll
          for (int c = 0; c < TD; ++c) {
            acc_v[a][c] = fmaf(pa[a], ob[c], acc_v[a][c]);
            acc_k[a][c] = fmaf(sa[a], qb[c], acc_k[a][c]);
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < TN; ++a) {
    const int kj = k0 + ty + 16 * a;
    if (kj >= Skv) continue;
    const size_t base = (((size_t)b * Skv + kj) * Hkv + hk) * DH;
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      const int d = tx + 16 * c;
      dk[base + d] = repro::from_float<T>(acc_k[a][c] * scale);
      dv[base + d] = repro::from_float<T>(acc_v[a][c]);
    }
  }
}

// one block: query rows [blockIdx.x*BM, +BM) of head blockIdx.y, batch row
// blockIdx.z, walking the KV tiles they can see; with kDelta it writes
// their D = rowsum(P o dP) into ``delta``, else their dQ (reading D)
template <typename T, int DH, bool kDelta>
__global__ void __launch_bounds__(kThreads, 1)
walk_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta,
              const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
              T* __restrict__ dq, int Sq, int Skv, int H, int Hkv,
              int causal, int window, float scale) {
  constexpr int BM = block_rows<DH>(), BN = block_rows<DH>();
  constexpr int LD = DH + 1, LP = BN + 1;
  constexpr int TM = BM / 16, TN = BN / 16, TD = DH / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                        // [BM][LD]
  float* do_s = q_s + BM * LD;              // [BM][LD]
  float* k_s = do_s + BM * LD;              // [BN][LD]
  float* v_s = k_s + BN * LD;               // [BN][LD]
  float* ds_s = v_s + BN * LD;              // [BM][LP]
  float* lse_s = ds_s + BM * LP;            // [BM]
  float* dl_s = lse_s + BM;                 // [BM]
  int* qp_s = reinterpret_cast<int*>(dl_s + BM);  // [BM]
  int* kp_s = qp_s + BM;                    // [BN]
  __shared__ int qlo_s, qhi_s, visit_s;

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid & 31, warp = tid >> 5;

  load_rows<T, DH>(q_s, q, b, q0, BM, Sq, H, h);
  load_rows<T, DH>(do_s, dout, b, q0, BM, Sq, H, h);
  if (tid < BM) {
    const int qi = q0 + tid;
    const bool in = qi < Sq;
    const size_t row = ((size_t)b * H + h) * Sq + qi;
    qp_s[tid] = in ? q_pos[(size_t)b * Sq + qi] : 0;
    lse_s[tid] = in ? lse[row] : 0.0f;
    dl_s[tid] = in && !kDelta ? delta[row] : 0.0f;
  }
  __syncthreads();
  if (warp == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = lane; r < BM; r += 32) {
      if (q0 + r >= Sq) continue;
      lo = min(lo, qp_s[r]);
      hi = max(hi, qp_s[r]);
    }
    lo = repro::warp_min_int(lo);
    hi = repro::warp_max_int(hi);
    if (lane == 0) {
      qlo_s = lo;
      qhi_s = hi;
    }
  }

  // dQ rows ty + 16a, columns tx + 16c; or D's partial sums over the
  // thread's columns
  float acc[TM][kDelta ? 1 : TD];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int c = 0; c < (kDelta ? 1 : TD); ++c) acc[a][c] = 0.0f;

  const int n_kt = (Skv + BN - 1) / BN;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();                        // the last tile is consumed
    if (tid < BN)
      kp_s[tid] = k0 + tid < Skv ? kv_pos[(size_t)b * Skv + k0 + tid] : -1;
    __syncthreads();
    if (warp == 0) {
      int lo = INT_MAX, hi = -1;
      for (int j = lane; j < BN; j += 32) {
        const int kp = kp_s[j];
        if (kp >= 0) {
          lo = min(lo, kp);
          hi = max(hi, kp);
        }
      }
      lo = repro::warp_min_int(lo);
      hi = repro::warp_max_int(hi);
      if (lane == 0)
        visit_s = tiles_meet(qlo_s, qhi_s, lo, hi, causal, window);
    }
    __syncthreads();
    if (!visit_s) continue;                 // rows with no valid key add 0
    load_rows<T, DH>(k_s, k, b, k0, BN, Skv, Hkv, hk);
    load_rows<T, DH>(v_s, v, b, k0, BN, Skv, Hkv, hk);
    __syncthreads();

    float s[TM][TN], dp[TM][TN];
    two_products<DH, TM, TN>(q_s, do_s, k_s, v_s, ty, tx, s, dp);
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int i = ty + 16 * a, j = tx + 16 * c;
        float p = 0.0f;
        if (q0 + i < Sq && k0 + j < Skv) {
          const float L = lse_s[i];
          if (!no_valid_key(L) &&
              pair_ok(qp_s[i], kp_s[j], causal, window))
            p = expf(s[a][c] * scale - L);
        }
        if (kDelta)
          acc[a][0] = fmaf(p, dp[a][c], acc[a][0]);
        else
          ds_s[i * LP + j] = p * (dp[a][c] - dl_s[i]);
      }
    if (kDelta) continue;
    __syncthreads();

    // dQ += dS K for rows ty + 16a, columns tx + 16c
#pragma unroll 2
    for (int j = 0; j < BN; ++j) {
      float sa[TM], kb[TD];
#pragma unroll
      for (int a = 0; a < TM; ++a) sa[a] = ds_s[(ty + 16 * a) * LP + j];
#pragma unroll
      for (int c = 0; c < TD; ++c) kb[c] = k_s[j * LD + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int c = 0; c < (kDelta ? 1 : TD); ++c)
          acc[a][c] = fmaf(sa[a], kb[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int qi = q0 + ty + 16 * a;
    if (kDelta) {
      // the 16 threads of a row are one half of a warp
      float d = acc[a][0];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if (tx == 0 && qi < Sq) delta[((size_t)b * H + h) * Sq + qi] = d;
      continue;
    }
    if (qi >= Sq) continue;
    const size_t base = (((size_t)b * Sq + qi) * H + h) * DH;
#pragma unroll
    for (int c = 0; c < (kDelta ? 1 : TD); ++c)
      dq[base + tx + 16 * c] = repro::from_float<T>(acc[a][c] * scale);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const int* q_pos,
                   const int* kv_pos, void* dq, void* dk, void* dv,
                   float* delta, int B, int Sq, int Skv, int H, int Hkv,
                   int causal, int window, cudaStream_t stream) {
  static size_t allowed_dkdv[8] = {0}, allowed_d[8] = {0},
                allowed_dq[8] = {0};
  constexpr int BM = block_rows<DH>(), BN = block_rows<DH>();
  auto kd = walk_q_kernel<T, DH, true>;
  auto kdkdv = dkdv_kernel<T, DH>;
  auto kdq = walk_q_kernel<T, DH, false>;
  constexpr size_t s1 = dkdv_smem_bytes<DH>(), s2 = dq_smem_bytes<DH>();
  cudaError_t e = repro::allow_smem(kd, s2, allowed_d);
  if (e != cudaSuccess) return e;
  e = repro::allow_smem(kdkdv, s1, allowed_dkdv);
  if (e != cudaSuccess) return e;
  e = repro::allow_smem(kdq, s2, allowed_dq);
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf((float)DH);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const dim3 q_grid((Sq + BM - 1) / BM, H, B);

  kd<<<q_grid, kThreads, s2, stream>>>(qt, kt, vt, dot, lse, delta, q_pos,
                                       kv_pos, nullptr, Sq, Skv, H, Hkv,
                                       causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kdkdv<<<dim3((Skv + BN - 1) / BN, Hkv, B), kThreads, s1, stream>>>(
      qt, kt, vt, dot, lse, delta, q_pos, kv_pos, static_cast<T*>(dk),
      static_cast<T*>(dv), Sq, Skv, H, Hkv, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kdq<<<q_grid, kThreads, s2, stream>>>(qt, kt, vt, dot, lse, delta, q_pos,
                                        kv_pos, static_cast<T*>(dq), Sq, Skv,
                                        H, Hkv, causal, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tensor-core body: bfloat16 at Dh 64 and 128
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
using repro::ldsm_x4;
using repro::ldsm_x4_t;
using repro::mma16816;
using repro::pack_bf16;
using repro::swz;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 64;       // keys a dK/dV block holds, 16 a warp
constexpr int kQStep = 32;      // query rows a dK/dV step takes
constexpr int kRows = 64;       // query rows a walk block holds, 16 a warp
constexpr int kKStep = 64;      // keys a walk step takes

template <int DH>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(bf16) * (2 * (size_t)kKeys * DH + 2 * (size_t)kQStep * DH) +
         sizeof(float) * 2 * kQStep + sizeof(int) * (kQStep + kKeys);
}

template <int DH>
constexpr size_t walk_smem_bytes() {
  return sizeof(bf16) * (2 * (size_t)kRows * DH + 2 * (size_t)kKStep * DH) +
         sizeof(float) * 2 * kRows + sizeof(int) * (kRows + kKStep);
}

// ``rows`` rows of a (B,S,heads,DH) bf16 tensor into a swizzled smem tile
// by 16-byte cp.async, rows past S zero
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int b,
                                          int r0, int rows, int S,
                                          int heads, int head) {
  constexpr int CH = DH / 8;
  for (int x = threadIdx.x; x < rows * CH; x += kThreads) {
    const int r = x / CH, c = x % CH, ri = r0 + r;
    const bool ok = ri < S;
    repro::cp_async16(
        dst + swz<DH>(r, c),
        src + (((size_t)b * S + (ok ? ri : 0)) * heads + head) * DH + c * 8,
        ok);
  }
}

// x, y as a bfloat16 pair and their rounding errors as a second pair: dS
// enters the tensor cores as hi + lo, about 16 bits of its f32 value
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// A fragment (16 rows x 16 columns) from two 8-column accumulator blocks
__device__ __forceinline__ void pack_a(const float* c0, const float* c1,
                                       uint32_t* a) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ void split_a(const float* c0, const float* c1,
                                        uint32_t* hi, uint32_t* lo) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// C (16 x 8*NB) += A B^T over DH, A rows a0.. of ``a_s``, B rows of
// ``b_s``: the forward's S = Q K^T, for S, S^T, dP and dP^T alike
template <int DH, int NB>
__device__ __forceinline__ void rows_by_rows(const bf16* a_s, int a0,
                                             const bf16* b_s,
                                             float (&c)[NB][4], int lane) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_s + swz<DH>(a0 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      uint32_t bb[4];
      ldsm_x4(bb, b_s + swz<DH>(nb * 8 + (lane & 7) + ((lane >> 4) << 3),
                                2 * kk + ((lane >> 3) & 1)));
      mma16816(c[nb], a, bb[0], bb[1]);
      mma16816(c[nb + 1], a, bb[2], bb[3]);
    }
  }
}

// acc (16 x DH) += A (16 x 16) B over the 16 rows k0.. of ``b_s``: the
// forward's O += P V, B read through ldmatrix.trans
template <int DH>
__device__ __forceinline__ void times_rows(const uint32_t* a,
                                           const bf16* b_s, int k0,
                                           float (&acc)[DH / 8][4],
                                           int lane) {
#pragma unroll
  for (int db = 0; db < DH / 8; db += 2) {
    uint32_t bb[4];
    ldsm_x4_t(bb, b_s + swz<DH>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                db + (lane >> 4)));
    mma16816(acc[db], a, bb[0], bb[1]);
    mma16816(acc[db + 1], a, bb[2], bb[3]);
  }
}

// acc (16 x DH) scaled, as bfloat16 rows r0.. of a (B,S,heads,DH) tensor
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst,
                                           const float (&acc)[DH / 8][4],
                                           float scale, int b, int r0,
                                           int S, int heads, int head,
                                           int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int ri = r0 + g + 8 * hr;
    if (ri >= S) continue;
    bf16* row = dst + (((size_t)b * S + ri) * heads + head) * DH + 2 * t4;
#pragma unroll
    for (int db = 0; db < DH / 8; ++db)
      *reinterpret_cast<__nv_bfloat162*>(row + db * 8) =
          __floats2bfloat162_rn(acc[db][2 * hr] * scale,
                                acc[db][2 * hr + 1] * scale);
  }
}

// one block: keys [blockIdx.x*64, +64) of KV head blockIdx.y, batch row
// blockIdx.z, 16 a warp; walks the group's heads and the query steps that
// can see them, holding S^T, dP^T (16 keys x 32 queries) and the warp's
// dK, dV rows in registers
template <int DH>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv,
            int H, int Hkv, int causal, int window, float scale) {
  constexpr int NQ = kQStep / 8;
  constexpr int DB = DH / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);   // [kKeys][DH]
  bf16* v_s = k_s + kKeys * DH;                     // [kKeys][DH]
  bf16* q_s = v_s + kKeys * DH;                     // [kQStep][DH]
  bf16* do_s = q_s + kQStep * DH;                   // [kQStep][DH]
  float* lse_s = reinterpret_cast<float*>(do_s + kQStep * DH);
  float* dl_s = lse_s + kQStep;
  int* qp_s = reinterpret_cast<int*>(dl_s + kQStep);
  int* kp_s = qp_s + kQStep;
  __shared__ int klo_s, khi_s, visit_s;

  const int k0 = blockIdx.x * kKeys, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t4 = lane & 3;
  const float p_uniform = __bfloat162float(__float2bfloat16(1.0f / Skv));

  load_tile<DH>(k_s, k, b, k0, kKeys, Skv, Hkv, hk);
  load_tile<DH>(v_s, v, b, k0, kKeys, Skv, Hkv, hk);
  repro::cp_async_commit();
  if (tid < kKeys)
    kp_s[tid] = k0 + tid < Skv ? kv_pos[(size_t)b * Skv + k0 + tid] : -1;
  repro::cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) {
    int lo = INT_MAX, hi = -1;
    for (int j = lane; j < kKeys; j += 32) {
      const int kp = kp_s[j];
      if (kp >= 0) {
        lo = min(lo, kp);
        hi = max(hi, kp);
      }
    }
    lo = repro::warp_min_int(lo);
    hi = repro::warp_max_int(hi);
    if (lane == 0) {
      klo_s = lo;
      khi_s = hi;
    }
  }
  // this thread's keys: rows g and g + 8 of the warp's 16
  int kp[2];
  bool kin[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int j = warp * 16 + (lane >> 2) + 8 * hr;
    kin[hr] = k0 + j < Skv;
    kp[hr] = kp_s[j];
  }

  float dk_acc[DB][4], dv_acc[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[db][e] = dv_acc[db][e] = 0.0f;

  const int n_qt = (Sq + kQStep - 1) / kQStep;
  for (int gq = 0; gq < G * n_qt; ++gq) {
    const int h = hk * G + gq / n_qt, q0 = (gq % n_qt) * kQStep;
    __syncthreads();                        // the last step is consumed
    if (tid < kQStep) {
      const int qi = q0 + tid;
      const bool in = qi < Sq;
      const size_t row = ((size_t)b * H + h) * Sq + qi;
      qp_s[tid] = in ? q_pos[(size_t)b * Sq + qi] : 0;
      lse_s[tid] = in ? lse[row] : 0.0f;
      dl_s[tid] = in ? delta[row] : 0.0f;
    }
    __syncthreads();
    if (warp == 0) {
      const int r = lane;                   // kQStep == 32
      const bool in = q0 + r < Sq;
      const int qlo = repro::warp_min_int(in ? qp_s[r] : INT_MAX);
      const int qhi = repro::warp_max_int(in ? qp_s[r] : INT_MIN);
      const bool empty = __any_sync(0xffffffffu, in && no_valid_key(lse_s[r]));
      if (lane == 0)
        visit_s = empty || tiles_meet(qlo, qhi, klo_s, khi_s, causal, window);
    }
    __syncthreads();
    if (!visit_s) continue;
    load_tile<DH>(q_s, q, b, q0, kQStep, Sq, H, h);
    load_tile<DH>(do_s, dout, b, q0, kQStep, Sq, H, h);
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int nb = 0; nb < NQ; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.0f;
    rows_by_rows<DH, NQ>(k_s, warp * 16, q_s, s, lane);
    rows_by_rows<DH, NQ>(v_s, warp * 16, do_s, dp, lane);

    // P^T (f32; rounded to bf16 when it enters the product, as the
    // forward rounds P before PV) and dS^T, in place
#pragma unroll
    for (int nb = 0; nb < NQ; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1, i = nb * 8 + 2 * t4 + (e & 1);
        float p = 0.0f, ds = 0.0f;
        if (kin[hr] && q0 + i < Sq) {
          const float L = lse_s[i];
          if (no_valid_key(L)) {
            p = p_uniform;
          } else if (pair_ok(qp_s[i], kp[hr], causal, window)) {
            p = expf(s[nb][e] * scale - L);
            ds = p * (dp[nb][e] - dl_s[i]);
          }
        }
        s[nb][e] = p;
        dp[nb][e] = ds;
      }

    // dV += P^T dO, dK += dS^T Q, 16 queries at a time
#pragma unroll
    for (int kk = 0; kk < kQStep / 16; ++kk) {
      uint32_t ap[4], ah[4], al[4];
      pack_a(s[2 * kk], s[2 * kk + 1], ap);
      split_a(dp[2 * kk], dp[2 * kk + 1], ah, al);
      times_rows<DH>(ap, do_s, kk * 16, dv_acc, lane);
      times_rows<DH>(ah, q_s, kk * 16, dk_acc, lane);
      times_rows<DH>(al, q_s, kk * 16, dk_acc, lane);
    }
  }
  store_rows<DH>(dk, dk_acc, scale, b, k0 + warp * 16, Skv, Hkv, hk, lane);
  store_rows<DH>(dv, dv_acc, 1.0f, b, k0 + warp * 16, Skv, Hkv, hk, lane);
}

// one block: query rows [blockIdx.x*64, +64) of head blockIdx.y, batch row
// blockIdx.z, 16 a warp, walking the KV steps they can see; with kDelta it
// writes D = rowsum(P o dP), else dQ (reading D)
template <int DH, bool kDelta>
__global__ void __launch_bounds__(kThreads)
walk_q_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta,
              const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
              bf16* __restrict__ dq, int Sq, int Skv, int H, int Hkv,
              int causal, int window, float scale) {
  constexpr int NB = kKStep / 8;
  constexpr int DB = DH / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [kRows][DH]
  bf16* do_s = q_s + kRows * DH;                    // [kRows][DH]
  bf16* k_s = do_s + kRows * DH;                    // [kKStep][DH]
  bf16* v_s = k_s + kKStep * DH;                    // [kKStep][DH]
  float* lse_s = reinterpret_cast<float*>(v_s + kKStep * DH);
  float* dl_s = lse_s + kRows;
  int* qp_s = reinterpret_cast<int*>(dl_s + kRows);
  int* kp_s = qp_s + kRows;
  __shared__ int qlo_s, qhi_s, visit_s;

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t4 = lane & 3;

  load_tile<DH>(q_s, q, b, q0, kRows, Sq, H, h);
  load_tile<DH>(do_s, dout, b, q0, kRows, Sq, H, h);
  repro::cp_async_commit();
  if (tid < kRows) {
    const int qi = q0 + tid;
    const bool in = qi < Sq;
    const size_t row = ((size_t)b * H + h) * Sq + qi;
    qp_s[tid] = in ? q_pos[(size_t)b * Sq + qi] : 0;
    lse_s[tid] = in ? lse[row] : 0.0f;
    dl_s[tid] = in && !kDelta ? delta[row] : 0.0f;
  }
  repro::cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = lane; r < kRows; r += 32) {
      if (q0 + r >= Sq) continue;
      lo = min(lo, qp_s[r]);
      hi = max(hi, qp_s[r]);
    }
    lo = repro::warp_min_int(lo);
    hi = repro::warp_max_int(hi);
    if (lane == 0) {
      qlo_s = lo;
      qhi_s = hi;
    }
  }
  // this thread's rows: g and g + 8 of the warp's 16
  int qp[2];
  bool live[2];
  float L[2], D[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = warp * 16 + (lane >> 2) + 8 * hr;
    qp[hr] = qp_s[i];
    L[hr] = lse_s[i];
    D[hr] = dl_s[i];
    live[hr] = q0 + i < Sq && !no_valid_key(L[hr]);
  }

  float acc[DB][4], dsum[2] = {0.0f, 0.0f};   // dQ rows; or D's sums
#pragma unroll
  for (int db = 0; db < DB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[db][e] = 0.0f;

  const int n_kt = (Skv + kKStep - 1) / kKStep;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kKStep;
    __syncthreads();                        // the last step is consumed
    if (tid < kKStep)
      kp_s[tid] = k0 + tid < Skv ? kv_pos[(size_t)b * Skv + k0 + tid] : -1;
    __syncthreads();
    if (warp == 0) {
      int lo = INT_MAX, hi = -1;
      for (int j = lane; j < kKStep; j += 32) {
        const int kp = kp_s[j];
        if (kp >= 0) {
          lo = min(lo, kp);
          hi = max(hi, kp);
        }
      }
      lo = repro::warp_min_int(lo);
      hi = repro::warp_max_int(hi);
      if (lane == 0)
        visit_s = tiles_meet(qlo_s, qhi_s, lo, hi, causal, window);
    }
    __syncthreads();
    if (!visit_s) continue;                 // rows with no valid key add 0
    load_tile<DH>(k_s, k, b, k0, kKStep, Skv, Hkv, hk);
    load_tile<DH>(v_s, v, b, k0, kKStep, Skv, Hkv, hk);
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T and dP = dO V^T for the warp's 16 rows
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.0f;
    rows_by_rows<DH, NB>(q_s, warp * 16, k_s, s, lane);
    rows_by_rows<DH, NB>(do_s, warp * 16, v_s, dp, lane);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1, j = nb * 8 + 2 * t4 + (e & 1);
        float p = 0.0f;
        if (live[hr] && k0 + j < Skv &&
            pair_ok(qp[hr], kp_s[j], causal, window))
          p = expf(s[nb][e] * scale - L[hr]);
        if (kDelta)
          dsum[hr] = fmaf(p, dp[nb][e], dsum[hr]);
        else
          dp[nb][e] = p * (dp[nb][e] - D[hr]);
      }
    if constexpr (!kDelta) {
      // dQ += dS K, 16 keys at a time
#pragma unroll
      for (int kk = 0; kk < kKStep / 16; ++kk) {
        uint32_t ah[4], al[4];
        split_a(dp[2 * kk], dp[2 * kk + 1], ah, al);
        times_rows<DH>(ah, k_s, kk * 16, acc, lane);
        times_rows<DH>(al, k_s, kk * 16, acc, lane);
      }
    }
  }

  if constexpr (kDelta) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float d = dsum[hr];
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const int qi = q0 + warp * 16 + (lane >> 2) + 8 * hr;
      if (t4 == 0 && qi < Sq) delta[((size_t)b * H + h) * Sq + qi] = d;
    }
  } else {
    store_rows<DH>(dq, acc, scale, b, q0 + warp * 16, Sq, H, h, lane);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const int* q_pos,
                   const int* kv_pos, void* dq, void* dk, void* dv,
                   float* delta, int B, int Sq, int Skv, int H, int Hkv,
                   int causal, int window, cudaStream_t stream) {
  static size_t allowed_d[8] = {0}, allowed_dkdv[8] = {0},
                allowed_dq[8] = {0};
  auto kd = walk_q_kernel<DH, true>;
  auto kdkdv = dkdv_kernel<DH>;
  auto kdq = walk_q_kernel<DH, false>;
  constexpr size_t s1 = dkdv_smem_bytes<DH>(), s2 = walk_smem_bytes<DH>();
  cudaError_t e = repro::allow_smem(kd, s2, allowed_d);
  if (e != cudaSuccess) return e;
  e = repro::allow_smem(kdkdv, s1, allowed_dkdv);
  if (e != cudaSuccess) return e;
  e = repro::allow_smem(kdq, s2, allowed_dq);
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf((float)DH);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const dim3 q_grid((Sq + kRows - 1) / kRows, H, B);
  kd<<<q_grid, kThreads, s2, stream>>>(qt, kt, vt, dot, lse, delta, q_pos,
                                       kv_pos, nullptr, Sq, Skv, H, Hkv,
                                       causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kdkdv<<<dim3((Skv + kKeys - 1) / kKeys, Hkv, B), kThreads, s1, stream>>>(
      qt, kt, vt, dot, lse, delta, q_pos, kv_pos, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Skv, H, Hkv, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kdq<<<q_grid, kThreads, s2, stream>>>(qt, kt, vt, dot, lse, delta, q_pos,
                                        kv_pos, static_cast<bf16*>(dq), Sq,
                                        Skv, H, Hkv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const int* q_pos,
                      const int* kv_pos, void* dq, void* dk, void* dv,
                      float* delta, int B, int Sq, int Skv, int H, int Hkv,
                      int Dh, int causal, int window, cudaStream_t s) {
  if (Dh == 256)
    return launch<T, 256>(q, k, v, dout, lse, q_pos, kv_pos, dq, dk, dv,
                          delta, B, Sq, Skv, H, Hkv, causal, window, s);
  // bfloat16 at Dh 64 and 128 takes the tensor-core body only
  if constexpr (std::is_same<T, float>::value) {
    if (Dh == 64)
      return launch<T, 64>(q, k, v, dout, lse, q_pos, kv_pos, dq, dk, dv,
                           delta, B, Sq, Skv, H, Hkv, causal, window, s);
    if (Dh == 128)
      return launch<T, 128>(q, k, v, dout, lse, q_pos, kv_pos, dq, dk, dv,
                            delta, B, Sq, Skv, H, Hkv, causal, window, s);
  }
  return cudaErrorInvalidValue;
}

cudaError_t tc_dh(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const int* q_pos,
                  const int* kv_pos, void* dq, void* dk, void* dv,
                  float* delta, int B, int Sq, int Skv, int H, int Hkv,
                  int Dh, int causal, int window, cudaStream_t s) {
  if (Dh == 64)
    return tc::launch<64>(q, k, v, dout, lse, q_pos, kv_pos, dq, dk, dv,
                          delta, B, Sq, Skv, H, Hkv, causal, window, s);
  if (Dh == 128)
    return tc::launch<128>(q, k, v, dout, lse, q_pos, kv_pos, dq, dk, dv,
                           delta, B, Sq, Skv, H, Hkv, causal, window, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dq, dout: (B,Sq,H,Dh); k, v, dk, dv: (B,Skv,Hkv,Dh); all contiguous,
// of one dtype (0 = float32, 1 = bfloat16).  lse: (B,H,Sq) float32 from
// flash_attention_fwd; delta: (B,H,Sq) float32 scratch.  tensor_cores: 1
// = the mma.sync body (bfloat16 at Dh 64 or 128, every tensor 16-byte
// aligned), 0 = the CUDA-core body (float32 at Dh 64, 128, 256; bfloat16
// at Dh 256).  Launches three kernels on ``stream``; returns the
// cudaError_t of the launches (0 = success).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const int* q_pos,
                                   const int* kv_pos, void* dq, void* dk,
                                   void* dv, float* delta, int B, int Sq,
                                   int Skv, int H, int Hkv, int Dh,
                                   int causal, int window, int dtype,
                                   int tensor_cores, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)tc_dh(q, k, v, dout, lse, q_pos, kv_pos, dq, dk, dv, delta,
                      B, Sq, Skv, H, Hkv, Dh, causal, window, s);
  }
  if (dtype == 0)
    return (int)launch_dh<float>(q, k, v, dout, lse, q_pos, kv_pos, dq, dk,
                                 dv, delta, B, Sq, Skv, H, Hkv, Dh, causal,
                                 window, s);
  if (dtype == 1)
    return (int)launch_dh<__nv_bfloat16>(q, k, v, dout, lse, q_pos, kv_pos,
                                         dq, dk, dv, delta, B, Sq, Skv, H,
                                         Hkv, Dh, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
