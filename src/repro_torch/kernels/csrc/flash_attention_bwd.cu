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
// FlashAttention-2's shape without atomics: every output element is
// written by one block, and every sum runs in an order fixed by the shape,
// so two calls on the same inputs give the same bits.
//   1. D = rowsum(P o dP) in f32, a block per (query tile, head, b)
//      walking the KV tiles it can see.  FA2 takes D = rowsum(dO o O)
//      instead, the same number in exact arithmetic, but the forward's O
//      has P rounded to bf16 before PV: emulated on the CPU at cuts of the
//      training shapes (tests/test_torch_backward_tiles.py), dQ and dK land
//      up to 2.6x past the elementwise bound the checks hold this kernel to
//      (2e-3 + 8e-3 |ref|) with O's f32 accumulator, 4.6x with the bf16 O,
//      so D costs its own walk (two tile products);
//   2. dK, dV: a block per (KV tile, KV head, b) holds its K and V tile and
//      its dK, dV sums, and walks the group's query heads and every query
//      step that can see the tile (by the tile's min/max valid key position
//      against the step's positions, as the forward's tile skipping; a step
//      holding a row with no valid key is always visited, since that row
//      reaches every key's dV);
//   3. dQ: the same walk as 1, now summing dS K.
// S and dP are recomputed in each walk.  Folding dQ into walk 2 (FA2 adds
// it with atomics) would cut two of the products, but a deterministic fold
// orders each query tile's adds across blocks: an f32 dQ read and written
// once per (KV tile, query step) pair, 3.6x the bytes of the whole
// backward at qwen3's shape, and blocks that wait on each other.
//
// What bounds it on the H100: operations or bytes, near the ridge point.
// The five products a backward needs over the valid pairs, against each
// input read once and each output written once:
//   qwen3-1.7b (B=8, S=512, 16/8 heads, Dh 128, causal): 21.5 GFLOP, 84 MB:
//     0.0251 ms (bytes);
//   recurrentgemma-2b (B=4, S=512, 10/1 heads, Dh 256, causal): 13.4
//     GFLOP, 36 MB: 0.0136 ms (operations); with a 128-key window 0.0107;
//   whisper-tiny's encoder (B=8, 1500 over 1500, 6/6 heads, Dh 64): 69.1
//     GFLOP: 0.0699 ms (operations); its cross-attention (128 queries over
//     1000 valid of 1500 frames) 0.0117 ms (bytes).
// Walks 1-3 take nine tile products, eleven with dS in two terms (below),
// so only the tensor cores come near the bound.  Two bodies, chosen by the
// wrapper (flash_attention/ops.py) by dtype alone:
//
// * tensor cores (bfloat16 at Dh 64, 128 and 256), namespace tc, four
//   launches: meta_kernel, delta_kernel (walk 1), grads_kernel (walks 2
//   and 3 in one launch: they need only D, and either walk's last wave
//   shares the card with the other) and, when the heads are split,
//   reduce_kernel.  A block is a warpgroup (4 warps) at Dh 64 and 128 and
//   two at 256.  What the design does about the bound:
//   - Every product on wgmma.  Tiles sit in shared memory in the GMMA
//     K-major layout with its 128-byte swizzle (64-column slabs, 1024-byte
//     aligned), filled by 16-byte cp.async.  S = Q K^T, dP = dO V^T and
//     walk 2's S^T, dP^T read both operands through descriptors
//     (wgmma m64nNk16, N = the step's 32 queries or 64 keys); dV += P^T
//     dO, dK += dS^T Q and dQ += dS K take A from registers (the S^T, dP^T
//     or dP accumulators re-packed as bf16 fragments) and B from the same
//     tiles read MN-major (the transpose flag), N = Dh.  A warp's rows of
//     every accumulator sit in mma.sync's fragment layout, so the
//     elementwise work is the FA2 register code.  (A fence.proxy.async
//     orders the cp.async writes before the products read them.)
//   - Dh 256 on the tensor cores.  A warpgroup's 64 keys x 256 columns of
//     dK and dV would be 256 f32 registers a thread, so at Dh 256 two
//     warpgroups share the 64 keys of walk 2: each owns 128 columns of dK
//     and dV (128 registers).  S^T and dP^T contract over all 256 columns:
//     each warpgroup takes its 128, and each warp pair swaps the partial
//     sums through shared memory and adds them (a + b on one warp, b + a on
//     the other: the same bits), rather than both running the whole
//     contraction (two more products a step).  The query walks split the
//     other way: both warpgroups take the same 64 rows and half of each
//     64-key step, and sum their D and dQ in warpgroup order at the end.
//   - Filling the card.  At the hybrid's shape walk 2 has 8 key tiles x 1
//     KV head x 4 rows = 32 blocks for 132 SMs.  The wrapper splits the G
//     query heads of a group across n_split blocks (the fewest that reach
//     one block an SM: 5 there), each writes its f32 partial dK and dV (2
//     MB each a split), and reduce_kernel sums them in split order.
//   - Copies under compute.  Every walk streams its tiles (walk 2: 32-row
//     Q and dO steps with their lse, D and positions; walks 1 and 3: 64-key
//     K and V steps) through a two-stage cp.async ring (a third stage
//     measured no faster): after a step's one barrier its block issues the
//     next step's copies, then computes.  Which steps a block visits is
//     known before it walks: meta_kernel first writes each 64-key tile's
//     min/max valid position and whether all its slots are valid, each
//     32-row step's min/max query position and, per head, whether the step
//     holds a row with no valid key, and a block compacts its visited steps
//     into a list in shared memory, each marked when no pair in it is
//     masked: such steps skip the mask arithmetic.  P is
//     2^(S log2(e)/sqrt(Dh) - lse log2(e)) on the SFU (ex2.approx).
//   - dS enters dK's and dQ's products as two bf16 terms (hi + the rounding
//     error lo), about 16 bits of its f32 value, so dQ and dK keep to the
//     f32 plain version's rounding where one bf16 term would not (the CPU
//     emulation puts one term up to 4x past the bound).
//   What bounds it now (tools/flash_bwd_ab.py, H100 80GB HBM3 at 700 W):
//   the walks' parts run in series.  At qwen3's shape the call takes 0.230
//   device ms; issuing no product it takes 0.140, issuing no copy 0.176,
//   neither 0.079 (barriers, per-block set-up, elementwise work), and with
//   every block stopping after its first step 0.103: qwen3's causal walks
//   are short (4.5 steps a query tile), so a block's set-up (its metadata,
//   its list, its first tiles' copies) weighs.  A block waits for its
//   step, runs its products, its elementwise work and its next products in
//   turn, and the one or two blocks an SM that the registers allow (walk
//   2's dK, dV accumulators: 128 a thread at Dh 128) hide little of it.  A
//   producer warp with TMA and two consumer warpgroups taking turns over
//   persistent blocks (FA3's shape) is the next step (ROADMAP).
// * CUDA cores (float32, whose tensor-core product would be TF32), the
//   first version: f32 FMAs fed from shared memory by a 16 x 16 thread
//   grid that owns 4 x 4 (2 x 2 at Dh 256) register tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// CUDA-core body: float32 at Dh 64, 128 and 256
// ---------------------------------------------------------------------------

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
// tensor-core body: bfloat16 at Dh 64, 128 and 256
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
using repro::pack_bf16;

constexpr int kKeyTile = 64;    // keys a dK/dV block holds, 16 a key group
constexpr int kQStep = 32;      // query rows a dK/dV step takes
constexpr int kRows = 64;       // query rows a walk block holds, 16 a group
constexpr int kKStep = 64;      // keys a walk step takes (= kKeyTile)
constexpr int kMetaWarps = 8;
constexpr int kFull = 1 << 30;  // a visit list entry's mark: no pair masked
constexpr float kLog2e = 1.4426950408889634f;

// warps that share one 16-row group: at Dh 256 two, each with half of it
template <int DH>
__host__ __device__ constexpr int split() {
  return DH == 256 ? 2 : 1;
}

template <int DH>
__host__ __device__ constexpr int threads() {
  return 128 * split<DH>();
}

// depth of the rings
constexpr int kStages = 2;

// the block's dynamic shared memory from its first 1024-byte boundary (the
// swizzle's period, which wgmma reads addresses against)
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  return smem_raw + ((1024 - (a & 1023)) & 1023);
}

template <int DH>
constexpr size_t dkdv_smem_bytes() {
  constexpr int T = threads<DH>();
  constexpr int NS = kStages;
  return 1024 +
         sizeof(bf16) * (2 * (size_t)kKeyTile * DH + 2 * NS * kQStep * DH) +
         NS * (2 * sizeof(float) + sizeof(int)) * kQStep +
         (split<DH>() > 1 ? sizeof(float) * T * (kQStep / 8) * 8 : 0) +
         sizeof(int) * (T + T / 32);
}

template <int DH>
constexpr size_t walk_smem_bytes() {
  constexpr int T = threads<DH>();
  constexpr int NS = kStages;
  return 1024 +
         sizeof(bf16) * (2 * (size_t)kRows * DH + 2 * NS * kKStep * DH) +
         NS * sizeof(int) * kKStep + sizeof(int) * (T + T / 32);
}

// 2^x on the SFU (ex2.approx.ftz: relative error about 2^-22)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// whether every (query, key) pair of a query range with positions in [qlo,
// qhi] and a full key tile (km.z) is valid
__device__ __forceinline__ bool all_pairs(int qlo, int qhi, int4 km,
                                          int causal, int window) {
  return km.z && !(causal && km.y > qlo) &&
         !(window > 0 && (long long)km.x <= (long long)qhi - window);
}

__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// element offset of 16-byte chunk c of row r in a [ROWS][DH] bf16 tile
// kept as DH/64 slabs of [ROWS][64]: the GMMA K-major layout with its
// 128-byte swizzle (a slab row's eight chunks XOR-ed by row % 8), which
// wgmma reads through a descriptor; every tile starts 1024-byte aligned
template <int ROWS>
__device__ __forceinline__ int sw(int r, int c) {
  return (c >> 3) * (ROWS * 64) + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

// ROWS rows of a (B,S,heads,DH) bf16 tensor into a [ROWS][DH] smem tile
// (``sw``) by 16-byte cp.async, rows past S zero
template <int DH, int T, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int b,
                                          int r0, int S, int heads,
                                          int head) {
  constexpr int CH = DH / 8;
  for (int x = threadIdx.x; x < ROWS * CH; x += T) {
    const int r = x / CH, c = x % CH, ri = r0 + r;
    const bool ok = ri < S;
    repro::cp_async16(
        dst + sw<ROWS>(r, c),
        src + (((size_t)b * S + (ok ? ri : 0)) * heads + head) * DH + c * 8,
        ok);
  }
}

// Every thread: the ids of the items whose ``flag`` holds, one item a
// thread, compacted in thread order into ``list``; returns their count.
template <int T>
__device__ __forceinline__ int compact(bool flag, int id, int* list,
                                       int* warp_n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_n[warp] = __popc(m);
  __syncthreads();
  int pos = __popc(m & ((1u << lane) - 1u)), total = 0;
#pragma unroll
  for (int w = 0; w < T / 32; ++w) {
    const int c = warp_n[w];
    pos += w < warp ? c : 0;
    total += c;
  }
  if (flag) list[pos] = id;
  __syncthreads();
  return total;
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

// the wgmma descriptor of a 128-byte-swizzled operand at ``p``: 8-row
// groups 1024 bytes apart, ``lbo`` bytes between 64-column slabs (read
// only when an MN-major operand spans several)
__device__ __forceinline__ uint64_t gmma_desc(const bf16* p, uint32_t lbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// K-major: 16-column slice kk of rows r0.. of a [ROWS][DH] tile
template <int ROWS>
__device__ __forceinline__ uint64_t slice_desc(const bf16* t, int r0,
                                               int kk) {
  return gmma_desc(t + (kk >> 2) * (ROWS * 64) + r0 * 64 + (kk & 3) * 16,
                   16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// cp.async writes into shared memory, seen by the async proxy wgmma reads
// through
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 32, this warp's 16 rows) (+)= A B^T for one 16-column slice
__device__ __forceinline__ void wgmma_n32(float (&d)[4][4], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64) (+)= A B^T for one 16-column slice
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(acc));
}

// MN-major: rows r0.. (the K of a product) and columns c0.. (its N, a
// multiple of 64) of a [ROWS][DH] tile, its slabs ROWS * 128 bytes apart
template <int ROWS>
__device__ __forceinline__ uint64_t mn_desc(const bf16* t, int r0, int c0) {
  return gmma_desc(t + (c0 >> 6) * (ROWS * 64) + r0 * 64, ROWS * 128);
}

// d (64 x 8*NC) += A B for 16 rows of B: A this warp's 16 x 16 fragment in
// registers (mma.sync's A layout), B MN-major behind a descriptor (the
// transpose flag set): dV += P^T dO, dK += dS^T Q, dQ += dS K
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16][4],
                                         const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32][4],
                                         const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the accumulators are read and written only after the wait
template <int NC>
__device__ __forceinline__ void fence_operands(float (&d)[NC][4]) {
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}

// two products of one warpgroup over the KK 16-column slices from kk0:
// c = A B^T and e = C E^T, A and C 64 rows at a0 of [RA][DH] tiles, B and
// E 8*NB rows at b0 of [RB][DH] tiles; each warp gets its 16 rows of c and
// e in mma.sync's accumulator layout
template <int RA, int RB, int NB, int KK>
__device__ __forceinline__ void two_products(const bf16* a_s, const bf16* b_s,
                                             const bf16* c_s, const bf16* e_s,
                                             int a0, int b0, int kk0,
                                             float (&c)[NB][4],
                                             float (&e)[NB][4]) {
  wgmma_fence();
#pragma unroll
  for (int x = 0; x < KK; ++x) {
    const int kk = kk0 + x;
    const uint64_t da = slice_desc<RA>(a_s, a0, kk);
    const uint64_t db = slice_desc<RB>(b_s, b0, kk);
    const uint64_t dc = slice_desc<RA>(c_s, a0, kk);
    const uint64_t de = slice_desc<RB>(e_s, b0, kk);
    if constexpr (NB == 4) {
      wgmma_n32(c, da, db, x);
      wgmma_n32(e, dc, de, x);
    } else {
      wgmma_n64(c, da, db, x);
      wgmma_n64(e, dc, de, x);
    }
  }
  wgmma_commit_wait();
  fence_operands(c);
  fence_operands(e);
}

// acc (16 x 8*NC) scaled, as bfloat16 rows r0.. of a (B,S,heads,DH)
// tensor, columns c0 on
template <int DH, int NC>
__device__ __forceinline__ void store_rows(bf16* dst,
                                           const float (&acc)[NC][4],
                                           float scale, int b, int r0, int S,
                                           int heads, int head, int c0,
                                           int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int ri = r0 + g + 8 * hr;
    if (ri >= S) continue;
    bf16* row =
        dst + (((size_t)b * S + ri) * heads + head) * DH + c0 + 2 * t4;
#pragma unroll
    for (int d = 0; d < NC; ++d)
      *reinterpret_cast<__nv_bfloat162*>(row + d * 8) =
          __floats2bfloat162_rn(acc[d][2 * hr] * scale,
                                acc[d][2 * hr + 1] * scale);
  }
}

// the same unscaled in f32: a split's partial dK or dV
template <int DH, int NC>
__device__ __forceinline__ void store_part(float* dst,
                                           const float (&acc)[NC][4], int b,
                                           int r0, int S, int heads, int head,
                                           int c0, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int ri = r0 + g + 8 * hr;
    if (ri >= S) continue;
    float* row =
        dst + (((size_t)b * S + ri) * heads + head) * DH + c0 + 2 * t4;
#pragma unroll
    for (int d = 0; d < NC; ++d)
      *reinterpret_cast<float2*>(row + d * 8) =
          make_float2(acc[d][2 * hr], acc[d][2 * hr + 1]);
  }
}

// One warp an item: each 64-key tile's (min, max) valid key position (max
// -1: none) and whether all its 64 slots hold valid keys, each 32-row query
// step's (min, max) position, and for each head whether the step holds a
// row with no valid key (lse NEG_INF).
__global__ void __launch_bounds__(kMetaWarps * 32)
meta_kernel(const float* __restrict__ lse, const int* __restrict__ q_pos,
            const int* __restrict__ kv_pos, int4* __restrict__ kmeta,
            int2* __restrict__ qmeta, int* __restrict__ qempty, int B,
            int Sq, int Skv, int H, int n_kt, int n_qs) {
  const int lane = threadIdx.x & 31;
  long long item = (long long)blockIdx.x * kMetaWarps + (threadIdx.x >> 5);
  const long long n1 = (long long)B * n_kt, n2 = (long long)B * n_qs;
  if (item < n1) {
    const int b = (int)(item / n_kt), t = (int)(item % n_kt);
    int lo = INT_MAX, hi = -1, n = 0;
#pragma unroll
    for (int j = lane; j < kKeyTile; j += 32) {
      const int kj = t * kKeyTile + j;
      const int kp = kj < Skv ? kv_pos[(size_t)b * Skv + kj] : -1;
      if (kp >= 0) {
        lo = min(lo, kp);
        hi = max(hi, kp);
      }
      n += __popc(__ballot_sync(0xffffffffu, kp >= 0));
    }
    lo = repro::warp_min_int(lo);
    hi = repro::warp_max_int(hi);
    if (lane == 0) kmeta[item] = make_int4(lo, hi, n == kKeyTile, 0);
    return;
  }
  item -= n1;
  if (item < n2) {
    const int b = (int)(item / n_qs), qi = (int)(item % n_qs) * kQStep + lane;
    const bool in = qi < Sq;
    const int qp = in ? q_pos[(size_t)b * Sq + qi] : 0;
    const int lo = repro::warp_min_int(in ? qp : INT_MAX);
    const int hi = repro::warp_max_int(in ? qp : INT_MIN);
    if (lane == 0) qmeta[item] = make_int2(lo, hi);
    return;
  }
  item -= n2;
  if (item < (long long)B * H * n_qs) {
    const long long bh = item / n_qs;
    const int qi = (int)(item % n_qs) * kQStep + lane;
    const bool e = qi < Sq && no_valid_key(lse[bh * Sq + qi]);
    const bool any = __any_sync(0xffffffffu, e);
    if (lane == 0) qempty[item] = any;
  }
}

// one block of walk 2: keys [kt*64, +64) of KV head hy / n_split, batch
// row b (of B), over query heads split hy % n_split of the group; 16 keys
// a key group of split<DH>() warps.  Walks the visited (head, 32-row step)
// pairs through its ring, holding S^T, dP^T (16 keys x 32 queries) and the
// group's dK, dV columns in registers.
template <int DH>
__device__ __forceinline__ void
dkdv_block(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
            const int4* __restrict__ kmeta, const int2* __restrict__ qmeta,
            const int* __restrict__ qempty, bf16* __restrict__ dk,
            bf16* __restrict__ dv, float* __restrict__ part_k,
            float* __restrict__ part_v, int Sq, int Skv, int H, int Hkv,
            int n_split, int causal, int window, float scale, int kt, int hy,
            int b, int B) {
  constexpr int SP = split<DH>(), T = threads<DH>();
  constexpr int NQ = kQStep / 8;          // 8-query blocks of S^T
  constexpr int COLS = DH / SP;           // dK, dV columns a warp owns
  constexpr int NC = COLS / 8;
  constexpr int KK = DH / 16 / SP;        // 16-column slices a warp contracts
  constexpr int NX = 2 * NQ * 4;          // floats a lane swaps with its pair
  constexpr int NS = kStages;
  bf16* k_s = reinterpret_cast<bf16*>(smem_base());  // [kKeyTile][DH]
  bf16* v_s = k_s + kKeyTile * DH;                  // [kKeyTile][DH]
  bf16* q_st = v_s + kKeyTile * DH;                 // [NS][kQStep][DH]
  bf16* do_st = q_st + NS * kQStep * DH;            // [NS][kQStep][DH]
  float* lse_st = reinterpret_cast<float*>(do_st + NS * kQStep * DH);
  float* dl_st = lse_st + NS * kQStep;              // [NS][kQStep]
  int* qp_st = reinterpret_cast<int*>(dl_st + NS * kQStep);
  float* xch = reinterpret_cast<float*>(qp_st + NS * kQStep);  // [T/32][NX][32]
  int* list = reinterpret_cast<int*>(xch + (SP > 1 ? T * NX : 0));
  int* warp_n = list + T;

  const int hk = hy / n_split, sp = hy % n_split;
  const int k0 = kt * kKeyTile;
  const int G = H / Hkv, Gb = G / n_split, h0 = hk * G + sp * Gb;
  const int n_qs = (Sq + kQStep - 1) / kQStep;
  const int n_kt = (Skv + kKeyTile - 1) / kKeyTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kg = warp & 3, hf = warp >> 2;  // key group, column half
  const int t4 = lane & 3;
  const float p_uniform = __bfloat162float(__float2bfloat16(1.0f / Skv));
  const float c2 = scale * kLog2e;         // P = 2^(S c2 - lse log2 e)

  load_tile<DH, T, kKeyTile>(k_s, k, b, k0, Skv, Hkv, hk);
  load_tile<DH, T, kKeyTile>(v_s, v, b, k0, Skv, Hkv, hk);
  repro::cp_async_commit();
  const int4 km = kmeta[(size_t)b * n_kt + kt];
  // this thread's keys: rows g and g + 8 of its group's 16
  int kp[2];
  bool kin[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kj = k0 + kg * 16 + (lane >> 2) + 8 * hr;
    kin[hr] = kj < Skv;
    kp[hr] = kin[hr] ? kv_pos[(size_t)b * Skv + kj] : -1;
  }

  float dk_acc[NC][4], dv_acc[NC][4];
#pragma unroll
  for (int d = 0; d < NC; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.0f;

  // step st: head h0 + st / n_qs, query rows (st % n_qs) * kQStep on
  auto load_step = [&](int st, int stage) {
    const int h = h0 + st / n_qs, q0 = (st % n_qs) * kQStep;
    load_tile<DH, T, kQStep>(q_st + stage * kQStep * DH, q, b, q0, Sq, H, h);
    load_tile<DH, T, kQStep>(do_st + stage * kQStep * DH, dout, b, q0, Sq, H,
                             h);
    if (tid < kQStep) {
      const int qi = q0 + tid;
      const bool in = qi < Sq;
      const size_t row = ((size_t)b * H + h) * Sq + (in ? qi : 0);
      repro::cp_async4(lse_st + stage * kQStep + tid, lse + row, in);
      repro::cp_async4(dl_st + stage * kQStep + tid, delta + row, in);
      repro::cp_async4(qp_st + stage * kQStep + tid,
                       q_pos + (size_t)b * Sq + (in ? qi : 0), in);
    }
  };

  const int n_steps = Gb * n_qs;
  for (int base = 0; base < n_steps; base += T) {
    const int st = base + tid;
    bool visit = false, full = false;
    if (st < n_steps) {
      const int h = h0 + st / n_qs, qs = st % n_qs;
      const int2 qm = qmeta[(size_t)b * n_qs + qs];
      const bool empty = qempty[((size_t)b * H + h) * n_qs + qs];
      visit = empty || tiles_meet(qm.x, qm.y, km.x, km.y, causal, window);
      full = !empty && (qs + 1) * kQStep <= Sq &&
             all_pairs(qm.x, qm.y, km, causal, window);
    }
    const int n = compact<T>(visit, st | (full ? kFull : 0), list, warp_n);
#pragma unroll
    for (int j = 0; j < NS - 1; ++j) {
      if (j < n) load_step(list[j] & ~kFull, j);
      repro::cp_async_commit();
    }
    for (int i = 0; i < n; ++i) {
      repro::cp_async_wait<NS - 2>();
      fence_async_shared();
      __syncthreads();                      // step i landed, step i-1 read
      if (i + NS - 1 < n)
        load_step(list[i + NS - 1] & ~kFull, (i + NS - 1) % NS);
      repro::cp_async_commit();
      const int stage = i % NS;
      const bool full = list[i] & kFull;
      const int q0 = ((list[i] & ~kFull) % n_qs) * kQStep;
      const bf16* q_s = q_st + stage * kQStep * DH;
      const bf16* do_s = do_st + stage * kQStep * DH;
      const float* lse_s = lse_st + stage * kQStep;
      const float* dl_s = dl_st + stage * kQStep;
      const int* qp_s = qp_st + stage * kQStep;

      // S^T = K Q^T and dP^T = V dO^T for the group's 16 keys, over this
      // warp's columns; at Dh 256 the pair adds its halves
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int nb = 0; nb < NQ; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.0f;
      two_products<kKeyTile, kQStep, NQ, KK>(k_s, q_s, v_s, do_s, 0, 0,
                                             hf * KK, s, dp);
      if constexpr (SP > 1) {
        float* mine = xch + warp * NX * 32 + lane;
        const float* other = xch + (warp ^ 4) * NX * 32 + lane;
#pragma unroll
        for (int nb = 0; nb < NQ; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            mine[(nb * 4 + e) * 32] = s[nb][e];
            mine[(NQ * 4 + nb * 4 + e) * 32] = dp[nb][e];
          }
        pair_sync(1 + kg);
#pragma unroll
        for (int nb = 0; nb < NQ; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[nb][e] += other[(nb * 4 + e) * 32];
            dp[nb][e] += other[(NQ * 4 + nb * 4 + e) * 32];
          }
      }

      // P^T (f32; rounded to bf16 when it enters the product, as the
      // forward rounds P before PV) and dS^T, in place; the thread's 8
      // queries' lse (base 2) and D read once
      float L2[NQ][2], Dq[NQ][2];
#pragma unroll
      for (int nb = 0; nb < NQ; ++nb)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          L2[nb][c] = lse_s[nb * 8 + 2 * t4 + c] * kLog2e;
          Dq[nb][c] = dl_s[nb * 8 + 2 * t4 + c];
        }
      if (full) {                           // no pair masked
#pragma unroll
        for (int nb = 0; nb < NQ; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2_approx(s[nb][e] * c2 - L2[nb][e & 1]);
            s[nb][e] = p;
            dp[nb][e] = p * (dp[nb][e] - Dq[nb][e & 1]);
          }
      } else {
#pragma unroll
        for (int nb = 0; nb < NQ; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hr = e >> 1, c = e & 1, r = nb * 8 + 2 * t4 + c;
            float p = 0.0f, ds = 0.0f;
            if (kin[hr] && q0 + r < Sq) {
              if (no_valid_key(lse_s[r])) {
                p = p_uniform;
              } else if (pair_ok(qp_s[r], kp[hr], causal, window)) {
                p = exp2_approx(s[nb][e] * c2 - L2[nb][c]);
                ds = p * (dp[nb][e] - Dq[nb][c]);
              }
            }
            s[nb][e] = p;
            dp[nb][e] = ds;
          }
      }

      // dV += P^T dO, dK += dS^T Q over this warpgroup's columns, 16
      // queries at a time
      uint32_t ap[kQStep / 16][4], ah[kQStep / 16][4], al[kQStep / 16][4];
#pragma unroll
      for (int kk = 0; kk < kQStep / 16; ++kk) {
        pack_a(s[2 * kk], s[2 * kk + 1], ap[kk]);
        split_a(dp[2 * kk], dp[2 * kk + 1], ah[kk], al[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQStep / 16; ++kk) {
        wgmma_rs(dv_acc, ap[kk], mn_desc<kQStep>(do_s, kk * 16, hf * COLS));
        const uint64_t dq_ = mn_desc<kQStep>(q_s, kk * 16, hf * COLS);
        wgmma_rs(dk_acc, ah[kk], dq_);
        wgmma_rs(dk_acc, al[kk], dq_);
      }
      wgmma_commit_wait();
      fence_operands(dv_acc);
      fence_operands(dk_acc);
    }
  }

  repro::cp_async_wait<0>();                // a block that visited nothing
  const int r0 = k0 + kg * 16, c0 = hf * COLS;
  if (n_split == 1) {
    store_rows<DH, NC>(dk, dk_acc, scale, b, r0, Skv, Hkv, hk, c0, lane);
    store_rows<DH, NC>(dv, dv_acc, 1.0f, b, r0, Skv, Hkv, hk, c0, lane);
  } else {
    const size_t off = (size_t)sp * B * Skv * Hkv * DH;
    store_part<DH, NC>(part_k + off, dk_acc, b, r0, Skv, Hkv, hk, c0, lane);
    store_part<DH, NC>(part_v + off, dv_acc, b, r0, Skv, Hkv, hk, c0, lane);
  }
}

// dK = scale * (sum of the splits' partials), dV = their sum, in split
// order, as bfloat16; n a multiple of 4
__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ part_k,
              const float* __restrict__ part_v, bf16* __restrict__ dk,
              bf16* __restrict__ dv, long long n, int n_split, float scale) {
  for (long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
       i < n; i += 4LL * gridDim.x * blockDim.x) {
    float4 sk = *reinterpret_cast<const float4*>(part_k + i);
    float4 sv = *reinterpret_cast<const float4*>(part_v + i);
    for (int s = 1; s < n_split; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(part_k + s * n + i);
      const float4 c = *reinterpret_cast<const float4*>(part_v + s * n + i);
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
    }
    __nv_bfloat162* ok = reinterpret_cast<__nv_bfloat162*>(dk + i);
    __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(dv + i);
    ok[0] = __floats2bfloat162_rn(sk.x * scale, sk.y * scale);
    ok[1] = __floats2bfloat162_rn(sk.z * scale, sk.w * scale);
    ov[0] = __floats2bfloat162_rn(sv.x, sv.y);
    ov[1] = __floats2bfloat162_rn(sv.z, sv.w);
  }
}

// one block of walk 1 or 3: query rows [qt*64, +64) of head h, batch row
// b, 16 a row group of split<DH>() warps, each warp taking its share of
// every visited 64-key step; with kDelta it writes D = rowsum(P o dP), else
// dQ (reading D)
template <int DH, bool kDelta>
__device__ __forceinline__ void
walk_block(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta,
              const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
              const int4* __restrict__ kmeta, const int2* __restrict__ qmeta,
              const int* __restrict__ qempty, bf16* __restrict__ dq, int Sq,
              int Skv, int H, int Hkv, int causal, int window, float scale,
              int qt, int h, int b) {
  constexpr int SP = split<DH>(), T = threads<DH>();
  constexpr int KW = kKStep / SP;           // keys a warp takes a step
  constexpr int NB = KW / 8;
  constexpr int DB = DH / 8;
  constexpr int NS = kStages;
  bf16* q_s = reinterpret_cast<bf16*>(smem_base());  // [kRows][DH]
  bf16* do_s = q_s + kRows * DH;                    // [kRows][DH]
  bf16* k_st = do_s + kRows * DH;                   // [NS][kKStep][DH]
  bf16* v_st = k_st + NS * kKStep * DH;             // [NS][kKStep][DH]
  int* kp_st = reinterpret_cast<int*>(v_st + NS * kKStep * DH);  // [NS][kKStep]
  int* list = kp_st + NS * kKStep;
  int* warp_n = list + T;

  const int q0 = qt * kRows, hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp & 3, kh = warp >> 2;  // row group, key half
  const int t4 = lane & 3;
  const int n_qs = (Sq + kQStep - 1) / kQStep;
  const int n_kt = (Skv + kKStep - 1) / kKStep;

  load_tile<DH, T, kRows>(q_s, q, b, q0, Sq, H, h);
  load_tile<DH, T, kRows>(do_s, dout, b, q0, Sq, H, h);
  repro::cp_async_commit();
  // this thread's rows: g and g + 8 of its group's 16
  int qp[2];
  bool live[2];
  float L2[2], D[2];                        // lse in base 2, D
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + rg * 16 + (lane >> 2) + 8 * hr;
    const bool in = qi < Sq;
    const size_t row = ((size_t)b * H + h) * Sq + (in ? qi : 0);
    const float L = in ? lse[row] : 0.0f;
    qp[hr] = in ? q_pos[(size_t)b * Sq + qi] : 0;
    L2[hr] = L * kLog2e;
    D[hr] = in && !kDelta ? delta[row] : 0.0f;
    live[hr] = in && !no_valid_key(L);
  }
  const float c2 = scale * kLog2e;
  // the block's query positions: its two 32-row steps; whether all 64 rows
  // are in range and have a valid key
  const size_t qs0 = (size_t)b * n_qs + 2 * qt;
  const size_t qe0 = ((size_t)b * H + h) * n_qs + 2 * qt;
  int2 qm = qmeta[qs0];
  bool rows_full = q0 + kRows <= Sq && !qempty[qe0];
  if (2 * qt + 1 < n_qs) {
    const int2 q2 = qmeta[qs0 + 1];
    qm = make_int2(min(qm.x, q2.x), max(qm.y, q2.y));
    rows_full = rows_full && !qempty[qe0 + 1];
  }

  float acc[kDelta ? 1 : DB][4];            // dQ rows, or unused
  float dsum[2] = {0.0f, 0.0f};             // D's partial row sums
#pragma unroll
  for (int d = 0; d < (kDelta ? 1 : DB); ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.0f;

  auto load_kv = [&](int t, int stage) {
    const int k0 = t * kKStep;
    load_tile<DH, T, kKStep>(k_st + stage * kKStep * DH, k, b, k0, Skv, Hkv,
                             hk);
    load_tile<DH, T, kKStep>(v_st + stage * kKStep * DH, v, b, k0, Skv, Hkv,
                             hk);
    if (tid < kKStep) {
      const int kj = k0 + tid;
      const bool in = kj < Skv;
      repro::cp_async4(kp_st + stage * kKStep + tid,
                       kv_pos + (size_t)b * Skv + (in ? kj : 0), in);
    }
  };

  for (int base = 0; base < n_kt; base += T) {
    const int t = base + tid;
    bool visit = false, full = false;       // rows with no valid key add 0
    if (t < n_kt) {
      const int4 km = kmeta[(size_t)b * n_kt + t];
      visit = tiles_meet(qm.x, qm.y, km.x, km.y, causal, window);
      full = rows_full && all_pairs(qm.x, qm.y, km, causal, window);
    }
    const int n = compact<T>(visit, t | (full ? kFull : 0), list, warp_n);
#pragma unroll
    for (int j = 0; j < NS - 1; ++j) {
      if (j < n) load_kv(list[j] & ~kFull, j);
      repro::cp_async_commit();
    }
    for (int i = 0; i < n; ++i) {
      repro::cp_async_wait<NS - 2>();
      fence_async_shared();
      __syncthreads();                      // step i landed, step i-1 read
      if (i + NS - 1 < n) load_kv(list[i + NS - 1] & ~kFull, (i + NS - 1) % NS);
      repro::cp_async_commit();
      const int stage = i % NS;
      const bool full = list[i] & kFull;
      const int k0 = (list[i] & ~kFull) * kKStep;
      const bf16* k_s = k_st + stage * kKStep * DH;
      const bf16* v_s = v_st + stage * kKStep * DH;
      const int* kp_s = kp_st + stage * kKStep;

      // S = Q K^T and dP = dO V^T for the group's 16 rows over this warp's
      // keys
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.0f;
      two_products<kRows, kKStep, NB, DH / 16>(q_s, k_s, do_s, v_s, 0,
                                               kh * KW, 0, s, dp);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1, j = kh * KW + nb * 8 + 2 * t4 + (e & 1);
          float p = 0.0f;
          if (full || (live[hr] && k0 + j < Skv &&
                       pair_ok(qp[hr], kp_s[j], causal, window)))
            p = exp2_approx(s[nb][e] * c2 - L2[hr]);
          if (kDelta)
            dsum[hr] = fmaf(p, dp[nb][e], dsum[hr]);
          else
            dp[nb][e] = p * (dp[nb][e] - D[hr]);
        }
      if constexpr (!kDelta) {
        // dQ += dS K, 16 keys at a time
        uint32_t ah[KW / 16][4], al[KW / 16][4];
#pragma unroll
        for (int kk = 0; kk < KW / 16; ++kk)
          split_a(dp[2 * kk], dp[2 * kk + 1], ah[kk], al[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KW / 16; ++kk) {
          const uint64_t dk_ = mn_desc<kKStep>(k_s, kh * KW + kk * 16, 0);
          wgmma_rs(acc, ah[kk], dk_);
          wgmma_rs(acc, al[kk], dk_);
        }
        wgmma_commit_wait();
        fence_operands(acc);
      }
    }
  }

  // at Dh 256 the second warp of each row group hands its sums to the
  // first through the (drained) ring, which adds them in warp order
  repro::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(k_st);
  if constexpr (kDelta) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      dsum[hr] += __shfl_xor_sync(0xffffffffu, dsum[hr], 1);
      dsum[hr] += __shfl_xor_sync(0xffffffffu, dsum[hr], 2);
    }
    if constexpr (SP > 1) {
      if (kh == 1) {
        red[(rg * 2) * 32 + lane] = dsum[0];
        red[(rg * 2 + 1) * 32 + lane] = dsum[1];
      }
      __syncthreads();
      if (kh == 1) return;
      dsum[0] += red[(rg * 2) * 32 + lane];
      dsum[1] += red[(rg * 2 + 1) * 32 + lane];
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = q0 + rg * 16 + (lane >> 2) + 8 * hr;
      if (t4 == 0 && qi < Sq) delta[((size_t)b * H + h) * Sq + qi] = dsum[hr];
    }
  } else {
    if constexpr (SP > 1) {
      float* mine = red + (size_t)rg * DB * 4 * 32 + lane;
      if (kh == 1) {
#pragma unroll
        for (int d = 0; d < DB; ++d)
#pragma unroll
          for (int e = 0; e < 4; ++e) mine[(d * 4 + e) * 32] = acc[d][e];
      }
      __syncthreads();
      if (kh == 1) return;
#pragma unroll
      for (int d = 0; d < DB; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][e] += mine[(d * 4 + e) * 32];
    }
    store_rows<DH, DB>(dq, acc, scale, b, q0 + rg * 16, Sq, H, h, 0, lane);
  }
}

// walk 1: D of every (query tile, head, b)
template <int DH>
__global__ void __launch_bounds__(threads<DH>())
delta_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ delta,
             const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
             const int4* __restrict__ kmeta, const int2* __restrict__ qmeta,
             const int* __restrict__ qempty, int Sq, int Skv, int H, int Hkv,
             int causal, int window, float scale) {
  walk_block<DH, true>(q, k, v, dout, lse, delta, q_pos, kv_pos, kmeta,
                       qmeta, qempty, nullptr, Sq, Skv, H, Hkv, causal,
                       window, scale, blockIdx.x, blockIdx.y, blockIdx.z);
}

// walks 2 and 3 in one launch, as they need only D: the first n_kt * Hkv *
// n_split * B blocks each one of walk 2 (the longer, so they start first),
// the rest each one of walk 3, so either walk's last wave shares the card
// with the other
template <int DH>
__global__ void __launch_bounds__(threads<DH>())
grads_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ delta,
             const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
             const int4* __restrict__ kmeta, const int2* __restrict__ qmeta,
             const int* __restrict__ qempty, bf16* __restrict__ dq,
             bf16* __restrict__ dk, bf16* __restrict__ dv,
             float* __restrict__ part_k, float* __restrict__ part_v, int B,
             int Sq, int Skv, int H, int Hkv, int n_split, int causal,
             int window, float scale) {
  const int n_kt = (Skv + kKeyTile - 1) / kKeyTile;
  const int n_qt = (Sq + kRows - 1) / kRows;
  const int ny = Hkv * n_split;
  int i = blockIdx.x;
  if (i < n_kt * ny * B) {
    dkdv_block<DH>(q, k, v, dout, lse, delta, q_pos, kv_pos, kmeta, qmeta,
                   qempty, dk, dv, part_k, part_v, Sq, Skv, H, Hkv, n_split,
                   causal, window, scale, i % n_kt, (i / n_kt) % ny,
                   i / (n_kt * ny), B);
    return;
  }
  i -= n_kt * ny * B;
  walk_block<DH, false>(q, k, v, dout, lse, delta, q_pos, kv_pos, kmeta,
                        qmeta, qempty, dq, Sq, Skv, H, Hkv, causal, window,
                        scale, i % n_qt, (i / n_qt) % H, i / (n_qt * H));
}

}  // namespace tc

// Bytes of scratch a call needs, and where each part lies: D (B,H,Sq) f32;
// for the tensor-core body the tile and step metadata and, when the query
// heads are split, the splits' f32 partial dK and dV.
struct Workspace {
  float* delta;
  int4* kmeta;
  int2* qmeta;
  int* qempty;
  float* part_k;
  float* part_v;
  size_t bytes;
};

Workspace carve(void* base, int B, int Sq, int Skv, int H, int Hkv, int Dh,
                int tensor_cores, int n_split) {
  Workspace w{};
  char* p = static_cast<char*>(base);
  size_t off = 0;
  auto take = [&](size_t bytes) -> void* {
    void* at = p ? p + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return at;
  };
  w.delta = static_cast<float*>(take(sizeof(float) * B * H * (size_t)Sq));
  if (tensor_cores) {
    const size_t n_kt = (Skv + tc::kKeyTile - 1) / tc::kKeyTile;
    const size_t n_qs = (Sq + tc::kQStep - 1) / tc::kQStep;
    w.kmeta = static_cast<int4*>(take(sizeof(int4) * B * n_kt));
    w.qmeta = static_cast<int2*>(take(sizeof(int2) * B * n_qs));
    w.qempty = static_cast<int*>(take(sizeof(int) * B * H * n_qs));
    if (n_split > 1) {
      const size_t part = sizeof(float) * n_split * B * (size_t)Skv * Hkv * Dh;
      w.part_k = static_cast<float*>(take(part));
      w.part_v = static_cast<float*>(take(part));
    }
  }
  w.bytes = off;
  return w;
}

namespace tc {

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const int* q_pos,
                   const int* kv_pos, void* dq, void* dk, void* dv,
                   const Workspace& w, int B, int Sq, int Skv, int H,
                   int Hkv, int n_split, int causal, int window,
                   cudaStream_t stream) {
  static size_t allowed_d[8] = {0}, allowed_g[8] = {0};
  constexpr int T = threads<DH>();
  auto kd = delta_kernel<DH>;
  auto kg = grads_kernel<DH>;
  constexpr size_t s1 = dkdv_smem_bytes<DH>(), s2 = walk_smem_bytes<DH>();
  constexpr size_t sg = s1 > s2 ? s1 : s2;
  cudaError_t e = repro::allow_smem(kd, s2, allowed_d);
  if (e != cudaSuccess) return e;
  e = repro::allow_smem(kg, sg, allowed_g);
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf((float)DH);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const int n_kt = (Skv + kKeyTile - 1) / kKeyTile;
  const int n_qs = (Sq + kQStep - 1) / kQStep;
  const int n_qt = (Sq + kRows - 1) / kRows;
  const long long items =
      (long long)B * n_kt + (long long)B * n_qs + (long long)B * H * n_qs;
  meta_kernel<<<(unsigned)((items + kMetaWarps - 1) / kMetaWarps),
                kMetaWarps * 32, 0, stream>>>(lse, q_pos, kv_pos, w.kmeta,
                                              w.qmeta, w.qempty, B, Sq, Skv,
                                              H, n_kt, n_qs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kd<<<dim3(n_qt, H, B), T, s2, stream>>>(
      qt, kt, vt, dot, lse, w.delta, q_pos, kv_pos, w.kmeta, w.qmeta,
      w.qempty, Sq, Skv, H, Hkv, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long blocks =
      (long long)n_kt * Hkv * n_split * B + (long long)n_qt * H * B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kg<<<(unsigned)blocks, T, sg, stream>>>(
      qt, kt, vt, dot, lse, w.delta, q_pos, kv_pos, w.kmeta, w.qmeta,
      w.qempty, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), w.part_k, w.part_v, B, Sq, Skv, H, Hkv, n_split,
      causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return e;
  const long long n = (long long)B * Skv * Hkv * DH;
  const long long want = (n / 4 + 255) / 256;
  reduce_kernel<<<(unsigned)(want < 65535 ? want : 65535), 256, 0, stream>>>(
      w.part_k, w.part_v, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n,
      n_split, scale);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const int* q_pos,
                      const int* kv_pos, void* dq, void* dk, void* dv,
                      float* delta, int B, int Sq, int Skv, int H, int Hkv,
                      int Dh, int causal, int window, cudaStream_t s) {
  if (Dh == 64)
    return launch<T, 64>(q, k, v, dout, lse, q_pos, kv_pos, dq, dk, dv,
                         delta, B, Sq, Skv, H, Hkv, causal, window, s);
  if (Dh == 128)
    return launch<T, 128>(q, k, v, dout, lse, q_pos, kv_pos, dq, dk, dv,
                          delta, B, Sq, Skv, H, Hkv, causal, window, s);
  if (Dh == 256)
    return launch<T, 256>(q, k, v, dout, lse, q_pos, kv_pos, dq, dk, dv,
                          delta, B, Sq, Skv, H, Hkv, causal, window, s);
  return cudaErrorInvalidValue;
}

cudaError_t tc_dh(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const int* q_pos,
                  const int* kv_pos, void* dq, void* dk, void* dv,
                  const Workspace& w, int B, int Sq, int Skv, int H, int Hkv,
                  int Dh, int n_split, int causal, int window,
                  cudaStream_t s) {
  if (Dh == 64)
    return tc::launch<64>(q, k, v, dout, lse, q_pos, kv_pos, dq, dk, dv, w,
                          B, Sq, Skv, H, Hkv, n_split, causal, window, s);
  if (Dh == 128)
    return tc::launch<128>(q, k, v, dout, lse, q_pos, kv_pos, dq, dk, dv, w,
                           B, Sq, Skv, H, Hkv, n_split, causal, window, s);
  if (Dh == 256)
    return tc::launch<256>(q, k, v, dout, lse, q_pos, kv_pos, dq, dk, dv, w,
                           B, Sq, Skv, H, Hkv, n_split, causal, window, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Bytes of the scratch ``flash_attention_bwd`` needs for these shapes, body
// and split (0 if they are invalid).
extern "C" long long flash_attention_bwd_workspace(int B, int Sq, int Skv,
                                                   int H, int Hkv, int Dh,
                                                   int tensor_cores,
                                                   int n_split) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      n_split <= 0)
    return 0;
  return (long long)carve(nullptr, B, Sq, Skv, H, Hkv, Dh, tensor_cores,
                          n_split)
      .bytes;
}

// q, dq, dout: (B,Sq,H,Dh); k, v, dk, dv: (B,Skv,Hkv,Dh); all contiguous,
// of one dtype (0 = float32, 1 = bfloat16).  lse: (B,H,Sq) float32 from
// flash_attention_fwd; workspace: flash_attention_bwd_workspace bytes.
// tensor_cores: 1 = the wgmma body (bfloat16 at Dh 64, 128 or 256, every
// tensor 16-byte aligned; its dK/dV walk splits each group's query heads
// over n_split blocks, n_split dividing H / Hkv), 0 = the CUDA-core body
// (float32 at Dh 64, 128, 256; n_split 1).  Launches its kernels on
// ``stream`` (tensor cores: metadata, D, dK/dV with dQ, and the splits'
// sum when n_split > 1; CUDA cores: D, dK/dV, dQ); returns the cudaError_t
// of the launches (0 = success).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const int* q_pos,
                                   const int* kv_pos, void* dq, void* dk,
                                   void* dv, void* workspace, int B, int Sq,
                                   int Skv, int H, int Hkv, int Dh,
                                   int causal, int window, int dtype,
                                   int tensor_cores, int n_split,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      B > 65535 || H > 65535 || n_split <= 0 || (H / Hkv) % n_split != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Workspace w =
      carve(workspace, B, Sq, Skv, H, Hkv, Dh, tensor_cores, n_split);
  if (tensor_cores) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)tc_dh(q, k, v, dout, lse, q_pos, kv_pos, dq, dk, dv, w, B,
                      Sq, Skv, H, Hkv, Dh, n_split, causal, window, s);
  }
  if (dtype != 0 || n_split != 1) return (int)cudaErrorInvalidValue;
  return (int)launch_dh<float>(q, k, v, dout, lse, q_pos, kv_pos, dq, dk, dv,
                               w.delta, B, Sq, Skv, H, Hkv, Dh, causal,
                               window, s);
}
