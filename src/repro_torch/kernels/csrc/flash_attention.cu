// Flash prefill attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py,
// flash_attention_kernel (body _flash_kernel): GQA attention of q
// (B,Sq,H,Dh) over k/v (B,Skv,Hkv,Dh) with a mask formed from explicit
// int32 positions (-1 = invalid slot): kp >= 0, kp <= qp when causal,
// kp > qp - window when window > 0.  Online softmax in f32 over KV tiles,
// PV accumulated in f32, output normalised and written in q's dtype.  As
// in the Pallas kernel, masked logits are NEG_INF but p is not zeroed, so
// a row with no valid key averages V uniformly over all Skv keys.
//
// What bounds it on the H100: at the engine's prefill shapes (qwen3's
// 512-query chunk over 544 keys, H=16, Dh=128; the hybrid's 384-token
// prompt, H=10, Hkv=1, Dh=256; bf16) the causal work is 0.6-1.2 GFLOP
// against 2-6 MB of q/k/v/out traffic, near the card's ridge point (~295
// FLOP/byte in bf16): either bound is ~1-2 us.  Only the tensor cores come
// near it; f32 FMAs on the CUDA cores (67 TFLOP/s) cannot.
//
// Two bodies, chosen by the wrapper (flash_attention/ops.py):
//
// * tensor cores (bf16, Dh 64/128/256), namespace tc.  QK^T and PV run as
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate) in the FA2 register
//   layout: each warp owns 16 query rows; Q and K fragments come from
//   shared memory by ldmatrix, P stays in registers (the S accumulator
//   re-packed as bf16 A fragments) and V is read by ldmatrix.trans, so no
//   transposed copy of V exists.  Tiles live in shared memory as bf16 with
//   16-byte chunks XOR-swizzled by row, so ldmatrix's eight row addresses
//   hit eight banks.  At these shapes there are too few 16-row query
//   groups to fill the card (qwen3's chunk: 512 warps' worth for 132 SMs),
//   so a block of 64 query rows of one head holds two warpgroups that
//   split its KV tiles (even and odd entries of its walk) and merge their
//   (o, m, l) by the log-sum-exp rule through shared memory at the end.
//   Each warpgroup streams its K/V tiles (64 keys, 32 at Dh=256 to keep a
//   warp's 16x256 f32 accumulator in registers) through its own two-stage
//   ring filled with 16-byte cp.async on neighbouring threads, synchronised
//   by its own named barrier: the next tile's copies are in flight while
//   the current one is computed.  A prologue reads the block's query
//   positions and every tile's min/max valid key position and keeps only
//   the tiles where some (query, key) pair can be valid (causal: kmin <=
//   max qp; window: kmax > min qp - window), whatever the order of the
//   positions.  Skipping is exact for a row with a valid key (a masked tile
//   before it is wiped by alpha = exp(NEG_INF - m) = 0, one after it adds
//   p = 0); a row with none must average all Skv keys, so a block that
//   ends its walk with such a row (m still NEG_INF) walks every tile again.
//   The query heads of a group are not folded into one product: each head
//   reads its KV head's tiles through L2.  mma.sync, not wgmma: the FA2
//   register layout needs no shared-memory matrix descriptors and was the
//   shorter way to a kernel that is right; wgmma, TMA and warp
//   specialisation are later work (PERF.md).
// * CUDA cores (float32, and the small Dh 8/16/32 the sweeps use), namespace
//   simt: the first version, kept because a tensor-core f32 product is TF32
//   and would break the f32 checks.  One block per (32-row q tile, head);
//   each 64-key tile is staged as f32 and reused by the 32 rows, one warp
//   per row at a time; it walks every tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <type_traits>
#include <stdint.h>

#include "common.cuh"

namespace simt {

constexpr int kBlockQ = 32;                 // query rows per block
constexpr int kBlockK = 64;                 // keys per KV tile (2 per lane)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * DH + kBlockK * (DH + 1) + kBlockK * DH) +
         sizeof(int) * kBlockK;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos, T* __restrict__ out,
                       int Sq, int Skv, int H, int Hkv, int causal,
                       int window, float scale) {
  constexpr int DPL = (DH + 31) / 32;       // output columns per lane
  constexpr int KS = DH + 1;                // padded K row stride
  extern __shared__ float smem[];
  float* q_s = smem;                        // [kBlockQ][DH]
  float* k_s = q_s + kBlockQ * DH;          // [kBlockK][KS]
  float* v_s = k_s + kBlockK * KS;          // [kBlockK][DH]
  int* kp_s = reinterpret_cast<int*>(v_s + kBlockK * DH);  // [kBlockK]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < kBlockQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH, qi = q0 + r;
    q_s[i] = qi < Sq
        ? repro::to_float(q[(((size_t)b * Sq + qi) * H + h) * DH + d])
        : 0.0f;
  }

  int qp[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    qp[r] = qi < Sq ? q_pos[(size_t)b * Sq + qi] : -1;
    m[r] = REPRO_NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.0f;
  }

  for (int k0 = 0; k0 < Skv; k0 += kBlockK) {
    __syncthreads();                        // previous tile fully consumed
    for (int i = tid; i < kBlockK * DH; i += kThreads) {
      const int j = i / DH, d = i % DH, kj = k0 + j;
      float kk = 0.0f, vv = 0.0f;
      if (kj < Skv) {
        const size_t off = (((size_t)b * Skv + kj) * Hkv + hk) * DH + d;
        kk = repro::to_float(k[off]);
        vv = repro::to_float(v[off]);
      }
      k_s[j * KS + d] = kk;
      v_s[j * DH + d] = vv;
    }
    for (int j = tid; j < kBlockK; j += kThreads)
      kp_s[j] = k0 + j < Skv ? kv_pos[(size_t)b * Skv + k0 + j] : -1;
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      if (q0 + row >= Sq) continue;          // warp-uniform
      const float* qr = q_s + row * DH;
      float s[2], p[2];
      bool in_range[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        const float* kr = k_s + j * KS;
        float dot = 0.0f;
#pragma unroll
        for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], kr[d], dot);
        const int kp = kp_s[j];
        const bool ok = kp >= 0 && (!causal || kp <= qp[r]) &&
                        (window <= 0 || kp > qp[r] - window);
        in_range[t] = k0 + j < Skv;         // tile padding past Skv
        s[t] = ok ? dot * scale : REPRO_NEG_INF;
      }
      const float tile_max = repro::warp_max(
          fmaxf(in_range[0] ? s[0] : -INFINITY, in_range[1] ? s[1] : -INFINITY));
      const float alpha = repro::online_softmax_rescale(m[r], tile_max);
#pragma unroll
      for (int t = 0; t < 2; ++t)
        p[t] = in_range[t] ? expf(s[t] - m[r]) : 0.0f;
      l[r] = alpha * l[r] + repro::warp_sum(p[0] + p[1]);
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
#pragma unroll 8
      for (int j = 0; j < kBlockK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p[j >> 5], j & 31);
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int d = lane + 32 * c;
          if (d < DH) acc[r][c] = fmaf(pj, v_s[j * DH + d], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    if (qi >= Sq) continue;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d >= DH) continue;
      float o, m_out;
      repro::finalize_online_softmax(acc[r][c], m[r], l[r], &o, &m_out);
      out[(((size_t)b * Sq + qi) * H + h) * DH + d] = repro::from_float<T>(o);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* out, int B,
                   int Sq, int Skv, int H, int Hkv, int causal, int window,
                   cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, DH>;
  constexpr size_t smem = smem_bytes<DH>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(out), Sq, Skv,
      H, Hkv, causal, window, 1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

}  // namespace simt

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kGroups = 2;                  // warpgroups, each a KV half
constexpr int kGroupThreads = 128;          // four warps of 16 query rows
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kBlockM = 64;                 // query rows per block
constexpr int kMaxSmem = 232448;            // bytes a block may use
constexpr float kLog2e = 1.4426950408889634f;

// keys per KV tile
template <int DH>
__host__ __device__ constexpr int block_n() {
  return DH == 256 ? 32 : 64;
}

// bytes: the q tile; per warpgroup two stages of K, V (later reused for
// the merge) and key positions; per KV tile its min and max valid
// position and the list of tiles to visit
template <int DH>
size_t smem_bytes(int n_tiles) {
  constexpr int BN = block_n<DH>();
  return sizeof(bf16) *
             ((size_t)kBlockM * DH + kGroups * 4 * (size_t)BN * DH) +
         sizeof(int) * (kGroups * 2 * (size_t)BN + 3 * (size_t)n_tiles);
}

using repro::ldsm_x4;
using repro::ldsm_x4_t;
using repro::mma16816;
using repro::pack_bf16;
using repro::swz;

// a barrier over one warpgroup's 128 threads (ids 1, 2; 0 is the block's)
__device__ __forceinline__ void group_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kGroupThreads));
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ q_pos,
                const int* __restrict__ kv_pos, bf16* __restrict__ out,
                int Sq, int Skv, int H, int Hkv, int causal, int window,
                float scale_log2) {
  constexpr int BN = block_n<DH>();
  constexpr int CH = DH / 8;                // 16-byte chunks in a row
  constexpr int NB = BN / 8;                // 8-key column blocks of S
  constexpr int DB = DH / 8;                // 8-wide column blocks of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);      // [kBlockM][DH]
  bf16* kv_s = q_s + kBlockM * DH;                     // [wg][K|V][2][BN][DH]
  int* kp_s = reinterpret_cast<int*>(kv_s + kGroups * 4 * BN * DH);
  const int n_tiles = (Skv + BN - 1) / BN;
  int* kmin_s = kp_s + kGroups * 2 * BN;               // [n_tiles]
  int* kmax_s = kmin_s + n_tiles;                      // [n_tiles]
  int* list_s = kmax_s + n_tiles;                      // [n_tiles]
  // the merge reuses the K/V space: warpgroup 1's o in fragment order,
  // then its m and l, indexed so that neighbouring threads are adjacent
  float* o_x = reinterpret_cast<float*>(kv_s);         // [DB*4][128]
  float* ml_x = o_x + DB * 4 * kGroupThreads;          // [4][128]
  __shared__ int qlo_s, qhi_s, nvis_s;

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid / kGroupThreads;       // this thread's KV half
  const int gtid = tid % kGroupThreads;
  const int warp = gtid >> 5;               // warp in the warpgroup
  const int g = lane >> 2;                  // row in the 8-row half
  const int t4 = lane & 3;                  // column pair in the block
  bf16* k_s = kv_s + wg * 4 * BN * DH;      // [2][BN][DH]
  bf16* v_s = k_s + 2 * BN * DH;            // [2][BN][DH]
  int* kpw_s = kp_s + wg * 2 * BN;          // [2][BN]

  // the q tile, in flight while the prologue runs; rows past Sq are zero
  for (int i = tid; i < kBlockM * CH; i += kThreads) {
    const int r = i / CH, c = i % CH, qi = q0 + r;
    const bf16* src =
        q + (((size_t)b * Sq + (qi < Sq ? qi : 0)) * H + h) * DH + c * 8;
    repro::cp_async16(q_s + swz<DH>(r, c), src, qi < Sq);
  }
  repro::cp_async_commit();

  // prologue: the block's query positions and each tile's valid keys
  if (tid == 0) {
    qlo_s = INT_MAX;
    qhi_s = INT_MIN;
  }
  for (int t = tid; t < n_tiles; t += kThreads) {
    kmin_s[t] = INT_MAX;
    kmax_s[t] = -1;
  }
  __syncthreads();
  if (tid < kBlockM && q0 + tid < Sq) {
    const int p = q_pos[(size_t)b * Sq + q0 + tid];
    atomicMin(&qlo_s, p);
    atomicMax(&qhi_s, p);
  }
  // a warp's 32 keys lie in one tile (32 divides BN)
#pragma unroll 4
  for (int j = tid; j < n_tiles * BN; j += kThreads) {
    const int kp = j < Skv ? kv_pos[(size_t)b * Skv + j] : -1;
    const int lo = repro::warp_min_int(kp >= 0 ? kp : INT_MAX);
    const int hi = repro::warp_max_int(kp);
    if (lane == 0 && hi >= 0) {
      atomicMin(&kmin_s[j / BN], lo);
      atomicMax(&kmax_s[j / BN], hi);
    }
  }
  __syncthreads();
  if (tid < 32) {
    const int qlo = qlo_s, qhi = qhi_s;
    int n = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;
      bool visit = false;
      if (t < n_tiles) {
        const int lo = kmin_s[t], hi = kmax_s[t];
        visit = hi >= 0 && !(causal && lo > qhi) &&
                !(window > 0 && (long long)hi <= (long long)qlo - window);
      }
      const unsigned mask = __ballot_sync(0xffffffffu, visit);
      if (visit) list_s[n + __popc(mask & ((1u << lane) - 1u))] = t;
      n += __popc(mask);
    }
    if (lane == 0) nvis_s = n;
  }
  repro::cp_async_wait<0>();                // q, copied by all 256 threads
  __syncthreads();

  // this thread's two rows: warp*16 + g and warp*16 + g + 8
  int qp[2];
  bool in_rows[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + warp * 16 + g + 8 * hr;
    in_rows[hr] = qi < Sq;
    qp[hr] = in_rows[hr] ? q_pos[(size_t)b * Sq + qi] : 0;
  }

  float o[DB][4], m[2], l[2];
  const int n_vis = nvis_s;
  for (int pass = 0;; ++pass) {
    // pass 0 visits the listed tiles; pass 1, taken only when a row saw no
    // valid key there (so has none), walks all of them for mean(V).
    // Warpgroup wg takes the walk's entries wg, wg + 2, ...
    const int n_walk = pass == 0 ? n_vis : n_tiles;
    const int n_mine = (n_walk - wg + 1) / 2;
#pragma unroll
    for (int db = 0; db < DB; ++db)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[db][e] = 0.0f;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      m[hr] = REPRO_NEG_INF;
      l[hr] = 0.0f;
    }

    auto tile_of = [&](int i) {
      const int e = wg + 2 * i;
      return pass == 0 ? list_s[e] : e;
    };
    auto load_tile = [&](int i, int st) {
      const int k0 = tile_of(i) * BN;
      bf16* kd = k_s + st * BN * DH;
      bf16* vd = v_s + st * BN * DH;
#pragma unroll
      for (int x = gtid; x < BN * CH; x += kGroupThreads) {
        const int r = x / CH, c = x % CH, kj = k0 + r;
        const bool ok = kj < Skv;
        const size_t off =
            (((size_t)b * Skv + (ok ? kj : 0)) * Hkv + hk) * DH + c * 8;
        repro::cp_async16(kd + swz<DH>(r, c), k + off, ok);
        repro::cp_async16(vd + swz<DH>(r, c), v + off, ok);
      }
      if (gtid < BN) {
        const int kj = k0 + gtid;
        repro::cp_async4(kpw_s + st * BN + gtid,
                         kv_pos + (size_t)b * Skv + (kj < Skv ? kj : 0),
                         kj < Skv);
      }
    };

    if (n_mine > 0) load_tile(0, 0);
    repro::cp_async_commit();
    for (int i = 0; i < n_mine; ++i) {
      const int st = i & 1;
      if (i + 1 < n_mine) load_tile(i + 1, st ^ 1);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();              // tile i arrived
      group_sync(wg);

      const bf16* ks = k_s + st * BN * DH;
      const bf16* vs = v_s + st * BN * DH;
      const int* kps = kpw_s + st * BN;
      const int k0 = tile_of(i) * BN;

      // S = Q K^T for the warp's 16 rows and the tile's BN keys
      float s[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, q_s + swz<DH>(warp * 16 + (lane & 15),
                                 2 * kk + (lane >> 4)));
#pragma unroll
        for (int nb = 0; nb < NB; nb += 2) {
          uint32_t bb[4];
          ldsm_x4(bb, ks + swz<DH>(nb * 8 + (lane & 7) + ((lane >> 4) << 3),
                                   2 * kk + ((lane >> 3) & 1)));
          mma16816(s[nb], a, bb[0], bb[1]);
          mma16816(s[nb + 1], a, bb[2], bb[3]);
        }
      }

      // mask (in log2 units), row max over the quad that shares a row
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          const int j = nb * 8 + 2 * t4 + (e & 1);
          float x = -INFINITY;                // tile padding past Skv
          if (k0 + j < Skv) {
            const int kp = kps[j];
            const bool ok = kp >= 0 && (!causal || kp <= qp[hr]) &&
                            (window <= 0 || kp > qp[hr] - window);
            x = ok ? s[nb][e] * scale_log2 : REPRO_NEG_INF;
          }
          s[nb][e] = x;
          mx[hr] = fmaxf(mx[hr], x);
        }
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        const float m_new = fmaxf(m[hr], mx[hr]);
        alpha[hr] = exp2f(m[hr] - m_new);
        m[hr] = m_new;
      }
      float ls[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[nb][e] - m[e >> 1]);
          s[nb][e] = p;
          ls[e >> 1] += p;
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) l[hr] = alpha[hr] * l[hr] + ls[hr];
#pragma unroll
      for (int db = 0; db < DB; ++db)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[db][e] *= alpha[e >> 1];

      // O += P V: P from registers as bf16, V through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int db = 0; db < DB; db += 2) {
          uint32_t bb[4];
          ldsm_x4_t(bb, vs + swz<DH>(kk * 16 + (lane & 7) +
                                         (((lane >> 3) & 1) << 3),
                                     db + (lane >> 4)));
          mma16816(o[db], a, bb[0], bb[1]);
          mma16816(o[db + 1], a, bb[2], bb[3]);
        }
      }
      group_sync(wg);                         // stage st free again
    }
    repro::cp_async_wait<0>();
    __syncthreads();                          // both halves walked

    // merge warpgroup 1's half into warpgroup 0's by the log-sum-exp rule
    // (a half that saw only masked keys has m = NEG_INF: exp2(NEG_INF - m)
    // wipes it against a valid key, and two such halves add, as one walk
    // would)
    if (wg == 1) {
#pragma unroll
      for (int db = 0; db < DB; ++db)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o_x[(db * 4 + e) * kGroupThreads + gtid] = o[db][e];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        ml_x[hr * kGroupThreads + gtid] = m[hr];
        ml_x[(2 + hr) * kGroupThreads + gtid] = l[hr];
      }
    }
    __syncthreads();
    bool no_key = false;
    if (wg == 0) {
      float a0[2], a1[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float m1 = ml_x[hr * kGroupThreads + gtid];
        const float mn = fmaxf(m[hr], m1);
        a0[hr] = exp2f(m[hr] - mn);
        a1[hr] = exp2f(m1 - mn);
        l[hr] = a0[hr] * l[hr] +
                a1[hr] * ml_x[(2 + hr) * kGroupThreads + gtid];
        m[hr] = mn;
      }
#pragma unroll
      for (int db = 0; db < DB; ++db)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[db][e] = a0[e >> 1] * o[db][e] +
                     a1[e >> 1] * o_x[(db * 4 + e) * kGroupThreads + gtid];
      no_key = (in_rows[0] && m[0] == REPRO_NEG_INF) ||
               (in_rows[1] && m[1] == REPRO_NEG_INF);
    }
    if (pass == 1 || n_vis == n_tiles || !__syncthreads_or(no_key)) break;
  }
  if (wg == 1) return;

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (!in_rows[hr]) continue;
    const int qi = q0 + warp * 16 + g + 8 * hr;
    const float inv = l[hr] > 0.0f ? 1.0f / l[hr] : 0.0f;
    bf16* dst = out + (((size_t)b * Sq + qi) * H + h) * DH + 2 * t4;
#pragma unroll
    for (int db = 0; db < DB; ++db)
      *reinterpret_cast<__nv_bfloat162*>(dst + db * 8) =
          __floats2bfloat162_rn(o[db][2 * hr] * inv, o[db][2 * hr + 1] * inv);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* out, int B,
                   int Sq, int Skv, int H, int Hkv, int causal, int window,
                   cudaStream_t stream) {
  auto kern = flash_tc_kernel<DH>;
  const int n_tiles = (Skv + block_n<DH>() - 1) / block_n<DH>();
  const size_t smem = smem_bytes<DH>(n_tiles);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), q_pos, kv_pos, static_cast<bf16*>(out),
      Sq, Skv, H, Hkv, causal, window, kLog2e / sqrtf((float)DH));
  return cudaGetLastError();
}

}  // namespace tc

namespace {

template <typename T>
cudaError_t simt_dh(const void* q, const void* k, const void* v,
                    const int* q_pos, const int* kv_pos, void* out, int B,
                    int Sq, int Skv, int H, int Hkv, int Dh, int causal,
                    int window, cudaStream_t s) {
  switch (Dh) {
    case 8:
      return simt::launch<T, 8>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H,
                                Hkv, causal, window, s);
    case 16:
      return simt::launch<T, 16>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H,
                                 Hkv, causal, window, s);
    case 32:
      return simt::launch<T, 32>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H,
                                 Hkv, causal, window, s);
    default:
      break;
  }
  // bfloat16 at Dh >= 64 takes the tensor-core body only
  if constexpr (std::is_same<T, float>::value) {
    switch (Dh) {
      case 64:
        return simt::launch<T, 64>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv,
                                   H, Hkv, causal, window, s);
      case 128:
        return simt::launch<T, 128>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv,
                                    H, Hkv, causal, window, s);
      case 256:
        return simt::launch<T, 256>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv,
                                    H, Hkv, causal, window, s);
      default:
        break;
    }
  }
  return cudaErrorInvalidValue;
}

cudaError_t tc_dh(const void* q, const void* k, const void* v,
                  const int* q_pos, const int* kv_pos, void* out, int B,
                  int Sq, int Skv, int H, int Hkv, int Dh, int causal,
                  int window, cudaStream_t s) {
  switch (Dh) {
    case 64:
      return tc::launch<64>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv,
                            causal, window, s);
    case 128:
      return tc::launch<128>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H,
                             Hkv, causal, window, s);
    case 256:
      return tc::launch<256>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H,
                             Hkv, causal, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// tensor_cores: 1 = the mma.sync body (bfloat16 with Dh 64, 128 or 256 and
// q, k, v 16-byte aligned), 0 = the CUDA-core body (float32 at Dh 8..256,
// bfloat16 at Dh 8, 16, 32).  Returns the cudaError_t of the launch
// (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const int* q_pos,
                                   const int* kv_pos, void* out, int B, int Sq,
                                   int Skv, int H, int Hkv, int Dh, int causal,
                                   int window, int dtype, int tensor_cores,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)tc_dh(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv, Dh,
                      causal, window, s);
  }
  if (dtype == 0)
    return (int)simt_dh<float>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H,
                               Hkv, Dh, causal, window, s);
  if (dtype == 1)
    return (int)simt_dh<__nv_bfloat16>(q, k, v, q_pos, kv_pos, out, B, Sq,
                                       Skv, H, Hkv, Dh, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
