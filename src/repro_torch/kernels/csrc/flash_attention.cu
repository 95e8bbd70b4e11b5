// Flash prefill attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py,
// flash_attention_kernel (body _flash_kernel): GQA attention of q
// (B,Sq,H,Dh) over k/v (B,Skv,Hkv,Dh) with a mask formed from explicit
// int32 positions (-1 = invalid slot): kp >= 0, kp <= qp when causal,
// kp > qp - window when window > 0.  Online softmax in f32 over KV tiles,
// PV accumulated in f32, output normalised and written in q's dtype.  As
// in the Pallas kernel, masked logits are NEG_INF but p is not zeroed, so
// a row with no valid key averages V uniformly (out = mean(V)).
//
// What bounds it on the H100: at the engine's prefill shapes (a chunk of
// up to 512 queries over up to 544 keys, H=16, Dh=128, bf16) the causal
// work is ~1.2 GFLOP against ~6.4 MB of q/k/v/out traffic, close to the
// card's ridge point (~295 FLOP/byte in bf16): either bound is ~2 us.
// This first version is far from it: it computes on the CUDA cores in
// f32 (one warp per query row at a time, lanes over keys for QK^T and
// over Dh for PV) so that the arithmetic is simple to hold against the
// plain version, and it walks every KV tile, masked or not.  Tensor cores
// (wgmma) and skipping fully masked tiles are later work (PERF.md).
//
// What the design does: one block per (q tile of 32 rows, head, batch);
// the q tile is loaded once and each 64-key KV tile of head h // G is
// staged in shared memory as f32 and reused by all 32 rows (a 16-row tile
// measured slower: staging then outweighs the rows' compute); K rows are
// padded by one float so the 32 lanes reading 32 keys hit 32 banks.  At
// Dh=256 (recurrentgemma-2b) the tiles take 164,352 bytes of shared memory,
// under the 227 KB a block may have, so one block runs per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

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

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos, void* out, int B,
                        int Sq, int Skv, int H, int Hkv, int Dh, int causal,
                        int window, cudaStream_t stream) {
  switch (Dh) {
    case 8:
      return launch<T, 8>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv,
                          causal, window, stream);
    case 16:
      return launch<T, 16>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv,
                           causal, window, stream);
    case 32:
      return launch<T, 32>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv,
                           causal, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv,
                           causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv,
                            causal, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv,
                            causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const int* q_pos,
                                   const int* kv_pos, void* out, int B, int Sq,
                                   int Skv, int H, int Hkv, int Dh, int causal,
                                   int window, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dh<float>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H,
                                   Hkv, Dh, causal, window, s);
  if (dtype == 1)
    return (int)dispatch_dh<__nv_bfloat16>(q, k, v, q_pos, kv_pos, out, B, Sq,
                                           Skv, H, Hkv, Dh, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
