// GQA flash-decode over a contiguous or ring-buffer KV cache for Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention/kernel.py,
// decode_attention_kernel (body _decode_kernel): one new query token per
// row b, q (B,H,Dh), attends over k/v (B,T,Hkv,Dh) with explicit int32
// positions: q_pos (B,) and kv_pos (B,T), -1 marking an empty slot.  A key
// is valid when kp >= 0 && kp <= qp && (window == 0 || kp > qp - window),
// so a ring buffer whose slots hold wrapped positions needs no reordering.
// Logits in f32, online softmax in f32 (repro::online_softmax_rescale),
// masked keys contribute p = 0.  Outputs: out (B,H,Dh) in q's dtype and the
// log-sum-exp state m, l (B,H) in f32, so partial results over disjoint key
// sets combine exactly (decode_attention/ref.py:lse_combine).  A row with
// no valid key gives out = 0, (m, l) = (NEG_INF, 0).
//
// What bounds it on the H100: bytes.  Each key does 4*G*Dh FLOPs against
// 2*Dh cache elements, a few FLOPs per byte, far below the ridge point, so
// the bound is the K/V bytes over the 3.35 TB/s memory rate: at the
// hybrid's decode shape (B=8, T=512, Hkv=1, Dh=256, bf16) K+V are 4.19 MB,
// about 1.25 us.
//
// What the design does: one block per (row b, KV head), so the G query
// heads that share a KV head read each K/V byte once; the G query rows sit
// in shared memory as f32, one warp per query row; 64-key tiles of K and V
// are staged in shared memory as f32 (K rows padded by one float so the 32
// lanes reading 32 keys hit 32 banks) and reused by all G warps; lanes
// split the keys for QK^T (two keys a lane) and the Dh columns for PV.
// This first version gives only B*Hkv blocks, 8 at the hybrid's main shape
// on 132 SMs, so it sits far from its bound: splitting T across blocks with
// a log-sum-exp combine (flash-decoding) is later work (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBlockK = 64;                 // keys per tile (2 per lane)
constexpr int kMaxGroup = 16;               // query heads per KV head
constexpr int kMaxThreads = kMaxGroup * 32;

template <int DH>
size_t smem_bytes(int G) {
  return sizeof(float) *
             ((size_t)G * DH + kBlockK * (DH + 1) + (size_t)kBlockK * DH) +
         sizeof(int) * kBlockK;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kMaxThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ q_pos,
                        const int* __restrict__ kv_pos, T* __restrict__ out,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        int Tk, int H, int Hkv, int window, float scale) {
  constexpr int DPL = DH / 32;              // output columns per lane
  constexpr int KS = DH + 1;                // padded K row stride
  extern __shared__ float smem[];
  const int G = H / Hkv;
  float* q_s = smem;                        // [G][DH]
  float* k_s = q_s + G * DH;                // [kBlockK][KS]
  float* v_s = k_s + kBlockK * KS;          // [kBlockK][DH]
  int* kp_s = reinterpret_cast<int*>(v_s + kBlockK * DH);  // [kBlockK]

  const int b = blockIdx.x;
  const int hk = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int g = tid >> 5;                   // this warp's query row
  const int qp = q_pos[b];

  // query heads hk*G .. hk*G+G-1 of row b are contiguous
  for (int i = tid; i < G * DH; i += nthreads)
    q_s[i] = repro::to_float(q[((size_t)b * H + (size_t)hk * G) * DH + i]);

  float m = REPRO_NEG_INF, l = 0.0f, acc[DPL];
#pragma unroll
  for (int c = 0; c < DPL; ++c) acc[c] = 0.0f;

  for (int k0 = 0; k0 < Tk; k0 += kBlockK) {
    __syncthreads();                        // q loaded / last tile consumed
    for (int i = tid; i < kBlockK * DH; i += nthreads) {
      const int j = i / DH, d = i % DH, kj = k0 + j;
      float kk = 0.0f, vv = 0.0f;
      if (kj < Tk) {
        const size_t off = (((size_t)b * Tk + kj) * Hkv + hk) * DH + d;
        kk = repro::to_float(k[off]);
        vv = repro::to_float(v[off]);
      }
      k_s[j * KS + d] = kk;
      v_s[j * DH + d] = vv;
    }
    for (int j = tid; j < kBlockK; j += nthreads)
      kp_s[j] = k0 + j < Tk ? kv_pos[(size_t)b * Tk + k0 + j] : -1;
    __syncthreads();

    const float* qr = q_s + g * DH;
    const float* kr0 = k_s + lane * KS;
    const float* kr1 = k_s + (lane + 32) * KS;
    float dot0 = 0.0f, dot1 = 0.0f;
#pragma unroll 16
    for (int d = 0; d < DH; ++d) {
      const float qd = qr[d];
      dot0 = fmaf(qd, kr0[d], dot0);
      dot1 = fmaf(qd, kr1[d], dot1);
    }
    float s[2];
    bool ok[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = lane + 32 * t;
      const int kp = kp_s[j];
      ok[t] = k0 + j < Tk && kp >= 0 && kp <= qp &&
              (window <= 0 || kp > qp - window);
      s[t] = ok[t] ? (t == 0 ? dot0 : dot1) * scale : REPRO_NEG_INF;
    }
    const float alpha =
        repro::online_softmax_rescale(m, repro::warp_max(fmaxf(s[0], s[1])));
    float p[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) p[t] = ok[t] ? expf(s[t] - m) : 0.0f;
    l = alpha * l + repro::warp_sum(p[0] + p[1]);
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[c] *= alpha;
#pragma unroll 8
    for (int j = 0; j < kBlockK; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p[j >> 5], j & 31);
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        acc[c] = fmaf(pj, v_s[j * DH + lane + 32 * c], acc[c]);
    }
  }

  const size_t row = (size_t)b * H + (size_t)hk * G + g;
  float m_fin = m;
#pragma unroll
  for (int c = 0; c < DPL; ++c) {
    float o;
    repro::finalize_online_softmax(acc[c], m, l, &o, &m_fin);
    out[row * DH + lane + 32 * c] = repro::from_float<T>(o);
  }
  if (lane == 0) {
    m_out[row] = m_fin;
    l_out[row] = l;
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* out, float* m,
                   float* l, int B, int Tk, int H, int Hkv, int window,
                   cudaStream_t stream) {
  auto kern = decode_attention_kernel<T, DH>;
  const size_t smem = smem_bytes<DH>(H / Hkv);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B, Hkv);
  kern<<<grid, 32 * (H / Hkv), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(out), m, l, Tk,
      H, Hkv, window, 1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos, void* out,
                        float* m, float* l, int B, int Tk, int H, int Hkv,
                        int Dh, int window, cudaStream_t stream) {
  switch (Dh) {
    case 32:
      return launch<T, 32>(q, k, v, q_pos, kv_pos, out, m, l, B, Tk, H, Hkv,
                           window, stream);
    case 64:
      return launch<T, 64>(q, k, v, q_pos, kv_pos, out, m, l, B, Tk, H, Hkv,
                           window, stream);
    case 128:
      return launch<T, 128>(q, k, v, q_pos, kv_pos, out, m, l, B, Tk, H, Hkv,
                            window, stream);
    case 256:
      return launch<T, 256>(q, k, v, q_pos, kv_pos, out, m, l, B, Tk, H, Hkv,
                            window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); m and l are
// float32.  Returns the cudaError_t of the launch (0 = success).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const int* q_pos,
                                    const int* kv_pos, void* out, float* m,
                                    float* l, int B, int Tk, int H, int Hkv,
                                    int Dh, int window, int dtype,
                                    void* stream) {
  if (B <= 0 || Tk <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > kMaxGroup)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dh<float>(q, k, v, q_pos, kv_pos, out, m, l, B, Tk,
                                   H, Hkv, Dh, window, s);
  if (dtype == 1)
    return (int)dispatch_dh<__nv_bfloat16>(q, k, v, q_pos, kv_pos, out, m, l,
                                           B, Tk, H, Hkv, Dh, window, s);
  return (int)cudaErrorInvalidValue;
}
