// GQA flash-decode over a contiguous or ring-buffer KV cache for Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention/kernel.py,
// decode_attention_kernel (body _decode_kernel): one new query token per
// row b, q (B,H,Dh), attends over k/v (B,T,Hkv,Dh) with explicit int32
// positions: q_pos (B,) and kv_pos (B,T), -1 marking an empty slot.  A key
// is valid when kp >= 0 && kp <= qp && (window == 0 || kp > qp - window),
// so a ring buffer whose slots hold wrapped positions needs no reordering.
// Logits in f32, online softmax in f32, masked keys contribute p = 0.
// Outputs: out (B,H,Dh) in q's dtype and the log-sum-exp state m, l (B,H)
// in f32, so partial results over disjoint key sets combine exactly
// (decode_attention/ref.py:lse_combine).  A row with no valid key gives
// out = 0, (m, l) = (NEG_INF, 0).
//
// What bounds it on the H100: bytes.  A key costs 4*G*Dh FLOPs against
// 4*Dh bytes of bf16 K and V, G FLOP/byte (10 for the hybrid's MQA, 2 for
// qwen3), under the f32 CUDA-core ridge of 67 TFLOP/s / 3.35 TB/s = 20
// FLOP/byte: the kernel is bound by bytes even without tensor cores, so it
// uses the CUDA cores.  Only valid keys must be read: at the hybrid's
// decode shape (B=8, T=512, Hkv=1, Dh=256, 2378 valid slots) 2.4 MB, about
// 0.75 us at 3.35 TB/s.
//
// What the design does (flash-decoding): T is split into chunks across
// blocks, a grid of (row b, KV head, chunk) with four warps each, whatever
// G is, so the hybrid's B=8, T=512 step runs 128 blocks instead of 8.  The
// chunk length depends only on T, Dh and the card's SM count (the wrapper
// plans it, decode_attention/ops.py), never on B, so a row's summation
// order does not change with the batch it sits in.  A block walks its chunk
// in sub-tiles of 64 keys (32 at Dh=256): warp 0 compacts the sub-tile's
// valid slots by ballot, then the K and V rows of those slots only are
// staged in shared memory with 16-byte cp.async on neighbouring threads,
// all in flight together; empty and masked slots are never read.  QK^T
// runs on groups of lanes that split Dh (one 16-byte vector each) and sum
// by shuffles, the G query rows of the KV head held in shared memory as
// f32; one warp per row takes the online-softmax step; PV runs one thread
// per (row, 16-byte column vector).  With one chunk the block writes out,
// m and l itself; with more it writes its chunk's unnormalised partial
// (acc, m, l) to scratch the wrapper allocates, and a second small kernel
// combines a row's chunks by the log-sum-exp rule and pins an empty row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;               // four warps, whatever G is
constexpr int kMaxGroup = 16;               // query heads per KV head
constexpr int kMaxChunks = 8192;            // the combine's weights: 32 KB

// keys per sub-tile (the chunk is a multiple of it)
template <int DH>
__host__ __device__ constexpr int sub_keys() {
  return DH == 256 ? 32 : 64;
}

template <typename T, int DH>
size_t smem_bytes(int G) {
  constexpr int BK = sub_keys<DH>();
  return sizeof(float) * ((size_t)G * DH + (size_t)G * BK + 3 * kMaxGroup) +
         sizeof(T) * 2 * (size_t)BK * DH + sizeof(int) * BK;
}

// 16 bytes of T written from floats
template <typename T>
__device__ __forceinline__ void store16(T* dst, const float* x);
template <>
__device__ __forceinline__ void store16<float>(float* dst, const float* x) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
}
template <>
__device__ __forceinline__ void store16<__nv_bfloat16>(__nv_bfloat16* dst,
                                                       const float* x) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(dst) = u;
}

// One block: row b = blockIdx.x, KV head hk = blockIdx.y, keys
// [c*chunk, min((c+1)*chunk, T)) with c = blockIdx.z.  GB is the power of
// two in 2..16 at or above G = H / Hkv, the bound of the register arrays.
template <typename T, int DH, int GB>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos, T* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ part_acc,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    int Tk, int H, int Hkv, int window, int chunk,
                    float scale) {
  constexpr int VEC = 16 / sizeof(T);       // elements per 16-byte vector
  constexpr int NV = DH / VEC;              // vectors per key row
  constexpr int L = NV < 32 ? NV : 32;      // lanes per key in QK^T
  constexpr int VPL = NV / L;               // vectors per lane in QK^T
  constexpr int GPW = 32 / L;               // key groups per warp
  constexpr int BK = sub_keys<DH>();
  // (row, vector) pairs of PV per thread, at most
  constexpr int PPT = (GB * NV + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / Hkv;
  float* q_s = reinterpret_cast<float*>(smem_raw);   // [G][DH]
  float* s_s = q_s + G * DH;                         // [G][BK]
  float* m_s = s_s + G * BK;                         // [kMaxGroup]
  float* l_s = m_s + kMaxGroup;                      // [kMaxGroup]
  float* a_s = l_s + kMaxGroup;                      // [kMaxGroup]
  T* k_s = reinterpret_cast<T*>(a_s + kMaxGroup);    // [BK][DH]
  T* v_s = k_s + BK * DH;                            // [BK][DH]
  int* idx_s = reinterpret_cast<int*>(v_s + BK * DH);  // [BK]
  __shared__ int nvalid_s;

  const int b = blockIdx.x;
  const int hk = blockIdx.y;
  const int c = blockIdx.z;
  const int n_chunks = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qp = q_pos[b];
  const int t_begin = c * chunk;
  const int t_end = min(Tk, t_begin + chunk);

  // query heads hk*G .. hk*G+G-1 of row b are contiguous
  for (int i = tid; i < G * DH; i += kThreads)
    q_s[i] = repro::to_float(q[((size_t)b * H + (size_t)hk * G) * DH + i]);
  if (tid < G) {
    m_s[tid] = REPRO_NEG_INF;
    l_s[tid] = 0.0f;
  }
  float acc[PPT][VEC];
#pragma unroll
  for (int j = 0; j < PPT; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.0f;

  for (int t0 = t_begin; t0 < t_end; t0 += BK) {
    const int n = min(BK, t_end - t0);
    __syncthreads();                        // last sub-tile consumed
    // the sub-tile's valid slots, compacted in order
    if (warp == 0) {
      int cnt = 0;
#pragma unroll
      for (int j0 = 0; j0 < BK; j0 += 32) {
        const int j = j0 + lane;
        bool ok = false;
        if (j < n) {
          const int kp = kv_pos[(size_t)b * Tk + t0 + j];
          ok = kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
        }
        const unsigned mask = __ballot_sync(0xffffffffu, ok);
        if (ok) idx_s[cnt + __popc(mask & ((1u << lane) - 1u))] = j;
        cnt += __popc(mask);
      }
      if (lane == 0) nvalid_s = cnt;
    }
    __syncthreads();
    const int nv = nvalid_s;
    if (nv == 0) continue;                  // block-uniform

    // K and V rows of the valid slots only, all copies in flight together
    for (int i = tid; i < nv * NV; i += kThreads) {
      const int r = i / NV, x = i % NV;
      const size_t off =
          (((size_t)b * Tk + t0 + idx_s[r]) * Hkv + hk) * DH + x * VEC;
      repro::cp_async16(k_s + r * DH + x * VEC, k + off);
      repro::cp_async16(v_s + r * DH + x * VEC, v + off);
    }
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();

    // logits: a group of L lanes per key, each lane VPL vectors of Dh
    for (int r0 = warp * GPW; r0 < nv; r0 += kThreads / L) {
      const int r = r0 + lane / L, lig = lane % L;
      const bool act = r < nv;
      float kf[VPL][VEC];
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        if (act) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              k_s + r * DH + (lig + u * L) * VEC);
          repro::unpack16<T>(raw, kf[u]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kf[u][e] = 0.0f;
        }
      }
      // the G rows' partial dots first, then their lane sums together,
      // so the shuffle chains of the rows overlap
      float dot[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        dot[g] = 0.0f;
        if (g < G) {
#pragma unroll
          for (int u = 0; u < VPL; ++u) {
            const float* qv = q_s + g * DH + (lig + u * L) * VEC;
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              dot[g] = fmaf(qv[e], kf[u][e], dot[g]);
          }
        }
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < GB; ++g)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
      if (act && lig == 0) {
#pragma unroll
        for (int g = 0; g < GB; ++g)
          if (g < G) s_s[g * BK + r] = dot[g] * scale;
      }
    }
    __syncthreads();

    // the online-softmax step: warp w owns rows w, w+4, ...
    for (int g = warp; g < G; g += kThreads / 32) {
      float x[BK / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int j = lane + 32 * u;
        x[u] = j < nv ? s_s[g * BK + j] : -INFINITY;
        mx = fmaxf(mx, x[u]);
      }
      mx = repro::warp_max(mx);
      float m = m_s[g];
      const float alpha = repro::online_softmax_rescale(m, mx);
      float ps = 0.0f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int j = lane + 32 * u;
        if (j < nv) {
          const float p = expf(x[u] - m);
          s_s[g * BK + j] = p;
          ps += p;
        }
      }
      ps = repro::warp_sum(ps);
      if (lane == 0) {
        m_s[g] = m;
        l_s[g] = alpha * l_s[g] + ps;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // PV: one thread per (row, 16-byte column vector)
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int e = tid + j * kThreads;
      if (e < G * NV) {
        const int g = e / NV, x = e % NV;
        const float alpha = a_s[g];
#pragma unroll
        for (int w = 0; w < VEC; ++w) acc[j][w] *= alpha;
        for (int r = 0; r < nv; ++r) {
          const float p = s_s[g * BK + r];
          float vf[VEC];
          repro::unpack16<T>(
              *reinterpret_cast<const uint4*>(v_s + r * DH + x * VEC), vf);
#pragma unroll
          for (int w = 0; w < VEC; ++w) acc[j][w] = fmaf(p, vf[w], acc[j][w]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int e = tid + j * kThreads;
    if (e >= G * NV) continue;
    const int g = e / NV, x = e % NV;
    const size_t row = (size_t)b * H + (size_t)hk * G + g;
    const float m = m_s[g], l = l_s[g];
    const bool empty = l == 0.0f;
    if (n_chunks == 1) {
      float o[VEC];
#pragma unroll
      for (int w = 0; w < VEC; ++w) o[w] = empty ? 0.0f : acc[j][w] / l;
      store16<T>(out + row * DH + x * VEC, o);
      if (x == 0) {
        m_out[row] = empty ? REPRO_NEG_INF : m;
        l_out[row] = l;
      }
    } else {
      const size_t prow = row * n_chunks + c;
#pragma unroll
      for (int w = 0; w < VEC; w += 4)
        *reinterpret_cast<float4*>(part_acc + prow * DH + x * VEC + w) =
            make_float4(acc[j][w], acc[j][w + 1], acc[j][w + 2],
                        acc[j][w + 3]);
      if (x == 0) {
        part_m[prow] = m;                   // NEG_INF when the chunk is empty
        part_l[prow] = l;
      }
    }
  }
}

// One block per query row (b, h), Dh threads: the row's chunk partials
// combined by the log-sum-exp rule (an empty chunk has m = NEG_INF, l = 0
// and weighs nothing), then the pin of an empty row.  Warp 0 puts each
// chunk's weight exp(m_c - m) in shared memory; then every thread sums its
// column with independent loads.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      T* __restrict__ out,
                                      float* __restrict__ m_out,
                                      float* __restrict__ l_out,
                                      int n_chunks, int Dh) {
  extern __shared__ float w_s[];            // [n_chunks]
  __shared__ float ml_s[2];
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* pm = part_m + row * n_chunks;
  const float* pl = part_l + row * n_chunks;
  if (d < 32) {
    float m = REPRO_NEG_INF;
    for (int c = d; c < n_chunks; c += 32) m = fmaxf(m, pm[c]);
    m = repro::warp_max(m);
    float l = 0.0f;
    for (int c = d; c < n_chunks; c += 32) {
      const float wc = expf(pm[c] - m);
      w_s[c] = wc;
      l = fmaf(wc, pl[c], l);
    }
    l = repro::warp_sum(l);
    if (d == 0) {
      ml_s[0] = m;
      ml_s[1] = l;
    }
  }
  __syncthreads();
  const float* pa = part_acc + row * n_chunks * Dh + d;
  float a = 0.0f;
#pragma unroll 8
  for (int c = 0; c < n_chunks; ++c) a = fmaf(w_s[c], pa[(size_t)c * Dh], a);
  const float m = ml_s[0], l = ml_s[1];
  const bool empty = l == 0.0f;
  out[row * Dh + d] = repro::from_float<T>(empty ? 0.0f : a / l);
  if (d == 0) {
    m_out[row] = empty ? REPRO_NEG_INF : m;
    l_out[row] = l;
  }
}

template <typename T, int DH, int GB>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* out, float* m,
                   float* l, float* part, int B, int Tk, int H, int Hkv,
                   int window, int chunk, cudaStream_t stream) {
  if (chunk % sub_keys<DH>() != 0) return cudaErrorInvalidValue;
  auto kern = decode_split_kernel<T, DH, GB>;
  const size_t smem = smem_bytes<T, DH>(H / Hkv);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int n_chunks = (Tk + chunk - 1) / chunk;
  if (n_chunks > kMaxChunks) return cudaErrorInvalidValue;
  // scratch, n_chunks > 1 only: part_acc (B*H, n_chunks, Dh), then
  // part_m and part_l (B*H, n_chunks)
  const size_t n_part = (size_t)B * H * n_chunks;
  float* part_acc = part;
  float* part_m = part ? part + n_part * DH : nullptr;
  float* part_l = part ? part_m + n_part : nullptr;
  if (n_chunks > 1 && part == nullptr) return cudaErrorInvalidValue;
  const dim3 grid(B, Hkv, n_chunks);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(out), m, l,
      part_acc, part_m, part_l, Tk, H, Hkv, window, chunk,
      1.0f / sqrtf((float)DH));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_chunks == 1) return e;
  decode_combine_kernel<T><<<B * H, DH, sizeof(float) * n_chunks, stream>>>(
      part_acc, part_m, part_l, static_cast<T*>(out), m, l, n_chunks, DH);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t dispatch_group(const void* q, const void* k, const void* v,
                           const int* q_pos, const int* kv_pos, void* out,
                           float* m, float* l, float* part, int B, int Tk,
                           int H, int Hkv, int window, int chunk,
                           cudaStream_t s) {
  const int G = H / Hkv;
  if (G <= 2)
    return launch<T, DH, 2>(q, k, v, q_pos, kv_pos, out, m, l, part, B, Tk,
                            H, Hkv, window, chunk, s);
  if (G <= 4)
    return launch<T, DH, 4>(q, k, v, q_pos, kv_pos, out, m, l, part, B, Tk,
                            H, Hkv, window, chunk, s);
  if (G <= 8)
    return launch<T, DH, 8>(q, k, v, q_pos, kv_pos, out, m, l, part, B, Tk,
                            H, Hkv, window, chunk, s);
  return launch<T, DH, 16>(q, k, v, q_pos, kv_pos, out, m, l, part, B, Tk, H,
                           Hkv, window, chunk, s);
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos, void* out,
                        float* m, float* l, float* part, int B, int Tk, int H,
                        int Hkv, int Dh, int window, int chunk,
                        cudaStream_t s) {
  switch (Dh) {
    case 32:
      return dispatch_group<T, 32>(q, k, v, q_pos, kv_pos, out, m, l, part,
                                   B, Tk, H, Hkv, window, chunk, s);
    case 64:
      return dispatch_group<T, 64>(q, k, v, q_pos, kv_pos, out, m, l, part,
                                   B, Tk, H, Hkv, window, chunk, s);
    case 128:
      return dispatch_group<T, 128>(q, k, v, q_pos, kv_pos, out, m, l, part,
                                    B, Tk, H, Hkv, window, chunk, s);
    case 256:
      return dispatch_group<T, 256>(q, k, v, q_pos, kv_pos, out, m, l, part,
                                    B, Tk, H, Hkv, window, chunk, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); m and l are
// float32.  chunk: keys per block, a multiple of 64 (32 at Dh=256).  part:
// float32 scratch of B*H*ceil(T/chunk)*(Dh+2) values when T > chunk, else
// unused (may be null).  k and v must be 16-byte aligned.  Returns the
// cudaError_t of the launches (0 = success).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const int* q_pos,
                                    const int* kv_pos, void* out, float* m,
                                    float* l, float* part, int B, int Tk,
                                    int H, int Hkv, int Dh, int window,
                                    int chunk, int dtype, void* stream) {
  if (B <= 0 || Tk <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > kMaxGroup || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dh<float>(q, k, v, q_pos, kv_pos, out, m, l, part,
                                   B, Tk, H, Hkv, Dh, window, chunk, s);
  if (dtype == 1)
    return (int)dispatch_dh<__nv_bfloat16>(q, k, v, q_pos, kv_pos, out, m, l,
                                           part, B, Tk, H, Hkv, Dh, window,
                                           chunk, s);
  return (int)cudaErrorInvalidValue;
}
