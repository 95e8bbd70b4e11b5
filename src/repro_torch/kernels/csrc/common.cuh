// Shared device helpers for the port's attention kernels.
//
// The CUDA counterpart of repro_torch/kernels/common.py: the finite
// NEG_INF stand-in for -inf, the f32 online-softmax rescale step and the
// end-of-walk finalize with the fully-masked-row pin.  The two kernels
// differ only in how they form p (flash keeps exp(NEG_INF - m) for masked
// keys, as its Pallas original does; paged decode zeroes masked keys, as
// kernels/common.py does), so p is computed at the call site.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Finite stand-in for -inf: exp(NEG_INF - NEG_INF) stays defined (== 1).
#define REPRO_NEG_INF (-1e30f)

namespace repro {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a dtype cast does
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// One chunk's rescale: raise the running max m to cover chunk_max and
// return alpha = exp(m_prev - m_new), the factor acc and l are scaled by.
__device__ __forceinline__ float online_softmax_rescale(float& m,
                                                        float chunk_max) {
  const float m_new = fmaxf(m, chunk_max);
  const float alpha = expf(m - m_new);
  m = m_new;
  return alpha;
}

// End of the walk: divide by l, and pin a row that saw no unmasked key
// (l == 0) to out = 0, m = NEG_INF, so LSE combines read it as empty.
__device__ __forceinline__ void finalize_online_softmax(float acc, float m,
                                                        float l, float* out,
                                                        float* m_out) {
  const bool empty = l == 0.0f;
  *out = empty ? 0.0f : acc / l;
  *m_out = empty ? REPRO_NEG_INF : m;
}

}  // namespace repro
