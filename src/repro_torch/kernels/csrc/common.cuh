// Shared device helpers for the port's attention kernels.
//
// The CUDA counterpart of repro_torch/kernels/common.py: the finite
// NEG_INF stand-in for -inf, the f32 online-softmax rescale step and the
// end-of-walk finalize with the fully-masked-row pin; besides, the
// 16-byte unpack, the cp.async copies the kernels stage tiles with, the
// tensor-core pieces of the FA2 register layout (the XOR swizzle of bf16
// tiles, ldmatrix, mma.sync.m16n8k16) that the flash and shared-prefix
// bodies share, and the host's once-per-device opt-in to more than 48 KB
// of shared memory.
// The kernels differ in how they form p (flash keeps exp(NEG_INF - m) for
// masked keys, as its Pallas original does; the decode kernels zero masked
// keys, as kernels/common.py does), so p is computed at the call site.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ int warp_min_int(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ int warp_max_int(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = max(x, __shfl_xor_sync(0xffffffffu, x, off));
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

// 16 bytes holding T values, as floats
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& x, float* out);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& x, float* out) {
  out[0] = __uint_as_float(x.x);
  out[1] = __uint_as_float(x.y);
  out[2] = __uint_as_float(x.z);
  out[3] = __uint_as_float(x.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& x,
                                                        float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Asynchronous global -> shared copies (sm_80+).  With pred false the
// destination is zero-filled and nothing is read (src must still be a
// valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// element offset of 16-byte chunk c of row r in a [rows][DH] bf16 tile:
// chunks XOR-swizzled by r % 8, so ldmatrix's eight rows hit eight banks
template <int DH>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DH + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Let a kernel take more than 48 KB of dynamic shared memory.  The
// attribute is set once per device and size, not on every launch: a
// decode step's host time bounds its kernels.  ``allowed`` is a static
// array of the caller's, one for each kernel.
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes, size_t (&allowed)[8]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 8 && bytes <= allowed[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && dev < 8) allowed[dev] = bytes;
  return e;
}

}  // namespace repro
