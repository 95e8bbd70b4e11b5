// Paged latent decode attention: DeepSeek-V2's multi-head latent attention
// (MLA) in its absorbed form, one decode token a row.
//
// It replaces no TPU kernel: the JAX package has no latent attention.  It
// was added because no kernel of the port computes this: the paged kernel
// is grouped-query attention with a K and a V pool, where here 128 query
// heads read one shared 576-wide key a token, [c_kv (512); k_rope (64)],
// whose first 512 values are also the value.  So per row the work is two
// products, S = q~ K^T ((heads x 576) by (576 x keys)) and O = P C
// ((heads x keys) by (keys x 512)), 2 x 128 x (576 + 512) operations a key:
// about 72 GFLOP a layer at 768 rows of ~338 keys, against ~600 MB of
// latent pages.  On the CUDA cores that work would bound the kernel; on the
// tensor cores (989 TFLOP/s bf16) the pages' bytes do (3.35 TB/s), so both
// products run on mma.sync.m16n8k16 in bfloat16 with float32 sums.
//
// Design (fixed launch parameters, no tuning table):
//   - grid (H / 32, B), 256 threads: a block takes 32 heads of one row, the
//     head blocks of a row adjacent in launch order so that they read the
//     row's pages through L2 together; 82,304 bytes of shared memory, two
//     blocks an SM.
//   - the block walks the row's valid keys (positions 0..lengths[b], the
//     new token's latent already scattered into its page) 32 at a time:
//     the tile's latents are read from the float32 pool, 16 bytes a
//     thread, and kept in shared memory as bfloat16 (exact: the pool holds
//     latents computed in bfloat16); rows padded by 8 elements so that the
//     fragment loads hit 32 banks.
//   - S: each of the 8 warps one 16-head x 8-key piece over the 576
//     dimensions (36 mma); scaled, masked past the row's length, into
//     shared memory.  An online softmax, 8 threads a head, keeps m and l
//     in shared memory (l sums the bfloat16 probabilities the value
//     product takes) and rescales.
//   - O: each warp 16 heads x 128 of the 512 value dimensions in
//     registers, P from shared memory, the latent's values through
//     ldmatrix.trans.
//   - no split of a row's keys across blocks: a row sums its keys in one
//     order whatever the batch.  A padding row (length -1) writes zeros.
// The pool is read once by each of the 4 head blocks of a row; the rest
// comes from L2.  This is the first, simple version: no cp.async or TMA
// ring, no wgmma, a __syncthreads between the phases.
#include "common.cuh"

namespace {

constexpr int kD = 576;                // latent width
constexpr int kDV = 512;               // value width (c_kv)
constexpr int kHB = 32;                // heads a block
constexpr int kKT = 32;                // keys a tile
constexpr int kThreads = 256;          // 8 warps
constexpr int kLD = kD + 8;            // bf16 row stride of the Q and K tiles
constexpr int kLDS = kKT + 4;          // f32 row stride of the score tile
constexpr int kLDP = kKT + 8;          // bf16 row stride of the P tile
constexpr int kSmemBytes = (kHB * kLD + kKT * kLD) * 2 + kHB * kLDS * 4 +
                           kHB * kLDP * 2 + 3 * kHB * 4;
static_assert(kSmemBytes <= 227 * 1024 / 2, "two blocks an SM");

using repro::ldsm_x4_t;
using repro::mma16816;
using repro::pack_bf16;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads, 2)
latent_decode_kernel(const __nv_bfloat16* __restrict__ q,
                     const float* __restrict__ pool,
                     const int* __restrict__ page_table,
                     const int* __restrict__ lengths,
                     __nv_bfloat16* __restrict__ out, float scale, int H,
                     int ps, int n_pages) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kHB * kLD;
  float* Ss = reinterpret_cast<float*>(Ks + kKT * kLD);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(Ss + kHB * kLDS);
  float* m_s = reinterpret_cast<float*>(Ps + kHB * kLDP);
  float* l_s = m_s + kHB;
  float* a_s = l_s + kHB;

  const int b = blockIdx.y;
  const int h0 = blockIdx.x * kHB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int len = lengths[b];
  __nv_bfloat16* orow = out + ((size_t)b * H + h0) * kDV;
  if (len < 0) {
    for (int i = tid; i < kHB * kDV / 8; i += kThreads)
      reinterpret_cast<uint4*>(orow)[i] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const uint4* qrow =
      reinterpret_cast<const uint4*>(q + ((size_t)b * H + h0) * kD);
  for (int i = tid; i < kHB * kD / 8; i += kThreads) {
    const int r = i / (kD / 8), c = i % (kD / 8);
    *reinterpret_cast<uint4*>(Qs + r * kLD + c * 8) = qrow[i];
  }
  const float neg_inf = __int_as_float(0xff800000);
  if (tid < kHB) {
    m_s[tid] = neg_inf;
    l_s[tid] = 0.0f;
  }
  const int ht = warp >> 2;            // head tile: heads ht*16 .. +16
  const int part = warp & 3;           // S: keys part*8 ..; O: dims part*128 ..
  const int n_keys = len + 1;
  const int* pt = page_table + (size_t)b * n_pages;
  float o[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;

  for (int k0 = 0; k0 < n_keys; k0 += kKT) {
    __syncthreads();  // the last tile's readers are done
    for (int i = tid; i < kKT * (kD / 4); i += kThreads) {
      const int r = i / (kD / 4), c = i % (kD / 4);
      const int key = k0 + r;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (key < n_keys) {
        const int page = pt[key / ps];
        v = reinterpret_cast<const float4*>(
            pool + ((size_t)page * ps + key % ps) * kD)[c];
      }
      uint2 packed;
      packed.x = pack_bf16(v.x, v.y);
      packed.y = pack_bf16(v.z, v.w);
      *reinterpret_cast<uint2*>(Ks + r * kLD + c * 4) = packed;
    }
    __syncthreads();

    // S = q~ K^T: heads ht*16 .. +16, keys part*8 .. +8
    {
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const __nv_bfloat16* qa = Qs + (ht * 16 + g) * kLD + t * 2;
      const __nv_bfloat16* kb = Ks + (part * 8 + g) * kLD + t * 2;
#pragma unroll 4
      for (int kk = 0; kk < kD; kk += 16) {
        uint32_t a[4];
        a[0] = ld32(qa + kk);
        a[1] = ld32(qa + 8 * kLD + kk);
        a[2] = ld32(qa + kk + 8);
        a[3] = ld32(qa + 8 * kLD + kk + 8);
        mma16816(s, a, ld32(kb + kk), ld32(kb + kk + 8));
      }
      const int key = k0 + part * 8 + t * 2;
      float* srow = Ss + (ht * 16 + g) * kLDS + part * 8 + t * 2;
      srow[0] = key < n_keys ? s[0] * scale : neg_inf;
      srow[1] = key + 1 < n_keys ? s[1] * scale : neg_inf;
      srow[8 * kLDS] = key < n_keys ? s[2] * scale : neg_inf;
      srow[8 * kLDS + 1] = key + 1 < n_keys ? s[3] * scale : neg_inf;
    }
    __syncthreads();

    // online softmax: 8 threads a head, 4 keys each
    {
      const int r = tid >> 3, sub = tid & 7;
      const float4 x = *reinterpret_cast<const float4*>(Ss + r * kLDS + sub * 4);
      const float m_old = m_s[r];
      const float l_old = l_s[r];
      float mx = fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w));
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // finite: key k0 <= len is valid in every tile
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      const __nv_bfloat16 p0 = __float2bfloat16(expf(x.x - m_new));
      const __nv_bfloat16 p1 = __float2bfloat16(expf(x.y - m_new));
      const __nv_bfloat16 p2 = __float2bfloat16(expf(x.z - m_new));
      const __nv_bfloat16 p3 = __float2bfloat16(expf(x.w - m_new));
      float sum = __bfloat162float(p0) + __bfloat162float(p1) +
                  __bfloat162float(p2) + __bfloat162float(p3);
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __nv_bfloat16* prow = Ps + r * kLDP + sub * 4;
      prow[0] = p0;
      prow[1] = p1;
      prow[2] = p2;
      prow[3] = p3;
      __syncwarp();
      if (sub == 0) {
        m_s[r] = m_new;
        l_s[r] = l_old * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // O = O * alpha + P C: heads ht*16 .. +16, dims part*128 .. +128
    {
      const float al0 = a_s[ht * 16 + g], al1 = a_s[ht * 16 + g + 8];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[j][0] *= al0;
        o[j][1] *= al0;
        o[j][2] *= al1;
        o[j][3] *= al1;
      }
      const __nv_bfloat16* pa = Ps + (ht * 16 + g) * kLDP + t * 2;
#pragma unroll
      for (int kk = 0; kk < kKT; kk += 16) {
        uint32_t a[4];
        a[0] = ld32(pa + kk);
        a[1] = ld32(pa + 8 * kLDP + kk);
        a[2] = ld32(pa + kk + 8);
        a[3] = ld32(pa + 8 * kLDP + kk + 8);
        const int row = kk + (lane & 15);
        const int col = part * 128 + ((lane >> 4) << 3);
#pragma unroll
        for (int j = 0; j < 16; j += 2) {
          uint32_t bb[4];
          ldsm_x4_t(bb, Ks + row * kLD + col + j * 8);
          mma16816(o[j], a, bb[0], bb[1]);
          mma16816(o[j + 1], a, bb[2], bb[3]);
        }
      }
    }
  }

  const float inv0 = 1.0f / l_s[ht * 16 + g];
  const float inv1 = 1.0f / l_s[ht * 16 + g + 8];
  __nv_bfloat16* o0 = orow + (ht * 16 + g) * kDV + part * 128 + t * 2;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<uint32_t*>(o0 + j * 8) =
        pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    *reinterpret_cast<uint32_t*>(o0 + 8 * kDV + j * 8) =
        pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
}

}  // namespace

// q (B, H, 576) bf16, pool (P, ps, 576) f32, page_table (B, n_pages) int32,
// lengths (B,) int32, out (B, H, 512) bf16; all contiguous, q and the pool
// 16-byte aligned.  Returns the launch's cudaError_t.
extern "C" int latent_decode_attention_fwd(const void* q, const void* pool,
                                           const int* page_table,
                                           const int* lengths, void* out,
                                           float scale, int B, int H, int ps,
                                           int n_pages, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H % kHB != 0 || ps <= 0 ||
      n_pages <= 0)
    return (int)cudaErrorInvalidValue;
  static size_t allowed[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  cudaError_t e = repro::allow_smem(latent_decode_kernel, kSmemBytes, allowed);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H / kHB, B);
  latent_decode_kernel<<<grid, kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(pool),
      page_table, lengths, static_cast<__nv_bfloat16*>(out), scale, H, ps,
      n_pages);
  return (int)cudaGetLastError();
}
