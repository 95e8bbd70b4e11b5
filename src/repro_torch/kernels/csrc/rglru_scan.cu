// RG-LRU linear-recurrence scan for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan/kernel.py,
// linear_scan_kernel (body _scan_kernel): h_t = a_t * h_{t-1} + b_t from
// h_{-1} = 0, elementwise over the channels, a, b, h (B,S,D) float32.
//
// What bounds it on the H100: bytes.  Each element is read twice (a, b)
// and written once and costs two FLOPs, so the bound is 12 bytes an
// element over the 3.35 TB/s memory rate: at the hybrid's prefill shape
// (1, 384, 2560) a, b and h are 11.8 MB, about 3.5 us.  The recurrence is
// sequential in time but independent across (b, d); its chain at that
// shape is 384 dependent multiply-adds, about 2 us.  What stands between
// the two is memory-level parallelism: a thread that loads its own next
// steps keeps a few hundred bytes in flight, and B*D channels make few
// blocks.
//
// What the design does: a block scans CH = 32 channels, so
// (1, 384, 2560) runs 80 blocks across the SMs (16 channels, 160 blocks,
// measured the same on an H100).  The block
// stages a and b in tiles of kTile time steps x CH channels through a ring
// of kStages stages of cp.async copies (16 bytes a thread where D and the
// pointers allow, 4 bytes otherwise), so kStages - 1 tiles (48 KB a block)
// are in flight while one is scanned.  Warp 0 scans: one thread per
// channel walks the tile with h in a register, reading kUnroll steps of a
// and b from shared memory into registers ahead of their updates;
// neighbouring threads hold neighbouring channels, so the shared-memory
// reads are conflict-free and every h store of a step is coalesced.  Warps
// 1-3 only issue the copies, so the scanning warp's instruction stream
// holds the chain and its stores and nothing else (a block of one warp
// that also issued its copies took 10 us at that shape on an H100, at 16
// and at 32 channels alike; with the copies moved off it, 6 us).
// The update is __fadd_rn(__fmul_rn(a, h), b): nvcc may not contract it
// into an FMA, so the kernel rounds exactly as the plain sequential
// version (a multiply, then an add) and equals it bitwise; no associative
// split of S is taken, since it would round differently.
//
// The backward (linear_scan_bwd_kernel; no Pallas counterpart: the JAX
// model differentiates its associative scan, repro/engine/models/rglru.py)
// is the same recurrence backwards in time, g_t = dh_t + a_{t+1} g_{t+1},
// with db = g and da_t = g_t h_{t-1}.  Bound by bytes: a, h and dh read, da
// and db written, 20 bytes an element; at the hybrid's training shape (4,
// 512, 2560) 105 MB, 0.0313 ms.  It is one kernel of the forward's design
// walking the time tiles from the last: the copiers stage a, dh and h one
// step earlier (h_{t-1} at row t, zero before time 0) in place, so no
// reversed or shifted copy of any tensor is made; the scanning lane
// carries g and a_{t+1} in registers and rounds as the plain reverse walk
// (a multiply, then an add; da one multiply), which it equals bitwise.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int CH = 32;         // channels a block scans, a lane each
constexpr int kThreads = 128;  // warp 0 scans, warps 1-3 copy
constexpr int kCopiers = kThreads - 32;
constexpr int kTile = 64;      // time steps a stage holds
constexpr int kStages = 4;     // the copy ring
constexpr int kUnroll = 8;     // steps read into registers ahead

constexpr size_t kSmemBytes = 2 * sizeof(float) * kStages * kTile * CH;
constexpr size_t kBwdSmemBytes = 3 * sizeof(float) * kStages * kTile * CH;

// One block: channels [blockIdx.x*CH, +CH) of batch row blockIdx.y.
__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ h, int S, int D, int vec16) {
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                               // [kStages][kTile][CH]
  float* b_s = smem + (size_t)kStages * kTile * CH;
  const int tid = threadIdx.x;
  const int ct = tid - 32;                         // copier index, < 0: scan
  const int d0 = blockIdx.x * CH;
  const int nch = min(CH, D - d0);                 // this block's channels
  const size_t base = (size_t)blockIdx.y * S * D + d0;
  const int n_tiles = (S + kTile - 1) / kTile;

  // tile k into ring slot k % kStages by the copiers; one commit group a
  // tile, empty past the end (and for the scanning warp), so the wait
  // count stays fixed
  auto load_tile = [&](int k) {
    if (ct >= 0 && k < n_tiles) {
      const int t0 = k * kTile, nt = min(kTile, S - t0);
      float* as = a_s + (size_t)(k % kStages) * kTile * CH;
      float* bs = b_s + (size_t)(k % kStages) * kTile * CH;
      if (vec16) {                 // D % 4 == 0: nch is whole vectors
        constexpr int VPR = CH / 4;
        for (int i = ct; i < nt * VPR; i += kCopiers) {
          const int t = i / VPR, x = 4 * (i % VPR);
          if (x < nch) {
            const size_t off = base + (size_t)(t0 + t) * D + x;
            repro::cp_async16(as + t * CH + x, a + off);
            repro::cp_async16(bs + t * CH + x, b + off);
          }
        }
      } else {
        for (int i = ct; i < nt * CH; i += kCopiers) {
          const int t = i / CH, x = i % CH;
          if (x < nch) {
            const size_t off = base + (size_t)(t0 + t) * D + x;
            repro::cp_async4(as + t * CH + x, a + off);
            repro::cp_async4(bs + t * CH + x, b + off);
          }
        }
      }
    }
    repro::cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) load_tile(k);

  float hv = 0.0f;
  float* hp = h + base + tid;
  for (int k = 0; k < n_tiles; ++k) {
    repro::cp_async_wait<kStages - 2>();
    __syncthreads();        // tile k landed; tile k-1 fully read
    load_tile(k + kStages - 1);
    if (tid >= nch) continue;        // copiers, and lanes past the channels
    const float* as = a_s + (size_t)(k % kStages) * kTile * CH + tid;
    const float* bs = b_s + (size_t)(k % kStages) * kTile * CH + tid;
    const int t0 = k * kTile, nt = min(kTile, S - t0);
    float* ht = hp + (size_t)t0 * D;
    if (nt == kTile) {
#pragma unroll
      for (int u0 = 0; u0 < kTile; u0 += kUnroll) {
        float av[kUnroll], bv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          av[u] = as[(u0 + u) * CH];
          bv[u] = bs[(u0 + u) * CH];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          hv = __fadd_rn(__fmul_rn(av[u], hv), bv[u]);
          ht[(size_t)(u0 + u) * D] = hv;
        }
      }
    } else {
      for (int t = 0; t < nt; ++t) {
        hv = __fadd_rn(__fmul_rn(as[t * CH], hv), bs[t * CH]);
        ht[(size_t)t * D] = hv;
      }
    }
  }
}

// The backward, one block per (CH channels, batch row) as the forward,
// walking the time tiles from the last: g_t = dh_t + a_{t+1} g_{t+1} (a
// zero past the end) in a register, rounded as the forward (a multiply,
// then an add), db_t = g_t and da_t = g_t h_{t-1} (h_{-1} = 0).  A stage
// holds a, dh and h one step earlier for its kTile steps, read in place.
__global__ void __launch_bounds__(kThreads)
linear_scan_bwd_kernel(const float* __restrict__ a,
                       const float* __restrict__ h,
                       const float* __restrict__ dh, float* __restrict__ da,
                       float* __restrict__ db, int S, int D, int vec16) {
  extern __shared__ __align__(16) float smem[];
  constexpr size_t kRing = (size_t)kStages * kTile * CH;
  float* a_s = smem;                               // [kStages][kTile][CH]
  float* d_s = smem + kRing;                       // dh
  float* h_s = smem + 2 * kRing;                   // h_{t-1} at row t
  const int tid = threadIdx.x;
  const int ct = tid - 32;                         // copier index, < 0: scan
  const int d0 = blockIdx.x * CH;
  const int nch = min(CH, D - d0);
  const size_t base = (size_t)blockIdx.y * S * D + d0;
  const int n_tiles = (S + kTile - 1) / kTile;

  // walk tile k (time tile n_tiles - 1 - k) into ring slot k % kStages;
  // row t of the h stage is h_{t0+t-1}, zero before time 0
  auto load_tile = [&](int k) {
    if (ct >= 0 && k < n_tiles) {
      const int t0 = (n_tiles - 1 - k) * kTile, nt = min(kTile, S - t0);
      float* as = a_s + (size_t)(k % kStages) * kTile * CH;
      float* ds = d_s + (size_t)(k % kStages) * kTile * CH;
      float* hs = h_s + (size_t)(k % kStages) * kTile * CH;
      if (vec16) {                 // D % 4 == 0: nch is whole vectors
        constexpr int VPR = CH / 4;
        for (int i = ct; i < nt * VPR; i += kCopiers) {
          const int t = i / VPR, x = 4 * (i % VPR);
          if (x < nch) {
            const size_t off = base + (size_t)(t0 + t) * D + x;
            const bool prev = t0 + t > 0;
            repro::cp_async16(as + t * CH + x, a + off);
            repro::cp_async16(ds + t * CH + x, dh + off);
            repro::cp_async16(hs + t * CH + x, h + (prev ? off - D : off),
                              prev);
          }
        }
      } else {
        for (int i = ct; i < nt * CH; i += kCopiers) {
          const int t = i / CH, x = i % CH;
          if (x < nch) {
            const size_t off = base + (size_t)(t0 + t) * D + x;
            const bool prev = t0 + t > 0;
            repro::cp_async4(as + t * CH + x, a + off);
            repro::cp_async4(ds + t * CH + x, dh + off);
            repro::cp_async4(hs + t * CH + x, h + (prev ? off - D : off),
                             prev);
          }
        }
      }
    }
    repro::cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) load_tile(k);

  float g = 0.0f, a_next = 0.0f;
  for (int k = 0; k < n_tiles; ++k) {
    repro::cp_async_wait<kStages - 2>();
    __syncthreads();        // tile k landed; tile k-1 fully read
    load_tile(k + kStages - 1);
    if (tid >= nch) continue;
    const size_t slot = (size_t)(k % kStages) * kTile * CH + tid;
    const float* as = a_s + slot;
    const float* ds = d_s + slot;
    const float* hs = h_s + slot;
    const int t0 = (n_tiles - 1 - k) * kTile, nt = min(kTile, S - t0);
    float* dat = da + base + tid + (size_t)t0 * D;
    float* dbt = db + base + tid + (size_t)t0 * D;
    if (nt == kTile) {
#pragma unroll
      for (int u0 = kTile - kUnroll; u0 >= 0; u0 -= kUnroll) {
        float av[kUnroll], dv[kUnroll], hv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          av[u] = as[(u0 + u) * CH];
          dv[u] = ds[(u0 + u) * CH];
          hv[u] = hs[(u0 + u) * CH];
        }
#pragma unroll
        for (int u = kUnroll - 1; u >= 0; --u) {
          g = __fadd_rn(__fmul_rn(a_next, g), dv[u]);
          dbt[(size_t)(u0 + u) * D] = g;
          dat[(size_t)(u0 + u) * D] = __fmul_rn(g, hv[u]);
          a_next = av[u];
        }
      }
    } else {
      for (int t = nt - 1; t >= 0; --t) {
        g = __fadd_rn(__fmul_rn(a_next, g), ds[t * CH]);
        dbt[(size_t)t * D] = g;
        dat[(size_t)t * D] = __fmul_rn(g, hs[t * CH]);
        a_next = as[t * CH];
      }
    }
  }
}

}  // namespace

// a, b, h: (B,S,D) float32, contiguous.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int linear_scan_fwd(const float* a, const float* b, float* h,
                               int B, int S, int D, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  static size_t allowed[8] = {0};
  cudaError_t e = repro::allow_smem(linear_scan_kernel, kSmemBytes, allowed);
  if (e != cudaSuccess) return (int)e;
  const int vec16 = D % 4 == 0 && ((uintptr_t)a | (uintptr_t)b) % 16 == 0;
  const dim3 grid((D + CH - 1) / CH, B);
  linear_scan_kernel<<<grid, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(a, b, h, S, D,
                                                            vec16);
  return (int)cudaGetLastError();
}

// a, h, dh, da, db: (B,S,D) float32, contiguous; h the forward's output, dh
// its gradient.  Writes the gradient of h = linear_scan(a, b): da and db.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int linear_scan_bwd(const float* a, const float* h,
                               const float* dh, float* da, float* db, int B,
                               int S, int D, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  static size_t allowed[8] = {0};
  cudaError_t e =
      repro::allow_smem(linear_scan_bwd_kernel, kBwdSmemBytes, allowed);
  if (e != cudaSuccess) return (int)e;
  const int vec16 =
      D % 4 == 0 && ((uintptr_t)a | (uintptr_t)h | (uintptr_t)dh) % 16 == 0;
  const dim3 grid((D + CH - 1) / CH, B);
  linear_scan_bwd_kernel<<<grid, kThreads, kBwdSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      a, h, dh, da, db, S, D, vec16);
  return (int)cudaGetLastError();
}
