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
// sequential in time but independent across (b, d).
//
// What the design does: one thread per (b, d) channel walks S with h in a
// register; neighbouring threads hold neighbouring channels, so every load
// and store of a time step is coalesced.  The loads of kUnroll steps are
// issued before their updates, since they do not depend on h, so several
// are in flight while the dependent chain runs.  The update is written as
// __fadd_rn(__fmul_rn(a, h), b): nvcc may not contract it into an FMA, so
// the kernel rounds exactly as the plain sequential version (a multiply,
// then an add) and equals it bitwise.  With B*D channels in 64-thread
// blocks, (1, 384, 2560) gives 40 blocks on 132 SMs; splitting S into
// chunks combined by a second pass is later work (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ h, int S, int D, long long channels) {
  const long long ch = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (ch >= channels) return;
  const long long bi = ch / D, d = ch % D;
  const size_t base = (size_t)bi * S * D + d;
  float hv = 0.0f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      av[u] = t < S ? a[base + (size_t)t * D] : 0.0f;
      bv[u] = t < S ? b[base + (size_t)t * D] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < S) {
        hv = __fadd_rn(__fmul_rn(av[u], hv), bv[u]);
        h[base + (size_t)t * D] = hv;
      }
    }
  }
}

}  // namespace

// a, b, h: (B,S,D) float32, contiguous.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int linear_scan_fwd(const float* a, const float* b, float* h,
                               int B, int S, int D, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const long long channels = (long long)B * D;
  const unsigned blocks = (unsigned)((channels + kThreads - 1) / kThreads);
  linear_scan_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a, b, h, S, D,
                                                            channels);
  return (int)cudaGetLastError();
}
