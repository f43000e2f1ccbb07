// RG-LRU (Griffin) linear recurrence for Hopper: the scan and its reverse.
//
//   forward   h_t = a_t * h_{t-1} + b_t,            h_{-1} = 0
//   backward  lam_t = dy_t + a_{t+1} * lam_{t+1},   lam_S = 0
//             db_t = lam_t,  da_t = lam_t * h_{t-1}
//
// Replaces repro/kernels/rglru.py::_rglru_kernel (entry rglru_fwd) and
// repro/kernels/rglru_bwd.py::_rglru_bwd_kernel (entry rglru_bwd).  The
// TPU grid (B, W / 128, S / chunk) walked its chunk axis in order with the
// (1, 128) carry in VMEM scratch; here one thread owns one (b, w) channel
// and walks the whole sequence with the carry in a register, so the chunk
// has no counterpart and changes no number.  Neighbouring threads own
// neighbouring w, so every load and store of a step is coalesced.  The
// backward reads h_{t-1} straight from the forward's output (zero at
// t = 0) instead of a shifted copy of it.
//
// Bound: bytes.  Each step is one multiply-add per channel against 12
// (forward) or 20 (backward) bytes of f32 traffic.  At recurrentgemma-2b's
// shape (B 2, S 2048, W 2560) the forward moves 125.8 MB (0.0376 ms at
// 3.35 TB/s) and the backward 209.7 MB (0.0626 ms).  The loads of a step
// do not depend on the carry, so each thread loads U = 16 steps ahead of
// the ones it computes (two register buffers).  What this design cannot
// fix is its width: B x W = 5120 channels are 80 blocks of 64 threads, too
// few bytes in flight to cover the memory latency.  The chunk-parallel
// scan (local scans per (b, w-block, chunk) block, a carry pass over the
// chunks, a fix-up) is the redesign that fills the card.  On an NVIDIA
// H100 80GB HBM3 at 700 W the two take 0.134 and 0.148 ms at that shape,
// 3.6x and 2.4x their bounds (chip_smoke.py).  nvcc -Xptxas -v (CUDA
// 12.8): 80 registers forward, 124 backward, no spill.
//
// nvcc contracts a * h + b into one FMA, one rounding where the plain
// PyTorch version rounds the product and the sum; the two agree to about
// 1e-7 relative, far inside the 1e-5 the tests hold them to.
#include "kernel_common.cuh"

namespace rglru {

constexpr int NT = 64;   // channels (threads) per block
constexpr int U = 16;    // steps loaded ahead of the carry

__global__ void __launch_bounds__(NT)
fwd_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ h,
           int S, int W) {
  const int w = blockIdx.x * NT + threadIdx.x;
  if (w >= W) return;
  const long long base = (long long)blockIdx.y * S * W + w;
  float an[U], bn[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = base + (long long)u * W;
    an[u] = u < S ? a[i] : 0.f;
    bn[u] = u < S ? b[i] : 0.f;
  }
  float hv = 0.f;
  for (int t0 = 0; t0 < S; t0 += U) {
    float ac[U], bc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ac[u] = an[u];
      bc[u] = bn[u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {   // the next U steps, in flight meanwhile
      const int t = t0 + U + u;
      const long long i = base + (long long)t * W;
      an[u] = t < S ? a[i] : 0.f;
      bn[u] = t < S ? b[i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      hv = fmaf(ac[u], hv, bc[u]);
      if (t < S) h[base + (long long)t * W] = hv;
    }
  }
}

__global__ void __launch_bounds__(NT)
bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
           const float* __restrict__ dy, float* __restrict__ da, float* __restrict__ db, int S,
           int W) {
  const int w = blockIdx.x * NT + threadIdx.x;
  if (w >= W) return;
  const long long base = (long long)blockIdx.y * S * W + w;
  // step t of a group is t1 - u, walking down from t1 = S - 1
  float an[U], dyn[U], hn[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = S - 1 - u;
    const long long i = base + (long long)t * W;
    an[u] = t >= 0 ? a[i] : 0.f;
    dyn[u] = t >= 0 ? dy[i] : 0.f;
    hn[u] = t >= 1 ? h[i - W] : 0.f;
  }
  float carry = 0.f;   // a_{t+1} * lam_{t+1}
  for (int t1 = S - 1; t1 >= 0; t1 -= U) {
    float ac[U], dyc[U], hc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ac[u] = an[u];
      dyc[u] = dyn[u];
      hc[u] = hn[u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t1 - U - u;
      const long long i = base + (long long)t * W;
      an[u] = t >= 0 ? a[i] : 0.f;
      dyn[u] = t >= 0 ? dy[i] : 0.f;
      hn[u] = t >= 1 ? h[i - W] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t1 - u;
      const float lam = dyc[u] + carry;
      if (t >= 0) {
        const long long i = base + (long long)t * W;
        db[i] = lam;
        da[i] = lam * hc[u];
      }
      carry = ac[u] * lam;
    }
  }
}

inline int grid_ok(int B, int W) { return B >= 1 && B <= 65535 && W >= 1; }

}  // namespace rglru

// a, b, h: (B, S, W) f32 contiguous.
extern "C" int rglru_fwd(const void* a, const void* b, void* h, int B, int S, int W,
                         void* stream) {
  if (!rglru::grid_ok(B, W) || S < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((W + rglru::NT - 1) / rglru::NT, B);
  rglru::fwd_kernel<<<grid, rglru::NT, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)h, S, W);
  return (int)cudaGetLastError();
}

// a, h (the forward's output), dy, da, db: (B, S, W) f32 contiguous.
extern "C" int rglru_bwd(const void* a, const void* h, const void* dy, void* da, void* db,
                         int B, int S, int W, void* stream) {
  if (!rglru::grid_ok(B, W) || S < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((W + rglru::NT - 1) / rglru::NT, B);
  rglru::bwd_kernel<<<grid, rglru::NT, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)h, (const float*)dy, (float*)da, (float*)db, S, W);
  return (int)cudaGetLastError();
}
