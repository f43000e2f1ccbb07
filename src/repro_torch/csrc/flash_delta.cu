// FlashAttention-2 backward preprocess: delta = rowsum(dO * O) in f32.
//
// Replaces repro/kernels/flash_attention_bwd.py::_delta_kernel (launched
// by _compute_delta).  One warp per (b, h, q) row: each lane reads D / 32
// elements of both rows, and a five-step xor shuffle sums them.
//
// Bound: bytes.  At the main-path shape it reads 2 x 33.5 MB and writes
// 0.5 MB (20 us at 3.35 TB/s) for 8.4 M multiply-adds.  Lanes read
// neighbouring elements of a row, so each warp's loads are coalesced;
// one pass, nothing kept.
#include "flash_common.cuh"

namespace flash {

template <typename T>
__global__ void __launch_bounds__(NT)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             int H, int Sq, int D, long long rows, long long osb, long long osh, long long oss,
             long long dsb, long long dsh, long long dss) {
  const long long row = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int s = (int)(row % Sq);
  const long long bh = row / Sq;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const T* orow = o + b * osb + h * osh + s * oss;
  const T* drow = dout + b * dsb + h * dsh + s * dss;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T>
int launch_delta(const void* o, const void* dout, void* delta, int B, int H, int Sq, int D,
                 long long osb, long long osh, long long oss, long long dsb, long long dsh,
                 long long dss, cudaStream_t stream) {
  const long long rows = (long long)B * H * Sq;
  const long long blocks = (rows + NT / 32 - 1) / (NT / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  delta_kernel<T><<<(unsigned)blocks, NT, 0, stream>>>((const T*)o, (const T*)dout,
                                                       (float*)delta, H, Sq, D, rows, osb, osh,
                                                       oss, dsb, dsh, dss);
  return (int)cudaGetLastError();
}

}  // namespace flash

// o, dout: (B, H, Sq, D) strided; delta: (B, H, Sq) f32 contiguous.
extern "C" int flash_delta(int dtype, const void* o, const void* dout, void* delta, int B,
                           int H, int Sq, int D, long long osb, long long osh, long long oss,
                           long long dsb, long long dsh, long long dss, void* stream) {
  if (dtype == 0)
    return flash::launch_delta<float>(o, dout, delta, B, H, Sq, D, osb, osh, oss, dsb, dsh,
                                      dss, (cudaStream_t)stream);
  if (dtype == 1)
    return flash::launch_delta<__nv_bfloat16>(o, dout, delta, B, H, Sq, D, osb, osh, oss, dsb,
                                              dsh, dss, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
