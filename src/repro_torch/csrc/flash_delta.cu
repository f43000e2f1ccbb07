// FlashAttention-2 backward preprocess: delta = rowsum(dO * O) in f32.
//
// Replaces repro/kernels/flash_attention_bwd.py::_delta_kernel (launched
// by _compute_delta): delta[b, h, q] = sum_d O[b, h, q, d] dO[b, h, q, d],
// summed in f32 and written as a contiguous (B, H, Sq) f32 array.  O and
// dO are (B, H, Sq, D) strided views with a unit stride on D.
//
// Bound: bytes.  At yi-6b's main-path shape (B 2, H 32, Sq 2048, D 128,
// bf16) it reads 2 x 33.5 MB and writes 0.5 MB, 20.2 us at 3.35 TB/s, for
// 8.4 M multiply-adds; at recurrentgemma-2b's (H 10, D 256) 2 x 21 MB and
// 0.16 MB, 12.6 us.  Nothing is reused, so the kernel is a stream, and a
// stream reaches the card's rate only with enough bytes in flight (some
// tens of KB an SM) in wide, coalesced loads.
//
// The design: the kernel is templated on the element type and on D.  Each
// thread makes one 16-byte load of O and one of dO per row (8 bf16 or 4
// f32 values), so L = D * sizeof(T) / 16 neighbouring lanes share a row
// (2 to 32) and a warp covers 32 / L rows.  A thread owns DELTA_RPT rows,
// DELTA_NT / L rows apart, and starts all 2 * DELTA_RPT of its loads
// before the first multiply.  On the card one row a thread was fastest:
// at 16 to 21 registers 2048 threads an SM keep 64 KB of loads in flight,
// where 4 rows a thread took 69 registers, 768 threads an SM and 1.2-1.4x
// the time (analysis/delta_tiles.py sweeps both constants).  A
// log2(L)-step xor shuffle inside the lane group sums a row, in a fixed
// order, and the group's first lane writes it: one owner per output, no
// atomics, equal bits on every call.  Rows past the last are masked, so
// any Sq works.  The wrapper (kernels/flash_attention_bwd.py::
// compute_delta) admits only 16-byte aligned data with batch, head and
// sequence strides that are multiples of 16 bytes; the entry refuses
// anything else rather than read it another way.
#include <stdint.h>

#include "kernel_common.cuh"

namespace flash {

constexpr int DELTA_NT = 256;   // threads per block
constexpr int DELTA_RPT = 1;    // rows per thread, all loads in flight at once

using bf16 = __nv_bfloat16;

// One 16-byte chunk of a row and its dot product with another, in f32.
template <typename T> struct Chunk;

template <> struct Chunk<float> {
  using type = float4;
  static __device__ __forceinline__ float dot(float4 a, float4 b) {
    float acc = a.x * b.x;
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
  }
};

template <> struct Chunk<bf16> {
  using type = uint4;
  static __device__ __forceinline__ float dot(uint4 a, uint4 b) {
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(pa[i]), y = __bfloat1622float2(pb[i]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
    return acc;
  }
};

template <typename T, int D>
struct DeltaShape {
  static constexpr int VEC = 16 / (int)sizeof(T);   // elements per chunk
  static constexpr int L = D / VEC;                 // lanes per row
  static constexpr int PASS = DELTA_NT / L;         // rows of a block per pass
  static constexpr int ROWS = PASS * DELTA_RPT;     // rows of a block
  static_assert(L >= 2 && L <= 32 && (L & (L - 1)) == 0, "a row is 2 to 32 lanes");
  static_assert(DELTA_NT % 32 == 0, "whole warps");
};

template <typename T, int D>
__global__ void __launch_bounds__(DELTA_NT)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             int H, int Sq, int rows, long long osb, long long osh, long long oss,
             long long dsb, long long dsh, long long dss) {
  using S = DeltaShape<T, D>;
  using V = typename Chunk<T>::type;
  const int lane = threadIdx.x % S::L;
  const int first = blockIdx.x * S::ROWS + threadIdx.x / S::L;
  V a[DELTA_RPT], b[DELTA_RPT];
#pragma unroll
  for (int r = 0; r < DELTA_RPT; ++r) {
    const int row = first + r * S::PASS;
    a[r] = V{};
    b[r] = V{};
    if (row < rows) {
      const int bh = row / Sq, s = row - bh * Sq;
      const int bi = bh / H, h = bh - bi * H;
      const T* orow = o + bi * osb + h * osh + s * oss;
      const T* drow = dout + bi * dsb + h * dsh + s * dss;
      a[r] = __ldg(reinterpret_cast<const V*>(orow) + lane);
      b[r] = __ldg(reinterpret_cast<const V*>(drow) + lane);
    }
  }
#pragma unroll
  for (int r = 0; r < DELTA_RPT; ++r) {
    float acc = Chunk<T>::dot(a[r], b[r]);
#pragma unroll
    for (int off = S::L / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const int row = first + r * S::PASS;
    if (lane == 0 && row < rows) delta[row] = acc;
  }
}

template <typename T, int D>
int launch_delta(const void* o, const void* dout, void* delta, int B, int H, int Sq,
                 long long osb, long long osh, long long oss, long long dsb, long long dsh,
                 long long dss, cudaStream_t stream) {
  using S = DeltaShape<T, D>;
  // the wrapper's alignment check, again: 16-byte chunks only
  const long long st[6] = {osb, osh, oss, dsb, dsh, dss};
  for (long long x : st)
    if (x % S::VEC) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)o | (uintptr_t)dout) % 16) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H * Sq;
  if (rows == 0) return (int)cudaSuccess;
  if (rows > 0x7fffffffLL - S::ROWS) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((rows + S::ROWS - 1) / S::ROWS);
  delta_kernel<T, D><<<blocks, DELTA_NT, 0, stream>>>(
      (const T*)o, (const T*)dout, (float*)delta, H, Sq, (int)rows, osb, osh, oss, dsb, dsh,
      dss);
  return (int)cudaGetLastError();
}

}  // namespace flash

// o, dout: (B, H, Sq, D) strided, unit stride on D, 16-byte aligned with
// strides that are multiples of 16 bytes; delta: (B, H, Sq) f32
// contiguous.  dtype 0 is f32 (D 16, 32, 64, 128), 1 is bf16 (D 16 to
// 256); any other pair is refused.
extern "C" int flash_delta(int dtype, const void* o, const void* dout, void* delta, int B,
                           int H, int Sq, int D, long long osb, long long osh, long long oss,
                           long long dsb, long long dsh, long long dss, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define DELTA_CASE(T, DD)                                                                  \
  if (D == DD)                                                                             \
    return flash::launch_delta<T, DD>(o, dout, delta, B, H, Sq, osb, osh, oss, dsb, dsh, \
                                      dss, st);
  if (dtype == 0) {
    DELTA_CASE(float, 16)
    DELTA_CASE(float, 32)
    DELTA_CASE(float, 64)
    DELTA_CASE(float, 128)
  } else if (dtype == 1) {
    DELTA_CASE(flash::bf16, 16)
    DELTA_CASE(flash::bf16, 32)
    DELTA_CASE(flash::bf16, 64)
    DELTA_CASE(flash::bf16, 128)
    DELTA_CASE(flash::bf16, 256)
  }
#undef DELTA_CASE
  return (int)cudaErrorInvalidValue;
}
