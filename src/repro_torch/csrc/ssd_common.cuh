// Shared pieces of the Mamba-2 SSD scan kernels for Hopper (sm_90a).
//
// Layout: x (B, S, H, P), dA (B, S, H), b and c (B, S, H, N) and the
// per-position outputs are addressed through batch, sequence and head
// strides with a unit stride on the last dim, so the public tensors go in
// as views (b and c broadcast over heads with a head stride of 0).  The
// states -- final (B, H, P, N), per chunk (B, H, nc, P, N), their
// cotangents -- are contiguous float32.
//
// The f32 kernels: one block of NT = 256 threads owns one (batch, head)
// and walks its chunks of Q <= 256 positions in order (the TPU grid's
// "arbitrary" axis), with the (P, N) state in shared memory.  (The bf16
// kernels are chunk-parallel on the tensor cores; see ssd_fwd.cu and
// ssd_bwd.cu.)  Inside a chunk, work is
// cut into 64-row slabs and 64 x 64 tiles.  Thread t has ty = t / 16,
// tx = t % 16; in a 64-row tile it holds rows ty + 16 i (i < 4) and
// columns tx + 16 j, so the 16 lanes of a half-warp share a row and a row
// reduction is four xor shuffles.  Shared-memory rows are padded by one
// float, so 16 lanes reading 16 rows at one column hit 16 banks.
//
// A chunk whose positions run past S (the short last chunk) reads zero
// inputs and zero log-decay there, which is the JAX op's zero padding.
#pragma once

#include "kernel_common.cuh"

namespace ssd {

using common::set_smem;
using common::to_f32;

constexpr int NT = 256;      // threads per block
constexpr int R = 64;        // rows per slab or tile
constexpr int QMAX = 256;    // the largest chunk

struct Str {                 // batch, sequence and head strides (elements)
  long long b, s, h;
};

__device__ __forceinline__ int tid_y() { return threadIdx.x / 16; }
__device__ __forceinline__ int tid_x() { return threadIdx.x % 16; }

__device__ __forceinline__ float row_sum16(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [row0, row0 + R) of a chunk into dst (row stride ld), W columns,
// times a per-row weight w(row); rows at or past nvalid read as zero.
template <int W, typename T, typename Weight>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* base, long long ss,
                                          int row0, int nvalid, Weight w) {
  for (int idx = threadIdx.x; idx < R * W; idx += NT) {
    const int r = idx / W, col = idx % W, row = row0 + r;
    dst[r * ld + col] = row < nvalid ? to_f32(base[(long long)row * ss + col]) * w(row) : 0.f;
  }
}

struct One {
  __device__ __forceinline__ float operator()(int) const { return 1.f; }
};

// acc[i][j] += sum_k A[(ty + 16 i) * lda + k] * Bm[(tx + 16 j) * ldb + k]:
// a product of two row-major operands over their shared last dim.
template <int CB, int K>
__device__ __forceinline__ void rowdot(float (&acc)[4][CB], const float* A, int lda,
                                       const float* Bm, int ldb) {
  const int ty = tid_y(), tx = tid_x();
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], b[CB];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < CB; ++j) b[j] = Bm[(tx + 16 * j) * ldb + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CB; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k A[(ty + 16 i) * lda + k] * V[k * ldv + tx + 16 j]:
// a row-major (64 x K) times a row-major (K x 16 CB).
template <int CB, int K>
__device__ __forceinline__ void matacc(float (&acc)[4][CB], const float* A, int lda,
                                       const float* V, int ldv) {
  const int ty = tid_y(), tx = tid_x();
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], v[CB];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < CB; ++j) v[j] = V[k * ldv + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CB; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r U[r * ldu + ty + 16 i] * V[r * ldv + tx + 16 j] over
// the R rows of a tile: a (P, N) state update from (R, P) and (R, N) rows.
template <int RA, int CB>
__device__ __forceinline__ void outer_acc(float (&acc)[RA][CB], const float* U, int ldu,
                                          const float* V, int ldv) {
  const int ty = tid_y(), tx = tid_x();
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    float u[RA], v[CB];
#pragma unroll
    for (int i = 0; i < RA; ++i) u[i] = U[r * ldu + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < CB; ++j) v[j] = V[r * ldv + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < CB; ++j) acc[i][j] = fmaf(u[i], v[j], acc[i][j]);
  }
}

// cs[0..Q) <- its inclusive prefix sums, accumulated in float64 and
// rounded once to float32 (torch.cumsum of the float64 values, then
// .float(), in the plain version).  Warp 0 works; the block then syncs.
__device__ __forceinline__ void chunk_cumsum(float* cs, int Q) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, per = (Q + 31) / 32;
    const int lo = min(Q, lane * per), hi = min(Q, lo + per);
    double run = 0.0;
    for (int i = lo; i < hi; ++i) run += (double)cs[i];
    double incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    double acc = incl - run;
    for (int i = lo; i < hi; ++i) {
      acc += (double)cs[i];
      cs[i] = (float)acc;
    }
  }
  __syncthreads();
}

// v[0..Q) <- its reverse inclusive sums (v_t = sum_{u >= t} v_u), in
// float64, rounded once.  Warp 0 works; the block then syncs.
__device__ __forceinline__ void chunk_revsum(float* v, int Q) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, per = (Q + 31) / 32;
    const int lo = min(Q, lane * per), hi = min(Q, lo + per);
    double run = 0.0;
    for (int i = lo; i < hi; ++i) run += (double)v[i];
    double incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += u;
    }
    double acc = incl - run;
    for (int i = hi - 1; i >= lo; --i) {
      acc += (double)v[i];
      v[i] = (float)acc;
    }
  }
  __syncthreads();
}

// Sum of one float per thread over the block, deterministic; every thread
// gets the result.  red holds NT / 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

}  // namespace ssd

// dtype code 0 = float32, 1 = bfloat16 for x, b, c; (P, N) = (64, 128) or
// (16, 16).
#define SSD_DISPATCH(DTYPE, P, N, FN, ...)                                     \
  do {                                                                         \
    if ((P) == 64 && (N) == 128) {                                             \
      if ((DTYPE) == 0) return FN<float, 64, 128>(__VA_ARGS__);                \
      if ((DTYPE) == 1) return FN<__nv_bfloat16, 64, 128>(__VA_ARGS__);        \
    } else if ((P) == 16 && (N) == 16) {                                       \
      if ((DTYPE) == 0) return FN<float, 16, 16>(__VA_ARGS__);                 \
      if ((DTYPE) == 1) return FN<__nv_bfloat16, 16, 16>(__VA_ARGS__);         \
    }                                                                          \
    return (int)cudaErrorInvalidValue;                                         \
  } while (0)
