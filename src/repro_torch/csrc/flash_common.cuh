// Shared pieces of the flash-attention kernels for Hopper (sm_90a).
//
// Layout: every tensor is (B, heads, S, D) addressed through its batch,
// head and sequence strides with a unit stride on D, so the public
// (B, S, H, D) tensors are passed as transposed views without a copy.
// lse and delta are contiguous (B, H, Sq) float32.
//
// Tiling: a block of NT = 256 threads owns a 64-row tile.  Thread t has
// ty = t / 16 and tx = t % 16; in a 64 x 64 score tile it holds rows
// ty + 16 i and columns tx + 16 j (i, j < 4), and in a 64 x D accumulator
// rows ty + 16 i and columns tx + 16 n (n < D / 16).  The 16 threads that
// share a row are the 16 lanes of one half-warp, so a row reduction is
// four xor shuffles.  Shared-memory rows are padded to D + 1 and BK + 1
// floats so that the 16 lanes reading 16 different rows at one column hit
// 16 different banks.
//
// These FMA kernels serve the f32 instantiations (head_dim up to 128); the
// bf16 forward, dq and dkv run on the tensor cores (wgmma.cuh), and head
// dim 256 takes bf16 only.
#pragma once

#include "kernel_common.cuh"

namespace flash {

using common::from_f32;
using common::set_smem;
using common::to_f32;

constexpr int BQ = 64;      // q rows per tile
constexpr int BK = 64;      // kv rows per tile
constexpr int NT = 256;     // threads per block
constexpr float NEG_INF = -1e30f;   // the Pallas kernels' masked score
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
#define MINUS_INF __int_as_float((int)0xff800000)   // -inf, a masked score inside a tile

using bf16 = __nv_bfloat16;

// The shared-memory type of the FMA kernels' operand tiles and their
// padded row length: f32 rows of D + 1.
template <typename T, int D>
struct Smem {
  using type = float;
  static constexpr int LD = D + 1;
};

// Half-warp reductions over the 16 lanes that share a tile row.
__device__ __forceinline__ float row_max16(float v) {
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// pair_mask of repro/kernels/flash_attention.py, plus the ragged edge.
__device__ __forceinline__ bool pair_visible(int qpos, int kpos, int Sq, int Sk,
                                             int causal, int window) {
  return qpos < Sq && kpos < Sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// tile_visible of repro/kernels/flash_attention.py turned into loop
// bounds: the kv tiles [lo, hi) that hold a key visible to some q row in
// [q_first, q_last].  Causal: a key is at most q_last.  Window: a key is
// above q_first - window.
__device__ __forceinline__ void kv_tile_range(int q_first, int q_last, int Sk, int causal,
                                              int window, int* lo, int* hi) {
  const int nk = (Sk + BK - 1) / BK;
  *hi = causal ? min(nk, q_last / BK + 1) : nk;
  *lo = window > 0 ? max(0, q_first - window + 1) / BK : 0;
}

// The q tiles [lo, hi) that hold a row seeing some key in [k_first, k_last].
__device__ __forceinline__ void q_tile_range(int k_first, int k_last, int Sq, int causal,
                                             int window, int* lo, int* hi) {
  const int nq = (Sq + BQ - 1) / BQ;
  *lo = causal ? min(nq, k_first / BQ) : 0;
  *hi = window > 0 ? min(nq, (k_last + window - 1) / BQ + 1) : nq;
}

// Rows [row0, row0 + ROWS) of a (S, D) slice into shared memory as S,
// rows padded to LD; rows at or past nrows read as zero.
template <typename T, typename S, int ROWS, int D, int LD>
__device__ __forceinline__ void load_tile(S* dst, const T* src, long long ss, int row0,
                                          int nrows) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += NT) {
    const int r = idx / D, d = idx % D, row = row0 + r;
    dst[r * LD + d] = from_f32<S>(row < nrows ? to_f32(src[(long long)row * ss + d]) : 0.f);
  }
}

}  // namespace flash

// The dispatch by head_dim for one dtype: FN<float, D> (f32 kernels, D up
// to 128) and FN<D> (bf16 tensor-core kernels, D up to 256).
#define FLASH_DISPATCH_F32(DIM, FN, ...)                                       \
  switch (DIM) {                                                               \
    case 16: return FN<float, 16>(__VA_ARGS__);                                \
    case 32: return FN<float, 32>(__VA_ARGS__);                                \
    case 64: return FN<float, 64>(__VA_ARGS__);                                \
    case 128: return FN<float, 128>(__VA_ARGS__);                              \
  }
#define FLASH_DISPATCH_BF16(DIM, FN, ...)                                      \
  switch (DIM) {                                                               \
    case 16: return FN<16>(__VA_ARGS__);                                       \
    case 32: return FN<32>(__VA_ARGS__);                                       \
    case 64: return FN<64>(__VA_ARGS__);                                       \
    case 128: return FN<128>(__VA_ARGS__);                                     \
    case 256: return FN<256>(__VA_ARGS__);                                     \
  }
