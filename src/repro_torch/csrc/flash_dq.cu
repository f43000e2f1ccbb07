// FlashAttention-2 backward, dQ: recompute P = exp(S - lse) tile by tile,
// dS = P (dP - delta) * scale with dP = dO V^T, and dQ = sum over kv tiles
// of dS K.
//
// Replaces repro/kernels/flash_attention_bwd.py::_dq_kernel.  The TPU
// grid (B, H, nq, nk) carried dq in VMEM scratch across its sequential kv
// axis; here one block owns one (q tile, b * h) pair, loops over the
// visible kv tiles (the forward's bounds), keeps dQ in f32 registers and
// writes it once.  No atomics: every dQ row has one owner.
//
// Bound: three S x S x D products (104 us of tensor-core time at the
// main-path shape).  Like the forward, this first kernel runs them as f32
// FMAs out of shared memory (Q, dO, K, V tiles and the dS tile), which
// keeps it correct and simple and far from that bound.
//
// Head dim 256 (bf16): the Q, dO, K, V tiles stay bf16 in shared memory
// (flash_common.cuh), 148,736 bytes in all against 279,808 as f32.  At
// recurrentgemma-2b's shape (B 2, S 2048, H 10, K 1, causal) the grid is
// 32 x 20 blocks and the products take 64.5 GFLOP (0.0652 ms at
// 989 TFLOP/s).  nvcc -Xptxas -v (CUDA 12.8): 166 registers, no spill at
// D 256; 126 registers at D 128.
#include "flash_common.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int H, int G, int Sq, int Sk,
          long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
          long long kss, long long vsb, long long vsh, long long vss, long long dsb,
          long long dsh, long long dss, long long gsb, long long gsh, long long gss,
          int causal, int window, float scale) {
  using ST = typename Smem<T, D>::type;
  constexpr int NJ = D / 16, LD = Smem<T, D>::LD;
  extern __shared__ float smem[];
  ST* Qs = reinterpret_cast<ST*>(smem);            // BQ x LD
  ST* dOs = Qs + BQ * LD;                          // BQ x LD
  ST* Ks = dOs + BQ * LD;                          // BK x LD
  ST* Vs = Ks + BK * LD;                           // BK x LD
  float* dSs = reinterpret_cast<float*>(Vs + BK * LD);  // BQ x (BK + 1)

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / G;
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;
  load_tile<T, ST, BQ, D, LD>(Qs, q + b * qsb + h * qsh, qss, q0, Sq);
  load_tile<T, ST, BQ, D, LD>(dOs, dout + b * dsb + h * dsh, dss, q0, Sq);

  const long long row0 = ((long long)b * H + h) * Sq;
  float lse_r[4], delta_r[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    lse_r[i] = qpos < Sq ? lse[row0 + qpos] : 0.f;
    delta_r[i] = qpos < Sq ? delta[row0 + qpos] : 0.f;
#pragma unroll
    for (int n = 0; n < NJ; ++n) acc[i][n] = 0.f;
  }

  int lo, hi;
  kv_tile_range(q0, min(q0 + BQ, Sq) - 1, Sk, causal, window, &lo, &hi);
  for (int jt = lo; jt < hi; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();
    load_tile<T, ST, BK, D, LD>(Ks, kb, kss, k0, Sk);
    load_tile<T, ST, BK, D, LD>(Vs, vb, vss, k0, Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qr[4], dr[4], kc[4], vc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qr[i] = to_f32(Qs[(ty + 16 * i) * LD + d]);
        dr[i] = to_f32(dOs[(ty + 16 * i) * LD + d]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kc[j] = to_f32(Ks[(tx + 16 * j) * LD + d]);
        vc[j] = to_f32(Vs[(tx + 16 * j) * LD + d]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(dr[i], vc[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool vis = pair_visible(q0 + r, k0 + tx + 16 * j, Sq, Sk, causal, window);
        const float p = vis ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dSs[r * (BK + 1) + tx + 16 * j] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsr[4], kc[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsr[i] = dSs[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int n = 0; n < NJ; ++n) kc[n] = to_f32(Ks[c * LD + tx + 16 * n]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < NJ; ++n) acc[i][n] = fmaf(dsr[i], kc[n], acc[i][n]);
    }
  }

  T* gb = dq + b * gsb + h * gsh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
#pragma unroll
    for (int n = 0; n < NJ; ++n) gb[qpos * gss + tx + 16 * n] = from_f32<T>(acc[i][n]);
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int H, int K, int Sq, int Sk, long long qsb,
              long long qsh, long long qss, long long ksb, long long ksh, long long kss,
              long long vsb, long long vsh, long long vss, long long dsb, long long dsh,
              long long dss, long long gsb, long long gsh, long long gss, int causal,
              int window, float scale, cudaStream_t stream) {
  using ST = typename Smem<T, D>::type;
  const size_t smem = sizeof(ST) * (2 * BQ + 2 * BK) * Smem<T, D>::LD +
                      sizeof(float) * BQ * (BK + 1);
  const void* kern = (const void*)dq_kernel<T, D>;
  int err = set_smem(kern, smem);
  if (err) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dq, H, H / K, Sq, Sk, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh,
      vss, dsb, dsh, dss, gsb, gsh, gss, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash

// q, dout, dq: (B, H, Sq, D); k, v: (B, K, Sk, D); lse, delta: (B, H, Sq) f32.
extern "C" int flash_dq(int dtype, int D, const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta, void* dq, int B,
                        int H, int K, int Sq, int Sk, long long qsb, long long qsh,
                        long long qss, long long ksb, long long ksh, long long kss,
                        long long vsb, long long vsh, long long vss, long long dsb,
                        long long dsh, long long dss, long long gsb, long long gsh,
                        long long gss, int causal, int window, float scale, void* stream) {
  if (B * H > 65535 || H % K != 0) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(dtype, D, flash::launch_dq, q, k, v, dout, lse, delta, dq, B, H, K, Sq, Sk,
                 qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, dsb, dsh, dss, gsb, gsh, gss,
                 causal, window, scale, (cudaStream_t)stream);
}
