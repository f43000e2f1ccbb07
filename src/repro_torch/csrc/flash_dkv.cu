// FlashAttention-2 backward, dK and dV per kv head: for every q head of
// the head's GQA group and every visible q tile, recompute P and dS and
// accumulate dV += P^T dO and dK += dS^T Q.
//
// Replaces repro/kernels/flash_attention_bwd.py::_dkv_kernel.  The TPU
// grid (B, K, nk, G, nq) kept dk/dv in VMEM scratch across its two
// innermost sequential axes (g, iq); here one block owns one
// (kv tile, b * kv head) pair and those two axes are its loops, over the
// visible q tiles only.  dK and dV stay in f32 registers and are written
// once, so there are no atomics and the result is deterministic.
//
// Bound: four S x S x D products (139 us of tensor-core time at the
// main-path shape).  This first kernel runs them as f32 FMAs out of
// shared memory (K, V, Q, dO tiles plus the P and dS tiles), far from
// that bound; tensor-core products are the next step.
//
// Head dim 256 (bf16): the K, V, Q, dO tiles stay bf16 in shared memory
// (flash_common.cuh), 165,888 bytes in all against 296,960 as f32.  The
// dK and dV columns are split in two halves of 128 over a third grid
// axis: each block recomputes the full-D scores and dP (two of its three
// products) but keeps only 2 x 4 x 8 accumulators per thread, where the
// whole row would be 2 x 4 x 16 = 128 f32 registers before any operand.
// Every output element still has one owner.  The split also doubles the
// grid, which MQA leaves small: at recurrentgemma-2b's shape (B 2, S 2048,
// H 10, K 1) it is 32 x 2 x 2 = 128 blocks on 132 SMs instead of 64, each
// looping over the 10 q heads of its kv head.  The causal triangle makes
// the blocks unequal: the first kv tile sees all 32 q tiles, the last one.
// The products take 85.9 GFLOP without the split (0.0869 ms at
// 989 TFLOP/s); the split adds half of that again in recomputed scores.
// nvcc -Xptxas -v (CUDA 12.8): 158 registers, no spill at D 256; 127-128
// registers at D 128.
#include "flash_common.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
           int G, int Sq, int Sk, long long qsb, long long qsh, long long qss, long long ksb,
           long long ksh, long long kss, long long vsb, long long vsh, long long vss,
           long long dsb, long long dsh, long long dss, long long gksb, long long gksh,
           long long gkss, long long gvsb, long long gvsh, long long gvss, int causal,
           int window, float scale) {
  using ST = typename Smem<T, D>::type;
  constexpr int DH = D > 128 ? 128 : D;   // dK/dV columns per block
  constexpr int NJ = DH / 16, LD = Smem<T, D>::LD;
  extern __shared__ float smem[];
  ST* Ks = reinterpret_cast<ST*>(smem);   // BK x LD
  ST* Vs = Ks + BK * LD;                  // BK x LD
  ST* Qs = Vs + BK * LD;                  // BQ x LD
  ST* dOs = Qs + BQ * LD;                 // BQ x LD
  float* Ps = reinterpret_cast<float*>(dOs + BQ * LD);  // BQ x (BK + 1)
  float* dSs = Ps + BQ * (BK + 1);    // BQ x (BK + 1)
  float* lse_s = dSs + BQ * (BK + 1); // BQ
  float* delta_s = lse_s + BQ;        // BQ

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int K = H / G;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / K, kh = blockIdx.y % K;
  const int c0 = blockIdx.z * DH;         // this block's first dK/dV column
  load_tile<T, ST, BK, D, LD>(Ks, k + b * ksb + kh * ksh, kss, k0, Sk);
  load_tile<T, ST, BK, D, LD>(Vs, v + b * vsb + kh * vsh, vss, k0, Sk);

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NJ; ++n) dk_acc[i][n] = dv_acc[i][n] = 0.f;

  int lo, hi;
  q_tile_range(k0, min(k0 + BK, Sk) - 1, Sq, causal, window, &lo, &hi);
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const long long row0 = ((long long)b * H + h) * Sq;
    for (int it = lo; it < hi; ++it) {
      const int q0 = it * BQ;
      __syncthreads();
      load_tile<T, ST, BQ, D, LD>(Qs, q + b * qsb + h * qsh, qss, q0, Sq);
      load_tile<T, ST, BQ, D, LD>(dOs, dout + b * dsb + h * dsh, dss, q0, Sq);
      if (tid < BQ) {
        const int qpos = q0 + tid;
        lse_s[tid] = qpos < Sq ? lse[row0 + qpos] : 0.f;
        delta_s[tid] = qpos < Sq ? delta[row0 + qpos] : 0.f;
      }
      __syncthreads();

      // score tile: q rows ty + 16 i, kv rows tx + 16 j
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
          const int c = tx + 16 * j;
          const bool vis = pair_visible(q0 + r, k0 + c, Sq, Sk, causal, window);
          const float p = vis ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          Ps[r * (BK + 1) + c] = p;
          dSs[r * (BK + 1) + c] = p * (dp[i][j] - delta_s[r]) * scale;
        }
      }
      __syncthreads();

      // accumulators: kv rows ty + 16 i, columns c0 + tx + 16 n
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pr[4], dsr[4], dov[NJ], qv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = Ps[r * (BK + 1) + ty + 16 * i];
          dsr[i] = dSs[r * (BK + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int n = 0; n < NJ; ++n) {
          dov[n] = to_f32(dOs[r * LD + c0 + tx + 16 * n]);
          qv[n] = to_f32(Qs[r * LD + c0 + tx + 16 * n]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int n = 0; n < NJ; ++n) {
            dv_acc[i][n] = fmaf(pr[i], dov[n], dv_acc[i][n]);
            dk_acc[i][n] = fmaf(dsr[i], qv[n], dk_acc[i][n]);
          }
      }
    }
  }

  T* dkb = dk + b * gksb + kh * gksh;
  T* dvb = dv + b * gvsb + kh * gvsh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= Sk) continue;
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
      dkb[kpos * gkss + c0 + tx + 16 * n] = from_f32<T>(dk_acc[i][n]);
      dvb[kpos * gvss + c0 + tx + 16 * n] = from_f32<T>(dv_acc[i][n]);
    }
  }
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int H, int K, int Sq, int Sk,
               long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
               long long kss, long long vsb, long long vsh, long long vss, long long dsb,
               long long dsh, long long dss, long long gksb, long long gksh, long long gkss,
               long long gvsb, long long gvsh, long long gvss, int causal, int window,
               float scale, cudaStream_t stream) {
  using ST = typename Smem<T, D>::type;
  const size_t smem = sizeof(ST) * (2 * BK + 2 * BQ) * Smem<T, D>::LD +
                      sizeof(float) * (2 * BQ * (BK + 1) + 2 * BQ);
  const void* kern = (const void*)dkv_kernel<T, D>;
  int err = set_smem(kern, smem);
  if (err) return err;
  dim3 grid((Sk + BK - 1) / BK, B * K, D > 128 ? D / 128 : 1);
  dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, H, H / K, Sq, Sk, qsb, qsh, qss, ksb, ksh, kss, vsb,
      vsh, vss, dsb, dsh, dss, gksb, gksh, gkss, gvsb, gvsh, gvss, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash

// q, dout: (B, H, Sq, D); k, v, dk, dv: (B, K, Sk, D); lse, delta: (B, H, Sq) f32.
extern "C" int flash_dkv(int dtype, int D, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta, void* dk,
                         void* dv, int B, int H, int K, int Sq, int Sk, long long qsb,
                         long long qsh, long long qss, long long ksb, long long ksh,
                         long long kss, long long vsb, long long vsh, long long vss,
                         long long dsb, long long dsh, long long dss, long long gksb,
                         long long gksh, long long gkss, long long gvsb, long long gvsh,
                         long long gvss, int causal, int window, float scale, void* stream) {
  if (B * K > 65535 || H % K != 0) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(dtype, D, flash::launch_dkv, q, k, v, dout, lse, delta, dk, dv, B, H, K, Sq,
                 Sk, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, dsb, dsh, dss, gksb, gksh,
                 gkss, gvsb, gvsh, gvss, causal, window, scale, (cudaStream_t)stream);
}
