// Flash-attention forward for Hopper: causal or sliding-window GQA
// attention with an online softmax, optionally writing lse = m + log l.
//
// Replaces repro/kernels/flash_attention.py::_flash_fwd_kernel (launched
// by fwd_kernel_layout).  The TPU grid (B, H, nq, nk) ran its kv axis in
// order, carrying m, l and the accumulator in VMEM scratch; here one block
// owns one (q tile, b * h) pair and the kv axis is a loop inside it, over
// the visible kv tiles only (the bounds come from tile_visible; pair_mask
// applies inside a tile).  The kv head is h / G, as the TPU index map
// h // G: K and V are never replicated to H heads.
//
// Bound: at the main-path shape (B 2, S 2048, H 32, K 4, D 128, causal,
// bf16) the two products take 69 GFLOP against 76 MB of traffic, so the
// card's limit is its tensor-core rate.  This first kernel does its
// products as f32 FMAs from shared memory (a 4 x 4 register tile of
// scores and a 4 x D/16 accumulator per thread, one load per two FMAs),
// which caps it well below that; tensor-core products (mma.sync/wgmma
// with TMA-fed tiles) are the next step.
//
// Head dim 256 (recurrentgemma-2b, bf16, one kv head, window 2048): the
// same loops over bf16 operand tiles (flash_common.cuh), 115,712 bytes of
// shared memory, one block of 256 threads per SM.  At B 2, S 2048, H 10,
// causal the two products take 43.0 GFLOP (0.0434 ms at 989 TFLOP/s).
// nvcc -Xptxas -v (CUDA 12.8): 128 registers and 4 bytes of spill stores
// (an 8-byte stack frame) at D 256; no spill at D 128, 128 registers.
#include "flash_common.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, int H, int G, int Sq, int Sk,
           long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
           long long kss, long long vsb, long long vsh, long long vss, long long osb,
           long long osh, long long oss, int causal, int window, float scale) {
  using ST = typename Smem<T, D>::type;
  constexpr int NJ = D / 16, LD = Smem<T, D>::LD;
  extern __shared__ float smem[];
  ST* Qs = reinterpret_cast<ST*>(smem);            // BQ x LD
  ST* Ks = Qs + BQ * LD;                           // BK x LD
  ST* Vs = Ks + BK * LD;                           // BK x LD
  float* Ps = reinterpret_cast<float*>(Vs + BK * LD);   // BQ x (BK + 1)

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / G;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;

  load_tile<T, ST, BQ, D, LD>(Qs, qb, qss, q0, Sq);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NJ; ++n) acc[i][n] = 0.f;
  }

  int lo, hi;
  kv_tile_range(q0, min(q0 + BQ, Sq) - 1, Sk, causal, window, &lo, &hi);
  for (int jt = lo; jt < hi; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, ST, BK, D, LD>(Ks, kb, kss, k0, Sk);
    load_tile<T, ST, BK, D, LD>(Vs, vb, vss, k0, Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qr[4], kc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qr[i] = to_f32(Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kc[j] = to_f32(Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
      bool vis[4];
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vis[j] = pair_visible(qpos, k0 + tx + 16 * j, Sq, Sk, causal, window);
        s[i][j] = vis[j] ? s[i][j] * scale : NEG_INF;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(rmax));
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[r * (BK + 1) + tx + 16 * j] = p;
        rsum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum16(rsum);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NJ; ++n) acc[i][n] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pr[4], vc[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int n = 0; n < NJ; ++n) vc[n] = to_f32(Vs[c * LD + tx + 16 * n]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < NJ; ++n) acc[i][n] = fmaf(pr[i], vc[n], acc[i][n]);
    }
  }

  T* ob = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    const float ll = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NJ; ++n) ob[qpos * oss + tx + 16 * n] = from_f32<T>(acc[i][n] / ll);
    if (lse != nullptr && tx == 0) lse[((long long)b * H + h) * Sq + qpos] = m[i] + logf(ll);
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
               int K, int Sq, int Sk, long long qsb, long long qsh, long long qss,
               long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
               long long vss, long long osb, long long osh, long long oss, int causal,
               int window, float scale, cudaStream_t stream) {
  using ST = typename Smem<T, D>::type;
  const size_t smem = sizeof(ST) * (BQ + 2 * BK) * Smem<T, D>::LD +
                      sizeof(float) * BQ * (BK + 1);
  const void* kern = (const void*)fwd_kernel<T, D>;
  int err = set_smem(kern, smem);
  if (err) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, H, H / K, Sq, Sk, qsb, qsh,
      qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash

// q: (B, H, Sq, D); k, v: (B, K, Sk, D); o like q; lse (B, H, Sq) f32 or null.
extern "C" int flash_fwd(int dtype, int D, const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int H, int K, int Sq, int Sk,
                         long long qsb, long long qsh, long long qss, long long ksb,
                         long long ksh, long long kss, long long vsb, long long vsh,
                         long long vss, long long osb, long long osh, long long oss,
                         int causal, int window, float scale, void* stream) {
  if (B * H > 65535 || H % K != 0) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(dtype, D, flash::launch_fwd, q, k, v, o, lse, B, H, K, Sq, Sk, qsb, qsh,
                 qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, causal, window, scale,
                 (cudaStream_t)stream);
}
