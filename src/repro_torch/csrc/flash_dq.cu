// FlashAttention-2 backward, dQ: recompute P = exp(S - lse) tile by tile,
// dS = P (dP - delta) * scale with dP = dO V^T, and dQ = sum over kv tiles
// of dS K.
//
// Replaces repro/kernels/flash_attention_bwd.py::_dq_kernel.  The TPU
// grid (B, H, nq, nk) carried dq in VMEM scratch across its sequential kv
// axis; here one block owns one (q tile, b * h) pair, loops over the
// visible kv tiles (the forward's bounds), keeps dQ in f32 registers and
// writes it once.  No atomics: every dQ row has one owner, and two calls
// on the same inputs give equal bits.
//
// Bound: three S x S x D products, the bf16 tensor-core rate: 0.104 ms at
// yi-6b's shape (B 2, S 2048, H 32, K 4, D 128, causal) and 0.065 ms at
// recurrentgemma-2b's (B 2, S 2048, H 10, K 1, D 256, window 2048).
//
// bf16 (dq_wgmma_kernel, every head_dim of the dispatch): the three
// products on the tensor cores with wgmma (m64nNk16, bf16 in, f32
// accumulate), from the tiles and fragments of wgmma.cuh.  S = Q K^T and
// dP = dO V^T read Q, dO, K and V K-major from shared memory; P and dS
// are computed on the accumulator fragments; dQ += dS K takes dS from
// registers (peel_frags) against K read MN-major from the same swizzled
// bytes.  The Pallas kernel keeps dS f32 for that product, so dS goes in
// as a bf16 high part plus the bf16 of its remainder, two products into
// one accumulator (as flash_dkv.cu does: one bf16 rounding of dS puts
// the gradients outside the bf16 tolerance).  The K and V tiles of the
// next kv tile arrive by cp.async into a two-stage ring while the current
// one is in the tensor cores.  Blocks start from the last q tile, which
// causality makes the heaviest.
//   D <= 128: one warpgroup a block owns 64 q rows and runs all four
// products (dQ D / 2 registers a thread); 99,328 bytes of shared memory,
// two blocks an SM.  Two warpgroups sharing the K/V tiles of a 128-row
// block, as the forward does, were slower on the card (PERF.md): the
// shared tile's barriers make the two wait for each other, where two
// blocks overlap one's exp with the other's products.
//   D 256: the dQ accumulator (64 x 256 f32, 128 registers a thread) does
// not fit beside S and dP.  Two warpgroups share one 64-row q tile: one
// computes S, the other dP (each over all 256 columns), they swap P and
// dP through 32 KB of shared memory, and each then owns 128 columns of dQ
// (dkv's D 256 scheme); 230,400 bytes, one block an SM.
// nvcc -Xptxas -v (CUDA 12.8): 242 registers at D 256, 231 at D 128, no
// spill.
//
// f32 (dq_kernel, up to D 128): the FMA loops out of shared memory, one
// block per (q tile, b * h), which hold the f32 paths' 1e-4 tolerance that
// TF32 products would not.
#include "flash_common.cuh"
#include "wgmma.cuh"

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

template <int D>
struct DqTC {
  static constexpr int DP = D < 64 ? 64 : D;   // tile width: one swizzle row at least
  static constexpr bool SPLIT = D > 128;       // two warpgroups share one 64-row q tile
  static constexpr int BM = 64;                // q rows a block
  static constexpr int NT = SPLIT ? 256 : 128;
  static constexpr int NC = SPLIT ? DP / 2 : DP;   // dQ columns a warpgroup owns
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;
  static constexpr int XCH = SPLIT ? 2 * 32 * 128 * 4 : 0;   // P / dP swap
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 4 * KV_BYTES + XCH;
};

template <int D>
__global__ void __launch_bounds__(DqTC<D>::NT, DqTC<D>::SPLIT ? 1 : 2)
dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, int H, int G, int Sq, int Sk, long long qsb,
                long long qsh, long long qss, long long ksb, long long ksh, long long kss,
                long long vsb, long long vsh, long long vss, long long dsb, long long dsh,
                long long dss, long long gsb, long long gsh, long long gss, int causal,
                int window, float scale) {
  using C = DqTC<D>;
  constexpr int DP = C::DP, NC = C::NC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Qs = (wg::smem_u32(smem_raw) + 1023) & ~1023u, dOs = Qs + C::Q_BYTES;
  const uint32_t KV0 = dOs + C::Q_BYTES;   // stage s: K at KV0 + 2 s KV_BYTES, V after it
  float* xch = reinterpret_cast<float*>(smem_raw + (KV0 + 4 * C::KV_BYTES -
                                                    wg::smem_u32(smem_raw)));   // [2][32][128]

  const int tid = threadIdx.x, w = tid / 128, t = tid % 128, lane = tid % 32;
  const int row_a = 16 * (t / 32) + lane / 4;   // fragment rows row_a, row_a + 8
  const int col_a = 2 * (lane % 4);             // fragment columns 8 j + col_a + {0, 1}
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BM;   // the heaviest q tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / G;
  const bf16* kb = k + b * ksb + kh * ksh;
  const bf16* vb = v + b * vsb + kh * vsh;

  int lo, hi;
  kv_tile_range(q0, min(q0 + C::BM, Sq) - 1, Sk, causal, window, &lo, &hi);
  wg::load_tile<C::BM, D, DP, C::NT>(Qs, q + b * qsb + h * qsh, qss, q0, Sq, tid);
  wg::load_tile<C::BM, D, DP, C::NT>(dOs, dout + b * dsb + h * dsh, dss, q0, Sq, tid);
  if (lo < hi) {
    wg::load_tile<BK, D, DP, C::NT>(KV0, kb, kss, lo * BK, Sk, tid);
    wg::load_tile<BK, D, DP, C::NT>(KV0 + C::KV_BYTES, vb, vss, lo * BK, Sk, tid);
  }
  wg::cp_async_commit();

  // lse (in log2 units) and delta of this thread's two fragment rows
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + row_a + 8 * r;
    const long long row = ((long long)b * H + h) * Sq + qpos;
    lse2[r] = qpos < Sq ? lse[row] * LOG2E : 0.f;
    dlt[r] = qpos < Sq ? delta[row] : 0.f;
  }
  const float sl2 = scale * LOG2E;
  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;

  for (int jt = lo; jt < hi; ++jt) {
    const int k0 = jt * BK, stage = (jt - lo) & 1;
    const uint32_t Ks = KV0 + stage * 2 * C::KV_BYTES, Vs = Ks + C::KV_BYTES;
    __syncthreads();   // every warpgroup is done with the stage the next tile goes to
    if (jt + 1 < hi) {
      const uint32_t Kn = KV0 + (stage ^ 1) * 2 * C::KV_BYTES;
      wg::load_tile<BK, D, DP, C::NT>(Kn, kb, kss, k0 + BK, Sk, tid);
      wg::load_tile<BK, D, DP, C::NT>(Kn + C::KV_BYTES, vb, vss, k0 + BK, Sk, tid);
      wg::cp_async_commit();
      wg::cp_async_wait<1>();
    } else {
      wg::cp_async_wait<0>();
    }
    wg::fence_async_smem();
    __syncthreads();

    // p = S, dp = dP (q rows x kv columns)
    float p[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = dp[i] = 0.f;
    if constexpr (!C::SPLIT) {
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wg::mma_ss_n64(p, wg::desc_k<C::BM>(Qs, kk), wg::desc_k<BK>(Ks, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wg::mma_ss_n64(dp, wg::desc_k<C::BM>(dOs, kk), wg::desc_k<BK>(Vs, kk), kk > 0);
      wg::mma_commit();
      wg::mma_wait<0>();
      wg::hold(p);
      wg::hold(dp);
    } else {   // warpgroup 0 computes S into p, warpgroup 1 dP into dp
      float x[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = 0.f;
      const uint32_t A = w == 0 ? Qs : dOs, Bm = w == 0 ? Ks : Vs;
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wg::mma_ss_n64(x, wg::desc_k<C::BM>(A, kk), wg::desc_k<BK>(Bm, kk), kk > 0);
      wg::mma_commit();
      wg::mma_wait<0>();
      wg::hold(x);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        p[i] = w == 0 ? x[i] : 0.f;
        dp[i] = w == 0 ? 0.f : x[i];
      }
    }

    const bool full = (!causal || k0 + BK - 1 <= q0) &&
                      (window <= 0 || k0 > q0 + 63 - window) && k0 + BK <= Sk;
    if (!C::SPLIT || w == 0) {   // P = exp(S scale - lse), masked
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = row_a + 8 * ((i % 4) / 2), c = 8 * (i / 4) + col_a + i % 2;
        const float e = exp2f(fmaf(p[i], sl2, -lse2[(i % 4) / 2]));
        p[i] = (full || pair_visible(q0 + r, k0 + c, Sq, Sk, causal, window)) ? e : 0.f;
      }
    }
    if constexpr (C::SPLIT) {   // swap: warpgroup 0 gets dP, warpgroup 1 gets P
#pragma unroll
      for (int i = 0; i < 32; ++i) xch[(w * 32 + i) * 128 + t] = w == 0 ? p[i] : dp[i];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float other = xch[((1 - w) * 32 + i) * 128 + t];
        if (w == 0) dp[i] = other; else p[i] = other;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)   // dS = P (dP - delta) scale, into dp
      dp[i] = p[i] * (dp[i] - dlt[(i % 4) / 2]) * scale;

    uint32_t sh[4][4], sl[4][4];   // dS = bf16 high part + bf16 remainder
    wg::peel_frags<4>(dp, sh);
    wg::peel_frags<4>(dp, sl);
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dk = wg::desc_mn<BK>(Ks, kk, w * NC / 64 * C::SPLIT);
      wg::mma_rs_t<NC>(acc, sh[kk], dk);
      wg::mma_rs_t<NC>(acc, sl[kk], dk);
    }
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::hold(acc);
    wg::hold(sh);
    wg::hold(sl);
  }
  wg::cp_async_wait<0>();

  // dQ rows q0 + row_a (+ 8), columns cw + 8 j + col_a (+ 1)
  bf16* gb = dq + b * gsb + h * gsh;
  const int cw = C::SPLIT ? w * NC : 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + row_a + 8 * r;
    if (qpos >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const int c = cw + 8 * j + col_a, i = 4 * j + 2 * r;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(gb + qpos * gss + c) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq, int B, int H, int K, int Sq,
                    int Sk, long long qsb, long long qsh, long long qss, long long ksb,
                    long long ksh, long long kss, long long vsb, long long vsh, long long vss,
                    long long dsb, long long dsh, long long dss, long long gsb, long long gsh,
                    long long gss, int causal, int window, float scale, cudaStream_t stream) {
  using C = DqTC<D>;
  int err = set_smem((const void*)dq_wgmma_kernel<D>, C::SMEM);
  if (err) return err;
  dim3 grid((Sq + C::BM - 1) / C::BM, B * H);
  dq_wgmma_kernel<D><<<grid, C::NT, C::SMEM, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (bf16*)dq, H, H / K, Sq, Sk, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh,
      vss, dsb, dsh, dss, gsb, gsh, gss, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash

// q, dout, dq: (B, H, Sq, D); k, v: (B, K, Sk, D); lse, delta: (B, H, Sq) f32.
// bf16 takes the tensor-core kernel (16-byte aligned operands, row strides
// a multiple of 8), f32 the FMA kernel.
extern "C" int flash_dq(int dtype, int D, const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta, void* dq, int B,
                        int H, int K, int Sq, int Sk, long long qsb, long long qsh,
                        long long qss, long long ksb, long long ksh, long long kss,
                        long long vsb, long long vsh, long long vss, long long dsb,
                        long long dsh, long long dss, long long gsb, long long gsh,
                        long long gss, int causal, int window, float scale, void* stream) {
  if (B * H > 65535 || H % K != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    FLASH_DISPATCH_BF16(D, flash::launch_dq_wgmma, q, k, v, dout, lse, delta, dq, B, H, K, Sq,
                        Sk, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, dsb, dsh, dss, gsb,
                        gsh, gss, causal, window, scale, (cudaStream_t)stream);
  if (dtype == 0)
    FLASH_DISPATCH_F32(D, flash::launch_dq, q, k, v, dout, lse, delta, dq, B, H, K, Sq, Sk,
                       qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, dsb, dsh, dss, gsb, gsh,
                       gss, causal, window, scale, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
