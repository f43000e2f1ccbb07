// FlashAttention-2 backward, dK and dV per kv head: for every q head of
// the head's GQA group and every visible q tile, recompute P and dS and
// accumulate dV += P^T dO and dK += dS^T Q.
//
// Replaces repro/kernels/flash_attention_bwd.py::_dkv_kernel.  The TPU
// grid (B, K, nk, G, nq) kept dk/dv in VMEM scratch across its two
// innermost sequential axes (g, iq); here a block owns kv tiles of one
// (b, kv head) and those two axes are its loops, over the visible q tiles
// only.  dK and dV stay in f32 registers; each element has one owner, no
// float atomics, and two calls on the same inputs give equal bits.
//
// Bound: four S x S x D products, 85.9 GFLOP at recurrentgemma-2b's shape
// (B 2, S 2048, H 10, K 1, D 256, causal; 0.0869 ms at 989 TFLOP/s) and
// 0.139 ms of tensor-core time at yi-6b's: the bf16 tensor-core rate.
//
// bf16 (dkv_wgmma_kernel, every head_dim of the dispatch): the products
// on the tensor cores with wgmma.  The scores come out transposed,
// S^T = K Q^T and dP^T = V dO^T (64 kv rows x 64 q columns, operands from
// shared memory), so P^T and dS^T are already the A operands of
// dV += P^T dO and dK += dS^T Q and go to them from registers, against
// Q and dO read MN-major from the same swizzled tiles (wgmma.cuh).  The
// Pallas kernel keeps P and dS f32 for those products; one bf16 rounding
// of them puts dK and dV outside the bf16 tolerance (PERF.md), so each is
// split into a bf16 high part and the bf16 of its remainder, two products
// into one accumulator: six products a q tile instead of four.  The Q, dO,
// lse and delta of the next q tile arrive by cp.async into a two-stage
// ring while the current one is in the tensor cores.
//   D <= 128: one warpgroup a block owns the 64 kv rows and all D columns
// (dK and dV 2 x D / 2 registers a thread) and runs all six products.
//   D 256: dK and dV (2 x 64 x 256 f32) do not fit one warpgroup's
// registers.  Two warpgroups share the kv tile: one computes S^T, the
// other dP^T (each over all 256 columns), they swap them through 32 KB of
// shared memory (P^T f32 one way, dP^T the other), and each then owns 128
// columns of dK and dV.  Nothing is computed twice (the FMA kernel's
// column split recomputed the scores in each half, 1.5x the products).
//   Balance.  Causality gives kv tile j nq - j q tiles to walk.  A block
// takes tile j and then tile nk - 1 - j, so every block walks nk + 1.
// Under MQA that leaves few blocks (recurrentgemma-2b: 16 pairs x 2), so
// the G q heads of a group may also be split over `splits` blocks
// (flash_attention_bwd.dkv_head_splits picks the count); each split then
// writes f32 partial sums to scratch and dkv_reduce_kernel adds them in
// split order into the bf16 dK and dV, in the same call.  Pairing needs
// no scratch, the head split does, and pairing alone leaves
// recurrentgemma's grid at 32 blocks on 132 SMs; so the kernel takes both.
// chip_smoke.py times every split on an H100 80GB HBM3 (700 W):
// recurrentgemma-2b 1.30 / 0.65 / 0.58 / 0.49 ms at 1 / 2 / 5 / 10
// splits, yi-6b 0.57 / 0.45 / 0.48 / 0.54 ms at 1 / 2 / 4 / 8; the
// planner takes 10 and 2.  The scratch is 8.4 MB a split at
// recurrentgemma's shape and 16.8 MB at yi-6b's.
// Shared memory: K, V and two stages of Q and dO tiles (64 x DP each),
// lse and delta, plus the exchange at D 256: 100,352 bytes at D 128 (two
// blocks an SM) and 231,424 at D 256 (1 KB of alignment slack in each).
// nvcc -Xptxas -v (CUDA 12.8): 255 registers with 52 bytes of spill
// stores at D 128 and 255 with 36 at D 256 (dK and dV are 128 of them),
// 217-220 and no spill below; the reduction 34.
//
// f32 (dkv_kernel, up to D 128): the FMA loops out of shared memory, one
// block per (kv tile, b * kv head), which hold the f32 paths' 1e-4
// tolerance.
#include "flash_common.cuh"
#include "wgmma.cuh"

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
  constexpr int NJ = D / 16, LD = Smem<T, D>::LD;
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

      // accumulators: kv rows ty + 16 i, columns tx + 16 n
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
          dov[n] = to_f32(dOs[r * LD + tx + 16 * n]);
          qv[n] = to_f32(Qs[r * LD + tx + 16 * n]);
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
      dkb[kpos * gkss + tx + 16 * n] = from_f32<T>(dk_acc[i][n]);
      dvb[kpos * gvss + tx + 16 * n] = from_f32<T>(dv_acc[i][n]);
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
  dim3 grid((Sk + BK - 1) / BK, B * K);
  dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, H, H / K, Sq, Sk, qsb, qsh, qss, ksb, ksh, kss, vsb,
      vsh, vss, dsb, dsh, dss, gksb, gksh, gkss, gvsb, gvsh, gvss, causal, window, scale);
  return (int)cudaGetLastError();
}


template <int D>
struct DkvTC {
  static constexpr int DP = D < 64 ? 64 : D;   // tile width: one swizzle row at least
  static constexpr int NWG = D > 128 ? 2 : 1;  // warpgroups sharing the kv tile
  static constexpr int NT = 128 * NWG;
  static constexpr int NC = DP / NWG;          // dK/dV columns a warpgroup owns
  static constexpr int TILE = 64 * DP * 2;     // one 64-row bf16 tile
  static constexpr int XCH = NWG > 1 ? 2 * 32 * 128 * 4 : 0;   // S^T / dP^T swap
  static constexpr int SMEM = 1024 + 6 * TILE + XCH + 2 * 2 * 64 * 4;
};

template <int D>
__global__ void __launch_bounds__(DkvTC<D>::NT, DkvTC<D>::NWG == 1 ? 2 : 1)
dkv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
                 int B, int H, int G, int Sq, int Sk, long long qsb, long long qsh,
                 long long qss, long long ksb, long long ksh, long long kss, long long vsb,
                 long long vsh, long long vss, long long dsb, long long dsh, long long dss,
                 long long gksb, long long gksh, long long gkss, long long gvsb,
                 long long gvsh, long long gvss, int causal, int window, float scale) {
  using C = DkvTC<D>;
  constexpr int DP = C::DP, NC = C::NC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Ks = (wg::smem_u32(smem_raw) + 1023) & ~1023u, Vs = Ks + C::TILE;
  // stage s: Q at Ks + (2 + 2 s) TILE, dO after it
  uint8_t* base = smem_raw + (Ks - wg::smem_u32(smem_raw));
  float* xch = reinterpret_cast<float*>(base + 6 * C::TILE);       // [2][32][128]
  float* rows = reinterpret_cast<float*>(base + 6 * C::TILE + C::XCH);   // [stage][lse, delta][64]

  const int tid = threadIdx.x, w = tid / 128, t = tid % 128, lane = tid % 32;
  const int row_a = 16 * (t / 32) + lane / 4;   // fragment rows (kv) row_a, row_a + 8
  const int col_a = 2 * (lane % 4);             // fragment columns 8 j + col_a + {0, 1}
  const int K = H / G, splits = gridDim.z, GS = G / splits;
  const int b = blockIdx.y / K, kh = blockIdx.y % K, g0 = blockIdx.z * GS;
  const int nk = (Sk + BK - 1) / BK;
  const float sl2 = scale * LOG2E;

  for (int half = 0; half < 2; ++half) {
    const int jt = half == 0 ? blockIdx.x : nk - 1 - blockIdx.x;
    if (half == 1 && jt == (int)blockIdx.x) break;   // the middle tile of an odd count
    const int k0 = jt * BK;
    int lo, hi;
    q_tile_range(k0, min(k0 + BK, Sk) - 1, Sq, causal, window, &lo, &hi);
    const int nq = max(hi - lo, 0), steps = GS * nq;

    float dk_acc[NC / 2], dv_acc[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    // step s: q head kh G + g0 + s / nq, q tile lo + s % nq, into stage st
    auto load_step = [&](int s, int st) {
      const int h = kh * G + g0 + s / nq, q0 = (lo + s % nq) * BQ;
      const uint32_t Qn = Ks + (2 + 2 * st) * C::TILE;
      wg::load_tile<BQ, D, DP, C::NT>(Qn, q + b * qsb + h * qsh, qss, q0, Sq, tid);
      wg::load_tile<BQ, D, DP, C::NT>(Qn + C::TILE, dout + b * dsb + h * dsh, dss, q0, Sq, tid);
      if (tid < BQ) {
        const long long row = ((long long)b * H + h) * Sq + q0 + tid;
        const bool ok = q0 + tid < Sq;
        const uint32_t dst = wg::smem_u32(rows + st * 2 * BQ + tid);
        wg::cp_async4(dst, ok ? lse + row : lse, ok ? 4 : 0);
        wg::cp_async4(dst + BQ * 4, ok ? delta + row : delta, ok ? 4 : 0);
      }
    };

    if (steps > 0) {
      __syncthreads();   // the first tile's readers are done with K, V and the stages
      wg::load_tile<BK, D, DP, C::NT>(Ks, k + b * ksb + kh * ksh, kss, k0, Sk, tid);
      wg::load_tile<BK, D, DP, C::NT>(Vs, v + b * vsb + kh * vsh, vss, k0, Sk, tid);
      load_step(0, 0);
      wg::cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      const int st = s & 1, q0 = (lo + s % nq) * BQ;
      const uint32_t Qs = Ks + (2 + 2 * st) * C::TILE, dOs = Qs + C::TILE;
      __syncthreads();   // every warpgroup is done with the stage step s + 1 goes to
      if (s + 1 < steps) {
        load_step(s + 1, st ^ 1);
        wg::cp_async_commit();
        wg::cp_async_wait<1>();
      } else {
        wg::cp_async_wait<0>();
      }
      wg::fence_async_smem();
      __syncthreads();

      // p = S^T, dp = dP^T (kv rows x q columns)
      float p[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = dp[i] = 0.f;
      if constexpr (C::NWG == 1) {
        wg::mma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wg::mma_ss_n64(p, wg::desc_k<BK>(Ks, kk), wg::desc_k<BQ>(Qs, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wg::mma_ss_n64(dp, wg::desc_k<BK>(Vs, kk), wg::desc_k<BQ>(dOs, kk), kk > 0);
        wg::mma_commit();
        wg::mma_wait<0>();
        wg::hold(p);
        wg::hold(dp);
      } else {   // warpgroup 0 computes S^T into p, warpgroup 1 dP^T into dp
        float x[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) x[i] = 0.f;
        const uint32_t A = w == 0 ? Ks : Vs, Bm = w == 0 ? Qs : dOs;
        wg::mma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wg::mma_ss_n64(x, wg::desc_k<BK>(A, kk), wg::desc_k<BQ>(Bm, kk), kk > 0);
        wg::mma_commit();
        wg::mma_wait<0>();
        wg::hold(x);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          p[i] = w == 0 ? x[i] : 0.f;
          dp[i] = w == 0 ? 0.f : x[i];
        }
      }

      const float* lse_s = rows + st * 2 * BQ;
      const float* delta_s = lse_s + BQ;
      const bool full = (!causal || k0 + BK - 1 <= q0) &&
                        (window <= 0 || k0 > q0 + BQ - 1 - window) && k0 + BK <= Sk &&
                        q0 + BQ <= Sq;
      if (C::NWG == 1 || w == 0) {   // P^T = exp(S^T scale - lse), masked
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = row_a + 8 * ((i % 4) / 2), c = 8 * (i / 4) + col_a + i % 2;
          const float e = exp2f(fmaf(p[i], sl2, -lse_s[c] * LOG2E));
          p[i] = (full || pair_visible(q0 + c, k0 + r, Sq, Sk, causal, window)) ? e : 0.f;
        }
      }
      if constexpr (C::NWG > 1) {   // swap: warpgroup 0 gets dP^T, warpgroup 1 gets P^T
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
      for (int i = 0; i < 32; ++i) {   // dS^T = P^T (dP^T - delta) scale, into dp
        const int c = 8 * (i / 4) + col_a + i % 2;
        dp[i] = p[i] * (dp[i] - delta_s[c]) * scale;
      }

      uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
      wg::peel_frags<4>(p, ph);   // P^T and dS^T: bf16 high parts, then remainders
      wg::peel_frags<4>(p, pl);
      wg::peel_frags<4>(dp, sh);
      wg::peel_frags<4>(dp, sl);
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint64_t ddo = wg::desc_mn<BQ>(dOs, kk, w * NC / 64);
        const uint64_t dq = wg::desc_mn<BQ>(Qs, kk, w * NC / 64);
        wg::mma_rs_t<NC>(dv_acc, ph[kk], ddo);
        wg::mma_rs_t<NC>(dv_acc, pl[kk], ddo);
        wg::mma_rs_t<NC>(dk_acc, sh[kk], dq);
        wg::mma_rs_t<NC>(dk_acc, sl[kk], dq);
      }
      wg::mma_commit();
      wg::mma_wait<0>();
      wg::hold(dv_acc);
      wg::hold(dk_acc);
      wg::hold(ph);
      wg::hold(pl);
      wg::hold(sh);
      wg::hold(sl);
    }
    if (steps > 0) wg::cp_async_wait<0>();

    // dK, dV rows k0 + row_a (+ 8), columns w NC + 8 j + col_a (+ 1): bf16
    // into dk/dv, or with a head split f32 into this split's partial sums
    const int cw = w * NC;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = k0 + row_a + 8 * r;
      if (kpos >= Sk) continue;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int c = cw + 8 * j + col_a, i = 4 * j + 2 * r;
        if (c >= D) continue;
        if (splits == 1) {
          *reinterpret_cast<__nv_bfloat162*>(dk + b * gksb + kh * gksh + kpos * gkss + c) =
              __floats2bfloat162_rn(dk_acc[i], dk_acc[i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dv + b * gvsb + kh * gvsh + kpos * gvss + c) =
              __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
        } else {
          const long long n = (long long)B * K * Sk * D;
          const long long e = (((long long)b * K + kh) * Sk + kpos) * D + c;
          float* pk = part + 2 * blockIdx.z * n + e;
          *reinterpret_cast<float2*>(pk) = make_float2(dk_acc[i], dk_acc[i + 1]);
          *reinterpret_cast<float2*>(pk + n) = make_float2(dv_acc[i], dv_acc[i + 1]);
        }
      }
    }
  }
}

// dK and dV from a head split's partial sums part[split][dk, dv][B][K][Sk][D]
// (f32), added in split order: four elements a thread.
__global__ void dkv_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, int splits, int K, int Sk, int D,
                                  long long n, long long gksb, long long gksh, long long gkss,
                                  long long gvsb, long long gvsh, long long gvss) {
  const long long e4 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e4 >= 2 * n) return;
  const int which = e4 >= n;
  const long long e = e4 - which * n;
  const int d = e % D, row = (e / D) % Sk, kh = (e / D / Sk) % K, b = e / D / Sk / K;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(part + (2LL * s + which) * n + e);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  bf16* dst = which ? dv + b * gvsb + kh * gvsh + row * gvss + d
                    : dk + b * gksb + kh * gksh + row * gkss + d;
  reinterpret_cast<__nv_bfloat162*>(dst)[0] = __floats2bfloat162_rn(acc.x, acc.y);
  reinterpret_cast<__nv_bfloat162*>(dst)[1] = __floats2bfloat162_rn(acc.z, acc.w);
}

template <int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, void* part,
                     int splits, int B, int H, int K, int Sq, int Sk, long long qsb,
                     long long qsh, long long qss, long long ksb, long long ksh, long long kss,
                     long long vsb, long long vsh, long long vss, long long dsb, long long dsh,
                     long long dss, long long gksb, long long gksh, long long gkss,
                     long long gvsb, long long gvsh, long long gvss, int causal, int window,
                     float scale, cudaStream_t stream) {
  using C = DkvTC<D>;
  const int G = H / K, nk = (Sk + BK - 1) / BK;
  if (splits < 1 || G % splits != 0 || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (nk == 0) return 0;
  int err = set_smem((const void*)dkv_wgmma_kernel<D>, C::SMEM);
  if (err) return err;
  dim3 grid((nk + 1) / 2, B * K, splits);
  dkv_wgmma_kernel<D><<<grid, C::NT, C::SMEM, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (bf16*)dk, (bf16*)dv, (float*)part, B, H, G, Sq, Sk, qsb, qsh, qss,
      ksb, ksh, kss, vsb, vsh, vss, dsb, dsh, dss, gksb, gksh, gkss, gvsb, gvsh, gvss, causal,
      window, scale);
  err = (int)cudaGetLastError();
  if (err || splits == 1) return err;
  const long long n = (long long)B * K * Sk * D;
  dkv_reduce_kernel<<<(unsigned)((2 * n / 4 + 255) / 256), 256, 0, stream>>>(
      (const float*)part, (bf16*)dk, (bf16*)dv, splits, K, Sk, D, n, gksb, gksh, gkss, gvsb,
      gvsh, gvss);
  return (int)cudaGetLastError();
}

}  // namespace flash

// q, dout: (B, H, Sq, D); k, v, dk, dv: (B, K, Sk, D); lse, delta: (B, H, Sq)
// f32.  bf16 takes the tensor-core kernel (16-byte aligned operands, row
// strides a multiple of 8), the G / K q heads of a group split over
// `splits` blocks, and with splits > 1 `part` is f32 scratch of
// splits x 2 x B x K x Sk x D; f32 takes the FMA kernel and ignores both.
extern "C" int flash_dkv(int dtype, int D, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta, void* dk,
                         void* dv, void* part, int splits, int B, int H, int K, int Sq, int Sk,
                         long long qsb, long long qsh, long long qss, long long ksb,
                         long long ksh, long long kss, long long vsb, long long vsh,
                         long long vss, long long dsb, long long dsh, long long dss,
                         long long gksb, long long gksh, long long gkss, long long gvsb,
                         long long gvsh, long long gvss, int causal, int window, float scale,
                         void* stream) {
  if (B * K > 65535 || H % K != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    FLASH_DISPATCH_BF16(D, flash::launch_dkv_wgmma, q, k, v, dout, lse, delta, dk, dv, part,
                        splits, B, H, K, Sq, Sk, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss,
                        dsb, dsh, dss, gksb, gksh, gkss, gvsb, gvsh, gvss, causal, window,
                        scale, (cudaStream_t)stream);
  if (dtype == 0)
    FLASH_DISPATCH_F32(D, flash::launch_dkv, q, k, v, dout, lse, delta, dk, dv, B, H, K, Sq, Sk,
                       qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, dsb, dsh, dss, gksb, gksh,
                       gkss, gvsb, gvsh, gvss, causal, window, scale, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
