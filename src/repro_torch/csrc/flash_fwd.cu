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
// Bound: at yi-6b's shape (B 2, S 2048, H 32, K 4, D 128, causal, bf16)
// the two products take 69 GFLOP against 76 MB of traffic, and at
// recurrentgemma-2b's (B 2, S 2048, H 10, K 1, D 256, window 2048) 43.0
// GFLOP: the card's limit is its bf16 tensor-core rate.
//
// bf16 (fwd_wgmma_kernel, every head_dim of the dispatch): both products
// on the tensor cores with wgmma (m64nNk16, bf16 in, f32 accumulate).  A
// block of two warpgroups owns 128 q rows, 64 per warpgroup; the K and V
// tiles (64 rows) are shared, loaded with cp.async into a two-stage ring
// of 128-byte-swizzled tiles (wgmma.cuh) so the next tile arrives while
// the current one is in the tensor cores.  S = Q K^T reads both operands
// from shared memory; the online softmax runs on the S accumulator
// fragment (row max and sum over the four lanes that share a row, in the
// log2 domain, exp2f), and P goes to the PV product from registers: no P
// tile in shared memory.  The Pallas kernel keeps P f32 for that product;
// P rounded once to bf16 moves O by up to two bf16 ulps, which keeps O
// itself inside its tolerance but moves delta = rowsum(dO O) enough to
// put dq and dk outside theirs on the main path (PERF.md).  So P goes in
// as a bf16 high part plus the bf16 of its remainder, two products into
// one accumulator (the PV product costs twice, the step 1.5x).  Masked
// scores are -inf inside the tile, so a fully masked row keeps
// m = NEG_INF and yields 0 and lse = NEG_INF + log(1e-30), the Pallas
// convention.  Only the kv tiles on the diagonal, at the window's edge or
// past Sk compute the mask.  Blocks start from the last q tile, which
// causality makes the heaviest.  D below 64 is zero-padded to one
// 64-column swizzle row.
// Shared memory: the 128 x DP Q tile and two stages of K and V, 99,328
// bytes at D 128 and 197,632 at D 256 (1 KB of it alignment slack); one
// block of 256 threads an SM.  nvcc -Xptxas -v (CUDA 12.8): 255 registers
// at D 256, 189 at D 128, 141-142 below, no spill.
//
// f32 (fwd_kernel, up to D 128): the products as f32 FMAs from shared
// memory (a 4 x 4 register tile of scores and a 4 x D/16 accumulator per
// thread), which holds the f32 paths' 1e-4 tolerance that TF32 products
// would not.
#include "flash_common.cuh"
#include "wgmma.cuh"

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

template <int D>
struct FwdTC {
  static constexpr int DP = D < 64 ? 64 : D;   // tile width: one swizzle row at least
  static constexpr int NWG = 2;                // warpgroups, 64 q rows each
  static constexpr int BM = 64 * NWG;          // q rows a block
  static constexpr int NT = 128 * NWG;
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;
  static constexpr int SMEM = 1024 + Q_BYTES + 4 * KV_BYTES;
};

template <int D>
__global__ void __launch_bounds__(FwdTC<D>::NT, 1)
fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int H, int G, int Sq, int Sk, long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
                 long long vss, long long osb, long long osh, long long oss, int causal,
                 int window, float scale) {
  using C = FwdTC<D>;
  constexpr int DP = C::DP, NA = DP / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Qs = (wg::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t KV0 = Qs + C::Q_BYTES;        // stage s: K at KV0 + 2 s KV_BYTES, V after it

  const int tid = threadIdx.x, w = tid / 128, lane = tid % 32;
  const int row_a = 16 * ((tid % 128) / 32) + lane / 4;   // fragment rows row_a, row_a + 8
  const int col_a = 2 * (lane % 4);                        // fragment columns 8 j + col_a + {0, 1}
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BM;     // the heaviest q tiles first
  const int qw = q0 + 64 * w;                              // this warpgroup's first row
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / G;
  const bf16* kb = k + b * ksb + kh * ksh;
  const bf16* vb = v + b * vsb + kh * vsh;

  int lo, hi;
  kv_tile_range(q0, min(q0 + C::BM, Sq) - 1, Sk, causal, window, &lo, &hi);
  wg::load_tile<C::BM, D, DP, C::NT>(Qs, q + b * qsb + h * qsh, qss, q0, Sq, tid);
  if (lo < hi) {
    wg::load_tile<BK, D, DP, C::NT>(KV0, kb, kss, lo * BK, Sk, tid);
    wg::load_tile<BK, D, DP, C::NT>(KV0 + C::KV_BYTES, vb, vss, lo * BK, Sk, tid);
  }
  wg::cp_async_commit();

  const float sl2 = scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF};   // row max of s * scale * log2 e
  float l[2] = {0.f, 0.f};           // this thread's part of the row sum
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;

  for (int jt = lo; jt < hi; ++jt) {
    const int k0 = jt * BK, stage = (jt - lo) & 1;
    const uint32_t Ks = KV0 + stage * 2 * C::KV_BYTES, Vs = Ks + C::KV_BYTES;
    __syncthreads();   // both warpgroups are done with the stage the next tile goes to
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

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wg::mma_ss_n64(s, wg::desc_k<C::BM>(Qs + w * 64 * 128, kk), wg::desc_k<BK>(Ks, kk),
                     kk > 0);
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::hold(s);

    const bool full = (!causal || k0 + BK - 1 <= qw) &&
                      (window <= 0 || k0 > qw + 63 - window) && k0 + BK <= Sk;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = row_a + 8 * ((i % 4) / 2), c = 8 * (i / 4) + col_a + i % 2;
      s[i] = (full || pair_visible(qw + r, k0 + c, Sq, Sk, causal, window)) ? s[i] * sl2
                                                                              : MINUS_INF;
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(s[i] - m[(i % 4) / 2]);   // -inf (masked) gives 0
      l[(i % 4) / 2] += s[i];
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] *= alpha[(i % 4) / 2];

    uint32_t ph[4][4], pl[4][4];   // P = bf16 high part + bf16 remainder
    wg::peel_frags<4>(s, ph);
    wg::peel_frags<4>(s, pl);
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wg::mma_rs_t<DP>(acc, ph[kk], wg::desc_mn<BK>(Vs, kk));
      wg::mma_rs_t<DP>(acc, pl[kk], wg::desc_mn<BK>(Vs, kk));
    }
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::hold(acc);
    wg::hold(ph);
    wg::hold(pl);
  }
  wg::cp_async_wait<0>();

  bf16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qpos = qw + row_a + 8 * r;
    if (qpos >= Sq) continue;
    const float ll = fmaxf(l[r], 1e-30f), inv = 1.f / ll;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + col_a;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(ob + qpos * oss + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
    if (lse != nullptr && lane % 4 == 0)
      lse[((long long)b * H + h) * Sq + qpos] = (m[r] == NEG_INF ? NEG_INF : m[r] * LN2) + logf(ll);
  }
}

template <int D>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                     int H, int K, int Sq, int Sk, long long qsb, long long qsh, long long qss,
                     long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
                     long long vss, long long osb, long long osh, long long oss, int causal,
                     int window, float scale, cudaStream_t stream) {
  using C = FwdTC<D>;
  int err = set_smem((const void*)fwd_wgmma_kernel<D>, C::SMEM);
  if (err) return err;
  dim3 grid((Sq + C::BM - 1) / C::BM, B * H);
  fwd_wgmma_kernel<D><<<grid, C::NT, C::SMEM, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, H, H / K, Sq, Sk,
      qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash

// q: (B, H, Sq, D); k, v: (B, K, Sk, D); o like q; lse (B, H, Sq) f32 or
// null.  bf16 takes the tensor-core kernel (16-byte aligned operands, row
// strides a multiple of 8), f32 the FMA kernel.
extern "C" int flash_fwd(int dtype, int D, const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int H, int K, int Sq, int Sk,
                         long long qsb, long long qsh, long long qss, long long ksb,
                         long long ksh, long long kss, long long vsb, long long vsh,
                         long long vss, long long osb, long long osh, long long oss,
                         int causal, int window, float scale, void* stream) {
  if (B * H > 65535 || H % K != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    FLASH_DISPATCH_BF16(D, flash::launch_fwd_wgmma, q, k, v, o, lse, B, H, K, Sq, Sk, qsb, qsh,
                        qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, causal, window, scale,
                        (cudaStream_t)stream);
  if (dtype == 0)
    FLASH_DISPATCH_F32(D, flash::launch_fwd, q, k, v, o, lse, B, H, K, Sq, Sk, qsb, qsh, qss,
                       ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, causal, window, scale,
                       (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
