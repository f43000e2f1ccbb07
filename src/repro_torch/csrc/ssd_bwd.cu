// Mamba-2 SSD chunked scan, backward (entry ssd_bwd).
//
// Replaces repro/kernels/ssd_bwd.py::_bwd_kernel (bwd_kernel_layout), whose
// TPU grid walked the chunks in reverse carrying the state adjoint dS.  Per
// chunk, with e = exp(csum), alpha = e[-1], d = exp(csum[-1] - csum),
// G = (c b^T) * L, the state S_in entering the chunk (from the forward's
// chunk_states) and the adjoint dS_out of the state leaving it:
//
//   dx = G^T dy + d (b dS_out^T)     dc = M b + e (dy S_in),  M = (dy x^T) * L
//   db = M^T c + d (x dS_out)        dS_in = alpha dS_out + (e dy)^T c
//   dcsum = rowsum(dG G) - colsum(dG G) + e rowsum(c (dy S_in)) - d dd,
//   dd = rowsum(b (x dS_out));  dcsum[-1] += alpha sum(dS_out S_in) + sum(d dd);
//   ddA = reverse cumsum of dcsum (float64, rounded once).
//
// Bound: bytes.  At mamba2-2.7b's shape (B 2, S 2048, H 80, P 64, N 128,
// chunk 256, bf16 x/B/C, B and C one group) the products take about 65
// GFLOP (0.066 ms at 989 TFLOP/s), while the per-head f32 outputs alone
// (db and dc, 336 MB) and the f32 inputs take 0.178 ms at 3.35 TB/s.
//
// bf16 (the main path): the reverse walk is split into four kernels, of
// which only the second is sequential over chunks, and it is elementwise:
//   1. bwd_u_kernel, a block per chunk: the chunk's csum and its term of
//      the recurrence, U = (e dy)^T c (P x N over the chunk's Q rows);
//   2. bwd_state_kernel, four state elements a thread: the reverse pass
//      dS_out[nc - 1] = dstate, dS_out[c - 1] = alpha_c dS_out[c] + U_c.
//      It writes each chunk's dS_out and S_in as bf16 tile images (two
//      parts each, in the swizzled layout) that phase 3 copies as they
//      are, and its blocks' sums of dS_out S_in;
//   3. bwd_chunk_kernel, a block (one warpgroup) per (64-row slab w, chunk,
//      b * h): pass A on the rows of slab w against the column slabs j <= w
//      (dc, the row terms of dcsum), then pass B on the columns of slab w
//      against the row slabs i >= w (dx, db, the column terms, dd), so
//      every block walks nslab + 1 tiles of the (Q, Q) chunk matrix; pass B
//      builds its tiles transposed, so G^T and M^T are register A operands
//      in the layout their products take.  The next tile's operands arrive
//      by cp.async (dy as f32 into a staging tile, split in shared memory)
//      while the current one is in the tensor cores.  Each slab's rows of
//      dcsum and its sum of d dd go to scratch;
//   4. bwd_ddA_kernel, a block per chunk: the last position's extra term
//      from those partial sums in a fixed order, then the reverse cumsum
//      in float64, rounded once.
// Every product is a wgmma (m64nNk16, bf16 in, f32 accumulate; wgmma.cuh)
// from 128-byte-swizzled tiles, with register A operands for M and G.
// c b^T and every product of x, b or c with a bf16 operand are exact.  An
// f32 operand (dy, S_in, dS_out, M, G, e dy) enters as bf16 parts, x = hi +
// lo (+ lo2), products summed into one accumulator: two parts against a
// bf16 operand; dy S_in as (hi, lo) x (hi, lo) less lo lo; G^T dy, where
// one term near the diagonal dominates an element and nothing averages the
// rounding out, with G and dy in three parts each (the six products of
// order above 2^-16), and M in three parts against b and c
// (analysis/ssd_split_error.py models the rounding).  The tolerance's
// measure, max|err| / max(max|want|, 1) <= 1e-5, is held with the margin
// PERF.md records.  Every output has one owner and every sum a fixed
// order: no atomics, deterministic.  The wrapper allocates the scratch:
// U, the tile images, and csum, dcsum and the partial sums per chunk.
// What holds bwd_chunk_kernel back is latency: one warpgroup a block at
// 255 registers (nvcc -Xptxas -v, CUDA 12.8: 264 bytes of spill stores),
// two blocks an SM, each tile waiting on its products.
//
// f32 (bwd_kernel): one block of 256 threads per (batch, head) walks the
// chunks in reverse, S_in and the dS carry (32 KB each at P 64, N 128) in
// shared memory, each chunk in two passes over 64-row slabs (A: rows of
// (c, dy) against the columns at or below the diagonal; B: columns of
// (b, x) against the rows at or above it; then C streams (e dy, c) into
// the new dS); f32 FMAs out of shared memory, which hold the f32 paths'
// tolerance that TF32 would not.
#include "ssd_common.cuh"
#include "wgmma.cuh"

namespace ssd {

struct BwdArgs {
  const void* x;
  const float* dA;
  const void* b;
  const void* c;
  const float* chunk_states;   // (B, H, nc, P, N)
  const float* dy;
  const float* dstate;         // (B, H, P, N)
  float* dx;
  float* ddA;
  float* db;
  float* dc;
  int H, S, Q;
  Str xs, as, bs, cs, dys, dxs, das, dbs, dcs;
};

template <int P, int N>
constexpr int bwd_smem_floats() {
  return 2 * P * (N + 1) + 3 * QMAX + NT / 32 + 2 * R * (N + 1) + 2 * R * (P + 1) +
         2 * R * (R + 1);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(NT) bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* s_in = smem;                   // [P][N + 1]  state entering the chunk
  float* ds = s_in + P * (N + 1);       // [P][N + 1]  adjoint of the state leaving it
  float* cs = ds + P * (N + 1);        // [QMAX]      csum
  float* dcs = cs + QMAX;              // [QMAX]      dcsum, then ddA
  float* sterm = dcs + QMAX;           // [QMAX]      d * dd
  float* red = sterm + QMAX;           // [NT / 32]   block_sum scratch
  float* sN = red + NT / 32;           // [R][N + 1]  slab rows of c (A) or b (B)
  float* sP = sN + R * (N + 1);        // [R][P + 1]  slab rows of dy (A) or x (B)
  float* tN = sP + R * (P + 1);        // [R][N + 1]  tile rows of b (A) or c (B, C)
  float* tP = tN + R * (N + 1);        // [R][P + 1]  tile rows of x (A) or dy (B, C)
  float* gw = tP + R * (P + 1);        // [R][R + 1]  G^T tile (B)
  float* mw = gw + R * (R + 1);        // [R][R + 1]  M tile (A), M^T tile (B)

  const int bh = blockIdx.x, bi = bh / a.H, hi = bh % a.H;
  const int ty = tid_y(), tx = tid_x();
  const int Q = a.Q, nc = (a.S + Q - 1) / Q;
  const T* x0 = (const T*)a.x + bi * a.xs.b + hi * a.xs.h;
  const float* d0 = a.dA + bi * a.as.b + hi * a.as.h;
  const T* b0 = (const T*)a.b + bi * a.bs.b + hi * a.bs.h;
  const T* c0 = (const T*)a.c + bi * a.cs.b + hi * a.cs.h;
  const float* dy0 = a.dy + bi * a.dys.b + hi * a.dys.h;
  float* dx0 = a.dx + bi * a.dxs.b + hi * a.dxs.h;
  float* dA0 = a.ddA + bi * a.das.b + hi * a.das.h;
  float* db0 = a.db + bi * a.dbs.b + hi * a.dbs.h;
  float* dc0 = a.dc + bi * a.dcs.b + hi * a.dcs.h;

  const float* dst = a.dstate + (long long)bh * P * N;
  for (int idx = threadIdx.x; idx < P * N; idx += NT) ds[(idx / N) * (N + 1) + idx % N] = dst[idx];

  for (int k = nc - 1; k >= 0; --k) {
    const int t0 = k * Q, nvalid = min(Q, a.S - t0);
    const T* xk = x0 + t0 * a.xs.s;
    const T* bk = b0 + t0 * a.bs.s;
    const T* ck = c0 + t0 * a.cs.s;
    const float* dyk = dy0 + t0 * a.dys.s;
    const float* sk = a.chunk_states + ((long long)bh * nc + k) * P * N;
    for (int idx = threadIdx.x; idx < P * N; idx += NT) s_in[(idx / N) * (N + 1) + idx % N] = sk[idx];
    for (int i = threadIdx.x; i < Q; i += NT)
      cs[i] = i < nvalid ? d0[(long long)(t0 + i) * a.as.s] : 0.f;
    __syncthreads();
    chunk_cumsum(cs, Q);
    const float last = cs[Q - 1];
    auto decay = [&](int row, int col) {
      return (row >= col && row < Q) ? expf(cs[row] - cs[col]) : 0.f;
    };

    // ---- A: row slabs of (c, dy): dc, rowsum(dG G), e term ----------------
    for (int r0 = 0; r0 < Q; r0 += R) {
      load_rows<N>(sN, N + 1, ck, a.cs.s, r0, nvalid, One());
      load_rows<P>(sP, P + 1, dyk, a.dys.s, r0, nvalid, One());
      float dcacc[4][N / 16] = {};
      float rs[4] = {};
      for (int j0 = 0; j0 <= r0; j0 += R) {
        load_rows<N>(tN, N + 1, bk, a.bs.s, j0, nvalid, One());
        load_rows<P>(tP, P + 1, xk, a.xs.s, j0, nvalid, One());
        __syncthreads();
        float g[4][4] = {}, dg[4][4] = {};
        rowdot<4, N>(g, sN, N + 1, tN, N + 1);     // c b^T
        rowdot<4, P>(dg, sP, P + 1, tP, P + 1);    // dy x^T
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float l = decay(r0 + ty + 16 * i, j0 + tx + 16 * j);
            rs[i] = fmaf(dg[i][j], g[i][j] * l, rs[i]);
            mw[(ty + 16 * i) * (R + 1) + tx + 16 * j] = dg[i][j] * l;
          }
        __syncthreads();
        matacc<N / 16, R>(dcacc, mw, R + 1, tN, N + 1);   // M b
        __syncthreads();
      }
      float dys_[4][N / 16] = {};
      matacc<N / 16, P>(dys_, sP, P + 1, s_in, N + 1);    // dy S_in
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty + 16 * i;
        const float e = row < Q ? expf(cs[row]) : 0.f;
        float et = 0.f;
#pragma unroll
        for (int j = 0; j < N / 16; ++j) et = fmaf(sN[(ty + 16 * i) * (N + 1) + tx + 16 * j], dys_[i][j], et);
        const float rsum = row_sum16(rs[i]), esum = row_sum16(et);
        if (row < Q && tx == 0) dcs[row] = rsum + e * esum;
        if (row < nvalid) {
          float* dcr = dc0 + (long long)(t0 + row) * a.dcs.s;
#pragma unroll
          for (int j = 0; j < N / 16; ++j) dcr[tx + 16 * j] = dcacc[i][j] + e * dys_[i][j];
        }
      }
      __syncthreads();
    }

    // ---- B: column slabs of (b, x): dx, db, colsum(dG G), dd -------------
    for (int j0 = 0; j0 < Q; j0 += R) {
      load_rows<N>(sN, N + 1, bk, a.bs.s, j0, nvalid, One());
      load_rows<P>(sP, P + 1, xk, a.xs.s, j0, nvalid, One());
      float dxacc[4][P / 16] = {}, dbacc[4][N / 16] = {};
      float csum_[4] = {};
      for (int i0 = j0; i0 < Q; i0 += R) {
        load_rows<N>(tN, N + 1, ck, a.cs.s, i0, nvalid, One());
        load_rows<P>(tP, P + 1, dyk, a.dys.s, i0, nvalid, One());
        __syncthreads();
        float g[4][4] = {}, dg[4][4] = {};             // [col j][row i]
        rowdot<4, N>(g, sN, N + 1, tN, N + 1);     // (c b^T)^T
        rowdot<4, P>(dg, sP, P + 1, tP, P + 1);    // (dy x^T)^T
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const float l = decay(i0 + tx + 16 * ii, j0 + ty + 16 * jj);
            const float gl = g[jj][ii] * l;
            csum_[jj] = fmaf(dg[jj][ii], gl, csum_[jj]);
            gw[(ty + 16 * jj) * (R + 1) + tx + 16 * ii] = gl;
            mw[(ty + 16 * jj) * (R + 1) + tx + 16 * ii] = dg[jj][ii] * l;
          }
        __syncthreads();
        matacc<P / 16, R>(dxacc, gw, R + 1, tP, P + 1);   // G^T dy
        matacc<N / 16, R>(dbacc, mw, R + 1, tN, N + 1);   // M^T c
        __syncthreads();
      }
      float bds[4][P / 16] = {}, xds[4][N / 16] = {};
      rowdot<P / 16, N>(bds, sN, N + 1, ds, N + 1);      // b dS^T
      matacc<N / 16, P>(xds, sP, P + 1, ds, N + 1);      // x dS
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int row = j0 + ty + 16 * jj;
        const float d = row < Q ? expf(last - cs[row]) : 0.f;
        float dd = 0.f;
#pragma unroll
        for (int n = 0; n < N / 16; ++n) dd = fmaf(sN[(ty + 16 * jj) * (N + 1) + tx + 16 * n], xds[jj][n], dd);
        const float csum_all = row_sum16(csum_[jj]), dd_all = row_sum16(dd);
        if (row < Q && tx == 0) {
          sterm[row] = dd_all * d;
          dcs[row] -= csum_all + dd_all * d;
        }
        if (row < nvalid) {
          float* dxr = dx0 + (long long)(t0 + row) * a.dxs.s;
          float* dbr = db0 + (long long)(t0 + row) * a.dbs.s;
#pragma unroll
          for (int p = 0; p < P / 16; ++p) dxr[tx + 16 * p] = dxacc[jj][p] + d * bds[jj][p];
#pragma unroll
          for (int n = 0; n < N / 16; ++n) dbr[tx + 16 * n] = dbacc[jj][n] + d * xds[jj][n];
        }
      }
      __syncthreads();
    }

    // ---- C: last-row term, then dS <- alpha dS + (e dy)^T c ----------------
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < P / 16; ++i)
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        const int off = (ty + 16 * i) * (N + 1) + tx + 16 * j;
        part = fmaf(ds[off], s_in[off], part);
      }
    const float dS_sin = block_sum(part, red);
    const float alpha = expf(last);
    float upd[P / 16][N / 16] = {};
    for (int i0 = 0; i0 < Q; i0 += R) {
      load_rows<P>(tP, P + 1, dyk, a.dys.s, i0, nvalid, [&](int row) { return expf(cs[row]); });
      load_rows<N>(tN, N + 1, ck, a.cs.s, i0, nvalid, One());
      __syncthreads();
      outer_acc<P / 16, N / 16>(upd, tP, P + 1, tN, N + 1);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < P / 16; ++i)
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        float* s = ds + (ty + 16 * i) * (N + 1) + tx + 16 * j;
        *s = alpha * *s + upd[i][j];
      }
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int i = 0; i < Q; ++i) s += sterm[i];
      dcs[Q - 1] += alpha * dS_sin + s;
    }
    __syncthreads();
    chunk_revsum(dcs, Q);
    for (int i = threadIdx.x; i < nvalid; i += NT) dA0[(long long)(t0 + i) * a.das.s] = dcs[i];
    __syncthreads();
  }
}

template <typename T, int P, int N>
int launch_bwd(const BwdArgs& a, int B, cudaStream_t stream) {
  if (a.Q < 1 || a.Q > QMAX || a.S < 1 || B < 1 || a.H < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * bwd_smem_floats<P, N>();
  int err = set_smem((const void*)bwd_kernel<T, P, N>, smem);
  if (err) return err;
  bwd_kernel<T, P, N><<<B * a.H, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: chunk-parallel, products on the tensor cores
// ---------------------------------------------------------------------------

struct BwdScratch {
  float* csum;    // (B*H, nc, Q): the chunk's cumsum of dA
  float* u;       // (B*H, nc, P, N): U of each chunk
  float* dcsum;   // (B*H, nc, Q)
  float* part;    // (B*H, nc, 4): sum of d dd over each slab's rows
  float* sds;     // (B*H, nc, PN / 512): sum of dS_out S_in over 512 elements
  uint8_t* img;   // (B*H, nc, [S_in, dS_out], 2 parts): swizzled 64 x NN bf16 tiles
};

template <int P, int N>
struct BwdTC {
  static constexpr int NP = P < 64 ? 64 : P;   // tile widths: one swizzle row at least
  static constexpr int NN = N < 64 ? 64 : N;
  static constexpr int BT = R * NN * 2;        // a 64-row bf16 tile of b, c or a state
  static constexpr int XT = R * NP * 2;        // a 64-row bf16 tile of x or dy
  static constexpr int FT = R * NP * 4;        // a 64-row f32 staging tile of dy
  static constexpr int OWN = BT + 2 * XT;      // the block's own slab
  // streamed tiles: pass A two stages of (b, x) with S_in's two parts over
  // the second; pass B two c tiles, dy's three parts, dS_out's two parts
  // over the second c tile and dy; then the dy staging tile
  static constexpr int STG = BT + XT + 2 * BT > 2 * BT + 3 * XT ? BT + XT + 2 * BT
                                                                 : 2 * BT + 3 * XT;
  static constexpr int STR = STG + FT;
  static constexpr int SMEM = 1024 + OWN + STR + 4 * (QMAX + 32);
  static constexpr int U_SMEM = 1024 + 2 * BT + 2 * XT + FT + 4 * QMAX;
  static_assert(NP == 64 && NN <= 128, "one m64 tile of P rows, N up to 128");
};

// The row sums of an m64nN accumulator fragment: lanes l, l ^ 1, l ^ 2, l ^ 3
// share a row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Sum over the 128 threads of a block in a fixed order; every thread gets it.
__device__ __forceinline__ float sum128(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  const float s = red[0] + red[1] + red[2] + red[3];
  __syncthreads();
  return s;
}

struct Exp {   // scale a row by exp(cs[row])
  const float* cs;
  __device__ __forceinline__ float operator()(int row) const { return expf(cs[row]); }
};

// Phase 1, one block (128 threads) per chunk: csum, and the chunk's term
// of the dS recurrence U = (e dy)^T c, a P x N product over the chunk's Q
// rows (A = (e dy)^T, MN-major, in two bf16 parts; B = c, MN-major).  The
// next slab's c and f32 dy arrive by cp.async while the current one is in
// the tensor cores.
template <int P, int N>
__global__ void __launch_bounds__(128) bwd_u_kernel(BwdArgs a, BwdScratch z) {
  using C = BwdTC<P, N>;
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t C0 = (wg::smem_u32(smem_raw) + 1023) & ~1023u;   // two c tiles
  const uint32_t E1 = C0 + 2 * C::BT, E2 = E1 + C::XT;             // e dy in two parts
  const uint32_t STG = E2 + C::XT;                                 // f32 dy
  uint8_t* base = smem_raw + (C0 - wg::smem_u32(smem_raw));
  const float* stg = reinterpret_cast<const float*>(base + (STG - C0));
  float* cs = reinterpret_cast<float*>(base + (STG - C0) + C::FT);

  const int kc = blockIdx.x, bh = blockIdx.y, bi = bh / a.H, hi = bh % a.H;
  const int Q = a.Q, nc = (a.S + Q - 1) / Q, t0 = kc * Q, nvalid = min(Q, a.S - t0);
  const int tid = threadIdx.x, lane = tid % 32;
  const int row_a = 16 * (tid / 32) + lane / 4, col_a = 2 * (lane % 4);
  const long long ci = (long long)bh * nc + kc;
  const float* dA0 = a.dA + bi * a.as.b + hi * a.as.h + t0 * a.as.s;
  const bf16* ck = (const bf16*)a.c + bi * a.cs.b + hi * a.cs.h + t0 * a.cs.s;
  const float* dyk = a.dy + bi * a.dys.b + hi * a.dys.h + t0 * a.dys.s;

  wg::load_tile<R, N, C::NN, 128>(C0, ck, a.cs.s, 0, nvalid, tid);
  wg::load_rows_f32<R, P, C::NP, 128>(STG, dyk, a.dys.s, 0, nvalid, tid);
  wg::cp_async_commit();
  if constexpr (P < C::NP || N < C::NN) {
    // the padding of S_in's and dS_out's tile images for phase 3 (rows P ..
    // 63, columns N .. NN - 1); phase 2 writes the P x N elements
    uint8_t* img = z.img + ci * 4 * C::BT;
    for (int i = tid; i < R * C::NN / 2; i += 128) {
      const int r = i / (C::NN / 2), c = 2 * (i % (C::NN / 2));
      if (r >= P || c >= N) {
        wg::put_parts<2>(img, C::BT, wg::tile_off<R>(r, c), 0.f, 0.f);
        wg::put_parts<2>(img + 2 * C::BT, C::BT, wg::tile_off<R>(r, c), 0.f, 0.f);
      }
    }
  }
  for (int i = tid; i < Q; i += 128) cs[i] = i < nvalid ? dA0[(long long)i * a.as.s] : 0.f;
  __syncthreads();
  chunk_cumsum(cs, Q);
  for (int i = tid; i < Q; i += 128) z.csum[ci * Q + i] = cs[i];

  float u[C::NN / 2];
#pragma unroll
  for (int i = 0; i < C::NN / 2; ++i) u[i] = 0.f;
  for (int r0 = 0, st = 0; r0 < Q; r0 += R, st ^= 1) {
    wg::cp_async_wait<0>();
    __syncthreads();   // this slab has landed; the previous slab's products are done
    wg::load_split<R, C::NP, C::NP, 128, 2>(E1, stg, C::NP, 0, nvalid - r0, tid, Exp{cs + r0});
    wg::fence_async_smem();
    __syncthreads();   // e dy's parts are visible; the staging tile is free
    if (r0 + R < Q) {
      wg::load_tile<R, N, C::NN, 128>(C0 + (st ^ 1) * C::BT, ck, a.cs.s, r0 + R, nvalid, tid);
      wg::load_rows_f32<R, P, C::NP, 128>(STG, dyk, a.dys.s, r0 + R, nvalid, tid);
      wg::cp_async_commit();
    }
    const uint32_t Cs = C0 + st * C::BT;
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      wg::mma_ss<C::NN, 1, 1>(u, wg::desc_mn<R>(E1, kk), wg::desc_mn<R>(Cs, kk));
      wg::mma_ss<C::NN, 1, 1>(u, wg::desc_mn<R>(E2, kk), wg::desc_mn<R>(Cs, kk));
    }
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::hold(u);
  }
  float* uo = z.u + ci * P * N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = row_a + 8 * r;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < C::NN / 8; ++j) {
      const int n = 8 * j + col_a;
      if (n < N)
        *reinterpret_cast<float2*>(uo + p * N + n) =
            make_float2(u[4 * j + 2 * r], u[4 * j + 2 * r + 1]);
    }
  }
}

// Phase 2, elementwise over (b, h, P N), four elements a thread, 512 a
// block: the reverse state pass, dS_out[nc - 1] = dstate and
// dS_out[c - 1] = alpha_c dS_out[c] + U_c.  Each dS_out and S_in go out as
// the two bf16 parts phase 3 reads (swizzled tile images), with the block's
// sum of dS_out S_in for the last position's extra term.  Eight chunks' U, S_in
// and alpha are loaded before any is used, so the loads overlap.
template <int P, int N>
__global__ void __launch_bounds__(128) bwd_state_kernel(BwdArgs a, BwdScratch z) {
  using C = BwdTC<P, N>;
  constexpr int PN = P * N, NB = (PN + 511) / 512, BATCH = 8;
  __shared__ float red[4];
  const int e = 4 * (blockIdx.x * 128 + threadIdx.x), bh = blockIdx.y;
  const bool on = e < PN;
  const int Q = a.Q, nc = (a.S + Q - 1) / Q;
  const uint32_t off = wg::tile_off<R>(e / N, e % N);   // e, e + 1; e + 2, e + 3 at off + 4
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  if (on) carry = *reinterpret_cast<const float4*>(a.dstate + (long long)bh * PN + e);
  for (int k0 = nc - 1; k0 >= 0; k0 -= BATCH) {
    float4 u[BATCH], si[BATCH];
    float alpha[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const long long ci = (long long)bh * nc + max(k0 - j, 0);
      u[j] = si[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (on) {
        u[j] = *reinterpret_cast<const float4*>(z.u + ci * PN + e);
        si[j] = *reinterpret_cast<const float4*>(a.chunk_states + ci * PN + e);
      }
      alpha[j] = expf(z.csum[ci * Q + Q - 1]);
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (k0 - j < 0) break;
      const long long ci = (long long)bh * nc + k0 - j;
      if (on) {   // S_in's and dS_out's two bf16 parts
        uint8_t* img = z.img + ci * 4 * C::BT;
        wg::put_parts<2>(img, C::BT, off, si[j].x, si[j].y);
        wg::put_parts<2>(img, C::BT, off + 4, si[j].z, si[j].w);
        wg::put_parts<2>(img + 2 * C::BT, C::BT, off, carry.x, carry.y);
        wg::put_parts<2>(img + 2 * C::BT, C::BT, off + 4, carry.z, carry.w);
      }
      float s = carry.x * si[j].x + carry.y * si[j].y + carry.z * si[j].z + carry.w * si[j].w;
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = s;
      __syncthreads();
      if (threadIdx.x == 0) z.sds[ci * NB + blockIdx.x] = red[0] + red[1] + red[2] + red[3];
      __syncthreads();
      carry.x = alpha[j] * carry.x + u[j].x;
      carry.y = alpha[j] * carry.y + u[j].y;
      carry.z = alpha[j] * carry.z + u[j].z;
      carry.w = alpha[j] * carry.w + u[j].w;
    }
  }
}

// Phase 3, one block (one warpgroup) per (64-row slab w, chunk, b * h):
// pass A, then pass B (see the top of the file).  The next tile's operands
// arrive by cp.async (dy as f32 into a staging tile, split into its bf16
// parts when its turn comes) while the current tile is in the tensor cores.
template <int P, int N>
__global__ void __launch_bounds__(128) bwd_chunk_kernel(BwdArgs a, BwdScratch z) {
  using C = BwdTC<P, N>;
  using bf16 = __nv_bfloat16;
  constexpr int NP = C::NP, NN = C::NN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t OWN = (wg::smem_u32(smem_raw) + 1023) & ~1023u, STR = OWN + C::OWN;
  const uint32_t STG = STR + C::STG;   // f32 dy staging
  uint8_t* base = smem_raw + (OWN - wg::smem_u32(smem_raw));
  const float* stg = reinterpret_cast<const float*>(base + C::OWN + C::STG);
  float* cs = reinterpret_cast<float*>(base + C::OWN + C::STR);
  float* red = cs + QMAX;

  const int w = blockIdx.x, kc = blockIdx.y, bh = blockIdx.z, bi = bh / a.H, hi = bh % a.H;
  const int Q = a.Q, nc = (a.S + Q - 1) / Q, nslab = (Q + R - 1) / R;
  const int t0 = kc * Q, nvalid = min(Q, a.S - t0);
  const int tid = threadIdx.x, lane = tid % 32;
  const int row_a = 16 * (tid / 32) + lane / 4, col_a = 2 * (lane % 4);
  const long long ci = (long long)bh * nc + kc;
  const bf16* xk = (const bf16*)a.x + bi * a.xs.b + hi * a.xs.h + t0 * a.xs.s;
  const bf16* bk = (const bf16*)a.b + bi * a.bs.b + hi * a.bs.h + t0 * a.bs.s;
  const bf16* ck = (const bf16*)a.c + bi * a.cs.b + hi * a.cs.h + t0 * a.cs.s;
  const float* dyk = a.dy + bi * a.dys.b + hi * a.dys.h + t0 * a.dys.s;
  const uint8_t* img = z.img + ci * 4 * C::BT;   // S_in's parts, then dS_out's

  // ---- A: rows of slab w ----------------------------------------------
  const uint32_t cw = OWN, dy1 = OWN + C::BT, dy2 = dy1 + C::XT;   // own c; dy in two parts
  const uint32_t SIN = STR + C::BT + C::XT;   // S_in's two parts, over the second stage
  wg::load_tile<R, N, NN, 128>(cw, ck, a.cs.s, R * w, nvalid, tid);
  wg::load_tile<R, N, NN, 128>(STR, bk, a.bs.s, 0, nvalid, tid);             // b_0
  wg::load_tile<R, P, NP, 128>(STR + C::BT, xk, a.xs.s, 0, nvalid, tid);     // x_0
  wg::load_rows_f32<R, P, NP, 128>(STG, dyk, a.dys.s, R * w, nvalid, tid);   // dy_w
  wg::copy_bytes<2 * C::BT, 128>(SIN, img, tid);                             // S_in
  wg::cp_async_commit();
  for (int i = tid; i < Q; i += 128) cs[i] = z.csum[ci * Q + i];
  wg::cp_async_wait<0>();
  __syncthreads();
  wg::load_split<R, NP, NP, 128, 2>(dy1, stg, NP, 0, R, tid, One());
  wg::fence_async_smem();
  __syncthreads();
  const float last = cs[Q - 1];
  auto decay = [&](int row, int col) {
    return (row >= col && row < Q) ? exp2f((cs[row] - cs[col]) * 1.4426950408889634f) : 0.f;
  };
  float e[2], d[2];   // exp(csum) and exp(csum[-1] - csum) of this thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = R * w + row_a + 8 * r;
    e[r] = row < Q ? expf(cs[row]) : 0.f;
    d[r] = row < Q ? expf(last - cs[row]) : 0.f;
  }
  float dc[NN / 2];   // dy S_in (K = P) first, then e-scaled, then + M b
#pragma unroll
  for (int i = 0; i < NN / 2; ++i) dc[i] = 0.f;
  wg::mma_fence();
#pragma unroll
  for (int kk = 0; kk < NP / 16; ++kk) {
    const uint64_t a1 = wg::desc_k<R>(dy1, kk), a2 = wg::desc_k<R>(dy2, kk);
    const uint64_t s1 = wg::desc_mn<R>(SIN, kk), s2 = wg::desc_mn<R>(SIN + C::BT, kk);
    wg::mma_ss<NN, 0, 1>(dc, a1, s1);
    wg::mma_ss<NN, 0, 1>(dc, a1, s2);
    wg::mma_ss<NN, 0, 1>(dc, a2, s1);
  }
  wg::mma_commit();
  wg::mma_wait<0>();
  wg::hold(dc);
  float rowT[2] = {0.f, 0.f}, et[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NN / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 4 * j + 2 * r;
      const float2 cv = wg::ld_pair(cw + wg::tile_off<R>(row_a + 8 * r, 8 * j + col_a));
      et[r] = fmaf(cv.x, dc[i], fmaf(cv.y, dc[i + 1], et[r]));
      dc[i] *= e[r];
      dc[i + 1] *= e[r];
    }

  for (int j = 0; j <= w; ++j) {
    const uint32_t bj = STR + (j & 1) * (C::BT + C::XT), xj = bj + C::BT;
    if (j > 0) {
      wg::cp_async_wait<0>();
      wg::fence_async_smem();
    }
    __syncthreads();   // tile j has landed; tile j - 1's (or S_in's) readers are done
    if (j < w) {
      const uint32_t bn = STR + ((j + 1) & 1) * (C::BT + C::XT);
      wg::load_tile<R, N, NN, 128>(bn, bk, a.bs.s, R * (j + 1), nvalid, tid);
      wg::load_tile<R, P, NP, 128>(bn + C::BT, xk, a.xs.s, R * (j + 1), nvalid, tid);
      wg::cp_async_commit();
    }
    float g[32], m[32];   // c b^T and dy x^T, rows of slab w, columns of slab j
#pragma unroll
    for (int i = 0; i < 32; ++i) g[i] = m[i] = 0.f;
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < NN / 16; ++kk)
      wg::mma_ss<64, 0, 0>(g, wg::desc_k<R>(cw, kk), wg::desc_k<R>(bj, kk));
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      wg::mma_ss<64, 0, 0>(m, wg::desc_k<R>(dy1, kk), wg::desc_k<R>(xj, kk));
      wg::mma_ss<64, 0, 0>(m, wg::desc_k<R>(dy2, kk), wg::desc_k<R>(xj, kk));
    }
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::hold(g);
    wg::hold(m);
#pragma unroll
    for (int i = 0; i < 32; ++i) {   // M = dG * L; rowsum(dG * G) = rowsum(M * (c b^T))
      const int r = (i % 4) / 2;
      const float l = decay(R * w + row_a + 8 * r, R * j + 8 * (i / 4) + col_a + i % 2);
      m[i] *= l;
      rowT[r] = fmaf(m[i], g[i], rowT[r]);
    }
    uint32_t f1[4][4], f2[4][4];   // dc += M b_j, M in three bf16 parts
    wg::peel_frags<4>(m, f1);
    wg::peel_frags<4>(m, f2);
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      wg::mma_rs_t<NN>(dc, f1[kk], wg::desc_mn<R>(bj, kk));
      wg::mma_rs_t<NN>(dc, f2[kk], wg::desc_mn<R>(bj, kk));
    }
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::hold(dc);
    wg::hold(f1);
    wg::hold(f2);
    wg::peel_frags<4>(m, f1);
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) wg::mma_rs_t<NN>(dc, f1[kk], wg::desc_mn<R>(bj, kk));
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::hold(dc);
    wg::hold(f1);
  }
  float dcs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) dcs[r] = quad_sum(rowT[r]) + e[r] * quad_sum(et[r]);
  float* dc0 = a.dc + bi * a.dcs.b + hi * a.dcs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = R * w + row_a + 8 * r;
    if (row >= nvalid) continue;
    float* dcr = dc0 + (long long)(t0 + row) * a.dcs.s;
#pragma unroll
    for (int j = 0; j < NN / 8; ++j) {
      const int n = 8 * j + col_a;
      if (n < N)
        *reinterpret_cast<float2*>(dcr + n) = make_float2(dc[4 * j + 2 * r], dc[4 * j + 2 * r + 1]);
    }
  }

  // ---- B: columns of slab w -------------------------------------------
  const uint32_t bw = OWN, xw = OWN + C::BT;   // own b, x
  const uint32_t y1 = STR + 2 * C::BT, y2 = y1 + C::XT, y3 = y2 + C::XT;   // dy in three parts
  const uint32_t DS = STR + C::BT;   // dS_out's two parts, over the second c tile and dy
  __syncthreads();   // pass A's readers are done with OWN and STR
  wg::load_tile<R, N, NN, 128>(bw, bk, a.bs.s, R * w, nvalid, tid);
  wg::load_tile<R, P, NP, 128>(xw, xk, a.xs.s, R * w, nvalid, tid);
  wg::load_tile<R, N, NN, 128>(STR, ck, a.cs.s, R * w, nvalid, tid);       // c_w
  wg::load_rows_f32<R, P, NP, 128>(STG, dyk, a.dys.s, R * w, nvalid, tid);  // dy_w
  wg::copy_bytes<2 * C::BT, 128>(DS, img + 2 * C::BT, tid);                 // dS_out
  wg::cp_async_commit();
  wg::cp_async_wait<0>();
  wg::fence_async_smem();
  __syncthreads();
  float dx[NP / 2], db[NN / 2];   // b dS^T and x dS first, then d-scaled, then + G^T dy, M^T c
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) dx[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NN / 2; ++i) db[i] = 0.f;
  wg::mma_fence();
#pragma unroll
  for (int kk = 0; kk < NN / 16; ++kk) {   // K = N; dS read K-major: its rows are P
    const uint64_t ab = wg::desc_k<R>(bw, kk);
    wg::mma_ss<NP, 0, 0>(dx, ab, wg::desc_k<R>(DS, kk));
    wg::mma_ss<NP, 0, 0>(dx, ab, wg::desc_k<R>(DS + C::BT, kk));
  }
#pragma unroll
  for (int kk = 0; kk < NP / 16; ++kk) {   // K = P; dS read MN-major
    const uint64_t ax = wg::desc_k<R>(xw, kk);
    wg::mma_ss<NN, 0, 1>(db, ax, wg::desc_mn<R>(DS, kk));
    wg::mma_ss<NN, 0, 1>(db, ax, wg::desc_mn<R>(DS + C::BT, kk));
  }
  wg::mma_commit();
  wg::mma_wait<0>();
  wg::hold(dx);
  wg::hold(db);
  float dd[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NN / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 4 * j + 2 * r;
      const float2 bv = wg::ld_pair(bw + wg::tile_off<R>(row_a + 8 * r, 8 * j + col_a));
      dd[r] = fmaf(bv.x, db[i], fmaf(bv.y, db[i + 1], dd[r]));
      db[i] *= d[r];
      db[i + 1] *= d[r];
    }
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) dx[i] *= d[(i % 4) / 2];

  float colT[2] = {0.f, 0.f};
  for (int it = w; it < nslab; ++it) {
    const uint32_t cis = STR + ((it - w) & 1) * C::BT;
    if (it > w) wg::cp_async_wait<0>();
    __syncthreads();   // tile it has landed; tile it - 1's (or dS's) readers are done
    wg::load_split<R, NP, NP, 128, 3>(y1, stg, NP, 0, R, tid, One());
    wg::fence_async_smem();
    __syncthreads();   // dy's parts are visible; the staging tile is free
    if (it + 1 < nslab) {
      wg::load_tile<R, N, NN, 128>(STR + ((it + 1 - w) & 1) * C::BT, ck, a.cs.s, R * (it + 1),
                                   nvalid, tid);
      wg::load_rows_f32<R, P, NP, 128>(STG, dyk, a.dys.s, R * (it + 1), nvalid, tid);
      wg::cp_async_commit();
    }
    float g[32], m[32];   // (c b^T)^T and (dy x^T)^T: rows of slab w, columns of slab it
#pragma unroll
    for (int i = 0; i < 32; ++i) g[i] = m[i] = 0.f;
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < NN / 16; ++kk)
      wg::mma_ss<64, 0, 0>(g, wg::desc_k<R>(bw, kk), wg::desc_k<R>(cis, kk));
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {   // dy's first two parts, as in pass A
      wg::mma_ss<64, 0, 0>(m, wg::desc_k<R>(xw, kk), wg::desc_k<R>(y1, kk));
      wg::mma_ss<64, 0, 0>(m, wg::desc_k<R>(xw, kk), wg::desc_k<R>(y2, kk));
    }
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::hold(g);
    wg::hold(m);
#pragma unroll
    for (int i = 0; i < 32; ++i) {   // G^T, M^T; colsum(dG * G) is a row sum here
      const int r = (i % 4) / 2;
      const float l = decay(R * it + 8 * (i / 4) + col_a + i % 2, R * w + row_a + 8 * r);
      m[i] *= l;
      colT[r] = fmaf(m[i], g[i], colT[r]);
      g[i] *= l;
    }
    // dx += G^T dy_i, G and dy in three parts (six products); db += M^T c_i,
    // M in three parts
    uint32_t f1[4][4], f2[4][4];
    wg::peel_frags<4>(g, f1);
    wg::peel_frags<4>(g, f2);
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      wg::mma_rs_t<NP>(dx, f1[kk], wg::desc_mn<R>(y1, kk));
      wg::mma_rs_t<NP>(dx, f1[kk], wg::desc_mn<R>(y2, kk));
      wg::mma_rs_t<NP>(dx, f1[kk], wg::desc_mn<R>(y3, kk));
      wg::mma_rs_t<NP>(dx, f2[kk], wg::desc_mn<R>(y1, kk));
      wg::mma_rs_t<NP>(dx, f2[kk], wg::desc_mn<R>(y2, kk));
    }
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::hold(dx);
    wg::hold(f1);
    wg::hold(f2);
    wg::peel_frags<4>(g, f1);
    wg::peel_frags<4>(m, f2);
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      wg::mma_rs_t<NP>(dx, f1[kk], wg::desc_mn<R>(y1, kk));
      wg::mma_rs_t<NN>(db, f2[kk], wg::desc_mn<R>(cis, kk));
    }
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::hold(dx);
    wg::hold(db);
    wg::hold(f1);
    wg::hold(f2);
    wg::peel_frags<4>(m, f1);
    wg::peel_frags<4>(m, f2);
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      wg::mma_rs_t<NN>(db, f1[kk], wg::desc_mn<R>(cis, kk));
      wg::mma_rs_t<NN>(db, f2[kk], wg::desc_mn<R>(cis, kk));
    }
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::hold(db);
    wg::hold(f1);
    wg::hold(f2);
  }

  float* dx0 = a.dx + bi * a.dxs.b + hi * a.dxs.h;
  float* db0 = a.db + bi * a.dbs.b + hi * a.dbs.h;
  float sterm = 0.f;   // sum of d dd over this slab's rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = R * w + row_a + 8 * r;
    const float ddr = quad_sum(dd[r]);
    dcs[r] -= quad_sum(colT[r]) + d[r] * ddr;
    if (row < Q && lane % 4 == 0) {
      z.dcsum[ci * Q + row] = dcs[r];
      sterm += d[r] * ddr;
    }
    if (row >= nvalid) continue;
    float* dxr = dx0 + (long long)(t0 + row) * a.dxs.s;
    float* dbr = db0 + (long long)(t0 + row) * a.dbs.s;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const int n = 8 * j + col_a;
      if (n < P)
        *reinterpret_cast<float2*>(dxr + n) = make_float2(dx[4 * j + 2 * r], dx[4 * j + 2 * r + 1]);
    }
#pragma unroll
    for (int j = 0; j < NN / 8; ++j) {
      const int n = 8 * j + col_a;
      if (n < N)
        *reinterpret_cast<float2*>(dbr + n) = make_float2(db[4 * j + 2 * r], db[4 * j + 2 * r + 1]);
    }
  }
  const float sterm_all = sum128(sterm, red);   // this slab's sum of d dd
  if (tid == 0) z.part[ci * 4 + w] = sterm_all;
}

// Phase 4, one block per chunk: ddA = the reverse cumsum of dcsum (float64,
// rounded once), with the last position's extra term alpha sum(dS_out S_in)
// + sum(d dd) added there, its partial sums taken in a fixed order.
__global__ void bwd_ddA_kernel(BwdArgs a, BwdScratch z, int nb) {
  __shared__ float v[QMAX];
  const int kc = blockIdx.x, bh = blockIdx.y, bi = bh / a.H, hi = bh % a.H;
  const int Q = a.Q, nc = (a.S + Q - 1) / Q, t0 = kc * Q, nvalid = min(Q, a.S - t0);
  const long long ci = (long long)bh * nc + kc;
  for (int i = threadIdx.x; i < Q; i += blockDim.x) v[i] = z.dcsum[ci * Q + i];
  __syncthreads();
  if (threadIdx.x == 0) {
    float sds = 0.f, sterm = 0.f;
    for (int k = 0; k < nb; ++k) sds += z.sds[ci * nb + k];
    for (int w = 0; w < (Q + R - 1) / R; ++w) sterm += z.part[ci * 4 + w];
    v[Q - 1] += expf(z.csum[ci * Q + Q - 1]) * sds + sterm;
  }
  __syncthreads();
  chunk_revsum(v, Q);
  float* dA0 = a.ddA + bi * a.das.b + hi * a.das.h + t0 * a.das.s;
  for (int i = threadIdx.x; i < nvalid; i += blockDim.x) dA0[(long long)i * a.das.s] = v[i];
}

template <int P, int N>
int launch_bwd_tc(const BwdArgs& a, const BwdScratch& z, int B, cudaStream_t stream) {
  using C = BwdTC<P, N>;
  const int nc = (a.S + a.Q - 1) / a.Q, nslab = (a.Q + R - 1) / R, BH = B * a.H;
  if (z.csum == nullptr || z.u == nullptr || z.img == nullptr || BH > 65535)
    return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)bwd_u_kernel<P, N>, C::U_SMEM);
  if (!err) err = set_smem((const void*)bwd_chunk_kernel<P, N>, C::SMEM);
  if (err) return err;
  bwd_u_kernel<P, N><<<dim3(nc, BH), 128, C::U_SMEM, stream>>>(a, z);
  const int nb = (P * N + 511) / 512;
  bwd_state_kernel<P, N><<<dim3(nb, BH), 128, 0, stream>>>(a, z);
  bwd_chunk_kernel<P, N><<<dim3(nslab, nc, BH), 128, C::SMEM, stream>>>(a, z);
  bwd_ddA_kernel<<<dim3(nc, BH), 128, 0, stream>>>(a, z, nb);
  return (int)cudaGetLastError();
}

}  // namespace ssd

// x (B,S,H,P) and b, c (B,S,H,N) in dtype; dA (B,S,H) f32; dy (B,S,H,P)
// f32; outputs dx (B,S,H,P), ddA (B,S,H), db, dc (B,S,H,N) f32, all
// strided; chunk_states (B,H,nc,P,N) and dstate (B,H,P,N) f32 contiguous.
// bf16 takes the chunk-parallel tensor-core kernels (x, b, c and dy
// 16-byte aligned with strides that are multiples of 16 bytes) and
// scratch: u_scr (B,H,nc,P,N) f32, img_scr of B H nc 4 (64 x max(N, 64))
// bf16 and rows_scr of B H nc (2 Q + 4 + ceil(P N / 512)) f32; f32 takes
// the reverse-walk FMA kernel and ignores all three.
extern "C" int ssd_bwd(int dtype, int P, int N, const void* x, const void* dA, const void* b,
                       const void* c, const void* chunk_states, const void* dy,
                       const void* dstate, void* dx, void* ddA, void* db, void* dc,
                       void* u_scr, void* img_scr, void* rows_scr, int B, int S, int H,
                       int Q,
                       long long xsb, long long xss, long long xsh, long long asb,
                       long long ass, long long ash, long long bsb, long long bss,
                       long long bsh, long long csb, long long css, long long csh,
                       long long dysb, long long dyss, long long dysh, long long dxsb,
                       long long dxss, long long dxsh, long long dasb, long long dass,
                       long long dash, long long dbsb, long long dbss, long long dbsh,
                       long long dcsb, long long dcss, long long dcsh, void* stream) {
  if (Q < 1 || Q > ssd::QMAX || S < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const ssd::BwdArgs a{x, (const float*)dA, b, c, (const float*)chunk_states,
                       (const float*)dy, (const float*)dstate, (float*)dx, (float*)ddA,
                       (float*)db, (float*)dc, H, S, Q,
                       {xsb, xss, xsh}, {asb, ass, ash}, {bsb, bss, bsh}, {csb, css, csh},
                       {dysb, dyss, dysh}, {dxsb, dxss, dxsh}, {dasb, dass, dash},
                       {dbsb, dbss, dbsh}, {dcsb, dcss, dcsh}};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    if (P == 64 && N == 128) return ssd::launch_bwd<float, 64, 128>(a, B, st);
    if (P == 16 && N == 16) return ssd::launch_bwd<float, 16, 16>(a, B, st);
  } else if (dtype == 1 && rows_scr != nullptr) {
    const long long rows = (long long)B * H * ((S + Q - 1) / Q);
    float* r = (float*)rows_scr;
    const ssd::BwdScratch z{r, (float*)u_scr, r + rows * Q, r + 2 * rows * Q,
                            r + 2 * rows * Q + 4 * rows, (uint8_t*)img_scr};
    if (P == 64 && N == 128) return ssd::launch_bwd_tc<64, 128>(a, z, B, st);
    if (P == 16 && N == 16) return ssd::launch_bwd_tc<16, 16>(a, z, B, st);
  }
  return (int)cudaErrorInvalidValue;
}
