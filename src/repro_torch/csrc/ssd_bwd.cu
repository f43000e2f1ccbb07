// Mamba-2 SSD chunked scan, backward: reverse-chunk walk carrying the
// state adjoint dS (entry ssd_bwd).
//
// Replaces repro/kernels/ssd_bwd.py::_bwd_kernel (bwd_kernel_layout).  Per
// chunk, with e = exp(csum), alpha = e[-1], d = exp(csum[-1] - csum),
// G = (c b^T) * L, the state S_in entering the chunk (from the forward's
// chunk_states) and the adjoint dS of the state leaving it:
//
//   dx = G^T dy + d (b dS^T)         dc = M b + e (dy S_in),  M = (dy x^T) * L
//   db = M^T c + d (x dS)            dS <- alpha dS + (e dy)^T c
//   dcsum = rowsum(dG G) - colsum(dG G) + e rowsum(c (dy S_in)) - d dd,
//   dd = rowsum(b (x dS));  dcsum[-1] += alpha sum(dS S_in) + sum(d dd);
//   ddA = reverse cumsum of dcsum (float64, rounded once).
//
// The TPU kernel formed the (Q, Q) matrices whole; here, as in the flash
// dq / dkv split, each chunk takes two passes over 64-row slabs:
//   A. row slabs of (c, dy) against the column tiles at or below the
//      diagonal: dc, rowsum(dG G) and the e term;
//   B. column slabs of (b, x) against the row tiles at or above it: dx,
//      db, colsum(dG G) and dd.  The tile is built transposed, so the
//      column sums are row reductions and G^T, M^T land in shared memory
//      in the layout the products read.
// Then pass C streams (e dy, c) into the new dS.  G and dG are rebuilt in
// each pass from the operands and the csum vector.  S_in and the dS carry
// (32 KB each at P 64, N 128) stay in shared memory; every output has one
// owner, so there are no atomics and the result is deterministic.
//
// Bound: operations (about 3x the forward's, 80 GFLOP at the main-path
// shape); f32 FMAs out of shared memory, far from the tensor-core bound.
#include "ssd_common.cuh"

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

}  // namespace ssd

// x (B,S,H,P) and b, c (B,S,H,N) in dtype; dA (B,S,H) f32; dy (B,S,H,P)
// f32; outputs dx (B,S,H,P), ddA (B,S,H), db, dc (B,S,H,N) f32, all
// strided; chunk_states (B,H,nc,P,N) and dstate (B,H,P,N) f32 contiguous.
extern "C" int ssd_bwd(int dtype, int P, int N, const void* x, const void* dA, const void* b,
                       const void* c, const void* chunk_states, const void* dy,
                       const void* dstate, void* dx, void* ddA, void* db, void* dc, int B,
                       int S, int H, int Q, long long xsb, long long xss, long long xsh,
                       long long asb, long long ass, long long ash, long long bsb,
                       long long bss, long long bsh, long long csb, long long css,
                       long long csh, long long dysb, long long dyss, long long dysh,
                       long long dxsb, long long dxss, long long dxsh, long long dasb,
                       long long dass, long long dash, long long dbsb, long long dbss,
                       long long dbsh, long long dcsb, long long dcss, long long dcsh,
                       void* stream) {
  const ssd::BwdArgs a{x, (const float*)dA, b, c, (const float*)chunk_states,
                       (const float*)dy, (const float*)dstate, (float*)dx, (float*)ddA,
                       (float*)db, (float*)dc, H, S, Q,
                       {xsb, xss, xsh}, {asb, ass, ash}, {bsb, bss, bsh}, {csb, css, csh},
                       {dysb, dyss, dysh}, {dxsb, dxss, dxsh}, {dasb, dass, dash},
                       {dbsb, dbss, dbsh}, {dcsb, dcss, dcsh}};
  SSD_DISPATCH(dtype, P, N, ssd::launch_bwd, a, B, (cudaStream_t)stream);
}
