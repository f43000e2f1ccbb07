// Mamba-2 SSD chunked scan, forward (entry ssd_fwd) and forward with the
// state entering each chunk (entry ssd_fwd_res): one templated kernel.
//
// Replaces repro/kernels/ssd.py::_ssd_kernel (ssd_fwd_kernel_layout) and
// repro/kernels/ssd_bwd.py::_fwd_res_kernel (fwd_res_kernel_layout).  Per
// chunk, with csum = cumsum(dA) and L[i,j] = exp(csum_i - csum_j), i >= j:
//
//   y  = ((c b^T) * L) x + exp(csum)[:,None] * (c S^T)
//   S' = exp(csum[-1]) S + x^T (b * exp(csum[-1] - csum)[:,None])
//
// The TPU kernel held the (Q, Q) chunk matrix whole in VMEM; at Q = 256 in
// f32 it is 256 KB, more than a Hopper block's 227 KB of shared memory.
// Here a chunk is cut into 64-row slabs of c; each slab visits only the
// 64-column tiles of b and x at or below the diagonal (the causal mask as
// loop bounds), builds its G tile from c, b and the csum vector, and
// accumulates G x in registers.  The (P, N) state stays in shared memory
// across the chunk loop; one block per (batch, head) walks the chunks in
// order.
//
// Bound: operations.  At B 2, S 2048, H 80, P 64, N 128, chunk 256 the
// scan does 2 (Q(Q+1)/2 (N + P) + 2 Q P N) flops per chunk, 27 GFLOP, and
// moves 86 MB; in f32 FMAs out of shared memory that is far from the
// tensor-core bound.  Tensor cores and chunk-parallel state passing (so
// more than B H = 160 blocks share the card's 132 SMs) are later work.
#include "ssd_common.cuh"

namespace ssd {

struct FwdArgs {
  const void* x;
  const float* dA;
  const void* b;
  const void* c;
  float* y;
  float* state;          // (B, H, P, N)
  float* chunk_states;   // (B, H, nc, P, N), written when RES
  int H, S, Q;
  Str xs, as, bs, cs, ys;
};

template <int P, int N>
constexpr int fwd_smem_floats() {
  return P * (N + 1) + QMAX + 2 * R * (N + 1) + R * (P + 1) + R * (R + 1);
}

template <typename T, int P, int N, bool RES>
__global__ void __launch_bounds__(NT) fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  float* st = smem;                    // [P][N + 1]   carried state
  float* cs = st + P * (N + 1);        // [QMAX]       csum of the chunk
  float* cw = cs + QMAX;               // [R][N + 1]   c rows of the slab
  float* bw = cw + R * (N + 1);        // [R][N + 1]   b rows of a tile
  float* xw = bw + R * (N + 1);        // [R][P + 1]   x rows of a tile
  float* gw = xw + R * (P + 1);        // [R][R + 1]   G tile

  const int bh = blockIdx.x, bi = bh / a.H, hi = bh % a.H;
  const int ty = tid_y(), tx = tid_x();
  const int Q = a.Q, nc = (a.S + Q - 1) / Q;
  const T* x0 = (const T*)a.x + bi * a.xs.b + hi * a.xs.h;
  const float* d0 = a.dA + bi * a.as.b + hi * a.as.h;
  const T* b0 = (const T*)a.b + bi * a.bs.b + hi * a.bs.h;
  const T* c0 = (const T*)a.c + bi * a.cs.b + hi * a.cs.h;
  float* y0 = a.y + bi * a.ys.b + hi * a.ys.h;

  for (int idx = threadIdx.x; idx < P * N; idx += NT) st[(idx / N) * (N + 1) + idx % N] = 0.f;
  __syncthreads();

  for (int k = 0; k < nc; ++k) {
    const int t0 = k * Q, nvalid = min(Q, a.S - t0);
    const T* xk = x0 + t0 * a.xs.s;
    const T* bk = b0 + t0 * a.bs.s;
    const T* ck = c0 + t0 * a.cs.s;
    if (RES) {
      float* out = a.chunk_states + ((long long)bh * nc + k) * P * N;
      for (int idx = threadIdx.x; idx < P * N; idx += NT)
        out[idx] = st[(idx / N) * (N + 1) + idx % N];
    }
    for (int i = threadIdx.x; i < Q; i += NT)
      cs[i] = i < nvalid ? d0[(long long)(t0 + i) * a.as.s] : 0.f;
    __syncthreads();
    chunk_cumsum(cs, Q);

    for (int r0 = 0; r0 < Q; r0 += R) {
      load_rows<N>(cw, N + 1, ck, a.cs.s, r0, nvalid, One());
      float acc[4][P / 16] = {};
      for (int j0 = 0; j0 <= r0; j0 += R) {
        load_rows<N>(bw, N + 1, bk, a.bs.s, j0, nvalid, One());
        load_rows<P>(xw, P + 1, xk, a.xs.s, j0, nvalid, One());
        __syncthreads();
        float g[4][4] = {};
        rowdot<4, N>(g, cw, N + 1, bw, N + 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = j0 + tx + 16 * j;
            const float l = (row >= col && row < Q) ? expf(cs[row] - cs[col]) : 0.f;
            gw[(ty + 16 * i) * (R + 1) + tx + 16 * j] = g[i][j] * l;
          }
        }
        __syncthreads();
        matacc<P / 16, R>(acc, gw, R + 1, xw, P + 1);
        __syncthreads();
      }
      // inter-chunk: y += exp(csum) * (c S^T)
      float inter[4][P / 16] = {};
      rowdot<P / 16, N>(inter, cw, N + 1, st, N + 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty + 16 * i;
        if (row >= nvalid) continue;
        const float e = expf(cs[row]);
        float* yr = y0 + (long long)(t0 + row) * a.ys.s;
#pragma unroll
        for (int j = 0; j < P / 16; ++j) yr[tx + 16 * j] = acc[i][j] + e * inter[i][j];
      }
      __syncthreads();
    }

    // S' = exp(csum[-1]) S + x^T (b * exp(csum[-1] - csum))
    const float last = cs[Q - 1];
    float upd[P / 16][N / 16] = {};
    for (int j0 = 0; j0 < Q; j0 += R) {
      load_rows<P>(xw, P + 1, xk, a.xs.s, j0, nvalid, One());
      load_rows<N>(bw, N + 1, bk, a.bs.s, j0, nvalid,
                   [&](int row) { return expf(last - cs[row]); });
      __syncthreads();
      outer_acc<P / 16, N / 16>(upd, xw, P + 1, bw, N + 1);
      __syncthreads();
    }
    const float alpha = expf(last);
#pragma unroll
    for (int i = 0; i < P / 16; ++i)
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        float* s = st + (ty + 16 * i) * (N + 1) + tx + 16 * j;
        *s = alpha * *s + upd[i][j];
      }
    __syncthreads();
  }

  float* out = a.state + (long long)bh * P * N;
  for (int idx = threadIdx.x; idx < P * N; idx += NT) out[idx] = st[(idx / N) * (N + 1) + idx % N];
}

template <typename T, int P, int N>
int launch_fwd(const FwdArgs& a, int B, bool res, cudaStream_t stream) {
  if (a.Q < 1 || a.Q > QMAX || a.S < 1 || B < 1 || a.H < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * fwd_smem_floats<P, N>();
  const void* kern = res ? (const void*)fwd_kernel<T, P, N, true>
                         : (const void*)fwd_kernel<T, P, N, false>;
  int err = set_smem(kern, smem);
  if (err) return err;
  if (res)
    fwd_kernel<T, P, N, true><<<B * a.H, NT, smem, stream>>>(a);
  else
    fwd_kernel<T, P, N, false><<<B * a.H, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

inline FwdArgs fwd_args(const void* x, const void* dA, const void* b, const void* c, void* y,
                        void* state, void* chunk_states, int H, int S, int Q, long long xsb,
                        long long xss, long long xsh, long long asb, long long ass,
                        long long ash, long long bsb, long long bss, long long bsh,
                        long long csb, long long css, long long csh, long long ysb,
                        long long yss, long long ysh) {
  return FwdArgs{x, (const float*)dA, b, c, (float*)y, (float*)state, (float*)chunk_states,
                 H, S, Q, {xsb, xss, xsh}, {asb, ass, ash}, {bsb, bss, bsh},
                 {csb, css, csh}, {ysb, yss, ysh}};
}

}  // namespace ssd

#define SSD_FWD_PARAMS                                                              \
  int dtype, int P, int N, const void *x, const void *dA, const void *b, const void *c, \
      void *y, void *state, void *chunk_states, int B, int S, int H, int Q, long long xsb, \
      long long xss, long long xsh, long long asb, long long ass, long long ash,         \
      long long bsb, long long bss, long long bsh, long long csb, long long css,         \
      long long csh, long long ysb, long long yss, long long ysh, void *stream
#define SSD_FWD_ARGS                                                                  \
  ssd::fwd_args(x, dA, b, c, y, state, chunk_states, H, S, Q, xsb, xss, xsh, asb, ass, \
                ash, bsb, bss, bsh, csb, css, csh, ysb, yss, ysh)

// x (B,S,H,P) and b, c (B,S,H,N) in dtype; dA (B,S,H) f32; y (B,S,H,P)
// f32, all strided; state (B,H,P,N) f32.  chunk_states is ignored.
extern "C" int ssd_fwd(SSD_FWD_PARAMS) {
  SSD_DISPATCH(dtype, P, N, ssd::launch_fwd, SSD_FWD_ARGS, B, false, (cudaStream_t)stream);
}

// As ssd_fwd, plus chunk_states (B,H,nc,P,N) f32: the state entering each
// chunk.
extern "C" int ssd_fwd_res(SSD_FWD_PARAMS) {
  if (chunk_states == nullptr) return (int)cudaErrorInvalidValue;
  SSD_DISPATCH(dtype, P, N, ssd::launch_fwd, SSD_FWD_ARGS, B, true, (cudaStream_t)stream);
}
