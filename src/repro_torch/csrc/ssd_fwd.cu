// Mamba-2 SSD chunked scan, forward (entry ssd_fwd) and forward with the
// state entering each chunk (entry ssd_fwd_res).
//
// Replaces repro/kernels/ssd.py::_ssd_kernel (ssd_fwd_kernel_layout) and
// repro/kernels/ssd_bwd.py::_fwd_res_kernel (fwd_res_kernel_layout), whose
// TPU grid walked the chunks in order carrying the (P, N) state.  Per
// chunk, with csum = cumsum(dA), L[i,j] = exp(csum_i - csum_j) for i >= j,
// e = exp(csum) and d = exp(csum[-1] - csum):
//
//   y  = ((c b^T) * L) x + e * (c S^T)
//   S' = e[-1] S + x^T (b * d) = e[-1] S + (d x)^T b
//
// Bound: bytes.  At mamba2-2.7b's shape (B 2, S 2048, H 80, P 64, N 128,
// chunk 256, bf16 x/B/C, B and C one group) the products take about 27
// GFLOP (0.027 ms at 989 TFLOP/s), while x, dA, B, C, y (f32) and the
// state move 134 MB (0.0401 ms at 3.35 TB/s); ssd_fwd_res also writes the
// 42 MB of chunk states (176 MB, 0.0527 ms).
//
// bf16 (the main path): only the state crosses chunks, and the chunk's
// term of its recurrence does not depend on it, so the walk is split into
// three kernels, of which only the second is sequential over chunks, and
// it is elementwise (the SSD backward's split, run forwards):
//   1. fwd_u_kernel, a block (one warpgroup) per chunk: the chunk's csum
//      (float64 sums, rounded once) and its term of the recurrence,
//      U = (d x)^T b (P x N over the chunk's Q rows; A = (d x)^T, MN-major,
//      in three bf16 parts; B = b, MN-major).  The next slab's b and x
//      arrive by cp.async while the current one is in the tensor cores;
//   2. fwd_state_kernel, four state elements a thread: S_in[0] = 0,
//      S_in[k + 1] = e_k[-1] S_in[k] + U_k.  It writes each chunk's S_in as
//      two bf16 tile images (in the swizzled layout) that phase 3 copies as
//      they are, the f32 chunk states for ssd_fwd_res, and the final state;
//   3. fwd_chunk_kernel, a block (one warpgroup) per (64-row slab w, chunk,
//      b * h), the heaviest slabs launched first: y = e (c_w S_in^T) in the
//      accumulator, then for each column slab j <= w, G = (c_w b_j^T) * L in
//      registers (the diagonal tile masked), fed as a register A operand
//      in three bf16 parts against x_j (one group of twelve wgmmas).  Tile
//      j + 1's b and x arrive by cp.async while tile j is in the tensor
//      cores.  Three blocks share an SM; each tile still waits on its two
//      product groups, so the warpgroup idles while its G is built.
// Every product is a wgmma (m64nNk16, bf16 in, f32 accumulate; wgmma.cuh)
// from 128-byte-swizzled tiles.  c b^T and every product with x, b or c
// against a bf16 operand are exact; the f32 operands enter as bf16 parts,
// products summed into one accumulator: d x and G in three parts (in G x
// one term near the diagonal can dominate an element, so two parts would
// put y at 4.95e-6 of max|y| and the chunk states at 3.04e-6), S_in in two
// (analysis/ssd_split_error.py models the rounding: 6.96e-7 on y).  Every
// output has one owner and every sum a fixed order: no atomics,
// deterministic.  The wrapper allocates the scratch: csum, U and the S_in
// images.
//
// f32 (fwd_kernel): one block of 256 threads per (batch, head) walks the
// chunks in order with the (P, N) state in shared memory; each chunk is cut
// into 64-row slabs of c that visit only the 64-column tiles of b and x at
// or below the diagonal (the causal mask as loop bounds); f32 FMAs out of
// shared memory, which hold the f32 paths' tolerance that TF32 would not.
#include "ssd_common.cuh"
#include "wgmma.cuh"

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

// ---------------------------------------------------------------------------
// bf16: chunk-parallel, products on the tensor cores
// ---------------------------------------------------------------------------

struct FwdScratch {
  float* csum;    // (B*H, nc, Q): the chunk's cumsum of dA
  float* u;       // (B*H, nc, P, N): U of each chunk
  uint8_t* img;   // (B*H, nc, 2 parts): S_in as swizzled 64 x NN bf16 tiles
};

template <int P, int N>
struct FwdTC {
  static constexpr int NP = P < 64 ? 64 : P;   // tile widths: one swizzle row at least
  static constexpr int NN = N < 64 ? 64 : N;
  static constexpr int BT = R * NN * 2;        // a 64-row bf16 tile of b, c or a state
  static constexpr int XT = R * NP * 2;        // a 64-row bf16 tile of x
  static constexpr int STAGE = BT + XT;        // b and x of one slab
  static constexpr int XPARTS = 3;             // d x in U
  static constexpr int SPARTS = 2;             // S_in in c S_in^T
  // phase 3's streamed tiles: two stages of (b, x), S_in's parts over the
  // second
  static constexpr int STR = 2 * STAGE > STAGE + SPARTS * BT ? 2 * STAGE : STAGE + SPARTS * BT;
  static constexpr int SMEM = 1024 + BT + STR + 4 * QMAX;
  static constexpr int U_SMEM = 1024 + 2 * STAGE + XPARTS * XT + 4 * QMAX;
  static_assert(NP == 64 && NN <= 128, "one m64 tile of P rows, N up to 128");
};

// Phase 1, one block (128 threads) per chunk: csum, and the chunk's term
// of the recurrence U = (d x)^T b.
template <int P, int N>
__global__ void __launch_bounds__(128) fwd_u_kernel(FwdArgs a, FwdScratch z) {
  using C = FwdTC<P, N>;
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t S0 = (wg::smem_u32(smem_raw) + 1023) & ~1023u;   // two stages of (b, x)
  const uint32_t XD = S0 + 2 * C::STAGE;                           // d x in three parts
  uint8_t* base = smem_raw + (S0 - wg::smem_u32(smem_raw));
  float* cs = reinterpret_cast<float*>(base + 2 * C::STAGE + C::XPARTS * C::XT);

  const int kc = blockIdx.x, bh = blockIdx.y, bi = bh / a.H, hi = bh % a.H;
  const int Q = a.Q, nc = (a.S + Q - 1) / Q, t0 = kc * Q, nvalid = min(Q, a.S - t0);
  const int tid = threadIdx.x, lane = tid % 32;
  const int row_a = 16 * (tid / 32) + lane / 4, col_a = 2 * (lane % 4);
  const long long ci = (long long)bh * nc + kc;
  const float* dA0 = a.dA + bi * a.as.b + hi * a.as.h + t0 * a.as.s;
  const bf16* xk = (const bf16*)a.x + bi * a.xs.b + hi * a.xs.h + t0 * a.xs.s;
  const bf16* bk = (const bf16*)a.b + bi * a.bs.b + hi * a.bs.h + t0 * a.bs.s;

  wg::load_tile<R, N, C::NN, 128>(S0, bk, a.bs.s, 0, nvalid, tid);
  wg::load_tile<R, P, C::NP, 128>(S0 + C::BT, xk, a.xs.s, 0, nvalid, tid);
  wg::cp_async_commit();
  if constexpr (P < C::NP || N < C::NN) {
    // the padding of S_in's tile images for phase 3 (rows P .. 63, columns
    // N .. NN - 1); phase 2 writes the P x N elements
    uint8_t* img = z.img + ci * C::SPARTS * C::BT;
    for (int i = tid; i < R * C::NN / 2; i += 128) {
      const int r = i / (C::NN / 2), c = 2 * (i % (C::NN / 2));
      if (r >= P || c >= N) wg::put_parts<C::SPARTS>(img, C::BT, wg::tile_off<R>(r, c), 0.f, 0.f);
    }
  }
  for (int i = tid; i < Q; i += 128) cs[i] = i < nvalid ? dA0[(long long)i * a.as.s] : 0.f;
  __syncthreads();
  chunk_cumsum(cs, Q);
  const float last = cs[Q - 1];
  for (int i = tid; i < Q; i += 128) z.csum[ci * Q + i] = cs[i];
  __syncthreads();   // every thread has read cs; it becomes d
  for (int i = tid; i < Q; i += 128) cs[i] = expf(last - cs[i]);

  float u[C::NN / 2];
#pragma unroll
  for (int i = 0; i < C::NN / 2; ++i) u[i] = 0.f;
  for (int r0 = 0, st = 0; r0 < Q; r0 += R, st ^= 1) {
    const uint32_t bs = S0 + st * C::STAGE, xs = bs + C::BT;
    wg::cp_async_wait<0>();
    __syncthreads();   // this slab has landed (and d); the previous slab's products are done
    if (r0 + R < Q) {
      const uint32_t nx = S0 + (st ^ 1) * C::STAGE;
      wg::load_tile<R, N, C::NN, 128>(nx, bk, a.bs.s, r0 + R, nvalid, tid);
      wg::load_tile<R, P, C::NP, 128>(nx + C::BT, xk, a.xs.s, r0 + R, nvalid, tid);
      wg::cp_async_commit();
    }
    wg::split_tile<R, C::NP, 128, C::XPARTS>(
        XD, xs, tid, [&](int r) { return r0 + r < Q ? cs[r0 + r] : 0.f; });
    wg::fence_async_smem();
    __syncthreads();   // d x's parts are visible
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      const uint64_t db = wg::desc_mn<R>(bs, kk);
#pragma unroll
      for (int k = 0; k < C::XPARTS; ++k)
        wg::mma_ss<C::NN, 1, 1>(u, wg::desc_mn<R>(XD + k * C::XT, kk), db);
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
// block: the state pass S_in[0] = 0, S_in[k + 1] = e_k[-1] S_in[k] + U_k.
// Each S_in goes out as the two bf16 parts phase 3 reads (swizzled tile
// images) and, for ssd_fwd_res, as the f32 chunk state; S_in[nc] is the
// final state.  Eight chunks' U and e[-1] are loaded before any is used,
// so the loads overlap.
template <int P, int N>
__global__ void __launch_bounds__(128) fwd_state_kernel(FwdArgs a, FwdScratch z) {
  using C = FwdTC<P, N>;
  constexpr int PN = P * N, BATCH = 8;
  const int e = 4 * (blockIdx.x * 128 + threadIdx.x), bh = blockIdx.y;
  if (e >= PN) return;
  const int Q = a.Q, nc = (a.S + Q - 1) / Q;
  const uint32_t off = wg::tile_off<R>(e / N, e % N);   // e, e + 1; e + 2, e + 3 at off + 4
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < nc; k0 += BATCH) {
    float4 u[BATCH];
    float alpha[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const long long ci = (long long)bh * nc + min(k0 + j, nc - 1);
      u[j] = *reinterpret_cast<const float4*>(z.u + ci * PN + e);
      alpha[j] = expf(z.csum[ci * Q + Q - 1]);
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (k0 + j >= nc) break;
      const long long ci = (long long)bh * nc + k0 + j;
      uint8_t* img = z.img + ci * C::SPARTS * C::BT;
      wg::put_parts<C::SPARTS>(img, C::BT, off, carry.x, carry.y);
      wg::put_parts<C::SPARTS>(img, C::BT, off + 4, carry.z, carry.w);
      if (a.chunk_states != nullptr)
        *reinterpret_cast<float4*>(a.chunk_states + ci * PN + e) = carry;
      carry.x = alpha[j] * carry.x + u[j].x;
      carry.y = alpha[j] * carry.y + u[j].y;
      carry.z = alpha[j] * carry.z + u[j].z;
      carry.w = alpha[j] * carry.w + u[j].w;
    }
  }
  *reinterpret_cast<float4*>(a.state + (long long)bh * PN + e) = carry;
}

// Phase 3, one block (one warpgroup) per (64-row slab w, chunk, b * h): the
// rows of slab w of y (see the top of the file).  At most 168 registers,
// so three blocks share an SM (left alone, nvcc took 185 and two did, and
// the kernel ran slower).
template <int P, int N>
__global__ void __launch_bounds__(128, 3) fwd_chunk_kernel(FwdArgs a, FwdScratch z) {
  using C = FwdTC<P, N>;
  using bf16 = __nv_bfloat16;
  constexpr int NP = C::NP, NN = C::NN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t CW = (wg::smem_u32(smem_raw) + 1023) & ~1023u, STR = CW + C::BT;
  const uint32_t SIN = STR + C::STAGE;   // S_in's two parts, over the second stage
  uint8_t* base = smem_raw + (CW - wg::smem_u32(smem_raw));
  float* cs = reinterpret_cast<float*>(base + C::BT + C::STR);

  const int kc = blockIdx.x, bh = blockIdx.y, bi = bh / a.H, hi = bh % a.H;
  const int Q = a.Q, nc = (a.S + Q - 1) / Q, nslab = (Q + R - 1) / R;
  const int w = nslab - 1 - (int)blockIdx.z;   // the heaviest slabs first
  const int t0 = kc * Q, nvalid = min(Q, a.S - t0);
  const int tid = threadIdx.x, lane = tid % 32;
  const int row_a = 16 * (tid / 32) + lane / 4, col_a = 2 * (lane % 4);
  const long long ci = (long long)bh * nc + kc;
  const bf16* xk = (const bf16*)a.x + bi * a.xs.b + hi * a.xs.h + t0 * a.xs.s;
  const bf16* bk = (const bf16*)a.b + bi * a.bs.b + hi * a.bs.h + t0 * a.bs.s;
  const bf16* ck = (const bf16*)a.c + bi * a.cs.b + hi * a.cs.h + t0 * a.cs.s;

  wg::load_tile<R, N, NN, 128>(CW, ck, a.cs.s, R * w, nvalid, tid);          // c_w
  wg::load_tile<R, N, NN, 128>(STR, bk, a.bs.s, 0, nvalid, tid);             // b_0
  wg::load_tile<R, P, NP, 128>(STR + C::BT, xk, a.xs.s, 0, nvalid, tid);     // x_0
  wg::copy_bytes<C::SPARTS * C::BT, 128>(SIN, z.img + ci * C::SPARTS * C::BT, tid);
  wg::cp_async_commit();
  for (int i = tid; i < Q; i += 128) cs[i] = z.csum[ci * Q + i];
  wg::cp_async_wait<0>();
  wg::fence_async_smem();
  __syncthreads();
  auto decay = [&](int row, int col) {
    return (row >= col && row < Q) ? exp2f((cs[row] - cs[col]) * 1.4426950408889634f) : 0.f;
  };

  float y[NP / 2];   // c_w S_in^T (K = N; S_in read K-major: its rows are P), then e-scaled
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) y[i] = 0.f;
  wg::mma_fence();
#pragma unroll
  for (int kk = 0; kk < NN / 16; ++kk) {
    const uint64_t ac = wg::desc_k<R>(CW, kk);
#pragma unroll
    for (int k = 0; k < C::SPARTS; ++k) wg::mma_ss<NP, 0, 0>(y, ac, wg::desc_k<R>(SIN + k * C::BT, kk));
  }
  wg::mma_commit();
  wg::mma_wait<0>();
  wg::hold(y);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = R * w + row_a + 8 * r;
    const float e = row < Q ? expf(cs[row]) : 0.f;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      y[4 * j + 2 * r] *= e;
      y[4 * j + 2 * r + 1] *= e;
    }
  }

  for (int j = 0; j <= w; ++j) {
    const uint32_t bj = STR + (j & 1) * C::STAGE, xj = bj + C::BT;
    if (j > 0) {
      wg::cp_async_wait<0>();
      wg::fence_async_smem();
    }
    __syncthreads();   // tile j has landed; tile j - 1's (or S_in's) readers are done
    if (j < w) {
      const uint32_t bn = STR + ((j + 1) & 1) * C::STAGE;
      wg::load_tile<R, N, NN, 128>(bn, bk, a.bs.s, R * (j + 1), nvalid, tid);
      wg::load_tile<R, P, NP, 128>(bn + C::BT, xk, a.xs.s, R * (j + 1), nvalid, tid);
      wg::cp_async_commit();
    }
    float g[32];   // c b^T, rows of slab w, columns of slab j
#pragma unroll
    for (int i = 0; i < 32; ++i) g[i] = 0.f;
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < NN / 16; ++kk)
      wg::mma_ss<64, 0, 0>(g, wg::desc_k<R>(CW, kk), wg::desc_k<R>(bj, kk));
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::hold(g);
#pragma unroll
    for (int i = 0; i < 32; ++i)   // G = (c b^T) * L
      g[i] *= decay(R * w + row_a + 8 * ((i % 4) / 2), R * j + 8 * (i / 4) + col_a + i % 2);
    // y += G x_j, G in three parts
    uint32_t f1[4][4], f2[4][4], f3[4][4];
    wg::peel_frags<4>(g, f1);
    wg::peel_frags<4>(g, f2);
    wg::peel_frags<4>(g, f3);
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      const uint64_t bx = wg::desc_mn<R>(xj, kk);
      wg::mma_rs_t<NP>(y, f1[kk], bx);
      wg::mma_rs_t<NP>(y, f2[kk], bx);
      wg::mma_rs_t<NP>(y, f3[kk], bx);
    }
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::hold(y);
    wg::hold(f1);
    wg::hold(f2);
    wg::hold(f3);
  }

  float* y0 = a.y + bi * a.ys.b + hi * a.ys.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = R * w + row_a + 8 * r;
    if (row >= nvalid) continue;
    float* yr = y0 + (long long)(t0 + row) * a.ys.s;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const int p = 8 * j + col_a;
      if (p < P) *reinterpret_cast<float2*>(yr + p) = make_float2(y[4 * j + 2 * r], y[4 * j + 2 * r + 1]);
    }
  }
}

template <int P, int N>
int launch_fwd_tc(const FwdArgs& a, const FwdScratch& z, int B, cudaStream_t stream) {
  using C = FwdTC<P, N>;
  const int nc = (a.S + a.Q - 1) / a.Q, nslab = (a.Q + R - 1) / R, BH = B * a.H;
  if (z.csum == nullptr || z.u == nullptr || z.img == nullptr || BH > 65535)
    return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)fwd_u_kernel<P, N>, C::U_SMEM);
  if (!err) err = set_smem((const void*)fwd_chunk_kernel<P, N>, C::SMEM);
  if (err) return err;
  fwd_u_kernel<P, N><<<dim3(nc, BH), 128, C::U_SMEM, stream>>>(a, z);
  fwd_state_kernel<P, N><<<dim3((P * N + 511) / 512, BH), 128, 0, stream>>>(a, z);
  fwd_chunk_kernel<P, N><<<dim3(nc, BH, nslab), 128, C::SMEM, stream>>>(a, z);
  return (int)cudaGetLastError();
}

inline int fwd_entry(int dtype, int P, int N, const FwdArgs& a, void* u_scr, void* img_scr,
                     void* csum_scr, int B, bool res, cudaStream_t st) {
  if (a.Q < 1 || a.Q > QMAX || a.S < 1 || B < 1 || a.H < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (P == 64 && N == 128) return launch_fwd<float, 64, 128>(a, B, res, st);
    if (P == 16 && N == 16) return launch_fwd<float, 16, 16>(a, B, res, st);
  } else if (dtype == 1) {
    FwdArgs t = a;   // phase 2 writes chunk states where there are some
    if (!res) t.chunk_states = nullptr;
    const FwdScratch z{(float*)csum_scr, (float*)u_scr, (uint8_t*)img_scr};
    if (P == 64 && N == 128) return launch_fwd_tc<64, 128>(t, z, B, st);
    if (P == 16 && N == 16) return launch_fwd_tc<16, 16>(t, z, B, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace ssd

#define SSD_FWD_PARAMS                                                                    \
  int dtype, int P, int N, const void *x, const void *dA, const void *b, const void *c,  \
      void *y, void *state, void *chunk_states, void *u_scr, void *img_scr,              \
      void *csum_scr, int B, int S, int H, int Q, long long xsb, long long xss,          \
      long long xsh, long long asb, long long ass, long long ash, long long bsb,         \
      long long bss, long long bsh, long long csb, long long css, long long csh,         \
      long long ysb, long long yss, long long ysh, void *stream
#define SSD_FWD_ARGS                                                                      \
  ssd::FwdArgs{x, (const float*)dA, b, c, (float*)y, (float*)state, (float*)chunk_states, \
               H, S, Q, {xsb, xss, xsh}, {asb, ass, ash}, {bsb, bss, bsh},                \
               {csb, css, csh}, {ysb, yss, ysh}}

// x (B,S,H,P) and b, c (B,S,H,N) in dtype; dA (B,S,H) f32; y (B,S,H,P)
// f32, all strided; state (B,H,P,N) f32.  bf16 takes the chunk-parallel
// tensor-core kernels (x, b and c 16-byte aligned with strides that are
// multiples of 16 bytes) and scratch: u_scr (B,H,nc,P,N) f32, img_scr of
// B H nc 2 (64 x max(N, 64)) bf16 and csum_scr of B H nc Q f32; f32 takes
// the in-order FMA kernel and ignores all three.  chunk_states is ignored.
extern "C" int ssd_fwd(SSD_FWD_PARAMS) {
  return ssd::fwd_entry(dtype, P, N, SSD_FWD_ARGS, u_scr, img_scr, csum_scr, B, false,
                        (cudaStream_t)stream);
}

// As ssd_fwd, plus chunk_states (B,H,nc,P,N) f32, contiguous: the state
// entering each chunk.
extern "C" int ssd_fwd_res(SSD_FWD_PARAMS) {
  if (chunk_states == nullptr) return (int)cudaErrorInvalidValue;
  return ssd::fwd_entry(dtype, P, N, SSD_FWD_ARGS, u_scr, img_scr, csum_scr, B, true,
                        (cudaStream_t)stream);
}
