// RG-LRU (Griffin) linear recurrence for Hopper: the scan and its reverse.
//
//   forward   h_t = a_t * h_{t-1} + b_t,            h_{-1} = 0
//   backward  lam_t = dy_t + a_{t+1} * lam_{t+1},   lam_S = 0
//             db_t = lam_t,  da_t = lam_t * h_{t-1}
//
// Replaces repro/kernels/rglru.py::_rglru_kernel (entry rglru_fwd) and
// repro/kernels/rglru_bwd.py::_rglru_bwd_kernel (entry rglru_bwd).  The
// TPU grid (B, W / 128, S / chunk) walked its chunk axis in order with the
// (1, 128) carry in VMEM scratch.  Here the chunks run in parallel and
// only the carry walks: a single-pass chained scan.
//
// Bound: bytes.  Each step is one multiply-add per channel against 12
// (forward) or 20 (backward) bytes of f32 traffic.  At recurrentgemma-2b's
// shape (B 2, S 2048, W 2560) the forward moves 125.8 MB (0.0376 ms at
// 3.35 TB/s) and the backward 209.7 MB (0.0626 ms).  The first port gave
// each (b, w) channel one thread that walked all S steps: 5120 channels
// made 80 blocks on 132 SMs, far too few bytes in flight to cover the
// memory latency (3.6x and 2.4x the bounds on an H100).
//
// Design.  A tile is (b, a strip of 32 channels, a chunk of Q = 128 steps),
// one block of 8 warps; warp j owns the chunk's steps 16 j .. 16 j + 15,
// lane l channel l of the strip, so every load and store of a warp is one
// 128-byte row.  At the main shape that is 2 x 80 x 16 = 2560 blocks.
//   1. Each thread loads its 16 steps into registers, all loads before any
//      arithmetic, and scans them from a zero carry: the affine map
//      h -> A h + H of its 16 steps (A the product of the a's).
//   2. The block combines the eight maps through shared memory, in warp
//      order, into the chunk's map (A_c, H_c) per channel.
//   3. One warp waits for the chunk before it in walk order to publish its
//      inclusive state, publishes A_c carry + H_c at once, and every
//      thread then enters its own carry and re-walks its 16 steps from the
//      registers, storing h.
// So a, b and h (the backward: a, h, dy, da and db) cross the bus once, as
// the bound counts them; a reduce-then-scan would read the inputs twice.
// The backward is the same tile walked in reverse chunk order on the map
// c -> a_t (dy_t + c) of c_t = a_t lam_t, so a chunk needs no a beyond its
// own; its one extra row is h_{t-1} at its first step (zero at t = 0),
// which no other warp of the chunk reads.
//
// Forward progress: a block takes its tile from an atomic ticket, in walk
// order (all tiles of a chunk before any of the next), never from
// blockIdx, so the tile it waits for belongs to a block that is already
// running.  Determinism: each tile combines only with its one predecessor,
// always in the same order, so two calls give the same bits (no look-back
// over aggregates, whose order would depend on timing).  The cumprod-and-
// divide closed form h = P cumsum(b / P) is never used: real gates drive
// a = exp(-8 softplus(-lam) r) to underflow, where it gives inf or NaN.
// The ticket, the flags and the carries are per-launch scratch that the
// wrapper zeroes, 33 x 4 bytes a tile (0.34 MB at the main shape).
//
// Measured on an H100 80GB HBM3 at 700 W at the main shape (chip_smoke.py,
// PERF.md): fwd_kernel 0.053-0.055 ms and bwd_kernel 0.080 ms of device
// time, 1.4x and 1.3x the bounds (the one-thread-a-channel kernels: 0.134
// and 0.148); at B 64, S 8192, W 512 (65536 tiles) 1.3-1.4x.  What holds
// the main shape above its bound is the chain and the edges of the grid:
// a tile's carry is ready one flag hand-off (a fence, an L2 round trip)
// after its predecessor's, 16 a strip, and the first and last chunks
// stream alone.  Tiles of 256 steps (32 steps a thread, or 16 warps) were
// slower (analysis/rglru_tiles.py).  nvcc -Xptxas -v (CUDA 12.8): 103
// registers forward, 109 backward, no spill.
//
// nvcc contracts a * h + b into one FMA, one rounding where the plain
// PyTorch version rounds the product and the sum, and the chunked
// association rounds otherwise than the sequential walk; the two agree to
// about 1e-7 of max|h|, far inside the 1e-5 the tests hold them to.
#include <climits>

#include "kernel_common.cuh"

namespace rglru {

// The tile of both kernels; PERF.md records the shapes tried.  Their
// __launch_bounds__(NT, 1) lets ptxas spend registers for one block an SM
// (103 and 109): on an H100 the forward took 0.060-0.062 ms where it took
// 0.066-0.067 at 80 registers without the 1 (analysis/rglru_tiles.py).
constexpr int LANES = 32;        // channels of a strip, one per lane
constexpr int L = 16;            // steps a thread owns
constexpr int NW = 8;            // warps a block
constexpr int Q = L * NW;        // steps a chunk
constexpr int NT = LANES * NW;   // threads a block

// One launch's chain state, in one zeroed buffer of 33 n + 1 words for n
// tiles: carry[n][32] (each tile's inclusive state per channel), flag[n]
// (1 once the carry is out), ticket (the next tile to hand out).
struct Chain {
  float* carry;
  unsigned* flag;
  unsigned* ticket;
};

struct Tiles {
  int S, W, strips, groups, chunks;   // groups: B x strips tiles a chunk
};

inline long long tile_count(int B, int S, int W) {
  return (long long)B * ((W + LANES - 1) / LANES) * ((S + Q - 1) / Q);
}

inline Chain chain_of(void* scratch, long long n) {
  float* base = (float*)scratch;
  return {base, (unsigned*)(base + LANES * n), (unsigned*)(base + (LANES + 1) * n)};
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The block's tile, from the ticket.
__device__ __forceinline__ int take_tile(const Chain& ch) {
  __shared__ int tile;
  if (threadIdx.x == 0) tile = (int)atomicAdd(ch.ticket, 1u);
  __syncthreads();
  return tile;
}

// The carry entering tile `tile` from the tile `pred` before it in walk
// order (0 when there is none), and this tile's inclusive state
// A_c carry + H_c published for the tile after it.  One warp, lane = channel.
__device__ __forceinline__ float hand_off(const Chain& ch, int tile, int pred, bool publish,
                                          float Ac, float Hc, int lane) {
  float carry = 0.f;
  if (pred >= 0) {
    while (ld_acquire(ch.flag + pred) == 0u) {
    }
    carry = __ldcg(ch.carry + (long long)pred * LANES + lane);
  }
  if (publish) {
    __stcg(ch.carry + (long long)tile * LANES + lane, fmaf(Ac, carry, Hc));
    __threadfence();
    __syncwarp();
    if (lane == 0) st_release(ch.flag + tile, 1u);
  }
  return carry;
}

__global__ void __launch_bounds__(NT, 1)
fwd_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ h,
           Tiles tl, Chain ch) {
  __shared__ float sA[NW][LANES], sH[NW][LANES], s_carry[LANES];
  const int tile = take_tile(ch);
  const int chunk = tile / tl.groups, g = tile - chunk * tl.groups;
  const int bi = g / tl.strips, strip = g - bi * tl.strips;
  const int warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int w = strip * LANES + lane, t0 = chunk * Q + warp * L;
  const long long base = ((long long)bi * tl.S + t0) * tl.W + w;
  // steps past S and channels past W are the identity (a 1, b 0)
  float av[L], bv[L];
#pragma unroll
  for (int u = 0; u < L; ++u) {
    const bool ok = w < tl.W && t0 + u < tl.S;
    av[u] = ok ? a[base + (long long)u * tl.W] : 1.f;
    bv[u] = ok ? b[base + (long long)u * tl.W] : 0.f;
  }
  float A = 1.f, H = 0.f;
#pragma unroll
  for (int u = 0; u < L; ++u) {
    H = fmaf(av[u], H, bv[u]);
    A *= av[u];
  }
  sA[warp][lane] = A;
  sH[warp][lane] = H;
  __syncthreads();
  // the map from the chunk's carry to this warp's: warps 0 .. warp - 1
  float PA = 1.f, PH = 0.f;
  for (int j = 0; j < warp; ++j) {
    PH = fmaf(sA[j][lane], PH, sH[j][lane]);
    PA *= sA[j][lane];
  }
  if (warp == 0) {
    float Ac = 1.f, Hc = 0.f;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      Hc = fmaf(sA[j][lane], Hc, sH[j][lane]);
      Ac *= sA[j][lane];
    }
    s_carry[lane] = hand_off(ch, tile, chunk > 0 ? tile - tl.groups : -1,
                             chunk + 1 < tl.chunks, Ac, Hc, lane);
  }
  __syncthreads();
  float hv = fmaf(PA, s_carry[lane], PH);
#pragma unroll
  for (int u = 0; u < L; ++u) {
    hv = fmaf(av[u], hv, bv[u]);
    if (w < tl.W && t0 + u < tl.S) h[base + (long long)u * tl.W] = hv;
  }
}

// c_t = a_t lam_t is what step t hands to step t - 1: lam_t = dy_t + c_{t+1}.
__global__ void __launch_bounds__(NT, 1)
bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
           const float* __restrict__ dy, float* __restrict__ da, float* __restrict__ db,
           Tiles tl, Chain ch) {
  __shared__ float sA[NW][LANES], sH[NW][LANES], s_carry[LANES];
  const int tile = take_tile(ch);
  const int walked = tile / tl.groups, g = tile - walked * tl.groups;
  const int chunk = tl.chunks - 1 - walked;
  const int bi = g / tl.strips, strip = g - bi * tl.strips;
  const int warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int w = strip * LANES + lane, t0 = chunk * Q + warp * L;
  const long long base = ((long long)bi * tl.S + t0) * tl.W + w;
  // steps past S and channels past W are the identity (a 1, dy 0)
  float av[L], dyv[L], hp[L];
#pragma unroll
  for (int u = 0; u < L; ++u) {
    const bool ok = w < tl.W && t0 + u < tl.S;
    const long long i = base + (long long)u * tl.W;
    av[u] = ok ? a[i] : 1.f;
    dyv[u] = ok ? dy[i] : 0.f;
    hp[u] = ok && t0 + u > 0 ? h[i - tl.W] : 0.f;
  }
  float A = 1.f, H = 0.f;
#pragma unroll
  for (int u = L - 1; u >= 0; --u) {
    H = av[u] * (dyv[u] + H);
    A *= av[u];
  }
  sA[warp][lane] = A;
  sH[warp][lane] = H;
  __syncthreads();
  // the map from the chunk's carry to this warp's: warps NW - 1 .. warp + 1
  float PA = 1.f, PH = 0.f;
  for (int j = NW - 1; j > warp; --j) {
    PH = fmaf(sA[j][lane], PH, sH[j][lane]);
    PA *= sA[j][lane];
  }
  if (warp == NW - 1) {
    float Ac = 1.f, Hc = 0.f;
#pragma unroll
    for (int j = NW - 1; j >= 0; --j) {
      Hc = fmaf(sA[j][lane], Hc, sH[j][lane]);
      Ac *= sA[j][lane];
    }
    s_carry[lane] = hand_off(ch, tile, walked > 0 ? tile - tl.groups : -1, chunk > 0, Ac, Hc,
                             lane);
  }
  __syncthreads();
  float c = fmaf(PA, s_carry[lane], PH);
#pragma unroll
  for (int u = L - 1; u >= 0; --u) {
    const float lam = dyv[u] + c;
    if (w < tl.W && t0 + u < tl.S) {
      const long long i = base + (long long)u * tl.W;
      db[i] = lam;
      da[i] = lam * hp[u];
    }
    c = av[u] * lam;
  }
}

inline bool shape_ok(int B, int S, int W) {
  return B >= 1 && S >= 1 && W >= 1 && tile_count(B, S, W) <= INT_MAX / (LANES + 1);
}

inline Tiles tiles_of(int B, int S, int W) {
  const int strips = (W + LANES - 1) / LANES;
  return {S, W, strips, B * strips, (S + Q - 1) / Q};
}

}  // namespace rglru

// Words (4 bytes each) of the zeroed scratch rglru_fwd and rglru_bwd take
// at this shape; -1 for a shape they refuse.
extern "C" int rglru_scratch_words(int B, int S, int W) {
  if (!rglru::shape_ok(B, S, W)) return -1;
  return (int)((rglru::LANES + 1) * rglru::tile_count(B, S, W) + 1);
}

// a, b, h: (B, S, W) f32 contiguous; scratch: rglru_scratch_words zeroed words.
extern "C" int rglru_fwd(const void* a, const void* b, void* h, void* scratch, int B, int S,
                         int W, void* stream) {
  if (!rglru::shape_ok(B, S, W)) return (int)cudaErrorInvalidValue;
  const long long n = rglru::tile_count(B, S, W);
  rglru::fwd_kernel<<<(unsigned)n, rglru::NT, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)h, rglru::tiles_of(B, S, W),
      rglru::chain_of(scratch, n));
  return (int)cudaGetLastError();
}

// a, h (the forward's output), dy, da, db: (B, S, W) f32 contiguous;
// scratch: rglru_scratch_words zeroed words.
extern "C" int rglru_bwd(const void* a, const void* h, const void* dy, void* da, void* db,
                         void* scratch, int B, int S, int W, void* stream) {
  if (!rglru::shape_ok(B, S, W)) return (int)cudaErrorInvalidValue;
  const long long n = rglru::tile_count(B, S, W);
  rglru::bwd_kernel<<<(unsigned)n, rglru::NT, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)h, (const float*)dy, (float*)da, (float*)db,
      rglru::tiles_of(B, S, W), rglru::chain_of(scratch, n));
  return (int)cudaGetLastError();
}
