// Hopper (sm_90a) building blocks of the tensor-core kernels (flash
// forward, dq and dkv; the SSD forward and backward): cp.async copies into
// 128-byte-swizzled tiles, wgmma shared-memory descriptors, the wgmma
// instructions themselves, and the fences that order them.
//
// Tile layout.  A (ROWS x DP) bf16 tile, DP a multiple of 64, is stored
// as DP / 64 column blocks of ROWS rows x 128 bytes; in a block, the
// 16-byte chunk c (columns 8c .. 8c + 7) of row r sits at chunk c ^ (r % 8)
// of its row (the 128-byte swizzle, which the tile's 1024-byte alignment
// lets the hardware undo).  The same bytes serve two descriptors:
//   K-major (the reduction runs along the row, e.g. Q in S = Q K^T):
//     start = block + (k % 4) * 32 bytes for k-step k (16 columns),
//     stride between 8-row groups (SBO) 1024 bytes;
//   MN-major (the reduction runs down the rows, e.g. V in O = P V):
//     start = tile + k * 2048 bytes (16 rows), SBO 1024 bytes between
//     8-row groups, LBO ROWS * 128 bytes between 64-column blocks.
// bf16 takes either for both operands: an A tile read MN-major is the
// transpose of what it stores (the SSD backward's (e dy)^T).
//
// f32 operands.  A product whose operand is f32 takes it as bf16 parts,
// x = p1 + p2 (+ p3), part k the bf16 of what parts 1 .. k-1 leave, and
// sums the products of the parts into one accumulator: in shared memory
// from load_split (f32 rows) or split_tile (a bf16 tile times a row
// scale), in device memory as tile images from put_parts, in registers
// from peel_frags.
//
// Fragments.  The f32 accumulator of an m64nN wgmma gives thread t of the
// warpgroup (warp w = t / 32, lane l = t % 32) the N / 2 values
// d[4 j + i]: row 16 w + l / 4 + 8 (i / 2), column 8 j + 2 (l % 4) + i % 2.
// A register A operand (m64k16, bf16) has the same rows and columns for
// the 16 columns of one k-step, so an accumulator converts to A operands
// in place (peel_frags).
//
// PTX needs every accumulator register named in the instruction, hence
// the long operand lists of the mma_* functions.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes < 16 zero-fills the rest (0: all zero).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// 4-byte async copy, zero-filled when src_bytes is 0.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Make this thread's shared-memory writes (plain or cp.async) visible to
// the async proxy that wgmma reads through; a barrier follows.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Registers an in-flight wgmma reads or writes: after mma_wait, this keeps
// the compiler from touching them earlier or reusing them meanwhile.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}
// k-step k of a K-major tile of ROWS rows (see the layout note above).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int k) {
  return desc(tile + (k / 4) * (ROWS * 128) + (k % 4) * 32, 16, 1024);
}
// k-step k of an MN-major tile of ROWS rows, from 64-column block cb on.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int k, int cb = 0) {
  return desc(tile + cb * (ROWS * 128) + k * 2048, ROWS * 128, 1024);
}

// Rows [row0, row0 + ROWS) of a (rows, D) bf16 slice with row stride ss
// (elements) into a swizzled (ROWS x DP) tile, by NTHREADS threads; rows at
// or past nrows and columns at or past D read as zero.  Needs a 16-byte
// aligned slice and ss a multiple of 8.
template <int ROWS, int D, int DP, int NTHREADS>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* src,
                                          long long ss, int row0, int nrows, int tid) {
  constexpr int CPR = DP / 8;   // 16-byte chunks a row
  static_assert((ROWS * CPR) % NTHREADS == 0, "tile chunks must divide over the threads");
#pragma unroll
  for (int n = 0; n < ROWS * CPR / NTHREADS; ++n) {
    const int i = tid + n * NTHREADS, r = i / CPR, c = i % CPR;
    const uint32_t dst = tile + (c / 8) * (ROWS * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4);
    const bool ok = row0 + r < nrows && c * 8 < D;
    cp_async16(dst, ok ? src + (long long)(row0 + r) * ss + c * 8 : src, ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of element (r, c) in a swizzled tile of ROWS rows.
template <int ROWS>
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  return (c / 64) * (ROWS * 128) + r * 128 + ((((c % 64) / 8) ^ (r % 8)) << 4) + (c % 8) * 2;
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
// Elements (r, c) and (r, c + 1), c even, of a swizzled bf16 tile.
__device__ __forceinline__ float2 ld_pair(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// BYTES contiguous bytes (a multiple of 16, 16-byte aligned) by cp.async:
// a tile image written in the swizzled layout lands as that tile.
template <int BYTES, int NTHREADS>
__device__ __forceinline__ void copy_bytes(uint32_t dst, const void* src, int tid) {
  static_assert(BYTES % (16 * NTHREADS) == 0, "16-byte chunks must divide over the threads");
#pragma unroll 4
  for (int i = tid; i < BYTES / 16; i += NTHREADS)
    cp_async16(dst + 16 * i, static_cast<const uint8_t*>(src) + 16 * i, 16);
}

// Rows [row0, row0 + ROWS) of a (rows, W) f32 slice with row stride ss
// into a plain row-major (ROWS x WP) f32 staging tile by cp.async; rows at
// or past nrows and columns at or past W read as zero.  Needs 16-byte
// aligned rows and W a multiple of 4.
template <int ROWS, int W, int WP, int NTHREADS>
__device__ __forceinline__ void load_rows_f32(uint32_t dst, const float* src, long long ss,
                                              int row0, int nrows, int tid) {
  constexpr int CPR = WP / 4;   // 16-byte chunks a row
  static_assert((ROWS * CPR) % NTHREADS == 0, "tile chunks must divide over the threads");
#pragma unroll
  for (int n = 0; n < ROWS * CPR / NTHREADS; ++n) {
    const int i = tid + n * NTHREADS, r = i / CPR, c = 4 * (i % CPR);
    const bool ok = row0 + r < nrows && c < W;
    cp_async16(dst + (r * WP + c) * 4, ok ? src + (long long)(row0 + r) * ss + c : src,
               ok ? 16 : 0);
  }
}

// Rows [row0, row0 + ROWS) of a (rows, W) f32 slice with row stride ss,
// each row times scale(row), into PARTS consecutive swizzled (ROWS x WP)
// bf16 tiles from `tiles` on: part 0 = bf16(x), part k = bf16 of what
// parts 0 .. k - 1 leave, so two parts hold x to about 16 bits and three
// to about 24.  Rows at or past nrows and columns at or past W are zero.
// Needs 8-byte aligned rows; plain stores, so fence_async_smem and a
// barrier follow before a wgmma reads the tiles.
template <int ROWS, int W, int WP, int NTHREADS, int PARTS, typename Scale>
__device__ __forceinline__ void load_split(uint32_t tiles, const float* src, long long ss,
                                           int row0, int nrows, int tid, Scale scale) {
  constexpr int PPR = WP / 2;   // column pairs a row
#pragma unroll 4
  for (int i = tid; i < ROWS * PPR; i += NTHREADS) {
    const int r = i / PPR, c = 2 * (i % PPR);
    float2 x = make_float2(0.f, 0.f);
    if (row0 + r < nrows && c < W) {
      x = *reinterpret_cast<const float2*>(src + (long long)(row0 + r) * ss + c);
      const float f = scale(row0 + r);
      x.x *= f;
      x.y *= f;
    }
    const uint32_t off = tile_off<ROWS>(r, c);
#pragma unroll
    for (int k = 0; k < PARTS; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
      st_shared(tiles + k * (ROWS * WP * 2) + off, *reinterpret_cast<const uint32_t*>(&h));
      x.x -= __low2float(h);
      x.y -= __high2float(h);
    }
  }
}

// The swizzled (ROWS x WP) bf16 tile at src, each row r times scale(r),
// into PARTS consecutive tiles of the same layout from dst on, split as
// load_split splits.  Plain stores, so fence_async_smem and a barrier
// follow before a wgmma reads the parts.
template <int ROWS, int WP, int NTHREADS, int PARTS, typename Scale>
__device__ __forceinline__ void split_tile(uint32_t dst, uint32_t src, int tid, Scale scale) {
  constexpr int PPR = WP / 2;   // column pairs a row
#pragma unroll 4
  for (int i = tid; i < ROWS * PPR; i += NTHREADS) {
    const int r = i / PPR;
    const uint32_t off = tile_off<ROWS>(r, 2 * (i % PPR));
    float2 x = ld_pair(src + off);
    const float f = scale(r);
    x.x *= f;
    x.y *= f;
#pragma unroll
    for (int k = 0; k < PARTS; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
      st_shared(dst + k * (ROWS * WP * 2) + off, *reinterpret_cast<const uint32_t*>(&h));
      x.x -= __low2float(h);
      x.y -= __high2float(h);
    }
  }
}

// (x0, x1) as PARTS bf16 parts, split as load_split splits, into tile
// images in device memory `stride` bytes apart, at byte offset off of
// each: images that a block later copies into shared memory as they are.
template <int PARTS>
__device__ __forceinline__ void put_parts(uint8_t* img, int stride, uint32_t off, float x0,
                                          float x1) {
#pragma unroll
  for (int k = 0; k < PARTS; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    *reinterpret_cast<__nv_bfloat162*>(img + k * stride + off) = h;
    x0 -= __low2float(h);
    x1 -= __high2float(h);
  }
}

// Peel one bf16 part off an m64n(16 K) f32 accumulator: f = bf16(d) as K
// register A operands of m64k16 products, and d -= f.  Called two or
// three times, it splits d into parts as load_split does.
template <int K>
__device__ __forceinline__ void peel_frags(float (&d)[8 * K], uint32_t (&f)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float& x0 = d[8 * k + 2 * r];
      float& x1 = d[8 * k + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      f[k][r] = *reinterpret_cast<const uint32_t*>(&h);
      x0 -= __low2float(h);
      x1 -= __high2float(h);
    }
}

// D (64 x N, f32) = D * scale_d + A (64 x 16) B (16 x N); A and B bf16 in
// shared memory through descriptors.  TA, TB: 0 K-major, 1 MN-major
// (transposed; bf16 takes either for both operands).
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA = 0, int TB = 0>
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x N) += A (64 x 16) B (16 x N), both from shared memory, for N = 64
// or 128.
template <int N, int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 64) mma_ss_n64<TA, TB>(d, da, db, 1);
  else mma_ss_n128<TA, TB>(d, da, db, 1);
}

// D (64 x 64, f32) += A (64 x 16) B (16 x 64); A bf16 in registers (the
// accumulator layout, two values a register), B bf16 in shared memory
// through a descriptor, MN-major (transposed).
__device__ __forceinline__ void mma_rs_n64_t(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16) B (16 x 128); A bf16 in registers (the
// accumulator layout, two values a register), B bf16 in shared memory
// through a descriptor, MN-major (transposed).
__device__ __forceinline__ void mma_rs_n128_t(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, f32) += A (64 x 16) B (16 x 256); A bf16 in registers (the
// accumulator layout, two values a register), B bf16 in shared memory
// through a descriptor, MN-major (transposed).
__device__ __forceinline__ void mma_rs_n256_t(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
      "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, "
      "%102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
        "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x N) += A (64 x 16, registers) B (16 x N, MN-major) for N = 64,
// 128, 256.
template <int N>
__device__ __forceinline__ void mma_rs_t(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void mma_rs_t<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  mma_rs_n64_t(d, a, db);
}
template <>
__device__ __forceinline__ void mma_rs_t<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  mma_rs_n128_t(d, a, db);
}
template <>
__device__ __forceinline__ void mma_rs_t<256>(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  mma_rs_n256_t(d, a, db);
}

}  // namespace wg
