// Hopper building blocks of the bf16 tensor-core kernels (K1's flash
// attention, K2's backward), as inline PTX: 16-byte asynchronous copies into
// 128-byte-swizzled shared-memory tiles, the shared-memory matrix descriptor
// of `wgmma`, and the warpgroup matrix products.
//
// Every tile here has rows of 64 bf16 = 128 bytes, one swizzle atom: row r
// lies at byte r * 128 of a 1024-byte-aligned tile and its 16-byte chunk c
// at chunk position c ^ (r % 8). The same bytes serve both readings of a
// `wgmma` operand: "K-major" (the 64 values of a row run along the product's
// inner dimension) and, through the descriptor's transpose bit, "MN-major"
// (the rows run along the inner dimension, 16 rows a k-step). A tile may
// have any number of rows that is a multiple of eight. An operand wider
// than 64 columns (K2's C = 96 .. 192) is a "wide tile": 64-row atoms of 64
// columns side by side, kTileBytes apart, each addressed by a descriptor of
// its own; a width that is not a multiple of 64 is padded with zero columns
// (`load_wide_rows_async`), which a product along the width skips k-step by
// k-step and a product across it computes and throws away.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hp {

constexpr int kRowBytes = 128;             // 64 bf16
constexpr int kTileBytes = 64 * kRowBytes; // a 64-row tile
constexpr int kWarpgroup = 128;            // the four warps of one wgmma

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (0..7) of row r in a swizzled tile.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return static_cast<uint32_t>(r * kRowBytes + ((c ^ (r & 7)) << 4));
}

// 16 bytes global -> shared, asynchronously; zeros when `live` is false
// (the source is then not read, but must be a valid address).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool live) {
  const int bytes = live ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool live) {
  const int bytes = live ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Makes shared-memory writes made by the threads (cp.async and stores)
// visible to the asynchronous proxy through which wgmma reads its operands.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows r0 .. r0 + kRows - 1 of one head of a token-major operand (`base`
// points at row 0 of the head, rows `stride_n` elements apart, 64 bf16
// each) into a swizzled tile; rows past N arrive as zeros.
template <int kRows>
__device__ __forceinline__ void load_rows_async(uint32_t tile, const __nv_bfloat16* base,
                                                long long stride_n, int r0, int N) {
#pragma unroll
  for (int i = threadIdx.x; i < kRows * 8; i += kWarpgroup) {
    const int r = i >> 3;
    const int c = i & 7;
    const bool live = r0 + r < N;
    const __nv_bfloat16* src = base + (live ? r0 + r : 0) * stride_n + c * 8;
    cp_async_16(tile + swizzled(r, c), src, live);
  }
}

// Rows r0 .. r0 + 63 of a row-major (R, 8 * chunks) bf16 matrix, rows
// `stride` elements apart, into a wide tile of kAtoms atoms, by all the
// block's threads; rows past R and the 16-byte chunks past `chunks` arrive
// as zeros.
template <int kAtoms>
__device__ __forceinline__ void load_wide_rows_async(uint32_t tile, const __nv_bfloat16* base,
                                                     long long stride, long long r0,
                                                     long long R, int chunks) {
  constexpr int kPerRow = kAtoms * 8;
  for (int i = threadIdx.x; i < 64 * kPerRow; i += blockDim.x) {
    const int r = i / kPerRow;
    const int c = i % kPerRow;
    const bool live = r0 + r < R && c < chunks;
    const __nv_bfloat16* src = base + (live ? (r0 + r) * stride + c * 8 : 0);
    cp_async_16(tile + (c >> 3) * kTileBytes + swizzled(r, c & 7), src, live);
  }
}

// A 64 x 64 tile of bf16 pairs held as a wgmma accumulator fragment, written
// into a swizzled tile: `pairs[2 j + half]` holds columns 8 j + 2 (lane % 4)
// + {0, 1} of row 16 warp + lane / 4 + 8 half. No bank conflicts: the eight
// rows of a warp's store land on eight different chunk positions.
__device__ __forceinline__ void store_fragment(uint8_t* tile, const uint32_t (&pairs)[16]) {
  const int lane = threadIdx.x & 31;
  const int row = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half;
      *reinterpret_cast<uint32_t*>(tile + swizzled(r, j) + (lane & 3) * 4) =
          pairs[2 * j + half];
    }
}

// A swizzled 64 x 64 bf16 tile out to rows r0 .. r0 + 63 of a token-major
// operand, 16 bytes a store; rows past N are not written.
__device__ __forceinline__ void store_rows(const uint8_t* tile, __nv_bfloat16* base,
                                           long long stride_n, int r0, int N) {
#pragma unroll
  for (int i = threadIdx.x; i < 64 * 8; i += kWarpgroup) {
    const int r = i >> 3;
    const int c = i & 7;
    if (r0 + r < N)
      *reinterpret_cast<uint4*>(base + (r0 + r) * stride_n + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swizzled(r, c));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Matrix descriptor of a swizzled tile at shared address `addr` (1024-byte
// aligned): 128-byte swizzle, groups of eight rows 1024 bytes apart. The
// leading-dimension offset is not read for a tile one swizzle atom wide.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// What to add to a descriptor for k-step `ks` (16 values of the inner
// dimension): 32 bytes along a row when K-major, 16 rows when MN-major.
__device__ __forceinline__ uint64_t k_major_step(int ks) { return static_cast<uint64_t>(2 * ks); }
__device__ __forceinline__ uint64_t mn_major_step(int ks) {
  return static_cast<uint64_t>(16 * kRowBytes / 16 * ks);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Waits until all but the newest committed group have finished.
__device__ __forceinline__ void wgmma_wait_all_but_newest() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the point where its wgmma group is known to have finished.
template <int kN>
__device__ __forceinline__ void fence_registers(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define HP_ACC8(d, o)                                                                   \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),           \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define HP_REGS_0_31                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, float32) = or += A (64 x 16) B (16 x 64), both bf16 from
// shared memory. kTransA / kTransB: 0 for a K-major tile, 1 for MN-major.
// The accumulator fragment: d[4 j + 2 half + e] is row 16 warp + lane / 4 +
// 8 half, column 8 j + 2 (lane % 4) + e.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HP_REGS_0_31
      ", %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : HP_ACC8(d, 0), HP_ACC8(d, 8), HP_ACC8(d, 16), HP_ACC8(d, 24)
      : "l"(a), "l"(b), "r"(static_cast<int>(accumulate)), "n"(kTransA), "n"(kTransB));
}

// d (64 x 64) += A B with A (64 x 16 bf16) from registers: a[0..3] are, pair
// by pair, what two adjacent 8-column blocks of an accumulator fragment
// hold after the cast to bf16 (a[2 (j % 2) + half]). kTransB: 1 for an
// MN-major tile of B, 0 for a K-major one.
template <int kTransB = 1>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HP_REGS_0_31
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : HP_ACC8(d, 0), HP_ACC8(d, 8), HP_ACC8(d, 16), HP_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(kTransB));
}

}  // namespace hp
