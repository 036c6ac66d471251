// Hopper building blocks of the bf16 tensor-core kernels (K1's flash
// attention, K2's forward and backward, K3's MLP tail), as inline PTX:
// 16-byte asynchronous copies into 128-byte-swizzled shared-memory tiles,
// tiles brought by the Tensor Memory Accelerator behind shared-memory
// barriers, the shared-memory matrix descriptor of `wgmma`, and the
// warpgroup matrix products.
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
// its own or, read MN-major with N across the atoms, by one descriptor that
// steps from atom to atom (`descriptor_across`); a width that is not a
// multiple of 64 is padded with zero columns (the tensor map's fill), which
// a product along the width skips k-step by k-step and a product across it
// computes and throws away.
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

// Asks for the 128-byte line at `p` to be brought into L2; nothing waits.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Shared-memory barriers (`mbarrier`, 8 bytes each) between a thread that
// asks the Tensor Memory Accelerator for tiles and the warpgroups that read
// them. A barrier's phase flips when its count of arrivals and its count of
// awaited bytes are both met; a wait names the parity of the phase it wants
// over: a new barrier is in phase 0, so waiting with parity 1 returns at once.
__device__ __forceinline__ void mbar_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}
// Makes the initialised barriers visible to the asynchronous proxy.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// One arrival, and `bytes` more to await from the copies that name the barrier.
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Spins until the phase of parity `parity` is over. A wait that would never
// end (a fault in the protocol) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (int spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins > (1 << 24)) __trap();
  }
}

// One box of a tensor map (a 64 x 64 bf16 box, written with the 128-byte
// swizzle of the tiles above; what lies outside the tensor arrives as
// zeros) from device memory into the tile at `dst`, by the Tensor Memory
// Accelerator: one thread asks, nothing waits, and the box's bytes are
// counted off `bar`. c0 is the box's first column, c1 its first row.
__device__ __forceinline__ void tma_load_box(uint32_t dst, const void* tensor_map, uint32_t bar,
                                             int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tensor_map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Hands registers between the warpgroups of a block whose roles differ: a
// warpgroup that needs few gives down to kRegs a thread, one that needs many
// takes up to kRegs (a multiple of 8; all four warps execute it together).
template <int kRegs>
__device__ __forceinline__ void give_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void take_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// A barrier among `threads` threads of the block (a multiple of 32), apart
// from __syncthreads' own: `id` in 1 .. 15.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrives at named barrier `id` without waiting: the other side of a
// hand-off waits there with named_barrier (`threads` counts both sides).
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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

// As wgmma_ss_n64 for a 64 x 32 product: d[4 j + 2 half + e], j < 4. A
// product that keeps half the registers of the 64-column one, for a
// warpgroup whose accumulators already fill most of its registers.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b,
                                             bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : HP_ACC8(d, 0), HP_ACC8(d, 8)
      : "l"(a), "l"(b), "r"(static_cast<int>(accumulate)), "n"(kTransA), "n"(kTransB));
}

// And for a 64 x 16 product: d[4 j + 2 half + e], j < 2.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t a, uint64_t b,
                                             bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n"
      "}\n"
      : HP_ACC8(d, 0)
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

// d (64 x kN, float32) += A B with A (64 x 16 bf16) from registers, as
// wgmma_rs_n64, and B a K-major tile of kN rows (128 bytes each, one after
// the other): one instruction for the whole width, so that a chain of
// k-steps is a few long instructions and not many short ones. d holds
// kN / 2 registers: d[4 j + 2 half + e] is row 16 warp + lane / 4 + 8 half,
// column 8 j + 2 (lane % 4) + e, j < kN / 8. kN: 64, 96, 128, 192 or 256.
template <int kN>
__device__ __forceinline__ void wgmma_rs_wide(float* d, const uint32_t* a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs_wide<64>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : HP_ACC8(d, 0), HP_ACC8(d, 8), HP_ACC8(d, 16), HP_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_wide<96>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n"
      "}\n"
      : HP_ACC8(d, 0), HP_ACC8(d, 8), HP_ACC8(d, 16), HP_ACC8(d, 24), HP_ACC8(d, 32), HP_ACC8(d, 40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_wide<128>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : HP_ACC8(d, 0), HP_ACC8(d, 8), HP_ACC8(d, 16), HP_ACC8(d, 24), HP_ACC8(d, 32), HP_ACC8(d, 40), HP_ACC8(d, 48), HP_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_wide<192>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n"
      "}\n"
      : HP_ACC8(d, 0), HP_ACC8(d, 8), HP_ACC8(d, 16), HP_ACC8(d, 24), HP_ACC8(d, 32), HP_ACC8(d, 40), HP_ACC8(d, 48), HP_ACC8(d, 56), HP_ACC8(d, 64), HP_ACC8(d, 72), HP_ACC8(d, 80), HP_ACC8(d, 88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_wide<256>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "
      "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : HP_ACC8(d, 0), HP_ACC8(d, 8), HP_ACC8(d, 16), HP_ACC8(d, 24), HP_ACC8(d, 32), HP_ACC8(d, 40), HP_ACC8(d, 48), HP_ACC8(d, 56), HP_ACC8(d, 64), HP_ACC8(d, 72), HP_ACC8(d, 80), HP_ACC8(d, 88), HP_ACC8(d, 96), HP_ACC8(d, 104), HP_ACC8(d, 112), HP_ACC8(d, 120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Matrix descriptor of a wide tile read MN-major as the B operand of a
// product whose N runs across the tile's atoms (wgmma_rs_across): as
// `descriptor`, with the leading-dimension offset set to the distance from
// one 64-column block of N to the next, kTileBytes.
__device__ __forceinline__ uint64_t descriptor_across(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(kTileBytes >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 x kN, float32) += A B with A (64 x 16 bf16) from registers, as
// wgmma_rs_wide, and B a wide tile read MN-major: its 16 rows of the k-step
// run along the inner dimension and its kN columns, atom after atom
// (descriptor_across), along N. The product across a row tile's width C of
// K2's backward (dh0 += da1 W1c, dW1c += da1^T h0, G^T += h1^T dout): one
// instruction as wide as C a k-step. kN: 64, 96, 128 or 192.
template <int kN>
__device__ __forceinline__ void wgmma_rs_across(float* d, const uint32_t* a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs_across<64>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HP_ACC8(d, 0), HP_ACC8(d, 8), HP_ACC8(d, 16), HP_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_across<96>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
      "%45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n"
      "}\n"
      : HP_ACC8(d, 0), HP_ACC8(d, 8), HP_ACC8(d, 16), HP_ACC8(d, 24), HP_ACC8(d, 32), HP_ACC8(d, 40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_across<128>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : HP_ACC8(d, 0), HP_ACC8(d, 8), HP_ACC8(d, 16), HP_ACC8(d, 24), HP_ACC8(d, 32), HP_ACC8(d, 40), HP_ACC8(d, 48), HP_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_across<192>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, "
      "%75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n"
      "}\n"
      : HP_ACC8(d, 0), HP_ACC8(d, 8), HP_ACC8(d, 16), HP_ACC8(d, 24), HP_ACC8(d, 32), HP_ACC8(d, 40), HP_ACC8(d, 48), HP_ACC8(d, 56), HP_ACC8(d, 64), HP_ACC8(d, 72), HP_ACC8(d, 80), HP_ACC8(d, 88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// acc (64 x 64) = A B^T over an inner dimension of 16 * steps columns, A and
// B wide tiles read K-major.
__device__ __forceinline__ void product_along_width(float (&acc)[32], uint32_t a, uint32_t b,
                                                    int steps) {
  for (int ks = 0; ks < steps; ++ks) {
    const uint32_t atom = (ks >> 2) * kTileBytes;
    wgmma_ss_n64<0, 0>(acc, descriptor(a + atom) + k_major_step(ks & 3),
                       descriptor(b + atom) + k_major_step(ks & 3), ks > 0);
  }
}

// One accumulator fragment to bf16 pairs, the A fragments of the next
// product: pairs[2 j + half] from value(i, j, half, e) of elements
// i = 4 j + 2 half + e, e in {0, 1}.
template <typename F>
__device__ __forceinline__ void to_fragments(uint32_t (&pairs)[16], F value) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 4 * j + 2 * half;
      pairs[2 * j + half] = pack_bf16(value(i, j, half, 0), value(i + 1, j, half, 1));
    }
}

}  // namespace hp
