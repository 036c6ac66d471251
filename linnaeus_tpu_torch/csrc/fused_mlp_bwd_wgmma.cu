// K2 backward in bfloat16 on the tensor cores: the eight gradients of
//   out = (GELU(LN(y) W1^T + b1) W2^T + b2) * gamma
// with the rounding points of fused_mlp_bwd.cu (which keeps float32 and the
// widths this route does not take on the CUDA cores): h0 = LN(y), h1 and
// da1 rounded to bf16, d2 = dout * gamma rounded to bf16 before the product
// it enters, every product accumulated in float32, every vector gradient
// summed from unrounded values.
//
// Replaces the Pallas kernel linnaeus_tpu/ops/fused_mlp.py `_bwd_kernel`
// (launched by `_pallas_bwd`) for bfloat16 operands with C a multiple of 32
// up to 192 and Hd a multiple of 64 (`lt::mlp_bwd_takes_wgmma`).
//
// What bounds it on the H100: operations. The least work is six products
// of M x C x Hd multiply-adds (`benchmark/roofline.py::k2_bound`: the
// forward's a1 and a2 again, dh1, da1 W1, dW1, dW2), 12 M C Hd operations
// against 3 M C elements moved, beside 3 M Hd evaluations of GELU or its
// derivative, which at C = 96 take about as many instruction slots as the
// products take tensor-core time.
//
// Products per 64-row tile and 64-column hidden chunk: five of that size
// against the bound's six, seven run in all, none twice within a pass.
//   - a2 is not computed. dgamma = sum_r dout (a2 + b2) is reached through
//     G = dout^T h1 (float32): dW2 = diag(gamma) G and
//     dgamma_c = sum_j W2[c, j] G[c, j] + b2_c sum_r dout[r, c], exact
//     rearrangements of the same sums. G's product takes dW2's place; the
//     rounding of d2 enters dh1 alone, no longer dW2.
//   - a1 and dh1 run once in each pass. One pass holding both a row tile's
//     dh0 and a chunk's dW1 and G would keep 2 Hd C float32 a block over
//     the rows; storing h1 and da1 for the second pass would move 8 M Hd
//     bytes, three to six times the two recomputed products' least time at
//     the model's widths.
//
// The kernels, launched in order on the caller's stream:
//
//   0. `mlp_bwd_prologue_kernel`, half a warp or a warp a row: h0 = round(LN(y)) and
//      d2 = round(dout * gamma) once, as bf16 (M, C) in the workspace, with
//      the rows' mean and rstd, so that both passes take their row tiles
//      whole from the Tensor Memory Accelerator. In training under drop
//      path it first writes ds = round(s * dout) (s the row's sample's
//      scale, drop_path.cuh) beside them, and everything after reads ds in
//      dout's place: one more (M, C) write, where the eager scale was a
//      pass of its own that read dout and wrote as much.
//   1. `mlp_bwd_rows_wgmma_kernel`: dh0, then dy through the LayerNorm and
//      the column sums of dh0 n, dh0 and dout. A consumer warpgroup owns a
//      64-row tile; per hidden chunk:
//        a1  = h0 W1c^T   (64 x 64, inner C)  A: h0 tile, B: W1 rows, both K-major
//        dh1 = d2 W2c     (64 x 64, inner C)  A: d2 tile, B: W2 columns MN-major
//        dh0 += da1 W1c   (64 x C, inner 64)  A: registers, B: W1 rows MN-major
//      with da1 = round(dh1 GELU'(a1 + b1)) formed in registers, where the
//      accumulator fragment is pair by pair the next product's A fragment.
//      After the tile's last a1 the producer brings y and dout into the
//      same slot, for the epilogue to read from shared memory.
//   2. `mlp_bwd_weights_wgmma_kernel`: a block owns a hidden chunk and a
//      slab of row tiles, and computes the chunk's activations transposed,
//      so that h1^T and da1^T come out of the accumulators as A fragments:
//        a1^T  = W1c h0^T    (64 x 64, inner C)   A: W1 rows,   B: h0 tile, K-major
//        dh1^T = W2c^T d2^T  (64 x 64, inner C)   A: W2 columns MN-major, B: d2 tile
//        G^T   += h1^T dout  (64 x C, inner 64 rows)  A: registers, B: dout tile MN-major
//        dW1c  += da1^T h0   (64 x C, inner 64 rows)  A: registers, B: h0 tile MN-major
//      The two consumer warpgroups share the chunk: the first computes
//      a1^T, h1^T and G^T and hands a1^T + b1 (in the erf form GELU'
//      itself; float32, two buffers behind named barriers) to the second,
//      which computes dh1^T, da1^T, dW1c and db1 from the unrounded da1^T.
//   3. `mlp_bwd_reduce_kernel`: the slabs and the row blocks' sums in a
//      fixed order into dW1, dW2 = gamma G, db1, d ln_w, d ln_b,
//      db2 = gamma sum dout and dgamma (one block a column, the W2 G dot
//      product over Hd as a fixed tree).
//
// Both passes are warp-specialised, as K2's forward: a block is two
// consumer warpgroups and a producer warpgroup, one thread of which keeps
// the Tensor Memory Accelerator's loads in flight (weight chunks and row
// tiles in the row pass, row tiles in the weight pass) through rings of
// `mbarrier` stages with bounded waits; it gives its registers to the
// consumers (`setmaxnreg`), which run free of each other, meeting only at
// the hand-off's named barriers: while one waits on its products the other
// evaluates its GELU. Every product's k-steps are unrolled (C and the GELU
// form are template arguments), no accumulator is indexed at run time, the
// warpgroup's index is broadcast from lane 0 so that ptxas sees every
// branch on it as uniform, and each product is issued, committed and
// waited asynchronously: ptxas reports no C7520 for this file.
//
// Registers. ptxas allocates the whole function at its launch bound, 168 a
// thread for 384 threads, and does not raise that where `setmaxnreg` gives
// the consumers more (measured: C7512 and spills in every consumer past
// 168). So a consumer fits 168: where the accumulator across C holds 64 or
// more registers a thread (C >= 128), a1 and dh1 (and their transposes)
// are taken 32 columns (tile rows) at a time, and 16 tile rows in the erf
// form's weight pass past C = 128.
//
// Widths. A tile is 64-column swizzle atoms side by side (hopper.cuh); the
// tensor maps fill the columns past C with zeros. Products along C run C /
// 16 k-steps and never read the padding; products across C are one
// `wgmma` of width kN a k-step: C itself at 64, 96, 128 and 192, and 64 at
// C = 32 and 192 at C = 160, whose extra columns meet zeros and are
// dropped. Rows past M arrive as zero rows of h0, d2, y and dout: their h1
// = GELU(b1) meets only zero rows of dout, their da1 is zero, and their dy
// is not written.
//
// The tanh form's tanh is the hardware's `tanh.approx.f32` (`tanh_of<true>`);
// the erf form stays exact. Every sum is taken in a fixed order, with no
// atomics: two calls give the same bits.
//
// Measured on an H100 SXM at 700 W, tanh form: 2.23-2.31 ms a call at
// (M, C) = (1179648, 96) and 1.67-1.71 ms at (294912, 192), the shapes of a
// 384 px train step at B = 128, against the bound's 0.528 ms: 23% and 31% of
// it (the kernels this replaced: 6.3 and 4.1 ms; PyTorch's bf16 autograd of
// the same chain: 4.8 and 2.5 ms). PERF.md section 6 has the other shapes.

#include <cuda.h>
#include <stdint.h>

#include "fused_mlp_bwd.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;  // rows per tile
constexpr int kHC = 64;  // hidden columns per chunk
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 227 * 1024;  // dynamic shared memory a block may ask for
// A block: two consumer warpgroups and a producer warpgroup, one thread of
// which works, the two paths one if / else that never meets again.
constexpr int kGroups = 2;
constexpr int kConsumers = kGroups * hp::kWarpgroup;
constexpr int kBlock = kConsumers + hp::kWarpgroup;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 2 x 232 + 40 <= 512 a lane of each sub-partition

// h0 = round(LN(y)), d2 = round(dout * gamma) and the rows' (mean, rstd).
// A lane owns eight columns of a row; up to 128 columns a row takes half a
// warp and a warp two rows, wider rows the warp: the block's rows are
// blockIdx.x * 8 * kPer + (warp * kPer + sub). kScaled (training under drop
// path): first ds = round(s * dout), s the row's sample's scale, written to
// `ds` for the passes to read in dout's place, and d2 = round(ds * gamma).
template <int kC, bool kScaled>
__global__ void __launch_bounds__(kThreads)
    mlp_bwd_prologue_kernel(const bf16* __restrict__ y, const bf16* __restrict__ dout,
                            const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                            const float* __restrict__ gamma, bf16* __restrict__ h0,
                            bf16* __restrict__ d2, float* __restrict__ stats, long long M,
                            float eps, const lt::SampleScale scale, bf16* __restrict__ ds) {
  constexpr int kLanes = kC <= 128 ? 16 : 32;  // lanes of a row
  constexpr int kPer = 32 / kLanes;            // rows of a warp
  const int lane = threadIdx.x % kLanes;
  const long long r =
      (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32) * kPer +
      (threadIdx.x % 32) / kLanes;
  const bool owner = r < M && lane < kC / 8;
  const int c0 = lane * 8;
  float v[8], g[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = g[i] = 0.f;
  if (owner) {
    const uint4 yr = *reinterpret_cast<const uint4*>(y + r * kC + c0);
    const uint4 gr = *reinterpret_cast<const uint4*>(dout + r * kC + c0);
    const bf16* yb = reinterpret_cast<const bf16*>(&yr);
    const bf16* gb = reinterpret_cast<const bf16*>(&gr);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = __bfloat162float(yb[i]);
      g[i] = __bfloat162float(gb[i]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) sum += v[i];
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const float mean = sum / kC;
  float sq = 0.f;
  if (owner) {
#pragma unroll
    for (int i = 0; i < 8; ++i) sq += (v[i] - mean) * (v[i] - mean);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  const float rstd = rsqrtf(sq / kC + eps);
  if (r < M && lane == 0) {
    stats[2 * r] = mean;
    stats[2 * r + 1] = rstd;
  }
  if (!owner) return;
  if constexpr (kScaled) {
    const float sr = scale.of_unit(r);
    uint4 s_out;
    uint32_t* sp32 = reinterpret_cast<uint32_t*>(&s_out);
#pragma unroll
    for (int i = 0; i < 8; i += 2)
      sp32[i / 2] = hp::pack_bf16(sr == 0.f ? 0.f : g[i] * sr, sr == 0.f ? 0.f : g[i + 1] * sr);
    *reinterpret_cast<uint4*>(ds + r * kC + c0) = s_out;
    const bf16* sb = reinterpret_cast<const bf16*>(&s_out);
#pragma unroll
    for (int i = 0; i < 8; ++i) g[i] = __bfloat162float(sb[i]);
  }
  uint4 h_out, d_out;
  uint32_t* hp32 = reinterpret_cast<uint32_t*>(&h_out);
  uint32_t* dp32 = reinterpret_cast<uint32_t*>(&d_out);
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    const int c = c0 + i;
    hp32[i / 2] = hp::pack_bf16((v[i] - mean) * rstd * ln_w[c] + ln_b[c],
                                (v[i + 1] - mean) * rstd * ln_w[c + 1] + ln_b[c + 1]);
    dp32[i / 2] = hp::pack_bf16(g[i] * gamma[c], g[i + 1] * gamma[c + 1]);
  }
  *reinterpret_cast<uint4*>(h0 + r * kC + c0) = h_out;
  *reinterpret_cast<uint4*>(d2 + r * kC + c0) = d_out;
}

// A tensor map of a row-major (rows, cols) bf16 matrix read in 64 x 64
// boxes with the 128-byte swizzle of the tiles; what lies outside arrives
// as zeros. The encoder, `cuTensorMapEncodeTiled`, is looked up through the
// CUDA runtime at first use, so nothing links against libcuda.
cudaError_t tile_map(CUtensorMap* m, const void* base, long long rows, int cols) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t box[2] = {64, 64}, ones[2] = {1, 1};
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(cols) * 2};
  const CUresult res = encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                              dims, stride, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tiles and products of a width kC (C itself).
template <int kC>
struct Width {
  // the width of the products across C: C itself at 64, 96, 128 and 192,
  // 64 at C = 32 and 192 at C = 160 (the extra columns meet zeros)
  static constexpr int kN = kC <= 64 ? 64 : kC == 96 ? 96 : kC <= 128 ? 128 : 192;
  static constexpr int kAtoms = (kN + 63) / 64;
  static constexpr int kTile = kAtoms * hp::kTileBytes;  // 64 rows x (64 kAtoms) bf16
  static constexpr int kSteps = kC / 16;                 // k-steps along C
  // The width of the 64-column products a1 and dh1 (and their transposes)
  // in one go: 32 where the accumulator across C holds kN / 2 >= 64
  // registers a thread, so that a consumer stays inside the 168 registers
  // a thread that ptxas gives a block of 384 threads.
  static constexpr int kSub = kN >= 128 ? 32 : 64;
  static constexpr int kHalves = kHC / kSub;
};

constexpr int stages_that_fit(int fixed, int stage_bytes, int most) {
  const int fit = (kSmemLimit - 1024 - fixed) / (stage_bytes + 16);
  return fit < most ? fit : most;
}

// The calling thread's warpgroup, broadcast from lane 0 so that the
// compiler knows every branch on it to be uniform across the warp: ptxas
// serialises `wgmma` issued on a path it takes for divergent (C7520).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / hp::kWarpgroup, 0);
}

// A stage of a ring and the parity of the phase awaited there.
struct Cursor {
  int s = 0;
  uint32_t parity;
  __device__ explicit Cursor(uint32_t p) : parity(p) {}
  __device__ void next(int stages) {
    if (++s == stages) s = 0, parity ^= 1;
  }
};

template <int kW, int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&acc)[kW / 2], uint64_t a, uint64_t b,
                                         bool accumulate) {
  if constexpr (kW == 64)
    hp::wgmma_ss_n64<kTransA, kTransB>(acc, a, b, accumulate);
  else if constexpr (kW == 32)
    hp::wgmma_ss_n32<kTransA, kTransB>(acc, a, b, accumulate);
  else
    hp::wgmma_ss_n16<kTransA, kTransB>(acc, a, b, accumulate);
}

// acc (64 x kW) = A B^T along C, both read K-major: A the 64 rows of the
// wide tile at `a`, B kW rows of the wide tile at `b` (the first of them at
// `b`, 128 bytes a row).
template <int kSteps, int kW>
__device__ __forceinline__ void along_c(float (&acc)[kW / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const uint32_t atom = (ks >> 2) * hp::kTileBytes;
    wgmma_ss<kW, 0, 0>(acc, hp::descriptor(a + atom) + hp::k_major_step(ks & 3),
                       hp::descriptor(b + atom) + hp::k_major_step(ks & 3), ks > 0);
  }
}

// dh1 = d2 W2c along C: A the d2 tile (K-major), B kW columns of the W2
// chunk, read MN-major from `w2_cols` (2 bytes a column into its rows).
template <int kSteps, int kW>
__device__ __forceinline__ void d2_times_w2(float (&acc)[kW / 2], uint32_t d2_tile,
                                            uint32_t w2_cols) {
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
    wgmma_ss<kW, 0, 1>(
        acc, hp::descriptor(d2_tile + (ks >> 2) * hp::kTileBytes) + hp::k_major_step(ks & 3),
        hp::descriptor(w2_cols) + hp::mn_major_step(ks), ks > 0);
}

// Its transpose, dh1^T = W2c^T d2^T: the W2 chunk as an MN-major A, B kW
// rows of the d2 tile read K-major.
template <int kSteps, int kW>
__device__ __forceinline__ void w2t_times_d2t(float (&acc)[kW / 2], uint32_t w2_tile,
                                              uint32_t d2_rows) {
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
    wgmma_ss<kW, 1, 0>(
        acc, hp::descriptor(w2_tile) + hp::mn_major_step(ks),
        hp::descriptor(d2_rows + (ks >> 2) * hp::kTileBytes) + hp::k_major_step(ks & 3),
        ks > 0);
}

// acc (64 x kN) += A B over kW inner values: A the fragments (kW / 16
// k-steps of bf16 pairs), B kW rows of a wide tile from `rows` on, read
// MN-major with N across the atoms: one instruction as wide as C a k-step.
template <int kN, int kW>
__device__ __forceinline__ void across_c(float (&acc)[kN / 2], const uint32_t (&frag)[kW / 4],
                                         uint32_t rows) {
#pragma unroll
  for (int ks = 0; ks < kW / 16; ++ks)
    hp::wgmma_rs_across<kN>(acc, frag + 4 * ks,
                            hp::descriptor_across(rows) + hp::mn_major_step(ks));
}

// pairs[2 j + half] = bf16 pair of value(i, half) at i = 4 j + 2 half and
// i + 1: a kW-column accumulator fragment as the A fragments of the next
// product.
template <int kW, typename F>
__device__ __forceinline__ void pack(uint32_t (&pairs)[kW / 4], F value) {
#pragma unroll
  for (int j = 0; j < kW / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 4 * j + 2 * half;
      pairs[2 * j + half] = hp::pack_bf16(value(i, half), value(i + 1, half));
    }
}

template <int kN>
__device__ __forceinline__ void zero(float (&acc)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) acc[i] = 0.f;
}

// ------------------------------------------------------------- the row pass

template <int kC>
struct RowPass {
  using W = Width<kC>;
  static constexpr int kRows = kGroups * kBM;                 // rows of a block's tile
  static constexpr int kStageBytes = 2 * W::kTile;            // a chunk's W1 rows, W2 columns
  static constexpr int kSlotsBytes = kGroups * 2 * W::kTile;  // each consumer's two tiles
  static constexpr int kSums = 3;                             // d ln_w, d ln_b, dout
  static constexpr int kSumsBytes = kGroups * 4 * kSums * kC * 4;  // per warp
  static constexpr int kSlotBars = 4;  // a slot's h0/d2 in, read; y/dout in, read
  static constexpr int kStages =
      stages_that_fit(kSlotsBytes + kSumsBytes + 8 * kSlotBars * kGroups, kStageBytes, 4);
  static_assert(kStages >= 2, "the ring needs two stages");
  static constexpr size_t kSmemBytes = 1024 + kSlotsBytes + kStages * kStageBytes + kSumsBytes +
                                       16 * kStages + 8 * kSlotBars * kGroups;
};

// A bf16 pair of a swizzled wide tile at generic address `tile`, as a
// fragment holds it: row `r`, columns 8 j + col and the next.
__device__ __forceinline__ float2 pair_in(const uint8_t* tile, int r, int j, int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      tile + (j >> 3) * hp::kTileBytes + hp::swizzled(r, j & 7) + col * 2));
}

// Per block tile of kGroups x 64 rows, consumer g owns rows 64 g ..: its
// slot holds h0 and d2 for the chunks, then y and dout for the epilogue.
// `part` is (gridDim.x, 3, C): this block's sums of dh0 n, dh0 and dout.
template <int kC, bool kApprox>
__global__ void __launch_bounds__(kBlock, 1)
    mlp_bwd_rows_wgmma_kernel(const __grid_constant__ CUtensorMap w1_map,
                              const __grid_constant__ CUtensorMap w2_map,
                              const __grid_constant__ CUtensorMap h0_map,
                              const __grid_constant__ CUtensorMap d2_map,
                              const __grid_constant__ CUtensorMap y_map,
                              const __grid_constant__ CUtensorMap dout_map,
                              const float* __restrict__ stats, const float* __restrict__ ln_w,
                              const float* __restrict__ b1, bf16* __restrict__ dy,
                              float* __restrict__ part, long long M, int Hd) {
  using P = RowPass<kC>;
  using W = typename P::W;
  constexpr int kTile = W::kTile, kStages = P::kStages, kSub = W::kSub;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (hp::smem_addr(smem_raw) & 1023u)) & 1023u;
  uint8_t* base = smem_raw + pad;
  const uint32_t slots = hp::smem_addr(base);
  const uint32_t ring = slots + P::kSlotsBytes;  // stage s: W1 chunk then W2 chunk
  float* colsum = reinterpret_cast<float*>(base + P::kSlotsBytes + kStages * P::kStageBytes);
  const uint32_t bars = hp::smem_addr(colsum) + P::kSumsBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  // slot g's barriers: k = 0 h0/d2 in, 1 h0/d2 read, 2 y/dout in, 3 y/dout read
  auto slot_bar = [&](int g, int k) { return bars + 8 * (2 * kStages + P::kSlotBars * g + k); };

  const int n_chunks = Hd / kHC;
  const long long tiles = (M + P::kRows - 1) / P::kRows;
  const int my_tiles = static_cast<int>((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(full(s), 1);
      hp::mbar_init(empty(s), 4 * kGroups);  // every consumer warp
    }
    for (int g = 0; g < kGroups; ++g)
      for (int k = 0; k < P::kSlotBars; ++k) hp::mbar_init(slot_bar(g, k), k & 1 ? 4 : 1);
    hp::fence_mbar_init();
  }
  for (int i = threadIdx.x; i < P::kSumsBytes / 4; i += kBlock) colsum[i] = 0.f;
  __syncthreads();

  if (warpgroup() == kGroups) {
    hp::give_registers<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      // the producer: a tile's h0 and d2 into each consumer's slot, the
      // tile's weight chunks through the ring, then its y and dout into the
      // slots as each consumer is done with h0 and d2
      Cursor w(1);  // the stages start empty
      for (int it = 0; it < my_tiles; ++it) {
        const int row0 = static_cast<int>(
            (blockIdx.x + static_cast<long long>(it) * gridDim.x) * P::kRows);
        const uint32_t par = it & 1;
        auto load_slot = [&](int g, int k, const CUtensorMap* m0, const CUtensorMap* m1) {
          // the slot is free once the other pair of tiles in it has been read
          hp::mbar_wait(slot_bar(g, (k + 3) & 3), k ? par : par ^ 1);
          hp::mbar_arrive_expect(slot_bar(g, k), 2 * kTile);
          const uint32_t slot = slots + g * 2 * kTile;
#pragma unroll
          for (int a = 0; a < W::kAtoms; ++a) {
            hp::tma_load_box(slot + a * hp::kTileBytes, m0, slot_bar(g, k), 64 * a,
                             row0 + kBM * g);
            hp::tma_load_box(slot + kTile + a * hp::kTileBytes, m1, slot_bar(g, k), 64 * a,
                             row0 + kBM * g);
          }
        };
        for (int g = 0; g < kGroups; ++g) load_slot(g, 0, &h0_map, &d2_map);
        for (int ch = 0; ch < n_chunks; ++ch) {
          hp::mbar_wait(empty(w.s), w.parity);
          hp::mbar_arrive_expect(full(w.s), P::kStageBytes);
          const uint32_t stage = ring + w.s * P::kStageBytes;
#pragma unroll
          for (int a = 0; a < W::kAtoms; ++a) {
            hp::tma_load_box(stage + a * hp::kTileBytes, &w1_map, full(w.s), 64 * a, ch * kHC);
            hp::tma_load_box(stage + kTile + a * hp::kTileBytes, &w2_map, full(w.s), ch * kHC,
                             64 * a);
          }
          w.next(kStages);
        }
        for (int g = 0; g < kGroups; ++g) load_slot(g, 2, &y_map, &dout_map);
      }
    }
  } else {
    hp::take_registers<kConsumerRegs>();
    const int group = warpgroup();
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int row = warp * 16 + (lane >> 2);  // and row + 8
    const int col = 2 * (lane & 3);           // first of this lane's two columns of each 8
    const bool elected = lane == 0;
    const uint8_t* slot = base + group * 2 * kTile;
    const uint32_t h0_tile = slots + group * 2 * kTile;
    const uint32_t d2_tile = h0_tile + kTile;
    float* sums = colsum + (group * 4 + warp) * P::kSums * kC;

    Cursor w(0);
    for (int it = 0; it < my_tiles; ++it) {
      const long long row0 =
          (blockIdx.x + static_cast<long long>(it) * gridDim.x) * P::kRows + kBM * group;
      const uint32_t par = it & 1;
      const long long gr[2] = {row0 + row, row0 + row + 8};
      const bool live[2] = {gr[0] < M, gr[1] < M};
      float mean[2], rstd[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mean[half] = live[half] ? stats[2 * gr[half]] : 0.f;
        rstd[half] = live[half] ? stats[2 * gr[half] + 1] : 0.f;
      }
      hp::mbar_wait(slot_bar(group, 0), par);

      // acc[4 j + 2 half + e]: dh0 at row + 8 half, column 8 j + col + e
      float acc[W::kN / 2];
      zero(acc);
      int held = -1;  // the stage whose dh0 product is still running
      for (int ch = 0; ch < n_chunks; ++ch) {
        hp::mbar_wait(full(w.s), w.parity);
        const uint32_t w1_tile = ring + w.s * P::kStageBytes;
        const uint32_t w2_tile = w1_tile + kTile;
#pragma unroll
        for (int h = 0; h < W::kHalves; ++h) {
          // a1[4 j + 2 half + e]: row + 8 half, hidden column 64 ch + kSub h + 8 j + col + e
          float a1[kSub / 2], dh1[kSub / 2];
          hp::wgmma_fence();
          along_c<W::kSteps, kSub>(a1, h0_tile, w1_tile + h * kSub * hp::kRowBytes);
          d2_times_w2<W::kSteps, kSub>(dh1, d2_tile, w2_tile + h * kSub * 2);
          hp::wgmma_commit();
          hp::wgmma_wait_all();  // and the dh0 product before
          hp::fence_registers(a1);
          hp::fence_registers(dh1);
          if (elected && h == 0 && held >= 0) hp::mbar_arrive(empty(held));
          if (elected && h + 1 == W::kHalves && ch + 1 == n_chunks)
            hp::mbar_arrive(slot_bar(group, 1));  // h0 and d2 read for good

          // da1 = round(dh1 GELU'(a1 + b1))
          const float* bias = b1 + ch * kHC + h * kSub + col;
          uint32_t frag[kSub / 4];
          pack<kSub>(frag, [&](int i, int) {
            return dh1[i] * gelu_grad<true>(a1[i] + bias[8 * (i >> 2) + (i & 1)], kApprox);
          });
          hp::wgmma_fence();
          across_c<W::kN, kSub>(acc, frag, w1_tile + h * kSub * hp::kRowBytes);  // dh0 += da1 W1c
          hp::wgmma_commit();
        }
        held = w.s;
        w.next(kStages);
      }
      hp::wgmma_wait_all();
      hp::fence_registers(acc);
      if (elected && held >= 0) hp::mbar_arrive(empty(held));

      // After the chunks, with y and dout in the slot. A column's sum over
      // the tile's rows: the thread's two rows, then the eight lanes that
      // share the column, then (lanes 0..3) into the warp's own sums.
      hp::mbar_wait(slot_bar(group, 2), par);
      float sum_dn[2] = {0.f, 0.f}, sum_dnn[2] = {0.f, 0.f};
      // d ln_w = sum dh0 n, d ln_b = sum dh0, and sum dout (for db2 and dgamma)
#pragma unroll
      for (int j = 0; j < kC / 8; ++j) {
        const int c = 8 * j + col;
        const float2 lw = *reinterpret_cast<const float2*>(ln_w + c);
        const float scale[2] = {lw.x, lw.y};
        float v[P::kSums][2] = {};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 yv = pair_in(slot, row + 8 * half, j, col);
          const float2 gv = pair_in(slot + kTile, row + 8 * half, j, col);
          const float n[2] = {(yv.x - mean[half]) * rstd[half], (yv.y - mean[half]) * rstd[half]};
          const float gd[2] = {gv.x, gv.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float dh = acc[4 * j + 2 * half + e];
            v[0][e] += dh * n[e];
            v[1][e] += dh;
            v[2][e] += gd[e];
            const float dn = dh * scale[e];
            sum_dn[half] += dn;
            sum_dnn[half] += dn * n[e];
          }
        }
#pragma unroll
        for (int k = 0; k < P::kSums; ++k)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[k][e] += __shfl_xor_sync(0xffffffffu, v[k][e], 4);
            v[k][e] += __shfl_xor_sync(0xffffffffu, v[k][e], 8);
            v[k][e] += __shfl_xor_sync(0xffffffffu, v[k][e], 16);
            if (lane < 4) sums[k * kC + c + e] += v[k][e];
          }
      }
      // dy through the LayerNorm; a row lives in the four lanes of a quad
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        sum_dn[half] += __shfl_xor_sync(0xffffffffu, sum_dn[half], 1);
        sum_dn[half] += __shfl_xor_sync(0xffffffffu, sum_dn[half], 2);
        sum_dnn[half] += __shfl_xor_sync(0xffffffffu, sum_dnn[half], 1);
        sum_dnn[half] += __shfl_xor_sync(0xffffffffu, sum_dnn[half], 2);
        if (!live[half]) continue;
        const float mean_dn = sum_dn[half] / kC;
        const float mean_dnn = sum_dnn[half] / kC;
#pragma unroll
        for (int j = 0; j < kC / 8; ++j) {
          const int c = 8 * j + col;
          const float2 lw = *reinterpret_cast<const float2*>(ln_w + c);
          const float2 yv = pair_in(slot, row + 8 * half, j, col);
          const float n0 = (yv.x - mean[half]) * rstd[half];
          const float n1 = (yv.y - mean[half]) * rstd[half];
          const float dn0 = acc[4 * j + 2 * half] * lw.x;
          const float dn1 = acc[4 * j + 2 * half + 1] * lw.y;
          *reinterpret_cast<uint32_t*>(dy + gr[half] * kC + c) =
              hp::pack_bf16(rstd[half] * (dn0 - mean_dn - n0 * mean_dnn),
                            rstd[half] * (dn1 - mean_dn - n1 * mean_dnn));
        }
      }
      __syncwarp();
      if (elected) hp::mbar_arrive(slot_bar(group, 3));  // y and dout read
    }

    // this block's three column sums: over its eight consumer warps, in order
    hp::named_barrier(1, kConsumers);
    for (int i = threadIdx.x; i < P::kSums * kC; i += kConsumers) {
      const int k = i / kC;
      const int c = i % kC;
      float sum = 0.f;
      for (int wp = 0; wp < 4 * kGroups; ++wp) sum += colsum[(wp * P::kSums + k) * kC + c];
      part[(static_cast<long long>(blockIdx.x) * P::kSums + k) * kC + c] = sum;
    }
  }
}

// ---------------------------------------------------------- the weight pass

template <int kC, bool kApprox>
struct WeightPass {
  using W = Width<kC>;
  // tile rows a step: as the row pass's columns, and 16 in the erf form at
  // C > 128, where erf and exp beside the 96-register accumulator leave no
  // room for more
  static constexpr int kSub = !kApprox && W::kN > 128 ? 16 : W::kSub;
  static constexpr int kSteps = kBM / kSub;            // steps a row tile
  static constexpr int kStageBytes = 3 * W::kTile;     // a row tile of h0, d2 and dout
  static constexpr int kWeightsBytes = 2 * W::kTile;   // the chunk's W1 rows and W2 columns
  static constexpr int kHandoff = kBM * kSub * 4;      // kSub tile rows of float32
  static constexpr int kHandoffBytes = 2 * kHandoff;
  static constexpr int kStages =
      stages_that_fit(kWeightsBytes + kHandoffBytes + 8, kStageBytes, 4);
  static_assert(kStages >= 2, "the ring needs two stages");
  static constexpr size_t kSmemBytes =
      1024 + kWeightsBytes + kHandoffBytes + kStages * kStageBytes + 16 * kStages + 8;
};

// Named barriers of the hand-off between the consumers: buffer b is full
// at 1 + b, empty at 3 + b.
constexpr int kHandoffFull = 1, kHandoffEmpty = 3;

// The producer: the block's weight chunk once, then its row tiles through
// the ring.
template <int kC, bool kApprox>
__device__ __forceinline__ void produce_weight_pass(uint32_t weights, uint32_t ring,
                                                    uint32_t bars, const CUtensorMap* w1_map,
                                                    const CUtensorMap* w2_map,
                                                    const CUtensorMap* h0_map,
                                                    const CUtensorMap* d2_map,
                                                    const CUtensorMap* dout_map, int my_tiles,
                                                    int slab, int slabs) {
  using P = WeightPass<kC, kApprox>;
  constexpr int kAtoms = P::W::kAtoms, kTile = P::W::kTile, kStages = P::kStages;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t weights_full = bars + 16 * kStages;
  const int hc = blockIdx.x * kHC;
  hp::mbar_arrive_expect(weights_full, P::kWeightsBytes);
#pragma unroll
  for (int a = 0; a < kAtoms; ++a) {
    hp::tma_load_box(weights + a * hp::kTileBytes, w1_map, weights_full, 64 * a, hc);
    hp::tma_load_box(weights + kTile + a * hp::kTileBytes, w2_map, weights_full, hc, 64 * a);
  }
  Cursor r(1);  // the stages start empty
  for (int t = 0; t < my_tiles; ++t) {
    const int row0 = static_cast<int>((slab + static_cast<long long>(t) * slabs) * kBM);
    hp::mbar_wait(empty(r.s), r.parity);
    hp::mbar_arrive_expect(full(r.s), P::kStageBytes);
    const uint32_t stage = ring + r.s * P::kStageBytes;
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      hp::tma_load_box(stage + a * hp::kTileBytes, h0_map, full(r.s), 64 * a, row0);
      hp::tma_load_box(stage + kTile + a * hp::kTileBytes, d2_map, full(r.s), 64 * a, row0);
      hp::tma_load_box(stage + 2 * kTile + a * hp::kTileBytes, dout_map, full(r.s), 64 * a,
                       row0);
    }
    r.next(kStages);
  }
}

// The consumers: both warpgroups work on the block's chunk, tile by tile
// and kSub tile rows at a time. Warpgroup 0 computes a1^T, h1^T and G^T and
// hands a1^T + b1 (GELU' in the erf form) to warpgroup 1, which computes
// dh1^T, da1^T, dW1c and db1; then each writes its slab's patches.
template <int kC, bool kApprox>
__device__ __forceinline__ void consume_weight_pass(uint32_t weights, float4* handoff,
                                                    uint32_t ring, uint32_t bars,
                                                    const float* __restrict__ b1,
                                                    float* __restrict__ ws_w1,
                                                    float* __restrict__ ws_g,
                                                    float* __restrict__ ws_b1, int Hd,
                                                    int my_tiles, int slab) {
  using P = WeightPass<kC, kApprox>;
  using W = typename P::W;
  constexpr int kTile = W::kTile, kStages = P::kStages, kSub = P::kSub, kN = W::kN;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const int group = warpgroup();
  const int in_group = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const int row = (in_group >> 5) * 16 + (lane >> 2);  // and row + 8: hidden
  const int col = 2 * (lane & 3);
  const bool elected = lane == 0;
  const int hc = blockIdx.x * kHC;
  const uint32_t w1_tile = weights, w2_tile = weights + kTile;
  const float bias[2] = {b1[hc + row], b1[hc + row + 8]};
  const int steps = my_tiles * P::kSteps;  // hand-offs, kSub tile rows each
  hp::mbar_wait(bars + 16 * kStages, 0);    // the chunk's weights
  Cursor r(0);
  int held = -1;  // the stage whose products are still running
  // acc[4 j + 2 half + e]: hidden hc + row + 8 half, column 8 j + col + e
  float acc[kN / 2];
  zero(acc);
  float db1[2] = {0.f, 0.f};

  for (int t = 0; t < my_tiles; ++t) {
    hp::mbar_wait(full(r.s), r.parity);
    const uint32_t h0_tile = ring + r.s * P::kStageBytes;
    const uint32_t d2_tile = h0_tile + kTile;
    const uint32_t dout_tile = d2_tile + kTile;
#pragma unroll
    for (int h = 0; h < P::kSteps; ++h) {
      const int u = t * P::kSteps + h;  // the hand-off's number
      const int b = u & 1;
      float4* buf = handoff + b * (P::kHandoff / 16);
      const uint32_t rows_at = h * kSub * hp::kRowBytes;  // this step's tile rows
      // x[4 j + 2 half + e]: hidden row + 8 half, tile row kSub h + 8 j + col + e
      float x[kSub / 2];
      uint32_t frag[kSub / 4];
      if (group == 0) {
        hp::wgmma_fence();
        along_c<W::kSteps, kSub>(x, w1_tile, h0_tile + rows_at);  // a1^T
        hp::wgmma_commit();
        hp::wgmma_wait_all();  // and the G product before
        hp::fence_registers(x);
        if (elected && h == 0 && held >= 0) hp::mbar_arrive(empty(held));
        // GELU into the fragments; the hand-off is a1^T + b1 in the tanh
        // form, whose GELU' warpgroup 1 evaluates, and GELU' itself in the
        // erf form, whose erf the two share here (the erf form's evaluation
        // beside warpgroup 1's accumulator needs more registers than a
        // thread has)
        float handed[kSub / 2];
#pragma unroll
        for (int i = 0; i < kSub / 2; ++i) {
          const float a = x[i] + bias[(i >> 1) & 1];
          if constexpr (kApprox) {
            x[i] = gelu<true>(a, true);
            handed[i] = a;
          } else {
            const float e = erff(a * 0.7071067811865476f);
            x[i] = 0.5f * a * (1.f + e);
            handed[i] = 0.5f * (1.f + e) + a * expf(-0.5f * a * a) * 0.3989422804014327f;
          }
        }
        if (u >= 2) hp::named_barrier(kHandoffEmpty + b, kConsumers);
#pragma unroll
        for (int q = 0; q < kSub / 8; ++q)
          buf[q * hp::kWarpgroup + in_group] = make_float4(
              handed[4 * q], handed[4 * q + 1], handed[4 * q + 2], handed[4 * q + 3]);
        hp::named_barrier_arrive(kHandoffFull + b, kConsumers);
        pack<kSub>(frag, [&](int i, int) { return x[i]; });
        hp::wgmma_fence();
        across_c<kN, kSub>(acc, frag, dout_tile + rows_at);  // G^T += h1^T dout
        hp::wgmma_commit();
      } else {
        float dh1t[kSub / 2];
        hp::wgmma_fence();
        w2t_times_d2t<W::kSteps, kSub>(dh1t, w2_tile, d2_tile + rows_at);
        hp::wgmma_commit();
        hp::wgmma_wait_all();  // and the dW1 product before
        hp::fence_registers(dh1t);
        if (elected && h == 0 && held >= 0) hp::mbar_arrive(empty(held));
        hp::named_barrier(kHandoffFull + b, kConsumers);
#pragma unroll
        for (int q = 0; q < kSub / 8; ++q) {
          const float4 v = buf[q * hp::kWarpgroup + in_group];
          x[4 * q] = v.x, x[4 * q + 1] = v.y, x[4 * q + 2] = v.z, x[4 * q + 3] = v.w;
        }
        if (u + 2 < steps) hp::named_barrier_arrive(kHandoffEmpty + b, kConsumers);
        pack<kSub>(frag, [&](int i, int half) {
          const float da1 = dh1t[i] * (kApprox ? gelu_grad<true>(x[i], true) : x[i]);
          db1[half] += da1;
          return da1;
        });
        hp::wgmma_fence();
        across_c<kN, kSub>(acc, frag, h0_tile + rows_at);  // dW1c += da1^T h0
        hp::wgmma_commit();
      }
    }
    held = r.s;
    r.next(kStages);
  }
  hp::wgmma_wait_all();
  hp::fence_registers(acc);
  if (elected && held >= 0) hp::mbar_arrive(empty(held));

  // the slab's patches: G^T transposed into ws_g (S, C, Hd), dW1c into
  // ws_w1 (S, Hd, C), db1 (summed over the quad that shares a hidden row)
  // into ws_b1 (S, Hd)
  if (group == 0) {
    float* out = ws_g + static_cast<long long>(slab) * kC * Hd + hc + row;
#pragma unroll
    for (int j = 0; j < kC / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          out[static_cast<long long>(8 * j + col + e) * Hd + 8 * half] = acc[4 * j + 2 * half + e];
  } else {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* out = ws_w1 + (static_cast<long long>(slab) * Hd + hc + row + 8 * half) * kC;
#pragma unroll
      for (int j = 0; j < kC / 8; ++j)
        *reinterpret_cast<float2*>(out + 8 * j + col) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      db1[half] += __shfl_xor_sync(0xffffffffu, db1[half], 1);
      db1[half] += __shfl_xor_sync(0xffffffffu, db1[half], 2);
      if ((lane & 3) == 0)
        ws_b1[static_cast<long long>(slab) * Hd + hc + row + 8 * half] = db1[half];
    }
  }
}

// Block (x, s) owns hidden chunk x and the row tiles s, s + S, ...; it
// writes its patches into slab s of the workspace.
template <int kC, bool kApprox>
__global__ void __launch_bounds__(kBlock, 1)
    mlp_bwd_weights_wgmma_kernel(const __grid_constant__ CUtensorMap w1_map,
                                 const __grid_constant__ CUtensorMap w2_map,
                                 const __grid_constant__ CUtensorMap h0_map,
                                 const __grid_constant__ CUtensorMap d2_map,
                                 const __grid_constant__ CUtensorMap dout_map,
                                 const float* __restrict__ b1, float* __restrict__ ws_w1,
                                 float* __restrict__ ws_g, float* __restrict__ ws_b1, long long M,
                                 int Hd) {
  using P = WeightPass<kC, kApprox>;
  constexpr int kStages = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (hp::smem_addr(smem_raw) & 1023u)) & 1023u;
  uint8_t* base = smem_raw + pad;
  const uint32_t weights = hp::smem_addr(base);  // W1 rows then W2 columns
  float4* handoff = reinterpret_cast<float4*>(base + P::kWeightsBytes);
  const uint32_t ring = weights + P::kWeightsBytes + P::kHandoffBytes;  // h0, d2, dout
  const uint32_t bars = ring + kStages * P::kStageBytes;

  const int slab = blockIdx.y;
  const int slabs = gridDim.y;
  const long long tiles = (M + kBM - 1) / kBM;
  const int my_tiles = static_cast<int>((tiles - slab + slabs - 1) / slabs);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(bars + 8 * s, 1);                // full
      hp::mbar_init(bars + 8 * (kStages + s), 8);    // empty: every consumer warp
    }
    hp::mbar_init(bars + 16 * kStages, 1);  // the weights in
    hp::fence_mbar_init();
  }
  __syncthreads();

  if (warpgroup() == kGroups) {
    hp::give_registers<kProducerRegs>();
    if (threadIdx.x == kConsumers)
      produce_weight_pass<kC, kApprox>(weights, ring, bars, &w1_map, &w2_map, &h0_map, &d2_map,
                              &dout_map, my_tiles, slab, slabs);
  } else {
    hp::take_registers<kConsumerRegs>();
    consume_weight_pass<kC, kApprox>(weights, handoff, ring, bars, b1, ws_w1, ws_g, ws_b1, Hd,
                                     my_tiles, slab);
  }
}

// ------------------------------------------------------------- the reduce

// Blocks below `elementwise` sum the slabs, in order, into dW1 (Hd, C),
// dW2 = gamma G (C, Hd) and db1, and the row blocks' sums into d ln_w,
// d ln_b and db2 = gamma sum dout. Block elementwise + c computes
// dgamma_c = sum_j W2[c, j] G[c, j] + b2_c sum dout, the dot product as a
// fixed tree over the block's threads.
__global__ void __launch_bounds__(kThreads)
    mlp_bwd_reduce_kernel(const float* __restrict__ ws_w1, const float* __restrict__ ws_g,
                          const float* __restrict__ ws_b1, const float* __restrict__ part,
                          const bf16* __restrict__ w2, const float* __restrict__ b2,
                          const float* __restrict__ gamma, int slabs, int row_blocks, int C,
                          int Hd, int elementwise, float* __restrict__ dw1,
                          float* __restrict__ dw2, float* __restrict__ db1,
                          float* __restrict__ dln_w, float* __restrict__ dln_b,
                          float* __restrict__ db2, float* __restrict__ dgamma) {
  const long long wsize = static_cast<long long>(Hd) * C;
  auto dout_sum = [&](int c) {
    float sum = 0.f;
    for (int b = 0; b < row_blocks; ++b) sum += part[(static_cast<long long>(b) * 3 + 2) * C + c];
    return sum;
  };
  if (static_cast<int>(blockIdx.x) >= elementwise) {
    __shared__ float warp_sums[kWarps];
    const int c = blockIdx.x - elementwise;
    float v = 0.f;
    for (int j = threadIdx.x; j < Hd; j += kThreads) {
      float g = 0.f;
      for (int s = 0; s < slabs; ++s) g += ws_g[s * wsize + static_cast<long long>(c) * Hd + j];
      v += __bfloat162float(w2[static_cast<long long>(c) * Hd + j]) * g;
    }
    v = lt::warp_sum(v);
    if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += warp_sums[w];
      dgamma[c] = sum + b2[c] * dout_sum(c);
    }
    return;
  }
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < wsize) {
    float sum = 0.f;
    for (int s = 0; s < slabs; ++s) sum += ws_w1[s * wsize + i];
    dw1[i] = sum;
    return;
  }
  i -= wsize;
  if (i < wsize) {  // i = c Hd + j, as ws_g's slabs lie
    float sum = 0.f;
    for (int s = 0; s < slabs; ++s) sum += ws_g[s * wsize + i];
    dw2[i] = gamma[i / Hd] * sum;
    return;
  }
  i -= wsize;
  if (i < Hd) {
    float sum = 0.f;
    for (int s = 0; s < slabs; ++s) sum += ws_b1[static_cast<long long>(s) * Hd + i];
    db1[i] = sum;
    return;
  }
  i -= Hd;
  if (i < 2LL * C) {
    const int k = static_cast<int>(i / C);
    const int c = static_cast<int>(i % C);
    float sum = 0.f;
    for (int b = 0; b < row_blocks; ++b) sum += part[(static_cast<long long>(b) * 3 + k) * C + c];
    (k == 0 ? dln_w : dln_b)[c] = sum;
    return;
  }
  i -= 2LL * C;
  if (i < C) db2[i] = gamma[i] * dout_sum(static_cast<int>(i));
}

template <int kC, bool kApprox>
cudaError_t launch(const lt::MlpBwdArgs& a) {
  const long long wsize = static_cast<long long>(a.Hd) * kC;
  // the workspace: h0 and d2 in bf16, the rows' (mean, rstd), the row
  // blocks' sums, then the slabs
  bf16* h0 = reinterpret_cast<bf16*>(a.workspace);
  bf16* d2 = h0 + a.M * kC;
  float* stats = a.workspace + a.M * kC;
  float* part = stats + 2 * a.M;  // (row_blocks, 3, C)
  float* ws_w1 = part + static_cast<long long>(a.row_blocks) * 3 * kC;
  float* ws_g = ws_w1 + a.slabs * wsize;
  float* ws_b1 = ws_g + a.slabs * wsize;
  const bf16* y = static_cast<const bf16*>(a.y);
  // under drop path the passes read ds = round(s * dout), which the
  // prologue writes, in dout's place
  const bool scaled = a.scale.u != nullptr;
  bf16* ds = static_cast<bf16*>(a.ds);
  const bf16* dout = scaled ? ds : static_cast<const bf16*>(a.dout);

  constexpr int kRowsABlock = kWarps * (kC <= 128 ? 2 : 1);
  const unsigned prologue_blocks = static_cast<unsigned>((a.M + kRowsABlock - 1) / kRowsABlock);
  if (scaled)
    mlp_bwd_prologue_kernel<kC, true><<<prologue_blocks, kThreads, 0, a.stream>>>(
        y, static_cast<const bf16*>(a.dout), a.ln_w, a.ln_b, a.gamma, h0, d2, stats, a.M,
        a.eps, a.scale, ds);
  else
    mlp_bwd_prologue_kernel<kC, false><<<prologue_blocks, kThreads, 0, a.stream>>>(
        y, dout, a.ln_w, a.ln_b, a.gamma, h0, d2, stats, a.M, a.eps, a.scale, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap w1_map, w2_map, h0_map, d2_map, y_map, dout_map;
  if ((err = tile_map(&w1_map, a.w1, a.Hd, kC)) != cudaSuccess ||
      (err = tile_map(&w2_map, a.w2, kC, a.Hd)) != cudaSuccess ||
      (err = tile_map(&h0_map, h0, a.M, kC)) != cudaSuccess ||
      (err = tile_map(&d2_map, d2, a.M, kC)) != cudaSuccess ||
      (err = tile_map(&y_map, y, a.M, kC)) != cudaSuccess ||
      (err = tile_map(&dout_map, dout, a.M, kC)) != cudaSuccess)
    return err;

  err = lt::launch_with_smem(mlp_bwd_rows_wgmma_kernel<kC, kApprox>, dim3(a.row_blocks), kBlock,
                             RowPass<kC>::kSmemBytes, a.stream, w1_map, w2_map, h0_map, d2_map,
                             y_map, dout_map, stats, a.ln_w, a.b1, static_cast<bf16*>(a.dy),
                             part, a.M, a.Hd);
  if (err != cudaSuccess) return err;

  err = lt::launch_with_smem(mlp_bwd_weights_wgmma_kernel<kC, kApprox>,
                             dim3(a.Hd / kHC, a.slabs), kBlock, WeightPass<kC, kApprox>::kSmemBytes,
                             a.stream, w1_map, w2_map, h0_map, d2_map, dout_map, a.b1, ws_w1,
                             ws_g, ws_b1, a.M, a.Hd);
  if (err != cudaSuccess) return err;

  const long long outputs = 2 * wsize + a.Hd + 3LL * kC;
  const int elementwise = static_cast<int>((outputs + kThreads - 1) / kThreads);
  mlp_bwd_reduce_kernel<<<elementwise + kC, kThreads, 0, a.stream>>>(
      ws_w1, ws_g, ws_b1, part, static_cast<const bf16*>(a.w2), a.b2, a.gamma, a.slabs,
      a.row_blocks, kC, a.Hd, elementwise, a.dw1, a.dw2, a.db1, a.dln_w, a.dln_b, a.db2,
      a.dgamma);
  return cudaGetLastError();
}

template <int kC>
cudaError_t launch_width(const lt::MlpBwdArgs& a) {
  return a.approximate ? launch<kC, true>(a) : launch<kC, false>(a);
}

}  // namespace

cudaError_t lt::mlp_bwd_wgmma(const lt::MlpBwdArgs& a) {
  switch (a.C) {  // the widths `lt::mlp_bwd_takes_wgmma` sends here
    case 32:
      return launch_width<32>(a);
    case 64:
      return launch_width<64>(a);
    case 96:
      return launch_width<96>(a);
    case 128:
      return launch_width<128>(a);
    case 160:
      return launch_width<160>(a);
    case 192:
      return launch_width<192>(a);
    default:
      return cudaErrorInvalidValue;
  }
}
