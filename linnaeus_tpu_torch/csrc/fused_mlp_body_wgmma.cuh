// The ConvNeXt MLP tail on the tensor cores, shared by the bfloat16 forward
// kernels that end in it: K2 (fused_mlp_fwd_wgmma.cu) and K3
// (fused_dwconv_mlp_fwd.cu). For a tile of 64 rows whose LayerNorm output h0
// lies in shared memory as bf16,
//   acc = GELU(h0 W1^T + b1) W2^T
// over the whole hidden dim, in chunks of 64 hidden columns:
//   a1   = h0 W1c^T   (64 x 64, inner C)   A: h0 tile,   B: rows hc.. of W1,
//                                          both K-major as they lie in memory
//   acc += h1 W2c^T   (64 x C, inner 64)   A: registers, B: columns hc.. of W2,
//                                          K-major, one wgmma as wide as C a k-step
// h1 = round(GELU(a1 + b1)) is formed in registers, where the accumulator
// fragment of a1 is pair by pair the A fragment of the second product: the
// (M, 4C) intermediates never reach shared memory.
//
// One warpgroup owns the 64 rows of a tile: it waits for a chunk's weights,
// starts a1, evaluates GELU, starts the second product, and gives the chunk's
// stage back. A warp that is feeding `wgmma` to the tensor cores executes
// nothing else meanwhile, so the tensor cores and the GELU overlap only
// between warpgroups: the
// warpgroups of a block therefore run free of one another, each at its own
// chunk, and meet nowhere. What couples them is the ring of weight chunks
// that they share: one producer thread asks the Tensor Memory Accelerator
// for each chunk's W1 rows and W2 columns (64 x 64 boxes of the weights'
// tensor maps, written straight into 128-byte-swizzled tiles, out-of-range
// columns and rows as zeros), a `full` barrier per stage counts the bytes
// in, and an `empty` barrier per stage counts the warps that are done with
// it. The ring runs on across the tiles of a persistent block.
//
// Widths as in K2's backward (hopper.cuh): a tile is 64-column atoms side by
// side; C = 96 is one and a half, padded with zeros. The a1 product runs
// C / 16 k-steps and never reads the padding. The second product's one
// instruction is as wide as C at 64, 96, 128, 192 and 256 columns and as
// wide as the next of those otherwise: its extra columns meet zero rows of
// W2 and are thrown away.
//
// The tanh form is evaluated as x / (1 + exp(-2 u)) with the hardware's exp2
// and reciprocal (`gelu_tanh_fragment`); the erf form is exact.
#pragma once

#include <cuda.h>

#include "fused_mlp_body.cuh"
#include "hopper.cuh"

namespace lt {

// The rule of the forward kernels that end in the MLP tail: bfloat16 with C
// a multiple of 32 up to 256 and whole 64-column hidden chunks takes the
// tensor-core tail; everything else (float32, whose 1e-5 bar no tensor-core
// product keeps, and the odd widths) the CUDA-core tail of
// fused_mlp_body.cuh. linnaeus_tpu_torch/ops/fused_mlp.py `forward_kernel`
// holds the same rule.
constexpr int kMaxWgmmaC = 256;
inline bool mlp_fwd_takes_wgmma(int C, int Hd, int dtype) {
  return dtype == kBFloat16 && C >= 32 && C <= kMaxWgmmaC && C % 32 == 0 && Hd >= 64 &&
         Hd % 64 == 0;
}

struct MlpFwdArgs {
  const void *y, *x;  // x: the residual, or null
  const float *ln_w, *ln_b;
  const void* w1;
  const float* b1;
  const void* w2;
  const float *b2, *gamma;
  void* out;
  long long M;
  int C, Hd;
  float eps;
  bool approximate;
  SampleScale scale;  // u null: no drop-path scale
  cudaStream_t stream;
};

// K2's tensor-core forward (fused_mlp_fwd_wgmma.cu); returns the launch's
// cudaError_t.
cudaError_t mlp_fwd_wgmma(const MlpFwdArgs& a);

// Tensor maps of the weights for the tail's producer: W1 (Hd, C) and W2
// (C, Hd), bf16, row-major, read in 64 x 64 boxes with the 128-byte swizzle.
// The encoder, `cuTensorMapEncodeTiled`, is looked up through the CUDA
// runtime at first use, so nothing links against libcuda.
inline cudaError_t weight_tensor_maps(const void* w1, const void* w2, int C, int Hd,
                                      CUtensorMap* m1, CUtensorMap* m2) {
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
  auto map = [&](CUtensorMap* m, const void* base, int rows, int cols) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
    const cuuint64_t stride[1] = {static_cast<cuuint64_t>(cols) * 2};
    return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, stride,
                  box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  if (map(m1, w1, Hd, C) != CUDA_SUCCESS || map(m2, w2, C, Hd) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace lt

namespace {

using bf16 = __nv_bfloat16;

// Shared memory of the tail for tiles of kAtoms atoms: a ring of `stages`
// stages, each a chunk's W1 tile then its W2 tile, and after the ring the
// stages' `full` and `empty` barriers.
template <int kAtoms>
struct WgmmaTail {
  static constexpr int kTile = kAtoms * hp::kTileBytes;  // 64 x (64 kAtoms) bf16
  static constexpr int kStageBytes = 2 * kTile;
  static constexpr int kMaxStages = 6;
  static constexpr int ring_bytes(int stages) { return stages * (kStageBytes + 16); }
};

struct TailRing {
  uint32_t stages_at, full_at, empty_at;  // shared-memory addresses
  int stages;
  __device__ __forceinline__ uint32_t full(int s) const { return full_at + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return empty_at + 8 * s; }
};

template <int kAtoms>
__device__ __forceinline__ TailRing tail_ring(uint32_t at, int stages) {
  TailRing r;
  r.stages_at = at;
  r.full_at = at + stages * WgmmaTail<kAtoms>::kStageBytes;
  r.empty_at = r.full_at + 8 * stages;
  r.stages = stages;
  return r;
}

// By one thread, before any other touches the ring (a block-wide barrier
// follows): a stage is full when its one producer has arrived and its bytes
// are in, and empty when every warp of the `consumers` warpgroups has
// arrived.
__device__ __forceinline__ void tail_ring_init(const TailRing& r, int consumers) {
  for (int s = 0; s < r.stages; ++s) {
    hp::mbar_init(r.full(s), 1);
    hp::mbar_init(r.empty(s), 4 * consumers);
  }
  hp::fence_mbar_init();
}

// The tanh form of GELU, 0.5 x (1 + tanh(u)) with u = sqrt(2/pi) (x + 0.044715 x^3),
// written as x / (1 + exp(-2 u)): one `ex2.approx` and one approximate
// reciprocal, both good to a few units of float32's last place, so h1 rounds
// as the plain version's does (the one-instruction `tanh.approx.f32`, good to
// 2^-11, flipped enough of h1's bf16 roundings to move a |out| > 8 by its
// last bit, 0.0625, over the 5e-2 bar).
//
// Over a whole fragment in place, stage by stage, so that the 32 elements'
// chains of dependent instructions run side by side: v[i] = gelu(v[i]).
__device__ __forceinline__ void gelu_tanh_fragment(float (&v)[32]) {
  float e[32];
#pragma unroll
  for (int i = 0; i < 32; ++i)  // -2 log2(e) sqrt(2/pi) x (1 + 0.044715 x^2)
    e[i] = v[i] * fmaf(-0.1029432f, v[i] * v[i], -2.302208f);
#pragma unroll
  for (int i = 0; i < 32; ++i) asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e[i]) : "f"(e[i]));
#pragma unroll
  for (int i = 0; i < 32; ++i) v[i] = __fdividef(v[i], 1.f + e[i]);
}

// The LayerNorm's lanes: a lane owns 16 bytes of a row, columns 8 piece ..
// 8 piece + 7. Up to 128 columns a row takes half a warp and a warp two rows
// at a time; wider rows take the warp.
template <int kAtoms>
struct LnLanes {
  static constexpr int kLanes = kAtoms <= 2 ? 16 : 32;  // lanes of a row
  static constexpr int kPer = 32 / kLanes;              // rows side by side in a warp
  __device__ static int piece() { return (threadIdx.x & 31) % kLanes; }
  __device__ static int sub() { return (threadIdx.x & 31) / kLanes; }
};

// kRows * kPer rows of the LayerNorm by one warp, into rows r0 .. of a
// swizzled wide tile as bf16: v[k] holds the lane's eight columns of row
// r0 + k * kPer + sub (zeros where the lane owns none, `owner` false).
// Statistics in float32, as `layer_norm_rows`: the mean, then the centred
// squares. The rows' sums go through the shuffles side by side, so their
// latencies overlap. Rows from r0 + live_rows on become zeros, as do the
// padding columns.
template <int kAtoms, int kRows>
__device__ __forceinline__ void layer_norm_rows_to_tile(const float (&v)[kRows][8], bool owner,
                                                        int live_rows, uint8_t* tile, int r0,
                                                        const float* __restrict__ ln_w,
                                                        const float* __restrict__ ln_b, int C,
                                                        float eps) {
  using L = LnLanes<kAtoms>;
  const int piece = L::piece();
  const float inv_c = 1.f / C;
  float mean[kRows], rstd[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    mean[k] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) mean[k] += v[k][i];
  }
#pragma unroll
  for (int off = L::kLanes / 2; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < kRows; ++k) mean[k] += __shfl_xor_sync(0xffffffffu, mean[k], off);
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    mean[k] *= inv_c;
    rstd[k] = 0.f;
    if (owner) {
#pragma unroll
      for (int i = 0; i < 8; ++i) rstd[k] += (v[k][i] - mean[k]) * (v[k][i] - mean[k]);
    }
  }
#pragma unroll
  for (int off = L::kLanes / 2; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < kRows; ++k) rstd[k] += __shfl_xor_sync(0xffffffffu, rstd[k], off);
  if (piece >= kAtoms * 8) return;
  float w[8], b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = b[i] = 0.f;
  if (owner) {
#pragma unroll
    for (int i = 0; i < 8; i += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(ln_w + piece * 8 + i);
      const float4 b4 = *reinterpret_cast<const float4*>(ln_b + piece * 8 + i);
      w[i] = w4.x, w[i + 1] = w4.y, w[i + 2] = w4.z, w[i + 3] = w4.w;
      b[i] = b4.x, b[i + 1] = b4.y, b[i + 2] = b4.z, b[i + 3] = b4.w;
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = k * L::kPer + L::sub();  // past r0
    uint4 h = make_uint4(0u, 0u, 0u, 0u);
    if (owner && r < live_rows) {
      const float scale = rsqrtf(rstd[k] * inv_c + eps);
      uint32_t* h32 = reinterpret_cast<uint32_t*>(&h);
#pragma unroll
      for (int i = 0; i < 8; i += 2)
        h32[i / 2] = hp::pack_bf16((v[k][i] - mean[k]) * scale * w[i] + b[i],
                                   (v[k][i + 1] - mean[k]) * scale * w[i + 1] + b[i + 1]);
    }
    *reinterpret_cast<uint4*>(tile + (piece >> 3) * hp::kTileBytes +
                              hp::swizzled(r0 + r, piece & 7)) = h;
  }
}

// The producer, one thread: chunk after chunk of the weights into the ring,
// `total` steps in all (the chunks of every tile of the block, in order).
// m1 maps W1 (Hd rows of C), m2 maps W2 (C rows of Hd).
template <int kAtoms>
__device__ __forceinline__ void tail_produce(const TailRing& ring, const void* m1, const void* m2,
                                             int n_chunks, long long total) {
  using P = WgmmaTail<kAtoms>;
  int s = 0, hc = 0;
  uint32_t parity = 1;  // the stages start empty
  for (long long g = 0; g < total; ++g) {
    hp::mbar_wait(ring.empty(s), parity);
    hp::mbar_arrive_expect(ring.full(s), P::kStageBytes);
    const uint32_t stage = ring.stages_at + s * P::kStageBytes;
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      hp::tma_load_box(stage + a * hp::kTileBytes, m1, ring.full(s), 64 * a, hc);
      hp::tma_load_box(stage + P::kTile + a * hp::kTileBytes, m2, ring.full(s), hc, 64 * a);
    }
    if (++s == ring.stages) s = 0, parity ^= 1;
    if ((hc += kHC) == n_chunks * kHC) hc = 0;
  }
}

// acc = GELU(h0 W1^T + b1) W2^T for the 64 rows of `h0_tile`, a wide tile of
// kAtoms atoms that the calling warpgroup wrote and published among its own
// warps (fence_async_proxy, then a barrier of the warpgroup). Called by the
// four warps of a warpgroup together. acc[a][4 j + 2 half + e] is row
// 16 warp + lane / 4 + 8 half, column 64 a + 8 j + 2 (lane % 4) + e; kN is
// the width of the second product's one instruction, C or the next of 64,
// 96, 128, 192, 256 (the columns past C meet zero rows of W2). g0
// counts the chunk steps this warpgroup has consumed so far (every
// warpgroup of the block consumes every step). `at_last_chunk` is called
// once the tile's last a1 has been computed by this warp: after a barrier of
// the warpgroup h0_tile is free, and what is copied there with `cp.async`
// lands under the last chunk's GELU and second product.
template <int kN, typename AtLastChunk>
__device__ __forceinline__ void tail_consume(uint32_t h0_tile, const TailRing& ring,
                                             long long g0, int n_chunks,
                                             const float* __restrict__ b1, int C,
                                             bool approximate,
                                             float (&acc)[(kN + 63) / 64][32],
                                             AtLastChunk at_last_chunk) {
  constexpr int kAtoms = (kN + 63) / 64;
  using P = WgmmaTail<kAtoms>;
  const int col = 2 * (threadIdx.x & 3);
  const bool elected = (threadIdx.x & 31) == 0;
  int s = static_cast<int>(g0 % ring.stages);
  uint32_t parity = static_cast<uint32_t>((g0 / ring.stages) & 1);
  int held = -1;  // the stage whose second product is still running
#pragma unroll
  for (int a = 0; a < kAtoms; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    hp::mbar_wait(ring.full(s), parity);
    const uint32_t w1_tile = ring.stages_at + s * P::kStageBytes;
    // a1[4 j + 2 half + e]: row + 8 half, hidden column 64 ch + 8 j + col + e
    float a1[32];
    hp::wgmma_fence();
    hp::product_along_width(a1, h0_tile, w1_tile, C / 16);
    hp::wgmma_commit();
    hp::wgmma_wait_all();  // and the chunk before's second product
    hp::fence_registers(a1);
    if (held >= 0 && elected) hp::mbar_arrive(ring.empty(held));
    if (ch + 1 == n_chunks) at_last_chunk();

    const float* bias = b1 + ch * kHC + col;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j);
      a1[4 * j] += b.x, a1[4 * j + 1] += b.y, a1[4 * j + 2] += b.x, a1[4 * j + 3] += b.y;
    }
    if (approximate) {
      gelu_tanh_fragment(a1);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) a1[i] = gelu(a1[i], false);
    }
    uint32_t frag[16];
    hp::to_fragments(frag, [&](int i, int, int, int) { return a1[i]; });
    // the whole width in one instruction a k-step: the W2 tile's rows lie one
    // after the other across its atoms
    hp::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kHC / 16; ++ks)
      hp::wgmma_rs_wide<kN>(&acc[0][0], frag + 4 * ks,
                            hp::descriptor(w1_tile + P::kTile) + hp::k_major_step(ks));
    hp::wgmma_commit();
    held = s;
    if (++s == ring.stages) s = 0, parity ^= 1;
  }
  hp::wgmma_wait_all();
#pragma unroll
  for (int a = 0; a < kAtoms; ++a) hp::fence_registers(acc[a]);
  if (elected) hp::mbar_arrive(ring.empty(held));
}

// After the tail: (acc + b2) * gamma [+ residual] in float32 and one cast,
// written as bf16 into the warpgroup's swizzled wide tile, from which the
// caller stores whole 16-byte pieces. With `has_residual` the tile holds the
// residual's rows (copied there by the caller's `at_last_chunk`, landed and
// published by a barrier); each thread reads and overwrites the places of
// its own fragment. The padded columns are left alone. kScaled (K2 in
// training under drop path; the residual is then always there): residual +
// s * (acc + b2) * gamma as one FMA, s the scale of the row's sample
// (`scale`, the tile's first row `row0`); a dropped sample's rows are their
// residual.
template <int kAtoms, bool kScaled = false>
__device__ __forceinline__ void finish_in_tile(const float (&acc)[kAtoms][32], uint8_t* tile,
                                               bool has_residual, const float* __restrict__ b2,
                                               const float* __restrict__ gamma, int C,
                                               const lt::SampleScale& scale = lt::SampleScale{},
                                               long long row0 = 0) {
  const int lane = threadIdx.x & 31;
  const int row = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // and row + 8
  const int col = 2 * (lane & 3);
  float s[2] = {1.f, 1.f};
  if constexpr (kScaled) {
    s[0] = scale.of_unit(row0 + row);
    s[1] = scale.of_unit(row0 + row + 8);
  }
#pragma unroll
  for (int a = 0; a < kAtoms; ++a)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (64 * a + 8 * j >= C) continue;  // the padded columns, warp-uniform
      const int c = 64 * a + 8 * j + col;
      const float2 bb = *reinterpret_cast<const float2*>(b2 + c);
      const float2 gm = *reinterpret_cast<const float2*>(gamma + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint8_t* p = tile + a * hp::kTileBytes + hp::swizzled(row + 8 * half, j) + (lane & 3) * 4;
        float v0 = (acc[a][4 * j + 2 * half] + bb.x) * gm.x;
        float v1 = (acc[a][4 * j + 2 * half + 1] + bb.y) * gm.y;
        if constexpr (kScaled) {
          const float2 res = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
          const float sr = s[half];
          v0 = sr == 0.f ? res.x : fmaf(v0, sr, res.x);
          v1 = sr == 0.f ? res.y : fmaf(v1, sr, res.y);
        } else if (has_residual) {
          const float2 res = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
          v0 += res.x;
          v1 += res.y;
        }
        *reinterpret_cast<uint32_t*>(p) = hp::pack_bf16(v0, v1);
      }
    }
}

}  // namespace
