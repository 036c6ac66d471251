// K2 backward in bfloat16 on the tensor cores: the passes of
// fused_mlp_bwd.cu (which holds the math, the casts, the layouts and the
// reason for the two-pass split) with every product as `wgmma`.
//
// Replaces the Pallas kernel linnaeus_tpu/ops/fused_mlp.py `_bwd_kernel`
// (launched by `_pallas_bwd`) for bfloat16 operands with C a multiple of 32
// up to 192 and Hd a multiple of 64 (`lt::mlp_bwd_takes_wgmma`).
//
// What bounds it on the H100: 32 M C^2 operations for 3 M C elements moved,
// so arithmetic. The CUDA-core kernels reached about a hundredth of the
// tensor cores' rate, with one block an SM, every load synchronous, float32
// copies of bf16 operands in shared memory and the weight chunk staged anew
// behind a barrier for every row tile. What this design does about it:
//
//   0. `mlp_bwd_prologue_kernel`, one warp a row: h0 = round(LN(y)) and
//      d2 = round(dout * gamma) once, as bf16 (M, C) in the workspace, with
//      the rows' mean and rstd. The weight pass reads every row tile once
//      per hidden chunk (6 to 12 times); with h0 and d2 made once, both
//      passes fill their tiles with plain 16-byte `cp.async` copies that
//      run while the tile before is worked on, instead of redoing the
//      LayerNorm behind a barrier each time. It costs 4 M C bytes written
//      and read again, a few percent of the kernel's time; the (M, 4C)
//      intermediates still never leave the SM.
//   1. `mlp_bwd_rows_wgmma_kernel`, persistent, one block of two warpgroups
//      an SM. Per 64-row tile, per 64-column hidden chunk:
//        a1  = h0 W1c^T   (64 x 64, inner C)   A: h0 tile,  B: W1 rows, both K-major
//        dh1 = d2 W2c     (64 x 64, inner C)   A: d2 tile,  B: W2 tile MN-major
//        a2 += h1 W2c^T   (64 x C, inner 64)   A: registers, B: W2 tile K-major
//        dh0 += da1 W1c   (64 x C, inner 64)   A: registers, B: W1 tile MN-major
//      h1 = round(GELU(a1 + b1)) and da1 = round(dh1 GELU'(a1 + b1)) are
//      formed in registers, where an accumulator fragment is pair by pair
//      the A fragment of the next product. a2 and dh0 are 2 x 96 registers a
//      thread at C = 192, more than one warpgroup holds beside the chunk
//      fragments, so the warpgroups split by side: warpgroup 0 owns a1, h1
//      and a2 and, after the chunks, dgamma and db2; warpgroup 1 owns a1
//      (again: the 64 x 64 products are the cheap ones, and nothing is then
//      exchanged between the two), dh1, da1 and dh0 and, after the chunks,
//      dy through the LayerNorm and the LN scale's and bias's sums. While
//      one warpgroup evaluates its GELU the other's products run, and
//      warpgroup 1 evaluates GELU'(a1) while its own dh1 product is still
//      running (a1 and dh1 are committed as two groups; with one block an
//      SM that overlap is a quarter of the call's time). The W1
//      and W2 chunks come through a two-stage `cp.async` ring that runs on
//      across row tiles, and the next row tile's h0 and d2 land during the
//      current tile's chunks. The four column sums go by shuffles over the
//      eight lanes that share a column into per-warp sums in shared memory,
//      added and written out in a fixed order.
//   2. `mlp_bwd_weights_wgmma_kernel`, one block of two warpgroups that
//      owns one hidden chunk and a share of the row tiles, and computes the
//      chunk's activations transposed, so that h1^T and da1^T come out of
//      the accumulators as A fragments:
//        a1^T  = W1c h0^T    (64 x 64, inner C)  A: W1 tile,  B: h0 tile, both K-major
//        dh1^T = W2c^T d2^T  (64 x 64, inner C)  A: W2 tile MN-major, B: d2 tile K-major
//        dW2c^T += h1^T d2   (64 x C, inner 64 rows)  A: registers, B: d2 tile MN-major
//        dW1c  += da1^T h0   (64 x C, inner 64 rows)  A: registers, B: h0 tile MN-major
//      Warpgroup 0 owns a1^T, h1^T and dW2c^T; warpgroup 1 a1^T, dh1^T,
//      da1^T, dW1c and db1 (the row sums of the unrounded da1^T: in the
//      thread, then across the quad). The chunk's W1 and W2 tiles are loaded
//      once; h0 and d2 tiles come through a two-stage ring.
//   3. `mlp_bwd_reduce_kernel` (fused_mlp_bwd.cuh), as on the CUDA-core route.
//
// Widths. A tile is 64-column swizzle atoms side by side (hopper.cuh). C =
// 96 is one and a half: the tiles are padded to 128 columns with zeros in
// shared memory. A product along C (a1, dh1 and their transposes) runs C /
// 16 k-steps and never reads the padding; a product across C (a2, dh0, dW1,
// dW2) runs one 64-column `wgmma` per atom and throws the padded columns
// away: a sixth more tensor-core work over the eight products at C = 96,
// none at C = 192, for no second swizzle flavour and no second instruction
// shape.
//
// Rows past M arrive as zero rows of h0 and d2. Their h1 = GELU(b1) is not
// zero, but it only meets zero rows of d2, their da1 is zero, and their dy
// is not written.
//
// The tanh form's tanh is the hardware's `tanh.approx.f32` (`tanh_of<true>`):
// with the products on the tensor cores the 2 x M x 4C evaluations of GELU
// and GELU' take as many instruction slots as the products take time
// (measured at (589824, 96) before GELU' was overlapped with dh1: tanhf 6.18
// ms a call; exp2 and a reciprocal 5.76; this 4.69; a tanh that costs
// nothing 4.52), and each warpgroup needs only one of the two forms. The erf
// form stays exact.
//
// What is left against the bound: one block of 256 threads an SM (162 to
// 255 registers a thread), so too few independent `wgmma` chains are in
// flight: the products take half of a call where the tensor cores' rate
// would make them a sixth (measured with the products cut out). Also the a1
// product done twice; the row pass's re-reads of the weight chunks from L2
// for every row tile and of y and dout, as 4-byte accesses, after the
// chunks (an eighth of a call); `cp.async` by all threads and not TMA by a
// producer warp.

#include <stdint.h>

#include "fused_mlp_bwd.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;  // rows per tile
constexpr int kHC = 64;  // hidden columns per chunk
constexpr int kWarps = kThreads / 32;

// h0 = round(LN(y)), d2 = round(dout * gamma) and (mean, rstd) of row
// blockIdx.x * 8 + warp; a lane owns eight columns.
__global__ void __launch_bounds__(kThreads)
    mlp_bwd_prologue_kernel(const bf16* __restrict__ y, const bf16* __restrict__ dout,
                            const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                            const float* __restrict__ gamma, bf16* __restrict__ h0,
                            bf16* __restrict__ d2, float* __restrict__ stats, long long M,
                            int C, float eps) {
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= M) return;  // the whole warp leaves together
  const bool owner = lane < C / 8;
  const int c0 = lane * 8;
  float v[8], g[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = g[i] = 0.f;
  if (owner) {
    const uint4 yr = *reinterpret_cast<const uint4*>(y + r * C + c0);
    const uint4 gr = *reinterpret_cast<const uint4*>(dout + r * C + c0);
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
  const float mean = lt::warp_sum(sum) / C;
  float sq = 0.f;
  if (owner) {
#pragma unroll
    for (int i = 0; i < 8; ++i) sq += (v[i] - mean) * (v[i] - mean);
  }
  const float rstd = rsqrtf(lt::warp_sum(sq) / C + eps);
  if (lane == 0) {
    stats[2 * r] = mean;
    stats[2 * r + 1] = rstd;
  }
  if (!owner) return;
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
  *reinterpret_cast<uint4*>(h0 + r * C + c0) = h_out;
  *reinterpret_cast<uint4*>(d2 + r * C + c0) = d_out;
}

// Columns hc .. hc + 63 of rows 0 .. kRows - 1 of W2 (C, Hd) into a tile
// one atom wide; rows past C arrive as zeros.
template <int kRows>
__device__ __forceinline__ void load_w2_async(uint32_t tile, const bf16* w2, int Hd, int hc,
                                              int C) {
  for (int i = threadIdx.x; i < kRows * 8; i += kThreads) {
    const int r = i >> 3;
    const int c = i & 7;
    const bool live = r < C;
    const bf16* src = w2 + (live ? static_cast<long long>(r) * Hd + hc + c * 8 : 0);
    hp::cp_async_16(tile + hp::swizzled(r, c), src, live);
  }
}

template <int kAtoms>
struct RowPass {
  static constexpr int kTile = kAtoms * hp::kTileBytes;  // 64 x (64 kAtoms) bf16
  static constexpr int kCP = kAtoms * 64;                // C padded to whole atoms
  // two stages of h0 and d2, two stages of the W1 and W2 chunks, the warps'
  // column sums, and the slack to align the tiles
  static constexpr size_t kSmemBytes = 1024 + 8 * kTile + kWarps * 2 * kCP * sizeof(float);
};

// `part` is (gridDim.x, 4, C): this block's sums for the LN scale, the LN
// bias, b2 and gamma.
template <int kAtoms>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_bwd_rows_wgmma_kernel(const bf16* __restrict__ h0g, const bf16* __restrict__ d2g,
                              const float* __restrict__ stats, const bf16* __restrict__ y,
                              const bf16* __restrict__ dout, const float* __restrict__ ln_w,
                              const bf16* __restrict__ w1, const float* __restrict__ b1,
                              const bf16* __restrict__ w2, const float* __restrict__ b2,
                              const float* __restrict__ gamma, bf16* __restrict__ dy,
                              float* __restrict__ part, long long M, int C, int Hd,
                              bool approximate) {
  using P = RowPass<kAtoms>;
  constexpr int kTile = P::kTile, kCP = P::kCP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (hp::smem_addr(smem_raw) & 1023u)) & 1023u;
  uint8_t* base = smem_raw + pad;
  const uint32_t x_ring = hp::smem_addr(base);  // stage s: h0 then d2
  const uint32_t w_ring = x_ring + 4 * kTile;   // stage s: W1 chunk then W2 chunk
  float* colsum = reinterpret_cast<float*>(base + 8 * kTile);  // [warp][2][kCP]

  const int group = threadIdx.x >> 7;  // warpgroup 0: the h1 side, 1: the da1 side
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // and row + 8
  const int col = 2 * (lane & 3);  // first of this lane's two columns of each 8
  const int chunks16 = C / 8;      // live 16-byte pieces of a row
  const int steps = C / 16;        // k-steps along C
  const int n_chunks = Hd / kHC;
  const long long tiles = (M + kBM - 1) / kBM;
  const int my_tiles = static_cast<int>((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  const long long total = static_cast<long long>(my_tiles) * n_chunks;

  for (int i = threadIdx.x; i < kWarps * 2 * kCP; i += kThreads) colsum[i] = 0.f;

  hp::load_wide_rows_async<kAtoms>(x_ring, h0g, C, blockIdx.x * kBM, M, chunks16);
  hp::load_wide_rows_async<kAtoms>(x_ring + kTile, d2g, C, blockIdx.x * kBM, M, chunks16);
  hp::load_wide_rows_async<kAtoms>(w_ring, w1, C, 0, Hd, chunks16);
  load_w2_async<kCP>(w_ring + kTile, w2, Hd, 0, C);
  hp::cp_async_commit();

  for (int it = 0; it < my_tiles; ++it) {
    const long long row0 = (blockIdx.x + static_cast<long long>(it) * gridDim.x) * kBM;
    const uint32_t h0_tile = x_ring + (it & 1) * 2 * kTile;
    const uint32_t d2_tile = h0_tile + kTile;

    float acc[kAtoms][32];  // a2 (warpgroup 0) or dh0 (warpgroup 1), [row][c]
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;

    for (int ch = 0; ch < n_chunks; ++ch) {
      const long long step = static_cast<long long>(it) * n_chunks + ch;
      const int hc = ch * kHC;
      const uint32_t w1_tile = w_ring + (step & 1) * 2 * kTile;
      const uint32_t w2_tile = w1_tile + kTile;
      // this step's tiles have landed, and every thread is done with the
      // step before, whose stage the next copies overwrite
      hp::cp_async_wait_all();
      hp::fence_async_proxy();
      __syncthreads();
      if (step + 1 < total) {
        const uint32_t next = w_ring + ((step + 1) & 1) * 2 * kTile;
        const int next_hc = (ch + 1 == n_chunks ? 0 : ch + 1) * kHC;
        hp::load_wide_rows_async<kAtoms>(next, w1, C, next_hc, Hd, chunks16);
        load_w2_async<kCP>(next + kTile, w2, Hd, next_hc, C);
      }
      if (ch == 0 && it + 1 < my_tiles) {
        const uint32_t next = x_ring + ((it + 1) & 1) * 2 * kTile;
        hp::load_wide_rows_async<kAtoms>(next, h0g, C, row0 + gridDim.x * kBM, M, chunks16);
        hp::load_wide_rows_async<kAtoms>(next + kTile, d2g, C, row0 + gridDim.x * kBM, M,
                                         chunks16);
      }
      hp::cp_async_commit();

      // a1[4 j + 2 half + e]: row + 8 half, hidden column hc + 8 j + col + e
      float a1[32], dh1[32];
      hp::wgmma_fence();
      hp::product_along_width(a1, h0_tile, w1_tile, steps);
      hp::wgmma_commit();
      if (group == 1) {
        // dh1 runs while GELU' of a1 is evaluated
        for (int ks = 0; ks < steps; ++ks)
          hp::wgmma_ss_n64<0, 1>(
              dh1, hp::descriptor(d2_tile + (ks >> 2) * hp::kTileBytes) + hp::k_major_step(ks & 3),
              hp::descriptor(w2_tile) + hp::mn_major_step(ks), ks > 0);
        hp::wgmma_commit();
        hp::wgmma_wait_all_but_newest();
      } else {
        hp::wgmma_wait_all();
      }
      hp::fence_registers(a1);

      float2 bias[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bias[j] = *reinterpret_cast<const float2*>(b1 + hc + 8 * j + col);
      uint32_t frag[16];
      if (group == 0) {
        hp::to_fragments(frag, [&](int i, int j, int, int e) {
          return gelu<true>(a1[i] + (e ? bias[j].y : bias[j].x), approximate);
        });
        // a2 += h1 W2c^T: the W2 tile K-major, 64 of its rows a product
        hp::wgmma_fence();
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
#pragma unroll
          for (int ks = 0; ks < kHC / 16; ++ks)
            hp::wgmma_rs_n64<0>(acc[a], frag + 4 * ks,
                                hp::descriptor(w2_tile + a * hp::kTileBytes) +
                                    hp::k_major_step(ks));
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 4 * j; i < 4 * j + 4; ++i)
            a1[i] = gelu_grad<true>(a1[i] + (i & 1 ? bias[j].y : bias[j].x), approximate);
        hp::wgmma_wait_all();
        hp::fence_registers(dh1);
        hp::to_fragments(frag, [&](int i, int, int, int) { return dh1[i] * a1[i]; });
        // dh0 += da1 W1c: the W1 tile MN-major, one atom of its columns a product
        hp::wgmma_fence();
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
#pragma unroll
          for (int ks = 0; ks < kHC / 16; ++ks)
            hp::wgmma_rs_n64<1>(acc[a], frag + 4 * ks,
                                hp::descriptor(w1_tile + a * hp::kTileBytes) +
                                    hp::mn_major_step(ks));
      }
      hp::wgmma_commit();
      hp::wgmma_wait_all();
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) hp::fence_registers(acc[a]);
    }

    // After the chunks. acc[a][4 j + 2 half + e]: row + 8 half, column
    // 64 a + 8 j + col + e. A column's sum over the tile's rows: the
    // thread's two rows, then the eight lanes that share the column, then
    // (lanes 0..3) into the warp's own sums in shared memory.
    const long long gr[2] = {row0 + row, row0 + row + 8};
    const bool live[2] = {gr[0] < M, gr[1] < M};
    float* sums = colsum + warp * 2 * kCP;
    auto add_column_sums = [&](int c, float (&v)[2][2]) {
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[k][e] += __shfl_xor_sync(0xffffffffu, v[k][e], 4);
          v[k][e] += __shfl_xor_sync(0xffffffffu, v[k][e], 8);
          v[k][e] += __shfl_xor_sync(0xffffffffu, v[k][e], 16);
          if (lane < 4) sums[k * kCP + c + e] += v[k][e];
        }
    };
    auto pair_at = [&](const bf16* p, int half, int c) {
      if (!live[half]) return make_float2(0.f, 0.f);
      return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + gr[half] * C + c));
    };
    if (group == 0) {
      // db2 = sum dout gamma, dgamma = sum dout (a2 + b2)
#pragma unroll
      for (int a = 0; a < kAtoms; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 64 * a + 8 * j + col;
          if (64 * a + 8 * j >= C) continue;  // the padded columns, warp-uniform
          const float2 gm = *reinterpret_cast<const float2*>(gamma + c);
          const float2 bb = *reinterpret_cast<const float2*>(b2 + c);
          float v[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 g = pair_at(dout, half, c);
            v[0][0] += g.x * gm.x;
            v[0][1] += g.y * gm.y;
            v[1][0] += g.x * (acc[a][4 * j + 2 * half] + bb.x);
            v[1][1] += g.y * (acc[a][4 * j + 2 * half + 1] + bb.y);
          }
          add_column_sums(c, v);
        }
    } else {
      // d ln_w = sum dh0 n, d ln_b = sum dh0, and dy through the LayerNorm
      float mean[2], rstd[2], sum_dn[2] = {0.f, 0.f}, sum_dnn[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mean[half] = live[half] ? stats[2 * gr[half]] : 0.f;
        rstd[half] = live[half] ? stats[2 * gr[half] + 1] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < kAtoms; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 64 * a + 8 * j + col;
          if (64 * a + 8 * j >= C) continue;
          const float2 lw = *reinterpret_cast<const float2*>(ln_w + c);
          float v[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 yv = pair_at(y, half, c);
            const float n[2] = {(yv.x - mean[half]) * rstd[half],
                                (yv.y - mean[half]) * rstd[half]};
            const float w[2] = {lw.x, lw.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float dh = acc[a][4 * j + 2 * half + e];
              v[0][e] += dh * n[e];
              v[1][e] += dh;
              const float dn = dh * w[e];
              sum_dn[half] += dn;
              sum_dnn[half] += dn * n[e];
            }
          }
          add_column_sums(c, v);
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // a row lives in the four lanes of a quad
        sum_dn[half] += __shfl_xor_sync(0xffffffffu, sum_dn[half], 1);
        sum_dn[half] += __shfl_xor_sync(0xffffffffu, sum_dn[half], 2);
        sum_dnn[half] += __shfl_xor_sync(0xffffffffu, sum_dnn[half], 1);
        sum_dnn[half] += __shfl_xor_sync(0xffffffffu, sum_dnn[half], 2);
        if (!live[half]) continue;
        const float mean_dn = sum_dn[half] / C;
        const float mean_dnn = sum_dnn[half] / C;
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = 64 * a + 8 * j + col;
            if (64 * a + 8 * j >= C) continue;
            const float2 lw = *reinterpret_cast<const float2*>(ln_w + c);
            const float2 yv = pair_at(y, half, c);
            const float n0 = (yv.x - mean[half]) * rstd[half];
            const float n1 = (yv.y - mean[half]) * rstd[half];
            const float dn0 = acc[a][4 * j + 2 * half] * lw.x;
            const float dn1 = acc[a][4 * j + 2 * half + 1] * lw.y;
            *reinterpret_cast<uint32_t*>(dy + gr[half] * C + c) =
                hp::pack_bf16(rstd[half] * (dn0 - mean_dn - n0 * mean_dnn),
                              rstd[half] * (dn1 - mean_dn - n1 * mean_dnn));
          }
      }
    }
  }

  // this block's four column sums: over the four warps of the warpgroup
  // that owns them, in order
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * C; i += kThreads) {
    const int k = i / C;  // 0: LN scale, 1: LN bias (warpgroup 1); 2: b2, 3: gamma (0)
    const int c = i % C;
    const int first_warp = k < 2 ? 4 : 0;
    float sum = 0.f;
    for (int w = 0; w < 4; ++w) sum += colsum[((first_warp + w) * 2 + (k & 1)) * kCP + c];
    part[(static_cast<long long>(blockIdx.x) * 4 + k) * C + c] = sum;
  }
}

template <int kAtoms>
struct WeightPass {
  static constexpr int kTile = kAtoms * hp::kTileBytes;
  static constexpr int kCP = kAtoms * 64;
  // the W1 and W2 chunks, two stages of h0 and d2, and the slack to align them
  static constexpr size_t kSmemBytes = 1024 + 6 * kTile;
};

// Block (x, s) owns hidden chunk x and the row tiles s, s + S, ... It writes
// its patches into slab s of ws_w1 and ws_w2, both (S, Hd, C), and of ws_b1,
// (S, Hd).
template <int kAtoms>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_bwd_weights_wgmma_kernel(const bf16* __restrict__ h0g, const bf16* __restrict__ d2g,
                                 const bf16* __restrict__ w1, const float* __restrict__ b1,
                                 const bf16* __restrict__ w2, float* __restrict__ ws_w1,
                                 float* __restrict__ ws_w2, float* __restrict__ ws_b1,
                                 long long M, int C, int Hd, bool approximate) {
  using P = WeightPass<kAtoms>;
  constexpr int kTile = P::kTile, kCP = P::kCP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (hp::smem_addr(smem_raw) & 1023u)) & 1023u;
  const uint32_t w1_tile = hp::smem_addr(smem_raw + pad);  // [hidden][c]
  const uint32_t w2_tile = w1_tile + kTile;                // [c][hidden]
  const uint32_t x_ring = w2_tile + kTile;                 // stage s: h0 then d2

  const int group = threadIdx.x >> 7;  // warpgroup 0: dW2, 1: dW1 and db1
  const int lane = threadIdx.x & 31;
  const int row = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // and row + 8: hidden
  const int col = 2 * (lane & 3);
  const int chunks16 = C / 8;
  const int steps = C / 16;
  const int hc = blockIdx.x * kHC;
  const int slab = blockIdx.y;
  const int slabs = gridDim.y;
  const long long tiles = (M + kBM - 1) / kBM;
  const int my_tiles = static_cast<int>((tiles - slab + slabs - 1) / slabs);

  hp::load_wide_rows_async<kAtoms>(w1_tile, w1, C, hc, Hd, chunks16);
  load_w2_async<kCP>(w2_tile, w2, Hd, hc, C);
  hp::load_wide_rows_async<kAtoms>(x_ring, h0g, C, slab * kBM, M, chunks16);
  hp::load_wide_rows_async<kAtoms>(x_ring + kTile, d2g, C, slab * kBM, M, chunks16);
  hp::cp_async_commit();

  const float bias[2] = {b1[hc + row], b1[hc + row + 8]};
  float acc[kAtoms][32];  // dW2c^T (warpgroup 0) or dW1c (warpgroup 1), [hidden][c]
#pragma unroll
  for (int a = 0; a < kAtoms; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
  float db1[2] = {0.f, 0.f};

  for (int it = 0; it < my_tiles; ++it) {
    const long long row0 = (slab + static_cast<long long>(it) * slabs) * kBM;
    const uint32_t h0_tile = x_ring + (it & 1) * 2 * kTile;
    const uint32_t d2_tile = h0_tile + kTile;
    hp::cp_async_wait_all();
    hp::fence_async_proxy();
    __syncthreads();
    if (it + 1 < my_tiles) {
      const uint32_t next = x_ring + ((it + 1) & 1) * 2 * kTile;
      hp::load_wide_rows_async<kAtoms>(next, h0g, C, row0 + slabs * kBM, M, chunks16);
      hp::load_wide_rows_async<kAtoms>(next + kTile, d2g, C, row0 + slabs * kBM, M, chunks16);
    }
    hp::cp_async_commit();

    // a1t[4 j + 2 half + e]: hidden row + 8 half, row row0 + 8 j + col + e
    float a1t[32], dh1t[32];
    hp::wgmma_fence();
    hp::product_along_width(a1t, w1_tile, h0_tile, steps);
    hp::wgmma_commit();
    if (group == 1) {
      // dh1^T = W2c^T d2^T, the W2 tile as a transposed A operand, runs
      // while GELU' of a1^T is evaluated
      for (int ks = 0; ks < steps; ++ks)
        hp::wgmma_ss_n64<1, 0>(
            dh1t, hp::descriptor(w2_tile) + hp::mn_major_step(ks),
            hp::descriptor(d2_tile + (ks >> 2) * hp::kTileBytes) + hp::k_major_step(ks & 3),
            ks > 0);
      hp::wgmma_commit();
      hp::wgmma_wait_all_but_newest();
    } else {
      hp::wgmma_wait_all();
    }
    hp::fence_registers(a1t);

    uint32_t frag[16];
    uint32_t other;  // the tile whose rows the fragments meet
    if (group == 0) {
      hp::to_fragments(frag, [&](int i, int, int half, int) {
        return gelu<true>(a1t[i] + bias[half], approximate);
      });
      other = d2_tile;  // dW2c^T += h1^T d2
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        a1t[i] = gelu_grad<true>(a1t[i] + bias[(i >> 1) & 1], approximate);
      hp::wgmma_wait_all();
      hp::fence_registers(dh1t);
      hp::to_fragments(frag, [&](int i, int, int half, int) {
        const float da1 = dh1t[i] * a1t[i];
        db1[half] += da1;
        return da1;
      });
      other = h0_tile;  // dW1c += da1^T h0
    }
    hp::wgmma_fence();
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
#pragma unroll
      for (int ks = 0; ks < kBM / 16; ++ks)
        hp::wgmma_rs_n64<1>(acc[a], frag + 4 * ks,
                            hp::descriptor(other + a * hp::kTileBytes) + hp::mn_major_step(ks));
    hp::wgmma_commit();
    hp::wgmma_wait_all();
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) hp::fence_registers(acc[a]);
  }

  float* ws = group == 0 ? ws_w2 : ws_w1;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float* out = ws + (static_cast<long long>(slab) * Hd + hc + row + 8 * half) * C;
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * a + 8 * j + col;
        if (64 * a + 8 * j >= C) continue;
        *reinterpret_cast<float2*>(out + c) =
            make_float2(acc[a][4 * j + 2 * half], acc[a][4 * j + 2 * half + 1]);
      }
    if (group == 1) {
      db1[half] += __shfl_xor_sync(0xffffffffu, db1[half], 1);
      db1[half] += __shfl_xor_sync(0xffffffffu, db1[half], 2);
      if ((lane & 3) == 0)
        ws_b1[static_cast<long long>(slab) * Hd + hc + row + 8 * half] = db1[half];
    }
  }
}

template <int kAtoms>
cudaError_t launch(const lt::MlpBwdArgs& a) {
  const long long wsize = static_cast<long long>(a.Hd) * a.C;
  // the workspace: h0 and d2 in bf16, the rows' (mean, rstd), then the slabs
  bf16* h0 = reinterpret_cast<bf16*>(a.workspace);
  bf16* d2 = h0 + a.M * a.C;
  float* stats = a.workspace + a.M * a.C;
  float* part = stats + 2 * a.M;  // (row_blocks, 4, C)
  float* ws_w1 = part + static_cast<long long>(a.row_blocks) * 4 * a.C;
  float* ws_w2 = ws_w1 + a.slabs * wsize;
  float* ws_b1 = ws_w2 + a.slabs * wsize;
  const bf16* y = static_cast<const bf16*>(a.y);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const bf16* w1 = static_cast<const bf16*>(a.w1);
  const bf16* w2 = static_cast<const bf16*>(a.w2);

  mlp_bwd_prologue_kernel<<<static_cast<unsigned>((a.M + kWarps - 1) / kWarps), kThreads, 0,
                            a.stream>>>(y, dout, a.ln_w, a.ln_b, a.gamma, h0, d2, stats, a.M,
                                        a.C, a.eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = lt::launch_with_smem(mlp_bwd_rows_wgmma_kernel<kAtoms>, dim3(a.row_blocks), kThreads,
                             RowPass<kAtoms>::kSmemBytes, a.stream, h0, d2, stats, y, dout,
                             a.ln_w, w1, a.b1, w2, a.b2, a.gamma, static_cast<bf16*>(a.dy),
                             part, a.M, a.C, a.Hd, a.approximate);
  if (err != cudaSuccess) return err;

  err = lt::launch_with_smem(mlp_bwd_weights_wgmma_kernel<kAtoms>,
                             dim3(a.Hd / kHC, a.slabs), kThreads,
                             WeightPass<kAtoms>::kSmemBytes, a.stream, h0, d2, w1, a.b1, w2,
                             ws_w1, ws_w2, ws_b1, a.M, a.C, a.Hd, a.approximate);
  if (err != cudaSuccess) return err;

  const long long outputs = 2 * wsize + a.Hd + 4LL * a.C;
  mlp_bwd_reduce_kernel<<<static_cast<unsigned>((outputs + kThreads - 1) / kThreads),
                          kThreads, 0, a.stream>>>(
      ws_w1, ws_w2, ws_b1, part, a.slabs, a.row_blocks, a.C, a.Hd, a.dw1, a.dw2, a.db1,
      a.dln_w, a.dln_b, a.db2, a.dgamma);
  return cudaGetLastError();
}

}  // namespace

cudaError_t lt::mlp_bwd_wgmma(const lt::MlpBwdArgs& a) {
  switch ((a.C + 63) / 64) {
    case 1:
      return launch<1>(a);
    case 2:
      return launch<2>(a);
    default:
      return launch<3>(a);
  }
}
