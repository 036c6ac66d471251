// K2 backward: gradients of the fused ConvNeXt MLP tail
//   out = (GELU(LN(y) @ W1^T + b1) @ W2^T + b2) * gamma  [+ residual]
// with respect to y and the seven parameter tensors. The residual's
// gradient is dout itself and stays in the wrapper.
//
// Replaces the Pallas kernel linnaeus_tpu/ops/fused_mlp.py `_bwd_kernel`
// (launched by `_pallas_bwd`). Same math and casts: the forward is
// recomputed in the tile (LN statistics in float32, h0 = LN(y) and
// h1 = GELU(a1) rounded to the input dtype before their products, float32
// accumulation), da2 = dout * gamma and da1 = dh1 * GELU'(a1) are rounded
// to the input dtype before the products they enter, the bias, gamma and
// LN parameter gradients are summed from the unrounded float32 values, and
// dy goes back through the LayerNorm in float32. The (M, 4C) intermediates
// never reach device memory. Rows past M are masked, not padded by a copy.
//
// Layout: y, dout and dy are (M, C) row-major in the input dtype. W1 is
// (4C, C) and W2 is (C, 4C), the torch Linear layout, in the input dtype,
// and dW1, dW2 come back in the same layouts in float32. The vectors and
// their gradients are float32.
//
// Design. The TPU kernel summed the weight gradients over a sequential grid
// with the accumulators resident in VMEM; here blocks run in parallel and
// dW1 + dW2 (295 KB at C = 96, 1.18 MB at C = 192 in float32) exceed an
// SM's shared memory, while dy needs each row's sum over all 4C hidden
// columns. No one loop order keeps both kinds of sum on the chip, so the
// work is split into two persistent passes and a reduction, all
// deterministic (no atomics):
//   1. the row pass: a block walks 64-row tiles; per tile it walks the
//      hidden dim in 64-column chunks keeping a2 and dh0 (64 x C) in
//      registers, then forms dy and adds the tile's column sums for dgamma,
//      db2 and the LN scale and bias. At its end each block writes its four
//      C-vectors into its own slab.
//   2. the weight pass: a block owns one 64-column hidden chunk and a share
//      of the row tiles; it keeps that chunk of W1 and W2 in shared memory
//      and its (64 x C) patches of dW1 and dW2 in registers across all its
//      tiles, recomputing h1 and da1 for the chunk, and writes the patches
//      and its db1 into its own slab.
//   3. `mlp_bwd_reduce_kernel` (fused_mlp_bwd.cuh) sums the slabs in a fixed
//      order into the outputs.
// The price of the split is that h1 and dh1 are computed in both passes:
// eight (64 x C x 64) products per tile and chunk where the TPU kernel did
// six.
//
// What bounds it on the H100: 32 M C^2 operations for 3 M C elements moved,
// so arithmetic, and the card's arithmetic is in its tensor cores (989
// TFLOP/s in bf16 against 67 on the CUDA cores). Two sets of kernels,
// chosen by dtype and width in `lt_fused_mlp_bwd` (`lt::mlp_bwd_takes_wgmma`):
// bfloat16 with C a multiple of 32 runs every product as `wgmma`
// (fused_mlp_bwd_wgmma.cu says how). float32, which has no tensor-core
// product that keeps its 2e-5 agreement with the plain version, and the
// other widths run the kernels of this file: float32 FMAs on the CUDA cores
// from padded float32 shared-memory tiles, a 16 x 16 grid of threads that
// each own a 4 x 4 patch of a tile product, one block of 256 threads per SM
// at the widths of the model (116 .. 215 KB of shared memory).

#include <stdint.h>

#include "fused_mlp_bwd.cuh"

namespace {

constexpr int kBM = 64;        // rows per tile: 4 per thread row
constexpr int kHC = 64;        // hidden columns per chunk: 4 per thread column
constexpr int kMaxC = 192;     // widest C whose tiles fit shared memory
constexpr int kLda = kHC + 1;  // padded row of the chunk-activation tile

// Shared memory of both kernels: h0 and d2 (kBM x C+1 each), one chunk of
// activations (kBM x kHC+1), the W1 and W2 chunks (kHC x C+1 each, both
// stored [hidden][c]) and the rows' mean and rstd. C+1 is odd for even C,
// which keeps the strided column walks free of bank conflicts.
__host__ __device__ inline size_t smem_floats(int C) {
  const size_t ldh = static_cast<size_t>(C) + 1;
  return 2 * kBM * ldh + kBM * kLda + 2 * kHC * ldh + 2 * kBM;
}

struct Tiles {
  float *h0, *d2, *act, *w1s, *w2s, *stats;
  int ldh;
};

__device__ __forceinline__ Tiles carve(float* smem, int C) {
  Tiles t;
  t.ldh = C + 1;
  t.h0 = smem;
  t.d2 = t.h0 + kBM * t.ldh;
  t.act = t.d2 + kBM * t.ldh;
  t.w1s = t.act + kBM * kLda;
  t.w2s = t.w1s + kHC * t.ldh;
  t.stats = t.w2s + kHC * t.ldh;
  return t;
}

// h0 = round(LN(y)) of rows row0 .. row0 + 63, one warp per row, with the
// rows' mean and rstd beside it; rows past M are zeros.
template <typename T>
__device__ __forceinline__ void layer_norm_tile(
    const T* __restrict__ y, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, long long row0, long long M, int C,
    float eps, const Tiles& t) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < kBM; r += kThreads / 32) {
    float* hr = t.h0 + r * t.ldh;
    const long long gr = row0 + r;
    if (gr >= M) {
      for (int c = lane; c < C; c += 32) hr[c] = 0.f;
      if (lane == 0) t.stats[2 * r] = t.stats[2 * r + 1] = 0.f;
      continue;
    }
    const T* yr = y + gr * C;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = lt::to_float(yr[c]);
      hr[c] = v;
      sum += v;
    }
    const float mean = lt::warp_sum(sum) / C;
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = hr[c] - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(lt::warp_sum(sq) / C + eps);
    for (int c = lane; c < C; c += 32)
      hr[c] = lt::round_to<T>((hr[c] - mean) * rstd * ln_w[c] + ln_b[c]);
    if (lane == 0) {
      t.stats[2 * r] = mean;
      t.stats[2 * r + 1] = rstd;
    }
  }
}

// d2 = round(dout * gamma) of the tile; rows past M are zeros.
template <typename T>
__device__ __forceinline__ void load_d2(const T* __restrict__ dout,
                                        const float* __restrict__ gamma,
                                        long long row0, long long M, int C,
                                        const Tiles& t) {
  for (int i = threadIdx.x; i < kBM * C; i += kThreads) {
    const int r = i / C;
    const int c = i % C;
    const long long gr = row0 + r;
    t.d2[r * t.ldh + c] =
        gr < M ? lt::round_to<T>(lt::to_float(dout[gr * C + c]) * gamma[c]) : 0.f;
  }
}

// The chunk's rows of W1 (4C, C) and columns of W2 (C, 4C), both as
// [hidden][c]; hidden columns past the end are zeros.
template <typename T>
__device__ __forceinline__ void stage_weights(const T* __restrict__ w1,
                                              const T* __restrict__ w2, int hc,
                                              int nh, int C, int Hd,
                                              const Tiles& t) {
  for (int i = threadIdx.x; i < kHC * C; i += kThreads) {
    const int hh = i / C;
    const int c = i % C;
    t.w1s[hh * t.ldh + c] =
        hh < nh ? lt::to_float(w1[static_cast<long long>(hc + hh) * C + c]) : 0.f;
  }
  for (int i = threadIdx.x; i < C * kHC; i += kThreads) {
    const int c = i / kHC;
    const int hh = i % kHC;
    t.w2s[hh * t.ldh + c] =
        hh < nh ? lt::to_float(w2[static_cast<long long>(c) * Hd + hc + hh]) : 0.f;
  }
}

// out[i][j] = sum_c a[(ty*4 + i)][c] * w[(tx + 16 j)][c]: a (rows x C) tile
// against a [hidden][c] weight chunk, giving this thread's 4 x 4 patch of a
// (rows x hidden) product.
__device__ __forceinline__ void rows_times_chunk_t(const float* __restrict__ a,
                                                   const float* __restrict__ w,
                                                   int ldh, int C, int tx,
                                                   int ty, float (&out)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    float av[4], wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * ldh + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) wv[j] = w[(tx + 16 * j) * ldh + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(av[i], wv[j], out[i][j]);
  }
}

// acc[i][j] += sum_k a[(ty*4 + i)][k] * w[k][tx + 16 j], k < n: the chunk's
// activations (rows x hidden) against a [hidden][c] weight chunk, adding to
// this thread's 4 x CPT patch of a (rows x C) product.
template <int CPT>
__device__ __forceinline__ void act_times_chunk(const float* __restrict__ a,
                                                const float* __restrict__ w,
                                                int ldh, int C, int n, int tx,
                                                int ty, float (&acc)[4][CPT]) {
  for (int k = 0; k < n; ++k) {
    float av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * kLda + k];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 16 * j;
      const float wv = c < C ? w[k * ldh + c] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], wv, acc[i][j]);
    }
  }
}

// acc[i][j] += sum_r a[r][ty*4 + i] * b[r][tx + 16 j] over the tile's rows:
// the (hidden x C) weight-gradient patch from a chunk of activations
// (rows x hidden) and a (rows x C) tile.
template <int CPT>
__device__ __forceinline__ void act_t_times_rows(const float* __restrict__ a,
                                                 const float* __restrict__ b,
                                                 int ldh, int C, int tx, int ty,
                                                 float (&acc)[4][CPT]) {
  for (int r = 0; r < kBM; ++r) {
    float av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[r * kLda + ty * 4 + i];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 16 * j;
      const float bv = c < C ? b[r * ldh + c] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], bv, acc[i][j]);
    }
  }
}

// CPT: columns of C per thread; thread column tx owns columns tx + 16 j.
// `part` is (gridDim.x, 4, C): this block's sums for the LN scale, the LN
// bias, b2 and gamma.
template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
    mlp_bwd_rows_kernel(const T* __restrict__ y, const T* __restrict__ dout,
                        const float* __restrict__ ln_w,
                        const float* __restrict__ ln_b,
                        const T* __restrict__ w1, const float* __restrict__ b1,
                        const T* __restrict__ w2, const float* __restrict__ b2,
                        const float* __restrict__ gamma, T* __restrict__ dy,
                        float* __restrict__ part, long long M, int C, int Hd,
                        float eps, bool approximate) {
  extern __shared__ float smem[];
  const Tiles t = carve(smem, C);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long tiles = (M + kBM - 1) / kBM;

  float col[4][CPT];  // d ln_w, d ln_b, d b2, d gamma: this thread's rows
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < CPT; ++j) col[k][j] = 0.f;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kBM;
    __syncthreads();  // the previous tile's reads of the shared tiles are done
    layer_norm_tile(y, ln_w, ln_b, row0, M, C, eps, t);
    load_d2(dout, gamma, row0, M, C, t);

    float a2[4][CPT], dh0[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) a2[i][j] = dh0[i][j] = 0.f;

    for (int hc = 0; hc < Hd; hc += kHC) {
      const int nh = min(kHC, Hd - hc);
      __syncthreads();  // h0, d2 written; the last chunk's act, w1s, w2s used
      stage_weights(w1, w2, hc, nh, C, Hd, t);
      __syncthreads();

      // a1 = h0 @ W1c^T + b1c; h1 = round(GELU(a1)) into act; keep GELU'(a1)
      float s[4][4], gg[4][4];
      rows_times_chunk_t(t.h0, t.w1s, t.ldh, C, tx, ty, s);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int hh = tx + 16 * j;
        const bool live = hh < nh;
        const float bias = live ? b1[hc + hh] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a1 = s[i][j] + bias;
          gg[i][j] = live ? gelu_grad(a1, approximate) : 0.f;
          t.act[(ty * 4 + i) * kLda + hh] =
              live ? lt::round_to<T>(gelu(a1, approximate)) : 0.f;
        }
      }
      __syncthreads();

      // a2 += h1 @ W2c^T; dh1 = d2 @ W2c
      act_times_chunk<CPT>(t.act, t.w2s, t.ldh, C, nh, tx, ty, a2);
      rows_times_chunk_t(t.d2, t.w2s, t.ldh, C, tx, ty, s);
      __syncthreads();  // every read of h1 in act is done
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          t.act[(ty * 4 + i) * kLda + tx + 16 * j] =
              lt::round_to<T>(s[i][j] * gg[i][j]);  // da1, zero past nh
      __syncthreads();

      // dh0 += da1 @ W1c
      act_times_chunk<CPT>(t.act, t.w1s, t.ldh, C, nh, tx, ty, dh0);
    }

    // dy through the LayerNorm, and the column sums of this thread's rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const long long gr = row0 + r;
      const bool live = gr < M;
      const float mean = t.stats[2 * r];
      const float rstd = t.stats[2 * r + 1];
      float sum_dn = 0.f, sum_dnn = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 16 * j;
        if (live && c < C) {
          const float n = (lt::to_float(y[gr * C + c]) - mean) * rstd;
          const float g = lt::to_float(dout[gr * C + c]);
          col[0][j] += dh0[i][j] * n;
          col[1][j] += dh0[i][j];
          col[2][j] += g * gamma[c];
          col[3][j] += g * (a2[i][j] + b2[c]);
          const float dn = dh0[i][j] * ln_w[c];
          sum_dn += dn;
          sum_dnn += dn * n;
        }
      }
      // the row's 16 threads are the 16 lanes of one half warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum_dn += __shfl_xor_sync(0xffffffffu, sum_dn, off);
        sum_dnn += __shfl_xor_sync(0xffffffffu, sum_dnn, off);
      }
      const float mean_dn = sum_dn / C;
      const float mean_dnn = sum_dnn / C;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 16 * j;
        if (live && c < C) {
          const float n = (lt::to_float(y[gr * C + c]) - mean) * rstd;
          const float dn = dh0[i][j] * ln_w[c];
          dy[gr * C + c] =
              lt::from_float<T>(rstd * (dn - mean_dn - n * mean_dnn));
        }
      }
    }
  }

  // this block's four column sums: over the 16 thread rows, in order
  __syncthreads();
  float* red = t.h0;  // (16, 4, C) fits the h0 tile
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 16 * j;
      if (c < C) red[(ty * 4 + k) * C + c] = col[k][j];
    }
  __syncthreads();
  for (int i = tid; i < 4 * C; i += kThreads) {
    const int k = i / C;
    const int c = i % C;
    float sum = 0.f;
    for (int r = 0; r < 16; ++r) sum += red[(r * 4 + k) * C + c];
    part[(static_cast<long long>(blockIdx.x) * 4 + k) * C + c] = sum;
  }
}

// Block (x, s) owns hidden chunk x and the row tiles s, s + S, ... It writes
// its patches into slab s of ws_w1 and ws_w2, both (S, Hd, C), and of ws_b1,
// (S, Hd).
template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
    mlp_bwd_weights_kernel(const T* __restrict__ y, const T* __restrict__ dout,
                           const float* __restrict__ ln_w,
                           const float* __restrict__ ln_b,
                           const T* __restrict__ w1,
                           const float* __restrict__ b1,
                           const T* __restrict__ w2,
                           const float* __restrict__ gamma,
                           float* __restrict__ ws_w1, float* __restrict__ ws_w2,
                           float* __restrict__ ws_b1, long long M, int C,
                           int Hd, float eps, bool approximate) {
  extern __shared__ float smem[];
  const Tiles t = carve(smem, C);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long tiles = (M + kBM - 1) / kBM;
  const int hc = blockIdx.x * kHC;
  const int nh = min(kHC, Hd - hc);
  const int slab = blockIdx.y;
  const int slabs = gridDim.y;

  stage_weights(w1, w2, hc, nh, C, Hd, t);

  // patches of dW1 and dW2 as [hidden ty*4 + i][c tx + 16 j]; db1 of the
  // hidden columns tx + 16 j over this thread's rows
  float dw1[4][CPT], dw2[4][CPT], db1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    db1[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) dw1[i][j] = dw2[i][j] = 0.f;
  }

  for (long long tile = slab; tile < tiles; tile += slabs) {
    const long long row0 = tile * kBM;
    __syncthreads();  // the previous tile's reads of h0, d2 and act are done
    layer_norm_tile(y, ln_w, ln_b, row0, M, C, eps, t);
    load_d2(dout, gamma, row0, M, C, t);
    __syncthreads();  // and, the first time, the staged weights are there

    float s[4][4], da1[4][4];
    rows_times_chunk_t(t.h0, t.w1s, t.ldh, C, tx, ty, s);
    rows_times_chunk_t(t.d2, t.w2s, t.ldh, C, tx, ty, da1);  // dh1
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int hh = tx + 16 * j;
      const bool live = hh < nh;
      const float bias = live ? b1[hc + hh] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a1 = s[i][j] + bias;
        da1[i][j] *= live ? gelu_grad(a1, approximate) : 0.f;
        db1[j] += da1[i][j];
        t.act[(ty * 4 + i) * kLda + hh] =
            live ? lt::round_to<T>(gelu(a1, approximate)) : 0.f;
      }
    }
    __syncthreads();

    // dW2c += h1^T @ d2
    act_t_times_rows<CPT>(t.act, t.d2, t.ldh, C, tx, ty, dw2);
    __syncthreads();  // every read of h1 in act is done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        t.act[(ty * 4 + i) * kLda + tx + 16 * j] = lt::round_to<T>(da1[i][j]);
    __syncthreads();

    // dW1c += da1^T @ h0
    act_t_times_rows<CPT>(t.act, t.h0, t.ldh, C, tx, ty, dw1);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int hh = ty * 4 + i;
    if (hh >= nh) continue;
    const long long base = (static_cast<long long>(slab) * Hd + hc + hh) * C;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 16 * j;
      if (c < C) {
        ws_w1[base + c] = dw1[i][j];
        ws_w2[base + c] = dw2[i][j];
      }
    }
  }
  // db1: over the 16 thread rows, in order
  __syncthreads();
  float* red = t.act;  // (16, 64) fits the activation tile
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty * kHC + tx + 16 * j] = db1[j];
  __syncthreads();
  if (tid < nh) {
    float sum = 0.f;
    for (int r = 0; r < 16; ++r) sum += red[r * kHC + tid];
    ws_b1[static_cast<long long>(slab) * Hd + hc + tid] = sum;
  }
}

template <typename T, int CPT>
cudaError_t launch(const lt::MlpBwdArgs& a) {
  const size_t bytes = smem_floats(a.C) * sizeof(float);
  auto rows_kernel = mlp_bwd_rows_kernel<T, CPT>;
  auto weights_kernel = mlp_bwd_weights_kernel<T, CPT>;
  cudaError_t err = cudaFuncSetAttribute(
      rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(weights_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;

  const long long wsize = static_cast<long long>(a.Hd) * a.C;
  float* part = a.workspace;  // (row_blocks, 4, C)
  float* ws_w1 = part + static_cast<long long>(a.row_blocks) * 4 * a.C;
  float* ws_w2 = ws_w1 + a.slabs * wsize;
  float* ws_b1 = ws_w2 + a.slabs * wsize;
  const T* y = static_cast<const T*>(a.y);
  const T* dout = static_cast<const T*>(a.dout);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w2 = static_cast<const T*>(a.w2);

  rows_kernel<<<a.row_blocks, kThreads, bytes, a.stream>>>(
      y, dout, a.ln_w, a.ln_b, w1, a.b1, w2, a.b2, a.gamma,
      static_cast<T*>(a.dy), part, a.M, a.C, a.Hd, a.eps, a.approximate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid((a.Hd + kHC - 1) / kHC, a.slabs);
  weights_kernel<<<grid, kThreads, bytes, a.stream>>>(
      y, dout, a.ln_w, a.ln_b, w1, a.b1, w2, a.gamma, ws_w1, ws_w2, ws_b1, a.M,
      a.C, a.Hd, a.eps, a.approximate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long outputs = 2 * wsize + a.Hd + 4LL * a.C;
  mlp_bwd_reduce_kernel<<<static_cast<unsigned>((outputs + kThreads - 1) / kThreads),
                          kThreads, 0, a.stream>>>(
      ws_w1, ws_w2, ws_b1, part, a.slabs, a.row_blocks, a.C, a.Hd, a.dw1, a.dw2,
      a.db1, a.dln_w, a.dln_b, a.db2, a.dgamma);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const lt::MlpBwdArgs& a) {
  const int cpt = (a.C + 15) / 16;
  if (cpt <= 2) return launch<T, 2>(a);
  if (cpt <= 4) return launch<T, 4>(a);
  if (cpt <= 6) return launch<T, 6>(a);
  if (cpt <= 8) return launch<T, 8>(a);
  return launch<T, 12>(a);
}

}  // namespace

// Returns the first non-zero cudaError_t of its launches (0 on success).
// `in` holds the 9 input pointers y, dout, ln_w, ln_b, w1, b1, w2, b2, gamma
// and `out` the 8 output pointers dy, dln_w, dln_b, dw1, db1, dw2, db2,
// dgamma. `workspace` is float32 of at least
//   row_blocks * 4 * C + slabs * (2 * Hd * C + Hd)
// elements, and M * C + 2 * M more where `lt_fused_mlp_bwd_route` says 1,
// and `lt::scaled_dout_floats` more where `u` is not null, and needs no
// initialising: `row_blocks` blocks run the row pass and `slabs` blocks per
// hidden chunk run the weight pass. `u` not null: the gradients of the
// branch that drop path's per-sample scale (drop_path.cuh) multiplies, over
// samples of `rows_per_sample` rows, M a whole number of them.
extern "C" int lt_fused_mlp_bwd(const void* const* in, void* const* out,
                                void* workspace, long long M, int C, int Hd,
                                float eps, int approximate, int row_blocks,
                                int slabs, int dtype, const void* u, float keep,
                                float inv_keep, long long rows_per_sample, void* stream) {
  if (M < 1 || C < 1 || C > kMaxC || Hd < 1 || row_blocks < 1 || slabs < 1)
    return cudaErrorInvalidValue;
  if (dtype != lt::kFloat32 && dtype != lt::kBFloat16) return cudaErrorInvalidValue;
  if (u != nullptr && (rows_per_sample < 1 || M % rows_per_sample != 0))
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto g = [](void* p) { return static_cast<float*>(p); };
  lt::MlpBwdArgs a;
  a.y = in[0];
  a.dout = in[1];
  a.ln_w = f(in[2]);
  a.ln_b = f(in[3]);
  a.w1 = in[4];
  a.b1 = f(in[5]);
  a.w2 = in[6];
  a.b2 = f(in[7]);
  a.gamma = f(in[8]);
  a.dy = out[0];
  a.dln_w = g(out[1]);
  a.dln_b = g(out[2]);
  a.dw1 = g(out[3]);
  a.db1 = g(out[4]);
  a.dw2 = g(out[5]);
  a.db2 = g(out[6]);
  a.dgamma = g(out[7]);
  a.workspace = g(workspace);
  a.M = M;
  a.C = C;
  a.Hd = Hd;
  a.eps = eps;
  a.approximate = approximate != 0;
  a.row_blocks = row_blocks;
  a.slabs = slabs;
  a.stream = static_cast<cudaStream_t>(stream);
  a.scale = lt::SampleScale{};
  a.ds = nullptr;
  if (u != nullptr) {
    a.scale.u = static_cast<const float*>(u);
    a.scale.keep = keep;
    a.scale.inv_keep = inv_keep;
    a.scale.per = rows_per_sample;
    a.scale.samples = M / rows_per_sample;
    a.ds = workspace;
    a.workspace = g(workspace) + lt::scaled_dout_floats(M, C, dtype);
  }
  // the tensor-core route's prologue writes ds itself
  if (lt::mlp_bwd_takes_wgmma(C, Hd, dtype)) return lt::mlp_bwd_wgmma(a);
  if (u != nullptr) {
    lt::SampleScale by_element = a.scale;
    by_element.per = rows_per_sample * C;
    const cudaError_t err = lt::scale_samples(a.dout, a.ds, by_element, dtype, a.stream);
    if (err != cudaSuccess) return err;
    a.dout = a.ds;
  }
  switch (dtype) {
    case lt::kFloat32:
      return dispatch<float>(a);
    case lt::kBFloat16:
      return dispatch<__nv_bfloat16>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

// Which kernels `lt_fused_mlp_bwd` launches for these operands: 1 for the
// tensor-core kernels, 0 for the CUDA-core kernels.
extern "C" int lt_fused_mlp_bwd_route(int C, int Hd, int dtype) {
  return lt::mlp_bwd_takes_wgmma(C, Hd, dtype) ? 1 : 0;
}
