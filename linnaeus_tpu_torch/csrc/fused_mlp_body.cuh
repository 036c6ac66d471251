// Device code shared by the forward kernels that end in the ConvNeXt MLP
// tail: K2 (fused_mlp_fwd.cu) and K3 (fused_dwconv_mlp_fwd.cu). A block of
// 256 threads, a 16 x 16 grid, owns a tile of kBM rows: the rows are
// normalised in shared memory, then the hidden dim is walked in chunks of
// kHC columns, each chunk's GELU tile living in shared memory only, and each
// thread keeps a 4-row strip of the output tile in registers. Everything
// here has internal linkage: each source that includes this header compiles
// its own copy.
#pragma once

#include "drop_path.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kBM = 64;        // rows per block: 4 per thread row
constexpr int kHC = 64;        // hidden columns per chunk: 4 per thread column
constexpr int kMaxC = 256;     // widest C the column split below covers

__device__ __forceinline__ float gelu(float x, bool approximate) {
  if (approximate) {
    const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.f + tanhf(inner));
  }
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

// Shared memory of the MLP tail after the normalised tile (kBM x C+1): one
// chunk of GELU output (kBM x kHC+1) and one staged weight chunk, W1's
// (C x kHC+1) or W2's (kHC x C+1). The +1 pads keep the column walks free of
// bank conflicts.
__host__ __device__ inline size_t mlp_chunk_floats(int C) {
  const size_t w1 = static_cast<size_t>(C) * (kHC + 1);
  const size_t w2 = static_cast<size_t>(kHC) * (C + 1);
  return static_cast<size_t>(kBM) * (kHC + 1) + (w1 > w2 ? w1 : w2);
}

__host__ __device__ inline size_t tile_floats(int C) {
  return static_cast<size_t>(kBM) * (C + 1);
}

// LayerNorm in place over the first `rows` rows of the float32 tile h0
// (kBM x ldh), one warp per row, statistics in float32, the result rounded
// to T; rows from `rows` on become zeros. A lane touches only the columns
// lane + 32 i, so a caller whose lanes wrote the same columns of the same
// rows needs no barrier in between.
template <typename T>
__device__ __forceinline__ void layer_norm_rows(float* __restrict__ h0, int ldh,
                                                int C, int rows,
                                                const float* __restrict__ ln_w,
                                                const float* __restrict__ ln_b,
                                                float eps) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < kBM; r += kThreads / 32) {
    float* hr = h0 + r * ldh;
    if (r >= rows) {
      for (int c = lane; c < C; c += 32) hr[c] = 0.f;
      continue;
    }
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += hr[c];
    const float mean = lt::warp_sum(sum) / C;
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = hr[c] - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(lt::warp_sum(sq) / C + eps);
    for (int c = lane; c < C; c += 32)
      hr[c] = lt::round_to<T>((hr[c] - mean) * rstd * ln_w[c] + ln_b[c]);
  }
}

// acc = GELU(h0 @ W1^T + b1) @ W2^T over the whole hidden dim, for the
// normalised tile h0 (kBM x C+1, already rounded to T). `act` and `wt` are
// the chunk buffers (mlp_chunk_floats). The first barrier inside also
// publishes h0. CPT: output columns per thread; thread column tx owns
// columns tx + 16 j, thread row ty owns rows ty*4 + i.
template <typename T, int CPT>
__device__ __forceinline__ void mlp_tail(const float* __restrict__ h0,
                                         float* __restrict__ act,
                                         float* __restrict__ wt,
                                         const T* __restrict__ w1,
                                         const float* __restrict__ b1,
                                         const T* __restrict__ w2, int C,
                                         int Hd, bool approximate,
                                         float (&acc)[4][CPT]) {
  const int ldh = C + 1;
  constexpr int lda = kHC + 1;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int hc = 0; hc < Hd; hc += kHC) {
    const int nh = min(kHC, Hd - hc);
    __syncthreads();  // h0 is written; the last chunk's act and wt are used
    // stage W1[hc : hc + nh, :] as wt[c][hh] (global reads run along c)
    for (int i = tid; i < kHC * C; i += kThreads) {
      const int hh = i / C;
      const int c = i % C;
      wt[c * lda + hh] =
          hh < nh ? lt::to_float(w1[static_cast<long long>(hc + hh) * C + c]) : 0.f;
    }
    __syncthreads();

    // 2. act = round(GELU(h0 @ W1c^T + b1c)): thread owns 4 rows x 4 columns
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < C; ++c) {
      float a[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = h0[(ty * 4 + i) * ldh + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = wt[c * lda + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bw[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int hh = tx + 16 * j;
      const float bias = hh < nh ? b1[hc + hh] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        act[(ty * 4 + i) * lda + hh] =
            hh < nh ? lt::round_to<T>(gelu(s[i][j] + bias, approximate)) : 0.f;
    }
    __syncthreads();  // act is complete and wt's W1 chunk is used

    // stage W2[:, hc : hc + nh] as wt[hh][c] (global reads run along hh)
    for (int i = tid; i < C * kHC; i += kThreads) {
      const int c = i / kHC;
      const int hh = i % kHC;
      wt[hh * ldh + c] =
          hh < nh ? lt::to_float(w2[static_cast<long long>(c) * Hd + hc + hh]) : 0.f;
    }
    __syncthreads();

    // 3. acc += act @ W2c^T: thread owns 4 rows x CPT columns
    for (int hh = 0; hh < nh; ++hh) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = act[(ty * 4 + i) * lda + hh];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 16 * j;
        const float bw = c < C ? wt[hh * ldh + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], bw, acc[i][j]);
      }
    }
  }
}

}  // namespace
