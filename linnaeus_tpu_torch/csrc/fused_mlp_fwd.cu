// K2 forward: the ConvNeXt MLP tail fused over a tile of rows,
//   out = (GELU(LN(y) @ W1^T + b1) @ W2^T + b2) * gamma  [+ residual].
//
// Replaces the Pallas kernel linnaeus_tpu/ops/fused_mlp.py `_body` (through
// `_kernel` / `_kernel_nores`, launched by `_pallas_fused`). Same casts: the
// LayerNorm (eps given, statistics in float32) is rounded to the input dtype
// before the first product, the GELU output is rounded to the input dtype
// before the second, both products accumulate in float32, and the bias,
// layer scale and residual are applied in float32 before the one cast of
// the result.
//
// Layout: y, residual and out are (M, C) row-major. W1 is (4C, C) and W2 is
// (C, 4C), the torch Linear layout of pwconv1 / pwconv2, in the input
// dtype. The LN weight and bias, b1, b2 and gamma are float32 vectors.
//
// What bounds it on the H100: the unfused chain writes and reads an
// (M, 4C) intermediate, 8x the bytes of y, while the fused form moves only
// y, the residual and the output; at C = 96 and 192 the two products do
// 16 C operations per element moved, so once the intermediate stays on the
// chip the kernel is bound by arithmetic. bfloat16 at the widths of
// `lt::mlp_fwd_takes_wgmma` goes to the tensor-core kernel of
// fused_mlp_fwd_wgmma.cu. This file holds the entry point and the kernel for
// everything else (float32, whose 1e-5 bar no tensor-core product keeps, and
// the odd widths): one block per 64-row tile normalises its rows into shared
// memory, then walks the hidden dim in 64-column chunks, each chunk's GELU
// tile living in shared memory only; the products run as float32 FMAs on the
// CUDA cores from shared-memory tiles (each thread owns a 4-row strip of the
// output tile in registers). The tile's LayerNorm and MLP tail are device
// code shared with K3 (fused_mlp_body.cuh).

#include <stdint.h>

#include "fused_mlp_body_wgmma.cuh"

namespace {

// Shared memory: the normalised tile and the MLP tail's chunk buffers.
__host__ __device__ inline size_t smem_floats(int C) {
  return tile_floats(C) + mlp_chunk_floats(C);
}

// CPT: output columns per thread; thread column tx owns columns tx + 16 j.
// kScaled: training under drop path (drop_path.cuh), residual + s * branch.
template <typename T, int CPT, bool kScaled>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_kernel(const T* __restrict__ y, const T* __restrict__ x,
                     const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b, const T* __restrict__ w1,
                     const float* __restrict__ b1, const T* __restrict__ w2,
                     const float* __restrict__ b2,
                     const float* __restrict__ gamma, T* __restrict__ out,
                     long long M, int C, int Hd, float eps, bool approximate,
                     const lt::SampleScale scale) {
  extern __shared__ float smem[];
  const int ldh = C + 1;
  float* h0 = smem;                  // kBM x ldh
  float* act = h0 + tile_floats(C);  // kBM x (kHC + 1)
  float* wt = act + kBM * (kHC + 1); // a staged chunk of W1 or W2

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int rows = static_cast<int>(min(static_cast<long long>(kBM), M - row0));

  // 1. the tile's rows into shared memory, one warp per row, then LayerNorm
  // over them by the same lanes; rows past M become zeros
  for (int r = warp; r < rows; r += kThreads / 32) {
    const T* yr = y + (row0 + r) * C;
    for (int c = lane; c < C; c += 32) h0[r * ldh + c] = lt::to_float(yr[c]);
  }
  layer_norm_rows<T>(h0, ldh, C, rows, ln_w, ln_b, eps);

  // 2, 3. the hidden dim in chunks: GEMM1 -> GELU -> GEMM2
  float acc[4][CPT];
  mlp_tail<T, CPT>(h0, act, wt, w1, b1, w2, C, Hd, approximate, acc);

  // 4. (acc + b2) * gamma [+ residual], one cast to T; kScaled: residual +
  // s (acc + b2) * gamma as one FMA, a dropped sample's rows their residual
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gr = row0 + ty * 4 + i;
    if (gr >= M) continue;
    float s = 1.f;
    if constexpr (kScaled) s = scale.of_unit(gr);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 16 * j;
      if (c >= C) continue;
      float t = (acc[i][j] + b2[c]) * gamma[c];
      if constexpr (kScaled) {
        const float res = lt::to_float(x[gr * C + c]);
        t = s == 0.f ? res : fmaf(t, s, res);
      } else if (x != nullptr) {
        t += lt::to_float(x[gr * C + c]);
      }
      out[gr * C + c] = lt::from_float<T>(t);
    }
  }
}

template <typename T, int CPT, bool kScaled>
cudaError_t launch(const void* y, const void* x, const float* ln_w,
                   const float* ln_b, const void* w1, const float* b1,
                   const void* w2, const float* b2, const float* gamma,
                   void* out, long long M, int C, int Hd, float eps,
                   bool approximate, const lt::SampleScale& scale, cudaStream_t stream) {
  auto kernel = fused_mlp_kernel<T, CPT, kScaled>;
  const size_t bytes = smem_floats(C) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const long long blocks = (M + kBM - 1) / kBM;
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(x), ln_w, ln_b,
      static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2, gamma,
      static_cast<T*>(out), M, C, Hd, eps, approximate, scale);
  return cudaGetLastError();
}

template <typename T, bool kScaled>
cudaError_t dispatch(const void* y, const void* x, const float* ln_w,
                     const float* ln_b, const void* w1, const float* b1,
                     const void* w2, const float* b2, const float* gamma,
                     void* out, long long M, int C, int Hd, float eps,
                     bool approximate, const lt::SampleScale& scale, cudaStream_t s) {
  const int cpt = (C + 15) / 16;
#define LT_LAUNCH(N)                                                          \
  return launch<T, N, kScaled>(y, x, ln_w, ln_b, w1, b1, w2, b2, gamma, out,  \
                               M, C, Hd, eps, approximate, scale, s)
  if (cpt <= 2) LT_LAUNCH(2);
  if (cpt <= 4) LT_LAUNCH(4);
  if (cpt <= 6) LT_LAUNCH(6);
  if (cpt <= 8) LT_LAUNCH(8);
  if (cpt <= 12) LT_LAUNCH(12);
  LT_LAUNCH(16);
#undef LT_LAUNCH
}

template <typename T>
cudaError_t dispatch_scaled_or_not(const void* y, const void* x, const float* ln_w,
                                   const float* ln_b, const void* w1, const float* b1,
                                   const void* w2, const float* b2, const float* gamma,
                                   void* out, long long M, int C, int Hd, float eps,
                                   bool approximate, const lt::SampleScale& scale,
                                   cudaStream_t s) {
  return scale.u != nullptr
             ? dispatch<T, true>(y, x, ln_w, ln_b, w1, b1, w2, b2, gamma, out, M, C, Hd, eps,
                                 approximate, scale, s)
             : dispatch<T, false>(y, x, ln_w, ln_b, w1, b1, w2, b2, gamma, out, M, C, Hd, eps,
                                  approximate, scale, s);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). `x` may be null (no
// residual). Hd is the hidden width (4C for ConvNeXt). `u` null: no scale;
// otherwise drop path's per-sample scale (drop_path.cuh) over samples of
// `rows_per_sample` rows, M a whole number of them, and `x` is required.
extern "C" int lt_fused_mlp_fwd(const void* y, const void* x, const void* ln_w,
                                const void* ln_b, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                const void* gamma, void* out, const void* u,
                                long long M, int C, int Hd, float eps, int approximate,
                                int dtype, float keep, float inv_keep,
                                long long rows_per_sample, void* stream) {
  if (M < 1 || C < 1 || C > kMaxC || Hd < 1) return cudaErrorInvalidValue;
  lt::SampleScale scale{};
  if (u != nullptr) {
    if (x == nullptr || rows_per_sample < 1 || M % rows_per_sample != 0)
      return cudaErrorInvalidValue;
    scale.u = static_cast<const float*>(u);
    scale.keep = keep;
    scale.inv_keep = inv_keep;
    scale.per = rows_per_sample;
    scale.samples = M / rows_per_sample;
  }
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  if (lt::mlp_fwd_takes_wgmma(C, Hd, dtype)) {
    lt::MlpFwdArgs a;
    a.y = y;
    a.x = x;
    a.ln_w = f(ln_w);
    a.ln_b = f(ln_b);
    a.w1 = w1;
    a.b1 = f(b1);
    a.w2 = w2;
    a.b2 = f(b2);
    a.gamma = f(gamma);
    a.out = out;
    a.M = M;
    a.C = C;
    a.Hd = Hd;
    a.eps = eps;
    a.approximate = approximate != 0;
    a.scale = scale;
    a.stream = s;
    return lt::mlp_fwd_wgmma(a);
  }
  switch (dtype) {
    case lt::kFloat32:
      return dispatch_scaled_or_not<float>(y, x, f(ln_w), f(ln_b), w1, f(b1), w2, f(b2),
                                           f(gamma), out, M, C, Hd, eps, approximate != 0,
                                           scale, s);
    case lt::kBFloat16:
      return dispatch_scaled_or_not<__nv_bfloat16>(y, x, f(ln_w), f(ln_b), w1, f(b1), w2,
                                                   f(b2), f(gamma), out, M, C, Hd, eps,
                                                   approximate != 0, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// 1 where lt_fused_mlp_fwd launches the tensor-core kernel for this width,
// hidden width and dtype code, 0 where the CUDA-core kernel.
extern "C" int lt_fused_mlp_fwd_route(int C, int Hd, int dtype) {
  return lt::mlp_fwd_takes_wgmma(C, Hd, dtype) ? 1 : 0;
}
