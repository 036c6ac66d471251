// Shared by K2's backward sources, fused_mlp_bwd.cu (the C entry point and
// the CUDA-core kernels) and fused_mlp_bwd_wgmma.cu (the tensor-core
// kernels): the launch arguments, the rule that chooses between the two,
// the GELU forms, and the kernel that sums the slabs. The device code has
// internal linkage: each source compiles its own copy.
#pragma once

#include "drop_path.cuh"

namespace lt {

struct MlpBwdArgs {
  const void *y, *dout;
  const float *ln_w, *ln_b;
  const void* w1;
  const float* b1;
  const void* w2;
  const float *b2, *gamma;
  void* dy;
  float *dln_w, *dln_b, *dw1, *db1, *dw2, *db2, *dgamma, *workspace;
  long long M;
  int C, Hd;
  float eps;
  bool approximate;
  int row_blocks, slabs;
  // training under drop path (u not null): the gradients are those of
  // s * branch, taken from ds = round(s * dout) (M, C) in y's dtype, which
  // the first launch writes at the head of the workspace and every later
  // pass reads in dout's place
  SampleScale scale;
  void* ds;
  cudaStream_t stream;
};

// float32 elements of the workspace that ds takes, whole 16-byte pieces
inline long long scaled_dout_floats(long long M, int C, int dtype) {
  const long long bytes = M * C * (dtype == kFloat32 ? 4 : 2);
  return (bytes + 15) / 16 * 4;
}

// The rule of K2's backward: bfloat16 with C a multiple of 32 up to 192 and
// whole 64-column hidden chunks takes the tensor-core kernels; everything
// else (float32, whose 2e-5 bar no tensor-core product keeps, and the odd
// widths) the CUDA-core kernels. linnaeus_tpu_torch/ops/fused_mlp.py
// `backward_kernel` holds the same rule.
inline bool mlp_bwd_takes_wgmma(int C, int Hd, int dtype) {
  return dtype == kBFloat16 && C >= 32 && C <= 192 && C % 32 == 0 && Hd >= 64 &&
         Hd % 64 == 0;
}

// The tensor-core route (fused_mlp_bwd_wgmma.cu); returns the first
// non-zero cudaError_t of its launches.
cudaError_t mlp_bwd_wgmma(const MlpBwdArgs& a);

}  // namespace lt

namespace {

constexpr int kThreads = 256;

// tanh for the GELU forms. kFast: the hardware's `tanh.approx.f32`, one
// instruction, relative error up to 2^-11. The bfloat16 kernels round what
// it feeds to 2^-9 and are held to 2e-2: measured on the H100, the gradients
// move from 3e-5 .. 8e-5 of their largest magnitude off the plain version
// (tanhf) to 9e-5 .. 1.2e-4, dy not at all (3.3e-3 either way).
template <bool kFast>
__device__ __forceinline__ float tanh_of(float x) {
  if constexpr (kFast) {
    float t;
    asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(x));
    return t;
  } else {
    return tanhf(x);
  }
}

template <bool kFast = false>
__device__ __forceinline__ float gelu(float x, bool approximate) {
  if (approximate) {
    const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.f + tanh_of<kFast>(inner));
  }
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

// d gelu(x) / dx, the two forms of the TPU package's `_gelu_grad`
template <bool kFast = false>
__device__ __forceinline__ float gelu_grad(float x, bool approximate) {
  if (approximate) {
    const float c = 0.7978845608028654f;
    const float k = 0.044715f;
    const float t = tanh_of<kFast>(c * (x + k * x * x * x));
    return 0.5f * (1.f + t) +
           0.5f * x * (1.f - t * t) * c * (1.f + 3.f * k * x * x);
  }
  const float phi = expf(-0.5f * x * x) * 0.3989422804014327f;
  return 0.5f * (1.f + erff(x * 0.7071067811865476f)) + x * phi;
}

// Sums the slabs, in order, into dW1 (Hd, C), dW2 (C, Hd), db1 (Hd) and the
// four C-vectors.
__global__ void __launch_bounds__(kThreads)
    mlp_bwd_reduce_kernel(const float* __restrict__ ws_w1,
                          const float* __restrict__ ws_w2,
                          const float* __restrict__ ws_b1,
                          const float* __restrict__ part, int slabs,
                          int row_blocks, int C, int Hd, float* __restrict__ dw1,
                          float* __restrict__ dw2, float* __restrict__ db1,
                          float* __restrict__ dln_w, float* __restrict__ dln_b,
                          float* __restrict__ db2, float* __restrict__ dgamma) {
  const long long wsize = static_cast<long long>(Hd) * C;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < wsize) {
    float sum = 0.f;
    for (int s = 0; s < slabs; ++s) sum += ws_w1[s * wsize + i];
    dw1[i] = sum;
    return;
  }
  i -= wsize;
  if (i < wsize) {
    const long long c = i / Hd;
    const long long hh = i % Hd;
    float sum = 0.f;
    for (int s = 0; s < slabs; ++s) sum += ws_w2[s * wsize + hh * C + c];
    dw2[i] = sum;
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
  if (i < 4LL * C) {
    const long long k = i / C;
    const long long c = i % C;
    float sum = 0.f;
    for (int r = 0; r < row_blocks; ++r)
      sum += part[(static_cast<long long>(r) * 4 + k) * C + c];
    float* out = k == 0 ? dln_w : k == 1 ? dln_b : k == 2 ? db2 : dgamma;
    out[c] = sum;
  }
}

}  // namespace
