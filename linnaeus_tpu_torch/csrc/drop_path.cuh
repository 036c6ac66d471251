// Stochastic depth as a per-sample scale, shared by the kernels that apply
// it inside the pass that writes a residual sum: K2 (fused_mlp_fwd*.cu,
// fused_mlp_bwd*.cu) and the scale-add kernel (drop_path_add.cu).
#pragma once

#include "common.cuh"

namespace lt {

// s[b] = (u[b] < keep) / keep for sample b, whose `per` consecutive units
// (rows for K2, elements for the scale-add kernel) follow one another; u
// holds the `samples` uniform draws in float32, null where nothing is
// scaled. `inv_keep` is 1 / keep as the caller rounded it to float32, so
// the kernels and the plain versions scale by the same number.
struct SampleScale {
  const float* u;
  float keep, inv_keep;
  long long per, samples;

  __device__ __forceinline__ float of_sample(long long b) const {
    return u[b] < keep ? inv_keep : 0.f;
  }
  // 0 past the last sample (the padded rows of a tile)
  __device__ __forceinline__ float of_unit(long long i) const {
    const long long b = i / per;
    return b < samples ? of_sample(b) : 0.f;
  }
};

// out = s[b] * in over `samples` x `per` elements (a dropped sample's are
// zeros, whatever `in` holds), in the dtype of `dtype`'s code; the launch's
// cudaError_t. drop_path_add.cu: the backward of the scale-add kernel, and
// the upstream gradient of K2's CUDA-core backward.
cudaError_t scale_samples(const void* in, void* out, const SampleScale& s, int dtype,
                          cudaStream_t stream);

}  // namespace lt
