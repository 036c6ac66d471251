// Helpers shared by the port's kernels: conversions between the storage
// type T (float or __nv_bfloat16) and the float32 the kernels compute in,
// and the launch of a kernel with a large dynamic shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lt {

// dtype codes of the C interface, matched by linnaeus_tpu_torch/_kernels.py
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a dtype cast
}

// The float that a cast to T keeps: where the TPU kernel casts an fp32
// intermediate to the input dtype before a matrix product, this does too.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Launches `kernel` with `smem` bytes of dynamic shared memory (more than
// the 48 KB a kernel may use unasked) and returns the launch's error.
template <typename Kernel, typename... Args>
cudaError_t launch_with_smem(Kernel kernel, dim3 grid, int threads, size_t smem,
                             cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace lt
