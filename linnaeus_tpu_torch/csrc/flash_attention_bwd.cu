// K1 backward: dQ, dK and dV of softmax attention from one recomputed P.
//
// Replaces the Pallas kernel linnaeus_tpu/ops/flash_attention.py
// `_flash_bwd_fused_kernel` and the host part of `_flash_bwd_rule` (the
// row sums delta = sum_d dO * O). Same math and casts: S = Q K^T in float32
// times the scale, P = exp(S - lse) with the forward's log-sum-exp, P cast
// to the input dtype before dV = P^T dO, dP = dO V^T, dS = P * (dP - delta)
// cast to the input dtype before dQ = dS K * scale and dK = dS^T Q * scale.
// P is computed once for each (query, key) pair and feeds all three
// gradients.
//
// Layout: q, k, v and dO are token-major (B, N, H, D) read through their
// strides (unit-stride head dim), as in the forward, so the views out of a
// qkv projection need no copy; O is contiguous (B, N, H, D); lse and the
// delta workspace are (B, H, N) float32. dQ, dK and dV are written through
// strides of their own, so they may be the three slices of one
// (B, N, 3, H, D) buffer. The TPU kernel's padded (BH, N_pad, D) copies and
// whole-row blocks are not carried over: a head's whole row does not fit an
// SM's shared memory, and ragged edges are masked here.
//
// Design. Three launches per call (the device code shared with the split
// backward kernels lives in flash_attention_bwd.cuh):
//   1. `delta_kernel`: one warp per (b, n, h) row computes delta in float32
//      and zeroes that row of the float32 dQ workspace.
//   2. the key-tile kernel: a block owns one 64-key tile of one (b, h), keeps
//      K and V of the tile in shared memory and its dK, dV sums in
//      registers, and walks the query tiles. For each it computes S and dP,
//      rounds P and dS, adds P^T dO and dS^T Q to its sums and adds the
//      tile's dS K to the dQ workspace with float32 atomics: dQ of one query
//      row is a sum over key tiles that different blocks own. The atomics
//      land in no fixed order, so dQ can differ from run to run in its last
//      float32 bits; dK and dV are deterministic.
//   3. `dq_finish_kernel`: dQ = workspace * scale, cast to the input dtype.
//
// What bounds it on the H100: 10 N^2 D operations for 8 N D elements moved,
// so arithmetic. The key-tile kernel is chosen by dtype in
// `lt_flash_attention_bwd`: bfloat16 takes `flash_bwd_wgmma_kernel`, one
// warpgroup a block with all five products on the tensor cores (wgmma from
// swizzled tiles filled by cp.async; `key_tile_backward_wgmma` in the
// header says how, and what is left); float32 takes `flash_bwd_fp32_kernel`
// on the CUDA cores (about two FMAs per shared-memory load), because no
// tensor-core product keeps float32's 2e-5 agreement with the plain version.

#include <stdint.h>

#include <type_traits>

#include "flash_attention_bwd.cuh"

namespace {

__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dq_acc, float* __restrict__ dk,
                          float* __restrict__ dv, int N, int H, Strides sq, Strides sk,
                          Strides sv, Strides sdo, Strides sdk, Strides sdv,
                          float scale) {
  extern __shared__ float smem[];
  key_tile_backward_fp32<true>(smem, q, k, v, dout, lse, delta, dq_acc, dk, dv, N, H,
                               sq, sk, sv, sdo, sdk, sdv, scale);
}

__global__ void __launch_bounds__(hp::kWarpgroup, kWgmmaKeyTileBlocksPerSM)
    flash_bwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int N, int H, Strides sq,
                           Strides sk, Strides sv, Strides sdo, Strides sdk,
                           Strides sdv, float scale) {
  extern __shared__ uint8_t smem_bytes[];
  key_tile_backward_wgmma<true>(smem_bytes, q, k, v, dout, lse, delta, dq_acc, dk, dv,
                                N, H, sq, sk, sv, sdo, sdk, sdv, scale);
}

// The key-tile kernel of T with its launch shape. The tensor-core kernel
// puts the key tiles of one (b, h) next to each other in the grid: they
// share Q and dO.
template <typename T>
cudaError_t launch_key_tiles(const T* q, const T* k, const T* v, const T* dout,
                             const float* lse, const float* delta, float* dq_acc,
                             T* dk, T* dv, int B, int N, int H, Strides sq, Strides sk,
                             Strides sv, Strides sdo, Strides sdk, Strides sdv,
                             float scale, cudaStream_t stream) {
  const int key_tiles = (N + kBK - 1) / kBK;
  if constexpr (std::is_same<T, float>::value) {
    return lt::launch_with_smem(flash_bwd_fp32_kernel, dim3(B * H, key_tiles), kThreads,
                                kKeyTileSmemBytes, stream, q, k, v, dout, lse, delta,
                                dq_acc, dk, dv, N, H, sq, sk, sv, sdo, sdk, sdv, scale);
  } else {
    return lt::launch_with_smem(flash_bwd_wgmma_kernel, dim3(key_tiles, B * H),
                                hp::kWarpgroup, kWgmmaKeyTileSmemBytes, stream, q, k, v,
                                dout, lse, delta, dq_acc, dk, dv, N, H, sq, sk, sv, sdo,
                                sdk, sdv, scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dq_finish_kernel(const float* __restrict__ dq_acc, T* __restrict__ dq,
                     long long elems, int N, int H, Strides sdq, float scale) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= elems) return;
  const int d = static_cast<int>(i % kD);
  const long long row = i / kD;
  const int h = static_cast<int>(row % H);
  const long long bn = row / H;
  const int n = static_cast<int>(bn % N);
  const long long b = bn / N;
  dq[b * sdq.b + n * sdq.n + h * sdq.h + d] = lt::from_float<T>(dq_acc[i] * scale);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta,
                   float* dq_acc, void* dq, void* dk, void* dv, int B, int N,
                   int H, Strides sq, Strides sk, Strides sv, Strides sdo,
                   Strides sdq, Strides sdk, Strides sdv, float scale,
                   cudaStream_t stream) {
  const long long elems = static_cast<long long>(B) * N * H * kD;
  cudaError_t err =
      launch_delta<T, true>(dout, o, delta, dq_acc, B, N, H, sdo, stream);
  if (err != cudaSuccess) return err;

  err = launch_key_tiles<T>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, dq_acc, static_cast<T*>(dk),
      static_cast<T*>(dv), B, N, H, sq, sk, sv, sdo, sdk, sdv, scale, stream);
  if (err != cudaSuccess) return err;

  const unsigned elem_blocks =
      static_cast<unsigned>((elems + kThreads - 1) / kThreads);
  dq_finish_kernel<T><<<elem_blocks, kThreads, 0, stream>>>(
      dq_acc, static_cast<T*>(dq), elems, N, H, sdq, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the first non-zero cudaError_t of its launches (0 on success).
// `strides` holds 7 x 3 element strides (batch, token, head) in the order
// q, k, v, dO, dQ, dK, dV. `delta` is a (B, H, N) and `dq_acc` a
// (B, N, H, D) float32 workspace; neither needs initialising. For bfloat16
// every pointer and stride is 16-byte aligned.
extern "C" int lt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq_acc, void* dq,
    void* dk, void* dv, int B, int N, int H, int D, const long long* strides,
    float scale, int dtype, void* stream) {
  if (D != kD || B < 1 || N < 1 || H < 1) return cudaErrorInvalidValue;
  Strides s[7];
  for (int i = 0; i < 7; ++i)
    s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  auto* acc = static_cast<float*>(dq_acc);
  switch (dtype) {
    case lt::kFloat32:
      return launch<float>(q, k, v, o, dout, l, dl, acc, dq, dk, dv, B, N, H,
                           s[0], s[1], s[2], s[3], s[4], s[5], s[6], scale, st);
    case lt::kBFloat16:
      return launch<__nv_bfloat16>(q, k, v, o, dout, l, dl, acc, dq, dk, dv, B,
                                   N, H, s[0], s[1], s[2], s[3], s[4], s[5],
                                   s[6], scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
