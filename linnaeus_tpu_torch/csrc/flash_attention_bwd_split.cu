// K1 backward, split: dQ from a kernel that owns query tiles, dK and dV from
// a kernel that owns key tiles.
//
// Replaces the Pallas kernels linnaeus_tpu/ops/flash_attention.py
// `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` and the host part of
// `_flash_bwd_rule` (the row sums delta = sum_d dO * O). Same math and casts:
// S = Q K^T in float32 times the scale, P = exp(S - lse) with the forward's
// log-sum-exp, dP = dO V^T, dS = P * (dP - delta). In the dQ kernel only dS
// is cast to the input dtype, before dQ = dS K * scale. In the dK/dV kernel P
// is cast before dV = P^T dO and dS before dK = dS^T Q * scale. Each kernel
// recomputes S and dP for itself, as the TPU pair does: 3 + 4 + 2 = 9 tile
// products against the fused kernel's 5.
//
// Layout: as flash_attention_bwd.cu. q, k, v and dO are token-major
// (B, N, H, D) read through their strides, O is contiguous (B, N, H, D), lse
// and delta are (B, H, N) float32, and dQ, dK, dV are written through
// strides of their own. The TPU kernels' padded copies and their -inf mask
// on padded keys are not carried over: the loops are bounded by N and pairs
// past N contribute zero.
//
// Design. Three launches, each with a C entry point of its own:
//   1. `delta_kernel` (flash_attention_bwd.cuh): delta in float32, one warp
//      per row. No workspace is zeroed: the split kernels have none.
//   2. `flash_bwd_dq_kernel`: a block owns one 64-query tile of one (b, h),
//      keeps Q, dO, lse and delta of the tile in shared memory and its dQ
//      patch (4 x 4 per thread) in registers, walks the key tiles in order,
//      and writes dQ * scale once, cast to the input dtype. No atomics and no
//      float32 workspace: dQ is the same from run to run.
//   3. the dK/dV kernel: a block owns one 64-key tile and walks the query
//      tiles: the key-tile body of the fused kernel without its dQ part
//      (flash_attention_bwd.cuh), so dK and dV of the two are the same bits.
//
// What bounds them on the H100: 6 N^2 D (dQ) and 8 N^2 D (dK/dV) operations
// for a few N D elements moved, so arithmetic. The dK/dV kernel is chosen by
// dtype in `lt_flash_attention_bwd_dkv`: bfloat16 takes
// `flash_bwd_dkv_wgmma_kernel`, one warpgroup a block with its four products
// on the tensor cores (`key_tile_backward_wgmma` in the header says how);
// float32 takes `flash_bwd_dkv_fp32_kernel` on the CUDA cores, because no
// tensor-core product keeps float32's 2e-5 agreement with the plain version.
// The dQ kernel still runs float32 FMAs on the CUDA cores from padded
// float32 shared-memory tiles for both dtypes; its tensor-core design is
// the work of a later change.

#include <stdint.h>

#include <type_traits>

#include "flash_attention_bwd.cuh"

namespace {

// Q, dO, K, V, dS tiles and the lse and delta of the query tile
constexpr size_t kQueryTileSmemBytes = (5 * kTile + 2 * kBQ) * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int N, int H, Strides sq, Strides sk, Strides sv,
                        Strides sdo, Strides sdq, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile;
  float* ks = dos + kTile;
  float* vs = ks + kTile;
  float* dss = vs + kTile;  // dS, rounded to T, [query][key]
  float* lse_s = dss + kTile;
  float* delta_s = lse_s + kBQ;

  const int bh = blockIdx.x;
  const long long b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  load_tile(q + b * sq.b + h * sq.h, q0, N, sq.n, qs);
  load_tile(dout + b * sdo.b + h * sdo.h, q0, N, sdo.n, dos);
  load_row_stats(lse + static_cast<long long>(bh) * N,
                 delta + static_cast<long long>(bh) * N, q0, N, lse_s, delta_s);

  // this thread's patch of dQ: queries ty*4 + i, dims tx + 16 j
  float dq_acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq_acc[i][j] = 0.f;

  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();  // the previous step's reads of ks, vs, dss are done
    load_tile(kb, k0, N, sk.n, ks);
    load_tile(vb, k0, N, sv.n, vs);
    __syncthreads();  // also covers qs, dos, lse_s, delta_s on the first step

    float s[4][4], dp[4][4];
    score_patches(qs, dos, ks, vs, ty, tx, s, dp);
    store_p_ds<T>(s, dp, lse_s, delta_s, q0, k0, N, scale, ty, tx, nullptr, dss);
    __syncthreads();
    add_ds_k(dss, ks, ty, tx, dq_acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= N) continue;
    T* dqp = dq + b * sdq.b + r * sdq.n + h * sdq.h;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dqp[tx + 16 * j] = lt::from_float<T>(dq_acc[i][j] * scale);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkv_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta, float* __restrict__ dk,
                              float* __restrict__ dv, int N, int H, Strides sq,
                              Strides sk, Strides sv, Strides sdo, Strides sdk,
                              Strides sdv, float scale) {
  extern __shared__ float smem[];
  key_tile_backward_fp32<false>(smem, q, k, v, dout, lse, delta, nullptr, dk, dv, N, H,
                                sq, sk, sv, sdo, sdk, sdv, scale);
}

__global__ void __launch_bounds__(hp::kWarpgroup, kWgmmaKeyTileBlocksPerSM)
    flash_bwd_dkv_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int N, int H,
                               Strides sq, Strides sk, Strides sv, Strides sdo,
                               Strides sdk, Strides sdv, float scale) {
  extern __shared__ uint8_t smem_bytes[];
  key_tile_backward_wgmma<false>(smem_bytes, q, k, v, dout, lse, delta, nullptr, dk, dv,
                                 N, H, sq, sk, sv, sdo, sdk, sdv, scale);
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int N, int H, Strides sq, Strides sk,
                      Strides sv, Strides sdo, Strides sdq, float scale,
                      cudaStream_t stream) {
  return lt::launch_with_smem(
      flash_bwd_dq_kernel<T>, dim3(B * H, (N + kBQ - 1) / kBQ), kThreads,
      kQueryTileSmemBytes, stream, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), N, H, sq, sk, sv, sdo, sdq, scale);
}

// The tensor-core kernel puts the key tiles of one (b, h) next to each other
// in the grid: they share Q and dO.
template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int N, int H, Strides sq,
                       Strides sk, Strides sv, Strides sdo, Strides sdk,
                       Strides sdv, float scale, cudaStream_t stream) {
  const int key_tiles = (N + kBK - 1) / kBK;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *dot = static_cast<const T*>(dout);
  T *dkt = static_cast<T*>(dk), *dvt = static_cast<T*>(dv);
  if constexpr (std::is_same<T, float>::value) {
    return lt::launch_with_smem(flash_bwd_dkv_fp32_kernel, dim3(B * H, key_tiles),
                                kThreads, kKeyTileSmemBytes, stream, qt, kt, vt, dot, lse,
                                delta, dkt, dvt, N, H, sq, sk, sv, sdo, sdk, sdv, scale);
  } else {
    return lt::launch_with_smem(flash_bwd_dkv_wgmma_kernel, dim3(key_tiles, B * H),
                                hp::kWarpgroup, kWgmmaKeyTileSmemBytes, stream, qt, kt, vt,
                                dot, lse, delta, dkt, dvt, N, H, sq, sk, sv, sdo, sdk, sdv,
                                scale);
  }
}

Strides strides_at(const long long* strides, int i) {
  return Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

}  // namespace

// Each function returns the cudaError_t of its launch (0 on success).
// Strides are element strides (batch, token, head) of (B, N, H, D) operands.

// delta (B, H, N) float32 = rowsum(dO * O); `dout_strides` holds dO's three
// strides, O is contiguous.
extern "C" int lt_flash_attention_bwd_delta(const void* o, const void* dout,
                                            void* delta, int B, int N, int H,
                                            int D, const long long* dout_strides,
                                            int dtype, void* stream) {
  if (D != kD || B < 1 || N < 1 || H < 1) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* dl = static_cast<float*>(delta);
  const Strides sdo = strides_at(dout_strides, 0);
  switch (dtype) {
    case lt::kFloat32:
      return launch_delta<float, false>(dout, o, dl, nullptr, B, N, H, sdo, st);
    case lt::kBFloat16:
      return launch_delta<__nv_bfloat16, false>(dout, o, dl, nullptr, B, N, H,
                                                sdo, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// `strides` holds 5 x 3 strides in the order q, k, v, dO, dQ.
extern "C" int lt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int N, int H, int D,
    const long long* strides, float scale, int dtype, void* stream) {
  if (D != kD || B < 1 || N < 1 || H < 1) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1),
                sv = strides_at(strides, 2), sdo = strides_at(strides, 3),
                sdq = strides_at(strides, 4);
  switch (dtype) {
    case lt::kFloat32:
      return launch_dq<float>(q, k, v, dout, l, dl, dq, B, N, H, sq, sk, sv,
                              sdo, sdq, scale, st);
    case lt::kBFloat16:
      return launch_dq<__nv_bfloat16>(q, k, v, dout, l, dl, dq, B, N, H, sq, sk,
                                      sv, sdo, sdq, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// `strides` holds 6 x 3 strides in the order q, k, v, dO, dK, dV. For
// bfloat16 every pointer and stride is 16-byte aligned.
extern "C" int lt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int N,
    int H, int D, const long long* strides, float scale, int dtype,
    void* stream) {
  if (D != kD || B < 1 || N < 1 || H < 1) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1),
                sv = strides_at(strides, 2), sdo = strides_at(strides, 3),
                sdk = strides_at(strides, 4), sdv = strides_at(strides, 5);
  switch (dtype) {
    case lt::kFloat32:
      return launch_dkv<float>(q, k, v, dout, l, dl, dk, dv, B, N, H, sq, sk,
                               sv, sdo, sdk, sdv, scale, st);
    case lt::kBFloat16:
      return launch_dkv<__nv_bfloat16>(q, k, v, dout, l, dl, dk, dv, B, N, H,
                                       sq, sk, sv, sdo, sdk, sdv, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
