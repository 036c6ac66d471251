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
// Design. Three launches per call:
//   1. `delta_kernel`: one warp per (b, n, h) row computes delta in float32
//      and zeroes that row of the float32 dQ workspace.
//   2. `flash_bwd_kernel`: a block owns one 64-key tile of one (b, h), keeps
//      K and V of the tile in shared memory and its dK, dV sums in
//      registers, and walks the query tiles. For each it computes S and dP
//      (each thread a 4 x 4 patch), writes the rounded P and dS to shared
//      memory, adds P^T dO and dS^T Q to its sums and adds the tile's
//      dS K to the dQ workspace with float32 atomicAdd: dQ of one query row
//      is a sum over key tiles that different blocks own. The atomics land
//      in no fixed order, so dQ can differ from run to run in its last
//      float32 bits; dK and dV are deterministic.
//   3. `dq_finish_kernel`: dQ = workspace * scale, cast to the input dtype.
//
// What bounds it on the H100: 10 N^2 D operations for 8 N D elements moved,
// so arithmetic. This first version runs float32 FMAs on the CUDA cores
// from shared-memory tiles (about two FMAs per shared-memory load); the
// tensor cores (wgmma) are the work of a later change.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kD = 64;        // head dim, compiled in
constexpr int kBQ = 64;       // query rows per step
constexpr int kBK = 64;       // keys per block
constexpr int kThreads = 256; // a 16 x 16 grid of threads, 4 x 4 patch each
constexpr int kLd = kD + 1;   // padded row of a shared tile: conflict-free columns
constexpr int kTile = 64 * kLd;
constexpr size_t kSmemBytes = 6 * kTile * sizeof(float);

struct Strides {
  long long b, n, h;  // element strides; the head dim is unit-stride
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const T* __restrict__ dout, const T* __restrict__ o,
                 float* __restrict__ delta, float* __restrict__ dq_acc,
                 long long rows, int N, int H, Strides sdo) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp leaves together
  const int h = static_cast<int>(row % H);
  const long long bn = row / H;
  const int n = static_cast<int>(bn % N);
  const long long b = bn / N;
  const T* dp = dout + b * sdo.b + n * sdo.n + h * sdo.h;
  const T* op = o + row * kD;
  float s = lt::to_float(dp[lane]) * lt::to_float(op[lane]) +
            lt::to_float(dp[lane + 32]) * lt::to_float(op[lane + 32]);
  s = lt::warp_sum(s);
  dq_acc[row * kD + lane] = 0.f;
  dq_acc[row * kD + lane + 32] = 0.f;
  if (lane == 0) delta[(b * H + h) * N + n] = s;
}

// Rows r0 .. r0 + 63 of one head of a (B, N, H, D) operand into a padded
// float32 tile; rows past N are zeros.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ base, int r0,
                                          int N, long long stride_n,
                                          float* __restrict__ tile) {
  for (int i = threadIdx.x; i < 64 * kD; i += kThreads) {
    const int j = i / kD;
    const int d = i % kD;
    const int r = r0 + j;
    tile[j * kLd + d] = r < N ? lt::to_float(base[r * stride_n + d]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq_acc, T* __restrict__ dk,
                     T* __restrict__ dv, int N, int H, Strides sq, Strides sk,
                     Strides sv, Strides sdo, Strides sdk, Strides sdv,
                     float scale) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile;
  float* qs = vs + kTile;
  float* dos = qs + kTile;
  float* ps = dos + kTile;   // P, rounded to T, [query][key]
  float* dss = ps + kTile;   // dS, rounded to T, [query][key]
  __shared__ float lse_s[kBQ];
  __shared__ float delta_s[kBQ];

  const int bh = blockIdx.x;
  const long long b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.y * kBK;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  load_tile(k + b * sk.b + h * sk.h, k0, N, sk.n, ks);
  load_tile(v + b * sv.b + h * sv.h, k0, N, sv.n, vs);

  // this thread's patch of dK and dV: keys ty*4 + i, dims tx + 16 j
  float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_b = lse + static_cast<long long>(bh) * N;
  const float* delta_b = delta + static_cast<long long>(bh) * N;

  for (int q0 = 0; q0 < N; q0 += kBQ) {
    __syncthreads();  // the previous step's reads of qs, dos, ps, dss are done
    load_tile(qb, q0, N, sq.n, qs);
    load_tile(dob, q0, N, sdo.n, dos);
    if (tid < kBQ) {
      const int r = q0 + tid;
      lse_s[tid] = r < N ? lse_b[r] : 0.f;
      delta_s[tid] = r < N ? delta_b[r] : 0.f;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T: queries ty*4 + i, keys tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      float qa[4], ga[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = qs[(ty * 4 + i) * kLd + d];
        ga[i] = dos[(ty * 4 + i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = ks[(tx + 16 * j) * kLd + d];
        vb[j] = vs[(tx + 16 * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(ga[i], vb[j], dp[i][j]);
        }
    }
    // P = exp(S scale - lse), dS = P (dP - delta); pairs past N give zero,
    // as the TPU kernel's masked columns and zero-padded rows do
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = ty * 4 + i;
      const bool q_live = q0 + qi < N;
      const float row_lse = lse_s[qi];
      const float row_delta = delta_s[qi];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx + 16 * j;
        const bool live = q_live && (k0 + kj < N);
        const float p = live ? expf(s[i][j] * scale - row_lse) : 0.f;
        const float ds = p * (dp[i][j] - row_delta);
        ps[qi * kLd + kj] = lt::round_to<T>(p);
        dss[qi * kLd + kj] = lt::round_to<T>(ds);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q: keys ty*4 + i, dims tx + 16 j
#pragma unroll 4
    for (int r = 0; r < kBQ; ++r) {
      float pa[4], da[4], gb[4], qb4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = ps[r * kLd + ty * 4 + i];
        da[i] = dss[r * kLd + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        gb[j] = dos[r * kLd + tx + 16 * j];
        qb4[j] = qs[r * kLd + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dv_acc[i][j] = fmaf(pa[i], gb[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(da[i], qb4[j], dk_acc[i][j]);
        }
    }

    // this key tile's share of dQ = dS K: queries ty*4 + i, dims tx + 16 j
    float dq[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dq[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float da[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = dss[(ty * 4 + i) * kLd + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = ks[kk * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dq[i][j] = fmaf(da[i], kb[j], dq[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      if (r >= N) continue;
      float* row = dq_acc + ((b * N + r) * H + h) * kD;
#pragma unroll
      for (int j = 0; j < 4; ++j) atomicAdd(row + tx + 16 * j, dq[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty * 4 + i;
    if (r >= N) continue;
    T* dkp = dk + b * sdk.b + r * sdk.n + h * sdk.h;
    T* dvp = dv + b * sdv.b + r * sdv.n + h * sdv.h;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dkp[tx + 16 * j] = lt::from_float<T>(dk_acc[i][j] * scale);
      dvp[tx + 16 * j] = lt::from_float<T>(dv_acc[i][j]);
    }
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
  const long long rows = static_cast<long long>(B) * N * H;
  const long long elems = rows * kD;
  const unsigned row_blocks =
      static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  delta_kernel<T><<<row_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(o), delta, dq_acc,
      rows, N, H, sdo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kernel = flash_bwd_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (N + kBK - 1) / kBK);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, dq_acc,
      static_cast<T*>(dk), static_cast<T*>(dv), N, H, sq, sk, sv, sdo, sdk, sdv,
      scale);
  err = cudaGetLastError();
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
// (B, N, H, D) float32 workspace; neither needs initialising.
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
