// Device code shared by K1's backward kernels: the fused one
// (flash_attention_bwd.cu) and the split dQ and dK/dV pair
// (flash_attention_bwd_split.cu). Tiles are 64 x 64 in padded float32 shared
// memory; a block is a 16 x 16 grid of threads, each owning a 4 x 4 patch of
// a tile product. Everything here has internal linkage: each source that
// includes this header compiles its own copy.
#pragma once

#include "common.cuh"

namespace {

constexpr int kD = 64;        // head dim, compiled in
constexpr int kBQ = 64;       // query rows per tile
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256; // a 16 x 16 grid of threads, 4 x 4 patch each
constexpr int kLd = kD + 1;   // padded row of a shared tile: conflict-free columns
constexpr int kTile = 64 * kLd;
// a block that owns a key tile: 6 tiles and the lse and delta of a query tile
constexpr size_t kKeyTileSmemBytes = (6 * kTile + 2 * kBQ) * sizeof(float);

struct Strides {
  long long b, n, h;  // element strides; the head dim is unit-stride
};

// delta = rowsum(dO * O) in float32, one warp per (b, n, h) row, written as
// (B, H, N). With kZeroWorkspace it also zeroes that row of the float32 dQ
// workspace of the fused kernel.
template <typename T, bool kZeroWorkspace>
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
  if constexpr (kZeroWorkspace) {
    dq_acc[row * kD + lane] = 0.f;
    dq_acc[row * kD + lane + 32] = 0.f;
  }
  if (lane == 0) delta[(b * H + h) * N + n] = s;
}

template <typename T, bool kZeroWorkspace>
cudaError_t launch_delta(const void* dout, const void* o, float* delta,
                         float* dq_acc, int B, int N, int H, Strides sdo,
                         cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * N * H;
  const unsigned row_blocks =
      static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  delta_kernel<T, kZeroWorkspace><<<row_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(o), delta, dq_acc,
      rows, N, H, sdo);
  return cudaGetLastError();
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

// lse and delta of query rows q0 .. q0 + 63 into shared vectors; rows past N
// are zeros.
__device__ __forceinline__ void load_row_stats(const float* __restrict__ lse_b,
                                               const float* __restrict__ delta_b,
                                               int q0, int N,
                                               float* __restrict__ lse_s,
                                               float* __restrict__ delta_s) {
  const int tid = threadIdx.x;
  if (tid < kBQ) {
    const int r = q0 + tid;
    lse_s[tid] = r < N ? lse_b[r] : 0.f;
    delta_s[tid] = r < N ? delta_b[r] : 0.f;
  }
}

// S = Q K^T and dP = dO V^T of one tile pair: queries ty*4 + i, keys
// tx + 16 j.
__device__ __forceinline__ void score_patches(
    const float* __restrict__ qs, const float* __restrict__ dos,
    const float* __restrict__ ks, const float* __restrict__ vs, int ty, int tx,
    float (&s)[4][4], float (&dp)[4][4]) {
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
}

// P = exp(S scale - lse) and dS = P (dP - delta) of this thread's patch,
// rounded to T into the shared tiles dss (and ps, unless null), both
// [query][key]. Pairs past N give zero, as the TPU kernels' masked columns
// and zero-padded rows do.
template <typename T>
__device__ __forceinline__ void store_p_ds(
    const float (&s)[4][4], const float (&dp)[4][4],
    const float* __restrict__ lse_s, const float* __restrict__ delta_s, int q0,
    int k0, int N, float scale, int ty, int tx, float* __restrict__ ps,
    float* __restrict__ dss) {
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
      if (ps != nullptr) ps[qi * kLd + kj] = lt::round_to<T>(p);
      dss[qi * kLd + kj] = lt::round_to<T>(ds);
    }
  }
}

// acc += dS K for one tile pair: queries ty*4 + i, dims tx + 16 j.
__device__ __forceinline__ void add_ds_k(const float* __restrict__ dss,
                                         const float* __restrict__ ks, int ty,
                                         int tx, float (&acc)[4][4]) {
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
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(da[i], kb[j], acc[i][j]);
  }
}

// The work of a block that owns one 64-key tile of one (b, h): K and V of
// the tile in shared memory, dK and dV in registers, a walk over the query
// tiles. With kWithDQ each tile pair's dS K is added to the float32 dQ
// workspace with atomicAdd (the fused kernel); without it no dQ work is done
// and `dq_acc` is not touched (the dK/dV kernel of the split pair). `smem`
// holds kKeyTileSmemBytes.
template <typename T, bool kWithDQ>
__device__ __forceinline__ void key_tile_backward(
    float* __restrict__ smem, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq_acc, T* __restrict__ dk, T* __restrict__ dv, int N,
    int H, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
    Strides sdv, float scale) {
  float* ks = smem;
  float* vs = ks + kTile;
  float* qs = vs + kTile;
  float* dos = qs + kTile;
  float* ps = dos + kTile;   // P, rounded to T, [query][key]
  float* dss = ps + kTile;   // dS, rounded to T, [query][key]
  float* lse_s = dss + kTile;
  float* delta_s = lse_s + kBQ;

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
    load_row_stats(lse_b, delta_b, q0, N, lse_s, delta_s);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_patches(qs, dos, ks, vs, ty, tx, s, dp);
    store_p_ds<T>(s, dp, lse_s, delta_s, q0, k0, N, scale, ty, tx, ps, dss);
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

    if constexpr (kWithDQ) {
      // this key tile's share of dQ = dS K: queries ty*4 + i, dims tx + 16 j
      float dq[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dq[i][j] = 0.f;
      add_ds_k(dss, ks, ty, tx, dq);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty * 4 + i;
        if (r >= N) continue;
        float* row = dq_acc + ((b * N + r) * H + h) * kD;
#pragma unroll
        for (int j = 0; j < 4; ++j) atomicAdd(row + tx + 16 * j, dq[i][j]);
      }
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

}  // namespace
