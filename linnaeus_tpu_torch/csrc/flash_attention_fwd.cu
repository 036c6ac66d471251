// K1 forward: softmax attention with an online softmax, one pass over the keys.
//
// Replaces the Pallas kernel linnaeus_tpu/ops/flash_attention.py
// `_flash_fwd_kernel` (launched by `_flash_forward_padded`). Same math: the
// scores are q.k in float32 times the scale, a running max m, denominator l
// and float32 accumulator per query row, p cast to the input dtype before
// the product with V, l clamped at 1e-30, and O = acc / l with the
// log-sum-exp m + log(l) written beside it.
//
// Layout: q, k, v are token-major (B, N, H, D) and are read through their
// strides (the head dim must be unit-stride), so the (B, N, 3, H, D) view
// out of a qkv projection needs no copy. O is written contiguous
// (B, N, H, D); lse is (B, H, N) float32.
//
// What bounds it on the H100: at the serving shapes (N = 580 and 148,
// D = 64) attention does 4 N^2 D operations for 4 N D elements read, so it
// is bound by arithmetic, not by memory. This first version computes on the
// CUDA cores in float32 (no tensor cores): one thread owns one query row
// and keeps q, its accumulator and a chunk of scores in registers, while
// the block stages 64-key tiles of K and V in shared memory, read by every
// thread of the block as broadcasts. The N x N scores never leave registers.
// Moving the two products onto wgmma is the work of a later change.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kD = 64;       // head dim, compiled in
constexpr int kBlockQ = 64;  // query rows per block, one per thread
constexpr int kBlockK = 64;  // keys per staged tile
constexpr int kChunk = 16;   // keys scored between two rescales
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, n, h;  // element strides; the head dim is unit-stride
};

template <typename T>
__global__ void __launch_bounds__(kBlockQ)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int N, int H, Strides sq,
                     Strides sk, Strides sv, float scale) {
  __shared__ float4 k_tile[kBlockK * kD / 4];
  __shared__ float4 v_tile[kBlockK * kD / 4];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int row = blockIdx.y * kBlockQ + threadIdx.x;
  const int q_row = row < N ? row : N - 1;  // idle threads shadow a live row

  float qr[kD];
  float acc[kD];
  const T* qp = q + b * sq.b + q_row * sq.n + h * sq.h;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = lt::to_float(qp[d]);
    acc[d] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  float* kf = reinterpret_cast<float*>(k_tile);
  float* vf = reinterpret_cast<float*>(v_tile);

  for (int k0 = 0; k0 < N; k0 += kBlockK) {
    const int nk = min(kBlockK, N - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kBlockK * kD; i += kBlockQ) {
      const int j = i / kD;
      const int d = i % kD;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        kv = lt::to_float(kb[(k0 + j) * sk.n + d]);
        vv = lt::to_float(vb[(k0 + j) * sv.n + d]);
      }
      kf[i] = kv;
      vf[i] = vv;
    }
    __syncthreads();

    for (int c0 = 0; c0 < nk; c0 += kChunk) {
      float s[kChunk];
      float m_cur = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4* kr = k_tile + (c0 + jj) * (kD / 4);
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < kD / 4; ++d4) {
          const float4 kk = kr[d4];
          dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
          dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
          dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
          dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
        }
        // keys past N score -inf, as the TPU kernel masks its padded columns
        s[jj] = (c0 + jj < nk) ? dot * scale : kNegInf;
        m_cur = fmaxf(m_cur, s[jj]);
      }
      const float m_new = fmaxf(m, m_cur);
      const float alpha = expf(m - m_new);
      float p_sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[jj] = expf(s[jj] - m_new);
        p_sum += s[jj];
      }
      l = alpha * l + p_sum;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = lt::round_to<T>(s[jj]);
        const float4* vr = v_tile + (c0 + jj) * (kD / 4);
#pragma unroll
        for (int d4 = 0; d4 < kD / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }

  if (row < N) {
    const float lc = fmaxf(l, 1e-30f);
    T* op = o + ((static_cast<long long>(b) * N + row) * H + h) * kD;
#pragma unroll
    for (int d = 0; d < kD; ++d) op[d] = lt::from_float<T>(acc[d] / lc);
    lse[static_cast<long long>(bh) * N + row] = m + logf(lc);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int N, int H, Strides sq, Strides sk,
                   Strides sv, float scale, cudaStream_t stream) {
  const dim3 grid(B * H, (N + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, N, H, sq, sk, sv,
      scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Strides are in
// elements for the batch, token and head dims of (B, N, H, D).
extern "C" int lt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int N, int H, int D, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh, long long v_sb,
    long long v_sn, long long v_sh, float scale, int dtype, void* stream) {
  if (D != kD || B < 1 || N < 1 || H < 1) return cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sn, q_sh}, sk{k_sb, k_sn, k_sh}, sv{v_sb, v_sn, v_sh};
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  switch (dtype) {
    case lt::kFloat32:
      return launch<float>(q, k, v, o, l, B, N, H, sq, sk, sv, scale, s);
    case lt::kBFloat16:
      return launch<__nv_bfloat16>(q, k, v, o, l, B, N, H, sq, sk, sv, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
