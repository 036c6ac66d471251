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
// What bounds it on the H100: at the model's shapes (N = 148 .. 1028,
// D = 64) attention does 4 N^2 D operations for 4 N D elements read, so it
// is bound by arithmetic, not by memory, and the card's arithmetic is in its
// tensor cores (989 TFLOP/s in bf16 against 67 on the CUDA cores). Two
// kernels, chosen by dtype in `lt_flash_attention_fwd`:
//
// bfloat16 -> `flash_fwd_wgmma_kernel`, both products on the tensor cores.
//   A block is one warpgroup (128 threads) that owns 64 queries of one
//   (b, h). Q (8 KB) is loaded once; K and V tiles of 64 keys (128 measured
//   no better at any of the model's shapes) go through a ring of two stages
//   in shared memory, filled by 16-byte `cp.async`
//   copies into the 128-byte swizzle (hopper.cuh) while the tensor cores
//   work on the tile before; rows past N arrive as zeros. `cp.async` and not
//   TMA: q, k and v are strided views whose pointers change with every
//   call, so TMA would have the host encode three tensor maps a launch, on
//   a path that is already short of host time, and the copies here are eight
//   `cp.async` a thread a tile.
//   S = Q K^T is one `wgmma` chain (four k-steps over D) with both operands
//   from shared memory and the float32 scores in registers. There they are
//   scaled, masked past N, reduced along rows (a row lives in four lanes:
//   two shuffles) and exponentiated with exp2 (log2 e folded into the
//   scale). P is cast to bf16 in registers, where an accumulator fragment
//   is, pair by pair, the A fragment of the next `wgmma`: O += P V reads V's
//   tile transposed through the descriptor and P never touches shared
//   memory. The (N, N) scores never leave registers. O / l goes through Q's
//   tile to 16-byte stores.
//   What is left against the bound: one warpgroup a block does its softmax
//   and its products in turn (only other blocks of the SM overlap them), no
//   warp is specialised for the copies, and the last key tile is computed
//   whole whatever N leaves of it.
//
// float32 -> `flash_fwd_fp32_kernel`, on the CUDA cores: float32 has no
//   tensor-core product that keeps its 2e-5 agreement with the plain
//   version (TF32 keeps ten bits). One thread owns one query row and keeps
//   q, its accumulator and a chunk of scores in registers, while the block
//   stages 64-key tiles of K and V in shared memory, read as broadcasts.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kD = 64;       // head dim, compiled in
constexpr int kBlockQ = 64;  // query rows per block, one per thread
constexpr int kBlockK = 64;  // keys per staged tile
constexpr int kChunk = 16;   // keys scored between two rescales
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, n, h;  // element strides; the head dim is unit-stride
};

__global__ void __launch_bounds__(kBlockQ)
    flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
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
  const float* qp = q + b * sq.b + q_row * sq.n + h * sq.h;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = qp[d];
    acc[d] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
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
        kv = kb[(k0 + j) * sk.n + d];
        vv = vb[(k0 + j) * sv.n + d];
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
        const float p = s[jj];
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
    float* op = o + ((static_cast<long long>(b) * N + row) * H + h) * kD;
#pragma unroll
    for (int d = 0; d < kD; ++d) op[d] = acc[d] / lc;
    lse[static_cast<long long>(bh) * N + row] = m + logf(lc);
  }
}

// ---- bfloat16: both products on the tensor cores ----

constexpr int kKeys = 64;  // keys of a staged K or V tile
// Q's tile, two stages of a K and a V tile, and the slack to align them
constexpr size_t kWgmmaSmemBytes = 1024 + hp::kTileBytes + 2 * 2 * kKeys * hp::kRowBytes;

__global__ void __launch_bounds__(hp::kWarpgroup)
    flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int N,
                           int H, Strides sq, Strides sk, Strides sv, float scale) {
  constexpr int kStageBytes = 2 * kKeys * hp::kRowBytes;
  constexpr int kS = kKeys / 2;  // scores a thread holds of one tile
  extern __shared__ uint8_t smem_raw[];
  // tiles are 1024-byte aligned: the swizzle is a function of address bits
  const uint32_t pad = (1024u - (hp::smem_addr(smem_raw) & 1023u)) & 1023u;
  uint8_t* q_tile = smem_raw + pad;
  const uint32_t q_addr = hp::smem_addr(q_tile);
  const uint32_t ring = q_addr + hp::kTileBytes;  // stage s: K then V

  const int q0 = blockIdx.x * kBlockQ;
  const int bh = blockIdx.y;
  const long long b = bh / H;
  const int h = bh % H;
  const int lane = threadIdx.x & 31;
  const int row = (threadIdx.x >> 5) * 16 + (lane >> 2);  // and row + 8
  const int col = 2 * (lane & 3);  // first of this lane's two columns of each 8

  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  hp::load_rows_async<kBlockQ>(q_addr, q + b * sq.b + h * sq.h, sq.n, q0, N);
  hp::load_rows_async<kKeys>(ring, kb, sk.n, 0, N);
  hp::load_rows_async<kKeys>(ring + kStageBytes / 2, vb, sv.n, 0, N);
  hp::cp_async_commit();

  const float c = scale * 1.4426950408889634f;  // p = exp2(s c - m c)
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of the raw scores, rows row, row + 8
  float l[2] = {0.f, 0.f};          // this lane's share of the denominator
  const uint64_t q_desc = hp::descriptor(q_addr);

  const int tiles = (N + kKeys - 1) / kKeys;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kKeys;
    const uint32_t stage = ring + (t & 1) * kStageBytes;
    // tile t has landed, and every thread is done with tile t - 1, whose
    // stage the next copies overwrite
    hp::cp_async_wait_all();
    hp::fence_async_proxy();
    __syncthreads();
    if (t + 1 < tiles) {
      const uint32_t next = ring + ((t + 1) & 1) * kStageBytes;
      hp::load_rows_async<kKeys>(next, kb, sk.n, k0 + kKeys, N);
      hp::load_rows_async<kKeys>(next + kStageBytes / 2, vb, sv.n, k0 + kKeys, N);
    }
    hp::cp_async_commit();

    float s[kS];
    const uint64_t k_desc = hp::descriptor(stage);
    hp::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks)
      hp::wgmma_ss_n64<0, 0>(s, q_desc + hp::k_major_step(ks), k_desc + hp::k_major_step(ks),
                             ks > 0);
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::fence_registers(s);

    // s[4 j + 2 half + e]: row + 8 half, key k0 + 8 j + col + e. Keys past N
    // score -inf, as the TPU kernel masks its padded columns (their K rows
    // are zeros and would score 0).
    if (k0 + kKeys > N) {
#pragma unroll
      for (int i = 0; i < kS; ++i)
        if (k0 + 8 * (i >> 2) + col + (i & 1) >= N) s[i] = kNegInf;
    }
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kS; ++i) m_new[(i >> 1) & 1] = fmaxf(m_new[(i >> 1) & 1], s[i]);
    float alpha[2], shift[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      m_new[half] = fmaxf(m_new[half], __shfl_xor_sync(0xffffffffu, m_new[half], 1));
      m_new[half] = fmaxf(m_new[half], __shfl_xor_sync(0xffffffffu, m_new[half], 2));
      alpha[half] = exp2f((m[half] - m_new[half]) * c);
      shift[half] = -m_new[half] * c;
      m[half] = m_new[half];
    }
    uint32_t p[kS / 2];  // P in bf16, the A fragments of P V
#pragma unroll
    for (int i = 0; i < kS; i += 2) {
      const int half = (i >> 1) & 1;
      const float p0 = exp2f(fmaf(s[i], c, shift[half]));
      const float p1 = exp2f(fmaf(s[i + 1], c, shift[half]));
      sum[half] += p0 + p1;  // the denominator sums the unrounded p
      p[i / 2] = hp::pack_bf16(p0, p1);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) l[half] = alpha[half] * l[half] + sum[half];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];

    const uint64_t v_desc = hp::descriptor(stage + kStageBytes / 2);
    hp::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKeys / 16; ++ks)
      hp::wgmma_rs_n64(acc, p + 4 * ks, v_desc + hp::mn_major_step(ks));
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::fence_registers(acc);
  }

  // O = acc / l through Q's tile to 16-byte stores; lse from a row's first lane
  uint32_t out[16];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    l[half] = fmaxf(l[half], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[2 * j + half] = hp::pack_bf16(acc[4 * j + 2 * half] / l[half],
                                        acc[4 * j + 2 * half + 1] / l[half]);
    const int r = q0 + row + 8 * half;
    if ((lane & 3) == 0 && r < N)
      lse[static_cast<long long>(bh) * N + r] = m[half] * scale + logf(l[half]);
  }
  __syncthreads();  // every warp's last read of Q's tile is done
  hp::store_fragment(q_tile, out);
  __syncthreads();
  hp::store_rows(q_tile, o + (b * N * H + h) * kD, static_cast<long long>(H) * kD, q0, N);
}

cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                         int B, int N, int H, Strides sq, Strides sk, Strides sv,
                         float scale, cudaStream_t stream) {
  // query tiles of one (b, h) are neighbours in the grid: they share K and V
  return lt::launch_with_smem(
      flash_fwd_wgmma_kernel, dim3((N + kBlockQ - 1) / kBlockQ, B * H), hp::kWarpgroup,
      kWgmmaSmemBytes, stream, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(o), lse, N, H, sq, sk, sv, scale);
}

cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int N, int H, Strides sq, Strides sk, Strides sv,
                        float scale, cudaStream_t stream) {
  const dim3 grid(B * H, (N + kBlockQ - 1) / kBlockQ);
  flash_fwd_fp32_kernel<<<grid, kBlockQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, N, H, sq, sk, sv, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Strides are in
// elements for the batch, token and head dims of (B, N, H, D). bfloat16
// takes the tensor-core kernel (pointers and strides 16-byte aligned),
// float32 the CUDA-core kernel.
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
      return launch_fp32(q, k, v, o, l, B, N, H, sq, sk, sv, scale, s);
    case lt::kBFloat16:
      return launch_wgmma(q, k, v, o, l, B, N, H, sq, sk, sv, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
