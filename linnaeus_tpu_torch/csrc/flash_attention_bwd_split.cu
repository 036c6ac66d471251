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
// products against a one-pass kernel's 5.
//
// On the H100 this pair is K1's whole backward at every length, so it also
// replaces the one-pass Pallas kernel `_flash_bwd_fused_kernel`, which
// computes each dQ in one program per (b, h) holding a head's whole row in
// VMEM. A head's row does not fit an SM's shared memory, so a one-pass
// kernel here owns a 64-key tile, and dQ of one query row becomes a sum over
// key tiles that different blocks own. Summing it with float32 atomics
// (0.538 ms at (64, 580, 6, 64)) made dQ differ from run to run in its last
// bits: two training runs of one seed parted by up to 0.77% in val loss over
// 896 steps. A workspace of one float32 partial per key tile, summed in tile
// order by a last launch, repeated but wrote and read 570 MB there: 0.691
// ms. This pair took 0.478 ms and gives the same bits on every call
// (NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py phase 7i(e)).
//
// Layout: q, k, v and dO are token-major (B, N, H, D) read through their
// strides (unit-stride head dim), so the views out of a qkv projection need
// no copy; O is contiguous (B, N, H, D), lse and delta are (B, H, N)
// float32, and dQ, dK, dV are written through strides of their own, so they
// may be the three slices of one (B, N, 3, H, D) buffer. The TPU kernels'
// padded copies and their -inf mask on padded keys are not carried over:
// the loops are bounded by N and pairs past N contribute zero.
//
// Design. Three launches, each with a C entry point of its own:
//   1. `delta_kernel` (flash_attention_bwd.cuh): delta in float32, one warp
//      per row. No workspace is zeroed: the split kernels have none.
//   2. the dQ kernel: a block owns one 64-query tile of one (b, h), keeps
//      its dQ tile in registers, walks the key tiles in order, and writes
//      dQ * scale once, cast to the input dtype. No atomics and no float32
//      workspace: dQ is the same from run to run.
//   3. the dK/dV kernel: a block owns one 64-key tile and walks the query
//      tiles (the key-tile body of flash_attention_bwd.cuh).
//
// What bounds them on the H100: 6 N^2 D (dQ) and 8 N^2 D (dK/dV) operations
// for a few N D elements moved, so arithmetic, and the card's arithmetic is
// in its tensor cores. Both kernels are chosen by dtype in their C entry
// points, `lt_flash_attention_bwd_dq` and `lt_flash_attention_bwd_dkv`.
//
// bfloat16 dQ -> `flash_bwd_dq_wgmma_kernel`: the forward kernel's shape
//   with one more product and no running maximum. One warpgroup owns 64
//   queries; Q and dO go once into two swizzled tiles; K and V tiles of 64
//   keys come through a two-stage `cp.async` ring while the tile before is
//   worked on. S = Q K^T and dP = dO V^T are two `wgmma` chains with all
//   four operands read as they lie (K-major) and both sums in registers.
//   There P = exp2(S scale log2 e - lse log2 e) and dS = P (dP - delta) are
//   formed in float32; a thread holds two rows of the fragment and keeps
//   their lse and delta in registers over the whole walk. dS is cast to
//   bf16 in registers (the kernel's only cast) where, pair by pair, it is
//   the A fragment of dQ += dS K, with K's tile read transposed through the
//   descriptor: the bytes that S read K-major. dQ * scale goes through Q's
//   tile to 16-byte stores. Nothing is exchanged through shared memory
//   between the products and no atomic is used.
//   Keys past N arrive as zero rows of K and V, so their S is 0 and their P
//   would be exp(-lse), not 0. The same zero rows of K multiply that dS, so
//   it could not reach dQ; it is set to zero in the ragged last tile all
//   the same, which keeps every value finite whatever lse is. Query rows
//   past N read lse = delta = 0 (never the memory behind the arrays), give
//   dS = 0 from their zero rows of Q and dO, and are not written.
//   Three 64 x 64 float32 fragments are 96 registers a thread: the kernel
//   is held to the 168 that let three blocks share an SM (49 KB of shared
//   memory each), so that one block's exponentials overlap another's
//   products. What is left against the bound: one warpgroup does its
//   elementwise work and its products in turn, no warp is specialised for
//   the copies, and the last key tile is computed whole.
// bfloat16 dK/dV -> `flash_bwd_dkv_wgmma_kernel`, one warpgroup a block
//   with its four products on the tensor cores (`key_tile_backward_wgmma`
//   in the header says how).
// float32 -> `flash_bwd_dq_fp32_kernel` and `flash_bwd_dkv_fp32_kernel` on
//   the CUDA cores (float32 FMAs from padded float32 shared-memory tiles,
//   256 threads that each own a 4 x 4 patch of a tile product), because no
//   tensor-core product keeps float32's 2e-5 agreement with the plain
//   version.

#include <stdint.h>

#include <type_traits>

#include "flash_attention_bwd.cuh"

namespace {

// Q, dO, K, V, dS tiles and the lse and delta of the query tile
constexpr size_t kQueryTileSmemBytes = (5 * kTile + 2 * kBQ) * sizeof(float);

__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta, float* __restrict__ dq,
                             int N, int H, Strides sq, Strides sk, Strides sv,
                             Strides sdo, Strides sdq, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile;
  float* ks = dos + kTile;
  float* vs = ks + kTile;
  float* dss = vs + kTile;  // dS, [query][key]
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

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();  // the previous step's reads of ks, vs, dss are done
    load_tile(kb, k0, N, sk.n, ks);
    load_tile(vb, k0, N, sv.n, vs);
    __syncthreads();  // also covers qs, dos, lse_s, delta_s on the first step

    float s[4][4], dp[4][4];
    score_patches(qs, dos, ks, vs, ty, tx, s, dp);
    store_p_ds<float>(s, dp, lse_s, delta_s, q0, k0, N, scale, ty, tx, nullptr, dss);
    __syncthreads();
    add_ds_k(dss, ks, ty, tx, dq_acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= N) continue;
    float* dqp = dq + b * sdq.b + r * sdq.n + h * sdq.h;
#pragma unroll
    for (int j = 0; j < 4; ++j) dqp[tx + 16 * j] = dq_acc[i][j] * scale;
  }
}

// bfloat16 on the tensor cores: see the note at the top of the file.
constexpr int kWgmmaDqBlocksPerSM = 3;
// Q and dO, two stages of a K and a V tile, and the slack to align them
constexpr size_t kWgmmaDqSmemBytes = 1024 + 2 * hp::kTileBytes + 2 * 2 * hp::kTileBytes;

__global__ void __launch_bounds__(hp::kWarpgroup, kWgmmaDqBlocksPerSM)
    flash_bwd_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int N, int H, Strides sq,
                              Strides sk, Strides sv, Strides sdo, Strides sdq,
                              float scale) {
  constexpr int kStageBytes = 2 * hp::kTileBytes;
  extern __shared__ uint8_t smem_bytes[];
  // tiles are 1024-byte aligned: the swizzle is a function of address bits
  const uint32_t pad = (1024u - (hp::smem_addr(smem_bytes) & 1023u)) & 1023u;
  uint8_t* q_tile = smem_bytes + pad;
  const uint32_t q_addr = hp::smem_addr(q_tile);
  const uint32_t do_addr = q_addr + hp::kTileBytes;
  const uint32_t ring = do_addr + hp::kTileBytes;  // stage s: K then V

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const long long b = bh / H;
  const int h = bh % H;
  const int lane = threadIdx.x & 31;
  const int row = (threadIdx.x >> 5) * 16 + (lane >> 2);  // and row + 8: queries
  const int col = 2 * (lane & 3);  // first of this lane's two columns of each 8

  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  hp::load_rows_async<kBQ>(q_addr, q + b * sq.b + h * sq.h, sq.n, q0, N);
  hp::load_rows_async<kBQ>(do_addr, dout + b * sdo.b + h * sdo.h, sdo.n, q0, N);
  hp::load_rows_async<kBK>(ring, kb, sk.n, 0, N);
  hp::load_rows_async<kBK>(ring + hp::kTileBytes, vb, sv.n, 0, N);
  hp::cp_async_commit();

  constexpr float kLog2e = 1.4426950408889634f;
  const float c = scale * kLog2e;  // P = exp2(S c - lse log2 e)
  float shift[2], dl[2];           // -lse log2 e and delta of rows row, row + 8
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + row + 8 * half;
    const bool live = r < N;
    shift[half] = live ? -lse[static_cast<long long>(bh) * N + r] * kLog2e : 0.f;
    dl[half] = live ? delta[static_cast<long long>(bh) * N + r] : 0.f;
  }
  const uint64_t q_desc = hp::descriptor(q_addr), do_desc = hp::descriptor(do_addr);

  float acc[32];  // dQ, [query][dim]
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  const int tiles = (N + kBK - 1) / kBK;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kBK;
    const uint32_t stage = ring + (t & 1) * kStageBytes;
    // tile t has landed, and every thread is done with tile t - 1, whose
    // stage the next copies overwrite
    hp::cp_async_wait_all();
    hp::fence_async_proxy();
    __syncthreads();
    if (t + 1 < tiles) {
      const uint32_t next = ring + ((t + 1) & 1) * kStageBytes;
      hp::load_rows_async<kBK>(next, kb, sk.n, k0 + kBK, N);
      hp::load_rows_async<kBK>(next + hp::kTileBytes, vb, sv.n, k0 + kBK, N);
    }
    hp::cp_async_commit();

    // S = Q K^T and dP = dO V^T: [query][key]
    float s[32], dp[32];
    const uint64_t k_desc = hp::descriptor(stage);
    const uint64_t v_desc = hp::descriptor(stage + hp::kTileBytes);
    hp::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks)
      hp::wgmma_ss_n64<0, 0>(s, q_desc + hp::k_major_step(ks), k_desc + hp::k_major_step(ks),
                             ks > 0);
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks)
      hp::wgmma_ss_n64<0, 0>(dp, do_desc + hp::k_major_step(ks),
                             v_desc + hp::k_major_step(ks), ks > 0);
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::fence_registers(s);
    hp::fence_registers(dp);

    // dS in bf16, the A fragments of dS K. s[4 j + 2 half + e]: query
    // row + 8 half, key k0 + 8 j + col + e.
    const bool ragged = k0 + kBK > N;
    uint32_t ds[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * half + e;
          const float p = exp2f(fmaf(s[i], c, shift[half]));
          d[e] = p * (dp[i] - dl[half]);
          if (ragged && k0 + 8 * j + col + e >= N) d[e] = 0.f;
        }
        ds[2 * j + half] = hp::pack_bf16(d[0], d[1]);
      }

    // dQ += dS K: K's tile read transposed
    hp::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
      hp::wgmma_rs_n64(acc, ds + 4 * ks, k_desc + hp::mn_major_step(ks));
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::fence_registers(acc);
  }

  // dQ * scale through Q's tile to 16-byte stores
  uint32_t out[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int e = 4 * (i >> 1) + 2 * (i & 1);
    out[i] = hp::pack_bf16(acc[e] * scale, acc[e + 1] * scale);
  }
  __syncthreads();  // every warp's last read of Q's tile is done
  hp::store_fragment(q_tile, out);
  __syncthreads();
  hp::store_rows(q_tile, dq + b * sdq.b + h * sdq.h, sdq.n, q0, N);
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
  key_tile_backward_fp32(smem, q, k, v, dout, lse, delta, dk, dv, N, H, sq, sk, sv, sdo,
                         sdk, sdv, scale);
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
  key_tile_backward_wgmma(smem_bytes, q, k, v, dout, lse, delta, dk, dv, N, H, sq, sk, sv,
                          sdo, sdk, sdv, scale);
}

// The tensor-core kernel puts the query tiles of one (b, h) next to each
// other in the grid: they share K and V.
template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int N, int H, Strides sq, Strides sk,
                      Strides sv, Strides sdo, Strides sdq, float scale,
                      cudaStream_t stream) {
  const int query_tiles = (N + kBQ - 1) / kBQ;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *dot = static_cast<const T*>(dout);
  if constexpr (std::is_same<T, float>::value) {
    return lt::launch_with_smem(flash_bwd_dq_fp32_kernel, dim3(B * H, query_tiles),
                                kThreads, kQueryTileSmemBytes, stream, qt, kt, vt, dot, lse,
                                delta, static_cast<T*>(dq), N, H, sq, sk, sv, sdo, sdq, scale);
  } else {
    return lt::launch_with_smem(flash_bwd_dq_wgmma_kernel, dim3(query_tiles, B * H),
                                hp::kWarpgroup, kWgmmaDqSmemBytes, stream, qt, kt, vt, dot,
                                lse, delta, static_cast<T*>(dq), N, H, sq, sk, sv, sdo, sdq,
                                scale);
  }
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
      return launch_delta<float>(dout, o, dl, B, N, H, sdo, st);
    case lt::kBFloat16:
      return launch_delta<__nv_bfloat16>(dout, o, dl, B, N, H, sdo, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// `strides` holds 5 x 3 strides in the order q, k, v, dO, dQ. For bfloat16
// every pointer and stride is 16-byte aligned.
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
