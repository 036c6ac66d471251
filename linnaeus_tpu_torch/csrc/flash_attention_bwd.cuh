// Device code of K1's backward kernels (flash_attention_bwd_split.cu).
// Everything here has internal linkage: each source that includes this
// header compiles its own copy.
//
// Two bodies for the block that owns a key tile (dK and dV), chosen by dtype
// in the C entry points:
//   `key_tile_backward_wgmma`, bfloat16: one warpgroup, all four tile
//   products on the tensor cores (see its note);
//   `key_tile_backward_fp32`, float32: 64 x 64 tiles in padded
//   float32 shared memory, a 16 x 16 grid of threads that each own a 4 x 4
//   patch of a tile product, float32 FMAs on the CUDA cores. float32 has no
//   tensor-core product that keeps its 2e-5 agreement with the plain version.
// The split pair's float32 dQ kernel uses the CUDA-core helpers too; its
// bfloat16 kernel is in flash_attention_bwd_split.cu.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kD = 64;        // head dim, compiled in
constexpr int kBQ = 64;       // query rows per tile
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256; // a 16 x 16 grid of threads, 4 x 4 patch each
constexpr int kLd = kD + 1;   // padded row of a shared tile: conflict-free columns
constexpr int kTile = 64 * kLd;
// a float32 block that owns a key tile: 6 tiles and the lse and delta of a query tile
constexpr size_t kKeyTileSmemBytes = (6 * kTile + 2 * kBQ) * sizeof(float);

struct Strides {
  long long b, n, h;  // element strides; the head dim is unit-stride
};

// delta = rowsum(dO * O) in float32, one warp per (b, n, h) row, written as
// (B, H, N).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const T* __restrict__ dout, const T* __restrict__ o,
                 float* __restrict__ delta, long long rows, int N, int H, Strides sdo) {
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
  if (lane == 0) delta[(b * H + h) * N + n] = s;
}

template <typename T>
cudaError_t launch_delta(const void* dout, const void* o, float* delta, int B, int N,
                         int H, Strides sdo, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * N * H;
  const unsigned row_blocks =
      static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  delta_kernel<T><<<row_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(o), delta, rows, N, H, sdo);
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

// float32 on the CUDA cores. The work of a block (kThreads threads) that owns
// one 64-key tile of one (b, h): K and V of the tile in shared memory, dK and
// dV in registers, a walk over the query tiles. `smem` holds
// kKeyTileSmemBytes.
__device__ __forceinline__ void key_tile_backward_fp32(
    float* __restrict__ smem, const float* __restrict__ q,
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv,
    int N,
    int H, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
    Strides sdv, float scale) {
  float* ks = smem;
  float* vs = ks + kTile;
  float* qs = vs + kTile;
  float* dos = qs + kTile;
  float* ps = dos + kTile;   // P, [query][key]
  float* dss = ps + kTile;   // dS, [query][key]
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

  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
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
    store_p_ds<float>(s, dp, lse_s, delta_s, q0, k0, N, scale, ty, tx, ps, dss);
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
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty * 4 + i;
    if (r >= N) continue;
    float* dkp = dk + b * sdk.b + r * sdk.n + h * sdk.h;
    float* dvp = dv + b * sdv.b + r * sdv.n + h * sdv.h;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dkp[tx + 16 * j] = dk_acc[i][j] * scale;
      dvp[tx + 16 * j] = dv_acc[i][j];
    }
  }
}

// bfloat16 on the tensor cores. The work of a block of one warpgroup that
// owns one 64-key tile of one (b, h) and walks the query tiles.
//
// What bounds it: 8 N^2 D operations for a few N D
// elements, so arithmetic, and so the tensor cores. K and V of the tile
// (8 KB each, swizzled) are loaded once; Q and dO tiles of 64 queries, with
// their lse and delta, go through a ring of two stages filled by `cp.async`
// while the tile before is worked on (rows past N arrive as zeros).
// The scores are computed transposed, S^T = K Q^T and dP^T = V dO^T (rows
// are keys, columns queries; every operand is read from its tile as it
// lies), so that P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta),
// cast to bf16 where the TPU kernel casts them, already sit in registers as
// the A fragments of dV += P^T dO and dK += dS^T Q (dO's and Q's tiles read
// transposed through the descriptor): P and dS never touch shared memory
// for dK and dV, which stay in registers over the whole walk. lse and delta
// run along columns here: a thread reads its sixteen of each from shared
// memory.
// What is left against the bound: one warpgroup a block computes its
// exponentials and its products in turn, so the tensor cores work only
// while another block of the SM is in its products: the kernels are held to
// 168 registers a thread (kWgmmaKeyTileBlocksPerSM; a thread holds five
// 64 x 64 fragments) so that three blocks share an SM, which measured 12 to
// 21% faster than the two that 175 registers allow.
constexpr int kWgmmaKeyTileBlocksPerSM = 3;
constexpr int kStatsBytes = 2 * kBQ * sizeof(float);  // lse and delta of a query tile
// the slack to align the tiles, K and V, two stages of Q and dO, the two
// stages' lse and delta
constexpr size_t kWgmmaKeyTileSmemBytes =
    1024 + 2 * hp::kTileBytes + 2 * 2 * hp::kTileBytes + 2 * kStatsBytes;

// Q and dO rows q0 .. q0 + 63 with their lse and delta into one stage.
__device__ __forceinline__ void load_query_stage(
    uint32_t tiles, uint32_t stats, const __nv_bfloat16* qb, long long q_stride,
    const __nv_bfloat16* dob, long long do_stride, const float* lse_b,
    const float* delta_b, int q0, int N) {
  hp::load_rows_async<kBQ>(tiles, qb, q_stride, q0, N);
  hp::load_rows_async<kBQ>(tiles + hp::kTileBytes, dob, do_stride, q0, N);
  const int i = threadIdx.x & (kBQ - 1);
  const bool live = q0 + i < N;
  const float* src = (threadIdx.x < kBQ ? lse_b : delta_b) + (live ? q0 + i : 0);
  hp::cp_async_4(stats + threadIdx.x * sizeof(float), src, live);
}

__device__ __forceinline__ void key_tile_backward_wgmma(
    uint8_t* __restrict__ smem_raw, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int N, int H,
    Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
    float scale) {
  // tiles are 1024-byte aligned: the swizzle is a function of address bits
  const uint32_t pad = (1024u - (hp::smem_addr(smem_raw) & 1023u)) & 1023u;
  uint8_t* k_tile = smem_raw + pad;
  uint8_t* v_tile = k_tile + hp::kTileBytes;
  uint8_t* ring_tiles = v_tile + hp::kTileBytes;        // stage s: Q then dO
  uint8_t* ring_stats = ring_tiles + 4 * hp::kTileBytes;  // stage s: lse then delta
  const uint32_t k_addr = hp::smem_addr(k_tile), v_addr = hp::smem_addr(v_tile);
  const uint32_t ring_addr = hp::smem_addr(ring_tiles);
  const uint32_t stats_addr = hp::smem_addr(ring_stats);

  const int k0 = blockIdx.x * kBK;
  const int bh = blockIdx.y;
  const long long b = bh / H;
  const int h = bh % H;
  const int lane = threadIdx.x & 31;
  const int row = (threadIdx.x >> 5) * 16 + (lane >> 2);  // and row + 8: keys
  const int col = 2 * (lane & 3);  // first of this lane's two columns of each 8

  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_b = lse + static_cast<long long>(bh) * N;
  const float* delta_b = delta + static_cast<long long>(bh) * N;

  hp::load_rows_async<kBK>(k_addr, k + b * sk.b + h * sk.h, sk.n, k0, N);
  hp::load_rows_async<kBK>(v_addr, v + b * sv.b + h * sv.h, sv.n, k0, N);
  load_query_stage(ring_addr, stats_addr, qb, sq.n, dob, sdo.n, lse_b, delta_b, 0, N);
  hp::cp_async_commit();

  constexpr float kLog2e = 1.4426950408889634f;
  const float c = scale * kLog2e;  // P = exp2(S c - lse log2 e)
  const bool key_live[2] = {k0 + row < N, k0 + row + 8 < N};
  const uint64_t k_desc = hp::descriptor(k_addr), v_desc = hp::descriptor(v_addr);

  float dk_acc[32], dv_acc[32];  // [key][dim] as accumulator fragments
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const int tiles = (N + kBQ - 1) / kBQ;
  for (int t = 0; t < tiles; ++t) {
    const int q0 = t * kBQ;
    const int s = t & 1;
    // tile t has landed, and every thread is done with tile t - 1 (its
    // stage, which the next copies overwrite)
    hp::cp_async_wait_all();
    hp::fence_async_proxy();
    __syncthreads();
    if (t + 1 < tiles)
      load_query_stage(ring_addr + (s ^ 1) * 2 * hp::kTileBytes,
                       stats_addr + (s ^ 1) * kStatsBytes, qb, sq.n, dob, sdo.n, lse_b,
                       delta_b, q0 + kBQ, N);
    hp::cp_async_commit();

    const uint64_t q_desc = hp::descriptor(ring_addr + s * 2 * hp::kTileBytes);
    const uint64_t do_desc =
        hp::descriptor(ring_addr + s * 2 * hp::kTileBytes + hp::kTileBytes);
    const float* lse_s = reinterpret_cast<const float*>(ring_stats + s * kStatsBytes);
    const float* delta_s = lse_s + kBQ;

    // S^T = K Q^T and dP^T = V dO^T: [key][query]
    float st[32], dpt[32];
    hp::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks)
      hp::wgmma_ss_n64<0, 0>(st, k_desc + hp::k_major_step(ks),
                             q_desc + hp::k_major_step(ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks)
      hp::wgmma_ss_n64<0, 0>(dpt, v_desc + hp::k_major_step(ks),
                             do_desc + hp::k_major_step(ks), ks > 0);
    hp::wgmma_commit();
    hp::wgmma_wait_all();
    hp::fence_registers(st);
    hp::fence_registers(dpt);

    // P^T and dS^T in bf16, as the A fragments of the next products.
    // st[4 j + 2 half + e]: key row + 8 half, query q0 + 8 j + col + e.
    // Pairs past N give zero, as the TPU kernels' masked columns and
    // zero-padded rows do.
    uint32_t pt[16], dst[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qi = 8 * j + col;
      const float2 row_lse = *reinterpret_cast<const float2*>(lse_s + qi);
      const float2 row_delta = *reinterpret_cast<const float2*>(delta_s + qi);
      const bool q_live[2] = {q0 + qi < N, q0 + qi + 1 < N};
      const float shift[2] = {-row_lse.x * kLog2e, -row_lse.y * kLog2e};
      const float dl[2] = {row_delta.x, row_delta.y};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * half + e;
          p[e] = key_live[half] && q_live[e] ? exp2f(fmaf(st[i], c, shift[e])) : 0.f;
          ds[e] = p[e] * (dpt[i] - dl[e]);
        }
        pt[2 * j + half] = hp::pack_bf16(p[0], p[1]);
        dst[2 * j + half] = hp::pack_bf16(ds[0], ds[1]);
      }
    }

    // dV += P^T dO and dK += dS^T Q: dO's and Q's tiles read transposed
    hp::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBQ / 16; ++ks)
      hp::wgmma_rs_n64(dv_acc, pt + 4 * ks, do_desc + hp::mn_major_step(ks));
#pragma unroll
    for (int ks = 0; ks < kBQ / 16; ++ks)
      hp::wgmma_rs_n64(dk_acc, dst + 4 * ks, q_desc + hp::mn_major_step(ks));
    hp::wgmma_commit();

    hp::wgmma_wait_all();
    hp::fence_registers(dv_acc);
    hp::fence_registers(dk_acc);
  }

  // dK * scale and dV through K's and V's tiles to 16-byte stores
  uint32_t out_k[16], out_v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    // pair i = 2 j + half holds elements 4 j + 2 half + {0, 1} of a fragment
    const int e = 4 * (i >> 1) + 2 * (i & 1);
    out_k[i] = hp::pack_bf16(dk_acc[e] * scale, dk_acc[e + 1] * scale);
    out_v[i] = hp::pack_bf16(dv_acc[e], dv_acc[e + 1]);
  }
  __syncthreads();  // every warp's last read of K's and V's tiles is done
  hp::store_fragment(k_tile, out_k);
  hp::store_fragment(v_tile, out_v);
  __syncthreads();
  hp::store_rows(k_tile, dk + b * sdk.b + h * sdk.h, sdk.n, k0, N);
  hp::store_rows(v_tile, dv + b * sdv.b + h * sdv.h, sdv.n, k0, N);
}

}  // namespace
