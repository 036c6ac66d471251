// K2 forward in bfloat16 on the tensor cores:
//   out = (GELU(LN(y) W1^T + b1) W2^T + b2) * gamma  [+ residual]
// with the casts and layouts of fused_mlp_fwd.cu (which keeps float32 and
// the widths this kernel does not take on the CUDA cores).
//
// Replaces the Pallas kernel linnaeus_tpu/ops/fused_mlp.py `_body` (through
// `_kernel` / `_kernel_nores`, launched by `_pallas_fused`) for bfloat16
// operands with C a multiple of 32 up to 256 and the hidden width a multiple
// of 64 (`lt::mlp_fwd_takes_wgmma`).
//
// What bounds it on the H100: 16 M C^2 operations for 3 M C elements moved,
// so arithmetic at C = 192 (and the 4 M C evaluations of GELU, which at
// C = 96 take about as many instruction slots as the products take
// tensor-core time). The CUDA-core kernel ran at 1/42 to 1/69 of the bound:
// float32 FMAs from float32 shared-memory tiles, every weight chunk staged
// and converted element by element behind four barriers, nothing overlapped.
// What this design does about it:
//
//   - Persistent blocks of kGroups consumer warpgroups and one producer
//     warpgroup (one thread of it works; it gives its registers to the
//     consumers); a block walks over row tiles of 64 kGroups rows, a
//     consumer owns 64 of them. The consumers never wait for one another:
//     while one runs its products another evaluates its GELU or its
//     LayerNorm.
//   - The weight chunks come through a ring of stages that the producer's
//     one thread fills with the Tensor Memory Accelerator and that runs on
//     across tiles (fused_mlp_body_wgmma.cuh): no thread of a consumer spends
//     an instruction on them.
//   - LN by the warpgroup itself: a lane 16 bytes of a row, read once from
//     device memory (the lines were asked into L2 a tile earlier),
//     statistics in float32, h0 written as bf16 into a swizzled tile. No
//     workspace, no prologue launch.
//   - Both products as `wgmma`, GELU in registers between them; the second
//     product is one instruction as wide as C a k-step (n96 at C = 96, n192
//     at C = 192: a chain of four long instructions a chunk; short ones
//     leave the tensor cores waiting on the chain's latency).
//   - Epilogue: the residual tile is copied into the (by then free) h0 tile
//     under the last chunk's GELU and product; (acc + b2) * gamma + residual
//     in float32 from the fragment, one cast, back into the same tile, and
//     out of it to device memory in 16-byte stores. Rows past M are
//     zero-filled on load and not stored. In training under drop path
//     (`kScaled`, drop_path.cuh) the branch is scaled by its sample's
//     s = (u < keep) / keep inside the same FMA: residual + s (acc + b2)
//     gamma, a dropped sample's rows their residual.
//
// The output is a function of the operands alone (no atomics, a fixed order
// of sums): the same bits from run to run.

#include <stdint.h>

#include "fused_mlp_body_wgmma.cuh"

namespace {

template <int kN, int kGroups>
struct FwdWgmma {
  static constexpr int kAtoms = (kN + 63) / 64;
  using Tail = WgmmaTail<kAtoms>;
  static constexpr int kConsumers = kGroups * hp::kWarpgroup;
  static constexpr int kBlock = kConsumers + hp::kWarpgroup;  // and the producer's warpgroup
  // registers a thread: the producer keeps 40, the consumers share the rest
  static constexpr int kSpare = (65536 / hp::kWarpgroup - 40) / kGroups / 8 * 8;
  static constexpr int kConsumerRegs = kSpare < 232 ? kSpare : 232;
  static constexpr int kTilesBytes = kGroups * Tail::kTile;  // the warpgroups' h0 tiles
  // as many stages as an SM's shared memory holds beside the tiles
  static constexpr int kStages = [] {
    const int fit = (227 * 1024 - 1024 - kTilesBytes) / (Tail::kStageBytes + 16);
    return fit < Tail::kMaxStages ? fit : Tail::kMaxStages;
  }();
  static_assert(kStages >= 2, "the ring needs two stages");
  static constexpr size_t kSmemBytes = 1024 + kTilesBytes + Tail::ring_bytes(kStages);
};

template <int kN, int kGroups, bool kScaled>
__global__ void __launch_bounds__((kGroups + 1) * hp::kWarpgroup, 1)
    fused_mlp_wgmma_kernel(const __grid_constant__ CUtensorMap w1_map,
                           const __grid_constant__ CUtensorMap w2_map,
                           const bf16* __restrict__ y, const bf16* __restrict__ x,
                           const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                           const float* __restrict__ b1, const float* __restrict__ b2,
                           const float* __restrict__ gamma, bf16* __restrict__ out, long long M,
                           int C, int Hd, float eps, bool approximate,
                           const lt::SampleScale scale) {
  using P = FwdWgmma<kN, kGroups>;
  constexpr int kAtoms = P::kAtoms;
  using L = LnLanes<kAtoms>;
  constexpr int kTile = P::Tail::kTile;
  constexpr int kRows = kGroups * kBM;  // rows of a block's tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (hp::smem_addr(smem_raw) & 1023u)) & 1023u;
  uint8_t* base = smem_raw + pad;
  const TailRing ring = tail_ring<kAtoms>(hp::smem_addr(base + P::kTilesBytes), P::kStages);

  const int n_chunks = Hd / kHC;
  const long long tiles = (M + kRows - 1) / kRows;
  const int my_tiles = static_cast<int>((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);

  if (threadIdx.x == 0) tail_ring_init(ring, kGroups);
  __syncthreads();

  if (threadIdx.x >= P::kConsumers) {
    hp::give_registers<40>();
    if (threadIdx.x == P::kConsumers)
      tail_produce<kAtoms>(ring, &w1_map, &w2_map, n_chunks,
                           static_cast<long long>(my_tiles) * n_chunks);
    return;
  }
  hp::take_registers<P::kConsumerRegs>();

  const int group = threadIdx.x >> 7;
  const int in_group = threadIdx.x & 127;
  const int warp = in_group >> 5;  // within the warpgroup
  uint8_t* tile = base + group * kTile;  // this warpgroup's h0, later its output rows
  const uint32_t h0_tile = hp::smem_addr(tile);
  const int chunks16 = C / 8;  // live 16-byte pieces of a row
  const bool owner = L::piece() < chunks16;
  auto sync_group = [&]() { hp::named_barrier(1 + group, hp::kWarpgroup); };

  for (int it = 0; it < my_tiles; ++it) {
    const long long row0 =
        (blockIdx.x + static_cast<long long>(it) * gridDim.x) * kRows + group * kBM;

    // ask for the next tile's rows of y, and this tile's of the residual
    {
      const long long next0 = row0 + static_cast<long long>(gridDim.x) * kRows;
      const int lines = (C * 2 + 127) / 128;  // 128-byte lines of a row
      for (int i = in_group; i < kBM * lines; i += hp::kWarpgroup) {
        const long long r = i / lines;
        const int piece = (i % lines) * 64;
        if (it + 1 < my_tiles && next0 + r < M) hp::prefetch_l2(y + (next0 + r) * C + piece);
        if (x != nullptr && row0 + r < M) hp::prefetch_l2(x + (row0 + r) * C + piece);
      }
    }

    // 1. LayerNorm of the warpgroup's 64 rows into its tile, 16 rows a warp
    // (a warp's loads are in flight together)
    constexpr int kLoads = kBM / 4 / L::kPer;
    uint4 raw[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const long long r = row0 + warp * (kBM / 4) + k * L::kPer + L::sub();
      raw[k] = make_uint4(0u, 0u, 0u, 0u);
      if (owner && r < M) raw[k] = *reinterpret_cast<const uint4*>(y + r * C + L::piece() * 8);
    }
    constexpr int kAtOnce = 4;  // loads whose sums share the shuffles' latency
#pragma unroll
    for (int k0 = 0; k0 < kLoads; k0 += kAtOnce) {
      const int r = warp * (kBM / 4) + k0 * L::kPer;
      float v[kAtOnce][8];
#pragma unroll
      for (int k = 0; k < kAtOnce; ++k) {
        const bf16* rb = reinterpret_cast<const bf16*>(&raw[k0 + k]);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[k][i] = __bfloat162float(rb[i]);
      }
      const long long left = M - (row0 + r);
      layer_norm_rows_to_tile<kAtoms, kAtOnce>(
          v, owner, static_cast<int>(left < 0 ? 0 : (left > kBM ? kBM : left)), tile, r, ln_w,
          ln_b, C, eps);
    }
    hp::fence_async_proxy();
    sync_group();

    // 2, 3. the hidden dim in chunks: a1 -> GELU -> the second product
    float acc[kAtoms][32];
    tail_consume<kN>(
        h0_tile, ring, static_cast<long long>(it) * n_chunks, n_chunks, b1, C, approximate, acc,
        [&]() {
          if (x == nullptr) return;
          sync_group();  // every warp's last a1 has read h0
          for (int i = in_group; i < kBM * chunks16; i += hp::kWarpgroup) {
            const int r = i / chunks16;
            const int c = i % chunks16;
            const bool live = row0 + r < M;
            hp::cp_async_16(h0_tile + (c >> 3) * hp::kTileBytes + hp::swizzled(r, c & 7),
                            x + (live ? (row0 + r) * C + c * 8 : 0), live);
          }
          hp::cp_async_commit();
        });

    // 4. (acc + b2) * gamma [+ residual] in float32, one cast, in the tile;
    // kScaled: residual + s (acc + b2) * gamma
    hp::cp_async_wait_all();
    sync_group();
    finish_in_tile<kAtoms, kScaled>(acc, tile, x != nullptr, b2, gamma, C, scale, row0);
    sync_group();
    for (int i = in_group; i < kBM * chunks16; i += hp::kWarpgroup) {
      const int r = i / chunks16;
      const int c = i % chunks16;
      if (row0 + r < M)
        *reinterpret_cast<uint4*>(out + (row0 + r) * C + c * 8) = *reinterpret_cast<const uint4*>(
            tile + (c >> 3) * hp::kTileBytes + hp::swizzled(r, c & 7));
    }
    sync_group();  // the tile is read out before the next LayerNorm writes it
  }
}

// Persistent blocks, one an SM.
template <int kN, int kGroups, bool kScaled>
cudaError_t launch(const lt::MlpFwdArgs& a) {
  using P = FwdWgmma<kN, kGroups>;
  auto kernel = fused_mlp_wgmma_kernel<kN, kGroups, kScaled>;
  static int sms = 0;
  if (sms == 0) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(P::kSmemBytes));
    if (err != cudaSuccess) return err;
    int device = 0, count = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return err;
    sms = count;
  }
  CUtensorMap w1_map, w2_map;
  const cudaError_t err = lt::weight_tensor_maps(a.w1, a.w2, a.C, a.Hd, &w1_map, &w2_map);
  if (err != cudaSuccess) return err;
  const long long tiles = (a.M + kGroups * kBM - 1) / (kGroups * kBM);
  const unsigned blocks = static_cast<unsigned>(tiles < sms ? tiles : sms);
  kernel<<<blocks, P::kBlock, P::kSmemBytes, a.stream>>>(
      w1_map, w2_map, static_cast<const bf16*>(a.y), static_cast<const bf16*>(a.x), a.ln_w,
      a.ln_b, a.b1, a.b2, a.gamma, static_cast<bf16*>(a.out), a.M, a.C, a.Hd, a.eps,
      a.approximate, a.scale);
  return cudaGetLastError();
}

template <int kN, int kGroups>
cudaError_t launch_scaled_or_not(const lt::MlpFwdArgs& a) {
  return a.scale.u != nullptr ? launch<kN, kGroups, true>(a) : launch<kN, kGroups, false>(a);
}

}  // namespace


cudaError_t lt::mlp_fwd_wgmma(const lt::MlpFwdArgs& a) {
  // the second product's width: C, or the next width that has an instruction
  // and the consumer warpgroups an SM's registers and shared memory hold:
  // three up to 128 columns, two past that
  if (a.C <= 64) return launch_scaled_or_not<64, 3>(a);
  if (a.C == 96) return launch_scaled_or_not<96, 3>(a);
  if (a.C <= 128) return launch_scaled_or_not<128, 3>(a);
  if (a.C <= 192) return launch_scaled_or_not<192, 2>(a);
  return launch_scaled_or_not<256, 2>(a);
}
