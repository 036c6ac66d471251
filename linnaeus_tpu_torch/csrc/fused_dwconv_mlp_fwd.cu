// K3 forward: a whole ConvNeXt block in one kernel,
//   out = x + (GELU(LN(dwconv7x7(x) + kb) @ W1^T + b1) @ W2^T + b2) * gamma.
//
// Replaces the Pallas kernel linnaeus_tpu/ops/fused_dwconv_mlp.py
// `_block_kernel` (launched by `_pallas_block`). Same casts: the 7 x 7
// depthwise convolution runs in float32 from float32 taps over the input
// converted to float32, with zeros outside the image, and its output goes
// into the LayerNorm unrounded; from there on it is K2's body (the LayerNorm
// rounded to the input dtype before the first product, the GELU output
// before the second, both products accumulated in float32); the bias, layer
// scale and the residual, which is the block's own input, are applied in
// float32 before the one cast of the result. Neither the convolution's
// output nor the (M, 4C) hidden tensor reaches device memory.
//
// Layout: x and out are (B, H, W, C) channels-last. The taps are (49, C)
// float32, tap dh * 7 + dw of channel c at [dh * 7 + dw][c]. W1 is (4C, C)
// and W2 is (C, 4C), the torch Linear layout, in the input dtype. The
// convolution's bias, the LN weight and bias, b1, b2 and gamma are float32
// vectors.
//
// Design. A block of 256 threads takes an 8 x 8 tile of output pixels of one
// image (the 64 rows of K2's body). It loads the 14 x 14 window around the
// tile, 3 halo pixels on every side, into shared memory as float32 by plain
// index arithmetic, zeros where the window leaves the image. (The TPU
// kernel passes x three times because its block indexing cannot express
// overlapping windows; that is not carried over.) Then each thread takes a
// channel and a row of 8 output pixels at a time: for each of the 7 kernel
// rows it reads 7 taps and the 14 window values of that row and channel and
// does 56 FMAs; neighbouring threads take neighbouring channels, so the
// shared-memory reads and the tap reads have unit stride. The 64 x C result
// lands in the tile buffer of the MLP body, which runs as in K2
// (fused_mlp_body.cuh). The window's memory is free by then and is reused
// for the body's chunk buffers, so the kernel needs
// tile + max(window, chunks) floats: 100 KB at C = 96, 200 KB at C = 192.
// The residual is read again from x (the same pixels this block loaded
// first, so from L2) in the epilogue.
//
// What bounds it on the H100: x read once and out written once, against
// 16 C + 98 operations per element: arithmetic at C = 96 and 192. The window
// is read (14 / 8)^2 = 3 times as often as a perfect tiling would.
//
// In bfloat16 at the widths of `block_takes_wgmma` the MLP tail runs on the
// tensor cores (`fused_block_wgmma_kernel`): the convolution stays on the
// CUDA cores and writes its float32 output as before; the LayerNorm writes
// h0 as bf16 into a swizzled tile; then the tail of
// fused_mlp_body_wgmma.cuh, with its weight ring in the window's freed
// memory. The tile's 64 rows are one warpgroup's: threads 0 .. 127 compute
// the tail, fed by one producer thread. float32 and the other widths keep
// the CUDA-core tail (`fused_block_kernel`).

#include <stdint.h>

#include "fused_mlp_body_wgmma.cuh"

namespace {

constexpr int kTH = 8;             // output tile: kTH x kTW pixels = kBM rows
constexpr int kTW = 8;
constexpr int kHalo = 3;           // a 7 x 7 kernel
constexpr int kWH = kTH + 2 * kHalo;  // window rows
constexpr int kWW = kTW + 2 * kHalo;  // window columns
static_assert(kTH * kTW == kBM, "the tile's pixels are the rows of the MLP body");

__host__ __device__ inline size_t block_smem_floats(int C) {
  const size_t window = static_cast<size_t>(kWH) * kWW * C;
  const size_t chunks = mlp_chunk_floats(C);
  return tile_floats(C) + (window > chunks ? window : chunks);
}

// Steps 1 and 2 of a block: the window around the tile at (y0, x0) of image
// `xb` into `win` (kWH x kWW x C float32, zeros outside the image), then the
// 7 x 7 depthwise convolution plus bias into h0 (kBM x ldh float32), one
// channel and one row of kTW output pixels per item, channels innermost
// across threads. Ends with a barrier: h0 is complete and the window free.
template <typename T>
__device__ __forceinline__ void depthwise_tile(const T* __restrict__ xb,
                                               const float* __restrict__ taps,
                                               const float* __restrict__ conv_b,
                                               float* __restrict__ win, float* __restrict__ h0,
                                               int ldh, int y0, int x0, int H, int W, int C) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kWH * kWW * C; i += kThreads) {
    const int c = i % C;
    const int p = i / C;
    const int gy = y0 - kHalo + p / kWW;
    const int gx = x0 - kHalo + p % kWW;
    float t = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      t = lt::to_float(xb[(static_cast<long long>(gy) * W + gx) * C + c]);
    win[i] = t;
  }
  __syncthreads();

  for (int item = tid; item < kTH * C; item += kThreads) {
    const int c = item % C;
    const int r = item / C;
    float acc[kTW];
#pragma unroll
    for (int px = 0; px < kTW; ++px) acc[px] = 0.f;
#pragma unroll
    for (int dh = 0; dh < 7; ++dh) {
      float tap[7], line[kWW];
#pragma unroll
      for (int dw = 0; dw < 7; ++dw) tap[dw] = taps[(dh * 7 + dw) * C + c];
#pragma unroll
      for (int wx = 0; wx < kWW; ++wx) line[wx] = win[((r + dh) * kWW + wx) * C + c];
#pragma unroll
      for (int dw = 0; dw < 7; ++dw)
#pragma unroll
        for (int px = 0; px < kTW; ++px)
          acc[px] = fmaf(line[px + dw], tap[dw], acc[px]);
    }
    const float bias = conv_b[c];
#pragma unroll
    for (int px = 0; px < kTW; ++px) h0[(r * kTW + px) * ldh + c] = acc[px] + bias;
  }
  __syncthreads();
}

template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
    fused_block_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                       const float* __restrict__ conv_b,
                       const float* __restrict__ ln_w,
                       const float* __restrict__ ln_b, const T* __restrict__ w1,
                       const float* __restrict__ b1, const T* __restrict__ w2,
                       const float* __restrict__ b2,
                       const float* __restrict__ gamma, T* __restrict__ out,
                       int H, int W, int C, int Hd, int tiles_x, float eps,
                       bool approximate) {
  extern __shared__ float smem[];
  const int ldh = C + 1;
  float* h0 = smem;                   // kBM x ldh: the convolution's output
  float* win = h0 + tile_floats(C);   // kWH x kWW x C, then the chunk buffers
  float* act = win;                   // kBM x (kHC + 1)
  float* wt = act + kBM * (kHC + 1);  // a staged chunk of W1 or W2

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int y0 = (blockIdx.x / tiles_x) * kTH;
  const int x0 = (blockIdx.x % tiles_x) * kTW;
  const T* xb = x + static_cast<long long>(blockIdx.y) * H * W * C;
  T* ob = out + static_cast<long long>(blockIdx.y) * H * W * C;

  // 1, 2. the window, then the convolution into h0; the window is then free
  // for act and wt
  depthwise_tile<T>(xb, taps, conv_b, win, h0, ldh, y0, x0, H, W, C);

  // 3. LayerNorm over every row of the tile (pixels past the image's edge
  // are computed and never written), then the MLP tail
  layer_norm_rows<T>(h0, ldh, C, kBM, ln_w, ln_b, eps);
  float acc[4][CPT];
  mlp_tail<T, CPT>(h0, act, wt, w1, b1, w2, C, Hd, approximate, acc);

  // 4. (acc + b2) * gamma + x, one cast to T
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    const int gy = y0 + row / kTW;
    const int gx = x0 + row % kTW;
    if (gy >= H || gx >= W) continue;
    const long long base = (static_cast<long long>(gy) * W + gx) * C;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 16 * j;
      if (c >= C) continue;
      const float t = (acc[i][j] + b2[c]) * gamma[c] + lt::to_float(xb[base + c]);
      ob[base + c] = lt::from_float<T>(t);
    }
  }
}

// Shared memory of the tensor-core kernel: (1024-byte aligned) the larger of
// the window and of the bf16 h0 tile with the tail's ring of two weight
// stages, which take the window's place; then the convolution's float32
// output.
template <int kN>
struct BlockWgmma {
  static constexpr int kAtoms = (kN + 63) / 64;
  using Tail = WgmmaTail<kAtoms>;
  static constexpr int kStages = 2;
  static constexpr size_t tail_bytes = Tail::kTile + Tail::ring_bytes(kStages);
  static size_t smem_bytes(int C) {
    const size_t window = static_cast<size_t>(kWH) * kWW * C * sizeof(float);
    return 1024 + tile_floats(C) * sizeof(float) + (window > tail_bytes ? window : tail_bytes);
  }
};

// After the convolution, which all 256 threads share, the block's first
// warpgroup runs the LayerNorm, the tail and the epilogue on the tile's 64
// rows, one thread of the fifth warp feeds it the weight chunks, and the
// other threads are done.
template <int kN>
__global__ void __launch_bounds__(kThreads, 1)
    fused_block_wgmma_kernel(const __grid_constant__ CUtensorMap w1_map,
                             const __grid_constant__ CUtensorMap w2_map,
                             const bf16* __restrict__ x, const float* __restrict__ taps,
                             const float* __restrict__ conv_b, const float* __restrict__ ln_w,
                             const float* __restrict__ ln_b, const float* __restrict__ b1,
                             const float* __restrict__ b2, const float* __restrict__ gamma,
                             bf16* __restrict__ out, int H, int W, int C, int Hd, int tiles_x,
                             float eps, bool approximate) {
  using P = BlockWgmma<kN>;
  constexpr int kAtoms = P::kAtoms;
  using L = LnLanes<kAtoms>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (hp::smem_addr(smem_raw) & 1023u)) & 1023u;
  uint8_t* tile = smem_raw + pad;  // the window; then h0 as bf16, then the ring
  float* win = reinterpret_cast<float*>(tile);
  const size_t window = static_cast<size_t>(kWH) * kWW * C * sizeof(float);
  float* conv_out = reinterpret_cast<float*>(
      tile + (window > P::tail_bytes ? window : P::tail_bytes));  // kBM x ldh
  const int ldh = C + 1;
  const uint32_t h0_tile = hp::smem_addr(tile);
  const TailRing ring = tail_ring<kAtoms>(h0_tile + P::Tail::kTile, P::kStages);

  const int y0 = (blockIdx.x / tiles_x) * kTH;
  const int x0 = (blockIdx.x % tiles_x) * kTW;
  const bf16* xb = x + static_cast<long long>(blockIdx.y) * H * W * C;
  bf16* ob = out + static_cast<long long>(blockIdx.y) * H * W * C;
  const int chunks16 = C / 8;
  const int n_chunks = Hd / kHC;

  // 1, 2. the window, then the convolution; the window is then free
  depthwise_tile<bf16>(xb, taps, conv_b, win, conv_out, ldh, y0, x0, H, W, C);
  if (threadIdx.x == 0) tail_ring_init(ring, 1);
  __syncthreads();

  if (threadIdx.x >= hp::kWarpgroup) {
    if (threadIdx.x == hp::kWarpgroup)
      tail_produce<kAtoms>(ring, &w1_map, &w2_map, n_chunks, n_chunks);
    return;
  }
  auto sync_group = [&]() { hp::named_barrier(1, hp::kWarpgroup); };

  // 3. LayerNorm of every row of the tile (pixels past the image's edge are
  // computed and never written) into the bf16 tile, 16 rows a warp
  {
    const int warp = threadIdx.x >> 5;
    const bool owner = L::piece() < chunks16;
    constexpr int kAtOnce = 4;
#pragma unroll
    for (int k0 = 0; k0 < kBM / 4 / L::kPer; k0 += kAtOnce) {
      const int r = warp * (kBM / 4) + k0 * L::kPer;
      float v[kAtOnce][8];
#pragma unroll
      for (int k = 0; k < kAtOnce; ++k)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[k][i] = owner ? conv_out[(r + k * L::kPer + L::sub()) * ldh + L::piece() * 8 + i]
                          : 0.f;
      layer_norm_rows_to_tile<kAtoms, kAtOnce>(v, owner, kBM, tile, r, ln_w, ln_b, C, eps);
    }
  }
  hp::fence_async_proxy();
  sync_group();

  // the tail; its residual, the tile's own pixels of x, lands in the h0 tile
  auto pixel = [&](int r) {  // offset of row r's pixel in the image, or -1 outside it
    const int gy = y0 + r / kTW;
    const int gx = x0 + r % kTW;
    return gy < H && gx < W ? (static_cast<long long>(gy) * W + gx) * C : -1LL;
  };
  float acc[kAtoms][32];
  tail_consume<kN>(h0_tile, ring, 0, n_chunks, b1, C, approximate, acc, [&]() {
    sync_group();  // every warp's last a1 has read h0
    for (int i = threadIdx.x; i < kBM * chunks16; i += hp::kWarpgroup) {
      const int r = i / chunks16;
      const int c = i % chunks16;
      const long long at = pixel(r);
      hp::cp_async_16(h0_tile + (c >> 3) * hp::kTileBytes + hp::swizzled(r, c & 7),
                      xb + (at >= 0 ? at + c * 8 : 0), at >= 0);
    }
    hp::cp_async_commit();
  });

  // 4. (acc + b2) * gamma + x in float32, one cast, out of the tile
  hp::cp_async_wait_all();
  sync_group();
  finish_in_tile<kAtoms>(acc, tile, true, b2, gamma, C);
  sync_group();
  for (int i = threadIdx.x; i < kBM * chunks16; i += hp::kWarpgroup) {
    const int r = i / chunks16;
    const int c = i % chunks16;
    const long long at = pixel(r);
    if (at >= 0)
      *reinterpret_cast<uint4*>(ob + at + c * 8) = *reinterpret_cast<const uint4*>(
          tile + (c >> 3) * hp::kTileBytes + hp::swizzled(r, c & 7));
  }
}

template <int kN>
cudaError_t launch_wgmma(const void* x, const float* taps, const float* conv_b,
                         const float* ln_w, const float* ln_b, const void* w1, const float* b1,
                         const void* w2, const float* b2, const float* gamma, void* out, int B,
                         int H, int W, int C, int Hd, float eps, bool approximate,
                         cudaStream_t stream) {
  CUtensorMap w1_map, w2_map;
  const cudaError_t err = lt::weight_tensor_maps(w1, w2, C, Hd, &w1_map, &w2_map);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int tiles_y = (H + kTH - 1) / kTH;
  return lt::launch_with_smem(fused_block_wgmma_kernel<kN>, dim3(tiles_x * tiles_y, B),
                              kThreads, BlockWgmma<kN>::smem_bytes(C), stream, w1_map, w2_map,
                              static_cast<const bf16*>(x), taps, conv_b, ln_w, ln_b, b1, b2,
                              gamma, static_cast<bf16*>(out), H, W, C, Hd, tiles_x, eps,
                              approximate);
}

template <typename T, int CPT>
cudaError_t launch(const void* x, const float* taps, const float* conv_b,
                   const float* ln_w, const float* ln_b, const void* w1,
                   const float* b1, const void* w2, const float* b2,
                   const float* gamma, void* out, int B, int H, int W, int C,
                   int Hd, float eps, bool approximate, cudaStream_t stream) {
  auto kernel = fused_block_kernel<T, CPT>;
  const size_t bytes = block_smem_floats(C) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int tiles_y = (H + kTH - 1) / kTH;
  const dim3 grid(tiles_x * tiles_y, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), taps, conv_b, ln_w, ln_b,
      static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2, gamma,
      static_cast<T*>(out), H, W, C, Hd, tiles_x, eps, approximate);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* taps, const float* conv_b,
                     const float* ln_w, const float* ln_b, const void* w1,
                     const float* b1, const void* w2, const float* b2,
                     const float* gamma, void* out, int B, int H, int W, int C,
                     int Hd, float eps, bool approximate, cudaStream_t s) {
  const int cpt = (C + 15) / 16;
#define LT_LAUNCH(N)                                                         \
  return launch<T, N>(x, taps, conv_b, ln_w, ln_b, w1, b1, w2, b2, gamma,    \
                      out, B, H, W, C, Hd, eps, approximate, s)
  if (cpt <= 2) LT_LAUNCH(2);
  if (cpt <= 4) LT_LAUNCH(4);
  if (cpt <= 6) LT_LAUNCH(6);
  if (cpt <= 8) LT_LAUNCH(8);
  LT_LAUNCH(12);
#undef LT_LAUNCH
}

// Widest C the column split of `dispatch` covers; its tile and window take
// 200 KB of an SM's 227 KB of shared memory.
constexpr int kMaxBlockC = 192;

// bfloat16 at the widths of the tensor-core tail, up to this kernel's own
// widest. linnaeus_tpu_torch/ops/fused_dwconv_mlp.py `forward_kernel` holds
// the same rule.
inline bool block_takes_wgmma(int C, int Hd, int dtype) {
  return C <= kMaxBlockC && lt::mlp_fwd_takes_wgmma(C, Hd, dtype);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Hd is the hidden
// width (4C for ConvNeXt). B is at most 65535 (it is a grid dimension).
extern "C" int lt_fused_convnext_block_fwd(
    const void* x, const void* taps, const void* conv_b, const void* ln_w,
    const void* ln_b, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* gamma, void* out, int B, int H, int W, int C,
    int Hd, float eps, int approximate, int dtype, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || C > kMaxBlockC || Hd < 1)
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  if (block_takes_wgmma(C, Hd, dtype)) {
#define LT_LAUNCH(N)                                                                         \
  return launch_wgmma<N>(x, f(taps), f(conv_b), f(ln_w), f(ln_b), w1, f(b1), w2, f(b2),      \
                         f(gamma), out, B, H, W, C, Hd, eps, approximate != 0, s)
    // the second product's width: C, or the next width that has an instruction
    if (C <= 64) LT_LAUNCH(64);
    if (C == 96) LT_LAUNCH(96);
    if (C <= 128) LT_LAUNCH(128);
    LT_LAUNCH(192);
#undef LT_LAUNCH
  }
  switch (dtype) {
    case lt::kFloat32:
      return dispatch<float>(x, f(taps), f(conv_b), f(ln_w), f(ln_b), w1, f(b1),
                             w2, f(b2), f(gamma), out, B, H, W, C, Hd, eps,
                             approximate != 0, s);
    case lt::kBFloat16:
      return dispatch<__nv_bfloat16>(x, f(taps), f(conv_b), f(ln_w), f(ln_b),
                                     w1, f(b1), w2, f(b2), f(gamma), out, B, H,
                                     W, C, Hd, eps, approximate != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// 1 where lt_fused_convnext_block_fwd runs the MLP tail on the tensor cores
// for this width, hidden width and dtype code, 0 where on the CUDA cores.
extern "C" int lt_fused_convnext_block_fwd_route(int C, int Hd, int dtype) {
  return block_takes_wgmma(C, Hd, dtype) ? 1 : 0;
}
