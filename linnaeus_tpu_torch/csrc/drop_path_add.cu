// Stochastic depth inside the residual add, for the residual sites that K2
// does not fuse (the RoPE blocks' attention and MLP branches, the ConvNeXt
// blocks past K2's widths, the other blocks that meet a DropPath):
//   out = residual + s[b] * branch,   s[b] = (u[b] < keep) / keep,
// and its backward, d_branch = s[b] * dout (d_residual is dout itself and
// stays in the wrapper, linnaeus_tpu_torch/ops/drop_path.py).
//
// Replaces no TPU kernel. The TPU package writes drop path as plain array
// code (linnaeus_tpu/models/blocks/common.py `DropPath`), which XLA fuses
// into the add; eager PyTorch runs it as five passes forward (the division,
// a zero tensor, a `where` over a broadcast mask, the add) and two backward.
//
// What bounds it on the H100: bytes. With T the bytes of one activation,
// the forward reads the residual and the branch and writes the sum (3T),
// the backward reads dout and writes d_branch (2T); a dropped sample's
// branch is not read, and its d_branch is written as zeros without reading
// dout. The arithmetic is one FMA an element.
//
// Design: a block of 256 threads covers 256 pieces of one sample
// (blockIdx.y is the sample), so a thread's scale is one cached load and no
// division; a piece is 16 bytes (8 bf16, 4 float32) where the sample's
// length and the pointers allow, one element otherwise. The sum is taken in
// float32 as one FMA and rounded once to the storage type. No atomics and no
// order: the same bits from run to run.

#include <stdint.h>

#include "drop_path.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxSamples = 65535;  // the grid's y dimension

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T x[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    drop_path_add_kernel(const T* __restrict__ residual, const T* __restrict__ branch,
                         T* __restrict__ out, const lt::SampleScale s) {
  using P = Pack<T, V>;
  const long long packs = s.per / V;  // of a sample
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= packs) return;
  const long long b = blockIdx.y;
  const long long at = b * packs + i;
  const float scale = s.of_sample(b);
  const P r = reinterpret_cast<const P*>(residual)[at];
  if (scale == 0.f) {  // a dropped sample is its residual; the branch is not read
    reinterpret_cast<P*>(out)[at] = r;
    return;
  }
  const P x = reinterpret_cast<const P*>(branch)[at];
  P o;
#pragma unroll
  for (int k = 0; k < V; ++k)
    o.x[k] = lt::from_float<T>(fmaf(scale, lt::to_float(x.x[k]), lt::to_float(r.x[k])));
  reinterpret_cast<P*>(out)[at] = o;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    scale_samples_kernel(const T* __restrict__ in, T* __restrict__ out, const lt::SampleScale s) {
  using P = Pack<T, V>;
  const long long packs = s.per / V;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= packs) return;
  const long long b = blockIdx.y;
  const long long at = b * packs + i;
  const float scale = s.of_sample(b);
  P o;
  if (scale == 0.f) {  // zeros, whatever `in` holds; it is not read
#pragma unroll
    for (int k = 0; k < V; ++k) o.x[k] = lt::from_float<T>(0.f);
  } else {
    const P g = reinterpret_cast<const P*>(in)[at];
#pragma unroll
    for (int k = 0; k < V; ++k) o.x[k] = lt::from_float<T>(scale * lt::to_float(g.x[k]));
  }
  reinterpret_cast<P*>(out)[at] = o;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

bool valid(const lt::SampleScale& s) {
  return s.u != nullptr && s.per >= 1 && s.samples >= 1 && s.samples <= kMaxSamples;
}

// pieces of 16 bytes where the sample's length and every pointer allow
template <typename T>
bool whole_pieces(const lt::SampleScale& s, const void* a, const void* b, const void* c) {
  return s.per % (16 / sizeof(T)) == 0 && aligned16(a) && aligned16(b) && aligned16(c);
}

dim3 grid_of(const lt::SampleScale& s, int per_piece) {
  const long long packs = s.per / per_piece;
  return dim3(static_cast<unsigned>((packs + kThreads - 1) / kThreads),
              static_cast<unsigned>(s.samples));
}

template <typename T>
cudaError_t add_typed(const void* residual, const void* branch, void* out,
                      const lt::SampleScale& s, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  auto r = static_cast<const T*>(residual);
  auto x = static_cast<const T*>(branch);
  auto o = static_cast<T*>(out);
  if (whole_pieces<T>(s, residual, branch, out))
    drop_path_add_kernel<T, V><<<grid_of(s, V), kThreads, 0, stream>>>(r, x, o, s);
  else
    drop_path_add_kernel<T, 1><<<grid_of(s, 1), kThreads, 0, stream>>>(r, x, o, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t scale_typed(const void* in, void* out, const lt::SampleScale& s,
                        cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  auto g = static_cast<const T*>(in);
  auto o = static_cast<T*>(out);
  if (whole_pieces<T>(s, in, out, out))
    scale_samples_kernel<T, V><<<grid_of(s, V), kThreads, 0, stream>>>(g, o, s);
  else
    scale_samples_kernel<T, 1><<<grid_of(s, 1), kThreads, 0, stream>>>(g, o, s);
  return cudaGetLastError();
}

lt::SampleScale sample_scale(const void* u, float keep, float inv_keep, long long samples,
                             long long per) {
  lt::SampleScale s;
  s.u = static_cast<const float*>(u);
  s.keep = keep;
  s.inv_keep = inv_keep;
  s.per = per;
  s.samples = samples;
  return s;
}

}  // namespace

cudaError_t lt::scale_samples(const void* in, void* out, const lt::SampleScale& s, int dtype,
                              cudaStream_t stream) {
  if (!valid(s)) return cudaErrorInvalidValue;
  switch (dtype) {
    case lt::kFloat32:
      return scale_typed<float>(in, out, s, stream);
    case lt::kBFloat16:
      return scale_typed<__nv_bfloat16>(in, out, s, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// out = residual + s[b] * branch over `samples` samples of `per` elements
// each, every operand contiguous in the dtype of `dtype`'s code; u holds
// the samples' float32 uniform draws. Returns the launch's cudaError_t.
extern "C" int lt_drop_path_add_fwd(const void* residual, const void* branch, void* out,
                                    const void* u, float keep, float inv_keep,
                                    long long samples, long long per, int dtype, void* stream) {
  const lt::SampleScale s = sample_scale(u, keep, inv_keep, samples, per);
  if (!valid(s)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case lt::kFloat32:
      return add_typed<float>(residual, branch, out, s, st);
    case lt::kBFloat16:
      return add_typed<__nv_bfloat16>(residual, branch, out, s, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// d_branch = s[b] * dout, the operands as lt_drop_path_add_fwd's.
extern "C" int lt_drop_path_add_bwd(const void* dout, void* d_branch, const void* u, float keep,
                                    float inv_keep, long long samples, long long per, int dtype,
                                    void* stream) {
  return lt::scale_samples(dout, d_branch, sample_scale(u, keep, inv_keep, samples, per), dtype,
                           static_cast<cudaStream_t>(stream));
}
