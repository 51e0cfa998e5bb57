// Fused masked instance norm + exact GELU for the wav2vec2 conv layer 0.
//
// Replaces the TPU kernel `pallas_instance_norm_gelu` in
// multimodaltopicsegmentation_tpu/ops/pallas_norm.py (kernel body `_kernel`)
// and computes the function the JAX engine path actually runs there:
// `_group_norm(..., frame_mask=fm)` with groups == channels, then exact GELU
// (multimodaltopicsegmentation_tpu/encoders/wav2vec2.py:123-131, 278-282).
//
// x is [B, C, T] float32 (the layout conv1d returns). For each (row, channel)
// series the statistics cover the row's first `lengths[b]` frames only
// (count max(valid, 1), two-pass variance, eps 1e-5); normalisation, the
// affine and GELU then apply to ALL T frames, as the JAX group norm does.
//
// Bound: memory. At the main-path shape, one 256-row chunk [256, 512, 3199]
// is 1.68 GB; one read plus one write is 3.35 GB, about 1.0 ms at the H100
// data-sheet rate of 3.35 TB/s, against some 25 GFLOP of arithmetic (0.4 ms
// at 67 TFLOP/s in float32).
//
// Design: the TPU kernel streamed time blocks twice with the sums carried in
// VMEM scratch across a sequential grid. Blocks here run in no order, so one
// block owns one whole series instead: a series of 3199 floats (12.8 KB)
// sits in shared memory, the block reduces it there (mean, then the squared
// deviations) and writes the result, so device memory sees one read and one
// write. A series too long for shared memory is re-read from device memory
// (three reads + one write). Vector loads and several series per block are
// left for later tuning.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-5f;
constexpr float kSqrtHalf = 0.70710678118654752440f;

// Sum of `v` over the block; every thread gets the total. `red` holds one
// partial per warp and may be reused by the next call.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // readers of the previous call are done with `red`
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < kWarps ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

template <bool kCached>
__global__ void __launch_bounds__(kThreads)
instance_norm_gelu_kernel(const float* __restrict__ x,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          const int* __restrict__ lengths,
                          float* __restrict__ out, int C, int T) {
  extern __shared__ float cache[];  // [T] when kCached
  __shared__ float red[kWarps];

  const long long series = blockIdx.x;
  const int b = static_cast<int>(series / C);
  const int c = static_cast<int>(series % C);
  const float* xs = x + series * static_cast<long long>(T);
  float* os = out + series * static_cast<long long>(T);

  int valid = T;
  if (lengths != nullptr) valid = min(max(lengths[b], 0), T);
  const float inv_cnt = 1.f / static_cast<float>(max(valid, 1));

  float s = 0.f;
  for (int t = threadIdx.x; t < T; t += kThreads) {
    const float v = xs[t];
    if (kCached) cache[t] = v;
    if (t < valid) s += v;
  }
  const float mu = block_sum(s, red) * inv_cnt;

  // each thread reads back only the entries it wrote itself above, and
  // block_sum's barriers order the rest
  const float* src = kCached ? cache : xs;
  float q = 0.f;
  for (int t = threadIdx.x; t < valid; t += kThreads) {
    const float d = src[t] - mu;
    q += d * d;
  }
  const float var = block_sum(q, red) * inv_cnt;

  const float rstd = rsqrtf(var + kEps);
  const float g = scale[c];
  const float h = bias[c];
  for (int t = threadIdx.x; t < T; t += kThreads) {
    const float y = (src[t] - mu) * rstd * g + h;
    os[t] = 0.5f * y * (1.f + erff(y * kSqrtHalf));
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// `lengths` may be null (statistics over all T frames).
extern "C" int mts_instance_norm_gelu_f32(const float* x, const float* scale,
                                          const float* bias, const int* lengths,
                                          float* out, int B, int C, int T,
                                          void* stream) {
  if (B <= 0 || C <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(B) * C;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t bytes = static_cast<size_t>(T) * sizeof(float);
  const size_t static_bytes = kWarps * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bytes + static_bytes <= static_cast<size_t>(smem_optin)) {
    if (bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(instance_norm_gelu_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    instance_norm_gelu_kernel<true><<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(
        x, scale, bias, lengths, out, C, T);
  } else {
    instance_norm_gelu_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        x, scale, bias, lengths, out, C, T);
  }
  return static_cast<int>(cudaGetLastError());
}
