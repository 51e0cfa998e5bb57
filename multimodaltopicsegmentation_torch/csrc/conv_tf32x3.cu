// The strided convolutions of the wav2vec2 / WavLM feature stack, channels-
// last, in float32: conv layers 1.. as an implicit GEMM on Hopper's tensor
// cores (3xTF32, `wgmma`), conv layer 0 (one input channel) on the CUDA
// cores, the one transposing pass that brings a [B, C, T] activation (K1's
// output) into the channels-last layout, and WavLM's per-frame LayerNorm +
// GELU on those rows.
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA.
// Added for the port's encoders (encoders/wav2vec2.py): their conv stack was
// cuDNN's float32 FFMA implicit GEMM on [B, C, T] (TF32 is off, since the
// configurations state float32), the largest device item of the wav2vec2-base
// cell, and WavLM's per-frame LayerNorms cost two transposes a conv.
//
// Layout. Activations are [B, P, C] row-major, P a padded frame count chosen
// down the chain so that a layer's input holds exactly s times its output's
// frames (encoders/wav2vec2.padded_frames; 3200 = 64 * 50 at a 1-s unit).
// The input of a layer then reads as A0 [B P_out, s C] with no copy: row r
// holds frames s r .. s r + s - 1 of one row of the batch. Output frame r
// (over the whole batch) is sum_j W_j x[s r + j], and tap j of it is column
// (j mod s) C + c of A0's row r + j div s. So the GEMM's K = k C runs in
// (tap, channel) order over ceil(k / s) groups of s taps; group q is a plain
// tiled box of A0 shifted down q rows (`ConvSteps`), a 2-D tensor map with
// 16-byte aligned rows: no im2col mode and no overlapping strides are
// needed, and no tile row is lost at the batch's row boundaries. A box that
// runs past a group's taps meets TMA's zero fill (past s C) or zero weight
// columns (past k C). A padded output frame may read the next batch row's
// first frames; a valid one never reads a padded frame, since T_out =
// (T_in - k) // s + 1. The weights are [C_out, k C] in (tap, channel) order,
// split once (ops/conv_tf32x3.FusedConv).
//
// Bound. Conv layers 1-6 of a 1-s unit are 4.86 GFLOP (2 k C_in C_out T_out
// per layer), operations at 165 TFLOP/s (495 TFLOP/s dense TF32 over three
// passes; data sheet, 700 W); their bytes (inputs, outputs, weights) are 26
// MB a unit, under a tenth of that time at 3.35 TB/s. Conv layer 0, the
// transpose and the LayerNorm + GELU are memory-bound: conv layer 0 writes
// 6.5 MB a 1-s unit, the transpose reads and writes as much, the LayerNorm +
// GELU reads and writes each layer's frames once (26 MB a unit over all
// seven).
//
// Design. Conv layers 1..: the GEMM body of csrc/wgmma_tf32x3.cuh, which the
// dense layer uses too, with the producer's A coordinates from `ConvSteps`;
// the epilogue adds the conv's bias and applies the exact GELU (wav2vec2's
// layers 1-6). Conv layer 0: a block computes 64 frames of one batch row for
// every channel, with its samples in shared memory (read as broadcasts) and
// each thread's taps in registers; a warp stores 32 neighbouring channels of
// a frame. Transpose: [32, 32] tiles through shared memory, read along time
// and written along channels, frames past T written as zeros. LayerNorm +
// GELU: a warp a row, three passes over it (mean, squared deviations, the
// output), the later two served by L1, so device memory sees one read and
// one write, where torch's LayerNorm and GELU made two of each.

#include "wgmma_tf32x3.cuh"

namespace {

using mts::wg::kBK;

// The steps of K of a strided conv over channels-last input (see the note
// above): full groups of s taps take `per_group` steps, the last group of
// k - (groups - 1) s taps what its columns need.
struct ConvSteps {
  int count;      // steps over all groups
  int per_group;  // steps of a full group: ceil(s C / 32)
  int groups;     // ceil(k / s)
  int group_k;    // K of a full group: s C
  __device__ __forceinline__ void at(int kt, int& a_col, int& a_row, int& w_col) const {
    const int q = min(kt / per_group, groups - 1);
    a_col = (kt - q * per_group) * kBK;
    a_row = q;
    w_col = q * group_k + a_col;
  }
};

__global__ void __launch_bounds__(mts::wg::kThreads, 1)
conv_tf32x3_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_big,
                   const __grid_constant__ CUtensorMap map_small,
                   const float* __restrict__ bias, float* __restrict__ y, int M, int N,
                   ConvSteps steps, int gelu) {
  mts::wg::gemm_tf32x3(map_x, map_big, map_small, bias, y, M, N, gelu, steps);
}

constexpr int kFirstThreads = 128;
constexpr int kFirstFrames = 64;   // frames of a block
constexpr int kFirstMaxTaps = 16;

__global__ void __launch_bounds__(kFirstThreads)
first_conv_kernel(const float* __restrict__ audio, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ y, int S, int C, int k,
                  int s, int frames) {
  extern __shared__ float samples[];  // s (kFirstFrames - 1) + k
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFirstFrames;
  const int n = s * (kFirstFrames - 1) + k;
  const long long first = static_cast<long long>(s) * t0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long long p = first + i;
    samples[i] = p < S ? audio[static_cast<long long>(b) * S + p] : 0.f;
  }
  __syncthreads();
  const int count = min(kFirstFrames, frames - t0);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float tap[kFirstMaxTaps];
#pragma unroll
    for (int j = 0; j < kFirstMaxTaps; ++j) tap[j] = j < k ? w[c * k + j] : 0.f;
    const float b0 = bias ? bias[c] : 0.f;
    float* out = y + (static_cast<size_t>(b) * frames + t0) * C + c;
    for (int f = 0; f < count; ++f) {
      const float* x = samples + s * f;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kFirstMaxTaps; ++j)
        if (j < k) acc = fmaf(tap[j], x[j], acc);
      out[static_cast<size_t>(f) * C] = acc + b0;
    }
  }
}

constexpr int kTile = 32;
constexpr int kTileRows = 8;

__global__ void __launch_bounds__(kTile * kTileRows)
channels_last_kernel(const float* __restrict__ x, float* __restrict__ y, int C, int T, int P) {
  __shared__ float tile[kTile][kTile + 1];
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * kTile;
  const float* src = x + static_cast<size_t>(b) * C * T;
#pragma unroll
  for (int i = 0; i < kTile; i += kTileRows) {
    const int c = c0 + threadIdx.y + i;
    const int t = t0 + threadIdx.x;
    tile[threadIdx.y + i][threadIdx.x] =
        c < C && t < T ? src[static_cast<size_t>(c) * T + t] : 0.f;
  }
  __syncthreads();
  float* dst = y + static_cast<size_t>(b) * P * C;
#pragma unroll
  for (int i = 0; i < kTile; i += kTileRows) {
    const int t = t0 + threadIdx.y + i;
    const int c = c0 + threadIdx.x;
    if (t < P && c < C) dst[static_cast<size_t>(t) * C + c] = tile[threadIdx.x][threadIdx.y + i];
  }
}

constexpr int kNormWarps = 8;  // rows of a block, one a warp

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// one warp a row of C floats (C a multiple of 4): the mean, then the squared
// deviations, then the output, each pass over the row (the later two from L1)
__global__ void __launch_bounds__(32 * kNormWarps)
layer_norm_gelu_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ b, float* __restrict__ y, long long rows, int C,
                       float eps) {
  const long long row = static_cast<long long>(blockIdx.x) * kNormWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int n4 = C / 4;
  const float4* xr = reinterpret_cast<const float4*>(x + row * C);
  float s = 0.f;
  for (int i = lane; i < n4; i += 32) {
    const float4 v = xr[i];
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mean = warp_sum(s) / C;
  float q = 0.f;
  for (int i = lane; i < n4; i += 32) {
    const float4 v = xr[i];
    const float a = v.x - mean, c = v.y - mean, d = v.z - mean, e = v.w - mean;
    q += (a * a + c * c) + (d * d + e * e);
  }
  const float rstd = rsqrtf(warp_sum(q) / C + eps);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float4* yr = reinterpret_cast<float4*>(y + row * C);
  for (int i = lane; i < n4; i += 32) {
    const float4 v = xr[i], g = w4[i], h = b4[i];
    yr[i] = make_float4(mts::wg::epilogue((v.x - mean) * rstd * g.x + h.x, true),
                        mts::wg::epilogue((v.y - mean) * rstd * g.y + h.y, true),
                        mts::wg::epilogue((v.z - mean) * rstd * g.z + h.z, true),
                        mts::wg::epilogue((v.w - mean) * rstd * g.w + h.w, true));
  }
}

}  // namespace

// y [rows, c_out] = the strided conv of x, channels-last: x holds rows * s
// frames of c_in floats ([B, s P, c_in] with rows = B P), output frame r is
// sum_j W_j x[s r + j] + bias, then the exact GELU if `gelu`. The weights are
// given as their split (w_big, w_small: [c_out, k c_in] each, (tap, channel)
// order); bias may be null. All float32, row-major, 16-byte aligned, c_in a
// multiple of 4. Launches on `stream`; returns the cudaError_t of the launch
// (0 = success).
extern "C" int mts_conv_tf32x3_f32(const float* x, const float* w_big, const float* w_small,
                                   const float* bias, float* y, int rows, int c_in, int c_out,
                                   int k, int s, int gelu, void* stream) {
  if (c_in <= 0 || c_in % 4 != 0 || k <= 0 || s <= 0 || static_cast<long long>(k) * c_in > 0x7fffffffLL ||
      static_cast<long long>(s) * c_in > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvSteps steps;
  steps.groups = (k + s - 1) / s;
  steps.group_k = s * c_in;
  steps.per_group = (steps.group_k + kBK - 1) / kBK;
  const int last = (k - (steps.groups - 1) * s) * c_in;
  steps.count = (steps.groups - 1) * steps.per_group + (last + kBK - 1) / kBK;
  return mts::wg::launch(conv_tf32x3_kernel, x, s * c_in, w_big, w_small, rows, c_out, k * c_in,
                         stream, bias, y, rows, c_out, steps, gelu);
}

// y [B, frames, C] = conv layer 0 over audio [B, S] (one input channel),
// channels-last: y[b, t, c] = sum_j w[c, j] audio[b, s t + j] + bias[c];
// samples at or past S read as zero. w [C, k], k <= 16; bias may be null.
// float32. Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int mts_first_conv_f32(const float* audio, const float* w, const float* bias, float* y,
                                  int B, int S, int C, int k, int s, int frames, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || k <= 0 || k > kFirstMaxTaps || s <= 0 || frames <= 0 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((frames + kFirstFrames - 1) / kFirstFrames, B);
  const size_t smem = sizeof(float) * (s * (kFirstFrames - 1) + k);
  first_conv_kernel<<<grid, kFirstThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      audio, w, bias, y, S, C, k, s, frames);
  return static_cast<int>(cudaGetLastError());
}

// y [B, P, C] = x [B, C, T] transposed, frames T .. P - 1 zero (P >= T).
// float32. Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int mts_channels_last_f32(const float* x, float* y, int B, int C, int T, int P,
                                     void* stream) {
  if (B <= 0 || C <= 0 || T < 0 || P < T || P <= 0 || B > 65535 || (C + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((P + kTile - 1) / kTile, (C + kTile - 1) / kTile, B);
  channels_last_kernel<<<grid, dim3(kTile, kTileRows), 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, C, T, P);
  return static_cast<int>(cudaGetLastError());
}

// y [rows, C] = the exact GELU of the LayerNorm of each row of x [rows, C]
// (biased variance, `eps`, affine w, b [C]). float32, 16-byte aligned, C a
// multiple of 4. Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int mts_layer_norm_gelu_f32(const float* x, const float* w, const float* b, float* y,
                                       long long rows, int C, float eps, void* stream) {
  const uintptr_t addresses = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                              reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(y);
  const long long blocks = (rows + kNormWarps - 1) / kNormWarps;
  if (rows <= 0 || C <= 0 || C % 4 != 0 || addresses % 16 != 0 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  layer_norm_gelu_kernel<<<static_cast<unsigned>(blocks), 32 * kNormWarps, 0,
                           static_cast<cudaStream_t>(stream)>>>(x, w, b, y, rows, C, eps);
  return static_cast<int>(cudaGetLastError());
}
