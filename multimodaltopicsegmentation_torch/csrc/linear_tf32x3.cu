// Dense layer y = x W^T + b, optionally followed by the exact GELU, in float32
// on Hopper's tensor cores (3xTF32, `wgmma`).
//
// Replaces no TPU kernel: the JAX package leaves its dense layers to XLA
// (jnp.dot). Added for the port's wav2vec2 and WavLM encoders
// (encoders/wav2vec2.py): their feature projection, Q/K/V, out_proj and FFN
// linears were cuBLAS float32 GEMMs on the CUDA cores (TF32 is off, since the
// configurations state float32), at 43-51 TFLOP/s, most of the encoder's
// device time.
//
// Bound: operations. 2 M N K float32 operations are 3 * 2 M N K TF32 ones, a
// floor of 2 M N K / 165 TFLOP/s (495 TFLOP/s dense TF32, data sheet, 700 W);
// at the encoder's shapes (M = 12,544 rows, K >= 512) the bytes are far below
// (x, both weight parts and y once: under 0.1 of the time at 3.35 TB/s).
//
// Design: the 3xTF32 `wgmma` GEMM of csrc/wgmma_tf32x3.cuh (persistent
// [128, 128] tiles, a TMA producer warpgroup, two consumer warpgroups with A
// split in registers, a float32 sum every 64 of K), with A read at the
// tile's own rows, 32 columns a step. One tile shape serves every (M, N, K):
// at the encoder's shapes 64-column tiles were never faster on the card. K
// must be a multiple of 4 (TMA's 16-byte row stride; the wrapper pads).

#include "wgmma_tf32x3.cuh"

namespace {

__global__ void __launch_bounds__(mts::wg::kThreads, 1)
linear_tf32x3_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_big,
                     const __grid_constant__ CUtensorMap map_small,
                     const float* __restrict__ bias, float* __restrict__ y, int M, int N, int K,
                     int gelu) {
  mts::wg::gemm_tf32x3(map_x, map_big, map_small, bias, y, M, N, gelu,
                       mts::wg::DenseSteps{(K + mts::wg::kBK - 1) / mts::wg::kBK});
}

}  // namespace

// y [M, N] = x [M, K] w^T + bias, then the exact GELU if `gelu`; w given as
// its split (w_big, w_small: [N, K] each, big + small == w); bias may be null.
// All float32, row-major, 16-byte aligned, K a multiple of 4. One block per
// SM (fewer if there are fewer tiles). Launches on `stream`; returns the
// cudaError_t of the launch (0 = success).
extern "C" int mts_linear_tf32x3_f32(const float* x, const float* w_big, const float* w_small,
                                     const float* bias, float* y, int M, int N, int K, int gelu,
                                     void* stream) {
  return mts::wg::launch(linear_tf32x3_kernel, x, K, w_big, w_small, M, N, K, stream, bias, y, M,
                         N, K, gelu);
}
