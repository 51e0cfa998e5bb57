// The 3xTF32 `wgmma` GEMM body of the dense layer (linear_tf32x3.cu) and of
// the strided convolutions of the feature stack (conv_tf32x3.cu):
// y [M, N] = A [M, K] W^T + bias, then the exact GELU if asked, in float32
// on Hopper's tensor cores. The two kernels differ only in where the
// producer finds the [128, 32] box of A for a step of K (`DenseSteps`,
// `ConvSteps` in conv_tf32x3.cu).
//
// Arithmetic: that of csrc/tf32x3.cuh ("fast F32"), moved from mma.sync to
// wgmma. Each product is a_small*b_big + a_big*b_small + a_big*b_big with
// big = tf32(v) rounded to nearest and small = v - big read truncated by the
// tensor core, accumulated in float32. The weights arrive already split
// (w_big, w_small: ops/linear_tf32x3.split_tf32, once per weight); A is split
// in registers.
//
// Design. A persistent block on each SM walks over [128, 128] tiles of y (n
// fastest). One thread of the producer's warpgroup keeps a ring of 4
// shared-memory stages filled by TMA: per stage the [128, 32] tile of A and
// the [128, 32] tiles of w_big and w_small, rows of 32 floats (128 bytes) in
// the 128-byte swizzle, completion on the stage's "full" mbarrier; it runs
// ahead into the block's next tile while the consumers finish the last. Two
// consumer warpgroups, 64 rows each, read their A fragment for each k8 step
// from shared memory into registers (the swizzle makes the loads
// conflict-free), split it, and issue three `wgmma.m64n128k8.f32.tf32.tf32`
// with A in registers and B (the weight tile, K-major) from shared memory,
// then release the stage on its "empty" mbarrier. While one warpgroup waits,
// the other's products keep the tensor cores busy. The products of kPromote
// = 2 stages (64 of K) go into a fresh accumulator, which is then added to
// the tile's sum in float32: the tensor cores' own sums over all of K lost 2-3
// bits against a float32 GEMM (3.5e-6 against 4e-7 over |x| |w|^T at K =
// 3072, on the card); sums over 64 keep the error at 1-2e-7 at no cost, while
// a float32 sum after every stage cost 5-13 % of the time. The producer's
// warpgroup gives up registers (setmaxnreg) for the consumers' two
// accumulators. The epilogue adds the bias, applies the GELU and stores
// float32 [M, N] row-major from the accumulator layout, rows and columns past
// M and N masked. Boxes that reach past the maps' rows or columns are
// zero-filled by TMA, and a zero weight column cancels whatever A holds
// there.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace mts {
namespace wg {

constexpr int kBM = 128;                     // rows of a tile
constexpr int kBN = 128;                     // columns of a tile
constexpr int kBK = 32;                      // K of a stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kConsumerWarps = 8;            // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;  // and the producer's warpgroup
constexpr int kPromote = 2;                  // stages summed by the tensor cores alone
constexpr int kABytes = kBM * kBK * 4;
constexpr int kBBytes = kBN * kBK * 4;
constexpr int kStageBytes = kABytes + 2 * kBBytes;
// the stages, 1024-byte aligned (the swizzle's period), then the mbarriers
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
constexpr float kSqrtHalf = 0.70710678118654752440f;

// ---- PTX ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spins until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// the box of `map` at (c0 = column, c1 = row) into shared memory at `dst`,
// counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma's descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle: start address, 1024 bytes between 8-row groups, layout type 1.
// A k8 step j of the 32-float rows starts 32 * j bytes in: + 2 * j.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A B + (scale_d ? d : 0) over one k8 step: A [64, 8] in registers (tf32
// bits, the fragment of mts::FragA per warp), B [128, 8] K-major in shared
// memory. Accumulator of warp w, lane 4g + t: d[4j + {0, 1}] at row 16w + g,
// columns 8j + 2t + {0, 1}; d[4j + {2, 3}] at row 16w + g + 8.
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

// ---- the GEMM body ----------------------------------------------------------

__device__ __forceinline__ float epilogue(float v, bool gelu) {
  return gelu ? 0.5f * v * (1.0f + erff(v * kSqrtHalf)) : v;
}

// The steps of K of a dense layer: step kt reads A at column 32 kt of the
// tile's own rows, W at column 32 kt.
struct DenseSteps {
  int count;
  __device__ __forceinline__ void at(int kt, int& a_col, int& a_row, int& w_col) const {
    a_col = w_col = kt * kBK;
    a_row = 0;
  }
};

// The whole kernel body, run by kThreads threads with kSmemBytes of dynamic
// shared memory: step kt of every tile loads the box of `map_a` at (a_col,
// m0 + a_row) and those of the weight maps at (w_col, n0), as `steps.at`
// gives them, for kt < steps.count.
template <class Steps>
__device__ __forceinline__ void gemm_tf32x3(const CUtensorMap& map_a, const CUtensorMap& map_big,
                                            const CUtensorMap& map_small,
                                            const float* __restrict__ bias, float* __restrict__ y,
                                            int M, int N, int gelu, Steps steps) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + kStages * kStageBytes;  // full[s], then empty[s]
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_tiles = (N + kBN - 1) / kBN;
  const int tiles = (M + kBM - 1) / kBM * n_tiles;
  const int k_steps = steps.count;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the ring's position runs on over the block's tiles: step i uses stage
  // i % kStages in round i / kStages
  if (warp >= kConsumerWarps) {  // the producer's warpgroup: one thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == kConsumerWarps && lane == 0) {
      int i = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * kBM;
        const int n0 = tile % n_tiles * kBN;
        for (int kt = 0; kt < k_steps; ++kt, ++i) {
          const int s = i % kStages;
          int a_col, a_row, w_col;
          steps.at(kt, a_col, a_row, w_col);
          mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);  // the first round passes
          const uint32_t dst = base + s * kStageBytes;
          mbar_expect_tx(full(s), kStageBytes);
          tma_load(dst, &map_a, full(s), a_col, m0 + a_row);
          tma_load(dst + kABytes, &map_big, full(s), w_col, n0);
          tma_load(dst + kABytes + kBBytes, &map_small, full(s), w_col, n0);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // consumers: warpgroup wg holds rows 64 wg .. 64 wg + 63 of a tile; this
  // lane's A rows are r and r + 8, which share r & 7, the swizzle's row key
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r = (warp >> 2) * 64 + (warp & 3) * 16 + g;
  const int key = r & 7;
  const bool act = gelu != 0;
  const bool pairs = (N & 1) == 0;  // 8-byte aligned column pairs
  float part[kBN / 2];
#pragma unroll
  for (int v = 0; v < kBN / 2; ++v) part[v] = 0.f;
  int i = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * kBM;
    const int n0 = tile % n_tiles * kBN;
    float acc[kBN / 2];
#pragma unroll
    for (int v = 0; v < kBN / 2; ++v) acc[v] = 0.f;

    for (int kt = 0; kt < k_steps; ++kt, ++i) {
      const int s = i % kStages;
      mbar_wait(full(s), (i / kStages) & 1);
      const float* row0 = reinterpret_cast<const float*>(smem + s * kStageBytes + r * 128);
      const float* row1 = row0 + 8 * 32;
      FragA a[kBK / 8];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        // columns 8j + t and 8j + t + 4: 16-byte chunks 2j and 2j + 1, swizzled
        const int lo = (((2 * j) ^ key) << 2) + t;
        const int hi = (((2 * j + 1) ^ key) << 2) + t;
        split(row0[lo], a[j].big[0], a[j].small[0]);
        split(row1[lo], a[j].big[1], a[j].small[1]);
        split(row0[hi], a[j].big[2], a[j].small[2]);
        split(row1[hi], a[j].big[3], a[j].small[3]);
      }
      const uint32_t b_big = base + s * kStageBytes + kABytes;
      const uint64_t d_big = smem_desc(b_big);
      const uint64_t d_small = smem_desc(b_big + kBBytes);
      const int carry = kt % kPromote != 0;  // 0: a fresh sum
      wgmma_fence();
      fence_regs(part);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        wgmma(part, a[j].small, d_big + 2 * j, j > 0 || carry);
        wgmma(part, a[j].big, d_small + 2 * j, 1);
        wgmma(part, a[j].big, d_big + 2 * j, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
      if (lane == 0) mbar_arrive(empty(s));
      if (kt % kPromote == kPromote - 1 || kt == k_steps - 1) {
#pragma unroll
        for (int v = 0; v < kBN / 2; ++v) acc[v] += part[v];
      }
    }

#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= N) continue;
      const bool two = col + 1 < N;
      const float b0 = bias ? bias[col] : 0.f;
      const float b1 = bias && two ? bias[col + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + r + 8 * h;
        if (row >= M) continue;
        const float v0 = epilogue(acc[4 * j + 2 * h] + b0, act);
        const float v1 = epilogue(acc[4 * j + 2 * h + 1] + b1, act);
        float* out = y + static_cast<size_t>(row) * N + col;
        if (two && pairs) {
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
        } else {
          out[0] = v0;
          if (two) out[1] = v1;
        }
      }
    }
  }
}

// ---- host -----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched through the runtime's entry-point query (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [rows, cols] row-major float32 in boxes of [box_rows, 32] in the 128-byte
// swizzle; cols a multiple of 4 (16-byte row stride)
inline CUresult make_map(EncodeTiled encode, CUtensorMap* map, const float* ptr, int rows,
                         int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elems[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims, strides,
                box, elems, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The maps of A [M, a_cols] and of the weight parts [N, K], then one block
// per SM (fewer if there are fewer tiles) of `kernel` on `stream`, its
// arguments the three maps followed by `args`. -> a cudaError_t (0 = success).
template <class Kernel, class... Args>
int launch(Kernel kernel, const float* a, int a_cols, const float* w_big, const float* w_small,
           int M, int N, int K, void* stream, Args... args) {
  const uintptr_t addresses = reinterpret_cast<uintptr_t>(a) |
                              reinterpret_cast<uintptr_t>(w_big) |
                              reinterpret_cast<uintptr_t>(w_small);
  const long long tiles = (M + kBM - 1LL) / kBM * ((N + kBN - 1LL) / kBN);
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 != 0 || a_cols <= 0 || a_cols % 4 != 0 ||
      tiles > 0x7fffffffLL || addresses % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_a, map_big, map_small;
  if (make_map(encode, &map_a, a, M, a_cols, kBM) != CUDA_SUCCESS ||
      make_map(encode, &map_big, w_big, N, K, kBN) != CUDA_SUCCESS ||
      make_map(encode, &map_small, w_small, N, K, kBN) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(map_a, map_big,
                                                                              map_small, args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
}  // namespace mts
