// Building blocks of the banded attention kernels K2, K6 and K3 on Hopper:
// float32 products on the tensor cores in three TF32 passes ("3xTF32"), and
// asynchronous copies from device memory into shared memory.
//
// 3xTF32. Each float32 operand x is split into big = tf32(x), rounded to
// nearest with ties away from zero (the rounding of cvt.rna.tf32.f32, done on
// the bits), and small = x - big, exact in float32, which the tensor core
// reads truncated to TF32. A product a*b is then a_small*b_big +
// a_big*b_small + a_big*b_big, accumulated in float32 by `mma.sync.m16n8k8`
// (the small*small term, below float32's precision, is left out). This is
// CUTLASS's "fast F32" (OpMultiplyAddFastF32); its error is close to a
// float32 product's, where a single TF32 pass keeps some three decimal
// digits. Its floor on an H100 is 3 * operations / 495 TFLOP/s (the dense
// TF32 peak of the data sheet, which `mma.sync` does not reach).
//
// Fragments of m16n8k8 (tf32), lane = 4 * g + t:
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   B (8 x 8, k x n):      b0 (k = t, n = g), b1 (k = t + 4, n = g);
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// Products X Y^T whose reduction runs along the rows of both shared tiles
// (Q K^T, K Q^T, V dO^T) load A and B with `ldmatrix`: an 8 x 8 matrix of
// 16-bit words is an 8 x 4 block of floats, and lane (g, t) receives the
// float at (g, t) of each block, the fragment layout above; four blocks per
// instruction, conflict-free at a row stride of 4 (mod 32) floats.
// A product of C-layout values (P or dS) with a tile whose reduction runs
// down its rows (P V, P^T dO, dS^T Q) takes the C fragment as its A fragment
// as it is, with the reduction index permuted: A slot k = t holds column 2t
// and slot k = t + 4 column 2t + 1, so B slot k = t reads row 2t and k = t + 4
// row 2t + 1 (two scalar loads, conflict-free at the same stride). No
// shuffle is needed.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mts {

constexpr int kTS = 64 + 4;      // row stride of a staged [64, 64] bias or 0/1 tile

// cvt.rna.tf32.f32 on the bits, for finite x: half a TF32 ulp added to the
// magnitude, the low 13 bits cleared (ties away from zero). Two integer
// operations at the full integer rate, where the cvt instruction runs at the
// rate of conversions.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// ---- PTX ------------------------------------------------------------------

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 4 float blocks of shared memory: lane l gives the address of row
// l % 8 of block l / 8 (16-byte aligned) and gets the float at (g, t) of block
// i in r[i].
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 16 bytes from device memory into shared memory, asynchronously; with
// `valid` false the 16 bytes are zero-filled and nothing is read (src-size 0)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4 bytes, likewise
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most `n` of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// ---- 3xTF32 fragments -----------------------------------------------------

struct FragA {
  uint32_t big[4], small[4];
};

struct FragB {
  uint32_t big[2], small[2];
};

// x = big + small exactly; the tensor core reads small's top 19 bits (round
// toward zero), as CUTLASS's fast F32 leaves it
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// A fragment of rows r .. r + 15 of a shared tile, columns c .. c + 7
__device__ __forceinline__ void load_a(FragA& f, const float* tile, int stride, int r, int c,
                                       int lane) {
  const int blk = lane >> 3;
  uint32_t x[4];
  ldsm4(x, tile + (r + (lane & 7) + 8 * (blk & 1)) * stride + c + 4 * (blk >> 1));
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(x[i]), f.big[i], f.small[i]);
}

// B fragments of the n-tiles n = n0 and n0 + 8 of X Y^T, B_n[k][m] = tile[n + m][c + k]
__device__ __forceinline__ void load_b2(FragB (&f)[2], const float* tile, int stride, int n0,
                                        int c, int lane) {
  const int blk = lane >> 3;
  uint32_t x[4];
  ldsm4(x, tile + (n0 + (lane & 7) + 8 * (blk >> 1)) * stride + c + 4 * (blk & 1));
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split(__uint_as_float(x[i]), f[i >> 1].big[i & 1], f[i >> 1].small[i & 1]);
}

// B fragment with the permuted reduction index: B[t][n] = tile[k0 + 2t][c0 + n],
// B[t + 4][n] = tile[k0 + 2t + 1][c0 + n]
__device__ __forceinline__ void load_b_perm(FragB& f, const float* tile, int stride, int k0,
                                            int c0, int g, int t) {
  const float* p = tile + (k0 + 2 * t) * stride + c0 + g;
  split(p[0], f.big[0], f.small[0]);
  split(p[stride], f.big[1], f.small[1]);
}

// A fragment from C-layout values c = (row g, col 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1), with the permuted reduction index of load_b_perm
__device__ __forceinline__ void a_from_c(FragA& f, const float (&c)[4]) {
  split(c[0], f.big[0], f.small[0]);
  split(c[2], f.big[1], f.small[1]);
  split(c[1], f.big[2], f.small[2]);
  split(c[3], f.big[3], f.small[3]);
}

// The products below run each pass over several accumulators in turn, so that
// an mma never waits on the one before it.

// c[n] += A * B_n over 8 columns col .. col + 7 of the reduction of X Y^T, for
// the eight n-tiles of a 64-row tile, B_n[k][j] = tile[8n + j][col + k], four
// n-tiles at a time. Every n-tile is computed, those outside a warp's band
// too (the masks zero them later): straight-line code runs faster than
// skipping them by branches.
__device__ __forceinline__ void mma3_xyt(float (&c)[8][4], const FragA& a, const float* tile,
                                         int stride, int col, int lane) {
#pragma unroll
  for (int n0 = 0; n0 < 8; n0 += 4) {
    FragB b[2][2];
    load_b2(b[0], tile, stride, 8 * n0, col, lane);
    load_b2(b[1], tile, stride, 8 * n0 + 16, col, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(c[n0 + j], a.small, b[j >> 1][j & 1].big);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(c[n0 + j], a.big, b[j >> 1][j & 1].small);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(c[n0 + j], a.big, b[j >> 1][j & 1].big);
  }
}

// c[j] += A * B_j for the NC column tiles j of a [*, 8 * NC] tile, with the
// permuted reduction over its rows k0 .. k0 + 7 (load_b_perm): 8 rows of the
// reduction of P V. G column tiles at a time.
template <int G, int NC>
__device__ __forceinline__ void mma3_pv(float (&c)[NC][4], const FragA& a, const float* tile,
                                        int stride, int k0, int g, int t) {
  static_assert(NC % G == 0, "G must divide NC");
#pragma unroll
  for (int j0 = 0; j0 < NC; j0 += G) {
    FragB b[G];
#pragma unroll
    for (int j = 0; j < G; ++j) load_b_perm(b[j], tile, stride, k0, 8 * (j0 + j), g, t);
#pragma unroll
    for (int j = 0; j < G; ++j) mma_tf32(c[j0 + j], a.small, b[j].big);
#pragma unroll
    for (int j = 0; j < G; ++j) mma_tf32(c[j0 + j], a.big, b[j].small);
#pragma unroll
    for (int j = 0; j < G; ++j) mma_tf32(c[j0 + j], a.big, b[j].big);
  }
}

// ---- staging --------------------------------------------------------------

// Row stride of a shared [64, Dh] tile: Dh rounded up to 32, plus 4.
__host__ __device__ __forceinline__ int tile_stride(int Dh) { return ((Dh + 31) & ~31) + 4; }

// Rows [row0, row0 + ROWS) of a [*, Dh] matrix into a shared tile,
// asynchronously, NC 8-column chunks per row (Dh <= 8 * NC; the chunk count is
// a constant, so the loop divides by no runtime value); rows at or past
// `row_end` are zero-filled (0 * garbage must not make a NaN). Columns
// [Dh, stride) are left as they are.
template <int kThreads, int ROWS, int NC>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const float* src, int row0,
                                           int row_end, int Dh, int tid) {
  constexpr int C4 = 2 * NC;  // 4-column chunks per row
#pragma unroll 4
  for (int idx = tid; idx < ROWS * C4; idx += kThreads) {
    const int r = idx / C4;
    const int c4 = idx - r * C4;
    if (4 * c4 >= Dh) continue;
    const bool in = row0 + r < row_end;
    cp_async16(dst + r * stride + 4 * c4,
               in ? src + static_cast<size_t>(row0 + r) * Dh + 4 * c4 : src, in);
  }
}

// Zero the columns [Dh, 8 * NC) of `rows` rows of shared tiles: the products
// run over 8 * NC columns of the head dim.
template <int kThreads, int NC>
__device__ __forceinline__ void zero_pad_columns(float* tiles, int rows, int stride, int Dh,
                                                 int tid) {
  const int pad4 = 2 * NC - (Dh >> 2);  // 4-column chunks to zero per row
  for (int idx = tid; idx < rows * pad4; idx += kThreads) {
    const int r = idx / pad4;
    *reinterpret_cast<float4*>(tiles + r * stride + Dh + 4 * (idx - r * pad4)) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Entries of a bias or 0/1 tile for query rows [q0, q0 + ROWS) into a shared
// [ROWS, kTS] tile, asynchronously. `tile` holds [rows, 3*block] floats; query
// i reads row i mod block (`by_residue`, the bias tile of one head) or row i
// (the 0/1 tile of one batch row and head). Row i's 64 columns start at
// key0 - block*(i div block) + block, the geometry column of key key0, or at
// key0 itself (`geometry_cols`). Rows at or past L and columns outside
// [0, 3*block) read as zeros. key0 and block are multiples of 8, so every
// 4-column chunk is 16-byte aligned and wholly inside or outside the tile.
template <int kThreads, int ROWS>
__device__ __forceinline__ void stage_tile(float* dst, const float* tile, bool by_residue,
                                           int q0, int key0, bool geometry_cols, int L,
                                           int block, int tid) {
  const int three = 3 * block;
  for (int idx = tid; idx < ROWS * 16; idx += kThreads) {
    const int r = idx >> 4;
    const int c4 = idx & 15;
    const int qpos = q0 + r;
    const int jq = qpos / block;
    const int col = (geometry_cols ? key0 : key0 - jq * block + block) + 4 * c4;
    const bool in = qpos < L && col >= 0 && col + 4 <= three;
    const int row = by_residue ? qpos - jq * block : qpos;
    cp_async16(dst + r * kTS + 4 * c4,
               in ? tile + static_cast<size_t>(row) * three + col : tile, in);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace mts
