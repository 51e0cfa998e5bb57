// Banded (sliding-window) attention forward for the long-document taggers:
// kernels K2 and K6 of the port.
//
// Replaces two TPU kernels of multimodaltopicsegmentation_tpu/ops/pallas_attention.py:
//   K2  `_flash_fwd_impl` (kernel body `_flash_fwd_kernel`): O and the per-row
//       logsumexp, optional 1/sqrt(Dh) scale, optional additive bias tile,
//       optional post-softmax 0/1 tile scaled by 1/keep;
//   K6  `pallas_local_attention` (kernel body `_kernel`): the same band and
//       prefix masks, always scaled, O only.
// Both compute, for q, k, v [B, H, L, Dh] float32 and a prefix length per
// batch row, softmax over the keys p with |p - i| <= half and 0 <= p < length.
//
// What the function is on rows that see no valid key. The TPU kernels work on
// [block, 3*block] score tiles (block = half rounded up to 8, the previous,
// own and next key block, edge blocks clamped) and SET masked scores to -1e9.
// A query row with no valid key (i >= length + half, or length 0) so gets
// equal weights over all 3*block columns: its O is the mean of V over its
// three clamped blocks (rows past L count as zeros) and its lse is
// -1e9 + log(3*block). The models add (1 - mask) * -1e9 downstream, so these
// rows must be finite and the same in every implementation. This file
// reproduces them in a separate phase; the bias tile and the 0/1 tile are
// indexed by position in that geometry, tile[i mod block][p - block*(i div
// block) + block], whatever the tiling used here.
//
// Bound. At the main-path shape [8, 8, 3600, 96], window 240, ragged lengths
// 3600, 0, 3100, 2500, 2048, 1500, 900, 400: QK^T and PV are 4*Dh
// operations per (query, valid key) pair, 10.3 GFLOP, 0.153 ms at the H100's
// 67 TFLOP/s float32 rate; the 3xTF32 route below does three TF32 products
// per float32 one, 0.062 ms at 495 TFLOP/s; the bytes these lengths need (q
// of the rows below length + half, k and v below the length, the V rows that
// rows without a key average, O and lse of every row: 266 MB) take 0.080 ms at
// 3.35 TB/s. Operations bound it in float32, bytes on the tensor cores.
//
// Design (for Hopper's tensor cores). A block of 4 warps owns 64 consecutive
// query rows, each warp 16 of them, and walks the 64-key tiles (aligned to
// 64) that meet the band of its rows below the length:
// - S = Q K^T in m16n8k8 3xTF32 fragments held in registers (tf32x3.cuh; Q
//   and K fragments by ldmatrix); scale, bias, masks and the online softmax
//   act on the fragments; then O += P V in the same instruction, P passing
//   from the C to the A layout in registers. Nothing score-shaped leaves the
//   registers. Every 8-key group of a tile is computed, in the band or not:
//   a branch per group costs more than the products it would skip. A
//   sub-tile whose pairs all lie inside the band and below the length skips
//   the per-pair mask; a warp whose rows see no key of the tile skips it.
// - Q, K and V tiles (and the bias and 0/1 entries of the tile's 64 x 64
//   pairs, staged by rows with 16-byte copies) arrive by cp.async. K of tile
//   t + 1 is loaded while the block runs the softmax and P V of tile t, and
//   V of tile t + 1 while it runs Q K^T of tile t + 1: one K and one V buffer
//   give a two-stage pipeline. 76.8 KB of shared memory at Dh 96 and at most
//   168 registers: three blocks per SM (two blocks of 128 rows, one more
//   m-tile per warp, ran out of registers and ran slower).
// - Rows that see no key: without a 0/1 tile and with equal scores (no bias,
//   or a bias below 32 in magnitude, which float32 drops next to -1e9) O is
//   the column sum of V over the three clamped blocks times 1/(3*block), one
//   sum per geometry block; where every row of kGroup tiles sees no key and
//   there is neither tile, the first of them writes all their rows, so that
//   V is summed once per group. Other rows (a 0/1 tile, a large bias) are a
//   tile product: W [rows, 3*block] times V [3*block, Dh], 64 columns at a
//   time, V and the bias / 0/1 entries staged by cp.async, W =
//   softmax(-1e9 + bias) times tile/keep built in registers as A fragments.
// The products run over Dh rounded up to 32 (zero columns in shared memory);
// four instantiations cover Dh up to 32, 64, 96 and 128. Times against both
// floors are in PERF.md; the tensor cores are far from busy: the two
// products, the softmax and the waits on tile copies and barriers each take
// a comparable share of the time.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

namespace {

using mts::FragA;
using mts::kTS;

constexpr int kBK = 64;        // keys per tile
constexpr int kBQ = 64;        // query rows per block
constexpr int kWarps = 4;      // each owns 16 of them
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e9f;
constexpr int kPvGroup = 4;  // column tiles per pass of the P V-type products
constexpr int kGroup = 4;    // tiles of rows without a key that one block writes
constexpr int kMaxDh = 128;

// Rows that see no key take two shortcuts where their weights are equal: the
// column sums of V per geometry block, and whole tiles written kGroup to a
// block. Built with -DMTS_NO_KEY_SHORTCUTS=0, the tile product does every
// such row; `python3 chip_smoke.py --no-key-rows` times the two builds.
#ifndef MTS_NO_KEY_SHORTCUTS
#define MTS_NO_KEY_SHORTCUTS 1
#endif
constexpr bool kShortcuts = MTS_NO_KEY_SHORTCUTS != 0;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* lengths;  // [B]
  const float* bias;   // [H, block, 3*block] or null
  const float* drop;   // [B*H, nb*block, 3*block] or null
  float* out;          // [B, H, L, Dh]
  float* lse;          // [B, H, L] or null
  int H, L, Dh, half, block, nb, tiles;
  float scale, keep;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

size_t smem_bytes(const Params& p) {
  const int DS = mts::tile_stride(p.Dh);
  return (static_cast<size_t>(kBQ + 2 * kBK) * DS + (p.bias != nullptr ? kBQ * kTS : 0) +
          (p.drop != nullptr ? kBQ * kTS : 0)) * sizeof(float);
}

// Column sums of V [L, Dh] over each geometry block b_first .. b_last into
// bsum[(b - b_first) * Dh + col]: float4 columns, rows split over `groups`
// thread groups, then the groups' partials (in `part`) in a fixed order;
// rows past L count as zeros. The rows of one block are summed in the same
// order whichever thread block does it.
__device__ void block_sums(float* bsum, float* part, const float* vb, int b_first, int b_last,
                           int block, int L, int Dh, int tid) {
  const int c4n = Dh >> 2;
  const int groups = kThreads / c4n;
  const int rg = tid / c4n;
  const int c4 = tid - rg * c4n;
  for (int bb = b_first; bb <= b_last; ++bb) {
    if (rg < groups) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      const int end = min((bb + 1) * block, L);
      const float* col = vb + 4 * c4;
#pragma unroll 8
      for (int pos = bb * block + rg; pos < end; pos += groups) {
        const float4 x = *reinterpret_cast<const float4*>(col + static_cast<size_t>(pos) * Dh);
        acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
      }
      *reinterpret_cast<float4*>(part + rg * Dh + 4 * c4) = acc;
    }
    __syncthreads();
    if (tid < Dh) {
      float sum = 0.f;
      for (int r = 0; r < groups; ++r) sum += part[r * Dh + tid];
      bsum[(bb - b_first) * Dh + tid] = sum;
    }
    __syncthreads();
  }
}

// NC: 8-column chunks of the head dim the products run over (4, 8, 12 or 16;
// the columns past Dh are zeros in shared memory). At NC 16 shared memory
// holds two blocks per SM, so asking for three would only force spills.
template <int NC>
__global__ void __launch_bounds__(kThreads, NC <= 12 ? 3 : 2)
flash_local_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int Dh = p.Dh;
  const int DS = mts::tile_stride(Dh);
  float* Qs = smem;
  float* Ks = Qs + kBQ * DS;
  float* Vs = Ks + kBK * DS;
  float* Bs = Vs + kBK * DS;                             // bias entries [64][kTS]
  float* Ms = Bs + (p.bias != nullptr ? kBQ * kTS : 0);  // 0/1 entries [64][kTS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x / p.tiles;
  const int q0 = (blockIdx.x - bh * p.tiles) * kBQ;
  const int h = bh % p.H;
  const int L = p.L;
  const int half = p.half;
  const int block = p.block;
  const int three = 3 * block;
  const int length = min(max(p.lengths[bh / p.H], 0), L);
  const int qend = min(q0 + kBQ, L);
  const int wr = 16 * warp;  // this warp's first row in the tile
  const int r0 = q0 + wr;

  const size_t base = static_cast<size_t>(bh) * L * Dh;
  const float* qb = p.q + base;
  const float* kb = p.k + base;
  const float* vb = p.v + base;
  float* ob = p.out + base;
  const float* bias_h = p.bias != nullptr ? p.bias + static_cast<size_t>(h) * block * three : nullptr;
  const float* drop_bh =
      p.drop != nullptr ? p.drop + static_cast<size_t>(bh) * p.nb * block * three : nullptr;

  // Tiles whose rows all see no key, without bias or 0/1 tile: every row of
  // geometry block j gets the mean of V over its three clamped blocks. The
  // first tile of each group of kGroup such tiles writes the rows of all of
  // them, so that a block of V is summed once per group instead of once per
  // tile; the others return at once.
  const int tile = blockIdx.x - bh * p.tiles;
  const int group0 = (tile - tile % kGroup) * kBQ;  // first row of this tile's group
  if (kShortcuts && bias_h == nullptr && drop_bh == nullptr &&
      group0 >= (length == 0 ? 0 : length + half)) {
    if (tile % kGroup != 0) return;
    const int gend = min(q0 + kGroup * kBQ, L);
    const int b_first = max(q0 / block - 1, 0);
    float* bsum = Qs;  // [b_last - b_first + 1][Dh]
    block_sums(bsum, Ks, vb, b_first, min((gend - 1) / block + 1, p.nb - 1), block, L, Dh, tid);
    const float three_f = static_cast<float>(three);
    const float w = 1.f / three_f;
    for (int row = q0 + warp; row < gend; row += kWarps) {
      const int j = row / block;
      const float* s0 = bsum + (max(j - 1, 0) - b_first) * Dh;
      const float* s1 = bsum + (j - b_first) * Dh;
      const float* s2 = bsum + (min(j + 1, p.nb - 1) - b_first) * Dh;
      float* orow = ob + static_cast<size_t>(row) * Dh;
      for (int col = 2 * lane; col < Dh; col += 64)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(w * (s0[col] + s1[col] + s2[col]),
                        w * (s0[col + 1] + s1[col + 1] + s2[col + 1]));
      if (p.lse != nullptr && lane == 0)
        p.lse[static_cast<size_t>(bh) * L + row] = kNegInf + logf(three_f);
    }
    return;
  }

  // keys any row of this tile can see, the first tile aligned to 64
  const int klo = max(0, q0 - half);
  const int khi = min(qend - 1 + half, length - 1);
  const int kfirst = klo & ~(kBK - 1);

  mts::zero_pad_columns<kThreads, NC>(smem, kBQ + 2 * kBK, DS, Dh, tid);

  float o[NC][4];  // O: n-tile c holds rows g, g + 8 and columns 8c + 2t, 8c + 2t + 1
  float m[2], l[2];
  // the keys row g + 8i sees: [klo_i, khi_i] (empty for a row at or past L)
  int klo_i[2], khi_i[2];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    const int qpos = r0 + g + 8 * i;
    klo_i[i] = qpos < L ? qpos - half : L;
    khi_i[i] = min(qpos + half, khi);
  }

  if (klo <= khi) {
    mts::stage_rows<kThreads, kBQ, NC>(Qs, DS, qb, q0, qend, Dh, tid);
    mts::stage_rows<kThreads, kBK, NC>(Ks, DS, kb, kfirst, khi + 1, Dh, tid);
    mts::cp_async_commit();
    mts::stage_rows<kThreads, kBK, NC>(Vs, DS, vb, kfirst, khi + 1, Dh, tid);
    if (bias_h != nullptr)
      mts::stage_tile<kThreads, kBQ>(Bs, bias_h, true, q0, kfirst, false, L, block, tid);
    if (drop_bh != nullptr)
      mts::stage_tile<kThreads, kBQ>(Ms, drop_bh, false, q0, kfirst, false, L, block, tid);
    mts::cp_async_commit();
  }

  for (int k0 = kfirst; k0 <= khi; k0 += kBK) {
    const bool next = k0 + kBK <= khi;
    // does any row of this warp see a key of the tile?
    const bool active = r0 < qend && k0 <= r0 + 15 + half && k0 + kBK - 1 >= r0 - half;
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;

    mts::cp_async_wait<1>();  // Q and K of this tile
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kc = 0; kc < NC; ++kc) {
        FragA a;
        mts::load_a(a, Qs, DS, wr, 8 * kc, lane);
        mts::mma3_xyt(s, a, Ks, DS, 8 * kc, lane);
      }
    }
    __syncthreads();  // every warp is done with K
    if (next) mts::stage_rows<kThreads, kBK, NC>(Ks, DS, kb, k0 + kBK, khi + 1, Dh, tid);
    mts::cp_async_commit();
    mts::cp_async_wait<1>();  // V and the bias / 0/1 entries of this tile
    __syncthreads();

    if (active) {
      // all pairs of the warp's 16 x 64 sub-tile inside the band and below the length
      const bool full = r0 + 15 < L && k0 + kBK - 1 <= khi && k0 + kBK - 1 - r0 <= half &&
                        r0 + 15 - k0 <= half;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int lr = wr + g + 8 * i;
        float tmax = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * n + 2 * t + e;
            const int kpos = k0 + col;
            const bool ok = full || (kpos >= klo_i[i] && kpos <= khi_i[i]);
            float sv = p.scale * s[n][2 * i + e];
            if (bias_h != nullptr) sv += Bs[lr * kTS + col];
            sv = ok ? sv : -INFINITY;
            s[n][2 * i + e] = sv;
            tmax = fmaxf(tmax, sv);
          }
        tmax = mts::quad_max(tmax);
        const float m_new = fmaxf(m[i], tmax);
        // a row that has seen no key yet subtracts 0: exp(-inf) is then 0, not NaN
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = __expf(m[i] - m_use);
        float rsum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float pv = __expf(s[n][2 * i + e] - m_use);
            rsum += pv;  // the row sum stays undropped
            if (drop_bh != nullptr) pv *= Ms[lr * kTS + 8 * n + 2 * t + e];
            s[n][2 * i + e] = pv;
          }
        rsum = mts::quad_sum(rsum);
        l[i] = l[i] * alpha + rsum;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          o[c][2 * i] *= alpha;
          o[c][2 * i + 1] *= alpha;
        }
      }
      // O += P V over the tile's 64 keys, 8 at a time
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        FragA a;
        mts::a_from_c(a, s[kk]);
        mts::mma3_pv<kPvGroup, NC>(o, a, Vs, DS, 8 * kk, g, t);
      }
    }
    __syncthreads();  // every warp is done with V and the staged entries
    if (next) {
      mts::stage_rows<kThreads, kBK, NC>(Vs, DS, vb, k0 + kBK, khi + 1, Dh, tid);
      if (bias_h != nullptr)
        mts::stage_tile<kThreads, kBQ>(Bs, bias_h, true, q0, k0 + kBK, false, L, block, tid);
      if (drop_bh != nullptr)
        mts::stage_tile<kThreads, kBQ>(Ms, drop_bh, false, q0, k0 + kBK, false, L, block, tid);
    }
    mts::cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = r0 + g + 8 * i;
    if (qpos < L && l[i] > 0.f) {
      const float lsum = fmaxf(l[i], 1e-20f);
      float inv = 1.f / lsum;
      if (drop_bh != nullptr) inv /= p.keep;
      float* orow = ob + static_cast<size_t>(qpos) * Dh;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = 8 * c + 2 * t;
        if (col < Dh)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(o[c][2 * i] * inv, o[c][2 * i + 1] * inv);
      }
      if (p.lse != nullptr && t == 0) p.lse[static_cast<size_t>(bh) * L + qpos] = m[i] + logf(lsum);
    }
  }

  // Rows with no valid key: i >= length + half, or length 0. They are the
  // rows the loop above left with l == 0. Every score of such a row is -1e9
  // (+ bias, which float32 drops below 32 in magnitude): without a 0/1 tile
  // and with equal scores its O is the mean of V over the three clamped
  // blocks, the same for every row of geometry block j; other rows weigh the
  // 3*block columns by softmax(-1e9 + bias) * tile / keep, a tile product.
  const int u0 = max(length == 0 ? 0 : length + half, q0);
  if (u0 >= qend) return;
  mts::cp_async_wait<0>();
  __syncthreads();
  // the Q and K tiles are free now
  float* mx_s = Ks;                // per row: max of -1e9 + bias over the 3*block columns
  float* ls_s = Ks + kBQ;          // the sum of exp(-1e9 + bias - max)
  float* even_s = Ks + 2 * kBQ;    // 1 where every weight of the row is 1/(3*block)
  float* part = Ks + 3 * kBQ;      // partial column sums, [groups][Dh]
  float* bsum = Qs;                // column sums of V per geometry block b_first ..
  const float three_f = static_cast<float>(three);
  const int b_first = max(u0 / block - 1, 0);
  if (kShortcuts && drop_bh == nullptr)
    block_sums(bsum, part, vb, b_first, min((qend - 1) / block + 1, p.nb - 1), block, L, Dh, tid);
  for (int j = u0 / block; j <= (qend - 1) / block; ++j) {
    // the rows of this block that lie in geometry block j and see no key
    const int ra = max(u0, j * block);
    const int rb = min(qend, (j + 1) * block);
    const bool mine = r0 < rb && r0 + 16 > ra;  // does this warp own any of them?
    bool uneven = false;
    if (mine) {
      for (int lr = wr; lr < wr + 16; ++lr) {
        const int qpos = q0 + lr;
        if (qpos < ra || qpos >= rb) continue;
        float mx = kNegInf, mn = kNegInf, ls = three_f;
        if (bias_h != nullptr) {
          const float* brow = bias_h + static_cast<size_t>(qpos - j * block) * three;
          mx = -INFINITY;
          mn = INFINITY;
          for (int c = lane; c < three; c += 32) {
            const float sc = kNegInf + brow[c];
            mx = fmaxf(mx, sc);
            mn = fminf(mn, sc);
          }
          mx = warp_max(mx);
          mn = -warp_max(-mn);
          ls = 0.f;
          for (int c = lane; c < three; c += 32) ls += expf(kNegInf + brow[c] - mx);
          ls = fmaxf(warp_sum(ls), 1e-20f);
        }
        const bool even = kShortcuts && mx == mn && drop_bh == nullptr;
        uneven |= !even;
        if (lane == 0) {
          mx_s[lr] = mx;
          ls_s[lr] = ls;
          even_s[lr] = even ? 1.f : 0.f;
        }
      }
      __syncwarp();
    }
    const bool product = __syncthreads_or(uneven);

#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
    for (int c0 = 0; product && c0 < three; c0 += kBK) {
      __syncthreads();  // the previous chunk's readers are done
      // V rows of geometry columns [c0, c0 + 64): the three clamped blocks
      constexpr int C4 = 2 * NC;
      for (int idx = tid; idx < kBK * C4; idx += kThreads) {
        const int r = idx / C4;
        const int c4 = idx - r * C4;
        if (4 * c4 >= Dh) continue;
        const int c = c0 + r;
        const int slot = c / block;
        const int pos = min(max(j - 1 + slot, 0), p.nb - 1) * block + (c - slot * block);
        const bool in = c < three && pos < L;
        mts::cp_async16(Vs + r * DS + 4 * c4, in ? vb + static_cast<size_t>(pos) * Dh + 4 * c4 : vb,
                        in);
      }
      if (bias_h != nullptr)
        mts::stage_tile<kThreads, kBQ>(Bs, bias_h, true, q0, c0, true, L, block, tid);
      if (drop_bh != nullptr)
        mts::stage_tile<kThreads, kBQ>(Ms, drop_bh, false, q0, c0, true, L, block, tid);
      mts::cp_async_commit();
      mts::cp_async_wait<0>();
      __syncthreads();
      if (!mine) continue;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        float w[4];  // C layout: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int lr = wr + g + 8 * i;
          const int qpos = q0 + lr;
          const bool row_in = qpos >= ra && qpos < rb && even_s[lr] == 0.f;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * kk + 2 * t + e;
            float wv = 0.f;
            if (row_in && c0 + col < three) {
              wv = bias_h != nullptr ? expf(kNegInf + Bs[lr * kTS + col] - mx_s[lr]) / ls_s[lr]
                                     : 1.f / ls_s[lr];
              if (drop_bh != nullptr) wv = wv * Ms[lr * kTS + col] / p.keep;
            }
            w[2 * i + e] = wv;
          }
        }
        FragA a;
        mts::a_from_c(a, w);
        mts::mma3_pv<kPvGroup, NC>(o, a, Vs, DS, 8 * kk, g, t);
      }
    }
    if (mine) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int lr = wr + g + 8 * i;
        const int qpos = q0 + lr;
        if (qpos < ra || qpos >= rb) continue;
        const bool even = even_s[lr] != 0.f;
        const float w = 1.f / ls_s[lr];
        // the three clamped blocks of geometry block j
        const float* s0 = bsum + (max(j - 1, 0) - b_first) * Dh;
        const float* s1 = bsum + (j - b_first) * Dh;
        const float* s2 = bsum + (min(j + 1, p.nb - 1) - b_first) * Dh;
        float* orow = ob + static_cast<size_t>(qpos) * Dh;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = 8 * c + 2 * t;
          if (col < Dh)
            *reinterpret_cast<float2*>(orow + col) =
                even ? make_float2(w * (s0[col] + s1[col] + s2[col]),
                                   w * (s0[col + 1] + s1[col + 1] + s2[col + 1]))
                     : make_float2(o[c][2 * i], o[c][2 * i + 1]);
        }
        if (p.lse != nullptr && t == 0)
          p.lse[static_cast<size_t>(bh) * L + qpos] = mx_s[lr] + logf(ls_s[lr]);
      }
    }
    __syncthreads();  // the row statistics are rewritten for the next block
  }
}

template <int NC>
int launch_nc(const Params& p, unsigned blocks, cudaStream_t s) {
  const size_t bytes = smem_bytes(p);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(flash_local_fwd_kernel<NC>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_local_fwd_kernel<NC><<<blocks, kThreads, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch(Params p, int B, void* stream) {
  if (B <= 0 || p.H <= 0 || p.L <= 0 || p.Dh <= 0 || p.Dh % 4 != 0 || p.Dh > kMaxDh ||
      p.half < 0 || p.block < 8 || p.block % 8 != 0 || p.block < p.half)
    return static_cast<int>(cudaErrorInvalidValue);
  p.nb = (p.L + p.block - 1) / p.block;
  p.tiles = (p.L + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(B) * p.H * p.tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned n = static_cast<unsigned>(blocks);
  switch ((p.Dh + 31) / 32) {
    case 1: return launch_nc<4>(p, n, s);
    case 2: return launch_nc<8>(p, n, s);
    case 3: return launch_nc<12>(p, n, s);
    default: return launch_nc<16>(p, n, s);
  }
}

}  // namespace

// K2. Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// q, k, v, out: [B, H, L, Dh] float32, contiguous, 16-byte aligned, Dh % 4 == 0,
// Dh <= 128. lengths: [B] int32. bias: [H, block, 3*block] or null. drop:
// [B*H, ceil(L/block)*block, 3*block] of 0/1 or null; both 16-byte aligned.
// lse: [B, H, L]. block, a multiple of 8 and >= half, is the geometry the two
// tiles are laid out in.
extern "C" int mts_flash_local_attention_f32(const float* q, const float* k, const float* v,
                                             const int* lengths, const float* bias,
                                             const float* drop, float* out, float* lse,
                                             int B, int H, int L, int Dh, int half, int block,
                                             float scale, float keep, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.lengths = lengths; p.bias = bias; p.drop = drop;
  p.out = out; p.lse = lse;
  p.H = H; p.L = L; p.Dh = Dh; p.half = half; p.block = block; p.nb = 0; p.tiles = 0;
  p.scale = scale; p.keep = keep;
  if (lse == nullptr || keep <= 0.f) return static_cast<int>(cudaErrorInvalidValue);
  return launch(p, B, stream);
}

// K6. The same band and prefix masks, always scaled by 1/sqrt(Dh); O only.
extern "C" int mts_fused_local_attention_f32(const float* q, const float* k, const float* v,
                                             const int* lengths, float* out, int B, int H,
                                             int L, int Dh, int half, int block, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.lengths = lengths; p.bias = nullptr; p.drop = nullptr;
  p.out = out; p.lse = nullptr;
  p.H = H; p.L = L; p.Dh = Dh; p.half = half; p.block = block; p.nb = 0; p.tiles = 0;
  p.scale = Dh > 0 ? 1.f / sqrtf(static_cast<float>(Dh)) : 1.f; p.keep = 1.f;
  return launch(p, B, stream);
}
