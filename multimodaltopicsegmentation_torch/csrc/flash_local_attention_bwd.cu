// Banded (sliding-window) attention backward for the long-document taggers:
// kernels K4, K5 and K3 of the port.
//
// Replaces three TPU kernels of multimodaltopicsegmentation_tpu/ops/pallas_attention.py,
// all reached from `_flash_bwd_impl`:
//   K4  `_flash_dq_kernel`:        dq = scale * sum_keys dS K;
//   K5  `_flash_biased_dq_kernel`: K4 with the bias tile added to the scores,
//       plus dbias [H, block, 3*block] = dS summed over batch and query blocks;
//   K3  `_flash_dkv_kernel`:       dv = (P M / keep)^T dO, dk = scale * dS^T Q.
// With s = scale * q.k (+ bias), the forward's per-row logsumexp `lse` and
// D = rowsum(dO * O) (both computed outside):
//   P  = exp(s - lse) where 0 <= key < length, |key - query| <= half AND
//        query < length, else 0;
//   dP = dO V^T, times M / keep under a 0/1 tile M;
//   dS = P * (dP - D).
// A query row at or past its length gets zero dq and adds nothing to dk, dv or
// dbias, although the forward gave it weights: the TPU kernels do the same.
//
// Geometry. The TPU kernels work on [block, 3*block] tiles (block = half
// rounded up to 8). Only the layout of the bias and 0/1 tiles keeps that
// geometry here: tile[i mod block][p - block*(i div block) + block] for query
// i and key p. The masks are on positions, so a clamped edge block of the TPU
// grid needs no special case.
//
// Bound: operations. At [8, 8, 3600, 96], window 240, ragged lengths (26 M
// (query, key) pairs that carry a gradient), K4/K5 do three banded products
// (6*Dh operations per pair, 15.1 GFLOP) and K3 four (8*Dh: 20.2 GFLOP). In
// float32 on the CUDA cores (67 TFLOP/s) that is 0.23 and 0.30 ms; in three
// TF32 passes on the tensor cores (495 TFLOP/s) 0.09 and 0.12 ms, just above
// the 0.08 and 0.10 ms that the bytes these lengths need (q, k, v, dO, lse,
// D of the rows below the length, the gradients of every row) take at
// 3.35 TB/s.
//
// All three kernels run their products on the tensor cores: m16n8k8 3xTF32
// fragments (tf32x3.cuh), X Y^T operands by ldmatrix, the C fragment of P or
// dS reused as the A fragment of the next product (no shuffle, no trip
// through shared memory), every 8-column group of a tile computed (branches
// per group cost more than the products they skip), the elementwise step
// branch-free, tiles staged by cp.async into one buffer each and refilled in
// turn while the other product runs, the bias and 0/1 entries of a 64 x 64
// tile staged by rows with 16-byte copies. The products run over Dh rounded
// up to 32 (zero columns in shared memory): four instantiations each, for Dh
// up to 32, 64, 96 and 128. Times against both floors are in PERF.md.
//
// K4 and K5 (flash_local_dq_kernel), query-major so that dS comes out as A
// rows: a block of 4 warps owns 64 query rows, 16 per warp, and walks the
// 64-key tiles of their band below the length; dQ accumulates in registers.
// Q and dO of its rows stay in shared memory; K and V have one buffer each:
// V of tile t + 1 loads while S, the elementwise step and dS K of tile t run,
// K of tile t + 1 while dP of tile t + 1 runs. 100.5 KB of shared memory at
// Dh 96: two blocks per SM. One block per (batch row, head, query tile) for
// both, so K5 has no loop over the batch. K5's dbias needs a sum across
// blocks that Hopper does not order: each block STORES the dS of its valid
// pairs (query below the length, key in the band and below the length) once
// into a slab of its own, [64, 2*half + 1] with column key - query + half
// (plain stores; no read-modify-write, no atomics), and a second kernel sums,
// for each (head, row residue, offset), the entries of the batch rows in
// order and, within each, of the query positions in order. The result does
// not depend on scheduling, and no entry it reads is one that no block
// wrote, so the scratch is not zeroed. It takes 4 * B * H * ceil(L/64) * 64 *
// (2*half + 1) bytes: 225 MB at [8, 8, 3600, *] window 240, of which the
// valid pairs of those lengths are written and read once.
//
// K3 (flash_local_dkv_kernel), key-major so that P^T and dS^T come out as A
// rows: a block owns 64 keys and walks the query tiles that see them; K and V
// stay in shared memory, Q and dO are refilled in turn; dK and dV accumulate
// in registers; 103 KB at Dh 96, two blocks per SM.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

namespace {

using mts::FragA;

constexpr int kBQ = 64;          // rows of the tile a block owns
constexpr int kBK = 64;          // rows of the tiles it walks
constexpr int kThreadsTC = 128;  // 4 warps of 16 rows (K4, K5: queries; K3: keys)
constexpr int kMaxDh = 128;
constexpr int kPvGroup = 4;  // column tiles per pass of the dQ, dV and dK products

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;    // [B, H, L]
  const float* dd;     // [B, H, L]
  const int* lengths;  // [B]
  const float* bias;   // [H, block, 3*block] or null
  const float* drop;   // [B*H, nb*block, 3*block] or null
  float* dq;
  float* dk;
  float* dv;
  float* partial;      // [B, H, tiles, kBQ, 2*half + 1] or null: K5's dS
  int B, H, L, Dh, half, block, nb, tiles;
  float scale, keep;
};

// K4 and K5 on the tensor cores. NC: 8-column chunks of the head dim this
// instantiation holds (4, 8, 12 or 16). A block of 4 warps owns 64 query rows,
// each warp 16, and walks the 64-key tiles (aligned to 64) that their band
// meets below the length. Per tile, query-major so that dS comes out as A rows:
//   dP = dO V^T and S = Q K^T (3xTF32 fragments in registers);
//   P = exp(scale * S + bias - lse), dS = P * (dP M / keep - D);
//   dQ += dS K, the C fragment of dS reused as the A fragment.
// Q and dO (with lse and D) stay in shared memory; K (with the staged bias /
// 0/1 entries) and V have one buffer each, refilled by cp.async in turn: V of
// tile t + 1 loads while S, dS and dS K of tile t run, K of tile t + 1 while
// dP of tile t + 1 runs. With `partial` (K5) each valid pair's dS is also
// stored into the block's slab [64, 2*half + 1] at column key - query + half.
// 100.5 KB of shared memory at Dh 96: two blocks per SM; at Dh 32, three.
template <int NC>
__global__ void __launch_bounds__(kThreadsTC, NC <= 4 ? 3 : 2)
flash_local_dq_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int Dh = p.Dh;
  const int DS = mts::tile_stride(Dh);
  float* Qs = smem;
  float* Os = Qs + kBQ * DS;  // dO
  float* Ks = Os + kBQ * DS;
  float* Vs = Ks + kBK * DS;
  float* lse_s = Vs + kBK * DS;
  float* dd_s = lse_s + kBQ;
  float* Bs = dd_s + kBQ;                                 // bias entries [query][key]
  float* Ms = Bs + (p.bias != nullptr ? kBQ * mts::kTS : 0);  // 0/1 entries [query][key]

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
  const int qhi = min(min(q0 + kBQ, L), length);  // first row of the tile without a gradient
  const int wr = 16 * warp;                       // this warp's first row in the tile
  const int r0 = q0 + wr;
  const size_t base = static_cast<size_t>(bh) * L * Dh;
  const float* kb = p.k + base;
  const float* vb = p.v + base;
  const float* bias_h = p.bias != nullptr ? p.bias + static_cast<size_t>(h) * block * three : nullptr;
  const float* drop_bh =
      p.drop != nullptr ? p.drop + static_cast<size_t>(bh) * p.nb * block * three : nullptr;
  const float inv_keep = 1.f / p.keep;
  // K5: this block's slab of dS, [64][2*half + 1]; blockIdx.x = (b*H + h)*tiles + tile
  const int wd = 2 * half + 1;
  float* part = p.partial != nullptr ? p.partial + static_cast<size_t>(blockIdx.x) * kBQ * wd
                                     : nullptr;

  float dq[NC][4];  // rows: queries g, g + 8 of the warp; columns 8c + 2t, + 1
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[c][e] = 0.f;

  mts::zero_pad_columns<kThreadsTC, NC>(smem, 2 * kBQ + 2 * kBK, DS, Dh, tid);

  // the keys these rows see: within half of a row below the length, and below it
  const int khi = q0 < qhi ? min(qhi - 1 + half, length - 1) : -1;  // the last one
  const int kfirst = max(0, q0 - half) & ~(kBK - 1);

  // K of tile k0 and the staged bias / 0/1 entries of its 64 x 64 pairs
  auto stage_k = [&](int k0) {
    mts::stage_rows<kThreadsTC, kBK, NC>(Ks, DS, kb, k0, khi + 1, Dh, tid);
    if (bias_h != nullptr)
      mts::stage_tile<kThreadsTC, kBQ>(Bs, bias_h, true, q0, k0, false, L, block, tid);
    if (drop_bh != nullptr)
      mts::stage_tile<kThreadsTC, kBQ>(Ms, drop_bh, false, q0, k0, false, L, block, tid);
  };

  if (kfirst <= khi) {
    mts::stage_rows<kThreadsTC, kBQ, NC>(Qs, DS, p.q + base, q0, qhi, Dh, tid);
    mts::stage_rows<kThreadsTC, kBQ, NC>(Os, DS, p.dout + base, q0, qhi, Dh, tid);
    if (tid < 2 * kBQ) {
      const int r = tid & (kBQ - 1);
      const bool in = q0 + r < qhi;
      const float* src = (tid < kBQ ? p.lse : p.dd) + static_cast<size_t>(bh) * L;
      mts::cp_async4((tid < kBQ ? lse_s : dd_s) + r, in ? src + q0 + r : src, in);
    }
    mts::stage_rows<kThreadsTC, kBK, NC>(Vs, DS, vb, kfirst, khi + 1, Dh, tid);
    mts::cp_async_commit();
    stage_k(kfirst);
    mts::cp_async_commit();
  }

  for (int k0 = kfirst; k0 <= khi; k0 += kBK) {
    const bool next = k0 + kBK <= khi;
    // does any row of this warp with a gradient see a key of the tile?
    const bool active = r0 < qhi && k0 <= r0 + 15 + half && k0 + kBK - 1 >= r0 - half;
    float s[8][4], dp[8][4];  // C layout: rows queries g, g + 8; columns keys 8n + 2t, + 1
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = 0.f;
        dp[n][e] = 0.f;
      }

    mts::cp_async_wait<1>();  // Q, dO, lse, D and this tile's V
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kc = 0; kc < NC; ++kc) {
        FragA a;
        mts::load_a(a, Os, DS, wr, 8 * kc, lane);
        mts::mma3_xyt(dp, a, Vs, DS, 8 * kc, lane);
      }
    }
    __syncthreads();  // every warp is done with V
    if (next) mts::stage_rows<kThreadsTC, kBK, NC>(Vs, DS, vb, k0 + kBK, khi + 1, Dh, tid);
    mts::cp_async_commit();
    mts::cp_async_wait<1>();  // this tile's K and staged entries
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kc = 0; kc < NC; ++kc) {
        FragA a;
        mts::load_a(a, Qs, DS, wr, 8 * kc, lane);
        mts::mma3_xyt(s, a, Ks, DS, 8 * kc, lane);
      }
      // all pairs of the warp's 16 x 64 sub-tile inside the band and below the length
      const bool full = r0 + 15 < qhi && k0 + kBK - 1 < length && k0 + kBK - 1 - r0 <= half &&
                        r0 + 15 - k0 <= half;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int lq = wr + g + 8 * i;
        const int qpos = q0 + lq;
        const float lse_q = lse_s[lq];
        const float dd_q = dd_s[lq];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int lk = 8 * n + 2 * t + e;
            const int kpos = k0 + lk;
            const bool ok = full || (qpos < qhi && kpos < length && abs(kpos - qpos) <= half);
            float sv = p.scale * s[n][2 * i + e];
            if (bias_h != nullptr) sv += Bs[lq * mts::kTS + lk];
            const float pv = __expf(sv - lse_q);
            float dpv = dp[n][2 * i + e];
            if (drop_bh != nullptr) dpv = dpv * (Ms[lq * mts::kTS + lk] * inv_keep);
            // masked pairs give zeros whatever pv is (rows past the length read lse 0)
            const float ds = ok ? pv * (dpv - dd_q) : 0.f;
            s[n][2 * i + e] = ds;
            if (part != nullptr && ok) part[lq * wd + (kpos - qpos + half)] = ds;
          }
      }
      // dQ += dS K over the tile's 64 keys, 8 at a time (scaled on the way out)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        FragA a;
        mts::a_from_c(a, s[kk]);
        mts::mma3_pv<kPvGroup, NC>(dq, a, Ks, DS, 8 * kk, g, t);
      }
    }
    __syncthreads();  // every warp is done with K and the staged entries
    if (next) stage_k(k0 + kBK);
    mts::cp_async_commit();
  }

  // rows at or past the length get zeros
  float* dqb = p.dq + base;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = r0 + g + 8 * i;
    if (qpos < L) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = 8 * c + 2 * t;
        if (col < Dh)
          *reinterpret_cast<float2*>(dqb + static_cast<size_t>(qpos) * Dh + col) =
              make_float2(p.scale * dq[c][0 + 2 * i], p.scale * dq[c][1 + 2 * i]);
      }
    }
  }
}

// K5's second pass: dbias[h][qr][c] = with off = c - block - qr (key - query),
// the sum over the batch rows b in order and, within each, over the query
// positions i = qr, qr + block, ... in order, of the dS that the block owning
// (b, h, i) stored at (i, off): exactly the entries with i and i + off in
// [0, length_b) and |off| <= half, the pairs that carry a gradient.
__global__ void flash_local_dbias_reduce_kernel(const float* __restrict__ partial,
                                                const int* __restrict__ lengths,
                                                float* __restrict__ dbias, int B, int H, int L,
                                                int half, int block, int tiles) {
  const int three = 3 * block;
  const int wd = 2 * half + 1;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(H) * block * three) return;
  const int c = static_cast<int>(idx % three);
  const int qr = static_cast<int>((idx / three) % block);
  const int h = static_cast<int>(idx / (static_cast<long long>(three) * block));
  const int off = c - block - qr;
  float sum = 0.f;
  if (abs(off) <= half) {
    for (int b = 0; b < B; ++b) {
      const int length = min(max(lengths[b], 0), L);
      // the query positions qr + m*block with i < length, i + off >= 0, i + off < length
      const int lo = max(0, -off);
      const int hi = min(length, length - off);
      int i = qr;
      if (i < lo) i += ((lo - i + block - 1) / block) * block;
      const float* slabs = partial + (static_cast<size_t>(b) * H + h) * tiles * kBQ * wd;
#pragma unroll 4
      for (; i < hi; i += block) sum += slabs[static_cast<size_t>(i) * wd + (off + half)];
    }
  }
  dbias[idx] = sum;
}

// K3 on the tensor cores. NC: 8-column chunks of the head dim this
// instantiation holds (4, 8, 12 or 16). A block of 4 warps owns 64 keys, each
// warp 16, and walks the 64-query tiles (aligned to 64) that see them. Per
// tile, in key-major orientation so that P^T and dS^T come out as A rows:
//   dP^T = V dO^T and S^T = K Q^T (3xTF32 fragments in registers);
//   P = exp(scale * S + bias - lse), dS = P * (dP M / keep - D), P M / keep;
//   dV += (P M / keep)^T dO and dK += dS^T Q, the C fragments of P^T and dS^T
//   reused as A fragments.
// K and V of the block's keys stay in shared memory; dO and Q (with lse, D
// and the staged bias / 0/1 entries) have one buffer each, refilled by
// cp.async in turn: dO of tile t + 1 loads while dK of tile t runs, Q of
// tile t + 1 while dP^T of tile t + 1 runs. 103 KB at Dh 96: two blocks per SM.
// The products run over 8 * NC columns of the head dim (zeros past Dh).
template <int NC>
__global__ void __launch_bounds__(kThreadsTC)
flash_local_dkv_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int Dh = p.Dh;
  const int DS = mts::tile_stride(Dh);
  float* Ks = smem;
  float* Vs = Ks + kBQ * DS;
  float* Qs = Vs + kBQ * DS;
  float* Os = Qs + kBK * DS;  // dO
  float* lse_s = Os + kBK * DS;
  float* dd_s = lse_s + kBK;
  float* Bs = dd_s + kBK;                                 // bias entries [query][key]
  float* Ms = Bs + (p.bias != nullptr ? kBK * mts::kTS : 0);  // 0/1 entries [query][key]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x / p.tiles;
  const int k0 = (blockIdx.x - bh * p.tiles) * kBQ;
  const int h = bh % p.H;
  const int L = p.L;
  const int half = p.half;
  const int block = p.block;
  const int three = 3 * block;
  const int length = min(max(p.lengths[bh / p.H], 0), L);
  const int kend = min(k0 + kBQ, L);
  const int khi = min(kend, length);  // first key of the tile that is masked
  const int wk = 16 * warp;           // this warp's first key in the tile
  const int kw = k0 + wk;
  const size_t base = static_cast<size_t>(bh) * L * Dh;
  const float* qb = p.q + base;
  const float* ob = p.dout + base;
  const float* bias_h = p.bias != nullptr ? p.bias + static_cast<size_t>(h) * block * three : nullptr;
  const float* drop_bh =
      p.drop != nullptr ? p.drop + static_cast<size_t>(bh) * p.nb * block * three : nullptr;
  const float inv_keep = 1.f / p.keep;

  float dk[NC][4], dv[NC][4];  // rows: keys g, g + 8 of the warp; columns 8c + 2t, + 1
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[c][e] = 0.f;
      dv[c][e] = 0.f;
    }

  mts::zero_pad_columns<kThreadsTC, NC>(smem, 2 * kBQ + 2 * kBK, DS, Dh, tid);

  // the queries that see these keys: within half, and below the length
  const int qlo = max(0, k0 - half) & ~(kBK - 1);
  const int qhi = k0 < khi ? min(khi - 1 + half, length - 1) : -1;  // the last one

  // Q, lse, D and the staged entries of query tile q0
  auto stage_q = [&](int q0) {
    mts::stage_rows<kThreadsTC, kBK, NC>(Qs, DS, qb, q0, qhi + 1, Dh, tid);
    if (tid < 2 * kBK) {
      const int r = tid & (kBK - 1);
      const bool in = q0 + r <= qhi;
      const float* src = (tid < kBK ? p.lse : p.dd) + static_cast<size_t>(bh) * L;
      mts::cp_async4((tid < kBK ? lse_s : dd_s) + r, in ? src + q0 + r : src, in);
    }
    if (bias_h != nullptr)
      mts::stage_tile<kThreadsTC, kBK>(Bs, bias_h, true, q0, k0, false, L, block, tid);
    if (drop_bh != nullptr)
      mts::stage_tile<kThreadsTC, kBK>(Ms, drop_bh, false, q0, k0, false, L, block, tid);
  };

  if (qlo <= qhi) {
    mts::stage_rows<kThreadsTC, kBQ, NC>(Ks, DS, p.k + base, k0, khi, Dh, tid);
    mts::stage_rows<kThreadsTC, kBQ, NC>(Vs, DS, p.v + base, k0, khi, Dh, tid);
    mts::stage_rows<kThreadsTC, kBK, NC>(Os, DS, ob, qlo, qhi + 1, Dh, tid);
    mts::cp_async_commit();
    stage_q(qlo);
    mts::cp_async_commit();
  }

  for (int q0 = qlo; q0 <= qhi; q0 += kBK) {
    const bool next = q0 + kBK <= qhi;
    // does any key of this warp meet a query of the tile?
    const bool active = kw < khi && q0 <= kw + 15 + half && q0 + kBK - 1 >= kw - half;
    float s[8][4], dp[8][4];  // C layout: rows keys g, g + 8; columns queries 8n + 2t, + 1
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = 0.f;
        dp[n][e] = 0.f;
      }

    mts::cp_async_wait<1>();  // K, V and this tile's dO
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kc = 0; kc < NC; ++kc) {
        FragA a;
        mts::load_a(a, Vs, DS, wk, 8 * kc, lane);
        mts::mma3_xyt(dp, a, Os, DS, 8 * kc, lane);
      }
    }
    mts::cp_async_wait<0>();  // this tile's Q, lse, D and staged entries
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kc = 0; kc < NC; ++kc) {
        FragA a;
        mts::load_a(a, Ks, DS, wk, 8 * kc, lane);
        mts::mma3_xyt(s, a, Qs, DS, 8 * kc, lane);
      }
      // all pairs of the warp's 16 x 64 sub-tile inside the band and below the length
      const bool full = kw + 15 < khi && q0 + kBK - 1 <= qhi && q0 + kBK - 1 - kw <= half &&
                        kw + 15 - q0 <= half;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int lq = 8 * n + 2 * t + e;
          const int qpos = q0 + lq;
          const float lse_q = lse_s[lq];
          const float dd_q = dd_s[lq];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int lk = wk + g + 8 * i;
            const int kpos = k0 + lk;
            const bool ok = full || (kpos < khi && qpos <= qhi && abs(kpos - qpos) <= half);
            float sv = p.scale * s[n][2 * i + e];
            if (bias_h != nullptr) sv += Bs[lq * mts::kTS + lk];
            const float pv = __expf(sv - lse_q);
            float dpv = dp[n][2 * i + e];
            float pd = pv;
            if (drop_bh != nullptr) {
              const float mk = Ms[lq * mts::kTS + lk] * inv_keep;
              pd = pv * mk;
              dpv = dpv * mk;
            }
            // masked pairs give zeros whatever pv is (rows past the length read lse 0)
            s[n][2 * i + e] = ok ? pd : 0.f;
            dp[n][2 * i + e] = ok ? pv * (dpv - dd_q) : 0.f;
          }
        }
      // dV += (P M / keep)^T dO over the tile's 64 queries, 8 at a time
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        FragA a;
        mts::a_from_c(a, s[kk]);
        mts::mma3_pv<kPvGroup, NC>(dv, a, Os, DS, 8 * kk, g, t);
      }
    }
    __syncthreads();  // every warp is done with dO
    if (next) mts::stage_rows<kThreadsTC, kBK, NC>(Os, DS, ob, q0 + kBK, qhi + 1, Dh, tid);
    mts::cp_async_commit();
    if (active) {
      // dK += dS^T Q (scaled on the way out)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        FragA a;
        mts::a_from_c(a, dp[kk]);
        mts::mma3_pv<kPvGroup, NC>(dk, a, Qs, DS, 8 * kk, g, t);
      }
    }
    __syncthreads();  // every warp is done with Q, lse, D and the staged entries
    if (next) stage_q(q0 + kBK);
    mts::cp_async_commit();
  }

  // keys past the length get zeros
  float* dkb = p.dk + base;
  float* dvb = p.dv + base;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = kw + g + 8 * i;
    if (kpos < L) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = 8 * c + 2 * t;
        if (col < Dh) {
          const size_t at = static_cast<size_t>(kpos) * Dh + col;
          *reinterpret_cast<float2*>(dkb + at) =
              make_float2(p.scale * dk[c][2 * i], p.scale * dk[c][2 * i + 1]);
          *reinterpret_cast<float2*>(dvb + at) = make_float2(dv[c][2 * i], dv[c][2 * i + 1]);
        }
      }
    }
  }
}

size_t dq_smem(const Params& p) {
  return (static_cast<size_t>(2 * kBQ + 2 * kBK) * mts::tile_stride(p.Dh) + 2 * kBQ +
          (p.bias != nullptr ? kBQ * mts::kTS : 0) + (p.drop != nullptr ? kBQ * mts::kTS : 0)) *
         sizeof(float);
}

size_t dkv_smem(const Params& p) {
  return (static_cast<size_t>(2 * kBQ + 2 * kBK) * mts::tile_stride(p.Dh) + 2 * kBK +
          (p.bias != nullptr ? kBK * mts::kTS : 0) + (p.drop != nullptr ? kBK * mts::kTS : 0)) *
         sizeof(float);
}

template <int NC>
int launch_dq(const Params& p, unsigned blocks, cudaStream_t s) {
  const size_t bytes = dq_smem(p);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(flash_local_dq_kernel<NC>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_local_dq_kernel<NC><<<blocks, kThreadsTC, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int NC>
int launch_dkv(const Params& p, unsigned blocks, cudaStream_t s) {
  const size_t bytes = dkv_smem(p);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(flash_local_dkv_kernel<NC>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_local_dkv_kernel<NC><<<blocks, kThreadsTC, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool prepare(Params& p) {
  if (p.B <= 0 || p.H <= 0 || p.L <= 0 || p.Dh <= 0 || p.Dh % 4 != 0 || p.Dh > kMaxDh ||
      p.half < 0 || p.block < 1 || p.block < p.half || p.keep <= 0.f)
    return false;
  p.nb = (p.L + p.block - 1) / p.block;
  p.tiles = (p.L + kBQ - 1) / kBQ;
  return true;
}

// One block per (batch row, head, 64-row tile) for K4, K5 and K3 alike; the
// staged bias / 0/1 entries are copied 16 bytes at a time (block % 8 == 0).
bool prepare_grid(Params& p, unsigned& blocks) {
  if (!prepare(p) || p.block % 8 != 0) return false;
  const long long n = static_cast<long long>(p.B) * p.H * p.tiles;
  if (n > 0x7fffffffLL) return false;
  blocks = static_cast<unsigned>(n);
  return true;
}

int run_dq(Params p, void* stream) {
  unsigned n = 0;
  if (!prepare_grid(p, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((p.Dh + 31) / 32) {
    case 1: return launch_dq<4>(p, n, s);
    case 2: return launch_dq<8>(p, n, s);
    case 3: return launch_dq<12>(p, n, s);
    default: return launch_dq<16>(p, n, s);
  }
}

int run_dkv(Params p, void* stream) {
  unsigned n = 0;
  if (!prepare_grid(p, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((p.Dh + 31) / 32) {
    case 1: return launch_dkv<4>(p, n, s);
    case 2: return launch_dkv<8>(p, n, s);
    case 3: return launch_dkv<12>(p, n, s);
    default: return launch_dkv<16>(p, n, s);
  }
}

Params make_params(const float* q, const float* k, const float* v, const float* dout,
                   const float* lse, const float* dd, const int* lengths, const float* bias,
                   const float* drop, int B, int H, int L, int Dh, int half, int block,
                   float scale, float keep) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.dd = dd; p.lengths = lengths;
  p.bias = bias; p.drop = drop;
  p.dq = nullptr; p.dk = nullptr; p.dv = nullptr; p.partial = nullptr;
  p.B = B; p.H = H; p.L = L; p.Dh = Dh; p.half = half; p.block = block; p.nb = 0; p.tiles = 0;
  p.scale = scale; p.keep = keep;
  return p;
}

}  // namespace

// All three launch on `stream` and return the cudaError_t of the launch (0 =
// success). q, k, v, dout and the gradients: [B, H, L, Dh] float32, contiguous,
// 16-byte aligned, Dh % 4 == 0, Dh <= 128. lse, dd: [B, H, L]. lengths: [B]
// int32. bias: [H, block, 3*block] or null; drop: [B*H, ceil(L/block)*block,
// 3*block] of 0/1 or null; block >= half is the geometry the two are laid out in,
// and block % 8 == 0 (their rows are staged 16 bytes at a time).

// K4: dq.
extern "C" int mts_flash_local_dq_f32(const float* q, const float* k, const float* v,
                                      const float* dout, const float* lse, const float* dd,
                                      const int* lengths, const float* drop, float* dq, int B,
                                      int H, int L, int Dh, int half, int block, float scale,
                                      float keep, void* stream) {
  Params p = make_params(q, k, v, dout, lse, dd, lengths, nullptr, drop, B, H, L, Dh, half, block,
                         scale, keep);
  p.dq = dq;
  return run_dq(p, stream);
}

// K5: dq and dbias [H, block, 3*block]. `partial` is scratch of
// B * H * ceil(L/64) * 64 * (2*half + 1) floats; it need not be zeroed (the
// reduce reads only the entries the dq kernel stored).
extern "C" int mts_flash_local_dq_dbias_f32(const float* q, const float* k, const float* v,
                                            const float* dout, const float* lse, const float* dd,
                                            const int* lengths, const float* bias,
                                            const float* drop, float* dq, float* partial,
                                            float* dbias, int B, int H, int L, int Dh, int half,
                                            int block, float scale, float keep, void* stream) {
  if (bias == nullptr || partial == nullptr || dbias == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, dout, lse, dd, lengths, bias, drop, B, H, L, Dh, half, block,
                         scale, keep);
  p.dq = dq;
  p.partial = partial;
  const int rc = run_dq(p, stream);
  if (rc != 0) return rc;
  const long long n = static_cast<long long>(H) * block * 3 * block;
  const int threads = 256;
  flash_local_dbias_reduce_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      partial, lengths, dbias, B, H, L, half, block, (L + kBQ - 1) / kBQ);
  return static_cast<int>(cudaGetLastError());
}

// K3: dk and dv.
extern "C" int mts_flash_local_dkv_f32(const float* q, const float* k, const float* v,
                                       const float* dout, const float* lse, const float* dd,
                                       const int* lengths, const float* bias, const float* drop,
                                       float* dk, float* dv, int B, int H, int L, int Dh, int half,
                                       int block, float scale, float keep, void* stream) {
  Params p = make_params(q, k, v, dout, lse, dd, lengths, bias, drop, B, H, L, Dh, half, block,
                         scale, keep);
  p.dk = dk;
  p.dv = dv;
  return run_dkv(p, stream);
}
