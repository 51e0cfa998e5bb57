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
// K4 and K5 (float32 on the CUDA cores): 256 threads own a 64 x 64 tile of
// (query, key) pairs at a time, each thread a 4 x 4 micro-tile of s and dP
// computed in one pass over Dh from shared-memory tiles of Q, dO, K and V
// (rows padded by 4 floats so the float4 reads do not conflict). dS goes
// through shared memory into the second product, whose accumulators stay in
// registers; nothing score-shaped reaches device memory. Only tiles inside
// the band and below the length are visited. A block owns 64 query rows and
// walks their key tiles; K4 runs one block per (batch row, head, query tile).
// K5's dbias has no sequential grid to lean on. One block per (head, query
// tile) loops over the batch IN ORDER and adds its dS into a partial [64, 64
// + 2*half] of its own in device memory (column = key - (q0 - half); plain
// read-modify-write, no atomics: no other block touches it). A second kernel
// then sums, for each (head, row, offset) of the tile, the partials of the
// query positions i = row, row + block, ... in order. The result does not
// depend on scheduling.
//
// K3 (redesigned for Hopper's tensor cores; see flash_local_dkv_kernel): all
// four products in m16n8k8 3xTF32 fragments (tf32x3.cuh), key-major so that
// P^T and dS^T stay in registers as the A operand of dV and dK; the
// operands of K Q^T and V dO^T by ldmatrix; every 8-query group of a tile computed
// (branches per group cost more than the products they skip); the
// elementwise step branch-free; Q and dO tiles by cp.async, one buffer each,
// refilled in turn while the other product runs; 103 KB of shared memory at
// Dh 96, two blocks per SM (the float32 CUDA-core design it replaces held
// six tiles, 138 KB, one block per SM); the bias and 0/1 entries of a 64 x 64
// tile are staged by rows with 16-byte copies instead of being read one by
// one from device memory. Times against both floors are in PERF.md.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

namespace {

using mts::FragA;

constexpr int kBQ = 64;        // rows of the tile a block owns
constexpr int kBK = 64;        // rows of the tiles it walks
constexpr int kThreads = 256;  // K4, K5: 16 row groups x 16 column lanes
constexpr int kThreadsTC = 128;  // K3: 4 warps of 16 keys each
constexpr int kPS = kBK + 4;   // row stride of the dS / P tiles
constexpr int kMaxDh = 128;
constexpr int kPvGroup = 4;  // column tiles per pass of K3's dV and dK products

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
  float* partial;      // [H, tiles, kBQ, kBQ + 2*half] or null: K5's dS sums
  int B, H, L, Dh, half, block, nb, tiles;
  float scale, keep;
};

__device__ __forceinline__ float at(const float4& f, int u) {
  return u == 0 ? f.x : (u == 1 ? f.y : (u == 2 ? f.z : f.w));
}

// rows [row0, row0 + 64) of a [L, Dh] matrix into a padded shared tile; rows
// at or past `row_end` are zero-filled (0 * garbage must not make a NaN)
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int row_end,
                                          int Dh, int DS, int tid) {
  const int d4n = Dh >> 2;
  for (int idx = tid; idx < 64 * d4n; idx += kThreads) {
    const int row = idx / d4n;
    const int c4 = idx - row * d4n;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + row < row_end)
      val = *reinterpret_cast<const float4*>(src + static_cast<size_t>(row0 + row) * Dh + 4 * c4);
    *reinterpret_cast<float4*>(dst + row * DS + 4 * c4) = val;
  }
}

// s[r][c] = A[ty*4+r] . B[tx+16c] and t[r][c] = C[ty*4+r] . D[tx+16c] over Dh
__device__ __forceinline__ void two_products(const float* A, const float* Bm, const float* C,
                                             const float* Dm, int Dh, int DS, int tx, int ty,
                                             float (&s)[4][4], float (&t)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[r][c] = 0.f;
      t[r][c] = 0.f;
    }
  for (int d = 0; d < Dh; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = *reinterpret_cast<const float4*>(A + (ty * 4 + r) * DS + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * c) * DS + d);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[r][c] += a[r].x * b[c].x + a[r].y * b[c].y + a[r].z * b[c].z + a[r].w * b[c].w;
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = *reinterpret_cast<const float4*>(C + (ty * 4 + r) * DS + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = *reinterpret_cast<const float4*>(Dm + (tx + 16 * c) * DS + d);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        t[r][c] += a[r].x * b[c].x + a[r].y * b[c].y + a[r].z * b[c].z + a[r].w * b[c].w;
  }
}

// K4 and K5. DC = ceil(Dh / 16): dq columns per thread.
template <int DC>
__global__ void __launch_bounds__(kThreads)
flash_local_dq_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int Dh = p.Dh;
  const int DS = Dh + 4;
  float* Qs = smem;
  float* Os = Qs + kBQ * DS;   // dO
  float* Ks = Os + kBQ * DS;
  float* Vs = Ks + kBK * DS;
  float* Ss = Vs + kBK * DS;   // dS
  float* lse_s = Ss + kBQ * kPS;
  float* dd_s = lse_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int tile = blockIdx.x % p.tiles;
  const int outer = blockIdx.x / p.tiles;
  const int q0 = tile * kBQ;
  const int L = p.L;
  const int half = p.half;
  const int block = p.block;
  const int three = 3 * block;
  const int qend = min(q0 + kBQ, L);
  const int wp = kBQ + 2 * half;
  // K5 (partial given): this block serves head `outer` and every batch row in
  // order. K4: it serves the one (batch row, head) pair `outer`.
  const bool per_head = p.partial != nullptr;
  const int h = per_head ? outer : outer % p.H;
  const int b_first = per_head ? 0 : outer / p.H;
  const int b_last = per_head ? p.B : b_first + 1;

  bool colok[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) colok[c] = tx + 16 * c < Dh;

  for (int b = b_first; b < b_last; ++b) {
    const int bh = b * p.H + h;
    const int length = min(max(p.lengths[b], 0), L);
    const int qhi = min(qend, length);  // first row of the tile without a gradient
    const size_t base = static_cast<size_t>(bh) * L * Dh;
    const float* kb = p.k + base;
    const float* vb = p.v + base;

    float acc[4][DC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;

    if (q0 < qhi) {
      load_tile(Qs, p.q + base, q0, qhi, Dh, DS, tid);
      load_tile(Os, p.dout + base, q0, qhi, Dh, DS, tid);
      if (tid < kBQ) {
        const bool in = q0 + tid < qhi;
        lse_s[tid] = in ? p.lse[static_cast<size_t>(bh) * L + q0 + tid] : 0.f;
        dd_s[tid] = in ? p.dd[static_cast<size_t>(bh) * L + q0 + tid] : 0.f;
      }
      const int klo = max(0, q0 - half);
      const int khi = min(qhi - 1 + half, length - 1);
      for (int k0 = klo; k0 <= khi; k0 += kBK) {
        load_tile(Ks, kb, k0, khi + 1, Dh, DS, tid);
        load_tile(Vs, vb, k0, khi + 1, Dh, DS, tid);
        __syncthreads();

        float s[4][4], dp[4][4];
        two_products(Qs, Ks, Os, Vs, Dh, DS, tx, ty, s, dp);

#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = ty * 4 + r;
          const int qpos = q0 + row;
          const int jq = qpos / block;
          const int qr = qpos - jq * block;
          const float lse = lse_s[row];
          const float dd = dd_s[row];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int kpos = k0 + tx + 16 * c;
            const bool ok = qpos < qhi && kpos <= khi && abs(kpos - qpos) <= half;
            float ds = 0.f;
            if (ok) {
              const int col = kpos - jq * block + block;
              float sv = p.scale * s[r][c];
              if (p.bias != nullptr) sv += p.bias[(static_cast<size_t>(h) * block + qr) * three + col];
              const float pv = expf(sv - lse);
              float dpv = dp[r][c];
              if (p.drop != nullptr)
                dpv = dpv * p.drop[(static_cast<size_t>(bh) * p.nb * block + qpos) * three + col] /
                      p.keep;
              ds = pv * (dpv - dd);
              if (per_head)
                p.partial[((static_cast<size_t>(h) * p.tiles + tile) * kBQ + row) * wp +
                          (kpos - q0 + half)] += ds;
            }
            Ss[row * kPS + tx + 16 * c] = ds;
          }
        }
        __syncthreads();

        for (int kk = 0; kk < kBK; kk += 4) {
          float4 sr[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            sr[r] = *reinterpret_cast<const float4*>(Ss + (ty * 4 + r) * kPS + kk);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float kv[DC];
#pragma unroll
            for (int c = 0; c < DC; ++c) kv[c] = colok[c] ? Ks[(kk + u) * DS + tx + 16 * c] : 0.f;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float su = at(sr[r], u);
#pragma unroll
              for (int c = 0; c < DC; ++c) acc[r][c] += su * kv[c];
            }
          }
        }
        __syncthreads();
      }
    }

    float* dqb = p.dq + base;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty * 4 + r;
      if (qpos < L) {
#pragma unroll
        for (int c = 0; c < DC; ++c)
          if (colok[c]) dqb[static_cast<size_t>(qpos) * Dh + tx + 16 * c] = p.scale * acc[r][c];
      }
    }
  }
}

// K5's second pass: dbias[h][qr][c] = sum over the query positions i = qr,
// qr + block, ... < L, in order, of the partial dS at (i, i + c - block - qr).
__global__ void flash_local_dbias_reduce_kernel(const float* __restrict__ partial,
                                                float* __restrict__ dbias, int H, int L,
                                                int half, int block, int tiles) {
  const int three = 3 * block;
  const int wp = kBQ + 2 * half;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(H) * block * three) return;
  const int c = static_cast<int>(idx % three);
  const int qr = static_cast<int>((idx / three) % block);
  const int h = static_cast<int>(idx / (static_cast<long long>(three) * block));
  const int off = c - block - qr;  // key - query
  float sum = 0.f;
  if (abs(off) <= half) {
    for (int qpos = qr; qpos < L; qpos += block) {
      const int t = qpos / kBQ;
      const int r = qpos - t * kBQ;
      sum += partial[((static_cast<size_t>(h) * tiles + t) * kBQ + r) * wp + (off + r + half)];
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

size_t dq_smem(int Dh) {
  return (static_cast<size_t>(2 * kBQ + 2 * kBK) * (Dh + 4) + static_cast<size_t>(kBQ) * kPS +
          2 * kBQ) * sizeof(float);
}

size_t dkv_smem(const Params& p) {
  return (static_cast<size_t>(2 * kBQ + 2 * kBK) * mts::tile_stride(p.Dh) + 2 * kBK +
          (p.bias != nullptr ? kBK * mts::kTS : 0) + (p.drop != nullptr ? kBK * mts::kTS : 0)) *
         sizeof(float);
}

template <int DC>
int launch_dq(const Params& p, unsigned blocks, cudaStream_t s) {
  const size_t bytes = dq_smem(p.Dh);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(flash_local_dq_kernel<DC>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_local_dq_kernel<DC><<<blocks, kThreads, bytes, s>>>(p);
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

#define MTS_DISPATCH_DC(fn, ...)                      \
  switch ((p.Dh + 15) / 16) {                         \
    case 1: return fn<1>(__VA_ARGS__);                \
    case 2: return fn<2>(__VA_ARGS__);                \
    case 3: return fn<3>(__VA_ARGS__);                \
    case 4: return fn<4>(__VA_ARGS__);                \
    case 5: return fn<5>(__VA_ARGS__);                \
    case 6: return fn<6>(__VA_ARGS__);                \
    case 7: return fn<7>(__VA_ARGS__);                \
    default: return fn<8>(__VA_ARGS__);               \
  }

bool prepare(Params& p) {
  if (p.B <= 0 || p.H <= 0 || p.L <= 0 || p.Dh <= 0 || p.Dh % 4 != 0 || p.Dh > kMaxDh ||
      p.half < 0 || p.block < 1 || p.block < p.half || p.keep <= 0.f)
    return false;
  p.nb = (p.L + p.block - 1) / p.block;
  p.tiles = (p.L + kBQ - 1) / kBQ;
  return true;
}

int run_dq(Params p, void* stream) {
  if (!prepare(p)) return static_cast<int>(cudaErrorInvalidValue);
  const long long outer = p.partial != nullptr ? p.H : static_cast<long long>(p.B) * p.H;
  const long long blocks = outer * p.tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned n = static_cast<unsigned>(blocks);
  MTS_DISPATCH_DC(launch_dq, p, n, s)
}

int run_dkv(Params p, void* stream) {
  // the staged bias / 0/1 entries are copied 16 bytes at a time
  if (!prepare(p) || p.block % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(p.B) * p.H * p.tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned n = static_cast<unsigned>(blocks);
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
// 3*block] of 0/1 or null; block >= half is the geometry the two are laid out in.

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
// H * ceil(L/64) * 64 * (64 + 2*half) floats that the caller has ZEROED.
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
      partial, dbias, H, L, half, block, (L + kBQ - 1) / kBQ);
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
