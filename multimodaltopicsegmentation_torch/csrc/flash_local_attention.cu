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
// Bound: operations. At the main-path shape [8, 8, 3600, 96], window 240,
// QK^T and PV are 4*B*H*L*(window+1)*Dh = 21.3 GFLOP, 0.32 ms at the H100's
// 67 TFLOP/s float32 rate, against 354 MB of q, k, v, O (0.11 ms at 3.35 TB/s).
// The arithmetic stays float32 on the CUDA cores for parity with the float32
// reference; tensor-core (TF32/bf16) products are a separate precision
// decision.
//
// Design: one block of 256 threads owns 64 consecutive query rows and walks
// the keys [q0 - half, q0 + 63 + half] clipped to [0, length) in tiles of 64
// staged through shared memory, with a running max, sum and O accumulator per
// row (online softmax), so no score ever reaches device memory and masked
// tiles outside the band are never computed (the TPU kernel's 3-block tile
// computes 3*block columns for window+1 useful ones). Each thread holds a
// 4 x 4 micro-tile of the scores and 4 x Dh/16 of O; a row's 16 threads are
// one half-warp, so row statistics are shuffles. Shared-memory rows are
// padded by 4 floats, which makes the float4 reads conflict-free.
// Left for later tuning: cp.async/TMA double buffering and tensor cores.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kWarps = kThreads / 32;
constexpr int kPS = kBK + 4;   // row stride of the probability tile
constexpr float kNegInf = -1e9f;
constexpr int kMaxDh = 128;

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

__device__ __forceinline__ float group16_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float at(const float4& f, int u) {
  return u == 0 ? f.x : (u == 1 ? f.y : (u == 2 ? f.z : f.w));
}

// DC = ceil(Dh / 16): O columns per thread.
template <int DC>
__global__ void __launch_bounds__(kThreads)
flash_local_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int Dh = p.Dh;
  const int DS = Dh + 4;  // row stride of the q, k, v tiles
  float* Qs = smem;
  float* Ks = Qs + kBQ * DS;
  float* Vs = Ks + kBK * DS;
  float* Ps = Vs + kBK * DS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x / p.tiles;
  const int q0 = (blockIdx.x - bh * p.tiles) * kBQ;
  const int h = bh % p.H;
  const int L = p.L;
  const int half = p.half;
  const int block = p.block;
  const int three = 3 * block;
  const int length = min(max(p.lengths[bh / p.H], 0), L);
  const int qend = min(q0 + kBQ, L);
  const int d4n = Dh >> 2;

  const float* qb = p.q + static_cast<size_t>(bh) * L * Dh;
  const float* kb = p.k + static_cast<size_t>(bh) * L * Dh;
  const float* vb = p.v + static_cast<size_t>(bh) * L * Dh;
  float* ob = p.out + static_cast<size_t>(bh) * L * Dh;

  // keys any row of this tile can see
  const int klo = max(0, q0 - half);
  const int khi = min(qend - 1 + half, length - 1);

  bool colok[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) colok[c] = tx + 16 * c < Dh;

  if (klo <= khi) {
    for (int idx = tid; idx < kBQ * d4n; idx += kThreads) {
      const int row = idx / d4n;
      const int c4 = idx - row * d4n;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + row < L) {
        val = *reinterpret_cast<const float4*>(qb + static_cast<size_t>(q0 + row) * Dh + 4 * c4);
        val.x *= p.scale; val.y *= p.scale; val.z *= p.scale; val.w *= p.scale;
      }
      *reinterpret_cast<float4*>(Qs + row * DS + 4 * c4) = val;
    }
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = klo; k0 <= khi; k0 += kBK) {
    // rows past khi are zero-filled: their weights are 0, and 0 * garbage
    // must not make a NaN
    for (int idx = tid; idx < kBK * d4n; idx += kThreads) {
      const int row = idx / d4n;
      const int c4 = idx - row * d4n;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (k0 + row <= khi) {
        const size_t off = static_cast<size_t>(k0 + row) * Dh + 4 * c4;
        kv = *reinterpret_cast<const float4*>(kb + off);
        vv = *reinterpret_cast<const float4*>(vb + off);
      }
      *reinterpret_cast<float4*>(Ks + row * DS + 4 * c4) = kv;
      *reinterpret_cast<float4*>(Vs + row * DS + 4 * c4) = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int d = 0; d < Dh; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + r) * DS + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        b[c] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * c) * DS + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[r][c] += a[r].x * b[c].x + a[r].y * b[c].y + a[r].z * b[c].z + a[r].w * b[c].w;
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty * 4 + r;
      const int jq = qpos / block;
      const int qr = qpos - jq * block;
      bool ok[4];
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        ok[c] = qpos < L && kpos <= khi && abs(kpos - qpos) <= half;
        if (ok[c]) {
          if (p.bias != nullptr) {
            const int col = kpos - jq * block + block;
            s[r][c] += p.bias[(static_cast<size_t>(h) * block + qr) * three + col];
          }
          tmax = fmaxf(tmax, s[r][c]);
        }
      }
      tmax = group16_max(tmax);
      const float m_new = fmaxf(m[r], tmax);
      const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float pv = ok[c] ? expf(s[r][c] - m_new) : 0.f;
        rsum += pv;  // the row sum stays undropped
        if (p.drop != nullptr && ok[c]) {
          const int col = k0 + tx + 16 * c - jq * block + block;
          pv *= p.drop[(static_cast<size_t>(bh) * p.nb * block + qpos) * three + col];
        }
        Ps[(ty * 4 + r) * kPS + tx + 16 * c] = pv;
      }
      rsum = group16_sum(rsum);
      l[r] = l[r] * alpha + rsum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pr[r] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + r) * kPS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) vv[c] = colok[c] ? Vs[(kk + u) * DS + tx + 16 * c] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float pu = at(pr[r], u);
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[r][c] += pu * vv[c];
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q0 + ty * 4 + r;
    if (qpos < L && l[r] > 0.f) {
      const float lsum = fmaxf(l[r], 1e-20f);
      float inv = 1.f / lsum;
      if (p.drop != nullptr) inv /= p.keep;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        if (colok[c]) ob[static_cast<size_t>(qpos) * Dh + tx + 16 * c] = acc[r][c] * inv;
      if (p.lse != nullptr && tx == 0)
        p.lse[static_cast<size_t>(bh) * L + qpos] = m[r] + logf(lsum);
    }
  }

  // Rows with no valid key: i >= length + half, or length 0. They are the
  // rows the loop above left with l == 0.
  const int u0 = max(length == 0 ? 0 : length + half, q0);
  if (u0 >= qend) return;

  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* red = Qs;               // [kWarps][Dh]
  float* usum = Qs + kWarps * Dh;  // [Dh]
  for (int j = u0 / block; j <= (qend - 1) / block; ++j) {
    // sum of V over the three clamped blocks of geometry block j
    float part[kMaxDh / 32];
#pragma unroll
    for (int i = 0; i < kMaxDh / 32; ++i) part[i] = 0.f;
    for (int c = warp; c < three; c += kWarps) {
      const int slot = c / block;
      const int pos = min(max(j - 1 + slot, 0), p.nb - 1) * block + (c - slot * block);
      if (pos < L) {
        const float* vr = vb + static_cast<size_t>(pos) * Dh;
#pragma unroll
        for (int i = 0; i < kMaxDh / 32; ++i)
          if (lane + 32 * i < Dh) part[i] += vr[lane + 32 * i];
      }
    }
    __syncthreads();  // the previous round's readers are done with red/usum
#pragma unroll
    for (int i = 0; i < kMaxDh / 32; ++i)
      if (lane + 32 * i < Dh) red[warp * Dh + lane + 32 * i] = part[i];
    __syncthreads();
    if (tid < Dh) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += red[w * Dh + tid];
      usum[tid] = t;
    }
    __syncthreads();

    const int r_hi = min(qend, (j + 1) * block);
    for (int qpos = max(u0, j * block) + warp; qpos < r_hi; qpos += kWarps) {
      const int qr = qpos - j * block;
      const float* brow =
          p.bias != nullptr ? p.bias + (static_cast<size_t>(h) * block + qr) * three : nullptr;
      const float* drow =
          p.drop != nullptr
              ? p.drop + (static_cast<size_t>(bh) * p.nb * block + qpos) * three
              : nullptr;
      float* orow = ob + static_cast<size_t>(qpos) * Dh;
      // every score is -1e9 (+ bias, which float32 drops below 32)
      float mx = kNegInf, mn = kNegInf;
      if (brow != nullptr) {
        mx = -INFINITY;
        mn = INFINITY;
        for (int c = lane; c < three; c += 32) {
          const float sc = kNegInf + brow[c];
          mx = fmaxf(mx, sc);
          mn = fminf(mn, sc);
        }
        mx = warp_max(mx);
        mn = warp_min(mn);
      }
      float lsum;
      if (mx == mn && drow == nullptr) {
        lsum = static_cast<float>(three);
        const float w = 1.f / lsum;
        for (int d = lane; d < Dh; d += 32) orow[d] = w * usum[d];
      } else {
        float ls = 0.f;
        for (int c = lane; c < three; c += 32)
          ls += expf(kNegInf + (brow != nullptr ? brow[c] : 0.f) - mx);
        lsum = fmaxf(warp_sum(ls), 1e-20f);
        float o[kMaxDh / 32];
#pragma unroll
        for (int i = 0; i < kMaxDh / 32; ++i) o[i] = 0.f;
        for (int slot = 0; slot < 3; ++slot) {
          const int base = min(max(j - 1 + slot, 0), p.nb - 1) * block;
          // branch-free and unrolled, so that the loads of several columns
          // are in flight together: this loop is bound by their latency
#pragma unroll 4
          for (int r = 0; r < block; ++r) {
            const int c = slot * block + r;
            float w = (brow != nullptr ? expf(kNegInf + brow[c] - mx) : 1.f) / lsum;
            if (drow != nullptr) w = w * drow[c] / p.keep;
            const bool in = base + r < L;
            const float* vr = vb + static_cast<size_t>(in ? base + r : 0) * Dh;
            const float wv = in ? w : 0.f;
#pragma unroll
            for (int i = 0; i < kMaxDh / 32; ++i)
              if (lane + 32 * i < Dh) o[i] += wv * vr[lane + 32 * i];
          }
        }
#pragma unroll
        for (int i = 0; i < kMaxDh / 32; ++i)
          if (lane + 32 * i < Dh) orow[lane + 32 * i] = o[i];
      }
      if (p.lse != nullptr && lane == 0)
        p.lse[static_cast<size_t>(bh) * L + qpos] = mx + logf(lsum);
    }
  }
}

template <int DC>
int launch_dc(const Params& p, unsigned blocks, size_t bytes, cudaStream_t s) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(flash_local_fwd_kernel<DC>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_local_fwd_kernel<DC><<<blocks, kThreads, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch(Params p, int B, void* stream) {
  if (B <= 0 || p.H <= 0 || p.L <= 0 || p.Dh <= 0 || p.Dh % 4 != 0 || p.Dh > kMaxDh ||
      p.half < 0 || p.block < 1 || p.block < p.half)
    return static_cast<int>(cudaErrorInvalidValue);
  p.nb = (p.L + p.block - 1) / p.block;
  p.tiles = (p.L + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(B) * p.H * p.tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes =
      (static_cast<size_t>(kBQ + 2 * kBK) * (p.Dh + 4) + static_cast<size_t>(kBQ) * kPS) *
      sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned n = static_cast<unsigned>(blocks);
  switch ((p.Dh + 15) / 16) {
    case 1: return launch_dc<1>(p, n, bytes, s);
    case 2: return launch_dc<2>(p, n, bytes, s);
    case 3: return launch_dc<3>(p, n, bytes, s);
    case 4: return launch_dc<4>(p, n, bytes, s);
    case 5: return launch_dc<5>(p, n, bytes, s);
    case 6: return launch_dc<6>(p, n, bytes, s);
    case 7: return launch_dc<7>(p, n, bytes, s);
    default: return launch_dc<8>(p, n, bytes, s);
  }
}

}  // namespace

// K2. Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// q, k, v, out: [B, H, L, Dh] float32, contiguous, 16-byte aligned, Dh % 4 == 0,
// Dh <= 128. lengths: [B] int32. bias: [H, block, 3*block] or null. drop:
// [B*H, ceil(L/block)*block, 3*block] of 0/1 or null. lse: [B, H, L].
// block >= half is the geometry the two tiles are laid out in.
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
