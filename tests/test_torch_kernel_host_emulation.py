"""The CUDA sources of kernels K2, K6 (`csrc/flash_local_attention.cu`), K4,
K5 and K3 (`csrc/flash_local_attention_bwd.cu`) compiled for the host and run
on the CPU against their plain versions.

A CUDA kernel has no interpret mode, so this test gives the sources one: a
small shim maps each CUDA thread to a `std::thread`, `__syncthreads` and the
warp collectives to barriers, `mma.sync.m16n8k8` (tf32) and `ldmatrix` to
per-warp exchanges of fragments and row addresses, and the `cp.async`
wrappers of `csrc/tf32x3.cuh` to plain copies; shared memory starts as NaNs,
so a read of a location the kernel never filled shows. The sources are built
with `g++ -std=c++20` and called through ctypes on CPU tensors at small
shapes (tile edges, head dims that are no multiple of 8, windows 0 and 2,
zero-length rows, groups of tiles whose rows see no key, bias and 0/1
tiles). What this can show: fragment layouts, indexing, masking and the
staging of every tile. What it cannot: timing, races between asynchronous
copies and their readers, and the device compiler's verdict; those are the
card's (`chip_smoke.py`, the `cuda`-marked tests).
"""
import ctypes
import math
import re
import shutil
import subprocess

import pytest
import torch

from multimodaltopicsegmentation_torch.core import cuda_build
from multimodaltopicsegmentation_torch.ops import flash_attention as FA

SHIM = r'''// Host emulation of the CUDA subset the kernels use: one std::thread per CUDA
// thread, barriers for __syncthreads / warp collectives, mma emulated per warp.
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>
#include <algorithm>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n)
#define __restrict__

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
template <class F>
inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }

struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline float __expf(float x) { return std::exp(x); }

namespace emu {
struct D3 { unsigned x = 0, y = 0, z = 0; };
struct Warp {
  std::barrier<> bar{32};
  float f[32][10];
  uint32_t u[32][10];
  const float* p[32];
};
struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<Warp>> warps;
  std::vector<float> smem;
  std::atomic<int> flag{0};
};
inline thread_local D3 tl_thread, tl_block, tl_dim;
inline thread_local Block* tl_ctx = nullptr;

inline float* shared() { return tl_ctx->smem.data(); }
inline Warp& warp() { return *tl_ctx->warps[tl_thread.x / 32]; }
inline int lane() { return tl_thread.x % 32; }

template <class F, class... A>
void launch(F f, unsigned grid, unsigned threads, size_t bytes, A... args) {
  for (unsigned b = 0; b < grid; ++b) {
    Block blk;
    blk.bar = std::make_unique<std::barrier<>>(threads);
    for (unsigned w = 0; w < (threads + 31) / 32; ++w) blk.warps.emplace_back(new Warp());
    blk.smem.assign(bytes / 4 + 16, std::nanf(""));  // garbage: NaN
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        tl_thread.x = t; tl_block.x = b; tl_dim.x = threads; tl_ctx = &blk;
        f(args...);
      });
    for (auto& t : ts) t.join();
  }
}
}  // namespace emu

#define threadIdx (emu::tl_thread)
#define blockIdx (emu::tl_block)
#define blockDim (emu::tl_dim)

inline void __syncthreads() { emu::tl_ctx->bar->arrive_and_wait(); }
inline int __syncthreads_or(int v) {
  auto* b = emu::tl_ctx;
  b->bar->arrive_and_wait();
  if (v) b->flag.fetch_or(1);
  b->bar->arrive_and_wait();
  int r = b->flag.load();
  b->bar->arrive_and_wait();
  if (emu::tl_thread.x == 0) b->flag.store(0);
  return r;
}
inline void __syncwarp() { emu::warp().bar.arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  auto& w = emu::warp();
  int l = emu::lane();
  w.f[l][0] = v;
  w.bar.arrive_and_wait();
  float r = w.f[l ^ o][0];
  w.bar.arrive_and_wait();
  return r;
}
'''

# the bodies of the PTX wrappers of tf32x3.cuh
PTX = r'''// emulated bodies of the PTX wrappers of tf32x3.cuh
namespace mts {
inline void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  auto& w = emu::warp();
  int l = emu::lane();
  for (int i = 0; i < 4; ++i) w.u[l][i] = a[i];
  for (int i = 0; i < 2; ++i) w.u[l][4 + i] = b[i];
  w.bar.arrive_and_wait();
  int g = l >> 2, t = l & 3;
  auto A = [&](int r, int k) { return __uint_as_float(w.u[(r % 8) * 4 + (k % 4)][(r / 8) + 2 * (k / 4)] & 0xffffe000u); };
  auto B = [&](int k, int n) { return __uint_as_float(w.u[n * 4 + (k % 4)][4 + k / 4] & 0xffffe000u); };
  int rows[4] = {g, g, g + 8, g + 8};
  int cols[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
  float out[4];
  for (int e = 0; e < 4; ++e) {
    double s = 0;
    for (int k = 0; k < 8; ++k) s += (double)A(rows[e], k) * (double)B(k, cols[e]);
    out[e] = (float)((double)c[e] + s);
  }
  w.bar.arrive_and_wait();
  for (int e = 0; e < 4; ++e) c[e] = out[e];
}
inline void ldsm4(uint32_t (&r)[4], const float* row) {
  auto& w = emu::warp();
  int l = emu::lane();
  w.p[l] = row;
  w.bar.arrive_and_wait();
  int g = l >> 2, t = l & 3;
  for (int i = 0; i < 4; ++i) r[i] = __float_as_uint(w.p[8 * i + g][t]);
  w.bar.arrive_and_wait();
}
inline void cp_async16(float* dst, const float* src, bool valid) {
  if (valid) std::memcpy(dst, src, 16); else std::memset(dst, 0, 16);
}
inline void cp_async4(float* dst, const float* src, bool valid) {
  if (valid) std::memcpy(dst, src, 4); else std::memset(dst, 0, 4);
}
inline void cp_async_commit() {}
template <int n>
inline void cp_async_wait() {}
}  // namespace mts
'''


def _split_args(text):
    out, depth, cur = [], 0, ""
    for ch in text:
        depth += ch in "(<[" and 1 or (ch in ")>]" and -1 or 0)
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return out + [cur.strip()]


def _translate(src):
    src = src.replace("#include <cuda_runtime.h>", '#include "shim.h"')
    src = src.replace('#include "tf32x3.cuh"', '#include "tf32x3_host.cuh"')
    src = src.replace("extern __shared__ __align__(16) float smem[];", "float* smem = emu::shared();")

    def launch(m):
        cfg = _split_args(m.group(2))
        return f"emu::launch({m.group(1)}, {cfg[0]}, {cfg[1]}, {cfg[2]}, {m.group(3)});"

    return re.sub(r"([\w:]+(?:<[\w, ]+>)?)\s*<<<(.*?)>>>\s*\((.*?)\);", launch, src, flags=re.S)


def _build(out, names, defines=()):
    """g++ builds of csrc/<name>.cu for each name, started together; -> {name: CDLL}."""
    jobs = {}
    for name in names:
        src = out / f"{name}.cpp"
        src.write_text(_translate((cuda_build.CSRC / f"{name}.cu").read_text()))
        lib = out / f"lib{name}{''.join(d.replace('=', '_') for d in defines)}.so"
        cmd = ["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-w", *defines,
               "-I", str(out), "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    for name, (_, job) in jobs.items():
        log, _ = job.communicate()
        if job.returncode != 0:
            if "barrier" in log and "No such file" in log:
                pytest.skip("the host compiler has no C++20 <barrier>")
            raise AssertionError(f"host build of {name}.cu failed:\n{log[-4000:]}")
    return {name: ctypes.CDLL(str(lib)) for name, (lib, _) in jobs.items()}


def _k2(lib):
    k2 = lib.mts_flash_local_attention_f32
    k2.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    k2.restype = ctypes.c_int
    return k2


@pytest.fixture(scope="module")
def host_dir(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels for the host")
    out = tmp_path_factory.mktemp("host_kernels")
    (out / "shim.h").write_text(SHIM)
    (out / "ptx_host.h").write_text(PTX)
    hdr = (cuda_build.CSRC / "tf32x3.cuh").read_text()
    a, b = hdr.index("// ---- PTX"), hdr.index("// ---- 3xTF32 fragments")
    hdr = hdr[:a] + '}  // namespace mts\n#include "ptx_host.h"\nnamespace mts {\n' + hdr[b:]
    (out / "tf32x3_host.cuh").write_text(hdr.replace("#include <cuda_runtime.h>", '#include "shim.h"'))
    return out


@pytest.fixture(scope="module")
def host_libs(host_dir):
    return _build(host_dir, (FA.KERNEL, FA.BWD_KERNEL))


@pytest.fixture(scope="module")
def host_kernels(host_libs):
    fwd, bwd = host_libs[FA.KERNEL], host_libs[FA.BWD_KERNEL]
    k6 = fwd.mts_fused_local_attention_f32
    k6.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    k3 = bwd.mts_flash_local_dkv_f32
    k3.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    for fn in (k6, k3):
        fn.restype = ctypes.c_int
    return _k2(fwd), k6, k3


@pytest.fixture(scope="module")
def host_dq_kernels(host_libs):
    """K4 (`mts_flash_local_dq_f32`) and K5 (`mts_flash_local_dq_dbias_f32`)."""
    bwd = host_libs[FA.BWD_KERNEL]
    k4 = bwd.mts_flash_local_dq_f32
    k4.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    k5 = bwd.mts_flash_local_dq_dbias_f32
    k5.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    for fn in (k4, k5):
        fn.restype = ctypes.c_int
    return k4, k5


@pytest.fixture(scope="module")
def host_k2_tile_product(host_dir):
    """K2 built with -DMTS_NO_KEY_SHORTCUTS=0: the tile product does every
    row that sees no key (the build `chip_smoke.py --no-key-rows` times)."""
    return _k2(_build(host_dir, (FA.KERNEL,), ("-DMTS_NO_KEY_SHORTCUTS=0",))[FA.KERNEL])


def _ptr(t):
    return None if t is None else t.data_ptr()


# (L, Dh, window, variant, lengths)
CASES = [
    (37, 8, 8, "plain", [37, 0, 3]),
    (130, 12, 8, "dropped", [130, 0, 65]),
    (65, 4, 2, "plain", [65, 64, 1]),
    (64, 32, 0, "plain", [64, 0, 10]),
    (130, 24, 16, "biased_dropped", [130, 17, 0]),
    (200, 32, 120, "dropped", [200, 0, 130]),  # half 60 under a block of 64
    (96, 96, 120, "biased", [96, 40, 0]),
    (72, 16, 4, "plain", [0, 0]),
    (100, 128, 40, "biased_dropped", [100, 20]),  # the widest head dim
    (600, 8, 8, "plain", [600, 70, 0]),  # groups of tiles whose rows see no key
]


def _case(L, Dh, window, variant, lengths):
    """-> (q, k, v, do, mask, lengths, bias, drop, scale, keep) of a case."""
    B, H = len(lengths), 2
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(B, H, L, Dh, generator=g) for _ in range(4))
    block, nb, _ = FA._flash_geometry(L, window // 2)
    mask = (torch.arange(L)[None, :] < torch.tensor(lengths)[:, None]).float()
    bias, drop, scale, keep = None, None, True, 1.0
    if variant.startswith("biased"):
        bias, scale = 0.3 * torch.randn(H, block, 3 * block, generator=g), False
        q, k = 0.5 * q, 0.5 * k
    if variant.endswith("dropped"):
        drop = (torch.rand(B * H, nb * block, 3 * block, generator=g) < 0.75).float()
        keep = 0.75
    return q, k, v, do, mask, FA._lengths(mask).contiguous(), bias, drop, scale, keep


def _run_k2(k2, q, k, v, lens, bias, drop, window, block, scale, keep):
    B, H, L, Dh = q.shape
    sc = 1.0 / math.sqrt(Dh) if scale else 1.0
    out, lse = torch.full_like(q, math.nan), torch.full((B, H, L), math.nan)
    assert k2(_ptr(q), _ptr(k), _ptr(v), _ptr(lens), _ptr(bias), _ptr(drop), _ptr(out), _ptr(lse),
              B, H, L, Dh, window // 2, block, sc, keep, None) == 0
    return out, lse


@pytest.mark.parametrize("L,Dh,window,variant,lengths", CASES)
def test_host_built_kernels_match_plain(host_kernels, L, Dh, window, variant, lengths):
    """K2 (O, lse), K6 (O) and K3 (dk, dv) on every row against the plain
    versions, atol and rtol 1e-4 as on the card; the host's mma sums in
    double, so the margin is wider here than there."""
    k2, k6, k3 = host_kernels
    q, k, v, do, mask, lens, bias, drop, scale, keep = _case(L, Dh, window, variant, lengths)
    B, H, half = len(lengths), 2, window // 2
    block = FA._flash_geometry(L, half)[0]
    want_o, want_lse = (t.contiguous() for t in FA.flash_local_attention_reference(
        q, k, v, mask, window, bias, scale, drop, keep))
    sc = 1.0 / math.sqrt(Dh) if scale else 1.0
    out, lse = _run_k2(k2, q, k, v, lens, bias, drop, window, block, scale, keep)
    torch.testing.assert_close(out, want_o, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    if variant == "plain":
        out6 = torch.full_like(q, math.nan)
        assert k6(_ptr(q), _ptr(k), _ptr(v), _ptr(lens), _ptr(out6), B, H, L, Dh, half, block,
                  None) == 0
        torch.testing.assert_close(out6, want_o, atol=1e-4, rtol=1e-4)
    dd = (do * want_o).sum(-1)
    want_dk, want_dv = FA.flash_dkv_reference(q, k, v, mask, want_lse, do, dd, window, bias, scale,
                                              drop, keep)
    dk, dv = torch.full_like(q, math.nan), torch.full_like(q, math.nan)
    assert k3(_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(want_lse), _ptr(dd), _ptr(lens),
              _ptr(bias), _ptr(drop), _ptr(dk), _ptr(dv), B, H, L, Dh, half, block, sc, keep,
              None) == 0
    torch.testing.assert_close(dk, want_dk, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(dv, want_dv, atol=1e-4, rtol=1e-4)


def _run_dq(k4, k5, q, k, v, do, lse, dd, lens, bias, drop, window, block, scale, keep):
    """K4, or K5 with a bias tile -> (dq, dbias or None). Outputs and K5's
    scratch start as NaNs: a row left unwritten, or a scratch entry that the
    reduce reads but no block stored, shows."""
    B, H, L, Dh = q.shape
    half = window // 2
    sc = 1.0 / math.sqrt(Dh) if scale else 1.0
    dq = torch.full_like(q, math.nan)
    common = (_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(dd), _ptr(lens))
    if bias is None:
        assert k4(*common, _ptr(drop), _ptr(dq), B, H, L, Dh, half, block, sc, keep, None) == 0
        return dq, None
    partial = torch.full((B, H, -(-L // FA.BWD_TILE), FA.BWD_TILE, 2 * half + 1), math.nan)
    dbias = torch.full_like(bias, math.nan)
    assert k5(*common, _ptr(bias), _ptr(drop), _ptr(dq), _ptr(partial), _ptr(dbias), B, H, L, Dh,
              half, block, sc, keep, None) == 0
    return dq, dbias


@pytest.mark.parametrize("L,Dh,window,variant,lengths", CASES)
def test_host_built_dq_kernels_match_plain(host_dq_kernels, L, Dh, window, variant, lengths):
    """K4 (K5 for the biased variants) on every row against
    `flash_dq_reference`: dq and dbias at atol and rtol 1e-4, dq exactly zero
    on the rows at or past the length, and a second call bit-identical in
    dq and dbias (the dbias sum has a fixed order)."""
    k4, k5 = host_dq_kernels
    q, k, v, do, mask, lens, bias, drop, scale, keep = _case(L, Dh, window, variant, lengths)
    block = FA._flash_geometry(L, window // 2)[0]
    want_o, want_lse = (t.contiguous() for t in FA.flash_local_attention_reference(
        q, k, v, mask, window, bias, scale, drop, keep))
    dd = (do * want_o).sum(-1)
    want_dq, want_dbias = FA.flash_dq_reference(q, k, v, mask, want_lse, do, dd, window, bias,
                                                scale, drop, keep)
    args = (q, k, v, do, want_lse, dd, lens, bias, drop, window, block, scale, keep)
    dq, dbias = _run_dq(k4, k5, *args)
    torch.testing.assert_close(dq, want_dq, atol=1e-4, rtol=1e-4)
    for b, n in enumerate(lengths):
        assert torch.equal(dq[b, :, n:], torch.zeros_like(dq[b, :, n:]))
    again_dq, again_dbias = _run_dq(k4, k5, *args)
    assert torch.equal(again_dq, dq)
    if bias is None:
        assert again_dbias is None
        return
    torch.testing.assert_close(dbias, want_dbias, atol=1e-4, rtol=1e-4)
    assert torch.equal(again_dbias, dbias)


@pytest.mark.parametrize("L,Dh,window,variant,lengths", CASES)
def test_host_built_k2_without_no_key_shortcuts_matches_plain(host_k2_tile_product, L, Dh, window,
                                                             variant, lengths):
    """K2 built with -DMTS_NO_KEY_SHORTCUTS=0 (the build `chip_smoke.py
    --no-key-rows` times against the shipped one) gives the same O and lse:
    the tile product alone is right on rows the shortcuts take."""
    q, k, v, _, mask, lens, bias, drop, scale, keep = _case(L, Dh, window, variant, lengths)
    want_o, want_lse = FA.flash_local_attention_reference(q, k, v, mask, window, bias, scale, drop,
                                                          keep)
    block = FA._flash_geometry(L, window // 2)[0]
    out, lse = _run_k2(host_k2_tile_product, q, k, v, lens, bias, drop, window, block, scale, keep)
    torch.testing.assert_close(out, want_o, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


def test_host_built_kernels_refuse_what_the_card_refuses(host_kernels, host_dq_kernels):
    """A head dim that is no multiple of 4, or a block that is no multiple of
    8, is refused with cudaErrorInvalidValue before any launch; so is K5
    without its bias tile, scratch or dbias."""
    k2, _, k3 = host_kernels
    k4, k5 = host_dq_kernels
    q = torch.zeros(1, 1, 16, 8)
    lens = torch.tensor([16], dtype=torch.int32)
    lse = torch.zeros(1, 1, 16)
    args = (_ptr(q), _ptr(q), _ptr(q), _ptr(lens), None, None, _ptr(q), _ptr(lse))
    assert k2(*args, 1, 1, 16, 6, 2, 8, 1.0, 1.0, None) != 0
    assert k2(*args, 1, 1, 16, 8, 2, 12, 1.0, 1.0, None) != 0
    assert k3(_ptr(q), _ptr(q), _ptr(q), _ptr(q), _ptr(lse), _ptr(lse), _ptr(lens), None, None,
              _ptr(q), _ptr(q), 1, 1, 16, 8, 2, 12, 1.0, 1.0, None) != 0
    dq_in = (_ptr(q), _ptr(q), _ptr(q), _ptr(q), _ptr(lse), _ptr(lse), _ptr(lens))
    assert k4(*dq_in, None, _ptr(q), 1, 1, 16, 6, 2, 8, 1.0, 1.0, None) != 0
    assert k4(*dq_in, None, _ptr(q), 1, 1, 16, 8, 2, 12, 1.0, 1.0, None) != 0
    bias = torch.zeros(1, 8, 24)
    partial = torch.zeros(1, 1, 1, 64, 5)
    dbias = torch.zeros(1, 8, 24)
    assert k5(*dq_in, _ptr(bias), None, _ptr(q), _ptr(partial), _ptr(dbias), 1, 1, 16, 6, 2, 8,
              1.0, 1.0, None) != 0
    assert k5(*dq_in, _ptr(bias), None, _ptr(q), _ptr(partial), _ptr(dbias), 1, 1, 16, 8, 2, 12,
              1.0, 1.0, None) != 0
    for missing in range(3):
        ptrs = [_ptr(bias), _ptr(partial), _ptr(dbias)]
        ptrs[missing] = None
        assert k5(*dq_in, ptrs[0], None, _ptr(q), ptrs[1], ptrs[2], 1, 1, 16, 8, 2, 8, 1.0, 1.0,
                  None) != 0
