#!/usr/bin/env python3
"""Kernel bench of the PyTorch/CUDA port (multimodaltopicsegmentation_torch) on one GPU.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every CUDA kernel from csrc/ (one nvcc each) and the native audio
loader (csrc/audio_native.cpp, g++), all started together, then holds each
kernel to its plain PyTorch version on the card at the shapes the main paths
give it and times it alone: `ms` is one wrapper call with the host's gaps
before its launch, `device_ms` device time alone; beside them the floors,
the plain version's time and one PyTorch call computing the same function.
The kernels are K1 (instance norm + GELU), K2 (banded flash attention
forward), K6 (fused local attention), the flash backward K4 (dq), K5 (dq +
dbias; two calls must give the same bits) and K3 (dk, dv), and the 3xTF32
dense layer (linear_tf32x3) at the six main-path shapes of wav2vec2-base and
of WavLM-Large and the feature stack's channels-last conv (conv_tf32x3) at
conv layers 1, 4 and 5 of a 256-row chunk and conv layer 1 of a 32-row tail,
both against float64, and the stack's three kernels around it: conv layer 0
(first_conv), the transposing pass of K1's output (channels_last) and the
per-frame LayerNorm + GELU (layer_norm_gelu) at every frame count of a chunk. K2, K4 and K3 are also held, untimed, to
their plain versions at the shapes two ranks of the parallel layer give them;
the four differentiable flash entries' gradients are held to the plain
path's.

The floors: `bound` is the float32 CUDA-core floor (bytes at the HBM rate
against operations at 67 TFLOP/s); the 3xTF32 tensor-core floor and the
operation and byte counts are the benchmark's own
(benchmark/mtsbench/roofline.py). Any failure exits non-zero, and no result
line is printed. The line before the last is a JSON object with one entry
per kernel; the last line is {"ok": true, "device": {...}}. Working files go
to build/chip_smoke/.

Whole paths on the card are checked by the `cuda`-marked tests
(`python -m pytest tests/test_torch_*.py -m cuda`) and measured by the
benchmark (`benchmark/run.py`).

`python3 chip_smoke.py --no-key-rows` times K2 as built against a build
whose tile product does every row that sees no key
(`-DMTS_NO_KEY_SHORTCUTS=0`), and prints the times as one JSON object.
`python3 chip_smoke.py --linear` runs only the check and the timings of the
dense layer after the build and prints them as one JSON object.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "benchmark"))
from mtsbench.roofline import (HBM_BYTES_PER_S, banded_bytes, banded_pairs,  # noqa: E402
                               banded_work, floor_s, k1_bytes)

WORK = os.path.join(ROOT, "build", "chip_smoke")
# kernel checks: one batch of 8 padded to 3600 units, a zero-length and a full row
CHECK_LENGTHS = (3600, 0, 3100, 2500, 2048, 1500, 900, 400)
FLASH_SOURCE = "multimodaltopicsegmentation_torch/csrc/flash_local_attention.cu"
FLASH_BWD_SOURCE = "multimodaltopicsegmentation_torch/csrc/flash_local_attention_bwd.cu"
PALLAS = "multimodaltopicsegmentation_tpu/ops/pallas_attention.py"
# the parallel shapes: ten training documents (each buckets to 3600) over two ranks
TRAIN_UNITS = (3600, 3600, 3400, 3100, 2900, 2500, 2100, 3600, 3300, 2800)
PARALLEL_RANKS = 2
# H100 SXM data sheet: float32 CUDA-core peak (dense)
FP32_FLOP_PER_S = 67e12
# about 1 ms of a 1.98 GHz clock: longer than a wrapper's host time per call
SPIN_CYCLES = 2_000_000


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=20, warmup=3, spin=False):
    """Median of `iters` CUDA-event timings of fn(): the wrapper's host time
    before its launches (checks, allocations) counts as a gap on the card.
    spin=True gives device time: a spin kernel queued before the first event
    keeps the card busy while the host queues the events and fn's launches."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def bound(bytes_moved, ops):
    """-> (bound_ms, bound_by): the larger of bytes over the HBM rate and
    float32 operations over the CUDA-core peak."""
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def ptxas_summary(nvcc_log):
    """-> ["kernel<NC>: N registers, S bytes spilled", ...] from `-Xptxas -v`."""
    out, name, spill = [], "?", ""
    for ln in nvcc_log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            k = re.search(r"\d([a-z]\w*?_kernel)(?:ILi(\d+)E)?", m.group(1))
            name = (k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "")) if k else m.group(1)
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(f"{name}: {m.group(1)} registers, {spill or 0} bytes spilled")
    return out


def check_instance_norm_gelu(dev):
    """K1 at the main-path shape: one 256-row chunk of wav2vec2-base conv
    layer 0 output, [256, 512, 3199] f32."""
    import torch
    import torch.nn.functional as F

    from multimodaltopicsegmentation_torch.ops import instance_norm_gelu as K

    B, C, T = 256, 512, 3199
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, C, T, device=dev, generator=g)
    scale = 1.0 + 0.1 * torch.randn(C, device=dev, generator=g)
    bias = 0.1 * torch.randn(C, device=dev, generator=g)
    # ragged rows, a zero-length (padding) row and a full one; rows of a
    # handful of frames, whose near-zero variance scales values into the
    # hundreds, are left to tests/test_torch_instance_norm_gelu.py (-m cuda)
    ragged = torch.randint(16, T + 1, (B,), device=dev, generator=g, dtype=torch.int32)
    ragged[:2] = torch.tensor([0, T], dtype=torch.int32)
    x[0] = 0.0  # a zero-length row holds zeros, as bucket_rows pads it
    err = 0.0
    for lengths in (ragged, None):
        got = K.instance_norm_gelu(x, scale, bias, lengths)
        torch.cuda.synchronize()
        want = K.instance_norm_gelu_reference(x, scale, bias, lengths)
        # summation order and erff against torch's erf
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        err = max(err, (got - want).abs().max().item())
        del got, want

    # the main path's rows are whole 1-second units
    full = torch.full((B,), T, device=dev, dtype=torch.int32)
    ms = time_ms(lambda: K.instance_norm_gelu(x, scale, bias, full))
    device_ms = time_ms(lambda: K.instance_norm_gelu(x, scale, bias, full), spin=True)
    plain_ms = time_ms(lambda: K.instance_norm_gelu_reference(x, scale, bias, full))
    library_ms = time_ms(lambda: F.gelu(F.group_norm(x, C, scale, bias, 1e-5)))
    n = B * C * T
    bytes_moved = k1_bytes(B, C, T)  # x read, out written, params, lengths
    # per element: sum, squared deviation (2), normalise + affine (2),
    # GELU (scale, erf counted as one, add, two products: 5)
    ops = 10 * n
    bound_ms, bound_by = bound(bytes_moved, ops)
    log(f"[K1 instance_norm_gelu] [{B}, {C}, {T}] f32: max_abs_err {err:.3e} (atol/rtol 1e-4); "
        f"kernel {ms:.4f} ms ({device_ms:.4f} ms device time), bound {bound_ms:.4f} ms "
        f"({bound_by}), plain {plain_ms:.4f} ms, F.gelu(F.group_norm) {library_ms:.4f} ms")
    return {
        "name": "instance_norm_gelu",
        "route": "cuda",
        "source": "multimodaltopicsegmentation_torch/csrc/instance_norm_gelu.cu",
        "replaces": "multimodaltopicsegmentation_tpu/ops/pallas_norm.py:91",
        "max_abs_err": err,
        "ms": ms,
        "device_ms": device_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


# (name, K, N, GELU) of the encoder's dense layers: projection, Q/K/V as one,
# out_proj, intermediate_dense, output_dense
LINEARS = {"wav2vec2-base": (("projection", 512, 768, False), ("qkv", 768, 2304, False),
                             ("out_proj", 768, 768, False), ("intermediate", 768, 3072, True),
                             ("output", 3072, 768, False)),
           "WavLM-Large": (("projection", 512, 1024, False), ("qkv", 1024, 3072, False),
                           ("out_proj", 1024, 1024, False), ("intermediate", 1024, 4096, True),
                           ("output", 4096, 1024, False))}
CHUNK_ROWS, TAIL_ROWS = 256 * 49, 32 * 49  # frames of a 256-row chunk and of a 32-row tail


def check_linear_tf32x3(dev):
    """The 3xTF32 dense layer at the main path's shapes of both encoders:
    error against float64 over |x| |w|^T + |b| (one TF32 pass reads 3e-5 or
    more), device time against the 3xTF32 floor, the plain version (the same
    three products in float32 GEMMs) and F.linear in float32."""
    import torch
    import torch.nn.functional as F

    from multimodaltopicsegmentation_torch.ops import linear_tf32x3 as K

    shapes = []
    for model, linears in LINEARS.items():
        cases = [(name, CHUNK_ROWS, k, n, gelu) for name, k, n, gelu in linears]
        cases.append(("intermediate", TAIL_ROWS) + linears[3][1:])
        for name, M, Kd, N, gelu in cases:
            g = torch.Generator(device=dev).manual_seed(M + Kd + N)
            x = torch.randn(M, Kd, device=dev, generator=g)
            w = torch.randn(N, Kd, device=dev, generator=g) * Kd ** -0.5
            b = 0.1 * torch.randn(N, device=dev, generator=g)
            pair = K._operands(w)
            got = K.linear_tf32x3(x, pair, b, gelu)
            torch.cuda.synchronize()
            want = x.double() @ w.double().T + b.double()
            want = F.gelu(want) if gelu else want
            scale = x.double().abs() @ w.double().abs().T + b.double().abs()
            err = ((got.double() - want).abs() / scale).max().item()
            if err > 1e-5:
                raise RuntimeError(f"linear_tf32x3 {model} {name} [{M}, {Kd}] -> {N}: error {err:.3e}")
            del got, want, scale
            ops = 2 * M * N * Kd
            bytes_moved = 4 * (M * Kd + 2 * N * Kd + N + M * N)
            row = {"model": model, "linear": name, "M": M, "K": Kd, "N": N, "gelu": gelu,
                   "error": err,
                   "ms": time_ms(lambda: K.linear_tf32x3(x, pair, b, gelu)),
                   "device_ms": time_ms(lambda: K.linear_tf32x3(x, pair, b, gelu), spin=True),
                   "bound_ms": 1e3 * floor_s(ops, bytes_moved),
                   "plain_ms": time_ms(lambda: K.linear_tf32x3_reference(x, w, b, gelu), iters=5),
                   "library_ms": time_ms(lambda: F.gelu(F.linear(x, w, b)) if gelu
                                         else F.linear(x, w, b), spin=True)}
            row["share"] = row["bound_ms"] / row["device_ms"]
            log(f"[linear_tf32x3] {model} {name} [{M}, {Kd}] -> {N}{' + GELU' if gelu else ''}: "
                f"error {err:.3e}; kernel {row['ms']:.4f} ms ({row['device_ms']:.4f} ms device "
                f"time), 3xTF32 floor {row['bound_ms']:.4f} ms ({100 * row['share']:.1f} %), "
                f"plain {row['plain_ms']:.4f} ms, F.linear {row['library_ms']:.4f} ms")
            shapes.append(row)
            del x, w, b, pair
    main = max(shapes, key=lambda r: r["bound_ms"])
    return {"name": "linear_tf32x3", "route": "cuda",
            "source": "multimodaltopicsegmentation_torch/csrc/linear_tf32x3.cu",
            "replaces": "none (the encoders' dense layers, left to XLA in the JAX package)",
            "max_error": max(r["error"] for r in shapes),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")},
            "shapes": shapes}


# (name, rows, C_in, C_out, k, stride, output frames) of conv layers 1, 4 and 5
# over 1-s units: a 256-row chunk, and conv layer 1 of a 32-row tail bucket
CONVS = (("conv1", 256, 512, 512, 3, 2, 1600), ("conv4", 256, 512, 512, 3, 2, 200),
         ("conv5", 256, 512, 512, 2, 2, 100), ("conv1", 32, 512, 512, 3, 2, 1600))


def check_conv_tf32x3(dev):
    """The feature stack's strided conv as a channels-last 3xTF32 implicit GEMM,
    at the shapes of CONVS: error against
    float64 over the conv of |x| and |w| plus |b| (the batch read as one
    sequence, as the kernel reads it), device time against the 3xTF32 floor,
    the plain version (the same three products over the unfolded columns) and
    cuDNN's float32 F.conv1d on [B, C, T], the layout the stack had."""
    import torch
    import torch.nn.functional as F

    from multimodaltopicsegmentation_torch.ops import conv_tf32x3 as K

    shapes = []
    for name, B, c_in, c_out, k, s, P in CONVS:
        g = torch.Generator(device=dev).manual_seed(B + P + k)
        x = torch.randn(B, s * P, c_in, device=dev, generator=g)
        w = torch.randn(c_out, c_in, k, device=dev, generator=g) * (k * c_in) ** -0.5
        b = 0.1 * torch.randn(c_out, device=dev, generator=g)
        fused = (K.split_tf32(K.gemm_weight(w).contiguous()), k)
        got = K.conv_tf32x3(x, fused, b, s, True)
        torch.cuda.synchronize()
        flat = x.reshape(1, -1, c_in)
        want = F.gelu(K._plain(flat.double(), w.double(), b.double(), s, False))
        scale = K._plain(flat.double().abs(), w.double().abs(), b.double().abs(), s, False)
        err = ((got.reshape(1, -1, c_out).double() - want).abs() / scale).max().item()
        if err > 1e-5:
            raise RuntimeError(f"conv_tf32x3 {name} [{B}, {s * P}, {c_in}] k {k}: error {err:.3e}")
        del got, want, scale, flat
        ops = 2 * B * P * c_out * k * c_in
        bytes_moved = 4 * (B * s * P * c_in + 2 * c_out * k * c_in + c_out + B * P * c_out)
        x_nct = x.transpose(1, 2).contiguous()
        row = {"conv": name, "B": B, "frames_in": s * P, "C_in": c_in, "C_out": c_out, "k": k,
               "stride": s, "error": err,
               "ms": time_ms(lambda: K.conv_tf32x3(x, fused, b, s, True)),
               "device_ms": time_ms(lambda: K.conv_tf32x3(x, fused, b, s, True), spin=True),
               "bound_ms": 1e3 * floor_s(ops, bytes_moved),
               "plain_ms": time_ms(lambda: K.conv_tf32x3_reference(x, w, b, s, True), iters=3),
               "library_ms": time_ms(lambda: F.gelu(F.conv1d(x_nct, w, b, stride=s)), spin=True)}
        row["share"] = row["bound_ms"] / row["device_ms"]
        log(f"[conv_tf32x3] {name} [{B}, {s * P}, {c_in}] -> [{B}, {P}, {c_out}], k {k} + GELU: "
            f"error {err:.3e}; kernel {row['ms']:.4f} ms ({row['device_ms']:.4f} ms device time), "
            f"3xTF32 floor {row['bound_ms']:.4f} ms ({100 * row['share']:.1f} %), plain "
            f"{row['plain_ms']:.4f} ms, cuDNN F.conv1d [B, C, T] {row['library_ms']:.4f} ms")
        shapes.append(row)
        del x, w, b, fused, x_nct
    main = shapes[0]
    return {"name": "conv_tf32x3", "route": "cuda",
            "source": "multimodaltopicsegmentation_torch/csrc/conv_tf32x3.cu",
            "replaces": "none (the feature stack's convolutions, left to XLA in the JAX package)",
            "max_error": max(r["error"] for r in shapes),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")},
            "shapes": shapes}


def scaled_error(got, want, scale):
    return ((got.double() - want).abs() / scale).max().item()


def check_feature_stack_kernels(dev):
    """The feature stack's memory-bound kernels around conv_tf32x3, each at the
    main path's shapes of a 256-row chunk of 1-s units, against its plain
    version in float64 (channels_last: equal bits), timed against the byte
    floor at the HBM rate and one PyTorch call: conv layer 0 (first_conv,
    WavLM-Large's) against cuDNN's float32 conv alone, K1's output into the
    layout (channels_last, wav2vec2-base's) against torch's transposing copy,
    and the per-frame LayerNorm + GELU (layer_norm_gelu, WavLM-Large's, at
    each of the 7 frame counts) against F.layer_norm then F.gelu. The plain
    versions are the wrappers' CPU paths run on the card in float32."""
    import torch
    import torch.nn.functional as F

    from multimodaltopicsegmentation_torch.ops import conv_tf32x3 as K

    B, C, S, k, s, frames = 256, 512, 16000, 10, 5, 3200
    g = torch.Generator(device=dev).manual_seed(22)
    out = {}

    def entry(name, err, run, plain, library, bytes_moved, ops, **extra):
        bound_ms, bound_by = bound(bytes_moved, ops)
        row = {"name": name, "route": "cuda",
               "source": "multimodaltopicsegmentation_torch/csrc/conv_tf32x3.cu",
               "replaces": "none (the feature stack, left to XLA in the JAX package)",
               "max_error": err, "ms": time_ms(run), "device_ms": time_ms(run, spin=True),
               "plain_ms": time_ms(plain, spin=True), "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": time_ms(library, spin=True), **extra}
        row["share"] = row["bound_ms"] / row["device_ms"]
        return row

    # conv layer 0: [B, 16000] audio -> [B, 3200, 512], k 10, stride 5, + bias
    audio = torch.randn(B, S, device=dev, generator=g)
    w = torch.randn(C, 1, k, device=dev, generator=g) * k ** -0.5
    b = 0.1 * torch.randn(C, device=dev, generator=g)
    got = K.first_conv(audio, w, b, s, frames)
    torch.cuda.synchronize()
    want = K._first_conv_plain(audio.double(), w.double(), b.double(), s, frames)
    scale = K._first_conv_plain(audio.double().abs(), w.double().abs(), b.double().abs(), s,
                                frames)
    err = scaled_error(got, want, scale)
    if err > 2e-6:
        raise RuntimeError(f"first_conv [{B}, {S}] -> [{B}, {frames}, {C}]: error {err:.3e}")
    del got, want, scale
    row = entry("first_conv", err, lambda: K.first_conv(audio, w, b, s, frames),
                lambda: K._first_conv_plain(audio, w, b, s, frames),
                lambda: F.conv1d(audio[:, None], w, b, stride=s),
                4 * (B * S + C * k + C + B * frames * C), 2 * k * C * B * frames)
    log(f"[first_conv] [{B}, {S}] -> [{B}, {frames}, {C}], k {k}, stride {s}: error {err:.3e}; "
        f"kernel {row['ms']:.4f} ms ({row['device_ms']:.4f} ms device time), bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}, {100 * row['share']:.1f} %), plain "
        f"{row['plain_ms']:.4f} ms, cuDNN F.conv1d [B, C, T] {row['library_ms']:.4f} ms")
    out["first_conv"] = row
    del audio, w, b

    # K1's output [B, 512, 3199] into the padded layout [B, 3200, 512]
    T = frames - 1
    x = torch.randn(B, C, T, device=dev, generator=g)
    got = K.channels_last(x, frames)
    if not torch.equal(got, K._channels_last_plain(x, frames)):
        raise RuntimeError(f"channels_last [{B}, {C}, {T}] -> [{B}, {frames}, {C}]: not equal")
    del got
    row = entry("channels_last", 0.0, lambda: K.channels_last(x, frames),
                lambda: K._channels_last_plain(x, frames),
                lambda: x.transpose(1, 2).contiguous(), 4 * (B * C * T + B * frames * C), 0)
    log(f"[channels_last] [{B}, {C}, {T}] -> [{B}, {frames}, {C}]: equal; kernel "
        f"{row['ms']:.4f} ms ({row['device_ms']:.4f} ms device time), bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}, {100 * row['share']:.1f} %), plain "
        f"{row['plain_ms']:.4f} ms, x.transpose(1, 2).contiguous() {row['library_ms']:.4f} ms")
    out["channels_last"] = row
    del x

    # WavLM's per-frame LayerNorm + GELU after each conv layer: [B, P_i, 512]
    scale = 1.0 + 0.1 * torch.randn(C, device=dev, generator=g)
    shift = 0.1 * torch.randn(C, device=dev, generator=g)
    shapes = []
    for P in (3200, 1600, 800, 400, 200, 100, 50):
        x = torch.randn(B, P, C, device=dev, generator=g)
        got = K.layer_norm_gelu(x, scale, shift)
        torch.cuda.synchronize()
        want = K._layer_norm_gelu_plain(x.double(), scale.double(), shift.double(), 1e-5)
        # summation order and erff against torch's erf, on values of order 1
        err = (got.double() - want).abs().max().item()
        if err > 1e-5:
            raise RuntimeError(f"layer_norm_gelu [{B}, {P}, {C}]: error {err:.3e}")
        del got, want
        n = B * P * C
        # per element: sum, squared deviation (2), normalise + affine (2),
        # GELU (5), as K1
        row = entry("layer_norm_gelu", err, lambda: K.layer_norm_gelu(x, scale, shift),
                    lambda: K._layer_norm_gelu_plain(x, scale, shift, 1e-5),
                    lambda: F.gelu(F.layer_norm(x, (C,), scale, shift, 1e-5)),
                    4 * (2 * n + 2 * C), 10 * n, shape=[B, P, C])
        log(f"[layer_norm_gelu] [{B}, {P}, {C}]: max_abs_err {err:.3e}; kernel {row['ms']:.4f} "
            f"ms ({row['device_ms']:.4f} ms device time), bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}, {100 * row['share']:.1f} %), plain {row['plain_ms']:.4f} ms, "
            f"F.gelu(F.layer_norm) {row['library_ms']:.4f} ms")
        shapes.append(row)
        del x
    out["layer_norm_gelu"] = dict(shapes[0], max_error=max(r["max_error"] for r in shapes),
                                  shapes=shapes)
    return out


def sdpa_mask(lengths, L, half, dev, bias=None, block=None):
    """Additive [B, 1 or H, L, L] mask for F.scaled_dot_product_attention:
    band, prefix lengths (NEG_INF, not -inf: a zero-length row must not give
    NaN) and, with `bias`, the translation-invariant tile laid out per
    position."""
    import torch

    i = torch.arange(L, device=dev)
    off = i[None, :] - i[:, None]  # key - query
    m = torch.where(off.abs() <= half, 0.0, -1e9)[None, None]
    if bias is not None:
        col = (off + (i % block)[:, None] + block).clamp(0, 3 * block - 1)
        m = m + bias[:, (i % block)[:, None].expand(L, L), col][None]
    valid = i[None, :] < torch.tensor(lengths, device=dev)[:, None]
    return m + torch.where(valid, 0.0, -1e9)[:, None, None, :]


def check_flash_attention(dev):
    """K2 and K6 against their plain versions at the long-document path's
    shapes (whole tensors, padded rows included), and their times at each."""
    import torch
    import torch.nn.functional as F

    from multimodaltopicsegmentation_torch.ops import flash_attention as FA

    H = 8
    # (label, kernel, B, L, Dh, window, biased, scale, dropped, lengths)
    cases = [
        ("K2 Transformer layer 0", "K2", 8, 3600, 96, 240, False, True, False, CHECK_LENGTHS),
        ("K2 Transformer layer 1", "K2", 8, 3600, 96, 120, False, True, False, CHECK_LENGTHS),
        ("K2 RecurrentLongT5, biased, unscaled", "K2", 8, 3600, 64, 240, True, False, False,
         CHECK_LENGTHS),
        ("K2 RecurrentLongformer", "K2", 8, 3600, 32, 120, False, True, False, CHECK_LENGTHS),
        ("K2 with a 0/1 tile", "K2", 2, 512, 64, 240, False, True, True, (512, 100)),
        # training's shape: half 60 under a flash block of 64, so the tile's block != half
        ("K2 BiLSTMRestrictedMHA, with a 0/1 tile", "K2", 8, 3600, 32, 120, False, True, True,
         CHECK_LENGTHS),
        ("K6 Transformer layer 0", "K6", 8, 3600, 96, 240, False, True, False, CHECK_LENGTHS),
    ]
    gated = set()  # the parallel ranks' shapes: held to the plain version, not timed
    for label, B, L, window, lengths in parallel_attention_shapes():
        cases.append((f"K2 {label}", "K2", B, L, 96, window, False, True, False, lengths))
        gated.add(f"K2 {label}")
    rows = []
    for label, kernel, B, L, Dh, window, biased, scale, dropped, lengths in cases:
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(B, H, L, Dh, device=dev, generator=g) for _ in range(3))
        mask = (torch.arange(L, device=dev)[None, :]
                < torch.tensor(lengths, device=dev)[:, None]).float()
        half = window // 2
        block, nb, _ = FA._flash_geometry(L, half)
        bias = 0.1 * torch.randn(H, block, 3 * block, device=dev, generator=g) if biased else None
        drop = ((torch.rand(B * H, nb * block, 3 * block, device=dev, generator=g) < 0.9).float()
                if dropped else None)
        keep = 0.9 if dropped else 1.0
        if kernel == "K2":
            run = lambda: FA._flash_fwd(q, k, v, mask, window, bias, scale, drop, keep)  # noqa: E731
            plain = lambda: FA.flash_local_attention_reference(  # noqa: E731
                q, k, v, mask, window, bias, scale, drop, keep)
        else:
            run = lambda: (FA.fused_local_attention(q, k, v, window, mask), None)  # noqa: E731
            plain = lambda: (FA.fused_local_attention_reference(q, k, v, window, mask), None)  # noqa: E731
        out, lse = run()
        torch.cuda.synchronize()
        want_out, want_lse = plain()
        # online softmax, tile-wise summation order and expf against torch's exp
        torch.testing.assert_close(out, want_out, atol=1e-4, rtol=1e-4)
        if lse is not None:
            torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
        err = (out - want_out).abs().max().item()
        del want_lse
        if label in gated:
            log(f"[{label}] [{B}, {H}, {L}, {Dh}] f32 window {window}, lengths {list(lengths)}: "
                f"max_abs_err {err:.3e} (atol/rtol 1e-4, O and lse)")
            rows.append({"kernel": kernel, "label": label, "shape": [B, H, L, Dh],
                         "window": window, "max_abs_err": err})
            del q, k, v, out, want_out
            continue

        library_ms = None
        if not dropped:  # no one call applies a given 0/1 tile to the weights
            am = sdpa_mask(lengths, L, half, dev, bias, block)
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=am, scale=None if scale else 1.0)
            # the yardstick computes the same function on every row with a key
            for b, n in enumerate(lengths):
                torch.testing.assert_close(sdpa()[b, :, :n], want_out[b, :, :n],
                                           atol=1e-3, rtol=1e-3)
            library_ms = time_ms(sdpa, iters=5, warmup=2)
            del am
        ms = time_ms(run)
        device_ms = time_ms(run, spin=True)
        plain_ms = time_ms(plain, iters=5, warmup=2)
        bytes_moved = banded_bytes(lengths, L, half, block, H, Dh, kernel == "K2",
                                   bias.numel() if biased else 0, dropped)
        ops = banded_work(lengths, L, half, block, H, Dh)
        bound_ms, bound_by = bound(bytes_moved, ops)
        tc_ms = 1e3 * floor_s(ops, bytes_moved)
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"[{label}] [{B}, {H}, {L}, {Dh}] f32 window {window}: max_abs_err {err:.3e} "
            f"(atol/rtol 1e-4, O{'' if lse is None else ' and lse'}); kernel {ms:.4f} ms "
            f"({device_ms:.4f} ms device time), bound "
            f"{bound_ms:.4f} ms ({bound_by}: {ops / 1e9:.2f} GFLOP, {bytes_moved / 1e6:.0f} MB), "
            f"3xTF32 floor {tc_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention {lib}")
        rows.append({"kernel": kernel, "label": label, "shape": [B, H, L, Dh], "window": window,
                     "max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "bound_tc_ms": tc_ms,
                     "library_ms": library_ms})
        del q, k, v, out, want_out

    def entry(name, kernel, replaces):
        mine = [r for r in rows if r["kernel"] == kernel]
        head = mine[0]  # the Transformer's first layer, the costliest call of the path
        return {
            "name": name, "route": "cuda", "source": FLASH_SOURCE, "replaces": replaces,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": head["ms"], "device_ms": head["device_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "bound_tc_ms": head["bound_tc_ms"], "library_ms": head["library_ms"],
            "shapes": [{k: r[k] for k in r if k != "kernel"} for r in mine],
        }

    return {
        "flash_local_attention": entry(
            "flash_local_attention", "K2",
            "multimodaltopicsegmentation_tpu/ops/pallas_attention.py:433"),
        "fused_local_attention": entry(
            "fused_local_attention", "K6",
            "multimodaltopicsegmentation_tpu/ops/pallas_attention.py:104"),
    }


def no_key_rows_ab(dev):
    """`--no-key-rows`: K2 as built against a build with -DMTS_NO_KEY_SHORTCUTS=0,
    where the tile product does every row that sees no key (no column sums of
    V, no whole tiles written kGroup to a block), at the long-document shapes
    that take the shortcuts. Each build is held against the plain version,
    then timed in the order as built, tile product, tile product, as built.
    -> {shape label: {build: [(ms, device_ms), (ms, device_ms)]}}"""
    import ctypes

    import torch

    from multimodaltopicsegmentation_torch.core import cuda_build
    from multimodaltopicsegmentation_torch.ops import flash_attention as FA

    lib_path = os.path.join(WORK, f"{FA.KERNEL}_tile_product_only.so")
    nvcc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-DMTS_NO_KEY_SHORTCUTS=0",
                           "-o", lib_path, str(cuda_build.CSRC / f"{FA.KERNEL}.cu")],
                          capture_output=True, text=True, timeout=600)
    if nvcc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the tile-product build:\n{nvcc.stdout}{nvcc.stderr}")
    log(f"[build] {FA.KERNEL} -DMTS_NO_KEY_SHORTCUTS=0: "
        f"{'; '.join(ptxas_summary(nvcc.stdout + nvcc.stderr))}")
    builds = {"as built": cuda_build.load(FA.KERNEL), "tile product": ctypes.CDLL(lib_path)}
    H = 8
    cases = [  # (label, L, Dh, window, biased, scale): check_flash_attention's K2 shapes
        ("Transformer layer 0", 3600, 96, 240, False, True),
        ("Transformer layer 1", 3600, 96, 120, False, True),
        ("RecurrentLongT5, biased, unscaled", 3600, 64, 240, True, False),
        ("RecurrentLongformer", 3600, 32, 120, False, True),
    ]
    out = {}
    try:
        for label, L, Dh, window, biased, scale in cases:
            B = len(CHECK_LENGTHS)
            g = torch.Generator(device=dev).manual_seed(0)
            q, k, v = (torch.randn(B, H, L, Dh, device=dev, generator=g) for _ in range(3))
            mask = (torch.arange(L, device=dev)[None, :]
                    < torch.tensor(CHECK_LENGTHS, device=dev)[:, None]).float()
            block = FA._flash_geometry(L, window // 2)[0]
            bias = 0.1 * torch.randn(H, block, 3 * block, device=dev, generator=g) if biased else None
            want_out, want_lse = FA.flash_local_attention_reference(q, k, v, mask, window, bias,
                                                                    scale)
            run = lambda: FA._flash_fwd(q, k, v, mask, window, bias, scale)  # noqa: E731
            times = {name: [] for name in builds}
            for name in ("as built", "tile product", "tile product", "as built"):
                cuda_build._loaded[FA.KERNEL] = builds[name]
                got_out, got_lse = run()
                torch.testing.assert_close(got_out, want_out, atol=1e-4, rtol=1e-4)
                torch.testing.assert_close(got_lse, want_lse, atol=1e-4, rtol=1e-4)
                times[name].append((time_ms(run), time_ms(run, spin=True)))
            text = "; ".join(f"{name} " + ", ".join(f"{ms:.4f} ({dms:.4f} device)" for ms, dms in t)
                             for name, t in times.items())
            log(f"[no-key rows] K2 {label} [{B}, {H}, {L}, {Dh}] window {window}: ms {text}")
            out[label] = times
            del q, k, v, want_out, want_lse, got_out, got_lse
    finally:
        cuda_build._loaded[FA.KERNEL] = builds["as built"]
    return out


def check_flash_backward(dev):
    """K4, K5 and K3 against their plain versions at the training path's
    shapes: whole tensors, ragged lengths with a zero-length row, a non-zero
    cotangent on padded rows, K5 twice with the same bits; and their times
    beside the bound, the plain version and autograd through
    scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F

    from multimodaltopicsegmentation_torch.ops import flash_attention as FA

    H = 8
    # (label, B, L, Dh, window, biased, scale, dropped, lengths)
    cases = [
        ("Transformer layer 0", 8, 3600, 96, 240, False, True, False, CHECK_LENGTHS),
        ("Transformer layer 1", 8, 3600, 96, 120, False, True, False, CHECK_LENGTHS),
        ("RecurrentLongT5, biased, unscaled", 8, 3600, 64, 240, True, False, False, CHECK_LENGTHS),
        ("RecurrentLongformer", 8, 3600, 32, 120, False, True, False, CHECK_LENGTHS),
        ("with a 0/1 tile", 2, 512, 64, 240, False, True, True, (512, 100)),
        ("biased, unscaled, with a 0/1 tile", 2, 512, 64, 240, True, False, True, (512, 100)),
        # the dropped entries' training shape: half 60 under a flash block of 64
        ("BiLSTMRestrictedMHA, with a 0/1 tile", 8, 3600, 32, 120, False, True, True,
         CHECK_LENGTHS),
    ]
    gated = set()  # the parallel ranks' shapes: held to the plain versions, not timed
    for label, B, L, window, lengths in parallel_attention_shapes():
        cases.append((label, B, L, 96, window, False, True, False, lengths))
        gated.add(label)
    rows = []
    for label, B, L, Dh, window, biased, scale, dropped, lengths in cases:
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v, do = (torch.randn(B, H, L, Dh, device=dev, generator=g) for _ in range(4))
        if not scale:
            # unscaled scores of unit-variance q and k have a deviation of sqrt(Dh) = 8
            # and a one-hot softmax; the T5 blocks' projections of RMS-normed
            # activations are about half that size each
            q, k = 0.5 * q, 0.5 * k
        mask = (torch.arange(L, device=dev)[None, :]
                < torch.tensor(lengths, device=dev)[:, None]).float()
        half = window // 2
        block, nb, _ = FA._flash_geometry(L, half)
        bias = 0.1 * torch.randn(H, block, 3 * block, device=dev, generator=g) if biased else None
        drop = ((torch.rand(B * H, nb * block, 3 * block, device=dev, generator=g) < 0.9).float()
                if dropped else None)
        keep = 0.9 if dropped else 1.0
        out, lse = FA._flash_fwd(q, k, v, mask, window, bias, scale, drop, keep)
        dd = (do * out).sum(dim=-1)
        common = (q, k, v, mask, lse, do, dd, window)
        if biased:
            run_dq = lambda: FA._flash_dq_dbias(*common, bias, scale, drop, keep)  # noqa: E731
        else:
            run_dq = lambda: (FA._flash_dq(*common, scale, drop, keep), None)  # noqa: E731
        run_dkv = lambda: FA._flash_dkv(*common, bias, scale, drop, keep)  # noqa: E731
        plain_dq = lambda: FA.flash_dq_reference(*common, bias, scale, drop, keep)  # noqa: E731
        plain_dkv = lambda: FA.flash_dkv_reference(*common, bias, scale, drop, keep)  # noqa: E731
        dq, dbias = run_dq()
        dk, dv = run_dkv()
        torch.cuda.synchronize()
        want_dq, want_dbias = plain_dq()
        want_dk, want_dv = plain_dkv()
        # tile-wise summation order and expf against torch's exp
        errs = {}
        for name, got, want in (("dq", dq, want_dq), ("dbias", dbias, want_dbias),
                                ("dk", dk, want_dk), ("dv", dv, want_dv)):
            if want is not None:
                torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
                errs[name] = (got - want).abs().max().item()
        for b, n in enumerate(lengths):  # padded query rows: zero dq whatever their cotangent
            if dq[b, :, n:].any():
                raise RuntimeError(f"{label}: dq is not zero on the padded rows of batch row {b}")
        del want_dq, want_dk, want_dv
        if label in gated:
            log(f"[K4 and K3 {label}] [{B}, {H}, {L}, {Dh}] f32 window {window}, lengths "
                f"{list(lengths)}: max_abs_err dq {errs['dq']:.3e}, dk {errs['dk']:.3e}, "
                f"dv {errs['dv']:.3e} (atol/rtol 1e-4)")
            for kernel, keys in (("K4", ("dq",)), ("K3", ("dk", "dv"))):
                rows.append({"kernel": kernel, "label": label, "shape": [B, H, L, Dh],
                             "window": window, "max_abs_err": max(errs[k] for k in keys)})
            del q, k, v, do, out, dq, dk, dv
            continue
        scratch = 0
        if biased:
            # the bytes of the scratch of dS slabs that the first call allocated
            scratch = FA._flash_dq_dbias.scratch_bytes
            # K5's dbias is summed in a fixed order: a second call gives the same bits. That call's
            # scratch starts as NaN, so a reduce that read an entry no block stored fails here too:
            # the allocator hands the second call's dq and scratch the blocks of the same sizes
            # freed just before it, and the run checks that the scratch got the NaN-filled one.
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            spare = torch.empty_like(q)
            poison = torch.full((scratch // 4,), float("nan"), device=dev)
            poisoned = poison.data_ptr()
            del spare, poison
            again_dq, again_dbias = run_dq()
            torch.cuda.synchronize()
            if FA._flash_dq_dbias.scratch_ptr != poisoned:
                raise RuntimeError(f"{label}: the second K5 call's scratch did not start as NaN")
            if not (torch.equal(again_dq, dq) and torch.equal(again_dbias, dbias)):
                raise RuntimeError(f"{label}: two K5 calls differ in dq or dbias")
            del again_dq, again_dbias

        library_ms = None
        if not dropped:  # no one call applies a given 0/1 tile to the weights
            am = sdpa_mask(lengths, L, half, dev, bias, block)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = F.scaled_dot_product_attention(*leaves, attn_mask=am, scale=None if scale else 1.0)
            do_valid = do * mask[:, None, :, None]
            lib = lambda: torch.autograd.grad(o, leaves, do_valid, retain_graph=True)  # noqa: E731
            # the yardstick computes the same gradients on every row with a key
            for got, want in zip(lib(), (dq, dk, dv)):
                for b, n in enumerate(lengths):
                    torch.testing.assert_close(got[b, :, :n], want[b, :, :n], atol=1e-3, rtol=1e-3)
            library_ms = time_ms(lib, iters=5, warmup=2)
            del am, o, leaves
        n = B * H * L
        valid = H * sum(min(m, L) for m in lengths)
        pairs = H * banded_pairs(lengths, L, half)
        # what THESE lengths need: q, k, v, dO, lse and D of the rows below the
        # length, the lengths, the bias tile, one 0/1 entry per pair
        reads = (4 * Dh + 2) * valid * 4 + B * 4 + (bias.numel() * 4 if biased else 0) \
            + (pairs * 4 if dropped else 0)
        for kernel, run, plain, grads, flop, err_keys in (
                ("K5" if biased else "K4", run_dq, plain_dq, 1, 6, ("dq", "dbias")),
                ("K3", run_dkv, plain_dkv, 2, 8, ("dk", "dv"))):
            ms = time_ms(run)
            device_ms = time_ms(run, spin=True)
            plain_ms = time_ms(plain, iters=5, warmup=2)
            # the gradients are written on every row (zeros past the length), dbias once
            bytes_moved = reads + grads * n * Dh * 4 + (bias.numel() * 4 if kernel == "K5" else 0)
            ops = flop * Dh * pairs
            bound_ms, bound_by = bound(bytes_moved, ops)
            tc_ms = 1e3 * floor_s(ops, bytes_moved)
            err = max(errs[key] for key in err_keys if key in errs)
            lib_txt = "none" if library_ms is None else f"{library_ms:.4f} ms (dq, dk and dv in one call)"
            scratch_txt = "" if kernel == "K3" else (
                f"; scratch {scratch / 1e6:.1f} MB, two calls bit-identical, the second on a "
                f"NaN-filled scratch" if scratch
                else "; no scratch")
            log(f"[{kernel} {label}] [{B}, {H}, {L}, {Dh}] f32 window {window}: max_abs_err "
                f"{err:.3e} (atol/rtol 1e-4, {' and '.join(k for k in err_keys if k in errs)}"
                f"{scratch_txt}); "
                f"kernel {ms:.4f} ms ({device_ms:.4f} ms device time), "
                f"bound {bound_ms:.4f} ms ({bound_by}: {ops / 1e9:.2f} GFLOP, "
                f"{bytes_moved / 1e6:.0f} MB), 3xTF32 floor {tc_ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, "
                f"autograd through scaled_dot_product_attention {lib_txt}")
            rows.append({"kernel": kernel, "label": label, "shape": [B, H, L, Dh], "window": window,
                         "max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "bound_tc_ms": tc_ms,
                         "library_ms": library_ms,
                         **({} if kernel == "K3" else {"scratch_bytes": scratch})})
        del q, k, v, do, out, dq, dk, dv

    def entry(name, kernel, line):
        mine = [r for r in rows if r["kernel"] == kernel]
        head = mine[0]  # the first, full-width shape of the training path that runs it
        return {
            "name": name, "route": "cuda", "source": FLASH_BWD_SOURCE,
            "replaces": f"{PALLAS}:{line}",
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": head["ms"], "device_ms": head["device_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "bound_tc_ms": head["bound_tc_ms"], "library_ms": head["library_ms"],
            "shapes": [{k: r[k] for k in r if k != "kernel"} for r in mine],
        }

    return {"flash_local_dq": entry("flash_local_dq", "K4", 239),
            "flash_local_dq_dbias": entry("flash_local_dq_dbias", "K5", 279),
            "flash_local_dkv": entry("flash_local_dkv", "K3", 324)}


def check_autograd_entries(dev):
    """Gradients of sum(sin(O) * W) through each of the four differentiable
    entries on the card against the plain forward and backward, the dropped
    ones with the tile that the same generator state draws."""
    import torch

    from multimodaltopicsegmentation_torch.ops import flash_attention as FA

    B, H, L, Dh, window, rate, seed = 2, 8, 512, 64, 240, 0.1, 11
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v, w = (torch.randn(B, H, L, Dh, device=dev, generator=g) for _ in range(4))
    q, k = 0.5 * q, 0.5 * k
    mask = (torch.arange(L, device=dev)[None, :] < torch.tensor((512, 100), device=dev)[:, None]).float()
    block, nb, _ = FA._flash_geometry(L, window // 2)
    bias0 = 0.1 * torch.randn(H, block, 3 * block, device=dev, generator=g)
    for name, biased, dropped in (("flash_local_attention", False, False),
                                  ("flash_local_attention_biased", True, False),
                                  ("flash_local_attention_dropped", False, True),
                                  ("flash_local_attention_biased_dropped", True, True)):
        tq, tk, tv, tb = (t.clone().requires_grad_() for t in (q, k, v, bias0))
        gen = torch.Generator(device=dev).manual_seed(seed)
        if biased and dropped:
            o = FA.flash_local_attention_biased_dropped(tq, tk, tv, mask, tb, gen, window, rate)
        elif biased:
            o = FA.flash_local_attention_biased(tq, tk, tv, mask, tb, window)
        elif dropped:
            o = FA.flash_local_attention_dropped(tq, tk, tv, mask, gen, window, rate)
        else:
            o = FA.flash_local_attention(tq, tk, tv, mask, window)
        (torch.sin(o) * w).sum().backward()
        torch.cuda.synchronize()

        bias, scale = (bias0, False) if biased else (None, True)
        tile, keep = None, 1.0
        if dropped:
            again = torch.Generator(device=dev).manual_seed(seed)
            tile, keep = FA._drop_mask(again, rate, B, H, nb, block, dev), 1.0 - rate
        out, lse = FA.flash_local_attention_reference(q, k, v, mask, window, bias, scale, tile, keep)
        do = torch.cos(out) * w
        dd = (do * out).sum(dim=-1)
        want_dq, want_dbias = FA.flash_dq_reference(q, k, v, mask, lse, do, dd, window, bias, scale,
                                                    tile, keep)
        want_dk, want_dv = FA.flash_dkv_reference(q, k, v, mask, lse, do, dd, window, bias, scale,
                                                  tile, keep)
        err = 0.0
        for got, want in ((tq.grad, want_dq), (tk.grad, want_dk), (tv.grad, want_dv),
                          (tb.grad, want_dbias)):
            if want is None:
                if got is not None:
                    raise RuntimeError(f"{name}: a gradient for a bias it was not given")
                continue
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
            err = max(err, (got - want).abs().max().item())
        log(f"[autograd {name}] [{B}, {H}, {L}, {Dh}] window {window}: gradients against the plain "
            f"path, max_abs_err {err:.3e} (atol/rtol 1e-4)")


def parallel_attention_shapes():
    """(label, B, L, window, lengths) of the attention calls that two ranks
    of the parallel layer make in the Transformer's two layers (windows 240
    and 120, Dh 96) over one global batch of the ten TRAIN_UNITS documents,
    for the kernel checks: a sequence shard's window [left halo | 1800 |
    right halo] on the line, where rank 1 has a left halo of window/2 only
    and the prefix lengths clamp(length - (1800 - window/2), 0, 1800 +
    window/2); a pipeline microbatch (one document); a data-parallel share
    (rank 1's five documents); a tensor-parallel rank (mesh data 1 x model 2:
    each model rank attends over the whole ten-document batch)."""
    Ls = 3600 // PARALLEL_RANKS
    shapes = []
    for window in (240, 120):
        half = window // 2
        prefix = tuple(min(max(n - (Ls - half), 0), Ls + half) for n in TRAIN_UNITS)
        shapes += [(f"sequence shard 1, window {window}", len(TRAIN_UNITS), Ls + half, window,
                    prefix),
                   (f"pipeline microbatch, window {window}", 1, 3600, window,
                    (TRAIN_UNITS[2 if window == 240 else 6],)),
                   (f"data-parallel share 1, window {window}", 5, 3600, window,
                    TRAIN_UNITS[5:]),
                   (f"tensor-parallel rank, window {window}", len(TRAIN_UNITS), 3600, window,
                    TRAIN_UNITS)]
    return shapes


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 1
    from multimodaltopicsegmentation_torch.core import cuda_build
    from multimodaltopicsegmentation_torch.core.torch_setup import resolve_device

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    dev = resolve_device("cuda")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    t0 = time.perf_counter()
    for name, (secs, nvcc_log) in cuda_build.build_all(cuda_build.KERNELS
                                                       + cuda_build.HOST_LIBRARIES).items():
        what = (f"{cuda_build._cxx()} {' '.join(cuda_build.host_flags())}"
                if name in cuda_build.HOST_LIBRARIES else "; ".join(ptxas_summary(nvcc_log)))
        log(f"[build] {name}: {secs:.2f} s; {what}")
    if sys.argv[1:] == ["--no-key-rows"]:
        log(json.dumps({"no_key_rows": no_key_rows_ab(dev)}))
        return 0
    if sys.argv[1:] == ["--linear"]:
        log(json.dumps({"linear_tf32x3": check_linear_tf32x3(dev)}))
        return 0
    t = time.perf_counter()
    results = {"instance_norm_gelu": check_instance_norm_gelu(dev)}
    results.update(check_flash_attention(dev))
    results.update(check_flash_backward(dev))
    check_autograd_entries(dev)
    results["linear_tf32x3"] = check_linear_tf32x3(dev)
    results["conv_tf32x3"] = check_conv_tf32x3(dev)
    results.update(check_feature_stack_kernels(dev))
    log(f"[kernels] against their plain versions: {time.perf_counter() - t:.1f} s")
    log(f"[total] {time.perf_counter() - t0:.1f} s on {smi}")
    log(json.dumps({"kernels": list(results.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
