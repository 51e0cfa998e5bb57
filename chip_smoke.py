#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (multimodaltopicsegmentation_torch) on one GPU.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. build every CUDA kernel of the predict path from csrc/ (one nvcc each,
   started together);
2. each kernel against its plain PyTorch version on the card, at the shape
   the main path gives it, with its time beside its bound, the plain
   version's time and one PyTorch call computing the same function;
3. the main path end to end: synthetic wavs, a random-weight BiLSTM
   checkpoint (embedding 768, h 256, 2 layers, FocalLoss) and the predict
   CLI with -ee on cuda under MTS_RANDOM_ENCODER_WEIGHTS=1 (random
   wav2vec2-base); the kernels' launch counts are set to 0 just before this
   run and read just after;
4. a breakdown of the main path's encode: host wall against device kernel
   time from torch.profiler, and the costliest device kernels;
5. the card against the CPU: one 20-unit document's _mean embeddings.

The line before the last is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}. Working files go to build/chip_smoke/.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SR = 16000
MAIN_SECONDS = (60.0, 150.0, 300.0)  # the main path's three documents
# H100 SXM data sheet: HBM rate, float32 peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Median of `iters` CUDA-event timings of fn()."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


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
    plain_ms = time_ms(lambda: K.instance_norm_gelu_reference(x, scale, bias, full))
    library_ms = time_ms(lambda: F.gelu(F.group_norm(x, C, scale, bias, 1e-5)))
    n = B * C * T
    bytes_moved = 2 * n * 4 + 2 * C * 4 + B * 4  # x read, out written, params, lengths
    # per element: sum, squared deviation (2), normalise + affine (2),
    # GELU (scale, erf counted as one, add, two products: 5)
    ops = 10 * n
    bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S)
    bound_by = "bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / FP32_FLOP_PER_S else "operations"
    log(f"[K1 instance_norm_gelu] [{B}, {C}, {T}] f32: max_abs_err {err:.3e} (atol/rtol 1e-4); "
        f"kernel {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
        f"F.gelu(F.group_norm) {library_ms:.4f} ms")
    return {
        "name": "instance_norm_gelu",
        "route": "cuda",
        "source": "multimodaltopicsegmentation_torch/csrc/instance_norm_gelu.cu",
        "replaces": "multimodaltopicsegmentation_tpu/ops/pallas_norm.py:91",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def write_wavs(audio_dir, seconds, seed):
    """Synthetic broadcasts: topics are carrier tones, plus noise."""
    import numpy as np

    from multimodaltopicsegmentation_torch.utils.audio import save_wav

    rng = np.random.default_rng(seed)
    os.makedirs(audio_dir)
    for d, dur in enumerate(seconds):
        n_topics = int(rng.integers(2, 6))
        edges = np.sort(rng.uniform(0, dur, n_topics - 1))
        t = np.arange(int(dur * SR)) / SR
        tone = (150.0 + 80.0 * rng.integers(0, 5, n_topics))[np.searchsorted(edges, t)]
        sig = 0.4 * np.sin(2 * np.pi * tone * t) + 0.02 * rng.standard_normal(len(t))
        save_wav(os.path.join(audio_dir, f"doc{d}.wav"), sig.astype(np.float32), SR)


def write_checkpoint(path, hyp_path, calibrate_on=None):
    """A random BiLSTM checkpoint (seed 0). With `calibrate_on`, a [units, 768]
    embedding array, the head's bias is shifted so that the median unit of it
    scores 0.5: random scores would otherwise sit all on one side of the
    threshold, and predict would find no segments or only segments."""
    import torch

    from multimodaltopicsegmentation_torch.models import registry
    from multimodaltopicsegmentation_torch.models.base import TaggerConfig
    from multimodaltopicsegmentation_torch.train import checkpoints

    cfg = TaggerConfig(embedding_dim=768, hidden_dim=256, num_layers=2, loss_fn="FocalLoss")
    tagger = registry.build("BiLSTM", cfg, torch.Generator().manual_seed(0))
    if calibrate_on is not None:
        x = torch.from_numpy(calibrate_on)[None]
        with torch.no_grad():
            scores = tagger.scores(x, torch.tensor([x.shape[1]]))
            tagger.classification.bias.sub_(scores.median())
    checkpoints.save(path, tagger.to_jax_params(), cfg, "BiLSTM")
    with open(hyp_path, "w") as f:
        f.write("Sentence encoder: wav2vec_mean\nNeural architecture: BiLSTM\n"
                "Hidden units: 256\nNumber of layers: 2\n")


def predict(tag, audio_dir, ckpt, hyp):
    from multimodaltopicsegmentation_torch.cli.predict import cli_main

    emb, exp = os.path.join(WORK, f"emb_{tag}"), os.path.join(WORK, f"exp_{tag}")
    cli_main(["-ee", "-ef", emb, "-hyp", hyp, "-model", ckpt, "-exp", exp,
              "-af", audio_dir, "-ui", "1.0", "-th", "0.5", "--device", "cuda"])
    return emb, exp


def main_path(kernels):
    """Drive the predict CLI once on cuda; -> {kernel name: launches}."""
    import numpy as np
    import torch

    seconds = MAIN_SECONDS
    write_wavs(os.path.join(WORK, "audio"), seconds, seed=0)
    write_wavs(os.path.join(WORK, "audio_warm"), (30.0,), seed=1)
    ckpt, hyp = os.path.join(WORK, "ckpt", "best_model"), os.path.join(WORK, "results.txt")
    write_checkpoint(ckpt, hyp)
    # warm-up (cuDNN, allocator), whose embeddings calibrate the checkpoint
    emb_warm, _ = predict("warm", os.path.join(WORK, "audio_warm"), ckpt, hyp)
    write_checkpoint(ckpt, hyp, np.load(os.path.join(emb_warm, "_mean", "doc0.npy")))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    emb, exp = predict("main", os.path.join(WORK, "audio"), ckpt, hyp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}

    for name, n in launches.items():
        if n == 0:
            raise RuntimeError(f"kernel {name} was not launched on the main path")
    if not os.path.exists(os.path.join(exp, "results.pkl")):
        raise RuntimeError("predict wrote no results.pkl")
    wavs = os.listdir(os.path.join(exp, "audio_segments"))
    if not wavs:
        raise RuntimeError("predict wrote no segment wavs")
    for d, dur in enumerate(seconds):
        mean = np.load(os.path.join(emb, "_mean", f"doc{d}.npy"))
        if mean.shape != (int(dur), 768) or not np.isfinite(mean).all():
            raise RuntimeError(f"doc{d}: _mean embeddings {mean.shape}, finite "
                               f"{np.isfinite(mean).all()}")
    audio_min = sum(seconds) / 60.0
    log(f"[main path] predict -ee on cuda: {audio_min:.2f} audio-min in {wall:.3f} s = "
        f"{audio_min / wall:.3f} audio-min/s (extract + decode + segment wavs); "
        f"{len(wavs)} segment wavs; launches {launches}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def breakdown(seconds=MAIN_SECONDS):
    """Where the main path's time goes: the wav2vec2 encode of the main-path
    documents alone (host clock, synchronised), and the device time inside
    it from torch.profiler; the rest of the predict wall is host work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from multimodaltopicsegmentation_torch.encoders.engine import Wav2Vec2Encoder
    from multimodaltopicsegmentation_torch.utils.audio import load_audio

    t0 = time.perf_counter()
    enc = Wav2Vec2Encoder(device="cuda")
    torch.cuda.synchronize()
    log(f"[breakdown] encoder set-up (random init on the host, copy to the card): "
        f"{time.perf_counter() - t0:.3f} s")
    docs = [load_audio(os.path.join(WORK, "audio", f"doc{d}.wav"))[0] for d in range(len(seconds))]
    bounds = [[(i * SR, (i + 1) * SR) for i in range(int(s))] for s in seconds]
    enc.encode_document(docs[0], bounds[0])  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for audio, b in zip(docs, bounds):
            enc.encode_document(audio, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device busy time: the union of the CUDA activity intervals (kernels
    # and copies), so that overlapping ones are counted once
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    busy = (f"device busy {busy_us / 1e6:.3f} s ({100 * busy_us / 1e6 / wall:.1f}% of the wall)"
            if events else "device time not measured (the profiler recorded no CUDA activity)")
    log(f"[breakdown] encode of {sum(seconds) / 60:.2f} audio-min: wall {wall:.3f} s, {busy}")
    for e in top:
        log(f"[breakdown]   {e.self_device_time_total / 1e3:9.2f} ms  {e.count:5d}x  {e.key[:90]}")


def card_vs_cpu():
    """One 20-unit document's _mean embeddings on cuda and on the cpu."""
    import numpy as np
    import torch

    from multimodaltopicsegmentation_torch.encoders.engine import Wav2Vec2Encoder
    from multimodaltopicsegmentation_torch.ops.pooling import pool
    from multimodaltopicsegmentation_torch.utils.audio import load_audio

    audio, _ = load_audio(os.path.join(WORK, "audio", "doc0.wav"))
    bounds = [(i * SR, (i + 1) * SR) for i in range(20)]
    means = []
    for device in ("cuda", "cpu"):
        frames = Wav2Vec2Encoder(device=device).encode_document(audio, bounds)
        seg = torch.from_numpy(np.repeat(np.arange(len(frames)), [len(f) for f in frames]))
        means.append(pool(torch.from_numpy(np.concatenate(frames)), seg, len(frames), "_mean"))
    err = (means[0] - means[1]).abs().max().item()
    log(f"[card vs cpu] 20-unit _mean embeddings: max_abs_err {err:.3e} (atol 1e-3)")
    if not err <= 1e-3:
        raise RuntimeError(f"card and cpu disagree: {err}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 1
    from multimodaltopicsegmentation_torch.core import cuda_build
    from multimodaltopicsegmentation_torch.core.torch_setup import resolve_device
    from multimodaltopicsegmentation_torch.ops import instance_norm_gelu as k1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    dev = resolve_device("cuda")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    os.environ["MTS_RANDOM_ENCODER_WEIGHTS"] = "1"
    os.environ.pop("MTS_WAV2VEC2_WEIGHTS", None)

    t0 = time.perf_counter()
    for name, (secs, nvcc_log) in cuda_build.build_all().items():
        regs = [ln.strip() for ln in nvcc_log.splitlines() if "registers" in ln]
        log(f"[build] {name}: {secs:.2f} s; {'; '.join(regs)}")
    kernels = {"instance_norm_gelu": k1.instance_norm_gelu}

    t = time.perf_counter()
    results = {"instance_norm_gelu": check_instance_norm_gelu(dev)}
    log(f"[phase] kernels vs plain: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches = main_path(kernels)
    log(f"[phase] main path: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    breakdown()
    log(f"[phase] breakdown: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    card_vs_cpu()
    log(f"[phase] card vs cpu: {time.perf_counter() - t:.1f} s")

    for name, r in results.items():
        r["launches"] = launches[name]
    log(f"[total] {time.perf_counter() - t0:.1f} s on {smi}")
    log(json.dumps({"kernels": list(results.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
