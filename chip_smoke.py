#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (multimodaltopicsegmentation_torch) on one GPU.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. build every CUDA kernel from csrc/ (one nvcc each) and the native audio
   loader (csrc/audio_native.cpp, g++), all started together;
2. each kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it, with its time (the wrapper's host gaps included,
   as in every earlier run) and its device time beside its float32 bound
   and, for the flash kernels, the 3xTF32 tensor-core floor, the plain
   version's time and one PyTorch call computing the same function: K1
   (instance norm + GELU), K2 (banded flash attention forward), K6 (fused
   local attention) and the flash backward K4 (dq), K5 (dq + dbias; two
   calls must give the same bits) and K3 (dk, dv); K2, K4 and K3 also at
   the shapes phase 11's ranks give them (a sequence shard's [10, 8, 1800 +
   window/2, 96] with the line exchange's prefix lengths, a pipeline
   microbatch's [1, 8, 3600, 96], a data-parallel share's [5, 8, 3600, 96]),
   held to their plain versions and not timed; then the four
   differentiable flash entries' gradients against the plain path's;
3. the audio path end to end: synthetic wavs, a random-weight BiLSTM
   checkpoint (embedding 768, h 256, 2 layers, FocalLoss) and the predict
   CLI with -ee on cuda under MTS_RANDOM_ENCODER_WEIGHTS=1 (random
   wav2vec2-base); the kernels' launch counts are set to 0 just before this
   run and read just after;
4. the long-document path: ten synthetic embedding files of up to 3600
   units, and for each of Transformer, RecurrentLongT5 and
   BiLSTMRestrictedMHA a random checkpoint at the flagship width (768, h 256,
   2 layers, 8 heads, window 120) through the predict CLI on cuda, with
   K2's count set to 0 before each run and read after it (4: two layers
   times two chunks); then K6 through local_attention(use_pallas=True);
5. a breakdown: host wall against device busy time from torch.profiler and
   the costliest device kernels, for the audio path's encode and for one
   8 x 3600 decode of each long-document tagger;
6. the training path at full width: `Trainer.fit` over a synthetic corpus of
   ten documents bucketed to 3600 units (768-dim embeddings, about 5 %
   boundaries, seed 0) for Transformer (batch 10 x 3600, hidden 256, 2
   layers, 8 heads, window 120, FocalLoss, Adam 1e-3), RecurrentLongT5,
   BiLSTMRestrictedMHA and the BiLSTM + focal replication config, with the
   backward kernels' counts set to 0 before each fit and read after it; then
   `search_threshold` and `test`; then a few Transformer steps with dropout
   0.1 and rematerialisation forced (one more K2 launch per layer, the losses
   of the same steps without it); then the train CLI end to end on the same
   corpus and the predict CLI on the checkpoint it wrote;
7. the card against the CPU: one 20-unit document's _mean embeddings, each
   long-document tagger's logits on a 400- and a 300-unit document, and each
   tagger's first-step loss and gradient norm;
8. the tagger zoo at the flagship width (embedding 768, h 256, 2 layers, 8
   heads; FocalLoss for the sigmoid heads, CrossEntropy over 2 tags for the
   CRFs; Adam 1e-3, dropout 0), with every flash counter set to 0 before it
   and required at 0 after it: the predict CLI over the ten embedding files
   for biLSTMCRF, Transformer-CRF, SimpleBiLSTM, MLP, SheikhBiLSTM and
   BiLSTMLateFusion (-ef2: a second folder of 512-dim units), SwitchBiLSTM
   refused; one profiled 8 x 3600 decode of each and the CRF loops alone;
   `Trainer.fit` on the training corpus for each zoo tagger (both Switch
   modes, BiLSTM with the cosine loss), then `search_threshold` and `test`;
   the train CLI with its default -arc biLSTMCRF and predict on its
   checkpoint; each zoo tagger card against CPU;
9. the audio front-end: three synthetic broadcasts of 60 + 150 + 300 s with
   pauses between sentences of 2-12 s, their JSON transcripts and a flat
   label file (about 10 % boundaries); the training extractor on cuda under
   MTS_RANDOM_ENCODER_WEIGHTS=1 with the default flags (energy VAD, then
   x-vector), the same with MTS_VAD_WEIGHTS naming a random CRDNN npz,
   `-ust --prosodic_feats`, and `-vd` with --mfcc, --wav2vec (K1's count set
   to 0 before it and read after it), --ecapa, --openl3 and --CREPE, each
   with its units, wall, audio-min/s and peak memory, the label files of runs
   that share a unitization required equal; `predict -ee` on a random
   prosodic BiLSTM (embedding 167); one profiled encode per encoder; each
   encoder, the energy VAD and the CRDNN card against CPU on a 30-second
   document;
10. training completeness: `Trainer(device_epochs=True)` beside the host
   loop (same seed, dropout 0.1) for Transformer and RecurrentLongT5 at the
   flagship width over 2 train batches of 5 x 3600 and 1 valid batch, 6
   epochs in windows of 3: equal decisions and losses (rtol 1e-5), the flash
   launches of every step and validation pass counted, the Transformer's
   windows enqueued under torch's sync debug mode "error" (RecurrentLongT5's
   synchronizing calls counted by caller), wall per epoch of both loops and
   one profiled window fit each; `GridTrainer` over the paper's 3 x 3
   dropout grid on the replication BiLSTM (10 x 3600, 2 epochs),
   configurations 0, 4 and 8 against serial `Trainer` runs, the grid's wall
   against serial fits', peak memory; the train CLI with `-pg` (a 2 x 2
   grid), `-de` (Transformer), `-pca` and `--infer` on the first run's
   folder, each with finite Pk / F1 / WD in results.txt.
11. the parallel layer with two ranks on the one card (gloo: more ranks
   than cards), spawned once with the kernels already built: at the
   flagship width over phase 6's corpus as one global batch of 10 x 3600,
   PARALLEL_EPOCHS steps each of data-parallel Transformer and BiLSTM fits
   (5 x 3600 a rank), `sequence_shards=2` (1800 units a rank plus halos),
   `pipeline_stages=2` (10 microbatches), expert-parallel SwitchBiLSTM
   ('lstm', domains from digit-named files), then each test decode; a
   `GridTrainer(mesh)` of 4 BiLSTM configurations; the sharded predict over
   phase 4's ten files. Each against the same run on one rank on the card
   (losses and logits at rtol 1e-4, identical tags, the grid at 1e-5, the
   predict's results.pkl equal to phase 4's), K2/K4/K3 launches counted per
   rank and step; in the same spawn, tensor parallelism over a (data 1,
   model 2) mesh: the Transformer (PARALLEL_EPOCHS steps over the same
   10 x 3600 batch) and the replication BiLSTM (the batch cut to 10 x
   TP_UNITS units: each recurrence step is one gather over the ranks), each
   with its test decode, against one rank on the card (losses, logits and
   the parameters after the last step at rtol 1e-4, identical tags), with
   the staged bytes, the collectives over "model" and the peak memory per
   rank; then a decode of phase 4's ten files through make_sharded_decode on
   that mesh, its results equal to phase 4's results.pkl; then
   `torchrun --standalone --nproc_per_node 2` on
   `train_fit -sqs 2` and `-pps 2` with phase 6's CLI flags (results.txt
   equal to phase 6's, test scores at 1e-4) and on `predict` with the
   first one's checkpoint (tags equal to one rank's), each under its own
   time limit;
12. the rest of the user surface: the native loader reads phase 9's
   broadcasts bit-equal to scipy's read (one by one and as a batch) and
   resamples a 44.1 kHz copy within 5e-3 of scipy's resample_poly;
   `predict -lgr -ee` over phase 9's corpus on cuda with the
   LogisticRegression of tests/data/logreg_prosodic_167.pkl, then `-lgr` on
   cpu over the same features (identical results.pkl and segment wavs);
   phase 3's BiLSTM and phase 4's Transformer written as reference
   Lightning checkpoints (the Transformer under HF Longformer names) and
   served through predict's converter fallback over phase 4's files
   (results.pkl equal to the port checkpoint's, K2 counted: 4); the metrics
   CLI on a synthetic experiment tree (its CSV checked, sklearn and pandas
   not imported); `load_text_dataset` on a Choi folder; `load_audio` of an
   mp3 (decoded by pygame, or JAX's error naming the missing decoder).

The line before the last is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}. Working files go to build/chip_smoke/.

`python3 chip_smoke.py --no-key-rows` runs none of the phases above after the
build: it times K2 as built against a build whose tile product does every
row that sees no key (`-DMTS_NO_KEY_SHORTCUTS=0`), and prints the times as
one JSON object.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SR = 16000
MAIN_SECONDS = (60.0, 150.0, 300.0)  # the audio path's and the front-end's three documents
# the long-document path: units per embedding file, and the taggers served
DOC_UNITS = (3600, 3600, 3100, 2500, 2048, 1500, 900, 400, 500, 300)
TAGGERS = ("Transformer", "RecurrentLongT5", "BiLSTMRestrictedMHA")
# kernel checks: one batch of 8 padded to 3600 units, a zero-length and a full row
CHECK_LENGTHS = (3600, 0, 3100, 2500, 2048, 1500, 900, 400)
FLASH_SOURCE = "multimodaltopicsegmentation_torch/csrc/flash_local_attention.cu"
FLASH_BWD_SOURCE = "multimodaltopicsegmentation_torch/csrc/flash_local_attention_bwd.cu"
PALLAS = "multimodaltopicsegmentation_tpu/ops/pallas_attention.py"
# the training path: units per document of the synthetic corpus (each buckets to
# 3600), the taggers trained, epochs per fit (Adam at 1e-3 overshoots on its first
# steps; the loss is back under its starting value within some ten steps)
TRAIN_UNITS = (3600, 3600, 3400, 3100, 2900, 2500, 2100, 3600, 3300, 2800)
TRAIN_TAGGERS = ("Transformer", "RecurrentLongT5", "BiLSTMRestrictedMHA", "BiLSTM")
TRAIN_EPOCHS = 20
# the train CLI's run of phase 6, which phase 11 repeats on two ranks with -sqs 2 and -pps 2
TRAIN_CLI_FLAGS = ("-arc", "Transformer", "-enc", "wav2vec", "-lr", "1e-3", "-hu", "256", "-nl",
                   "2", "-nh", "8", "-window", "120", "-bs", "10", "-max", "2", "-pat", "2",
                   "-loss", "FocalLoss", "-sth", "-ar", "-as", "--device", "cuda")
# flash layers per tagger: (K2 forward, K4, K5, K3) launches of one train step without remat
STEP_LAUNCHES = {"Transformer": (2, 2, 0, 2), "RecurrentLongT5": (2, 0, 2, 2),
                 "BiLSTMRestrictedMHA": (2, 2, 0, 2), "BiLSTM": (0, 0, 0, 0)}
# H100 SXM data sheet: HBM rate, float32 peak, TF32 tensor-core peak (dense)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
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


def bound_tc(bytes_moved, ops):
    """The floor of the 3xTF32 route the flash kernels take: bytes over the
    HBM rate against three TF32 tensor-core operations per float32 one."""
    return 1e3 * max(bytes_moved / HBM_BYTES_PER_S, 3 * ops / TF32_FLOP_PER_S)


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
    bytes_moved = 2 * n * 4 + 2 * C * 4 + B * 4  # x read, out written, params, lengths
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


def banded_work(lengths, L, half, block, H, Dh):
    """Float32 operations the banded attention needs for THESE lengths: 4*Dh
    per (query, valid key in band) pair, queries in the padding included, and
    one sum of V over 3*block rows for each block that holds a query with no
    valid key."""
    import numpy as np

    i = np.arange(L)
    ops = 0
    for n in lengths:
        keys = np.minimum(i + half, n - 1) - np.maximum(i - half, 0) + 1
        pairs = int(np.clip(keys, 0, None).sum())
        first_uniform = 0 if n == 0 else n + half
        blocks = 0 if first_uniform >= L else -(-L // block) - first_uniform // block
        ops += H * (4 * Dh * pairs + blocks * 3 * block * Dh)
    return ops


def banded_bytes(lengths, L, half, block, H, Dh, lse, bias_numel, dropped):
    """Bytes the banded attention forward must move for THESE lengths: q of
    the rows that see a key (below length + half), k and v of the rows below
    the length, O (and lse) written on every row, the lengths and the bias
    tile once, one 0/1 entry per (query, valid key) pair and 3*block for each
    row that sees no key, and the rows of V at or past the length that the
    three clamped blocks of such rows cover, each once."""
    import numpy as np

    i = np.arange(L)
    total = len(lengths) * 4 + bias_numel * 4
    for n in lengths:
        seen = 0 if n == 0 else min(n + half, L)  # rows that see a key
        keys = np.minimum(i + half, n - 1) - np.maximum(i - half, 0) + 1
        pairs = int(np.clip(keys, 0, None).sum())
        # the first V row of the clamped blocks around the first row that sees no key
        first_v = L if seen >= L else max(seen // block - 1, 0) * block
        total += H * 4 * (seen * Dh + 2 * n * Dh + L * Dh + (L if lse else 0)
                          + max(0, L - max(n, first_v)) * Dh)
        if dropped:
            total += H * 4 * (pairs + (L - seen) * 3 * block)
    return total


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
    gated = set()  # phase 11's shapes: held to the plain version, not timed
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
        tc_ms = bound_tc(bytes_moved, ops)
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


def write_checkpoint(path, hyp_path, calibrate_on=None, architecture="BiLSTM",
                     embedding_dim=768, encoder="wav2vec_mean"):
    """A random checkpoint (seed 0) at the flagship width: embedding 768,
    h 256, 2 layers, 8 heads, window 120, FocalLoss. With `calibrate_on`, a
    [units, embedding_dim] array, the head's bias is shifted so that the
    median unit of it scores 0.5: random scores would otherwise sit all on
    one side of the threshold, and predict would find no segments or only
    segments."""
    import torch

    from multimodaltopicsegmentation_torch.models import registry
    from multimodaltopicsegmentation_torch.models.base import TaggerConfig
    from multimodaltopicsegmentation_torch.train import checkpoints

    cfg = TaggerConfig(embedding_dim=embedding_dim, hidden_dim=256, num_layers=2, nheads=8,
                       attention_window=120, loss_fn="FocalLoss")
    tagger = registry.build(architecture, cfg, torch.Generator().manual_seed(0)).eval()
    if calibrate_on is not None:
        x = torch.from_numpy(calibrate_on)[None]
        with torch.no_grad():
            scores = tagger.scores(x, torch.tensor([x.shape[1]]))
            tagger.classification.bias.sub_(scores.median())
    checkpoints.save(path, tagger.to_jax_params(), cfg, architecture)
    with open(hyp_path, "w") as f:
        f.write(f"Sentence encoder: {encoder}\nNeural architecture: {architecture}\n"
                "Hidden units: 256\nNumber of layers: 2\n")
    return tagger


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


def write_embeddings(emb_dir, units, seed, dim=768):
    """Synthetic precomputed embeddings, one [n, dim] file per document."""
    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(emb_dir)
    for d, n in enumerate(units):
        np.save(os.path.join(emb_dir, f"doc{d}.npy"), rng.standard_normal((n, dim)).astype(np.float32))


def long_document_path(flash_fwd, fused):
    """Drive the predict CLI on cuda once per long-document tagger over ten
    embedding files (two chunks of 8 and 2 documents, padded to 3600 and 512
    units), then the fused kernel through local_attention(use_pallas=True).
    -> ({kernel name: launches}, {architecture: its random tagger})."""
    import pickle

    import numpy as np
    import torch

    from multimodaltopicsegmentation_torch.cli.predict import cli_main
    from multimodaltopicsegmentation_torch.ops.attention import local_attention

    emb, emb_warm = os.path.join(WORK, "long_emb"), os.path.join(WORK, "long_emb_warm")
    write_embeddings(emb, DOC_UNITS, seed=2)
    write_embeddings(emb_warm, (100, 70), seed=3)
    calibrate_on = np.load(os.path.join(emb, "doc7.npy"))  # the 400-unit document
    total, taggers = 0, {}
    for arch in TAGGERS:
        ckpt = os.path.join(WORK, f"ckpt_{arch}", "best_model")
        hyp = os.path.join(WORK, f"results_{arch}.txt")
        taggers[arch] = write_checkpoint(ckpt, hyp, calibrate_on, arch)
        common = ["-hyp", hyp, "-model", ckpt, "-bs", "8", "-rjs", "--device", "cuda"]
        cli_main(common + ["-ef", emb_warm, "-exp", os.path.join(WORK, f"exp_warm_{arch}")])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_fwd.launches = 0
        t0 = time.perf_counter()
        exp = os.path.join(WORK, f"exp_{arch}")
        cli_main(common + ["-ef", emb, "-exp", exp])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = flash_fwd.launches
        if n != 4:  # 2 layers x 2 chunks
            raise RuntimeError(f"{arch}: the flash kernel was launched {n} times, expected 4")
        total += n
        with open(os.path.join(exp, "results.pkl"), "rb") as f:
            results = pickle.load(f)
        for d, units in enumerate(DOC_UNITS):
            tags = results.get(f"doc{d}.npy")
            if tags is None or len(tags) != units or set(tags) - {0, 1}:
                raise RuntimeError(f"{arch}: doc{d} got {None if tags is None else len(tags)} "
                                   f"tags for {units} units")
        found = sum(sum(t) for t in results.values())
        if not 0 < found < sum(DOC_UNITS):
            raise RuntimeError(f"{arch}: {found} boundaries in {sum(DOC_UNITS)} units")
        log(f"[long path] {arch}: predict on cuda, {len(DOC_UNITS)} documents, {sum(DOC_UNITS)} "
            f"units in {wall:.3f} s = {sum(DOC_UNITS) / wall:.0f} units/s (checkpoint load + "
            f"decode); {found} boundaries; flash launches {n}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # K6's only caller, at the Transformer's first-layer shape
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(8, 3600, 8, 96, device="cuda", generator=g).transpose(1, 2)
               for _ in range(3))
    mask = (torch.arange(3600, device="cuda")[None, :]
            < torch.tensor(DOC_UNITS[:8], device="cuda")[:, None]).float()
    fused.launches = 0
    out = local_attention(q, k, v, 240, mask, use_pallas=True)
    torch.cuda.synchronize()
    if fused.launches == 0 or not torch.isfinite(out).all():
        raise RuntimeError(f"fused kernel: {fused.launches} launches, finite "
                           f"{torch.isfinite(out).all().item()}")
    log(f"[long path] local_attention(use_pallas=True) [8, 8, 3600, 96] window 240: "
        f"fused launches {fused.launches}")
    return {"flash_local_attention": total, "fused_local_attention": fused.launches}, taggers


def profiled(fn):
    """Run fn() under torch.profiler -> (host wall s, device busy s or None,
    the six costliest device kernels as (name, (ns, launches))). Device busy
    time is the union of the CUDA activity intervals (kernels and copies), so
    that overlapping ones are counted once. Both are read from the raw
    profiler events: torch's event tree, which nothing here needs, takes
    tens of seconds to build for a run of tens of thousands of launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    busy_ns, end, by_name = 0, float("-inf"), {}
    for e in sorted(device, key=lambda e: e.start_ns()):
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        busy_ns += max(0, b - max(a, end))
        end = max(end, b)
        ns, n = by_name.get(e.name(), (0, 0))
        by_name[e.name()] = (ns + e.duration_ns(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return wall, (busy_ns / 1e9 if device else None), top


def log_profile(what, wall, busy, top):
    share = (f"device busy {busy:.3f} s ({100 * busy / wall:.1f}% of the wall)" if busy is not None
             else "device time not measured (the profiler recorded no CUDA activity)")
    log(f"[breakdown] {what}: wall {wall:.3f} s, {share}")
    for name, (ns, n) in top:
        log(f"[breakdown]   {ns / 1e6:9.2f} ms  {n:5d}x  {name[:90]}")


def breakdown_taggers(taggers):
    """One decode of the first chunk's shape (8 documents padded to 3600
    units) per long-document tagger."""
    import numpy as np
    import torch

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((8, 3600, 768)).astype(np.float32)).cuda()
    lengths = torch.tensor(DOC_UNITS[:8], device="cuda")
    for arch, tagger in taggers.items():
        tagger = tagger.cuda()
        with torch.inference_mode():
            tagger.decode(x, lengths, 0.5)  # warm-up
            torch.cuda.synchronize()
            wall, busy, top = profiled(lambda: tagger.decode(x, lengths, 0.5))
        log_profile(f"{arch} decode of 8 x 3600 units", wall, busy, top)
        tagger.cpu()


def breakdown(seconds=MAIN_SECONDS):
    """Where the main path's time goes: the wav2vec2 encode of the main-path
    documents alone (host clock, synchronised), and the device time inside
    it from torch.profiler; the rest of the predict wall is host work."""
    import torch

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

    def encode():
        for audio, b in zip(docs, bounds):
            enc.encode_document(audio, b)

    log_profile(f"encode of {sum(seconds) / 60:.2f} audio-min", *profiled(encode))


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


def taggers_card_vs_cpu(taggers):
    """Each long-document tagger's logits for a 400- and a 300-unit document
    (padded to 512 units, as predict buckets them) on cuda and on the cpu."""
    import numpy as np
    import torch

    from multimodaltopicsegmentation_torch.train.data import pad_batch

    docs = [np.load(os.path.join(WORK, "long_emb", f"doc{d}.npy")) for d in (7, 9)]
    batch = pad_batch([(e, [0] * len(e), str(i)) for i, e in enumerate(docs)], crf=False,
                      bucket=True)
    x, lengths = torch.from_numpy(batch["src_tokens"]), torch.from_numpy(batch["src_lengths"])
    for arch, tagger in taggers.items():
        with torch.inference_mode():
            on_cpu = tagger.cpu().scores(x, lengths)
            on_card = tagger.cuda().scores(x.cuda(), lengths.cuda()).cpu()
        tagger.cpu()
        err = max((on_card[b, :n] - on_cpu[b, :n]).abs().max().item()
                  for b, n in enumerate(lengths.tolist()))
        log(f"[card vs cpu] {arch} logits, {lengths.tolist()} units padded to {x.shape[1]}: "
            f"max_abs_err {err:.3e} on valid units (atol 1e-3)")
        if not err <= 1e-3 or not torch.isfinite(on_card).all():
            raise RuntimeError(f"{arch}: card and cpu disagree: {err}")


def banded_pairs(lengths, L, half):
    """(query, key) pairs that carry a gradient for THESE lengths: both below
    the length and within `half` of each other."""
    import numpy as np

    total = 0
    for n in lengths:
        i = np.arange(min(n, L))
        total += int((np.minimum(i + half, n - 1) - np.maximum(i - half, 0) + 1).sum())
    return total


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
    gated = set()  # phase 11's shapes: held to the plain versions, not timed
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
            tc_ms = bound_tc(bytes_moved, ops)
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


def write_corpus(root, units, seed):
    """A synthetic training corpus on the reference's on-disk contract: one
    [n, 768] embedding file per document, topic segments with distinct mean
    vectors and about 5 % boundaries, labs_dict.pkl and a split JSON (7 train,
    1 test, 2 validation). -> (embedding dir, labels file, split file, docs)."""
    import pickle

    import numpy as np

    rng = np.random.default_rng(seed)
    emb_dir = os.path.join(root, "embeddings")
    os.makedirs(emb_dir)
    means = rng.standard_normal((16, 768)).astype(np.float32)
    labs, docs = {}, []
    for d, n in enumerate(units):
        lab = (rng.random(n) < 0.05).astype(int)
        lab[-1] = 1
        segment = np.concatenate([[0], np.cumsum(lab)[:-1]])
        topic = rng.integers(0, 16, segment[-1] + 1)
        topic[1:] = np.where(topic[1:] == topic[:-1], (topic[1:] + 1) % 16, topic[1:])
        emb = means[topic[segment]] + 0.5 * rng.standard_normal((n, 768)).astype(np.float32)
        np.save(os.path.join(emb_dir, f"doc{d}.npy"), emb)
        labs[f"doc{d}"] = lab.tolist()
        train_lab = lab.tolist()
        train_lab[-1] = 0  # as the loader zeroes it
        docs.append((emb, train_lab, f"doc{d}.npy"))
    labs_file, split_file = os.path.join(root, "labs_dict.pkl"), os.path.join(root, "split.json")
    with open(labs_file, "wb") as f:
        pickle.dump(labs, f)
    names = [f"doc{d}.npy" for d in range(len(units))]
    with open(split_file, "w") as f:
        json.dump({"train": names[:7], "test": names[7:8], "validation": names[8:]}, f)
    return emb_dir, labs_file, split_file, docs


def flash_counters():
    from multimodaltopicsegmentation_torch.ops import flash_attention as FA

    return {"flash_local_attention": FA._flash_fwd, "flash_local_dq": FA._flash_dq,
            "flash_local_dq_dbias": FA._flash_dq_dbias, "flash_local_dkv": FA._flash_dkv}


def training_config():
    from multimodaltopicsegmentation_torch.models.base import TaggerConfig

    return TaggerConfig(embedding_dim=768, hidden_dim=256, num_layers=2, nheads=8,
                        attention_window=120, loss_fn="FocalLoss", alpha=0.9, gamma=2.0)


def timed_fit(trainer, train_batches):
    """`trainer.fit(train_batches)` with each step timed by CUDA events.
    -> (params, history, wall s, steps, step ms: the median of steps 3 on,
    peak device memory GiB)."""
    import torch

    step, events = trainer._train_step, []

    def timed(batch):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        loss = step(batch)
        e1.record()
        events.append((e0, e1))
        return loss

    trainer._train_step = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        params, history = trainer.fit(train_batches)
        torch.cuda.synchronize()
    finally:
        # back to the class's method: a bound method kept on its own instance
        # is a reference cycle, which would keep this trainer's device memory
        # until the garbage collector next runs, inside the next fit's peak
        del trainer._train_step
    wall = time.perf_counter() - t0
    times = sorted(e0.elapsed_time(e1) for e0, e1 in events[2:])
    return (params, history, wall, len(events), times[len(times) // 2],
            torch.cuda.max_memory_allocated() / 2**30)


def training_path(docs):
    """`Trainer.fit` at full width for each tagger over the ten-document
    corpus in one batch of 10 x 3600 units, then `search_threshold` and
    `test`. -> {kernel name: launches over the four fits}."""
    import torch

    from multimodaltopicsegmentation_torch.models import transformers as TT
    from multimodaltopicsegmentation_torch.train.data import batches
    from multimodaltopicsegmentation_torch.train.loop import Trainer, batches_to_device

    counters = flash_counters()
    total = dict.fromkeys(counters, 0)
    train_batches = list(batches(docs, 10, crf=False, truncate=True, truncate_value=3600))
    units = int(sum(b["src_lengths"].sum() for b in train_batches))
    for arch in TRAIN_TAGGERS:
        trainer = Trainer(arch, training_config(), lr=1e-3, optimizer="Adam",
                          max_epochs=TRAIN_EPOCHS, no_early_stop=True, monitor="training_loss",
                          check_dir=os.path.join(WORK, f"train_{arch}"), seed=0, device="cuda")
        for c in counters.values():
            c.launches = 0
        params, history, wall, steps, step_ms, peak = timed_fit(trainer, train_batches)
        launches = {name: c.launches for name, c in counters.items()}
        step = trainer._train_step
        remat = [m.last_remat for m in trainer.tagger.modules()
                 if isinstance(m, (TT.BertStyleEncoder, TT.LongT5Encoder))]
        fwd, dq, dqb, dkv = STEP_LAUNCHES[arch]
        if any(remat):
            if not all(remat):
                raise RuntimeError(f"{arch}: remat chosen for some encoder stacks only: {remat}")
            fwd *= 2  # the recomputation runs the forward kernel once more
        want = dict(zip(counters, (steps * fwd, steps * dq, steps * dqb, steps * dkv)))
        if launches != want:
            raise RuntimeError(f"{arch}: launches {launches} over {steps} steps, expected {want}")
        losses = [h["training_loss"] for h in history]
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            raise RuntimeError(f"{arch}: the training loss did not fall: {losses}")
        if not os.path.exists(trainer.best_model_path):
            raise RuntimeError(f"{arch}: no snapshot at {trainer.best_model_path}")
        for name in total:
            total[name] += launches[name]

        th, th_pk = trainer.search_threshold(params, train_batches)
        trainer.threshold = th
        results, per_doc, scores = trainer.test(params, train_batches)
        if len(per_doc) != len(docs) or not all(math.isfinite(v) for v in results.values()):
            raise RuntimeError(f"{arch}: test gave {len(per_doc)} documents, results {results}")
        per_step = {n: launches[n] // steps for n in launches}
        log(f"[train] {arch}: fit of {steps} steps of 10 x 3600 ({units} units) in {wall:.3f} s; "
            f"step {step_ms:.3f} ms (CUDA events, median of steps 3-{steps}) = "
            f"{units / step_ms * 1e3:.0f} units/s; loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
            f"remat {any(remat)}; launches per step {per_step}; peak device memory {peak:.2f} GiB; "
            f"search_threshold {th} (Pk {th_pk:.4f}); test Pk {results['test_loss']:.4f} "
            f"F1 {results['F1_loss']:.4f} WD {results['WD_loss']:.4f}")
        batch = batches_to_device(train_batches, "cuda")[0]
        t0 = time.perf_counter()
        log_profile(f"{arch} train step of 10 x 3600 units", *profiled(lambda: step(batch)))
        log(f"[train] {arch}: the profiled step with the profiler's set-up and read-out took "
            f"{time.perf_counter() - t0:.3f} s of this phase")
        del trainer, batch, step
        torch.cuda.empty_cache()
    return total


def remat_path(docs, steps=4):
    """The Transformer's train step at full width with per-layer
    rematerialisation forced on its encoder (the policy never chooses it on a
    card this size), all dropout rates 0.1 so that each checkpointed layer
    draws its 0/1 tiles again: `steps` Adam steps beside the same steps
    without remat, same seeds. One more K2 launch per layer and step, and the
    same losses. -> {kernel name: launches of both runs}."""
    import dataclasses

    import torch

    from multimodaltopicsegmentation_torch.models import registry
    from multimodaltopicsegmentation_torch.models import transformers as TT
    from multimodaltopicsegmentation_torch.train.data import batches
    from multimodaltopicsegmentation_torch.train.loop import batches_to_device, make_optimizer

    counters = flash_counters()
    total = dict.fromkeys(counters, 0)
    cfg = dataclasses.replace(training_config(), dropout_in=0.1, dropout_out=0.1)
    batch = batches_to_device(
        list(batches(docs, 10, crf=False, truncate=True, truncate_value=3600)), "cuda")[0]
    runs = {}
    for remat in (False, True):
        tagger = registry.build("Transformer", cfg, torch.Generator().manual_seed(0)).to("cuda")
        encoders = [m for m in tagger.modules() if isinstance(m, TT.BertStyleEncoder)]
        for m in encoders:
            m.remat = remat
        opt = make_optimizer("Adam", list(tagger.parameters()), 1e-3)
        generator = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        losses, events = [], []
        for _ in range(steps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            opt.zero_grad(set_to_none=True)
            loss = tagger.loss(batch["src_tokens"], batch["src_lengths"], batch["tgt_tokens"],
                               generator=generator)
            loss.backward()
            opt.step()
            e1.record()
            losses.append(loss.detach())
            events.append((e0, e1))
        torch.cuda.synchronize()
        launches = {name: c.launches for name, c in counters.items()}
        want = dict(zip(counters, (steps * (4 if remat else 2), steps * 2, 0, steps * 2)))
        if launches != want or [m.last_remat for m in encoders] != [remat]:
            raise RuntimeError(f"remat {remat}: launches {launches} over {steps} steps, expected "
                               f"{want}; encoders checkpointed: {[m.last_remat for m in encoders]}")
        for name in total:
            total[name] += launches[name]
        runs[remat] = (torch.stack(losses).tolist(), e0.elapsed_time(e1),
                       torch.cuda.max_memory_allocated() / 2**30)
        del tagger, opt
        torch.cuda.empty_cache()
    (plain_losses, plain_ms, plain_peak), (losses, ms, peak) = runs[False], runs[True]
    err = max(abs(a - b) for a, b in zip(plain_losses, losses))
    log(f"[train] Transformer with remat forced and dropout 0.1, {steps} steps of 10 x 3600: "
        f"4 K2 + 2 K4 + 2 K3 launches per step (2 + 2 + 2 without); losses {losses}, "
        f"{err:.3e} from the stored run's (first step atol 1e-6, all 1e-4); last step {ms:.3f} ms, peak device "
        f"memory {peak:.2f} GiB (stored: {plain_ms:.3f} ms, {plain_peak:.2f} GiB)")
    # the first losses come from one draw on equal weights; later ones follow Adam
    # steps on gradients that are summed in another order under recomputation
    if not (all(map(math.isfinite, losses)) and abs(plain_losses[0] - losses[0]) <= 1e-6
            and err <= 1e-4):
        raise RuntimeError(f"remat: losses {losses} against {plain_losses} without")
    return total


def train_cli_path(emb_dir, labs_file, split_file):
    """The train CLI end to end on cuda (Transformer, 2 epochs, threshold
    search), then the predict CLI on the checkpoint it wrote.
    -> {kernel name: launches}."""
    import pickle

    import torch

    from multimodaltopicsegmentation_torch.cli import predict, train_fit

    counters = flash_counters()
    for c in counters.values():
        c.launches = 0
    exp = os.path.join(WORK, "exp_train_cli")
    cwd = os.getcwd()
    t0 = time.perf_counter()
    try:
        train_fit.cli_main(["-exp", exp, "-ef", emb_dir, "-lf", labs_file, "-split", split_file,
                            *TRAIN_CLI_FLAGS])
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    with open(os.path.join(exp, "results.txt")) as f:
        txt = f.read()
    best = os.path.join(exp, "checkpoints", "best_model")
    if "Mean Pk obtained is" not in txt or not os.path.exists(best):
        raise RuntimeError(f"train_fit wrote no Pk line or no best_model under {exp}")
    # 2 epochs x 1 batch x 2 layers, forward also for the validation loss and the decodes
    want = {"flash_local_dq": 4, "flash_local_dq_dbias": 0, "flash_local_dkv": 4}
    if any(launches[n] != c for n, c in want.items()) or launches["flash_local_attention"] < 8:
        raise RuntimeError(f"train_fit: launches {launches}")
    out = os.path.join(WORK, "exp_train_predict")
    predict.cli_main(["-ef", emb_dir, "-hyp", os.path.join(exp, "results.txt"), "-model", best,
                      "-exp", out, "-bs", "8", "-rjs", "--device", "cuda"])
    with open(os.path.join(out, "results.pkl"), "rb") as f:
        results = pickle.load(f)
    for d, n in enumerate(TRAIN_UNITS):
        tags = results.get(f"doc{d}.npy")
        if tags is None or len(tags) != n or set(tags) - {0, 1}:
            raise RuntimeError(f"predict on the trained checkpoint: doc{d} got "
                               f"{None if tags is None else len(tags)} tags for {n} units")
    pk = [ln for ln in txt.splitlines() if ln.startswith("Mean Pk")][0]
    log(f"[train cli] train_fit -arc Transformer on cuda, 2 epochs of 7 documents + threshold "
        f"search + test in {wall:.3f} s; {pk}; launches {launches}; predict served the "
        f"checkpoint: {len(results)} documents")
    return launches


def training_card_vs_cpu(docs):
    """The first step's loss and gradient norm of each tagger (dropout 0, seed
    0) for a 3600- and a 2100-unit document, on cuda and on the cpu."""
    import torch

    from multimodaltopicsegmentation_torch.models import registry
    from multimodaltopicsegmentation_torch.train.data import pad_batch

    batch = pad_batch([docs[0], docs[6]], crf=False, truncate=True, truncate_value=3600)
    x, lengths, tags = (torch.from_numpy(batch[k])
                        for k in ("src_tokens", "src_lengths", "tgt_tokens"))
    for arch in TRAIN_TAGGERS:
        got = []
        for device in ("cuda", "cpu"):
            tagger = registry.build(arch, training_config(), torch.Generator().manual_seed(0))
            tagger.to(device)
            loss = tagger.loss(x.to(device), lengths.to(device), tags.to(device))
            loss.backward()
            norm = torch.sqrt(sum((p.grad * p.grad).sum() for p in tagger.parameters()))
            got.append((loss.item(), norm.item()))
        (l0, n0), (l1, n1) = got
        log(f"[card vs cpu] {arch} first step, {lengths.tolist()} units: loss {l0:.6f} on the card, "
            f"{abs(l0 - l1):.3e} from the cpu's; gradient norm {n0:.6f}, {abs(n0 - n1):.3e} from "
            f"the cpu's (atol 1e-3)")
        if not (abs(l0 - l1) <= 1e-3 and abs(n0 - n1) <= 1e-3):
            raise RuntimeError(f"{arch}: card and cpu disagree on the first step: {got}")


# -- the tagger zoo ----------------------------------------------------------------------

# the taggers that predict serves (SwitchBiLSTM needs domain ids and is refused)
ZOO_PREDICT = ("biLSTMCRF", "Transformer-CRF", "SimpleBiLSTM", "MLP", "SheikhBiLSTM",
               "BiLSTMLateFusion")
# the taggers trained: (label, architecture, config fields)
ZOO_TRAIN = (("biLSTMCRF", "biLSTMCRF", {}), ("Transformer-CRF", "Transformer-CRF", {}),
             ("BiLSTMLateFusion", "BiLSTMLateFusion", {}), ("SimpleBiLSTM", "SimpleBiLSTM", {}),
             ("MLP", "MLP", {}), ("SheikhBiLSTM", "SheikhBiLSTM", {}),
             ("SwitchBiLSTM dense", "SwitchBiLSTM", {"switch": "dense"}),
             ("SwitchBiLSTM lstm", "SwitchBiLSTM", {"switch": "lstm"}),
             ("BiLSTM -cos", "BiLSTM", {"cosine_loss": True}))
ZOO_EPOCHS = 10  # steps per zoo fit: Adam at 1e-3 is back under its first loss by then
SECOND_DIM = 512  # the late-fusion tagger's second modality: openl3 units


def zoo_config(architecture, **fields):
    """The flagship width for a zoo tagger: FocalLoss (alpha .9, gamma 2) on the
    sigmoid heads, CrossEntropy over 2 tags for the CRFs, a 512-dim second
    modality for late fusion, dropout 0."""
    import dataclasses

    loss_fn = "CrossEntropy" if architecture.endswith("CRF") else "FocalLoss"
    return dataclasses.replace(training_config(), loss_fn=loss_fn, embedding_dim2=SECOND_DIM,
                               **fields)


def zoo_predict():
    """The predict CLI on cuda over the ten long-document embedding files for
    each tagger of ZOO_PREDICT from a random checkpoint (seed 0), late fusion
    with -ef2 over a second folder of 512-dim units with the same unit counts;
    then SwitchBiLSTM, which predict must refuse. -> {architecture: tagger}"""
    import pickle

    import torch

    from multimodaltopicsegmentation_torch.cli.predict import cli_main
    from multimodaltopicsegmentation_torch.models import registry
    from multimodaltopicsegmentation_torch.train import checkpoints

    emb, emb_warm = os.path.join(WORK, "long_emb"), os.path.join(WORK, "long_emb_warm")
    emb2, emb2_warm = os.path.join(WORK, "long_emb_openl3"), os.path.join(WORK, "long_emb_openl3_warm")
    write_embeddings(emb2, DOC_UNITS, seed=5, dim=SECOND_DIM)
    write_embeddings(emb2_warm, (100, 70), seed=6, dim=SECOND_DIM)

    def checkpoint(arch):
        cfg = zoo_config(arch)
        tagger = registry.build(arch, cfg, torch.Generator().manual_seed(0)).eval()
        ckpt = os.path.join(WORK, f"ckpt_zoo_{arch}", "best_model")
        hyp = os.path.join(WORK, f"results_zoo_{arch}.txt")
        checkpoints.save(ckpt, tagger.to_jax_params(), cfg, arch)
        second = "Second sentence encoder: openl3\n" if arch == "BiLSTMLateFusion" else ""
        with open(hyp, "w") as f:
            f.write(f"Sentence encoder: wav2vec_mean\n{second}Neural architecture: {arch}\n")
        return tagger, ["-hyp", hyp, "-model", ckpt, "-bs", "8", "-rjs", "--device", "cuda"]

    taggers = {}
    for arch in ZOO_PREDICT:
        tagger, common = checkpoint(arch)
        double = arch == "BiLSTMLateFusion"
        cli_main(common + ["-ef", emb_warm, "-exp", os.path.join(WORK, f"exp_zoo_warm_{arch}")]
                 + (["-ef2", emb2_warm] if double else []))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        exp = os.path.join(WORK, f"exp_zoo_{arch}")
        cli_main(common + ["-ef", emb, "-exp", exp] + (["-ef2", emb2] if double else []))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(exp, "results.pkl"), "rb") as f:
            results = pickle.load(f)
        for d, units in enumerate(DOC_UNITS):
            tags = results.get(f"doc{d}.npy")
            if tags is None or len(tags) != units or set(tags) - {0, 1}:
                raise RuntimeError(f"{arch}: doc{d} got {None if tags is None else len(tags)} "
                                   f"tags for {units} units")
        found = sum(sum(t) for t in results.values())
        log(f"[zoo predict] {arch}: predict on cuda, {len(DOC_UNITS)} documents, {sum(DOC_UNITS)} "
            f"units in {wall:.3f} s = {sum(DOC_UNITS) / wall:.0f} units/s (checkpoint load + "
            f"decode); {found} boundaries; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        taggers[arch] = tagger

    _, common = checkpoint("SwitchBiLSTM")
    try:
        cli_main(common + ["-ef", emb, "-exp", os.path.join(WORK, "exp_zoo_SwitchBiLSTM")])
    except NotImplementedError as e:
        if "domain ids" not in str(e):
            raise
        log(f"[zoo predict] SwitchBiLSTM: refused by predict ({e})")
    else:
        raise RuntimeError("predict served a SwitchBiLSTM checkpoint")
    return taggers


def zoo_breakdown(taggers):
    """One profiled decode of 8 documents padded to 3600 units per zoo tagger,
    then each CRF's loops alone on its emission width: Viterbi, the forward
    algorithm, and the loss with its backward (CUDA events, host gaps
    included: both loops are host-bound)."""
    import numpy as np
    import torch

    from multimodaltopicsegmentation_torch.ops import crf as crf_lib
    from multimodaltopicsegmentation_torch.ops.masks import length_mask

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((8, 3600, 768)).astype(np.float32)).cuda()
    x2 = torch.from_numpy(rng.standard_normal((8, 3600, SECOND_DIM)).astype(np.float32)).cuda()
    lengths = torch.tensor(DOC_UNITS[:8], device="cuda")
    for arch, tagger in taggers.items():
        tagger = tagger.cuda()
        kw = {"x2": x2} if arch == "BiLSTMLateFusion" else {}
        with torch.inference_mode():
            tagger.decode(x, lengths, 0.5, **kw)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            wall, busy, top = profiled(lambda: tagger.decode(x, lengths, 0.5, **kw))
        log_profile(f"{arch} decode of 8 x 3600 units (peak device memory "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)", wall, busy, top)
        if arch.endswith("CRF"):
            width = tagger.crf.fc.in_features
            h = torch.from_numpy(rng.standard_normal((8, 3600, width)).astype(np.float32)).cuda()
            mask = length_mask(lengths, 3600)
            tags = torch.from_numpy((rng.random((8, 3600)) < 0.05).astype(np.int64)).cuda()
            with torch.inference_mode():
                emissions = tagger.crf.fc(h)
                viterbi_ms = time_ms(lambda: crf_lib.viterbi_decode(tagger.crf, h, mask), 2, 1)
                forward_ms = time_ms(lambda: crf_lib.forward_algorithm(
                    tagger.crf.transitions, emissions, mask), 2, 1)
            loss_ms = time_ms(lambda: crf_lib.crf_loss(tagger.crf, h, tags, mask).backward(), 2, 1)
            tagger.zero_grad(set_to_none=True)
            log(f"[zoo crf] {arch}: CRF over [8, 3600, {width}] features, lengths "
                f"{list(DOC_UNITS[:8])}: viterbi_decode {viterbi_ms:.3f} ms, forward_algorithm "
                f"{forward_ms:.3f} ms, crf_loss forward + backward {loss_ms:.3f} ms (CUDA events)")
        tagger.cpu()


def zoo_training(docs):
    """`Trainer.fit` at the flagship width for each tagger of ZOO_TRAIN over
    the training corpus in one batch of 10 x 3600 units, ZOO_EPOCHS steps,
    then `search_threshold` and `test`. SwitchBiLSTM's documents alternate
    between the two domains; late fusion's second modality is 512-dim units
    drawn from seed 1 at the same unit counts."""
    import numpy as np
    import torch

    from multimodaltopicsegmentation_torch.train.data import batches
    from multimodaltopicsegmentation_torch.train.loop import Trainer

    rng = np.random.default_rng(1)
    second = [(rng.standard_normal((len(e), SECOND_DIM)).astype(np.float32), lab, name)
              for e, lab, name in docs]
    # a file name that starts with a digit is domain 1
    switched = [(e, lab, f"{d % 2}{name}") for d, (e, lab, name) in enumerate(docs)]
    for label, arch, fields in ZOO_TRAIN:
        crf = arch.endswith("CRF")
        pad = dict(crf=crf, truncate=True, truncate_value=3600)
        if arch == "SwitchBiLSTM":
            train_batches = list(batches(switched, 10, domain_adapt=True, **pad))
        else:
            train_batches = list(batches(docs, 10, **pad))
        if arch == "BiLSTMLateFusion":
            for b, b2 in zip(train_batches, batches(second, 10, **pad)):
                b["src_tokens2"] = b2["src_tokens"]
        units = int(sum(b["src_lengths"].sum() for b in train_batches))
        trainer = Trainer(arch, zoo_config(arch, **fields), lr=1e-3, optimizer="Adam",
                          max_epochs=ZOO_EPOCHS, no_early_stop=True, monitor="training_loss",
                          check_dir=os.path.join(WORK, f"train_zoo_{label.replace(' ', '_')}"),
                          seed=0, device="cuda")
        params, history, wall, steps, step_ms, peak = timed_fit(trainer, train_batches)
        losses = [h["training_loss"] for h in history]
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            raise RuntimeError(f"{label}: the training loss did not fall: {losses}")
        if not os.path.exists(trainer.best_model_path):
            raise RuntimeError(f"{label}: no snapshot at {trainer.best_model_path}")
        th, th_val = trainer.search_threshold(params, train_batches)
        trainer.threshold = th
        results, per_doc, scores = trainer.test(params, train_batches)
        if len(per_doc) != len(docs) or not all(math.isfinite(v) for v in results.values()):
            raise RuntimeError(f"{label}: test gave {len(per_doc)} documents, results {results}")
        if crf and not (th == 0.5 and math.isnan(th_val) and all(s.shape == (1,) for s in scores)):
            raise RuntimeError(f"{label}: search_threshold gave {(th, th_val)}, scores of shapes "
                               f"{[s.shape for s in scores]}; a CRF gives (0.5, nan) and one "
                               "Viterbi score per document")
        log(f"[zoo train] {label}: fit of {steps} steps of 10 x 3600 ({units} units) in {wall:.3f} s; "
            f"step {step_ms:.3f} ms (CUDA events, median of steps 3-{steps}) = "
            f"{units / step_ms * 1e3:.0f} units/s; loss {losses[0]:.5f} -> {losses[-1]:.5f}; peak "
            f"device memory {peak:.2f} GiB; search_threshold {th} ({th_val:.4f}); test Pk "
            f"{results['test_loss']:.4f} F1 {results['F1_loss']:.4f} WD {results['WD_loss']:.4f}")
        del trainer
        torch.cuda.empty_cache()


def zoo_train_cli(emb_dir, labs_file, split_file):
    """The train CLI on cuda with its default architecture (biLSTMCRF) for 2
    epochs at the flagship width, then the predict CLI on its checkpoint."""
    import pickle

    import torch

    from multimodaltopicsegmentation_torch.cli import predict, train_fit

    exp = os.path.join(WORK, "exp_zoo_train_cli")
    cwd = os.getcwd()
    t0 = time.perf_counter()
    try:
        train_fit.cli_main([
            "-exp", exp, "-enc", "wav2vec", "-ef", emb_dir, "-lf", labs_file, "-lr", "1e-3",
            "-hu", "256", "-nl", "2", "-bs", "10", "-max", "2", "-pat", "2", "-split", split_file,
            "-ar", "-as", "--device", "cuda"])
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(exp, "results.txt")) as f:
        txt = f.read()
    best = os.path.join(exp, "checkpoints", "best_model")
    if ("Neural architecture: biLSTMCRF" not in txt or "Mean Pk obtained is" not in txt
            or not os.path.exists(best)):
        raise RuntimeError(f"train_fit with its default architecture wrote no biLSTMCRF result "
                           f"under {exp}")
    out = os.path.join(WORK, "exp_zoo_train_predict")
    predict.cli_main(["-ef", emb_dir, "-hyp", os.path.join(exp, "results.txt"), "-model", best,
                      "-exp", out, "-bs", "8", "-rjs", "--device", "cuda"])
    with open(os.path.join(out, "results.pkl"), "rb") as f:
        results = pickle.load(f)
    for d, n in enumerate(TRAIN_UNITS):
        tags = results.get(f"doc{d}.npy")
        if tags is None or len(tags) != n or set(tags) - {0, 1}:
            raise RuntimeError(f"predict on the biLSTMCRF checkpoint: doc{d} got "
                               f"{None if tags is None else len(tags)} tags for {n} units")
    pk = [ln for ln in txt.splitlines() if ln.startswith("Mean Pk")][0]
    log(f"[zoo train cli] train_fit (default -arc biLSTMCRF) on cuda, 2 epochs of 7 documents + "
        f"test in {wall:.3f} s; {pk}; predict served the checkpoint: {len(results)} documents")


def zoo_card_vs_cpu():
    """Each zoo tagger (seed 0) on a 400- and a 300-unit document, padded to
    512 units as predict buckets them, on cuda and on the cpu: logits (a
    CRF's Viterbi scores) and tags on the valid units, then the first-step
    loss and gradient norm against labels with about 5 % boundaries. Values
    agree within 1e-3 + 1e-5 |cpu value|: a CRF's loss and scores sum over
    the units (10^2-10^3 here, where a float32 ulp is 10^-5-10^-4), and
    Transformer-CRF's gradient norm reaches some 2000."""
    import numpy as np
    import torch

    from multimodaltopicsegmentation_torch.models import registry
    from multimodaltopicsegmentation_torch.train.data import pad_batch

    names = ("doc7.npy", "doc9.npy")
    failed = []
    for label, arch, fields in ZOO_TRAIN:
        crf = arch.endswith("CRF")

        def padded(folder):
            docs = []
            for name in names:
                e = np.load(os.path.join(WORK, folder, name))
                lab = (np.random.default_rng(len(e)).random(len(e)) < 0.05).astype(int).tolist()
                docs.append((e, lab, ("1" if name == names[0] else "") + name))
            return pad_batch(docs, crf=crf, bucket=True, domain_adapt=True)

        batch, batch2 = padded("long_emb"), padded("long_emb_openl3")
        lengths = batch["src_lengths"].tolist()
        got = {}
        for device in ("cuda", "cpu"):
            x, n, tags, dom = (torch.from_numpy(batch[k]).to(device)
                               for k in ("src_tokens", "src_lengths", "tgt_tokens", "domain"))
            x2 = torch.from_numpy(batch2["src_tokens"]).to(device)
            tagger = registry.build(arch, zoo_config(arch, **fields),
                                    torch.Generator().manual_seed(0)).to(device)
            if arch == "SwitchBiLSTM":
                decode = lambda: tagger.decode(x, n, dom, 0.5)  # noqa: E731
                loss = lambda: tagger.loss(x, n, tags, dom)  # noqa: E731
            elif arch == "BiLSTMLateFusion":
                decode = lambda: tagger.decode(x, n, 0.5, x2=x2)  # noqa: E731
                loss = lambda: tagger.loss(x, n, tags, x2=x2)  # noqa: E731
            else:
                decode = lambda: tagger.decode(x, n, 0.5)  # noqa: E731
                loss = lambda: tagger.loss(x, n, tags)  # noqa: E731
            with torch.inference_mode():
                scores, decoded = (t.cpu() for t in decode())
            value = loss()
            value.backward()
            norm = torch.sqrt(sum((p.grad * p.grad).sum() for p in tagger.parameters()))
            if crf:  # one Viterbi score per document, tags on the valid units
                kept = scores
            else:
                kept = torch.cat([scores[b, :m].reshape(-1) for b, m in enumerate(lengths)])
            got[device] = (kept, [decoded[b, :m] for b, m in enumerate(lengths)], value.item(),
                           norm.item())
        (s0, t0, l0, n0), (s1, t1, l1, n1) = got["cuda"], got["cpu"]
        err = (s0 - s1).abs().max().item()
        close = (torch.isfinite(s0).all() and ((s0 - s1).abs() <= 1e-3 + 1e-5 * s1.abs()).all()
                 and abs(l0 - l1) <= 1e-3 + 1e-5 * abs(l1) and abs(n0 - n1) <= 1e-3 + 1e-5 * abs(n1))
        same = all(torch.equal(a, b) for a, b in zip(t0, t1))
        log(f"[zoo card vs cpu] {label}, {lengths} units padded to {batch['src_tokens'].shape[1]}: "
            f"{'Viterbi scores' if crf else 'logits'} max_abs_err {err:.3e}, tags "
            f"{'identical' if same else 'DIFFER'}; first step loss {l0:.6f} on the card, "
            f"{abs(l0 - l1):.3e} from the cpu's; gradient norm {n0:.6f}, {abs(n0 - n1):.3e} from "
            f"the cpu's (atol 1e-3 + rtol 1e-5)")
        if not (close and same):
            failed.append(label)
    if failed:
        raise RuntimeError(f"card and cpu disagree for {failed}")


def zoo_phase(docs, emb_dir, labs_file, split_file):
    """Phase 8, with every flash counter at 0 before it and after it."""
    from multimodaltopicsegmentation_torch.ops import flash_attention as FA

    counters = {**flash_counters(), "fused_local_attention": FA.fused_local_attention}
    for c in counters.values():
        c.launches = 0
    t = time.perf_counter()
    taggers = zoo_predict()
    for what, run in (("predict", None), ("breakdown", lambda: zoo_breakdown(taggers)),
                      ("training", lambda: zoo_training(docs)),
                      ("train cli", lambda: zoo_train_cli(emb_dir, labs_file, split_file)),
                      ("card vs cpu", zoo_card_vs_cpu)):
        if run is not None:
            run()
        log(f"[zoo] {what}: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
    launches = {name: c.launches for name, c in counters.items()}
    if any(launches.values()):
        raise RuntimeError(f"the tagger zoo reached a flash kernel: {launches}")
    log(f"[zoo] flash launches over the phase: {launches}")


# ---------------------------------------------------------------------------
# phase 9: the audio front-end and the training extractor
# ---------------------------------------------------------------------------

# the extractor runs: (tag, flags, CRDNN VAD); runs of one unitization share labels
FRONT_RUNS = (("vad_xvector", [], False), ("crdnn_vad_xvector", [], True),
              ("sentences_prosodic", ["-ust", "--prosodic_feats"], False),
              ("uniform_mfcc", ["-vd", "--mfcc"], False),
              ("uniform_wav2vec", ["-vd", "--wav2vec"], False),
              ("uniform_ecapa", ["-vd", "--ecapa"], False),
              ("uniform_openl3", ["-vd", "--openl3"], False),
              ("uniform_crepe", ["-vd", "--CREPE"], False))
# units CREPE's card-against-cpu check takes from the 30-second document (it
# costs some 10 ms of CPU per 10 ms frame); the other encoders take them all
CREPE_CHECK_UNITS = 10


def write_speech_corpus(root, seconds, seed):
    """Synthetic broadcasts with pauses: sentences of 2-12 s (a carrier tone
    per topic, 0.2-0.6 s of near-silence after each), their JSON transcripts
    and a flat labs.npy with about 10 % boundaries.
    -> (audio dir, transcript dir, labels file)."""
    import numpy as np

    from multimodaltopicsegmentation_torch.utils.audio import save_wav

    rng = np.random.default_rng(seed)
    audio_dir, data_dir = os.path.join(root, "audio"), os.path.join(root, "data")
    os.makedirs(audio_dir)
    os.makedirs(data_dir)
    labs = []
    for d, dur in enumerate(seconds):
        sig = (0.003 * rng.standard_normal(int(dur * SR))).astype(np.float32)
        sentences, t, tone = [], 0.0, 150.0
        while t < dur - 1.0:
            length = float(min(rng.uniform(2.0, 12.0), dur - t))
            voiced = max(length - rng.uniform(0.2, 0.6), 0.5)
            a, b = int(t * SR), int(min(t + voiced, dur) * SR)
            vibrato = 1.0 + 0.02 * np.sin(2 * np.pi * 5.0 * np.arange(b - a) / SR)
            sig[a:b] += 0.4 * np.sin(2 * np.pi * tone * np.cumsum(vibrato) / SR)
            sentences.append({"sentence": f"s{len(sentences)}", "start": round(t, 3),
                              "end": round(t + length, 3)})
            boundary = rng.random() < 0.1
            labs.append(int(boundary))
            if boundary:
                tone = 150.0 + 40.0 * rng.integers(0, 6)
            t += length
        labs[-1] = 1
        save_wav(os.path.join(audio_dir, f"doc{d}.wav"), sig, SR)
        with open(os.path.join(data_dir, f"doc{d}.json"), "w") as f:
            json.dump(sentences, f)
    labs_file = os.path.join(root, "labs.npy")
    np.save(labs_file, np.asarray(labs))
    return audio_dir, data_dir, labs_file


def write_vad_weights(path, audio):
    """A random CRDNN (port's random_params, seed 0) whose posteriors spread
    around 0.5: random weights keep every posterior within 0.01 of it, where
    no span forms, so the head is scaled by 300 and its bias set so that the
    median frame of `audio` scores 0.5."""
    import numpy as np
    import torch

    from multimodaltopicsegmentation_torch.encoders import crdnn_vad

    params = crdnn_vad.random_params(torch.Generator().manual_seed(0))
    params["out_w"] = params["out_w"] * 300.0
    median = float(np.median(crdnn_vad.posteriors(crdnn_vad.build(params, "cuda"), audio, SR)))
    params["out_b"] = (params["out_b"] - np.log(median / (1.0 - median))).astype(np.float32)
    np.savez(path, **params)


def frontend_runs(k1, corpus):
    """The training extractor once per flag set on cuda; -> K1 launches of
    the --wav2vec run."""
    import pickle

    import numpy as np
    import torch

    from multimodaltopicsegmentation_torch.cli.extract_embeddings import cli_main

    audio_dir, data_dir, labs_file = corpus
    audio_min = sum(MAIN_SECONDS) / 60.0
    labels, k1_launches = {}, 0
    for tag, flags, crdnn in FRONT_RUNS:
        if crdnn:
            os.environ["MTS_VAD_WEIGHTS"] = os.path.join(WORK, "vad.npz")
        out = os.path.join(WORK, f"front_{tag}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1.launches = 0
        t0 = time.perf_counter()
        cli_main(["-data", data_dir, "-audio", audio_dir, "-lab", labs_file, "-od", out + "/emb",
                  "-lod", out + "/labs", "--device", "cuda"] + flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        os.environ.pop("MTS_VAD_WEIGHTS", None)
        launches = k1.launches
        if "--wav2vec" in flags:
            if launches == 0:
                raise RuntimeError("the --wav2vec extraction launched no K1")
            k1_launches = launches
        elif launches:
            raise RuntimeError(f"{tag}: {launches} K1 launches outside wav2vec2")
        with open(os.path.join(out, "labs", "labs_dict.pkl"), "rb") as f:
            labs = pickle.load(f)
        with open(os.path.join(out, "labs", "segments.pkl"), "rb") as f:
            segments = pickle.load(f)
        units = sum(len(v) for v in labs.values())
        for d in range(len(MAIN_SECONDS)):
            name = f"doc{d}.npy"
            path = os.path.join(out, "emb", name)
            emb = np.load(path if os.path.exists(path) else os.path.join(out, "emb", "_mean", name))
            if len(emb) != len(labs[f"doc{d}"]) or not np.isfinite(emb).all() or not labs[f"doc{d}"][-1]:
                raise RuntimeError(f"{tag}: doc{d} has {len(emb)} rows for {len(labs[f'doc{d}'])} "
                                   f"labels, finite {np.isfinite(emb).all()}")
        unitization = ("CRDNN VAD" if crdnn else "sentence" if "-ust" in flags
                       else "uniform" if "-vd" in flags else "energy VAD")
        same = labels.setdefault(unitization, (segments, labs)) == (segments, labs)
        if not same:
            raise RuntimeError(f"{tag}: segments.pkl/labs_dict.pkl differ from the first "
                               f"{unitization} run")
        log(f"[front-end] {tag}: {units} units, {wall:.3f} s = {audio_min / wall:.3f} "
            f"audio-min/s, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB, K1 launches {launches}, {emb.shape[1]}-d; segments.pkl/labs_dict.pkl "
            f"equal to the first {unitization} run: {same}")
    return k1_launches


def frontend_predict(corpus):
    """predict -ee with the prosodic encoder on a random BiLSTM (embedding 167)."""
    import pickle

    import numpy as np
    import torch

    from multimodaltopicsegmentation_torch.cli.predict import cli_main

    ckpt = os.path.join(WORK, "ckpt_prosodic", "best_model")
    hyp = os.path.join(WORK, "results_prosodic.txt")
    common = ["-ee", "-hyp", hyp, "-model", ckpt, "-ui", "1.0", "-th", "0.5", "--device", "cuda"]
    write_checkpoint(ckpt, hyp, embedding_dim=167, encoder="prosodic")
    warm = os.path.join(WORK, "emb_prosodic_warm")
    cli_main(common + ["-af", os.path.join(WORK, "audio_warm"), "-ef", warm,
                       "-exp", os.path.join(WORK, "exp_prosodic_warm")])
    write_checkpoint(ckpt, hyp, np.load(os.path.join(warm, "doc0.npy")), embedding_dim=167,
                     encoder="prosodic")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp = os.path.join(WORK, "exp_prosodic")
    cli_main(common + ["-af", corpus[0], "-ef", os.path.join(WORK, "emb_prosodic"), "-exp", exp])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(exp, "results.pkl"), "rb") as f:
        results = pickle.load(f)
    for d, dur in enumerate(MAIN_SECONDS):
        tags = results.get(f"doc{d}.npy")
        if tags is None or len(tags) != int(dur):
            raise RuntimeError(f"prosodic predict: doc{d} got {tags and len(tags)} tags")
    found = sum(sum(t) for t in results.values())
    log(f"[front-end] predict -ee prosodic: {sum(MAIN_SECONDS) / 60:.2f} audio-min in "
        f"{wall:.3f} s = {sum(MAIN_SECONDS) / 60 / wall:.3f} audio-min/s; {found} boundaries; "
        f"{len(os.listdir(os.path.join(exp, 'audio_segments')))} segment wavs")


def frontend_breakdown(corpus):
    """One profiled encode of doc1 (150 s) per encoder, warmed up first:
    its sentence units for the prosodic encoder and the x-vector, 1-s units
    for the others; wall, device busy share and the three costliest kernels."""
    from multimodaltopicsegmentation_torch.encoders import crepe, engine, openl3, tdnn
    from multimodaltopicsegmentation_torch.utils.audio import load_audio

    audio, _ = load_audio(os.path.join(corpus[0], "doc1.wav"))
    with open(os.path.join(corpus[1], "doc1.json")) as f:
        sentences = [(int(s["start"] * SR), min(int(s["end"] * SR), len(audio)))
                     for s in json.load(f)]
    uniform = [(i * SR, (i + 1) * SR) for i in range(len(audio) // SR)]
    for name, build, bounds in (
            ("prosodic", lambda: engine.ProsodicEncoder("cuda"), sentences),
            ("x-vector", lambda: tdnn.XVectorEncoder(device="cuda"), sentences),
            ("mfcc", lambda: engine.MFCCEncoder("cuda"), uniform),
            ("wav2vec", lambda: engine.Wav2Vec2Encoder(device="cuda"), uniform),
            ("ecapa", lambda: tdnn.EcapaEncoder(device="cuda"), uniform),
            ("openl3", lambda: openl3.OpenL3Encoder(device="cuda"), uniform),
            ("crepe", lambda: crepe.CrepeEncoder(device="cuda"), uniform)):
        enc = build()
        enc.encode_document(audio, bounds)  # warm-up
        wall, busy, top = profiled(lambda: enc.encode_document(audio, bounds))
        log_profile(f"{name} encode of doc1 ({len(bounds)} units, {len(audio) / SR / 60:.2f} "
                    f"audio-min)", wall, busy, top[:3])


def frontend_card_vs_cpu(check):
    """Each encoder, the energy VAD and the CRDNN posteriors on the card and
    on the cpu for one 30-second document: continuous outputs within
    1e-3 + 1e-5 |value|; VAD spans of equal count, edges within one 10 ms
    frame; prosodic vectors: fewer than 1 % of pYIN frames in another state,
    the six f0/pause/voicing columns and the pitch jump exempt on units where
    a state differs."""
    import numpy as np
    import torch

    from multimodaltopicsegmentation_torch.dsp import vad
    from multimodaltopicsegmentation_torch.dsp.pyin import pyin
    from multimodaltopicsegmentation_torch.encoders import crdnn_vad, engine
    from multimodaltopicsegmentation_torch.encoders.engine_util import pad_units
    from multimodaltopicsegmentation_torch.utils.audio import load_audio

    audio, _ = load_audio(os.path.join(check[0], "doc0.wav"))
    with open(os.path.join(check[1], "doc0.json")) as f:
        sentences = [(int(s["start"] * SR), min(int(s["end"] * SR), len(audio)))
                     for s in json.load(f)]
    uniform = [(i * SR, (i + 1) * SR) for i in range(len(audio) // SR)]
    failed = []

    def close(label, got, want):
        err = float(np.abs(got - want).max())
        ok = bool(np.isfinite(got).all() and (np.abs(got - want) <= 1e-3 + 1e-5 * np.abs(want)).all())
        log(f"[front-end card vs cpu] {label}: max_abs_err {err:.3e} "
            f"(atol 1e-3 + rtol 1e-5): {'ok' if ok else 'FAILED'}")
        if not ok:
            failed.append(label)

    spans = [vad.get_speech_segments(audio, SR, device=d) for d in ("cuda", "cpu")]
    edges = max((abs(a - b) for x, y in zip(*spans) for a, b in zip(x, y)), default=0.0)
    ok = len(spans[0]) == len(spans[1]) and edges <= 0.01 + 1e-9
    log(f"[front-end card vs cpu] energy VAD: {len(spans[0])} / {len(spans[1])} spans, "
        f"edges within {edges:.3f} s (0.01): {'ok' if ok else 'FAILED'}")
    if not ok:
        failed.append("energy VAD")
    params = crdnn_vad.load_npz(os.path.join(WORK, "vad.npz"))
    close("CRDNN posteriors", *(crdnn_vad.posteriors(crdnn_vad.build(params, d), audio, SR)
                                for d in ("cuda", "cpu")))

    # prosodic: pYIN states first, then the vectors
    units, lens = pad_units(audio, sentences, bucket=True)
    flags, f0s = [], []
    for d in ("cuda", "cpu"):
        f0, flag, _, _ = pyin(torch.from_numpy(units).to(d), SR, with_raw_yin=True)
        f0s.append(f0.cpu().numpy())
        flags.append(flag.cpu().numpy())
    T = flags[0].shape[1]
    valid = np.arange(T)[None, :] < (1 + lens[:, None] // 512)
    differ = valid & ((flags[0] != flags[1]) | ~((f0s[0] == f0s[1]) | np.isnan(f0s[0]) & np.isnan(f0s[1])))
    share = differ.sum() / valid.sum()
    got, want = (np.stack(engine.ProsodicEncoder(d).encode_document(audio, sentences))
                 for d in ("cuda", "cpu"))
    # a unit whose states differ is exempt in its six f0/pause/voicing columns
    # and in its pitch jump, which divides by that unit's pYIN f0
    exempt = differ.any(axis=1)
    bad = np.abs(got - want) > 1e-3 + 1e-5 * np.abs(want)
    bad[np.ix_(exempt, list(range(6)) + [166])] = False
    ok = share < 0.01 and not bad.any() and np.isfinite(got).all()
    log(f"[front-end card vs cpu] prosodic: {differ.sum()} of {valid.sum()} pYIN frames in another "
        f"state ({100 * share:.3f} %, limit 1 %), {exempt.sum()} of {len(exempt)} units exempt "
        f"in f0/pause/voicing; max_abs_err {np.abs(got - want)[:, 6:].max():.3e} over the other "
        f"columns: {'ok' if ok else 'FAILED'}")
    if not ok:
        failed.append("prosodic")

    constructors = {"mfcc": lambda d: engine.MFCCEncoder(d),
                "wav2vec": lambda d: engine.Wav2Vec2Encoder(device=d)}
    from multimodaltopicsegmentation_torch.encoders import crepe, openl3, tdnn

    constructors.update({"x-vectors": lambda d: tdnn.XVectorEncoder(device=d),
                     "ecapa": lambda d: tdnn.EcapaEncoder(device=d),
                     "openl3": lambda d: openl3.OpenL3Encoder(device=d),
                     "crepe": lambda d: crepe.CrepeEncoder(device=d)})
    for name, build in constructors.items():
        bounds = uniform[:CREPE_CHECK_UNITS] if name == "crepe" else uniform
        outs = [np.concatenate([np.atleast_2d(u) for u in build(d).encode_document(audio, bounds)])
                for d in ("cuda", "cpu")]
        close(f"{name} ({len(bounds)} units)", *outs)
    if failed:
        raise RuntimeError(f"card and cpu disagree for {failed}")


def frontend_phase(k1):
    """Phase 9; -> K1 launches of the --wav2vec extraction."""
    from multimodaltopicsegmentation_torch.utils.audio import load_audio

    t = time.perf_counter()
    corpus = write_speech_corpus(os.path.join(WORK, "front_corpus"), MAIN_SECONDS, seed=6)
    check = write_speech_corpus(os.path.join(WORK, "front_check"), (30.0,), seed=7)
    write_vad_weights(os.path.join(WORK, "vad.npz"),
                      load_audio(os.path.join(check[0], "doc0.wav"))[0])
    launches = 0
    for what, run in (("extractor runs", lambda: frontend_runs(k1, corpus)),
                      ("predict -ee prosodic", lambda: frontend_predict(corpus)),
                      ("breakdown", lambda: frontend_breakdown(corpus)),
                      ("card vs cpu", lambda: frontend_card_vs_cpu(check))):
        launches = run() or launches
        log(f"[front-end] {what}: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
    return launches


# -- phase 10: training completeness (device windows, the dropout grid, the CLI flags) --

WINDOW_TAGGERS = ("Transformer", "RecurrentLongT5")
WINDOW_EPOCHS, WINDOW = 6, 3
GRID_RATES = tuple((di, do) for di in (0.0, 0.2, 0.5) for do in (0.0, 0.2, 0.5))
GRID_EPOCHS = 2  # cut from 3 so that phase 11 fits the script's time


def _fit_wall(trainer, train_batches, valid_batches):
    """`trainer.fit` synchronised on both sides -> (params, history, wall s,
    peak device memory GiB)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, history = trainer.fit(train_batches, valid_batches)
    torch.cuda.synchronize()
    return params, history, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def _same_fit(what, host, device, rtol):
    """Decisions equal (epochs, snapshot name, final rate) and losses within
    `rtol` relative, or raise."""
    (th, hh), (td, hd) = host, device
    names = [os.path.basename(t.best_model_path) for t in (th, td)]
    rates = [t.opt.param_groups[0]["lr"] for t in (th, td)]
    if len(hh) != len(hd) or names[0] != names[1] or rates[0] != rates[1]:
        raise RuntimeError(f"{what}: host and device decide apart: {len(hh)} / {len(hd)} epochs, "
                           f"snapshots {names}, rates {rates}")
    err = 0.0
    for a, b in zip(hh, hd):
        for key in ("training_loss", "val_loss"):
            err = max(err, abs(a[key] - b[key]) / abs(a[key]))
    if not err <= rtol:
        raise RuntimeError(f"{what}: losses {err:.3e} apart (rtol {rtol}): {hh} against {hd}")
    return err


def _sync_checked_windows(mode):
    """Make each device window enqueue under torch.cuda.set_sync_debug_mode(mode)
    ("error": a synchronizing call inside it raises; "warn": it warns), the
    packed pull after it outside. -> a function that undoes it."""
    import torch

    from multimodaltopicsegmentation_torch.train import device_fit

    make = device_fit.make_fit_window

    def checked(*args, **kwargs):
        fit_window = make(*args, **kwargs)

        def run(*a):
            torch.cuda.set_sync_debug_mode(mode)
            try:
                return fit_window(*a)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    device_fit.make_fit_window = checked
    return lambda: setattr(device_fit, "make_fit_window", make)


def window_fits(docs):
    """(a) `Trainer(device_epochs=True)` beside the host loop, same seed,
    dropout 0.1, for each of WINDOW_TAGGERS: 2 uniform train batches of
    5 x 3600, 1 valid batch, WINDOW_EPOCHS epochs in windows of WINDOW.
    -> {kernel name: launches of the device fits}."""
    import dataclasses
    import warnings

    import torch

    from multimodaltopicsegmentation_torch.models import transformers as TT
    from multimodaltopicsegmentation_torch.train.data import batches, pad_batch
    from multimodaltopicsegmentation_torch.train.loop import Trainer

    counters = flash_counters()
    total = dict.fromkeys(counters, 0)
    pad = dict(crf=False, truncate=True, truncate_value=3600)
    train_batches = list(batches(docs, 5, **pad))
    valid_batches = [pad_batch(docs[7:], **pad)]
    nb, nv = len(train_batches), len(valid_batches)
    cfg = dataclasses.replace(training_config(), dropout_in=0.1, dropout_out=0.1)
    os.environ["MTS_DEVICE_EPOCH_WINDOW"] = str(WINDOW)
    for arch in WINDOW_TAGGERS:
        # one profiled window first: its busy share, and the warm-up (the
        # allocator, first uses) that neither timed fit then pays for
        trainer = Trainer(arch, cfg, lr=1e-3, max_epochs=WINDOW, patience=20,
                          check_dir=os.path.join(WORK, f"window_{arch}_profiled"), seed=0,
                          device="cuda", device_epochs=True)
        t0 = time.perf_counter()
        busy = profiled(lambda: trainer.fit(train_batches, valid_batches))
        profiled_s = time.perf_counter() - t0  # with the profiler's start and teardown
        runs, walls = {}, {}
        for mode in ("host", "device"):
            trainer = Trainer(arch, cfg, lr=1e-3, max_epochs=WINDOW_EPOCHS, patience=20,
                              check_dir=os.path.join(WORK, f"window_{arch}_{mode}"), seed=0,
                              device="cuda", device_epochs=mode == "device")
            for c in counters.values():
                c.launches = 0
            # the Transformer's windows must enqueue without one synchronizing call
            # (torch raises on one); RecurrentLongT5's are counted by where they come from
            undo = _sync_checked_windows("error" if arch == "Transformer" else "warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    _, history, wall, peak = _fit_wall(trainer, train_batches, valid_batches)
            finally:
                undo()
            syncs = {}
            for w in caught:
                if "synchronizing CUDA operation" in str(w.message):
                    where = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                    syncs[where] = syncs.get(where, 0) + 1
            runs[mode], walls[mode] = (trainer, history), wall
            launches = {name: c.launches for name, c in counters.items()}
        remat = [m.last_remat for m in trainer.tagger.modules()
                 if isinstance(m, (TT.BertStyleEncoder, TT.LongT5Encoder))]
        fwd, dq, dqb, dkv = STEP_LAUNCHES[arch]
        steps, evals = WINDOW_EPOCHS * nb, WINDOW_EPOCHS * nv
        want = dict(zip(counters, (steps * fwd * (2 if any(remat) else 1) + evals * fwd,
                                   steps * dq, steps * dqb, steps * dkv)))
        if launches != want:
            raise RuntimeError(f"{arch} device windows: launches {launches}, expected {want}")
        for name in total:
            total[name] += launches[name]
        err = _same_fit(f"{arch} device windows", runs["host"], runs["device"], 1e-5)
        losses = [h["training_loss"] for h in runs["device"][1]]
        if not all(map(math.isfinite, losses)):
            raise RuntimeError(f"{arch} device windows: losses {losses}")
        log(f"[complete] {arch} Trainer(device_epochs=True) at 768 -> 256 x 2, 8 heads, window 120, "
            f"dropout 0.1: {WINDOW_EPOCHS} epochs of {nb} x (5 x 3600) + {nv} valid batch in "
            f"windows of {WINDOW}: {walls['device'] / WINDOW_EPOCHS:.4f} s per epoch against "
            f"{walls['host'] / WINDOW_EPOCHS:.4f} s in the host loop; losses {err:.3e} apart "
            f"(rtol 1e-5), same snapshot {os.path.basename(runs['device'][0].best_model_path)}; "
            f"launches {launches}; synchronizing calls inside the windows, by caller: {syncs}; peak device "
            f"memory {peak:.2f} GiB")
        log_profile(f"{arch} device window fit of {WINDOW} epochs, set-up included (the profiled "
                    f"call {profiled_s:.1f} s)", *busy)
        del runs, trainer
        torch.cuda.empty_cache()
    os.environ.pop("MTS_DEVICE_EPOCH_WINDOW")
    return total


def grid_fits(docs):
    """(b) `GridTrainer` over the paper's dropout grid (G = 9) on the
    replication BiLSTM (h 256 x 2, FocalLoss, Adam eps 1e-7), one train batch
    of 10 x 3600 and one valid batch, GRID_EPOCHS epochs; configurations 0, 4
    and 8 against serial `Trainer` runs."""
    import dataclasses

    import torch

    from multimodaltopicsegmentation_torch.train.data import batches, pad_batch
    from multimodaltopicsegmentation_torch.train.grid import GridTrainer
    from multimodaltopicsegmentation_torch.train.loop import Trainer

    pad = dict(crf=False, truncate=True, truncate_value=3600)
    train_batches = list(batches(docs, 10, **pad))
    valid_batches = [pad_batch(docs[7:], **pad)]
    kw = dict(lr=1e-3, max_epochs=GRID_EPOCHS, patience=20, seed=0, device="cuda")
    gt = GridTrainer("BiLSTM", training_config(), GRID_RATES,
                     check_dir=os.path.join(WORK, "grid"), **kw)
    _, histories, wall, peak = _fit_wall(gt, train_batches, valid_batches)
    serial_wall = 0.0
    for g in (0, 4, 8):
        cfg = dataclasses.replace(training_config(), dropout_in=GRID_RATES[g][0],
                                  dropout_out=GRID_RATES[g][1])
        trainer = Trainer("BiLSTM", cfg, check_dir=os.path.join(WORK, f"grid_serial_{g}"), **kw)
        _, history, s_wall, _ = _fit_wall(trainer, train_batches, valid_batches)
        serial_wall += s_wall / 3
        names = [os.path.basename(p) for p in (trainer.best_model_path, gt.best_model_paths[g])]
        err = max(abs(a[k] - b[k]) / abs(a[k]) for a, b in zip(history, histories[g])
                  for k in ("training_loss", "val_loss"))
        if len(history) != len(histories[g]) or names[0] != names[1] or not err <= 1e-5:
            raise RuntimeError(f"grid configuration {g} {GRID_RATES[g]}: {histories[g]} against the "
                               f"serial {history}; snapshots {names}")
        log(f"[complete] grid configuration {g} {GRID_RATES[g]}: history {err:.3e} from its serial "
            f"run (rtol 1e-5), snapshot {names[0]} in both")
    G = len(GRID_RATES)
    log(f"[complete] GridTrainer BiLSTM h 256 x 2, G = {G}, {GRID_EPOCHS} epochs of 10 x 3600 + a "
        f"valid batch: {wall:.3f} s, {wall / G:.3f} s a configuration against {serial_wall:.3f} s "
        f"for one serial fit (mean of 3), {wall / (G * GRID_EPOCHS):.3f} s a configuration's "
        f"epoch; peak device memory {peak:.2f} GiB")
    del gt
    torch.cuda.empty_cache()


def _results(exp):
    """results.txt's Pk, F1 and WD, which must be finite."""
    with open(os.path.join(exp, "results.txt")) as f:
        lines = f.read().splitlines()
    got = {}
    for key in ("Pk", "F1", "WD"):
        line = [ln for ln in lines if ln.startswith(f"Mean {key} obtained is")]
        got[key] = float(line[0].split()[4]) if line else math.nan
    if not all(map(math.isfinite, got.values())):
        raise RuntimeError(f"{exp}/results.txt: {got}")
    return got


def train_cli_flags(emb_dir, labs_file, split_file):
    """(c) The train CLI on cuda with -pg (a 2 x 2 dropout grid on BiLSTM), -de
    (Transformer), -pca (BiLSTM on 167 components) and --infer on the first
    run's folder. -> {kernel name: launches}."""
    import shutil

    from multimodaltopicsegmentation_torch.cli import train_fit

    counters = flash_counters()
    for c in counters.values():
        c.launches = 0
    base = ["-enc", "wav2vec", "-ef", emb_dir, "-lf", labs_file, "-split", split_file, "-lr", "1e-3",
            "-hu", "256", "-nl", "2", "-bs", "10", "-max", "2", "-pat", "2", "-loss", "FocalLoss",
            "--device", "cuda"]
    grid = ["-arc", "BiLSTM", "-hs", "-huss", "256", "-nlss", "2", "-diss", "0", "0.2",
            "-doss", "0", "0.2", "-s_last"]
    runs = (("pg", grid + ["-pg"]), ("de", ["-arc", "Transformer", "-nh", "8", "-window", "120", "-de"]),
            ("pca", ["-arc", "BiLSTM", "-pca", "-pca_v", "167"]), ("infer", grid + ["--infer"]))
    cwd = os.getcwd()
    for name, flags in runs:
        exp = os.path.join(WORK, "exp_flags_" + ("pg" if name == "infer" else name))
        if name == "infer":
            # --infer tests checkpoints/final=0.500.ckpt, as the JAX CLI does: the
            # first run's chosen checkpoint under that name
            shutil.copy(os.path.join(exp, "checkpoints", "best_model"),
                        os.path.join(exp, "checkpoints", "final=0.500.ckpt"))
        t0 = time.perf_counter()
        try:
            train_fit.cli_main(base + ["-exp", exp] + flags)
        finally:
            os.chdir(cwd)
        log(f"[complete] train_fit {' '.join(flags)}: {time.perf_counter() - t0:.3f} s, "
            f"results.txt {_results(exp)}")
    launches = {name: c.launches for name, c in counters.items()}
    if not (launches["flash_local_dq"] == launches["flash_local_dkv"] == 2 * 2
            and launches["flash_local_dq_dbias"] == 0):
        raise RuntimeError(f"train_fit -de -arc Transformer: launches {launches}")
    return launches


def completeness_phase(docs, emb_dir, labs_file, split_file):
    """Phase 10; -> {kernel name: launches}."""
    launches = {}
    t = time.perf_counter()
    for what, run in (("device windows", lambda: window_fits(docs)),
                      ("dropout grid", lambda: grid_fits(docs)),
                      ("train CLI flags", lambda: train_cli_flags(emb_dir, labs_file, split_file))):
        for name, n in (run() or {}).items():
            launches[name] = launches.get(name, 0) + n
        log(f"[complete] {what}: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
    return launches


# -- phase 11: the parallel layer, two ranks on the one card ----------------------------------

PARALLEL_RANKS = 2
PARALLEL_EPOCHS = 3  # steps of each parallel fit: one global batch of 10 x 3600 an epoch
PARALLEL_GRID = ((0.0, 0.0), (0.2, 0.0), (0.0, 0.2), (0.2, 0.2))
PARALLEL_GRID_EPOCHS = 2
PARALLEL_TIMEOUT = 300  # seconds for the spawn, and for each torchrun call
# (K2, K4, K5, K3) launches a rank makes in one train step: 2 layers each, or,
# pipelined over 2 stages, 1 layer for each of the 10 microbatches
PARALLEL_STEP_LAUNCHES = {"dp_transformer": (2, 2, 0, 2), "seq_transformer": (2, 2, 0, 2),
                          "pipe_transformer": (10, 10, 0, 10), "dp_bilstm": (0, 0, 0, 0),
                          "expert_switch": (0, 0, 0, 0), "tp_transformer": (2, 2, 0, 2),
                          "tp_bilstm": (0, 0, 0, 0)}
# tensor parallelism: the model axis of the two ranks; the BiLSTM's documents
# cut from 3600 units (a gather over the ranks, staged through host memory,
# each recurrence step)
TP_MODEL_PARALLEL, TP_UNITS = 2, 600
# a Transformer test decode (2 layers, one batch), the sharded predict (2 layers x 2 chunks)
PARALLEL_DECODE_LAUNCHES, PARALLEL_PREDICT_LAUNCHES = (2, 0, 0, 0), (4, 0, 0, 0)


def parallel_attention_shapes():
    """(label, B, L, window, lengths) of the attention calls that phase 11's
    ranks make in the Transformer's two layers (windows 240 and 120, Dh 96),
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


def _parallel_batches(docs):
    """The phase-6 corpus as one global batch of 10 x 3600 (5 x 3600 a rank
    under data parallelism), the same with domain flags (the even
    documents' names gain a leading digit: domain 1, as RadioNews files),
    and the same cut to TP_UNITS units."""
    from multimodaltopicsegmentation_torch.train.data import pad_batch

    pad = dict(crf=False, truncate=True, truncate_value=3600)
    named = [(e, lab, f"{d}{n}" if d % 2 == 0 else n) for d, (e, lab, n) in enumerate(docs)]
    return (pad_batch(docs, **pad), pad_batch(named, domain_adapt=True, **pad),
            pad_batch(docs, crf=False, truncate=True, truncate_value=TP_UNITS))


def _parallel_fits():
    """(name, architecture, Trainer keywords, uses the domain batch) of the fits."""
    return (("dp_transformer", "Transformer", "mesh", False),
            ("dp_bilstm", "BiLSTM", "mesh", False),
            ("seq_transformer", "Transformer", dict(sequence_shards=PARALLEL_RANKS), False),
            ("pipe_transformer", "Transformer", dict(pipeline_stages=PARALLEL_RANKS), False),
            ("expert_switch", "SwitchBiLSTM", {}, True))


def _tp_fits():
    """(name, architecture, on the TP_UNITS batch) of the tensor-parallel fits."""
    return (("tp_transformer", "Transformer", False), ("tp_bilstm", "BiLSTM", True))


def tp_predict(mesh, emb_dir, ckpt, out):
    """Phase 4's checkpoint over phase 4's files through make_sharded_decode
    on a mesh with a "model" axis, chunks of 8 as predict -bs 8 takes them;
    mesh position (0, 0) writes results.pkl as predict does."""
    import pickle

    from multimodaltopicsegmentation_torch.cli.predict import load_dataset_for_inference_with_names
    from multimodaltopicsegmentation_torch.models import registry
    from multimodaltopicsegmentation_torch.parallel.train_step import make_sharded_decode
    from multimodaltopicsegmentation_torch.train import checkpoints as ckpt_lib
    from multimodaltopicsegmentation_torch.train.data import pad_batch

    params, cfg, arch, _ = ckpt_lib.load(ckpt)
    tagger = registry.build(arch, cfg)
    tagger.load_state_dict(type(tagger).from_jax_params(params))
    decode = make_sharded_decode(tagger.to(mesh.device).eval(), mesh, 0.5)
    embeddings, names = load_dataset_for_inference_with_names(emb_dir)
    docs = [(e, [0] * len(e), n) for e, n in zip(embeddings, names)]
    results = []
    for i in range(0, len(docs), 8):
        batch = pad_batch(docs[i:i + 8], crf=False, bucket=True)
        tags = decode(batch)[1].cpu().numpy()
        results += [tags[j][:int(n)].astype(int).tolist()
                    for j, n in enumerate(batch["src_lengths"][:len(docs[i:i + 8])])]
    if mesh.is_first:
        os.makedirs(out)
        with open(os.path.join(out, "results.pkl"), "wb") as f:
            pickle.dump(dict(zip(names, results)), f)
    mesh.barrier()


def _switch_config():
    import dataclasses

    return dataclasses.replace(training_config(), switch="lstm")


def parallel_rank(rank, out_dir, batch, domain_batch, tp_batch, emb_dir, ckpt, hyp):
    """One of the two ranks (spawned, gloo on one card): each mode's fit of
    PARALLEL_EPOCHS steps and its test decode, the grid, the sharded predict,
    the tensor-parallel fits and decode; launches, walls, staged bytes,
    collectives over "model" and peak memory counted here, in this process."""
    import pickle

    import numpy as np
    import torch

    from multimodaltopicsegmentation_torch.cli import predict
    from multimodaltopicsegmentation_torch.parallel import mesh as PM
    from multimodaltopicsegmentation_torch.train.grid import GridTrainer
    from multimodaltopicsegmentation_torch.train.loop import Trainer

    mesh = PM.make_mesh()
    tp_mesh = PM.make_mesh(model_parallel=TP_MODEL_PARALLEL)
    counters = flash_counters()

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        before = dict(PM.stats)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        moved = {k: PM.stats[k] - before[k] for k in PM.stats}
        return out, dict(wall=time.perf_counter() - t0, staged=moved["staged_bytes"],
                         gathers=moved["model_all_gathers"], reduces=moved["model_all_reduces"],
                         peak=torch.cuda.max_memory_allocated(),
                         launches={n: c.launches for n, c in counters.items()})

    res = {"device": str(mesh.device), "backend": mesh.backend}
    # warm-up, untimed and uncounted: this process's first kernels, cuBLAS and
    # cuDNN handles and gloo's buffers, which every mode below then finds ready
    Trainer("Transformer", training_config(), lr=1e-3, max_epochs=1, monitor="training_loss",
            check_dir=os.path.join(out_dir, f"warm_{rank}"), seed=0, device=mesh.device,
            mesh=mesh).fit([batch])
    for name, arch, kw, domain in _parallel_fits():
        cfg = _switch_config() if arch == "SwitchBiLSTM" else training_config()
        kw = dict(mesh=mesh) if kw == "mesh" else kw
        trainer = Trainer(arch, cfg, lr=1e-3, max_epochs=PARALLEL_EPOCHS, monitor="training_loss",
                          check_dir=os.path.join(out_dir, f"{name}_{rank}"), seed=0,
                          device=mesh.device, **kw)
        b = domain_batch if domain else batch
        (_, history), fit = counted(lambda: trainer.fit([b]))
        (test, _, scores), dec = counted(lambda: trainer.test(trainer.params, [b]))
        res[name] = dict(history=history, fit=fit, test=test, decode=dec,
                         scores=[np.asarray(x, np.float32) for x in scores],
                         expert=trainer.expert_mesh is not None)
        del trainer
        torch.cuda.empty_cache()
    gt = GridTrainer("BiLSTM", training_config(), PARALLEL_GRID, lr=1e-3,
                     max_epochs=PARALLEL_GRID_EPOCHS, monitor="training_loss", seed=0,
                     check_dir=os.path.join(out_dir, "grid"), mesh=mesh, device=mesh.device)
    (_, histories), grid = counted(lambda: gt.fit([batch]))
    res["grid"] = dict(histories=histories, paths=[os.path.basename(p) for p in gt.best_model_paths],
                       fit=grid)
    _, pred = counted(lambda: predict.cli_main([
        "-ef", emb_dir, "-hyp", hyp, "-model", ckpt, "-exp", os.path.join(out_dir, "predict"),
        "-bs", "8", "-rjs", "--device", "cuda"]))
    res["predict"] = dict(fit=pred)
    for name, arch, cut in _tp_fits():
        trainer = Trainer(arch, training_config(), lr=1e-3, max_epochs=PARALLEL_EPOCHS,
                          monitor="training_loss", check_dir=os.path.join(out_dir, f"{name}_{rank}"),
                          seed=0, device=mesh.device, mesh=tp_mesh)
        b = tp_batch if cut else batch
        (_, history), fit = counted(lambda: trainer.fit([b]))
        (test, _, scores), dec = counted(lambda: trainer.test(trainer.params, [b]))
        res[name] = dict(history=history, fit=fit, test=test, decode=dec, params=trainer.params,
                         scores=[np.asarray(x, np.float32) for x in scores],
                         position=(tp_mesh.index, tp_mesh.model_index))
        del trainer
        torch.cuda.empty_cache()
    _, tp_pred = counted(lambda: tp_predict(tp_mesh, emb_dir, ckpt,
                                            os.path.join(out_dir, "tp_predict")))
    res["tp_predict"] = dict(fit=tp_pred)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _close(what, got, want, rtol=1e-4):
    """|got - want| <= rtol * (|want| + max |want|): relative, with the
    array's own scale for values near 0; -> the largest relative error."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() if want.size else 0.0
    err = np.abs(got - want) / (np.abs(want) + scale + 1e-30)
    if got.shape != want.shape or not (err <= rtol).all():
        raise RuntimeError(f"{what}: {err.max() if err.size else 'shape'} apart (rtol {rtol}); "
                           f"shapes {got.shape} {want.shape}")
    return float(err.max()) if err.size else 0.0


def _one_rank_references(batch, domain_batch, tp_batch):
    """The same fits, test decodes and grid on one rank on the card (no
    group); the Transformer's and the cut BiLSTM's parameters and peak
    memory, for the tensor-parallel fits."""
    import numpy as np
    import torch

    from multimodaltopicsegmentation_torch.train.grid import GridTrainer
    from multimodaltopicsegmentation_torch.train.loop import Trainer

    refs, walls = {}, {}
    for arch, b in (("Transformer", batch), ("BiLSTM", batch), ("SwitchBiLSTM", domain_batch),
                    (f"BiLSTM_{TP_UNITS}", tp_batch)):
        cfg = _switch_config() if arch == "SwitchBiLSTM" else training_config()
        trainer = Trainer(arch.split("_")[0], cfg, lr=1e-3, max_epochs=PARALLEL_EPOCHS,
                          monitor="training_loss",
                          check_dir=os.path.join(WORK, f"parallel_ref_{arch}"), seed=0,
                          device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, history = trainer.fit([b])
        torch.cuda.synchronize()
        walls[arch] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        test, _, scores = trainer.test(trainer.params, [b])
        refs[arch] = dict(history=history, test=test, params=trainer.params, peak=peak,
                          scores=[np.asarray(x, np.float32) for x in scores])
        del trainer
        torch.cuda.empty_cache()
    gt = GridTrainer("BiLSTM", training_config(), PARALLEL_GRID, lr=1e-3,
                     max_epochs=PARALLEL_GRID_EPOCHS, monitor="training_loss", seed=0,
                     check_dir=os.path.join(WORK, "parallel_ref_grid"), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, histories = gt.fit([batch])
    torch.cuda.synchronize()
    walls["grid"] = time.perf_counter() - t0
    refs["grid"] = dict(histories=histories,
                        paths=[os.path.basename(p) for p in gt.best_model_paths])
    return refs, walls


def tensor_parallel_checks(r, res, refs, ref_walls, counters):
    """Rank r's tensor-parallel fits against one rank's: losses, logits and
    the parameters after the last step at rtol 1e-4, identical tags, the
    flash launches per step; -> the launches of its fits, decodes and the
    sharded decode."""
    from multimodaltopicsegmentation_torch.parallel.tensor import tree_paths

    total = dict.fromkeys(counters, 0)
    for name, arch, cut in _tp_fits():
        got, want = res[name], refs[f"BiLSTM_{TP_UNITS}" if cut else arch]
        if res[name]["position"] != (0, r):
            raise RuntimeError(f"{name} rank {r}: mesh position {res[name]['position']}")
        steps = len(got["history"])
        if steps != PARALLEL_EPOCHS or len(want["history"]) != steps:
            raise RuntimeError(f"{name} rank {r}: {steps} epochs")
        err = max(_close(f"{name} rank {r} losses", [h["training_loss"] for h in got["history"]],
                         [h["training_loss"] for h in want["history"]]),
                  max(_close(f"{name} rank {r} logits", a, b)
                      for a, b in zip(got["scores"], want["scores"])))
        want_params = dict(tree_paths(want["params"]))
        got_params = dict(tree_paths(got["params"]))
        if sorted(got_params) != sorted(want_params):
            raise RuntimeError(f"{name} rank {r}: parameter tree differs")
        perr = max(_close(f"{name} rank {r} parameter {k}", got_params[k], v)
                   for k, v in want_params.items())
        if got["test"] != want["test"]:
            raise RuntimeError(f"{name} rank {r}: test {got['test']} against one rank's "
                               f"{want['test']} (tags differ)")
        per_step = PARALLEL_STEP_LAUNCHES[name]
        fit_want = dict(zip(counters, (n * PARALLEL_EPOCHS for n in per_step)))
        dec_want = dict(zip(counters, PARALLEL_DECODE_LAUNCHES if arch == "Transformer"
                            else (0, 0, 0, 0)))
        if got["fit"]["launches"] != fit_want or got["decode"]["launches"] != dec_want:
            raise RuntimeError(f"{name} rank {r}: launches fit {got['fit']['launches']} "
                               f"(want {fit_want}), decode {got['decode']['launches']} "
                               f"(want {dec_want})")
        for k in total:
            total[k] += got["fit"]["launches"][k] + got["decode"]["launches"][k]
        fit = got["fit"]
        units = TP_UNITS if cut else 3600
        log(f"[parallel] {name} rank {r} ({arch}, 768 -> 256 x 2, 10 x {units}, mesh data 1 x "
            f"model {TP_MODEL_PARALLEL}): fit of {PARALLEL_EPOCHS} steps {fit['wall']:.3f} s "
            f"(one rank {ref_walls[f'BiLSTM_{TP_UNITS}' if cut else arch]:.3f} s), test decode "
            f"{got['decode']['wall']:.3f} s; a step: staged "
            f"{fit['staged'] / PARALLEL_EPOCHS / 2**20:.2f} MiB, "
            f"{fit['gathers'] / PARALLEL_EPOCHS:.0f} all-gathers and "
            f"{fit['reduces'] / PARALLEL_EPOCHS:.0f} all-reduces over 'model'; peak memory "
            f"{fit['peak'] / 2**20:.1f} MiB a rank against one rank's {want['peak'] / 2**20:.1f} "
            f"MiB; losses and logits {err:.3e}, parameters {perr:.3e} from one rank's (rtol "
            f"1e-4), tags identical; launches a step {dict(zip(counters, per_step))}")
    pred = res["tp_predict"]["fit"]["launches"]
    if pred != dict(zip(counters, PARALLEL_PREDICT_LAUNCHES)):
        raise RuntimeError(f"tensor-parallel decode rank {r}: launches {pred}")
    for k in total:
        total[k] += pred[k]
    return total


def _run_group(cmd, timeout, what):
    """cmd in a session of its own, under `timeout`; every process of the
    session is killed if it runs over. Raises on a non-zero exit."""
    import signal

    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"{what}: still running after {timeout} s, killed")
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)  # nothing of the session outlives it
        except ProcessLookupError:
            pass
    if proc.returncode != 0:
        raise RuntimeError(f"{what}: exit code {proc.returncode}:\n{out[-4000:]}")
    return out


def _torchrun(module, argv, what):
    t0 = time.perf_counter()
    out = _run_group([sys.executable, "-m", "torch.distributed.run", "--standalone",
                      "--nproc_per_node", str(PARALLEL_RANKS), "-m", module, *argv],
                     PARALLEL_TIMEOUT, what)
    if out.count("backend gloo") != PARALLEL_RANKS:
        raise RuntimeError(f"{what}: the ranks did not report backend gloo:\n{out[-2000:]}")
    return time.perf_counter() - t0


def _results_lines(exp):
    with open(os.path.join(exp, "results.txt")) as f:
        return [ln for ln in f.read().splitlines()
                if ln and not ln.startswith("Results for experiment")]


def parallel_cli(emb_dir, labs_file, split_file):
    """torchrun --standalone --nproc_per_node 2 on train_fit -sqs 2 and -pps 2
    (phase 6's train CLI flags: Transformer, 2 epochs, threshold search) and
    on predict with the -sqs run's checkpoint, against phase 6's one-rank
    run and a one-rank predict on that checkpoint."""
    import json
    import pickle

    import numpy as np

    from multimodaltopicsegmentation_torch.cli import predict

    one = os.path.join(WORK, "exp_train_cli")  # phase 6, one rank, the same flags
    flags = ["-ef", emb_dir, "-lf", labs_file, "-split", split_file, *TRAIN_CLI_FLAGS]
    with open(os.path.join(one, "all_scores.json")) as f:
        want_scores = json.load(f)
    walls = {}
    for mode in ("-sqs", "-pps"):
        exp = os.path.join(WORK, f"exp_torchrun{mode}")
        walls[f"train_fit {mode} 2"] = _torchrun(
            "multimodaltopicsegmentation_torch.cli.train_fit", flags + ["-exp", exp, mode, "2"],
            f"torchrun train_fit {mode} 2")
        if _results_lines(exp) != _results_lines(one):
            raise RuntimeError(f"train_fit {mode} 2 on two ranks: {_results_lines(exp)} against "
                               f"one rank's {_results_lines(one)}")
        with open(os.path.join(exp, "all_scores.json")) as f:
            got = json.load(f)
        err = max(_close(f"train_fit {mode} 2 scores of {k}", got[k], want_scores[k])
                  for k in want_scores)
        log(f"[parallel] torchrun train_fit {mode} 2: {walls[f'train_fit {mode} 2']:.3f} s; "
            f"results.txt equal to one rank's; test scores {err:.3e} apart (rtol 1e-4)")
    exp = os.path.join(WORK, "exp_torchrun-sqs")
    ckpt, hyp = os.path.join(exp, "checkpoints", "best_model"), os.path.join(exp, "results.txt")
    common = ["-ef", emb_dir, "-hyp", hyp, "-model", ckpt, "-bs", "8", "-rjs", "--device", "cuda"]
    walls["predict"] = _torchrun("multimodaltopicsegmentation_torch.cli.predict",
                                 common + ["-exp", os.path.join(WORK, "exp_torchrun_predict")],
                                 "torchrun predict")
    predict.cli_main(common + ["-exp", os.path.join(WORK, "exp_torchrun_predict_one")])
    results = []
    for name in ("exp_torchrun_predict", "exp_torchrun_predict_one"):
        with open(os.path.join(WORK, name, "results.pkl"), "rb") as f:
            results.append(pickle.load(f))
    if results[0] != results[1] or len(results[0]) != len(TRAIN_UNITS):
        raise RuntimeError("torchrun predict: tags differ from one rank's")
    log(f"[parallel] torchrun predict on the -sqs checkpoint: {walls['predict']:.3f} s, "
        f"{len(results[0])} documents, tags identical to one rank's "
        f"({int(np.sum([sum(t) for t in results[0].values()]))} boundaries)")
    return walls


def parallel_phase(docs, emb_dir, labs_file, split_file, smi):
    """Phase 11: the parallel layer with two ranks on the one card. -> {kernel
    name: launches of both ranks}."""
    import pickle

    import torch

    from multimodaltopicsegmentation_torch.parallel import mesh as PM
    from multimodaltopicsegmentation_torch.parallel.dryrun import spawn_ranks

    t_phase = time.perf_counter()
    if PM.backend_for(PARALLEL_RANKS, "cuda") != "gloo":
        raise RuntimeError("two ranks on one card must take gloo")
    log(f"[parallel] backend rule: {PARALLEL_RANKS} ranks, {torch.cuda.device_count()} card(s) "
        f"-> {PM.backend_for(PARALLEL_RANKS, 'cuda')}; the compute stays on the card, "
        f"ppermute and all_gather stage through host memory")
    batch, domain_batch, tp_batch = _parallel_batches(docs)
    torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the ranks
    out = os.path.join(WORK, "parallel")
    os.makedirs(out)
    ckpt = os.path.join(WORK, "ckpt_Transformer", "best_model")  # phase 4's, and its predict
    hyp = os.path.join(WORK, "results_Transformer.txt")
    t0 = time.perf_counter()
    spawn_ranks(parallel_rank, PARALLEL_RANKS,
                (out, batch, domain_batch, tp_batch, os.path.join(WORK, "long_emb"), ckpt, hyp),
                "cuda", timeout=PARALLEL_TIMEOUT, store_dir=out)
    spawn_wall = time.perf_counter() - t0
    ranks = []
    for r in range(PARALLEL_RANKS):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    refs, ref_walls = _one_rank_references(batch, domain_batch, tp_batch)

    counters = flash_counters()
    total = dict.fromkeys(counters, 0)
    for r, res in enumerate(ranks):
        if res["backend"] != "gloo" or res["device"] != "cuda:0":
            raise RuntimeError(f"rank {r}: backend {res['backend']} on {res['device']}")
        for name, arch, _, _ in _parallel_fits():
            got, want = res[name], refs[arch]
            steps = len(got["history"])
            if steps != PARALLEL_EPOCHS or len(want["history"]) != steps:
                raise RuntimeError(f"{name} rank {r}: {steps} epochs")
            err = max(_close(f"{name} rank {r} losses", [h["training_loss"] for h in got["history"]],
                             [h["training_loss"] for h in want["history"]]),
                      max(_close(f"{name} rank {r} logits", a, b)
                          for a, b in zip(got["scores"], want["scores"])))
            if got["test"] != want["test"]:
                raise RuntimeError(f"{name} rank {r}: test {got['test']} against one rank's "
                                   f"{want['test']} (tags differ)")
            per_step = PARALLEL_STEP_LAUNCHES[name]
            fit_want = dict(zip(counters, (n * PARALLEL_EPOCHS for n in per_step)))
            # decode: 2 layers a batch, or none for the LSTM taggers
            dec_want = dict(zip(counters, PARALLEL_DECODE_LAUNCHES if arch == "Transformer"
                                else (0, 0, 0, 0)))
            if got["fit"]["launches"] != fit_want or got["decode"]["launches"] != dec_want:
                raise RuntimeError(f"{name} rank {r}: launches fit {got['fit']['launches']} "
                                   f"(want {fit_want}), decode {got['decode']['launches']} "
                                   f"(want {dec_want})")
            if name == "expert_switch" and not got["expert"]:
                raise RuntimeError("SwitchBiLSTM('lstm') on two ranks did not take expert mode")
            for k in total:
                total[k] += got["fit"]["launches"][k] + got["decode"]["launches"][k]
            if r == 0:
                log(f"[parallel] {name} ({arch}, 768 -> 256 x 2, 8 heads, window 120, 10 x 3600 "
                    f"over 2 ranks): fit of {PARALLEL_EPOCHS} steps {got['fit']['wall']:.3f} s "
                    f"(one rank {ref_walls[arch]:.3f} s), test decode {got['decode']['wall']:.3f} "
                    f"s; staged {got['fit']['staged'] / PARALLEL_EPOCHS / 2**20:.2f} MiB a step; "
                    f"losses and logits {err:.3e} from one rank's (rtol 1e-4), tags identical; "
                    f"launches a step {dict(zip(counters, per_step))}")
        grid = res["grid"]  # each configuration's own fit, on its rank: phase 10's grid gate
        if grid["paths"] != refs["grid"]["paths"]:
            raise RuntimeError(f"grid over 2 ranks, rank {r}: snapshots {grid['paths']} against "
                               f"the serial grid's {refs['grid']['paths']}")
        grid_err = max(_close(f"grid configuration {g} rank {r}",
                              [h["training_loss"] for h in got_h],
                              [h["training_loss"] for h in want_h], rtol=1e-5)
                       for g, (got_h, want_h) in enumerate(zip(grid["histories"],
                                                               refs["grid"]["histories"])))
        pred = res["predict"]["fit"]["launches"]
        if pred != dict(zip(counters, PARALLEL_PREDICT_LAUNCHES)):
            raise RuntimeError(f"sharded predict rank {r}: launches {pred}")
        for k in total:
            total[k] += pred[k]
        tp_launches = tensor_parallel_checks(r, res, refs, ref_walls, counters)
        for k in total:
            total[k] += tp_launches[k]
    with open(os.path.join(WORK, "parallel", "predict", "results.pkl"), "rb") as f:
        sharded = pickle.load(f)
    with open(os.path.join(WORK, "exp_Transformer", "results.pkl"), "rb") as f:
        one = pickle.load(f)
    if sharded != one:
        raise RuntimeError("the sharded predict's tags differ from phase 4's one-rank predict")
    with open(os.path.join(WORK, "parallel", "tp_predict", "results.pkl"), "rb") as f:
        if pickle.load(f) != one:
            raise RuntimeError("the tensor-parallel decode's tags differ from phase 4's predict")
    log(f"[parallel] tensor-parallel decode (model {TP_MODEL_PARALLEL}) of phase 4's "
        f"{len(DOC_UNITS)} files: {ranks[0]['tp_predict']['fit']['wall']:.3f} s, "
        f"{ranks[0]['tp_predict']['fit']['reduces']} all-reduces and "
        f"{ranks[0]['tp_predict']['fit']['gathers']} all-gathers over 'model' a rank, staged "
        f"{ranks[0]['tp_predict']['fit']['staged'] / 2**20:.2f} MiB, results.pkl equal to "
        f"phase 4's; the NCCL branch needs a card per rank and cannot run on this one card")
    log(f"[parallel] GridTrainer(mesh) G = {len(PARALLEL_GRID)} BiLSTM, {PARALLEL_GRID_EPOCHS} "
        f"epochs: {ranks[0]['grid']['fit']['wall']:.3f} s on 2 ranks against "
        f"{ref_walls['grid']:.3f} s serial, losses {grid_err:.3e} apart (rtol 1e-5), the same "
        f"snapshots; sharded predict over "
        f"{len(DOC_UNITS)} files: {ranks[0]['predict']['fit']['wall']:.3f} s, tags identical to "
        f"phase 4's; the spawn (start-up included) {spawn_wall:.1f} s")
    cli_walls = parallel_cli(emb_dir, labs_file, split_file)
    log(f"[parallel] phase 11 on {smi}: {time.perf_counter() - t_phase:.1f} s (spawn "
        f"{spawn_wall:.1f} s, torchrun calls {sum(cli_walls.values()):.1f} s); launches of both "
        f"ranks {total}")
    return total


# -- phase 12: the remaining user surface (native loader, -lgr, reference checkpoints, metrics) --

LOGREG_MODEL = os.path.join(ROOT, "tests", "data", "logreg_prosodic_167.pkl")


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def native_resample_plain(x, sr_in, sr_out):
    """The native loader's resampler in float64 numpy: its Kaiser-windowed
    sinc (beta 8, cutoff 0.95 of the lower Nyquist, 32 zero crossings a
    side, I0 by its 32-term series) through scipy's upfirdn. For a
    downsampling ratio the filter's half length is a multiple of `down`, so
    output m is upfirdn's m + half / down."""
    from math import gcd

    import numpy as np
    from scipy.signal import upfirdn

    g = gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    if down < up:
        raise ValueError("native_resample_plain covers downsampling only")
    half, cutoff = 32 * down, 0.95 * 0.5 / down
    k = 2.0 * np.arange(1, 32)

    def i0(v):
        return 1.0 + np.cumprod((v[:, None] / k) ** 2, axis=1).sum(axis=1)

    n = np.arange(-half, half + 1, dtype=np.float64)
    sinc = np.where(n == 0, 2 * cutoff, np.sin(2 * np.pi * cutoff * n) / (np.pi * np.where(n == 0, 1, n)))
    window = i0(8.0 * np.sqrt(np.maximum(0.0, 1.0 - (n / half) ** 2))) / i0(np.array([8.0]))
    n_out = len(x) * up // down
    y = upfirdn(sinc * window * up, np.asarray(x, np.float64), up, down)
    return y[half // down : half // down + n_out]


def native_loader_checks():
    """Phase 9's 16 kHz broadcasts through the native loader, bit-equal to
    scipy's read, one by one and as a batch. A 44.1 kHz copy of the 150-s
    broadcast resampled to 16 kHz within 1e-6 of the resampler's float64
    plain version; a 440 Hz tone at 44.1 kHz within 5e-3 of scipy's
    resample_poly (the JAX package's own bound and input). The broadcast's
    distance to resample_poly is printed, not gated: the two filters differ
    in their transition band (0.95 of 8 kHz, Kaiser beta 8, against scipy's
    8 kHz, beta 5), where the broadcast's sentence onsets put energy."""
    import numpy as np
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    from multimodaltopicsegmentation_torch.runtime import audio_native

    audio_dir = os.path.join(WORK, "front_corpus", "audio")
    paths = [os.path.join(audio_dir, f"doc{d}.wav") for d in range(len(MAIN_SECONDS))]
    native, wall = _timed(lambda: [audio_native.read_wav(p) for p in paths])
    batch, batch_wall = _timed(lambda: audio_native.read_wav_batch(paths))
    scipy_read, scipy_wall = _timed(lambda: [wavfile.read(p) for p in paths])
    for p, (a, sr), (b, bsr), (ssr, ref) in zip(paths, native, batch, scipy_read):
        if not (sr == bsr == ssr == SR and ref.dtype == np.float32
                and a.tobytes() == ref.tobytes() == b.tobytes()):
            raise RuntimeError(f"native loader: {os.path.basename(p)} differs from scipy's read")
    copy = os.path.join(WORK, "doc1_44k.wav")
    wavfile.write(copy, 44100, resample_poly(scipy_read[1][1], 441, 160).astype(np.float32))
    (got, sr), res_wall = _timed(lambda: audio_native.read_wav(copy, SR))
    x44 = wavfile.read(copy)[1]
    plain, plain_wall = _timed(lambda: native_resample_plain(x44, 44100, SR))
    err = float(np.abs(got - plain).max())
    want = resample_poly(x44, 160, 441)
    poly_err = float(np.abs(got[1000:-1000] - want[1000:-1000]).max())
    t = np.arange(2 * 44100) / 44100
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    tone_got, tone_want = audio_native.resample(tone, 44100, SR), resample_poly(tone, 160, 441)
    tone_err = float(np.abs(tone_got[1000:-1000] - tone_want[1000:-1000]).max())
    if sr != SR or len(got) != len(plain) or not err < 1e-6 or not tone_err < 5e-3:
        raise RuntimeError(f"native resample 44.1 -> 16 kHz: {len(got)} vs {len(plain)} samples, "
                           f"max_abs_err {err:.3e} against the plain version (limit 1e-6), "
                           f"{tone_err:.3e} against resample_poly on a tone (limit 5e-3)")
    samples = sum(len(a) for a, _ in native)
    log(f"[surface] native read_wav of phase 9's {len(paths)} broadcasts ({samples} samples): "
        f"{wall:.3f} s, read_wav_batch {batch_wall:.3f} s, scipy {scipy_wall:.3f} s; bit-equal to "
        f"scipy; 44.1 kHz copy of doc1 to 16 kHz {res_wall:.3f} s (plain float64 version "
        f"{plain_wall:.3f} s), max_abs_err {err:.3e} against it (limit 1e-6) and {poly_err:.3e} "
        f"against resample_poly (not gated); a 440 Hz tone {tone_err:.3e} against resample_poly "
        f"(limit 5e-3)")


def _pickled(path):
    import pickle

    with open(path, "rb") as f:
        return pickle.load(f)


def _files(folder):
    from pathlib import Path

    return {p.name: p.read_bytes() for p in sorted(Path(folder).iterdir())}


def logreg_predict():
    """predict -lgr -ee over phase 9's corpus on cuda (prosodic features on
    the card, the pickled LogisticRegression applied in float64 there), then
    -lgr on cpu over the features the card extracted: the same results.pkl
    and segment wavs. (Card and CPU prosodic features differ where pYIN's
    states do, phase 9's gate, so each device classifies the same features.)"""
    import torch

    from multimodaltopicsegmentation_torch.cli.predict import cli_main

    audio_dir = os.path.join(WORK, "front_corpus", "audio")
    emb = os.path.join(WORK, "lgr_emb")
    exps = {d: os.path.join(WORK, f"exp_lgr_{d}") for d in ("cuda", "cpu")}
    common = ["-lgr", "-model", LOGREG_MODEL, "-af", audio_dir, "-ef", emb, "-ui", "1.0"]
    torch.cuda.synchronize()
    _, wall = _timed(lambda: cli_main(common + ["-ee", "-exp", exps["cuda"], "--device", "cuda"]))
    _, cpu_wall = _timed(lambda: cli_main(common + ["-exp", exps["cpu"], "--device", "cpu"]))
    results = _pickled(os.path.join(exps["cuda"], "results.pkl"))
    for d, dur in enumerate(MAIN_SECONDS):
        tags = results.get(f"doc{d}.npy")
        if tags is None or len(tags) != int(dur) or set(tags) - {0, 1}:
            raise RuntimeError(f"-lgr: doc{d} got {tags and len(tags)} tags for {int(dur)} units")
    if _files(exps["cuda"]) != _files(exps["cpu"]):
        raise RuntimeError("-lgr: results.pkl or segment wavs differ between cuda and cpu")
    found = sum(sum(t) for t in results.values())
    wavs = sum(n.endswith(".wav") for n in os.listdir(exps["cuda"]))
    log(f"[surface] predict -lgr -ee on cuda: {sum(MAIN_SECONDS) / 60:.2f} audio-min in {wall:.3f} "
        f"s = {sum(MAIN_SECONDS) / 60 / wall:.3f} audio-min/s; {found} boundaries in "
        f"{sum(map(len, results.values()))} units, {wavs} segment wavs; -lgr on cpu over the same "
        f"features {cpu_wall:.3f} s: results.pkl and wavs identical")


def _reference_layout(tagger, architecture):
    """A port tagger's weights as a reference Lightning checkpoint's state
    dict: the BiLSTM's names are the reference's one to one; the
    Transformer's become HF Longformer names (position ids from padding_idx
    + 1 = 2, so two rows before the table; one token type, zero; the global
    projections HF builds and the converter leaves unread)."""
    import torch

    sd = {}
    for k, v in tagger.state_dict().items():
        v = v.detach().cpu()
        if architecture == "Transformer" and k.endswith("embeddings.position_table"):
            sd["model.model.embeddings.position_embeddings.weight"] = \
                torch.cat([v.new_zeros(2, v.shape[1]), v])
            sd["model.model.embeddings.token_type_embeddings.weight"] = v.new_zeros(1, v.shape[1])
            continue
        sd[k] = v
        if architecture == "Transformer" and k.endswith("attention.self.query.weight"):
            for g in ("query_global", "key_global", "value_global"):
                sd[k.replace("query.weight", f"{g}.weight")] = v
                sd[k.replace("query.weight", f"{g}.bias")] = v.new_zeros(v.shape[0])
    return {"model." + k: v for k, v in sd.items()}


def reference_checkpoints(flash_fwd):
    """Phase 3's BiLSTM and phase 4's Transformer written as reference
    Lightning checkpoints and served by predict on cuda over phase 4's files
    through the converter; results.pkl equal to the port checkpoint's (phase
    4's own for the Transformer), 4 K2 launches for the Transformer.
    -> K2 launches."""
    import torch

    from multimodaltopicsegmentation_torch.cli.predict import cli_main
    from multimodaltopicsegmentation_torch.models import registry
    from multimodaltopicsegmentation_torch.train import checkpoints

    emb = os.path.join(WORK, "long_emb")
    launches = 0
    for arch, ckpt, hyp in (
            ("BiLSTM", os.path.join(WORK, "ckpt", "best_model"), os.path.join(WORK, "results.txt")),
            ("Transformer", os.path.join(WORK, "ckpt_Transformer", "best_model"),
             os.path.join(WORK, "results_Transformer.txt"))):
        params, cfg, name, _ = checkpoints.load(ckpt)
        tagger = registry.build(name, cfg)
        tagger.load_state_dict(type(tagger).from_jax_params(params))
        ref = os.path.join(WORK, f"ref_{arch}.ckpt")
        state_dict = _reference_layout(tagger, arch)
        torch.save({"state_dict": state_dict, "hyper_parameters": {}}, ref)
        common = ["-ef", emb, "-hyp", hyp, "-bs", "8", "-rjs", "-th", "0.5", "--device", "cuda"]
        want = os.path.join(WORK, f"exp_{arch}")  # phase 4's run for the Transformer
        if arch == "BiLSTM":
            cli_main(common + ["-model", ckpt, "-exp", want])
        torch.cuda.synchronize()
        flash_fwd.launches = 0
        exp = os.path.join(WORK, f"exp_ref_{arch}")
        _, wall = _timed(lambda: cli_main(common + ["-model", ref, "-exp", exp]))
        torch.cuda.synchronize()
        n = flash_fwd.launches
        if n != (4 if arch == "Transformer" else 0):
            raise RuntimeError(f"reference {arch}: {n} flash launches")
        launches += n
        got, expected = (_pickled(os.path.join(e, "results.pkl")) for e in (exp, want))
        if got != expected:
            raise RuntimeError(f"reference {arch} checkpoint: results.pkl differs from the port "
                               "checkpoint's")
        log(f"[surface] reference-layout {arch} checkpoint ({len(state_dict)} "
            f"tensors) through predict's converter fallback on cuda: {wall:.3f} s (load, "
            f"convert, decode of {len(DOC_UNITS)} files); results.pkl equal to the port "
            f"checkpoint's; flash launches {n}")
    return launches


def metrics_cli():
    """The post-hoc metrics CLI on a synthetic experiment tree of the
    reference's layout: 3 encoders x 10 test documents; the CSV's header and
    rows checked. Neither sklearn nor pandas is imported."""
    import csv
    import importlib.util
    import pickle

    import numpy as np

    from multimodaltopicsegmentation_torch.cli.compute_accuracy_metrics_sentence import cli_main

    rng = np.random.default_rng(12)
    root = os.path.join(WORK, "metrics", "RadioNewsSentence")
    os.makedirs(os.path.join(root, "RadioNewsSentence"))
    files = [f"doc{d}.npy" for d in range(10)]
    labs = {}
    for f in files:
        lab = (rng.random(int(rng.integers(40, 120))) < 0.1).astype(int)
        lab[-1] = 1
        labs[f[:-4]] = lab.tolist()
    with open(os.path.join(root, "RadioNewsSentence", "labs_dict.pkl"), "wb") as fh:
        pickle.dump(labs, fh)
    with open(os.path.join(root, "RadioNews_split.json"), "w") as fh:
        json.dump({"train": [], "test": files, "validation": []}, fh)
    encoders = ["radio_news_topseg", "x-vectors",
                "openl3/_mean_std+radio_news_roberta+radio_news_topseg"]
    for enc in encoders:
        out = os.path.join(root, "UnimodalExperiments", "BiLSTM_bs10_" + enc)
        os.makedirs(out)
        scores = {f: (4 * np.asarray(labs[f[:-4]]) - 2 + rng.standard_normal(len(labs[f[:-4]]))
                      ).tolist() for f in files}
        with open(os.path.join(out, "all_scores.json"), "w") as fh:
            json.dump(scores, fh)
    csv_path = os.path.join(WORK, "metrics", "final_result_bilstm.csv")
    table, wall = _timed(lambda: cli_main(["radionews", "--root", root, "--encoders", *encoders,
                                          "--output", csv_path]))
    with open(csv_path, newline="") as f:
        rows = list(csv.reader(f))
    metric_cols = ["Precision", "Recall", "F1", "B-F1", "B-Precision", "B-Recall"]
    if rows[0][:2] != ["", "Precision"] or len(rows) != 4 or rows[0][1:] != list(table) \
            or [r[0] for r in rows[1:]] != ["0", "1", "2"] \
            or [r[rows[0].index("embedding")] for r in rows[1:]] != encoders \
            or not all(0 <= float(r[rows[0].index(c)]) <= 1 for r in rows[1:] for c in metric_cols) \
            or "F1 P-value 4" not in rows[0]:
        raise RuntimeError(f"metrics CLI: unexpected CSV {rows[:2]}")
    imported = sorted(m for m in ("sklearn", "pandas") if m in sys.modules)
    if imported:
        raise RuntimeError(f"metrics CLI: {imported} imported")
    installed = [m for m in ("sklearn", "pandas") if importlib.util.find_spec(m)]
    log(f"[surface] metrics CLI: {len(rows) - 1} rows x {len(rows[0]) - 1} columns in {wall:.3f} s "
        f"(10,000 bootstrap samples per cell); sklearn and pandas not imported (installed here: "
        f"{installed or 'neither'})")


def text_corpus_check():
    from multimodaltopicsegmentation_torch.utils.text_corpora import load_text_dataset

    root = os.path.join(WORK, "choi")
    os.makedirs(os.path.join(root, "3-5"))
    with open(os.path.join(root, "3-5", "0.ref"), "w") as f:
        f.write("==========\nThe first topic starts.\nIt goes on.\n==========\nA second one.\n"
                "==========\nA third.\nAnd its end.\n==========\n")
    docs = load_text_dataset("choi", root)
    want = ["The first topic starts.", "It goes on.", "A second one.", "A third.", "And its end."]
    if len(docs) != 1 or docs[0][0] != want or docs[0][1] != [0, 1, 1, 0, 1]:
        raise RuntimeError(f"load_text_dataset('choi'): {docs}")
    log(f"[surface] load_text_dataset('choi'): 1 document, {len(want)} sentences, labels "
        f"{docs[0][1]}")


def mp3_check():
    """load_audio of an mp3: decoded through pygame where it is installed,
    else the JAX package's error naming the missing decoder."""
    import importlib.util

    from multimodaltopicsegmentation_torch.utils.audio import load_audio

    spec = importlib.util.find_spec("pygame")
    sample = os.path.join(os.path.dirname(spec.origin), "examples", "data",
                          "house_lo.mp3") if spec else None
    if sample and os.path.exists(sample):
        audio, sr = load_audio(sample)
        if sr != SR or audio.ndim != 1 or not 7.0 < len(audio) / sr < 7.5:
            raise RuntimeError(f"mp3 decode: {audio.shape} at {sr}")
        log(f"[surface] mp3: pygame decoded {os.path.basename(sample)}, {len(audio) / sr:.2f} s")
        return
    path = os.path.join(WORK, "no_decoder.mp3")
    open(path, "wb").close()
    try:
        load_audio(path)
    except RuntimeError as e:
        if "mp3 decoding needs the 'pygame' package" not in str(e):
            raise
        log(f"[surface] mp3: no pygame here, load_audio raised: {e}")
        return
    raise RuntimeError("load_audio of an mp3 without pygame did not raise")


def surface_phase(flash_fwd, smi):
    """Phase 12; -> K2 launches (the reference Transformer's predict)."""
    t_phase = t = time.perf_counter()
    launches = 0
    for what, run in (("native loader", native_loader_checks),
                      ("predict -lgr", logreg_predict),
                      ("reference checkpoints", lambda: reference_checkpoints(flash_fwd)),
                      ("metrics CLI", metrics_cli), ("text corpora", text_corpus_check),
                      ("mp3", mp3_check)):
        launches += run() or 0
        log(f"[surface] {what}: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
    log(f"[surface] phase 12 on {smi}: {time.perf_counter() - t_phase:.1f} s")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 1
    from multimodaltopicsegmentation_torch.core import cuda_build
    from multimodaltopicsegmentation_torch.core.torch_setup import resolve_device
    from multimodaltopicsegmentation_torch.ops import flash_attention as k2
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
    for name, (secs, nvcc_log) in cuda_build.build_all(cuda_build.KERNELS
                                                       + cuda_build.HOST_LIBRARIES).items():
        what = (f"{cuda_build._cxx()} {' '.join(cuda_build.host_flags())}"
                if name in cuda_build.HOST_LIBRARIES else "; ".join(ptxas_summary(nvcc_log)))
        log(f"[build] {name}: {secs:.2f} s; {what}")
    if sys.argv[1:] == ["--no-key-rows"]:
        log(json.dumps({"no_key_rows": no_key_rows_ab(dev)}))
        return 0
    kernels = {"instance_norm_gelu": k1.instance_norm_gelu}

    t = time.perf_counter()
    results = {"instance_norm_gelu": check_instance_norm_gelu(dev)}
    results.update(check_flash_attention(dev))
    results.update(check_flash_backward(dev))
    check_autograd_entries(dev)
    log(f"[phase] kernels vs plain: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches = main_path(kernels)
    log(f"[phase] main path: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    long_launches, taggers = long_document_path(k2._flash_fwd, k2.fused_local_attention)
    launches.update(long_launches)
    log(f"[phase] long-document path: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    breakdown()
    breakdown_taggers(taggers)
    log(f"[phase] breakdown: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    emb_dir, labs_file, split_file, docs = write_corpus(os.path.join(WORK, "train_corpus"),
                                                        TRAIN_UNITS, seed=0)
    for phase in (training_path(docs), remat_path(docs),
                  train_cli_path(emb_dir, labs_file, split_file)):
        for name, n in phase.items():
            launches[name] = launches.get(name, 0) + n
    log(f"[phase] training path: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    card_vs_cpu()
    taggers_card_vs_cpu(taggers)
    training_card_vs_cpu(docs)
    log(f"[phase] card vs cpu: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    zoo_phase(docs, emb_dir, labs_file, split_file)
    log(f"[phase] tagger zoo: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches["instance_norm_gelu"] += frontend_phase(k1.instance_norm_gelu)
    log(f"[phase] front-end: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    for name, n in completeness_phase(docs, emb_dir, labs_file, split_file).items():
        launches[name] = launches.get(name, 0) + n
    log(f"[phase] training completeness: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    for name, n in parallel_phase(docs, emb_dir, labs_file, split_file, smi).items():
        launches[name] = launches.get(name, 0) + n
    log(f"[phase] parallel: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches["flash_local_attention"] += surface_phase(k2._flash_fwd, smi)
    log(f"[phase] remaining surface: {time.perf_counter() - t:.1f} s")

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
