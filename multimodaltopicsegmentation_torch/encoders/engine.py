"""Batched unit-encoding engine (counterpart of the JAX package's
encoders/engine.py).

A document's units are packed into zero-padded [U, S] batches and encoded on
the device in chunks:
- unit-level DSP encoders (prosodic 167-d, mfcc 200-d) run dsp/prosody.py;
  prosodic chunks carry one unit of left context so that the pitch-jump
  chain survives chunking;
- wav2vec2 runs the transformer over 256-row chunks and slices each unit's
  valid frames;
- x-vector, ECAPA, OpenL3 and CREPE live in tdnn.py, openl3.py, crepe.py.

Encoders without weights raise unless MTS_RANDOM_ENCODER_WEIGHTS=1
(random-weight smoke mode, announced); explicit weights always win.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ..core.torch_setup import resolve_device
from ..utils import profiling
from . import wav2vec2 as W
from .engine_util import bucket_rows, pad_units, traced_encode

SR = 16000


class ProsodicEncoder:
    name = "prosodic"
    dim = 167
    frame_level = False

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    @traced_encode
    @torch.inference_mode()
    def encode_document(self, audio, bounds, chunk=256):
        from ..dsp.prosody import prosodic_features

        units, lens = pad_units(audio, bounds, bucket=True)
        outs = []
        i = 0
        while i < len(bounds):
            lo = max(i - 1, 0)  # one unit of left context for pitch jumps
            hi = min(i + chunk, len(bounds))
            # rows to a multiple of 8 (padded rows have length 0, dropped below)
            u, l = bucket_rows(units[lo:hi], lens[lo:hi], 8)
            feats = prosodic_features(torch.from_numpy(u).to(self.device),
                                      torch.from_numpy(l).to(self.device), SR)
            outs.append(feats[: hi - lo][i - lo :].cpu().numpy())
            i = hi
        return [f for f in np.concatenate(outs, axis=0)]


class MFCCEncoder:
    name = "mfcc"
    dim = 200
    frame_level = False

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    @traced_encode
    @torch.inference_mode()
    def encode_document(self, audio, bounds, chunk=256):
        from ..dsp.prosody import mfcc_features

        units, lens = pad_units(audio, bounds, bucket=True)
        outs = []
        for i in range(0, len(bounds), chunk):
            n = min(chunk, len(bounds) - i)
            u, l = bucket_rows(units[i : i + chunk], lens[i : i + chunk], 32)
            feats = mfcc_features(torch.from_numpy(u).to(self.device),
                                  torch.from_numpy(l).to(self.device), SR)
            outs.append(feats[:n].cpu().numpy())
        return [f for f in np.concatenate(outs, axis=0)]


class Wav2Vec2Encoder:
    name = "wav2vec"
    dim = 768
    frame_level = True

    def __init__(self, name_or_path: str = "facebook/wav2vec2-base-960h", device="cuda"):
        self.device = resolve_device(device)
        # explicit weights (MTS_WAV2VEC2_WEIGHTS, a local HF checkpoint)
        # always win over the random-weight smoke mode
        weights = os.environ.get("MTS_WAV2VEC2_WEIGHTS") or None
        if weights is None and os.environ.get("MTS_RANDOM_ENCODER_WEIGHTS") == "1":
            print(
                "WARNING: MTS_RANDOM_ENCODER_WEIGHTS=1 — wav2vec2 runs with "
                "RANDOM weights (smoke-test mode, embeddings are meaningless)"
            )
            self.cfg = W.Wav2Vec2Config.base()
            state = W.random_state_dict(self.cfg, seed=0)
        else:
            state, self.cfg = W.load_pretrained(weights or name_or_path)
        self.model = W.build_model(self.cfg, state, self.device)

    @traced_encode
    def encode_document(self, audio, bounds, chunk=256) -> List[np.ndarray]:
        """-> one [frames, hidden] array per unit of `bounds`."""
        with profiling.span("encode_document.pack"):
            units, lens = pad_units(audio, bounds, bucket=True)
        outs: List[np.ndarray] = []
        for i in range(0, len(bounds), chunk):
            nb = min(chunk, len(bounds) - i)
            with profiling.span("encode_document.pack"):
                # the ragged tail chunk is bucketed to a multiple of 32 rows;
                # the zero-length padded rows are dropped below
                u, l = bucket_rows(units[i : i + chunk], lens[i : i + chunk], 32, cap=chunk)
            with torch.inference_mode():
                with profiling.span("encode_document.to_device",
                                    bytes_to_device=u.nbytes + l.nbytes):
                    u, l = torch.from_numpy(u).to(self.device), torch.from_numpy(l).to(self.device)
                with profiling.span("encode_document.forward"):
                    frames = self.model(u, l)
                with profiling.span("encode_document.to_host") as to_host:
                    frames = frames[:nb].cpu().numpy()
                    to_host.add("bytes_to_host", frames.nbytes)
            with profiling.span("encode_document.slice"):
                for row, n in zip(frames, lens[i : i + chunk]):
                    t = W.feature_extractor_output_length(self.cfg, int(n))
                    outs.append(row[: max(t, 1)])
        return outs


class _WeightlessEncoder:
    """An encoder whose pretrained stack is not available: in random-weight
    smoke mode it serves a fixed random projection of log-mel statistics
    (tdnn.RandomProjectionEncoder), else it raises."""

    def __init__(self, name, dim, frame_level=False, device="cuda"):
        self.name = name
        self.dim = dim
        self.frame_level = frame_level
        self.device = resolve_device(device)

    def encode_document(self, audio, bounds, chunk=256):
        if os.environ.get("MTS_RANDOM_ENCODER_WEIGHTS") != "1":
            raise RuntimeError(
                f"encoder '{self.name}' needs pretrained weights that are not "
                "available in this environment (no network egress). Use "
                "prosodic/mfcc (weight-free) or wav2vec with a local "
                "checkpoint, or set MTS_RANDOM_ENCODER_WEIGHTS=1 for a "
                "random-weight smoke test."
            )
        from .tdnn import RandomProjectionEncoder

        return RandomProjectionEncoder(self.dim, self.frame_level, self.device).encode_document(
            audio, bounds, chunk
        )


def build_encoder(args, device="cuda"):
    """Encoder selection with the reference's flag priority
    (extract_embeddings.py:140-197): ecapa > openl3 > prosodic > mfcc >
    wav2vec > CREPE > x-vectors (the default). OpenL3 takes its mel256
    inference variant when `args._inference_variant` is set."""
    device = resolve_device(device)
    if getattr(args, "ecapa", False):
        from .tdnn import EcapaEncoder

        return EcapaEncoder(device=device)
    if getattr(args, "openl3", False):
        from .openl3 import OpenL3Encoder

        # training used mel128/env, inference mel256/music
        n_mels = 256 if getattr(args, "_inference_variant", False) else 128
        return OpenL3Encoder(n_mels=n_mels, device=device)
    if getattr(args, "prosodic_feats", False):
        return ProsodicEncoder(device)
    if getattr(args, "mfcc", False):
        return MFCCEncoder(device)
    if getattr(args, "wav2vec", False):
        return Wav2Vec2Encoder(device=device)
    if getattr(args, "CREPE", False):
        from .crepe import CrepeEncoder

        return CrepeEncoder(device=device)
    from .tdnn import XVectorEncoder

    return XVectorEncoder(device=device)
