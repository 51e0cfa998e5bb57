"""Batched unit-encoding engine (counterpart of the JAX package's
encoders/engine.py, wav2vec2 only).

A document's units are packed into padded [U, S] batches, encoded on the
device in chunks of 256 rows, and each unit's valid frames are sliced out.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ..core.torch_setup import resolve_device
from . import wav2vec2 as W
from .engine_util import bucket_rows, pad_units

SR = 16000


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

    def encode_document(self, audio, bounds, chunk=256) -> List[np.ndarray]:
        """-> one [frames, hidden] array per unit of `bounds`."""
        units, lens = pad_units(audio, bounds, bucket=True)
        outs: List[np.ndarray] = []
        for i in range(0, len(bounds), chunk):
            nb = min(chunk, len(bounds) - i)
            # the ragged tail chunk is bucketed to a multiple of 32 rows;
            # the zero-length padded rows are dropped below
            u, l = bucket_rows(units[i : i + chunk], lens[i : i + chunk], 32, cap=chunk)
            with torch.inference_mode():
                frames = self.model(
                    torch.from_numpy(u).to(self.device), torch.from_numpy(l).to(self.device)
                )[:nb].cpu().numpy()
            for row, n in zip(frames, lens[i : i + chunk]):
                t = W.feature_extractor_output_length(self.cfg, int(n))
                outs.append(row[: max(t, 1)])
        return outs


def build_encoder(args, device="cuda"):
    """Encoder selection; this slice of the port has wav2vec2 only."""
    if getattr(args, "wav2vec", False):
        return Wav2Vec2Encoder(device=device)
    raise NotImplementedError(
        "only the wav2vec encoder is ported so far; the DSP encoders "
        "(prosodic, mfcc) and the other pretrained encoders (openl3, x-vector, "
        "ecapa, CREPE) are ROADMAP.md section 1 items 11 and 12"
    )
