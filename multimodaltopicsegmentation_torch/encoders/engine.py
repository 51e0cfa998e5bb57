"""Batched unit-encoding engine (counterpart of the JAX package's
encoders/engine.py).

A document's units are packed into zero-padded [U, S] batches and encoded on
the device in chunks:
- unit-level DSP encoders (prosodic 167-d, mfcc 200-d) run dsp/prosody.py;
  prosodic chunks carry one unit of left context so that the pitch-jump
  chain survives chunking;
- wav2vec2, WavLM or w2v-BERT 2.0 (by the checkpoint's config) runs the
  transformer over 256-row chunks, one chunk ahead of the copy of its frames
  to the host (through two pinned staging slots), and slices each unit's
  valid frames;
- x-vector, ECAPA, OpenL3 and CREPE live in tdnn.py, openl3.py, crepe.py.

Encoders without weights raise unless MTS_RANDOM_ENCODER_WEIGHTS=1
(random-weight smoke mode, announced); explicit weights always win.
MTS_WAV2VEC2_WEIGHTS names a local HF checkpoint directory of wav2vec2,
WavLM or w2v-BERT 2.0 (facebook/w2v-bert-2.0, `model_type`
"wav2vec2-bert"); its config.json says which model `--wav2vec` runs.
"""
from __future__ import annotations

import os
from typing import List, NamedTuple

import numpy as np
import torch

from ..core.torch_setup import resolve_device
from ..utils import profiling
from . import w2v_bert as B
from . import wav2vec2 as W
from .engine_util import bucket_rows, pad_units, traced_encode, unit_lengths

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
    """wav2vec2 or WavLM, as `encoders/wav2vec2.py` runs them, or w2v-BERT 2.0
    (`encoders/w2v_bert.py`): the checkpoint's config.json says which. Each
    model's own rule gives a unit's frames (`frames`)."""

    name = "wav2vec"
    frame_level = True
    _slots = None  # _StagingSlots, made at the first encode_document

    @property
    def dim(self) -> int:
        return self.cfg.hidden_size

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
        self.model = _model_module(self.cfg).build_model(self.cfg, state, self.device)

    @classmethod
    def from_state(cls, cfg, state_dict: dict, device="cuda") -> "Wav2Vec2Encoder":
        """The encoder around weights already in hand: `cfg` a
        `wav2vec2.Wav2Vec2Config` or a `w2v_bert.W2VBertConfig`, `state_dict`
        the module's own (as `load_pretrained` returns it)."""
        enc = cls.__new__(cls)
        enc.device, enc.cfg = resolve_device(device), cfg
        enc.model = _model_module(cfg).build_model(cfg, state_dict, enc.device)
        return enc

    def frames(self, n_samples):
        """Frames the model makes of `n_samples` samples (an int or an int
        tensor): the conv stack's count, or w2v-BERT's fbank rows."""
        if isinstance(self.cfg, B.W2VBertConfig):
            return B.output_length(n_samples)
        return W.feature_extractor_output_length(self.cfg, n_samples)

    @traced_encode
    def encode_document(self, audio, bounds, chunk=256) -> List[np.ndarray]:
        """-> one [frames, hidden] array per unit of `bounds`.

        The units are cut to one document-wide padded length S (as
        `unit_lengths(bounds, bucket=True)` gives it) and run through the
        transformer in chunks of `chunk` rows, one chunk ahead: chunk i+1's
        forward is queued before chunk i's frames are drained to the host.
        Each chunk is packed into a staging slot (pinned on a CUDA device),
        copied in and its frames copied back without blocking, and an event
        after the copy back says when the slot is free again."""
        with profiling.span("encode_document.pack"):
            lens, S = unit_lengths(bounds, bucket=True)
            T = self.frames(S)
            out = np.empty((len(bounds), T, self.cfg.hidden_size), np.float32)
        cuda = self.device.type == "cuda"
        if self._slots is None:
            self._slots = _StagingSlots(pinned=cuda)
        slots = self._slots.views(chunk, S, T, self.cfg.hidden_size)
        outs: List[np.ndarray] = []
        pending = None  # (slot, first unit, rows, event) of the chunk not yet drained
        for c, i in enumerate(range(0, len(bounds), chunk)):
            slot = slots[c % 2]  # free: its last chunk (c - 2) was drained
            nb = min(chunk, len(bounds) - i)
            # the ragged tail chunk is bucketed to a multiple of 32 rows;
            # the zero-length padded rows are dropped below
            nbb = min(chunk, 32 * -(-nb // 32))
            with profiling.span("encode_document.pack"):
                _pack(slot, audio, bounds[i : i + nb], lens[i : i + nb], nbb)
            with torch.inference_mode():
                u, l = slot.audio[:nbb], slot.lens[:nbb]
                with profiling.span("encode_document.to_device",
                                    bytes_to_device=u.nbytes + l.nbytes):
                    u = u.to(self.device, non_blocking=True)
                    l = l.to(self.device, non_blocking=True)
                with profiling.span("encode_document.forward", ahead=int(pending is not None)):
                    slot.frames[:nb].copy_(self.model(u, l)[:nb], non_blocking=True)
                    done = None
                    if cuda:
                        done = torch.cuda.Event()
                        done.record(torch.cuda.current_stream(self.device))
            if pending is not None:
                self._drain(*pending, lens, out, outs)
            pending = (slot, i, nb, done)
        self._drain(*pending, lens, out, outs)
        return outs

    def _drain(self, slot, i, nb, done, lens, out, outs):
        """Waits for a chunk's frames in its slot, copies them into the
        document's array and appends each unit's valid frames to `outs`."""
        with profiling.span("encode_document.to_host") as to_host:
            if done is not None:
                done.synchronize()
            out[i : i + nb] = slot.frames[:nb].numpy()
            to_host.add("bytes_to_host", out[i : i + nb].nbytes)
        with profiling.span("encode_document.slice"):
            for row, n in zip(out[i : i + nb], lens[i : i + nb]):
                t = self.frames(int(n))
                outs.append(row[: max(t, 1)])


def _model_module(cfg):
    """The module that builds the model of `cfg`."""
    return B if isinstance(cfg, B.W2VBertConfig) else W


class _Slot(NamedTuple):
    """One chunk's staging: audio [chunk, S] float32, lens [chunk] int32,
    frames [chunk, T, hidden] float32."""

    audio: torch.Tensor
    lens: torch.Tensor
    frames: torch.Tensor


class _StagingSlots:
    """The two host slots of `Wav2Vec2Encoder.encode_document`'s chunk loop,
    page-locked on a CUDA device (so that copies to and from the card do not
    block the host) and ordinary memory on the CPU. A slot's buffers are flat
    and grow only when a larger (chunk, S, T) arrives; smaller shapes are
    views of their first elements, so the memory held is two chunks of the
    largest shape seen, whatever a document's length."""

    DTYPES = (torch.float32, torch.int32, torch.float32)

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.sizes = (0, 0, 0)  # elements of each slot's audio, lens, frames
        self.flat = []

    def views(self, chunk, S, T, hidden) -> List[_Slot]:
        need = (chunk * S, chunk, chunk * T * hidden)
        if any(n > m for n, m in zip(need, self.sizes)):
            self.sizes = tuple(map(max, need, self.sizes))
            self.flat = [[torch.empty(n, dtype=d, pin_memory=self.pinned)
                          for n, d in zip(self.sizes, self.DTYPES)] for _ in range(2)]
        return [_Slot(a[: need[0]].view(chunk, S), l[:chunk], f[: need[2]].view(chunk, T, hidden))
                for a, l, f in self.flat]


def _pack(slot: _Slot, audio, bounds, lens, rows):
    """Writes the units `bounds` (cut to `lens`, as `unit_lengths` cuts them)
    zero-padded into the slot's first `rows` rows; the rows past the units
    get length 0."""
    a, l = slot.audio.numpy(), slot.lens.numpy()
    S = a.shape[1]
    for r, (s, e) in enumerate(bounds):
        seg = audio[s:e][:S]
        a[r, : len(seg)] = seg
        a[r, len(seg):] = 0
    a[len(bounds) : rows] = 0
    l[: len(bounds)] = lens
    l[len(bounds) : rows] = 0


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
