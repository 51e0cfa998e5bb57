"""Unit-batching helpers for encoders (a copy of the JAX package's
encoders/engine_util.py, which the port does not import), and the span
every encoder's `encode_document` opens."""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

from ..utils import profiling


def traced_encode(encode_document):
    """Runs an encoder's `encode_document(audio, bounds, ...)` inside the
    `encode_document` span, counting its units."""

    @functools.wraps(encode_document)
    def traced(self, audio, bounds, *args, **kwargs):
        with profiling.span("encode_document", units=len(bounds)):
            return encode_document(self, audio, bounds, *args, **kwargs)

    return traced


def bucket_samples(S: int, sr: int = 16000) -> int:
    """Round a ragged document's max unit length up onto a 9/8 geometric
    grid, with >= 4096 samples of zero tail, so that every unit sits in the
    padded regime and the length-masked features do not depend on the grid
    (see the JAX package's engine_util.bucket_samples)."""
    q = sr // 4
    headroom = 4096
    b = q
    while b < S + headroom:
        b = -(-b * 9) // 8
    return b


def bucket_rows(u: np.ndarray, l: np.ndarray = None, quantum: int = 32,
                cap: int = None):
    """Zero-pad the row axis up to a multiple of `quantum` (optionally capped,
    e.g. at the chunk size). Padded rows have length 0 (when `l` is given)
    or are all-zero; callers drop them by slicing to the real row count."""
    nb = u.shape[0]
    nbb = quantum * (-(-nb // quantum))
    if cap is not None:
        nbb = min(cap, nbb)
    if nbb == nb:
        return u, l
    u = np.concatenate([u, np.zeros((nbb - nb, *u.shape[1:]), u.dtype)])
    if l is not None:
        l = np.concatenate([l, np.zeros((nbb - nb,), l.dtype)])
    return u, l


def unit_lengths(
    bounds: Sequence[Tuple[int, int]], max_len: int = None, bucket: bool = False,
) -> Tuple[np.ndarray, int]:
    """-> (int32 length of each [start, end) span, padded length S).

    Each length is at least 1; S is `max_len` or the longest length, which
    bucket=True quantizes via `bucket_samples` for RAGGED documents only
    (uniform documents, the 1-second-unit predict contract, keep their exact
    shape); every length is cut at S."""
    lens = [max(e - s, 1) for s, e in bounds]
    S = max_len or max(lens)
    if bucket and max_len is None and len(set(lens)) > 1:
        S = bucket_samples(S)
    return np.asarray([min(l, S) for l in lens], np.int32), S


def pad_units(
    audio: np.ndarray, bounds: Sequence[Tuple[int, int]], max_len: int = None,
    bucket: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Slice [start, end) sample spans into one zero-padded [U, S] batch,
    S and the lengths as `unit_lengths` gives them."""
    lens, S = unit_lengths(bounds, max_len, bucket)
    out = np.zeros((len(bounds), S), np.float32)
    for i, (s, e) in enumerate(bounds):
        seg = audio[s:e][:S]
        out[i, : len(seg)] = seg
    return out, lens
