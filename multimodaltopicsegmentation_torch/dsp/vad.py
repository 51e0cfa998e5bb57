"""Voice activity detection (counterpart of the JAX package's dsp/vad.py).

The frame energies are computed on the device (`frame_log_energy`); the span
logic after them is host code, copied from the JAX package: the energy VAD
(`speech_segments`), and SpeechBrain's `get_speech_segments` pipeline as the
reference training extractor calls it (extract_embeddings.py:297-308):
posterior hysteresis -> energy double check inside each span -> merge close
spans -> drop short ones -> mean-posterior re-check, on a 10 ms grid.

The posterior source is `default_posteriors`, the JAX package's dispatch:
the CRDNN network (encoders/crdnn_vad.py) when MTS_VAD_WEIGHTS names a
converted checkpoint, else the energy logistic `vad_posteriors`, announced
once on stderr. The energy logistic is that package's documented VAD
without neural weights, not a fallback of the device.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .spectral import frame_signal


def frame_log_energy(y: torch.Tensor, sr: int, frame_length: int = 400, hop: int = 160):
    """[..., N] -> [..., n_frames] log mean-square frame energies
    (25 ms / 10 ms at 16 kHz), uncentred frames."""
    frames = frame_signal(y, frame_length, hop, center=False)
    return torch.log(torch.mean(frames**2, dim=-1) + 1e-10)


def _log_energy(audio: np.ndarray, sr: int, frame_length: int, hop: int, device) -> np.ndarray:
    y = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(device)
    return frame_log_energy(y, sr, frame_length, hop).cpu().numpy()


def speech_segments(audio: np.ndarray, sr: int, min_speech_s: float = 0.25,
                    min_gap_s: float = 0.3, threshold_offset_db: float = 6.0,
                    device="cuda") -> list:
    """-> [(start_s, end_s)] speech spans: threshold = noise floor (10th
    percentile of log energy) + offset; gaps under min_gap_s are bridged,
    spans under min_speech_s dropped."""
    e = _log_energy(audio, sr, 400, 160, device)
    if len(e) == 0:
        return []
    floor = np.percentile(e, 10)
    offset = threshold_offset_db / 10.0 * np.log(10.0)
    if np.percentile(e, 95) - floor < offset:
        # flat energy profile: there is no silence to separate — all speech
        active = np.ones(len(e), dtype=bool)
    else:
        active = e > floor + offset

    spans = _binary_to_spans(active, hop_s=160 / sr)
    merged = []
    for s, t in spans:
        if merged and s - merged[-1][1] < min_gap_s:
            merged[-1] = (merged[-1][0], t)
        else:
            merged.append((s, t))
    return [(s, t) for s, t in merged if t - s >= min_speech_s]


TIME_RESOLUTION = 0.01  # speechbrain's 10 ms VAD frame grid


def vad_posteriors(audio: np.ndarray, sr: int, device="cuda") -> np.ndarray:
    """Frame speech probabilities in [0, 1] on the 10 ms grid: a logistic of
    the log frame energy around the midpoint between the noise floor and the
    speech ceiling; a flat profile is all speech or all silence, decided by
    an absolute floor (-10 in log mean square, about -43 dBFS)."""
    hop = max(int(sr * TIME_RESOLUTION), 1)
    frame = max(int(sr * 0.025), 2)
    e = _log_energy(audio, sr, frame, hop, device)
    if len(e) == 0:
        return np.zeros((0,), np.float32)
    # light smoothing (50 ms) so posteriors do not flicker within a phone
    if len(e) >= 5:
        e = np.convolve(e, np.ones(5) / 5.0, mode="same")
    floor, ceil = np.percentile(e, 10), np.percentile(e, 95)
    if ceil - floor < 6.0 / 10.0 * np.log(10.0):
        level = 1.0 if np.median(e) > -10.0 else 0.0
        return np.full_like(e, level, dtype=np.float32)
    mid = 0.5 * (floor + ceil)
    scale = max((ceil - floor) / 8.0, 1e-3)
    return 1.0 / (1.0 + np.exp(-(e - mid) / scale))


_CRDNN_CACHE: dict = {}
_warned_fallback = False


def _warn_energy_fallback():
    """One notice per process when VAD runs without neural weights: the
    energy-logistic posterior gives other unit boundaries than a CRDNN run."""
    global _warned_fallback
    if _warned_fallback:
        return
    _warned_fallback = True
    print(
        "WARNING: MTS_VAD_WEIGHTS is not set — VAD is using the built-in "
        "energy-logistic posterior, NOT the SpeechBrain CRDNN the reference "
        "uses (extract_embeddings.py:116-118). Unit boundaries will differ "
        "from a reference VAD run. Convert weights with "
        "`tools/convert_weights.py crdnn_vad` and set MTS_VAD_WEIGHTS to "
        "silence this.",
        file=sys.stderr,
    )


def default_posteriors(audio: np.ndarray, sr: int, device="cuda") -> np.ndarray:
    """The CRDNN network on `device` when MTS_VAD_WEIGHTS names converted
    weights (tools/convert_weights.py crdnn_vad), else the energy logistic."""
    path = os.environ.get("MTS_VAD_WEIGHTS")
    if not path:
        _warn_energy_fallback()
        return vad_posteriors(audio, sr, device)
    from ..encoders import crdnn_vad

    key = (path, str(device))
    if key not in _CRDNN_CACHE:
        _CRDNN_CACHE.clear()  # one set of VAD weights per process
        _CRDNN_CACHE[key] = crdnn_vad.build(crdnn_vad.load_npz(path), device)
    return crdnn_vad.posteriors(_CRDNN_CACHE[key], audio, sr)


def apply_threshold(post: np.ndarray, activation_th: float = 0.5,
                    deactivation_th: float = 0.25) -> np.ndarray:
    """Double-threshold hysteresis (speechbrain VAD.apply_threshold): the
    state at frame i is whatever the latest on (>= activation) or off
    (< deactivation) crossing said."""
    post = np.asarray(post)
    n = len(post)
    if n == 0:
        return np.zeros((0,), bool)
    on_ev = post >= activation_th
    off_ev = post < deactivation_th
    idx = np.arange(n)
    last_event = np.maximum.accumulate(np.where(on_ev | off_ev, idx, -1))
    return (last_event >= 0) & on_ev[np.maximum(last_event, 0)]


def _binary_to_spans(active: np.ndarray, hop_s: float, offset_s: float = 0.0) -> list:
    spans = []
    start = None
    for i, a in enumerate(active):
        if a and start is None:
            start = i
        elif not a and start is not None:
            spans.append((offset_s + start * hop_s, offset_s + i * hop_s))
            start = None
    if start is not None:
        spans.append((offset_s + start * hop_s, offset_s + len(active) * hop_s))
    return spans


def energy_double_check(audio: np.ndarray, sr: int, spans: list, activation_th: float = 0.5,
                        deactivation_th: float = 0.0) -> list:
    """speechbrain VAD.energy_VAD: inside each span, standardise 10 ms chunk
    energies to mean 0.5 / half-unit std and threshold again, splitting
    spans whose inside holds low-energy stretches."""
    hop = max(int(sr * TIME_RESOLUTION), 1)
    out = []
    for s, t in spans:
        seg = audio[int(s * sr) : int(t * sr)]
        n = len(seg) // hop
        if n < 2:
            out.append((s, t))
            continue
        chunks = seg[: n * hop].reshape(n, hop)
        e = np.sqrt(np.mean(chunks.astype(np.float64) ** 2, axis=-1) + 1e-12)
        std = e.std()
        if std < 1e-12:
            out.append((s, t))
            continue
        norm = (e - e.mean()) / (2 * std) + 0.5
        active = apply_threshold(norm, activation_th, deactivation_th)
        out.extend(_binary_to_spans(active, TIME_RESOLUTION, offset_s=s))
    return out


def merge_close_segments(spans: list, close_th: float = 0.250) -> list:
    merged = []
    for s, t in spans:
        if merged and s - merged[-1][1] < close_th:
            merged[-1] = (merged[-1][0], max(merged[-1][1], t))
        else:
            merged.append((s, t))
    return merged


def remove_short_segments(spans: list, len_th: float = 0.250) -> list:
    return [(s, t) for s, t in spans if t - s >= len_th]


def double_check_speech_segments(spans: list, post: np.ndarray, speech_th: float = 0.5) -> list:
    """Keep only spans whose MEAN posterior clears speech_th."""
    out = []
    for s, t in spans:
        a, b = int(round(s / TIME_RESOLUTION)), int(round(t / TIME_RESOLUTION))
        window = post[a:max(b, a + 1)]
        if len(window) and float(window.mean()) > speech_th:
            out.append((s, t))
    return out


def get_speech_segments(
    audio: np.ndarray,
    sr: int,
    apply_energy_VAD: bool = True,
    double_check: bool = True,
    activation_th: float = 0.5,
    deactivation_th: float = 0.25,
    en_activation_th: float = 0.5,
    en_deactivation_th: float = 0.0,
    close_th: float = 0.250,
    len_th: float = 0.250,
    speech_th: float = 0.5,
    posteriors: np.ndarray = None,
    device="cuda",
) -> list:
    """The reference VAD pipeline -> [(start_s, end_s)] speech spans; the
    posteriors are computed on `device` unless given."""
    post = (default_posteriors(audio, sr, device) if posteriors is None
            else np.asarray(posteriors))
    active = apply_threshold(post, activation_th, deactivation_th)
    spans = _binary_to_spans(active, TIME_RESOLUTION)
    if apply_energy_VAD:
        spans = energy_double_check(audio, sr, spans, en_activation_th, en_deactivation_th)
    spans = merge_close_segments(spans, close_th)
    spans = remove_short_segments(spans, len_th)
    if double_check:
        spans = double_check_speech_segments(spans, post, speech_th)
    return spans


def get_speech_segments_quartered(audio: np.ndarray, sr: int, n_parts: int = 4, **kw) -> list:
    """The reference's MemoryError path: the VAD on four consecutive
    quarters, spans shifted by each quarter's start
    (extract_embeddings.py:314-369)."""
    part = len(audio) // n_parts
    spans = []
    for i in range(n_parts):
        start = part * i
        end = part * (i + 1) if i < n_parts - 1 else len(audio)
        off = start / sr
        spans.extend(
            (s + off, t + off) for s, t in get_speech_segments(audio[start:end], sr, **kw)
        )
    return spans
