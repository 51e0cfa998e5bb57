"""Spectral front-end: STFT, mel spectrogram, MFCC, deltas (counterpart of the
JAX package's dsp/spectral.py).

Every function takes rows on a leading axis (`[R, N]` audio, one row per
unit or window) and works on the device the rows are on: framing is an index
gather, the STFT an rfft over frames, the mel projection and the DCT are
matmuls with banks built on the host in float64 and cast to float32.

Conventions follow librosa's defaults, as the JAX package does: periodic
hann, n_fft 2048, hop 512, centred reflect padding, power-2 spectrogram,
Slaney mel bank, `power_to_db` with ref 1 and top_db 80 (the clamp is taken
per row), orthonormal DCT-II, and the width-9 Savitzky-Golay slope for
deltas with edge replication.

Reflect padding repeats when the pad is longer than the row, as `jnp.pad`
and `np.pad` do (`torch.nn.functional.pad` refuses that case): rows shorter
than 1025 samples are real (uniform units of 0.05 s are 800 samples).
"""
from __future__ import annotations

import numpy as np
import torch


def hann_window(n: int) -> np.ndarray:
    """Periodic (sym=False) hann, matching scipy.signal.get_window('hann')."""
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))


def reflect_index(n: int, pad_lo: int, pad_hi: int) -> np.ndarray:
    """Source positions of a row of length n reflect-padded by (pad_lo,
    pad_hi), reflecting again as often as the pad needs (np.pad semantics)."""
    i = np.arange(-pad_lo, n + pad_hi)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.mod(i, period)
    return np.where(i > n - 1, period - i, i)


def frame_signal(y: torch.Tensor, frame_length: int, hop: int, center: bool = True):
    """[..., N] -> [..., n_frames, frame_length], centred reflect padding."""
    if center:
        pad = frame_length // 2
        idx = reflect_index(y.shape[-1], pad, pad)
        y = y[..., torch.from_numpy(idx).to(y.device)]
    n_frames = 1 + (y.shape[-1] - frame_length) // hop
    idx = np.arange(frame_length)[None, :] + hop * np.arange(n_frames)[:, None]
    return y[..., torch.from_numpy(idx).to(y.device)]


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(like.device)


def stft_power(y: torch.Tensor, n_fft: int = 2048, hop: int = 512) -> torch.Tensor:
    """[R, N] -> power spectrogram [R, n_freqs, n_frames] (librosa layout)."""
    frames = frame_signal(y, n_fft, hop)
    spec = torch.fft.rfft(frames * _const(hann_window(n_fft), y), dim=-1)
    return (spec.abs() ** 2).transpose(-1, -2)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax=None) -> np.ndarray:
    """Slaney-style mel filterbank [n_mels, n_fft//2+1] (librosa htk=False)."""
    if fmax is None:
        fmax = sr / 2.0

    def hz_to_mel(f):
        f = np.asanyarray(f, dtype=np.float64)
        f_sp = 200.0 / 3
        mels = f / f_sp
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)

    def mel_to_hz(m):
        m = np.asanyarray(m, dtype=np.float64)
        f_sp = 200.0 / 3
        freqs = f_sp * m
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)

    fftfreqs = np.linspace(0, sr / 2.0, n_fft // 2 + 1)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def melspectrogram(y: torch.Tensor, sr: int, n_mels: int = 128, n_fft: int = 2048,
                   hop: int = 512) -> torch.Tensor:
    """[R, N] -> [R, n_mels, n_frames] power mel spectrogram."""
    S = stft_power(y, n_fft, hop)
    return _const(mel_filterbank(sr, n_fft, n_mels), y) @ S


def power_to_db(S: torch.Tensor, top_db: float = 80.0) -> torch.Tensor:
    """10 log10(max(S, 1e-10)), floored at top_db under each ROW's maximum
    (the max runs over every axis but the first)."""
    db = 10.0 * torch.log10(S.clamp_min(1e-10))
    if top_db is not None:
        peak = db.reshape(db.shape[0], -1).amax(dim=1)
        db = torch.maximum(db, (peak - top_db).reshape((-1,) + (1,) * (db.dim() - 1)))
    return db


def dct_ii_ortho_matrix(n: int) -> np.ndarray:
    """[n, n] orthonormal DCT-II matrix (scipy.fft.dct norm='ortho')."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    m = np.cos(np.pi * k * (2 * j + 1) / (2 * n)) * np.sqrt(2.0 / n)
    m[0] *= 1.0 / np.sqrt(2.0)
    return m.astype(np.float32)


def mfcc(y: torch.Tensor, sr: int, n_mfcc: int = 20, n_mels: int = 128,
         n_fft: int = 2048, hop: int = 512) -> torch.Tensor:
    """[R, N] -> [R, n_mfcc, n_frames], librosa.feature.mfcc semantics."""
    S = power_to_db(melspectrogram(y, sr, n_mels, n_fft, hop))
    return _const(dct_ii_ortho_matrix(n_mels)[:n_mfcc], y) @ S


def delta(x: torch.Tensor, width: int = 9) -> torch.Tensor:
    """Savitzky-Golay order-1 first derivative over the last axis: the
    regression-slope FIR k / sum(k^2) with the edge values replicated."""
    half = width // 2
    k = np.arange(-half, half + 1, dtype=np.float32)
    coeffs = k / np.sum(k**2)
    xp = torch.cat([x[..., :1].expand(*x.shape[:-1], half), x,
                    x[..., -1:].expand(*x.shape[:-1], half)], dim=-1)
    n = x.shape[-1]
    out = torch.zeros_like(x)
    for i, c in enumerate(coeffs):
        out = out + float(c) * xp[..., i : i + n]
    return out
