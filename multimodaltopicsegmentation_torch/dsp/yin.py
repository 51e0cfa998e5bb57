"""YIN fundamental frequency with pyin's closed-form voicing (counterpart of
the JAX package's dsp/yin.py).

Frames are batched on any leading axes (`[..., T, W]`). The difference
function comes from one rfft autocorrelation and cumulative energies, the
CMNDF normalisation, absolute-threshold trough choice and parabolic
refinement follow the YIN paper, and the voicing is pyin's observation
probability summed over its Beta(2, 18) threshold prior:
    voicing = 1 - (1 - 0.01) * I_{min CMNDF}(2, 18).
PyTorch has no `betainc`; for these integer parameters the regularised
incomplete beta is the binomial tail I_x(2, 18) = 1 - (1-x)^19 - 19 x (1-x)^18,
evaluated in float64 (it cancels near x = 0).
"""
from __future__ import annotations

import numpy as np
import torch

from .spectral import frame_signal


def betainc_2_18(x: torch.Tensor) -> torch.Tensor:
    """Regularised incomplete beta I_x(2, 18) for x in [0, 1]."""
    xd = x.double()
    q = 1.0 - xd
    return (1.0 - q**19 - 19.0 * xd * q**18).to(x.dtype)


def cmndf_band(frames: torch.Tensor, sr: int, fmin: float, fmax: float):
    """Cumulative-mean-normalised difference function over framed audio
    [..., T, W]. -> (cmndf [..., T, W//2+1], band [..., T, tau_max-tau_min],
    tau_min, tau_max)."""
    W = frames.shape[-1]
    tau_min = max(int(sr / fmax), 1)
    tau_max = min(int(sr / fmin) + 1, W // 2)
    dev = frames.device

    # d[tau] = sum_{j<W-tau} (x_j - x_{j+tau})^2 = e_head + e_tail - 2 acf[tau]
    n_fft = int(2 ** np.ceil(np.log2(2 * W)))
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    acf = torch.fft.irfft(spec * torch.conj(spec), n=n_fft, dim=-1)[..., : W // 2 + 1]

    csum = torch.cumsum(frames**2, dim=-1)  # e[k] = sum_{j<=k} x_j^2
    total = csum[..., -1:]
    taus = np.arange(0, W // 2 + 1)
    e_head = csum[..., torch.from_numpy(W - 1 - taus).to(dev)]
    prev = csum[..., torch.from_numpy(np.maximum(taus - 1, 0)).to(dev)]
    e_tail = total - torch.where(torch.from_numpy(taus > 0).to(dev), prev, 0.0)
    d = (e_head + e_tail - 2.0 * acf).clamp_min(0.0)

    cum = torch.cumsum(d[..., 1:], dim=-1)
    tau_range = torch.arange(1, W // 2 + 1, device=dev, dtype=d.dtype)
    cmndf = torch.cat([torch.ones_like(d[..., :1]), d[..., 1:] * tau_range / cum.clamp_min(1e-12)],
                      dim=-1)
    # zero-energy frames are 0/0 -> "perfect periodicity"; force aperiodic
    cmndf = torch.where(total > 1e-10, cmndf, 1.0)
    return cmndf, cmndf[..., tau_min:tau_max], tau_min, tau_max


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx.unsqueeze(-1)).squeeze(-1)


def select_f0(cmndf: torch.Tensor, band: torch.Tensor, tau_min: int, sr: int,
              threshold: float = 0.1):
    """YIN trough choice + closed-form pyin voicing on a CMNDF band.
    -> (f0 [..., T], defined at EVERY frame, and voicing [..., T])."""
    n_tau = band.shape[-1]
    W2 = cmndf.shape[-1] - 1

    # first crossing below the threshold, then down to that trough's local
    # minimum; the global minimum when nothing crosses (argmax: first index)
    below = band < threshold
    first_below = torch.argmax(below.to(torch.uint8), dim=-1)
    any_below = below.any(dim=-1)
    nxt = torch.cat([band[..., 1:], torch.full_like(band[..., :1], float("inf"))], dim=-1)
    pos = torch.arange(n_tau, device=band.device)
    at_local_min = (band <= nxt) & (pos >= first_below.unsqueeze(-1))
    trough = torch.argmax(at_local_min.to(torch.uint8), dim=-1)
    global_min = torch.argmin(band, dim=-1)
    tau_abs = torch.where(any_below, trough, global_min) + tau_min

    ym1 = _take(cmndf, (tau_abs - 1).clamp_min(1))
    y0 = _take(cmndf, tau_abs)
    yp1 = _take(cmndf, (tau_abs + 1).clamp_max(W2))
    denom = 2.0 * (ym1 - 2.0 * y0 + yp1)
    shift = torch.where(denom.abs() > 1e-12, (ym1 - yp1) / denom, 0.0).clamp(-0.5, 0.5)
    tau_refined = tau_abs.to(band.dtype) + shift

    f0 = sr / tau_refined.clamp_min(1e-6)
    min_cmndf = band.amin(dim=-1).clamp(0.0, 1.0)
    no_trough_prob = 0.01
    voicing = 1.0 - (1.0 - no_trough_prob) * betainc_2_18(min_cmndf)
    return f0, voicing


def yin(y: torch.Tensor, sr: int, fmin: float = 70.0, fmax: float = 500.0,
        frame_length: int = 2048, hop: int = 512, threshold: float = 0.1):
    """[..., N] audio -> (f0 [..., n_frames], voicing [..., n_frames]); f0 is
    NaN below 0.5 voicing, like pyin's unvoiced output."""
    frames = frame_signal(y, frame_length, hop)
    cmndf, band, tau_min, _tau_max = cmndf_band(frames, sr, fmin, fmax)
    f0, voicing = select_f0(cmndf, band, tau_min, sr, threshold)
    return torch.where(voicing >= 0.5, f0, float("nan")), voicing
