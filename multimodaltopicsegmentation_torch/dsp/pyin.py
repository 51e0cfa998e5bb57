"""Probabilistic YIN with HMM Viterbi pitch tracking, batched over units
(counterpart of the JAX package's dsp/pyin.py, librosa.pyin semantics).

1. CMNDF per frame (dsp/yin.cmndf_band);
2. trough candidates: local minima over the lag band in tau order (a stable
   sort, as `jnp.argsort` is), parabolic-refined;
3. observation mass: a Beta(2, 18) prior over 100 thresholds, below-threshold
   troughs sharing it under a Boltzmann(2) position prior, thresholds with
   no trough crediting the global minimum with 0.01;
4. candidates onto 0.1-semitone pitch bins; unvoiced states share the rest;
5. Viterbi over 2 x 341 states (voiced/unvoiced x pitch) with librosa's
   transition matrix, one batched step per frame for all units: the step's
   [U, 682, 682] candidates live only for that step, the back-pointers are
   kept as [T-1, U, 682] integers and the backtrace is a reverse gather on
   the device (no host read inside either loop). Ties go to the first
   maximal index, as `jnp.argmax` gives them.

Each row is tracked over all its frames, padding included: the JAX package
runs pyin on the zero-padded row under vmap, and padding frames take part in
the Viterbi path of the valid ones.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .spectral import frame_signal
from .yin import cmndf_band, select_f0

N_THRESHOLDS = 100
BETA_A, BETA_B = 2.0, 18.0
BOLTZMANN_LAMBDA = 2.0
NO_TROUGH_PROB = 0.01
SWITCH_PROB = 0.01
MAX_TRANSITION_RATE = 35.92  # octaves / second
RESOLUTION = 0.1  # semitones per pitch bin
NEG = -1e30
# frames per pass of the observation mass: bounds its [frames, 100, 128] temporaries
OBS_CHUNK = 4096


def _beta_masses() -> np.ndarray:
    from scipy.stats import beta as beta_dist

    edges = np.linspace(0, 1, N_THRESHOLDS + 1)
    cdf = beta_dist.cdf(edges, BETA_A, BETA_B)
    return np.diff(cdf).astype(np.float32)  # [100]


def _pitch_bins(fmin: float, fmax: float):
    n_octaves = math.log2(fmax / fmin)
    n_bins = int(np.floor(12 * n_octaves / RESOLUTION)) + 1
    freqs = fmin * 2.0 ** (np.arange(n_bins) * RESOLUTION / 12.0)
    return n_bins, freqs.astype(np.float32)


def _transition_log(n_bins: int, sr: int, hop: int) -> np.ndarray:
    """log transition matrix [2n, 2n] (voiced block first), librosa layout."""
    max_semitones = round(MAX_TRANSITION_RATE * 12 * hop / sr)
    width = int(max_semitones / RESOLUTION) + 1
    local = np.zeros((n_bins, n_bins), np.float64)
    half = width // 2
    offs = np.arange(-half, half + 1)
    tri = 1.0 + half - np.abs(offs)
    for i in range(n_bins):
        j = i + offs
        ok = (j >= 0) & (j < n_bins)
        local[i, j[ok]] = tri[ok]
        local[i] /= local[i].sum()
    t_switch = np.array([[1 - SWITCH_PROB, SWITCH_PROB], [SWITCH_PROB, 1 - SWITCH_PROB]])
    full = np.kron(t_switch, local)
    return np.log(np.maximum(full, 1e-30)).astype(np.float32)


def _observation_mass(heights: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[N, K] trough heights (tau order) -> [N, K] observation probabilities."""
    dev = heights.device
    beta_m = torch.from_numpy(_beta_masses()).to(dev)
    thresholds = torch.from_numpy(
        np.linspace(0, 1, N_THRESHOLDS + 1)[1:].astype(np.float32)).to(dev)
    out = []
    for lo in range(0, heights.shape[0], OBS_CHUNK):
        h, v = heights[lo : lo + OBS_CHUNK], valid[lo : lo + OBS_CHUNK]
        below = (h[:, None, :] < thresholds[None, :, None]) & v[:, None, :]  # [n, S, K]
        pos = torch.cumsum(below, dim=2, dtype=torch.int32) - 1
        n_below = below.sum(dim=2)  # [n, S]
        lam = BOLTZMANN_LAMBDA
        # (1 - e^-lam) in float32, as the JAX expression evaluates it
        head = 1 - torch.exp(torch.tensor(-lam, device=dev))
        boltz = (head * torch.exp(-lam * pos.to(h.dtype))
                 / (1 - torch.exp(-lam * n_below.to(h.dtype)[:, :, None])).clamp_min(1e-12))
        boltz = torch.where(below, boltz, 0.0)
        probs = torch.einsum("tsk,s->tk", boltz, beta_m)
        # thresholds with no trough below: their mass goes to the global minimum
        gmin = torch.argmin(torch.where(v, h, float("inf")), dim=1)
        no_trough = torch.einsum("ts,s->t", (n_below == 0).to(beta_m.dtype), beta_m)
        probs = probs.index_put((torch.arange(len(h), device=dev), gmin),
                                NO_TROUGH_PROB * no_trough, accumulate=True)
        out.append(torch.where(v, probs, 0.0))
    return torch.cat(out)


def viterbi(log_obs: torch.Tensor, log_A: torch.Tensor, p_init: torch.Tensor) -> torch.Tensor:
    """[U, T, n] log observations -> [U, T] most likely state paths."""
    U, T, n = log_obs.shape
    delta = p_init + log_obs[:, 0]
    bps = torch.empty((max(T - 1, 0), U, n), dtype=torch.int64, device=log_obs.device)
    for t in range(1, T):
        best, bps[t - 1] = torch.max(delta[:, :, None] + log_A, dim=1)
        delta = best + log_obs[:, t]
    states = torch.empty((U, T), dtype=torch.int64, device=log_obs.device)
    states[:, T - 1] = torch.argmax(delta, dim=1)
    for t in range(T - 2, -1, -1):
        states[:, t] = torch.gather(bps[t], 1, states[:, t + 1 : t + 2]).squeeze(1)
    return states


def pyin(y: torch.Tensor, sr: int, fmin: float = 70.0, fmax: float = 500.0,
         frame_length: int = 2048, hop: int = 512, max_troughs: int = 128,
         with_raw_yin: bool = False):
    """[U, S] audio rows -> (f0 [U, T] bin frequencies with NaN when unvoiced,
    voiced_flag [U, T], voiced_prob [U, T]); with_raw_yin=True adds the plain
    YIN f0 track chosen from the same CMNDF (defined at every frame)."""
    frames = frame_signal(y, frame_length, hop)  # [U, T, W]
    U, T, W = frames.shape
    dev = y.device
    cmndf, band, tau_min, tau_max = cmndf_band(frames, sr, fmin, fmax)
    n_tau = tau_max - tau_min
    c2, b2 = cmndf.reshape(U * T, -1), band.reshape(U * T, n_tau)

    # librosa localmin: x < left and x <= right, never at index 0
    left = torch.cat([torch.full_like(b2[:, :1], float("-inf")), b2[:, :-1]], dim=1)
    right = torch.cat([b2[:, 1:], b2[:, -1:]], dim=1)
    is_trough = (b2 < left) & (b2 <= right)
    order_key = torch.where(is_trough, torch.arange(n_tau, device=dev), n_tau + 1)
    sel = torch.argsort(order_key, dim=1, stable=True)[:, :max_troughs]
    valid = torch.gather(is_trough, 1, sel)

    v0 = torch.gather(b2, 1, sel)
    ym1 = torch.gather(c2, 1, (sel + tau_min - 1).clamp_min(1))
    yp1 = torch.gather(c2, 1, (sel + tau_min + 1).clamp_max(W // 2))
    denom = 2.0 * (ym1 - 2.0 * v0 + yp1)
    shift = torch.where(denom.abs() > 1e-12, (ym1 - yp1) / denom, 0.0).clamp(-0.5, 0.5)
    heights = (v0 - 0.25 * (ym1 - yp1) * shift).clamp_min(0.0)
    tau_ref = sel.to(b2.dtype) + tau_min + shift
    cand_freq = sr / tau_ref.clamp_min(1e-6)

    probs = _observation_mass(heights, valid)
    voiced_prob = probs.sum(dim=1).clamp(0.0, 1.0)

    n_bins, freqs = _pitch_bins(fmin, fmax)
    bin_idx = torch.round(12.0 / RESOLUTION * torch.log2(cand_freq.clamp_min(1e-6) / fmin))
    bin_idx = bin_idx.clamp(0, n_bins - 1).to(torch.int64)
    obs_voiced = torch.zeros((U * T, n_bins), dtype=probs.dtype, device=dev)
    obs_voiced.scatter_add_(1, bin_idx, probs)
    obs_unvoiced = ((1.0 - voiced_prob) / n_bins)[:, None].expand(-1, n_bins)
    log_obs = torch.log(torch.cat([obs_voiced, obs_unvoiced], dim=1).clamp_min(1e-30))

    log_A = torch.from_numpy(_transition_log(n_bins, sr, hop)).to(dev)
    p_init = torch.full((2 * n_bins,), NEG, device=dev)
    p_init[n_bins:] = -torch.log(torch.tensor(float(n_bins)))
    states = viterbi(log_obs.reshape(U, T, 2 * n_bins), log_A, p_init)

    # voiced only where the state AND the observation evidence agree (the
    # JAX package's documented gate on voiced_prob >= 0.5)
    voiced_prob = voiced_prob.reshape(U, T)
    voiced_flag = (states < n_bins) & (voiced_prob >= 0.5)
    f0 = torch.from_numpy(freqs).to(dev)[states % n_bins]
    f0 = torch.where(voiced_flag, f0, float("nan"))
    if with_raw_yin:
        raw_f0, _ = select_f0(cmndf, band, tau_min, sr)
        return f0, voiced_flag, voiced_prob, raw_f0
    return f0, voiced_flag, voiced_prob
