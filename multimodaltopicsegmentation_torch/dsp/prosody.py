"""Prosodic (167-d) and MFCC (200-d) unit feature vectors, batched over units
(counterpart of the JAX package's dsp/prosody.py, reference
extract_acoustic_features.py semantics).

- prosodic = [mean, std] of pYIN f0, pause durations and voiced-frame
  intensities (2 each), per-band [mean, std] of the 40-mel power spectrogram
  and of its delta (80 + 80), and one pitch-jump scalar against the previous
  unit: 167;
- mfcc = [mean of 50 MFCCs, mean of their deltas, std, std of deltas]: 200;
- pauses are maximal runs of voicing < 0.5 that end before the unit does;
  the trailing open run counts only when no pause completed, and with no
  pause at all the voiced statistics run over every frame (the reference's
  three branches).

A document's units are one zero-padded [U, S] batch, framed as padded rows
(as the JAX package's vmap frames them); frame masks cut each unit's
statistics to its 1 + n // 512 frames. Pause runs are counted with a
cumulative sum instead of a scan: a pause frame belongs to the run between
the voiced frames before and after it.
"""
from __future__ import annotations

import torch

from .spectral import delta, melspectrogram, mfcc as mfcc_fn
from .pyin import pyin

HOP = 512
FRAME = 2048


def _masked_mean_std(x: torch.Tensor, mask: torch.Tensor, dim: int = -1):
    """mean/std (ddof=0) over masked entries; zeros when empty."""
    cnt = mask.sum(dim=dim)
    s = (x * mask).sum(dim=dim)
    mean = torch.where(cnt > 0, s / cnt.clamp_min(1), 0.0)
    var = torch.where(cnt > 0,
                      (mask * (x - mean.unsqueeze(dim)) ** 2).sum(dim=dim) / cnt.clamp_min(1), 0.0)
    return mean, torch.sqrt(var)


def pause_statistics(voicing: torch.Tensor, frame_mask: torch.Tensor):
    """The reference's get_pause_durations on [U, T] voicing tracks.
    -> (pause_mean, pause_std, voiced_mean, voiced_std), each [U]."""
    valid = frame_mask > 0
    is_pause = (voicing < 0.5) & valid
    is_voiced = (voicing >= 0.5) & valid
    U, T = voicing.shape

    # run g holds the pause frames after the g-th voiced (valid) frame; the
    # runs before the last voiced frame are completed, the last one is open
    gap = torch.cumsum(is_voiced.to(torch.int64), dim=1)
    n_voiced = gap[:, -1]
    runs = torch.zeros((U, T + 1), dtype=torch.int64, device=voicing.device)
    runs.scatter_add_(1, gap, is_pause.to(torch.int64))
    completed = torch.arange(T + 1, device=voicing.device) < n_voiced[:, None]
    done = torch.where(completed, runs, 0)
    cnt = (done > 0).sum(dim=1).to(torch.int32)
    s = done.sum(dim=1).to(torch.int32)
    ss = (done * done).sum(dim=1).to(torch.int32)
    open_run = torch.gather(runs, 1, n_voiced[:, None]).squeeze(1).to(torch.int32)

    v_mean, v_std = _masked_mean_std(voicing, is_voiced.to(voicing.dtype))

    # completed pauses: stats over them, voiced stats over voiced frames
    p_mean0 = s / cnt.clamp_min(1)
    p_var0 = ss / cnt.clamp_min(1) - p_mean0**2
    # no completed pause but a trailing open run: pauses=[run], voiced gets a 0
    vs_cnt = n_voiced.to(torch.int32) + 1
    v_mean1 = (voicing * is_voiced).sum(dim=1) / vs_cnt.clamp_min(1)
    v_var1 = ((is_voiced * (voicing - v_mean1[:, None]) ** 2).sum(dim=1)
              + (0.0 - v_mean1) ** 2) / vs_cnt.clamp_min(1)
    # no pause at all: pauses=[0], voiced stats over ALL valid frames
    a_mean, a_std = _masked_mean_std(voicing, frame_mask)

    has_completed = cnt > 0
    has_open = open_run > 0
    pause_mean = torch.where(has_completed, p_mean0,
                             torch.where(has_open, open_run.to(voicing.dtype), 0.0))
    pause_std = torch.where(has_completed, torch.sqrt(p_var0.clamp_min(0.0)), 0.0)
    voiced_mean = torch.where(has_completed, v_mean, torch.where(has_open, v_mean1, a_mean))
    voiced_std = torch.where(has_completed, v_std,
                             torch.where(has_open, torch.sqrt(v_var1.clamp_min(0.0)), a_std))
    return pause_mean, pause_std, voiced_mean, voiced_std


def _frame_mask(unit_lengths: torch.Tensor, T: int, dtype):
    """-> ([U, T] mask of each unit's librosa-centred frames, [U] their
    count 1 + n // hop)."""
    t_valid = 1 + unit_lengths.to(torch.int64) // HOP
    return (torch.arange(T, device=unit_lengths.device) < t_valid[:, None]).to(dtype), t_valid


def _pitch_jumps(f0, raw, f0_valid, t_valid):
    """Pitch jump of each unit against the previous one (first unit: 0).

    Reference math: mean over the first len//5 pyin frames of f0/mean(f0),
    minus the mean over the previous unit's last len//5 PLAIN-yin frames of
    prev/mean(prev). Empty head slices and all-unvoiced units give 0; a
    previous unit under 5 frames uses its whole track (the prev[-0:] quirk)."""
    U, T = f0.shape
    idx = torch.arange(T, device=f0.device)
    head = (idx < (t_valid // 5)[:, None]) & f0_valid
    head_cnt = head.sum(dim=1)
    voiced = f0_valid.sum(dim=1)
    overall = torch.where(f0_valid, f0, 0.0).sum(dim=1) / voiced.clamp_min(1)
    head_mean = (torch.where(head, f0, 0.0).sum(dim=1) / head_cnt.clamp_min(1)
                 / overall.clamp_min(1e-8))

    # the previous row's raw track (row 0 reads row U-1, and is zeroed below)
    praw, pt = torch.roll(raw, 1, dims=0), torch.roll(t_valid, 1, dims=0)
    pt5 = pt // 5
    n_tail = torch.where(pt5 > 0, pt5, pt)
    tail = (idx >= (pt - n_tail)[:, None]) & (idx < pt[:, None])
    poverall = torch.where(idx < pt[:, None], praw, 0.0).sum(dim=1) / pt.clamp_min(1)
    tail_mean = (torch.where(tail, praw, 0.0).sum(dim=1) / n_tail.clamp_min(1)
                 / poverall.clamp_min(1e-8))

    j = head_mean - tail_mean
    ok = (head_cnt > 0) & (voiced > 0) & (pt > 0) & torch.isfinite(j)
    first = torch.arange(U, device=f0.device) == 0
    return torch.where(first | ~ok, 0.0, j)


def prosodic_features(units: torch.Tensor, unit_lengths: torch.Tensor, sr: int) -> torch.Tensor:
    """[U, S] zero-padded unit audio, [U] sample counts -> [U, 167]; pitch
    jumps chain the units in order. f0 comes from the pYIN tracker."""
    U, S = units.shape
    T = int(1 + S // HOP)
    fmask, t_valid = _frame_mask(unit_lengths, T, units.dtype)
    # the plain-yin track from the same CMNDF feeds the pitch jump
    f0, _vflag, voicing, raw_f0 = pyin(units, sr, with_raw_yin=True)
    f0, voicing, raw_f0 = f0[:, :T], voicing[:, :T], raw_f0[:, :T]

    f0_valid = torch.isfinite(f0) & (fmask > 0)
    f0_mean, f0_std = _masked_mean_std(torch.where(f0_valid, f0, 0.0), f0_valid.to(f0.dtype))
    p_mean, p_std, v_mean, v_std = pause_statistics(voicing, fmask)
    mel = melspectrogram(units, sr, n_mels=40)[..., :T]
    dmel = delta(mel)
    mel_mean, mel_std = _masked_mean_std(mel, fmask[:, None, :])
    dmel_mean, dmel_std = _masked_mean_std(dmel, fmask[:, None, :])
    jumps = _pitch_jumps(f0, raw_f0, f0_valid, t_valid)
    return torch.cat([torch.stack([f0_mean, f0_std, p_mean, p_std, v_mean, v_std], dim=1),
                      mel_mean, mel_std, dmel_mean, dmel_std, jumps[:, None]], dim=1)


def mfcc_features(units: torch.Tensor, unit_lengths: torch.Tensor, sr: int) -> torch.Tensor:
    """[U, S] zero-padded unit audio, [U] sample counts -> [U, 200]."""
    U, S = units.shape
    T = int(1 + S // HOP)
    fmask, _ = _frame_mask(unit_lengths, T, units.dtype)
    m = mfcc_fn(units, sr, n_mfcc=50)[..., :T]
    dm = delta(m)
    m_mean, m_std = _masked_mean_std(m, fmask[:, None, :])
    dm_mean, dm_std = _masked_mean_std(dm, fmask[:, None, :])
    # reference order: mean(x), mean(delta), std(x), std(delta)
    return torch.cat([m_mean, dm_mean, m_std, dm_std], dim=1)
