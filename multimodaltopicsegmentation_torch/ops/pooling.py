"""Frame -> unit pooling: the reference's reduction variants as segment
reductions (counterpart of the JAX package's ops/pooling.py).

A document is one [total_frames, d] tensor plus a frame -> unit segment id
vector. A unit with no frames gives a zero row in every variant.
"""
from __future__ import annotations

import torch


def _seg_count(frames, seg_ids, n_units):
    ones = torch.ones(frames.shape[0], dtype=frames.dtype, device=frames.device)
    return torch.zeros(n_units, dtype=frames.dtype, device=frames.device).index_add_(0, seg_ids, ones)


def _seg_sum(frames, seg_ids, n_units):
    out = torch.zeros((n_units, frames.shape[1]), dtype=frames.dtype, device=frames.device)
    return out.index_add_(0, seg_ids, frames)


def segment_mean(frames, seg_ids, n_units):
    cnt = _seg_count(frames, seg_ids, n_units)
    return _seg_sum(frames, seg_ids, n_units) / cnt.clamp_min(1.0)[:, None]


def segment_std(frames, seg_ids, n_units):
    cnt = _seg_count(frames, seg_ids, n_units).clamp_min(1.0)[:, None]
    mean = _seg_sum(frames, seg_ids, n_units) / cnt
    var = _seg_sum(frames ** 2, seg_ids, n_units) / cnt - mean ** 2
    return torch.sqrt(var.clamp_min(0.0))


def segment_max(frames, seg_ids, n_units):
    out = torch.full((n_units, frames.shape[1]), float("-inf"),
                     dtype=frames.dtype, device=frames.device)
    idx = seg_ids[:, None].expand_as(frames)
    out = out.scatter_reduce(0, idx, frames, "amax", include_self=True)
    cnt = _seg_count(frames, seg_ids, n_units)
    return torch.where(cnt[:, None] > 0, out, torch.zeros_like(out))


def _frame_index(frames, seg_ids, n_units, reduce):
    """Index of each unit's last ("amax") or first ("amin") frame; 0 for an
    empty unit, whose row the callers zero."""
    n = frames.shape[0]
    init = -1 if reduce == "amax" else n
    idx = torch.full((n_units,), init, dtype=torch.long, device=frames.device)
    idx = idx.scatter_reduce(0, seg_ids, torch.arange(n, device=frames.device), reduce,
                             include_self=True)
    return idx.clamp(0, max(n - 1, 0))


def _gather_rows(frames, seg_ids, n_units, reduce):
    cnt = _seg_count(frames, seg_ids, n_units)
    rows = frames[_frame_index(frames, seg_ids, n_units, reduce)]
    return torch.where(cnt[:, None] > 0, rows, torch.zeros_like(rows))


def segment_last(frames, seg_ids, n_units):
    """Embedding of each unit's final frame (zeros for an empty unit)."""
    return _gather_rows(frames, seg_ids, n_units, "amax")


def segment_first(frames, seg_ids, n_units):
    return _gather_rows(frames, seg_ids, n_units, "amin")


def pool(frames, seg_ids, n_units: int, variant: str):
    """One of the reference's pooling variants (leading underscore optional).

    _delta_gap is the NEXT unit's first frame minus this unit's last frame;
    the final unit, which has no successor, keeps its own last frame. The
    final unit must be a real (non-empty) one, as the extract CLI gives."""
    v = variant.lstrip("_")
    if v == "mean":
        return segment_mean(frames, seg_ids, n_units)
    if v == "max":
        return segment_max(frames, seg_ids, n_units)
    if v == "mean_std":
        return torch.cat([segment_mean(frames, seg_ids, n_units),
                          segment_std(frames, seg_ids, n_units)], dim=-1)
    if v == "max_std":
        return torch.cat([segment_max(frames, seg_ids, n_units),
                          segment_std(frames, seg_ids, n_units)], dim=-1)
    if v == "last":
        return segment_last(frames, seg_ids, n_units)
    if v == "delta_gap":
        last = segment_last(frames, seg_ids, n_units)
        first = segment_first(frames, seg_ids, n_units)
        gap = torch.cat([first[1:], torch.zeros_like(first[:1])], dim=0) - last
        gap[-1] = last[-1]
        return gap
    raise ValueError(f"unknown pooling variant {variant!r}")


POOLING_VARIANTS = ("_mean", "_max", "_mean_std", "_max_std", "_last", "_delta_gap")
