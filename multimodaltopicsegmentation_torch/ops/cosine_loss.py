"""Auxiliary segment-coherence cosine loss (counterpart of the JAX package's
ops/cosine_loss.py), weighted 0.1 by the taggers that take `-cos`.

For every complete topic segment the sum of its even-indexed unit states
should be cosine-similar to the sum of its odd-indexed ones (positive pair),
and the sums of consecutive segments dissimilar (negative pair, hinge at 0).
The segments are derived from the boundary labels: a unit's segment id is
the number of boundaries strictly before it, and every pair sum is a masked
segment reduction over the whole batch at once.
"""
from __future__ import annotations

import torch


def _cos(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    # eps inside the square roots, as the JAX package has it (not
    # F.cosine_similarity, which clamps the norms instead)
    na = torch.sqrt((a * a).sum(dim=-1) + eps)
    nb = torch.sqrt((b * b).sum(dim=-1) + eps)
    return (a * b).sum(dim=-1) / (na * nb)


def _segment_sum(values: torch.Tensor, flat_seg: torch.Tensor, B: int, L: int) -> torch.Tensor:
    """values [B, L, ...] summed into [B, L (segments), ...] by per-document
    segment ids, flattened to one index over B * L."""
    flat = values.reshape(B * L, *values.shape[2:])
    out = flat.new_zeros(flat.shape).index_add(0, flat_seg, flat)
    return out.reshape(values.shape)


def cosine_segment_loss(h: torch.Tensor, lengths: torch.Tensor, tags: torch.Tensor) -> torch.Tensor:
    """h [B, L, D] states, lengths [B], tags [B, L] 0/1 boundary labels (1 =
    last unit of a segment; padding may hold -1) -> scalar."""
    B, L, _ = h.shape
    idx = torch.arange(L, device=h.device)
    valid = idx[None, :] < lengths.to(h.device)[:, None]
    t = torch.where(valid, tags.to(h.dtype).clamp_min(0.0), 0.0)
    seg = (torch.cumsum(t, dim=1) - t).long()  # a boundary unit keeps its own segment
    n_bound = t.sum(dim=1).long()  # complete segments per document
    flat_seg = (seg + L * torch.arange(B, device=h.device)[:, None]).reshape(-1)

    # position within the segment, for the even/odd split
    seg_start = torch.full((B, L), L, dtype=torch.long, device=h.device).scatter_reduce(
        1, seg, torch.where(valid, idx[None, :], L), "amin")
    pos = idx[None, :] - seg_start.gather(1, seg)
    w = valid.to(h.dtype)
    even = ((pos % 2 == 0) & valid).to(h.dtype)[..., None]
    odd = ((pos % 2 == 1) & valid).to(h.dtype)[..., None]
    sum_even = _segment_sum(h * even, flat_seg, B, L)
    sum_odd = _segment_sum(h * odd, flat_seg, B, L)
    seg_sum = _segment_sum(h * w[..., None], flat_seg, B, L)
    seg_len = _segment_sum(w, flat_seg, B, L)

    complete = idx[None, :] < n_bound[:, None]  # segments that end at a boundary
    # positives: the halves of complete segments of more than one unit
    pos_valid = complete & (seg_len > 1)
    pos_loss = 1.0 - _cos(sum_even, sum_odd)
    # negatives: each complete segment against the region after it
    nxt = torch.clamp(idx + 1, max=L - 1)
    neg_valid = complete & (seg_len[:, nxt] > 0)
    neg_loss = torch.clamp_min(_cos(seg_sum, seg_sum[:, nxt]), 0.0)

    totals = (torch.where(pos_valid, pos_loss, 0.0).sum(dim=1)
              + torch.where(neg_valid, neg_loss, 0.0).sum(dim=1))
    counts = pos_valid.sum(dim=1) + neg_valid.sum(dim=1)
    return totals.sum() / counts.sum().clamp_min(1).to(h.dtype)
