"""Length-mask utilities (counterpart of the JAX package's ops/masks.py)."""
from __future__ import annotations

import torch


def length_mask(lengths: torch.Tensor, max_len: int, dtype=torch.float32) -> torch.Tensor:
    """[B] lengths -> [B, max_len] mask, 1.0 for valid steps, 0.0 for padding."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).to(dtype)


def reverse_in_length(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each sequence of x [B, L, ...] within its valid length;
    padding stays in place (what a packed backward RNN direction sees)."""
    B, L = x.shape[:2]
    t = torch.arange(L, device=x.device)[None, :].expand(B, L)
    lens = lengths.to(x.device).long()[:, None]
    src = torch.where(t < lens, lens - 1 - t, t)
    return torch.gather(x, 1, src.reshape(B, L, *([1] * (x.dim() - 2))).expand_as(x))
