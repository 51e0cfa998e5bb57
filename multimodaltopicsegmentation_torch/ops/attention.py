"""Dense multi-head attention core (the part of the JAX package's
ops/attention.py that wav2vec2 uses).

`dense_attention` stays plain torch with an additive NEG_INF mask, as in JAX.
A boolean-masked scaled_dot_product_attention would give NaN for the
zero-length padded rows that `bucket_rows` adds (all keys masked), where the
additive mask gives them uniform weights; the port matches JAX row for row.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e9


def dense_attention(q, k, v, mask=None):
    """q, k, v: [B, H, L, Dh]; mask: [B, L] float (1 = valid key)."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores + (1.0 - mask[:, None, None, :]) * NEG_INF
    return torch.matmul(torch.softmax(scores, dim=-1), v)


def split_heads(x: torch.Tensor, nheads: int) -> torch.Tensor:
    B, L, D = x.shape
    return x.reshape(B, L, nheads, D // nheads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, L, Dh = x.shape
    return x.transpose(1, 2).reshape(B, L, H * Dh)
