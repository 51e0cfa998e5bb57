"""Common tagger pieces (counterpart of the JAX package's models/base.py,
inference side: the losses and `head_loss` come with the training slice)."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class TaggerConfig:
    """Static hyperparameters shared by the zoo (reference flag names kept);
    the same fields as the JAX TaggerConfig, with a torch `dtype`."""

    embedding_dim: int = 768
    hidden_dim: int = 256
    num_layers: int = 2
    tagset_size: int = 2
    bidirectional: bool = True
    lstm: bool = True  # False -> GRU (reference --NoLSTM)
    dropout_in: float = 0.0
    dropout_out: float = 0.0
    loss_fn: str = "CrossEntropy"  # CrossEntropy | BinaryCrossEntropy | FocalLoss
    alpha: float = 0.9
    gamma: float = 2.0
    threshold: Optional[float] = None
    nheads: int = 8
    attention_window: int = 120
    positional_encoding: bool = True
    embedding_dim2: int = 0
    switch: str = "dense"
    cosine_loss: bool = False
    dtype: object = torch.float32

    @classmethod
    def from_dict(cls, d: dict) -> "TaggerConfig":
        """From a checkpoint's config dict (a JAX checkpoint's `dtype` is a
        JAX global and is dropped: the port runs in float32)."""
        d = dict(d)
        d.pop("dtype", None)
        return cls(**d)


def head_dim(cfg: TaggerConfig) -> int:
    return cfg.tagset_size if cfg.loss_fn == "CrossEntropy" else 1


def head_decode(cfg: TaggerConfig, logits: torch.Tensor, threshold) -> torch.Tensor:
    """scores -> boolean boundary tags (reference models/CRF.py:362-368)."""
    if cfg.loss_fn == "CrossEntropy":
        probs = torch.softmax(logits, dim=-1)[..., 1]
    else:
        probs = torch.sigmoid(logits[..., 0])
    return probs > threshold


def linear(in_dim: int, out_dim: int, generator: torch.Generator = None) -> nn.Linear:
    """nn.Linear with torch's default init, U(+-1/sqrt(fan_in)) for weight and
    bias, drawn from `generator`."""
    layer = nn.Linear(in_dim, out_dim)
    bound = 1.0 / math.sqrt(in_dim)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)
    return layer
