"""Common tagger pieces (counterpart of the JAX package's models/base.py):
the config, the classification head's loss and decode, dropout with an
explicit generator, and the linear init."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops import losses as losses_lib
from ..ops.masks import length_mask


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


def head_loss(cfg: TaggerConfig, logits: torch.Tensor, lengths: torch.Tensor,
              tags: torch.Tensor) -> torch.Tensor:
    """The classification head's loss, shared by every non-CRF tagger, in the
    reference's three branches (models/CRF.py:331-356): BCE and focal over
    the unpadded positions; CE over ALL positions, relying on the -1 padding
    label."""
    L = logits.shape[1]
    if cfg.loss_fn == "CrossEntropy":
        return losses_lib.cross_entropy_ignore_index(
            logits.reshape(-1, cfg.tagset_size), tags.reshape(-1).to(torch.int32))
    mask = length_mask(lengths.to(logits.device), L, logits.dtype).reshape(-1)
    flat = logits[..., 0].reshape(-1)
    t = tags.reshape(-1).to(logits.dtype)
    t = torch.where(mask > 0, t, 0.0)  # padded tags may be -1; masked out anyway
    if cfg.loss_fn == "FocalLoss":
        return losses_lib.sigmoid_focal_loss(flat, t, mask, cfg.alpha, cfg.gamma)
    return losses_lib.bce_loss(flat, t, mask)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout drawn from an explicit generator on x's device.
    Inactive when `deterministic`, without a generator, or at rate 0."""
    if deterministic or generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    m = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(m, x / keep, 0.0)


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


def linear_from_jax(sd: dict, prefix: str, p: dict):
    """A JAX linear {"w": [in, out], "b"} into `sd` as `prefix.weight/bias`."""
    sd[f"{prefix}.weight"] = torch.from_numpy(np.array(p["w"], np.float32).T.copy())
    sd[f"{prefix}.bias"] = torch.from_numpy(np.array(p["b"], np.float32))


def linear_to_jax(sd: dict, prefix: str) -> dict:
    """Inverse of `linear_from_jax` (numpy leaves)."""
    return {"w": sd[f"{prefix}.weight"].detach().cpu().numpy().T.copy(),
            "b": sd[f"{prefix}.bias"].detach().cpu().numpy().copy()}
