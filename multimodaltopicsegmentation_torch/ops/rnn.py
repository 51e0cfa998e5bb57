"""LSTM/GRU stacks for inference (counterpart of the JAX package's ops/rnn.py).

One `nn.LSTM`/`nn.GRU(num_layers, bidirectional)` over packed sequences gives
the semantics the JAX scan reproduces with `reverse_in_length`: the backward
direction starts at each row's true last step, and padded steps output 0.
Zero-length rows are packed with length 1 and their outputs masked to 0, as
JAX masks them.

Parameters keep torch's layout and names (`weight_ih_l{k}[_reverse]`,
separate `bias_ih`/`bias_hh`); `from_jax_params` maps the JAX per-layer
pytree onto them, the legacy fused LSTM bias {"b"} as b_ih = b, b_hh = 0.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from .masks import length_mask


class RNNStack(nn.Module):
    """Holds the recurrent stack as `.rnn` (the reference RNN wrapper's name,
    so state-dict keys read `model.rnn.*` inside a tagger)."""

    def __init__(self, in_dim: int, hidden: int, num_layers: int, bidirectional: bool = True,
                 lstm: bool = True, generator: torch.Generator = None):
        super().__init__()
        cls = nn.LSTM if lstm else nn.GRU
        self.rnn = cls(in_dim, hidden, num_layers=num_layers, bidirectional=bidirectional,
                       batch_first=True)
        self._init(generator, lstm)

    @torch.no_grad()
    def _init(self, generator, lstm):
        """Reference TF-style init: xavier-uniform W_ih, orthogonal W_hh, zero
        biases, LSTM forget-gate bias 1 on b_ih."""
        H = self.rnn.hidden_size
        for name, p in self.rnn.named_parameters():
            if name.startswith("weight_ih"):
                nn.init.xavier_uniform_(p, generator=generator)
            elif name.startswith("weight_hh"):
                nn.init.orthogonal_(p, generator=generator)
            else:
                p.zero_()
                if lstm and name.startswith("bias_ih"):
                    p[H : 2 * H] = 1.0

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """x [B, L, D], lengths [B] -> [B, L, H * directions], padding zeroed."""
        L = x.shape[1]
        packed = pack_padded_sequence(x, lengths.cpu().long().clamp_min(1), batch_first=True,
                                      enforce_sorted=False)
        y, _ = pad_packed_sequence(self.rnn(packed)[0], batch_first=True, total_length=L)
        return y * length_mask(lengths.to(x.device), L, y.dtype)[..., None]


def from_jax_params(layers: list, prefix: str = "rnn") -> dict:
    """JAX stack [{"fwd": {...}, "bwd": {...}}, ...] -> RNNStack state_dict."""
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    sd = {}
    for k, layer in enumerate(layers):
        for key, suffix in (("fwd", ""), ("bwd", "_reverse")):
            if key not in layer:
                continue
            p = layer[key]
            sd[f"{prefix}.weight_ih_l{k}{suffix}"] = t(np.transpose(p["w_ih"]))
            sd[f"{prefix}.weight_hh_l{k}{suffix}"] = t(np.transpose(p["w_hh"]))
            if "b" in p:  # legacy fused LSTM bias
                sd[f"{prefix}.bias_ih_l{k}{suffix}"] = t(p["b"])
                sd[f"{prefix}.bias_hh_l{k}{suffix}"] = torch.zeros_like(t(p["b"]))
            else:
                sd[f"{prefix}.bias_ih_l{k}{suffix}"] = t(p["b_ih"])
                sd[f"{prefix}.bias_hh_l{k}{suffix}"] = t(p["b_hh"])
    return sd


def to_jax_params(sd: dict, num_layers: int, bidirectional: bool, prefix: str = "rnn") -> list:
    """Inverse of `from_jax_params` (numpy leaves, the JAX checkpoint layout)."""
    n = lambda name: sd[f"{prefix}.{name}"].detach().cpu().numpy()  # noqa: E731
    layers = []
    dirs = (("fwd", ""), ("bwd", "_reverse")) if bidirectional else (("fwd", ""),)
    for k in range(num_layers):
        layers.append({
            key: {"w_ih": n(f"weight_ih_l{k}{s}").T.copy(), "w_hh": n(f"weight_hh_l{k}{s}").T.copy(),
                  "b_ih": n(f"bias_ih_l{k}{s}"), "b_hh": n(f"bias_hh_l{k}{s}")}
            for key, s in dirs
        })
    return layers
