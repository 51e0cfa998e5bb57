"""LSTM/GRU stacks (counterpart of the JAX package's ops/rnn.py).

One `nn.LSTM`/`nn.GRU(num_layers, bidirectional)` over packed sequences gives
the semantics the JAX scan reproduces with `reverse_in_length`: the backward
direction starts at each row's true last step, and padded steps output 0.
Zero-length rows are packed with length 1 and their outputs masked to 0, as
JAX masks them; the mask also keeps any gradient from reaching the weights
through such a row.

Training: cuDNN refuses an RNN backward in eval mode, and the taggers apply
their dropout outside the stack (the recurrent module's own `dropout` is 0),
so `forward` puts the recurrent module into train mode whenever a gradient
is wanted, whatever the mode of the tagger around it.

Host lengths: `pack_padded_sequence` takes its lengths on the host, copies
its sort order to the device and `pad_packed_sequence` the inverse order
back; on a card each of these waits for every queued kernel. A device
lengths tensor that carries its packing order (`with_host_lengths`, set
where batches are copied to the device) is packed and unpacked from it, so
that a train step of the recurrent taggers enqueues without waiting.

Parameters keep torch's layout and names (`weight_ih_l{k}[_reverse]`,
separate `bias_ih`/`bias_hh`); `from_jax_params` maps the JAX per-layer
pytree onto them, the legacy fused LSTM bias {"b"} as b_ih = b, b_hh = 0.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn.utils.rnn import PackedSequence, pack_padded_sequence, pad_packed_sequence

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
        tf_init(self.rnn, generator)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """x [B, L, D], lengths [B] -> [B, L, H * directions], padding zeroed."""
        return run_packed(self.rnn, x, lengths)


@torch.no_grad()
def tf_init(rnn: nn.RNNBase, generator: torch.Generator = None):
    """Reference TF-style init: xavier-uniform W_ih, orthogonal W_hh, zero
    biases, LSTM forget-gate bias 1 on b_ih."""
    H = rnn.hidden_size
    for name, p in rnn.named_parameters():
        if name.startswith("weight_ih"):
            nn.init.xavier_uniform_(p, generator=generator)
        elif name.startswith("weight_hh"):
            nn.init.orthogonal_(p, generator=generator)
        else:
            p.zero_()
            if isinstance(rnn, nn.LSTM) and name.startswith("bias_ih"):
                p[H : 2 * H] = 1.0


def with_host_lengths(lengths: torch.Tensor, host: torch.Tensor) -> torch.Tensor:
    """Attach to the device tensor `lengths` the packing order made from
    `host`, its CPU copy: the sorted lengths (on the host, as the packing
    wants them) and the sort order (copied to the device now). `run_packed`
    then packs and unpacks without a transfer. -> lengths."""
    sorted_lengths, order = torch.sort(host.long().clamp_min(1), descending=True)
    lengths.host_packing = (sorted_lengths, order.to(lengths.device))
    return lengths


def run_packed(rnn: nn.RNNBase, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """A batch-first `nn.LSTM`/`nn.GRU` over packed sequences: x [B, L, D],
    lengths [B] -> [B, L, H * directions], padding zeroed."""
    L = x.shape[1]
    # train() on the recurrent module changes nothing but cuDNN's choice of
    # a path that keeps what its backward needs (its dropout is 0)
    rnn.train(torch.is_grad_enabled())
    packing = getattr(lengths, "host_packing", None)
    if packing is None:
        packed = pack_padded_sequence(x, lengths.cpu().long().clamp_min(1), batch_first=True,
                                      enforce_sorted=False)
        y, _ = pad_packed_sequence(rnn(packed)[0], batch_first=True, total_length=L)
    else:
        # pack_padded_sequence / pad_packed_sequence step for step, with the
        # order already on the device (they copy it there, and the lengths back)
        sorted_lengths, order = packing
        data, batch_sizes = torch._pack_padded_sequence(x.index_select(0, order), sorted_lengths,
                                                        True)
        out = rnn(PackedSequence(data, batch_sizes, order))[0]
        y = torch._pad_packed_sequence(out.data, out.batch_sizes, True, 0.0, L)[0]
        y = y.index_select(0, out.unsorted_indices)
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
