"""Attention-based taggers for inference: the transformer / Longformer /
LongT5 families (counterpart of the JAX package's models/transformers.py).

- `BertStyleEncoder`: BERT-style post-LN encoder over input embeddings with
  one learned positional table, dense or with a per-layer sliding window.
- `LongT5Encoder`: T5-style pre-RMSNorm blocks with unscaled local attention
  and a relative-position-bucket bias.
- Taggers: `TransformerSegmenter` (pyramidal windows, or dense),
  `RecurrentLongT5` ([BiLSTM -> LongT5 block] x num_layers) and
  `RecurrentLongformer` ([BiLSTM -> bare local-MHA block] x num_layers with
  the separate forward/backward trick, then a final BiLSTM).

All windowed attention goes through `ops.attention.local_attention`: the
flash kernel on a CUDA tensor, the blocked plain-torch path on the CPU.

State-dict names follow the reference modules' layouts that the JAX
package's checkpoint converter reads, wherever they map one to one (HF
`encoder.layer.{i}.attention.self.query`, `LocalSelfAttention.q`, ...). The
positional table is the JAX package's one folded [4096, D] table
(`embeddings.position_table`), not HF's offset rows plus a token-type row.
Each tagger converts with `from_jax_params` / `to_jax_params`.

Inference only: dropout, the losses, rematerialisation, the
sequence-parallel hooks and `TransformerCRF` are not here yet.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import rnn as rnn_lib
from ..ops.attention import (
    dense_attention,
    local_attention,
    merge_heads,
    relative_bias_fn,
    split_heads,
)
from ..ops.masks import length_mask
from .base import TaggerConfig, head_decode, head_dim, linear

LAYER_NORM_EPS = 1e-12  # HF BertConfig/LongformerConfig default, which the reference runs
MAX_POSITION = 4096


def _bag(**children) -> nn.Module:
    """A module that only names its children (the reference layouts nest
    several such levels)."""
    m = nn.Module()
    for name, child in children.items():
        m.add_module(name, child)
    return m


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        var = x.square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * self.weight


def _attend(query, key, value, x, nheads, mask, window=None, bias_fn=None, scale=True):
    """Projections + attention core -> merged heads [B, L, D] (no output
    projection). window None = dense."""
    q = split_heads(query(x), nheads)
    k = split_heads(key(x), nheads)
    v = split_heads(value(x), nheads)
    if window is None:
        out = dense_attention(q, k, v, mask)
    else:
        out = local_attention(q, k, v, window, mask, bias_fn=bias_fn, scale=scale)
    return merge_heads(out)


# -- JAX pytree <-> state_dict leaves ---------------------------------------

def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _linear_from_jax(sd: dict, prefix: str, p: dict):
    sd[f"{prefix}.weight"] = _t(np.transpose(p["w"]))
    sd[f"{prefix}.bias"] = _t(p["b"])


def _linear_to_jax(sd: dict, prefix: str) -> dict:
    return {"w": _n(sd[f"{prefix}.weight"]).T.copy(), "b": _n(sd[f"{prefix}.bias"])}


def _norm_from_jax(sd: dict, prefix: str, p: dict):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _norm_to_jax(sd: dict, prefix: str) -> dict:
    out = {"scale": _n(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = _n(sd[f"{prefix}.bias"])
    return out


def _lstm_from_jax(sd: dict, prefix: str, pair: dict):
    sd.update(rnn_lib.from_jax_params([pair], prefix=f"{prefix}.rnn"))


def _lstm_to_jax(sd: dict, prefix: str) -> dict:
    return rnn_lib.to_jax_params(sd, 1, True, prefix=f"{prefix}.rnn")[0]


def _count(sd: dict, template: str) -> int:
    n = 0
    while template.format(n) in sd:
        n += 1
    return n


# ---------------------------------------------------------------------------
# BERT-style post-LN encoder (classic / Longformer windows)
# ---------------------------------------------------------------------------


class BertLayer(nn.Module):
    def __init__(self, d_model, nheads, d_ff, generator=None):
        super().__init__()
        self.nheads = nheads
        lin = lambda i, o: linear(i, o, generator)  # noqa: E731
        self.attention = _bag(
            self=_bag(query=lin(d_model, d_model), key=lin(d_model, d_model),
                      value=lin(d_model, d_model)),
            output=_bag(dense=lin(d_model, d_model),
                        LayerNorm=nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)),
        )
        self.intermediate = _bag(dense=lin(d_model, d_ff))
        self.output = _bag(dense=lin(d_ff, d_model),
                           LayerNorm=nn.LayerNorm(d_model, eps=LAYER_NORM_EPS))

    def forward(self, x, mask, window=None):
        att = getattr(self.attention, "self")
        a = _attend(att.query, att.key, att.value, x, self.nheads, mask, window)
        x = self.attention.output.LayerNorm(x + self.attention.output.dense(a))
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(self.intermediate.dense(x), approximate="tanh")
        return self.output.LayerNorm(x + self.output.dense(h))


class BertStyleEncoder(nn.Module):
    """windows: None (dense) or one window per layer."""

    def __init__(self, d_model, nheads, n_layers, d_ff, windows, max_position=MAX_POSITION,
                 generator=None):
        super().__init__()
        self.windows = windows
        table = torch.empty(max_position, d_model).normal_(generator=generator) * 0.02
        emb = _bag(LayerNorm=nn.LayerNorm(d_model, eps=LAYER_NORM_EPS))
        emb.position_table = nn.Parameter(table)
        self.embeddings = emb
        self.encoder = _bag(layer=nn.ModuleList(
            BertLayer(d_model, nheads, d_ff, generator) for _ in range(n_layers)))

    def forward(self, x, lengths):
        L = x.shape[1]
        table = self.embeddings.position_table
        if L > table.shape[0]:
            raise ValueError(f"{L} units exceed the positional table's {table.shape[0]} rows")
        mask = length_mask(lengths.to(x.device), L, x.dtype)
        x = self.embeddings.LayerNorm(x + table[:L][None])
        for i, layer in enumerate(self.encoder.layer):
            x = layer(x, mask, None if self.windows is None else self.windows[i])
        return x

    @staticmethod
    def from_jax_params(p: dict, prefix: str) -> dict:
        sd = {f"{prefix}.embeddings.position_table": _t(p["pos"])}
        _norm_from_jax(sd, f"{prefix}.embeddings.LayerNorm", p["ln_emb"])
        for i, lp in enumerate(p["layers"]):
            b = f"{prefix}.encoder.layer.{i}"
            for name, key in (("query", "q"), ("key", "k"), ("value", "v")):
                _linear_from_jax(sd, f"{b}.attention.self.{name}", lp["attn"][key])
            _linear_from_jax(sd, f"{b}.attention.output.dense", lp["attn"]["o"])
            _norm_from_jax(sd, f"{b}.attention.output.LayerNorm", lp["ln1"])
            _linear_from_jax(sd, f"{b}.intermediate.dense", lp["ff1"])
            _linear_from_jax(sd, f"{b}.output.dense", lp["ff2"])
            _norm_from_jax(sd, f"{b}.output.LayerNorm", lp["ln2"])
        return sd

    @staticmethod
    def to_jax_params(sd: dict, prefix: str) -> dict:
        layers = []
        for i in range(_count(sd, prefix + ".encoder.layer.{}.attention.self.query.weight")):
            b = f"{prefix}.encoder.layer.{i}"
            layers.append({
                "attn": {
                    "q": _linear_to_jax(sd, f"{b}.attention.self.query"),
                    "k": _linear_to_jax(sd, f"{b}.attention.self.key"),
                    "v": _linear_to_jax(sd, f"{b}.attention.self.value"),
                    "o": _linear_to_jax(sd, f"{b}.attention.output.dense"),
                },
                "ln1": _norm_to_jax(sd, f"{b}.attention.output.LayerNorm"),
                "ff1": _linear_to_jax(sd, f"{b}.intermediate.dense"),
                "ff2": _linear_to_jax(sd, f"{b}.output.dense"),
                "ln2": _norm_to_jax(sd, f"{b}.output.LayerNorm"),
            })
        return {"pos": _n(sd[f"{prefix}.embeddings.position_table"]),
                "ln_emb": _norm_to_jax(sd, f"{prefix}.embeddings.LayerNorm"),
                "layers": layers}


# ---------------------------------------------------------------------------
# LongT5-style pre-RMSNorm encoder with relative-bucket local attention
# ---------------------------------------------------------------------------


class LongT5Encoder(nn.Module):
    """`window` is HF LongT5's local radius r: each unit attends |i - j| <= r,
    a two-sided band of 2r. The linears keep their biases (the JAX package's
    shared linear does; a converted reference checkpoint holds zeros). One
    relative-bias table, held by block 0 as in HF, serves every block."""

    def __init__(self, d_model, nheads, n_layers, d_ff, window, generator=None):
        super().__init__()
        self.nheads = nheads
        self.num_buckets = max(4, window)
        self.max_distance = window + 1
        self.window = 2 * window
        lin = lambda i, o: linear(i, o, generator)  # noqa: E731
        blocks = []
        for _ in range(n_layers):
            attn = _bag(q=lin(d_model, d_model), k=lin(d_model, d_model),
                        v=lin(d_model, d_model), o=lin(d_model, d_model))
            ffn = _bag(wi=lin(d_model, d_ff), wo=lin(d_ff, d_model))
            blocks.append(_bag(layer=nn.ModuleList([
                _bag(LocalSelfAttention=attn, layer_norm=RMSNorm(d_model)),
                _bag(DenseReluDense=ffn, layer_norm=RMSNorm(d_model)),
            ])))
        rel = nn.Embedding(self.num_buckets, nheads)
        with torch.no_grad():
            rel.weight.copy_(torch.empty(self.num_buckets, nheads).normal_(generator=generator) * 0.02)
        blocks[0].layer[0].LocalSelfAttention.relative_attention_bias = rel
        self.encoder = _bag(block=nn.ModuleList(blocks), final_layer_norm=RMSNorm(d_model))
        self._bias_fn = relative_bias_fn(rel.weight, self.num_buckets, self.max_distance)

    def forward(self, x, lengths):
        mask = length_mask(lengths.to(x.device), x.shape[1], x.dtype)
        for block in self.encoder.block:
            sa, ff = block.layer[0], block.layer[1]
            a = sa.LocalSelfAttention
            h = _attend(a.q, a.k, a.v, sa.layer_norm(x), self.nheads, mask, self.window,
                        bias_fn=self._bias_fn, scale=False)  # T5 attention is unscaled
            x = x + a.o(h)
            h = ff.layer_norm(x)
            x = x + ff.DenseReluDense.wo(F.relu(ff.DenseReluDense.wi(h)))
        return self.encoder.final_layer_norm(x)

    @staticmethod
    def from_jax_params(p: dict, prefix: str) -> dict:
        sd = {}
        for j, lp in enumerate(p["layers"]):
            b = f"{prefix}.encoder.block.{j}"
            for key in ("q", "k", "v", "o"):
                _linear_from_jax(sd, f"{b}.layer.0.LocalSelfAttention.{key}", lp["attn"][key])
            _norm_from_jax(sd, f"{b}.layer.0.layer_norm", lp["ln1"])
            _linear_from_jax(sd, f"{b}.layer.1.DenseReluDense.wi", lp["wi"])
            _linear_from_jax(sd, f"{b}.layer.1.DenseReluDense.wo", lp["wo"])
            _norm_from_jax(sd, f"{b}.layer.1.layer_norm", lp["ln2"])
        sd[f"{prefix}.encoder.block.0.layer.0.LocalSelfAttention.relative_attention_bias.weight"] = \
            _t(p["rel_bias"])
        _norm_from_jax(sd, f"{prefix}.encoder.final_layer_norm", p["ln_final"])
        return sd

    @staticmethod
    def to_jax_params(sd: dict, prefix: str) -> dict:
        layers = []
        for j in range(_count(sd, prefix + ".encoder.block.{}.layer.0.LocalSelfAttention.q.weight")):
            b = f"{prefix}.encoder.block.{j}"
            layers.append({
                "attn": {key: _linear_to_jax(sd, f"{b}.layer.0.LocalSelfAttention.{key}")
                         for key in ("q", "k", "v", "o")},
                "ln1": _norm_to_jax(sd, f"{b}.layer.0.layer_norm"),
                "wi": _linear_to_jax(sd, f"{b}.layer.1.DenseReluDense.wi"),
                "wo": _linear_to_jax(sd, f"{b}.layer.1.DenseReluDense.wo"),
                "ln2": _norm_to_jax(sd, f"{b}.layer.1.layer_norm"),
            })
        rel = sd[f"{prefix}.encoder.block.0.layer.0.LocalSelfAttention.relative_attention_bias.weight"]
        return {"layers": layers, "rel_bias": _n(rel),
                "ln_final": _norm_to_jax(sd, f"{prefix}.encoder.final_layer_norm")}


# ---------------------------------------------------------------------------
# Taggers
# ---------------------------------------------------------------------------


def pyramidal_windows(window: int, n_layers: int) -> List[int]:
    """[w*k for k in n_layers..1], forced even."""
    ws = [window * k for k in range(n_layers, 0, -1)]
    return [w if w % 2 == 0 else w + 1 for w in ws]


class _Tagger(nn.Module):
    """scores -> decode, and the state-dict view the converters work on."""

    def decode(self, x: torch.Tensor, lengths: torch.Tensor, threshold: float):
        logits = self.scores(x, lengths)
        return logits, head_decode(self.cfg, logits, threshold)

    def to_jax_params(self) -> dict:
        """This tagger's weights as the JAX pytree (numpy leaves)."""
        return self._to_jax(self.state_dict())


class TransformerSegmenter(_Tagger):
    """Pyramidal local-attention encoder (or a dense one) + classification
    head; d_model = embedding_dim, FFN width = hidden_dim."""

    def __init__(self, cfg: TaggerConfig, restricted: bool = True,
                 generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        windows = pyramidal_windows(cfg.attention_window, cfg.num_layers) if restricted else None
        self.model = _bag(model=BertStyleEncoder(cfg.embedding_dim, cfg.nheads, cfg.num_layers,
                                                 cfg.hidden_dim, windows, generator=generator))
        self.classification = linear(cfg.embedding_dim, head_dim(cfg), generator)

    def scores(self, x, lengths):
        return self.classification(self.model.model(x, lengths))

    @staticmethod
    def from_jax_params(params: dict) -> dict:
        sd = BertStyleEncoder.from_jax_params(params["encoder"], "model.model")
        _linear_from_jax(sd, "classification", params["cls"])
        return sd

    @staticmethod
    def _to_jax(sd: dict) -> dict:
        return {"encoder": BertStyleEncoder.to_jax_params(sd, "model.model"),
                "cls": _linear_to_jax(sd, "classification")}


class RecurrentLongT5(_Tagger):
    """Stacked [BiLSTM -> one-block LongT5 encoder] x num_layers; the
    encoders run at d_model = FFN width = 2 * hidden_dim."""

    def __init__(self, cfg: TaggerConfig, generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        d = 2 * cfg.hidden_dim
        blocks, in_dim = [], cfg.embedding_dim
        for _ in range(cfg.num_layers):
            blocks.append(_bag(
                lstm=rnn_lib.RNNStack(in_dim, cfg.hidden_dim, 1, generator=generator),
                transformer=_bag(model=LongT5Encoder(d, cfg.nheads, 1, d, cfg.attention_window,
                                                     generator)),
            ))
            in_dim = d
        self.model = nn.ModuleList(blocks)
        self.classification = linear(d, head_dim(cfg), generator)

    def scores(self, x, lengths):
        h = x
        for block in self.model:
            h = block.transformer.model(block.lstm(h, lengths), lengths)
        return self.classification(h)

    @staticmethod
    def from_jax_params(params: dict) -> dict:
        sd = {}
        for i, bp in enumerate(params["blocks"]):
            _lstm_from_jax(sd, f"model.{i}.lstm", bp["lstm"])
            sd.update(LongT5Encoder.from_jax_params(bp["t5"], f"model.{i}.transformer.model"))
        _linear_from_jax(sd, "classification", params["cls"])
        return sd

    @staticmethod
    def _to_jax(sd: dict) -> dict:
        blocks = [
            {"lstm": _lstm_to_jax(sd, f"model.{i}.lstm"),
             "t5": LongT5Encoder.to_jax_params(sd, f"model.{i}.transformer.model")}
            for i in range(_count(sd, "model.{}.lstm.rnn.weight_ih_l0"))
        ]
        return {"blocks": blocks, "cls": _linear_to_jax(sd, "classification")}


class RecurrentLongformer(_Tagger):
    """Stacked [BiLSTM -> bare local-MHA block], topped by a final BiLSTM.

    The block is attention only and returns the merged-head context: no
    output projection, residual or LayerNorm. With
    `separate_forward_backward`, queries AND values come from the forward
    LSTM half `h[..., :H]` and only the keys from the backward half. Scores
    are scaled by 1/sqrt(head_dim); an odd window is rounded up."""

    def __init__(self, cfg: TaggerConfig, separate_forward_backward: bool = True,
                 last_bilstm: bool = True, generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        self.sep_fb = separate_forward_backward
        self.last_bilstm = last_bilstm
        w = cfg.attention_window
        self.window = w if w % 2 == 0 else w + 1
        H = cfg.hidden_dim
        attn_dim = H if self.sep_fb else 2 * H
        lin = lambda: linear(attn_dim, attn_dim, generator)  # noqa: E731
        blocks, in_dim = [], cfg.embedding_dim
        for _ in range(cfg.num_layers):
            blocks.append(_bag(
                lstm=rnn_lib.RNNStack(in_dim, H, 1, generator=generator),
                transformer=_bag(model=_bag(attention=_bag(
                    self=_bag(query=lin(), key=lin(), value=lin())))),
            ))
            in_dim = attn_dim
        out_dim = attn_dim
        if last_bilstm:
            blocks.append(rnn_lib.RNNStack(attn_dim, H, 1, generator=generator))
            out_dim = 2 * H
        self.model = nn.ModuleList(blocks)
        self.classification = linear(out_dim, head_dim(cfg), generator)

    def scores(self, x, lengths):
        H, nh = self.cfg.hidden_dim, self.cfg.nheads
        mask = length_mask(lengths.to(x.device), x.shape[1], x.dtype)
        h = x
        for block in list(self.model)[: self.cfg.num_layers]:
            h = block.lstm(h, lengths)
            if self.sep_fb:
                q_src, k_src = h[..., :H], h[..., H:]
                v_src = q_src
            else:
                q_src = k_src = v_src = h
            att = getattr(block.transformer.model.attention, "self")
            h = merge_heads(local_attention(
                split_heads(att.query(q_src), nh), split_heads(att.key(k_src), nh),
                split_heads(att.value(v_src), nh), self.window, mask))
        if self.last_bilstm:
            h = self.model[self.cfg.num_layers](h, lengths)
        return self.classification(h)

    @staticmethod
    def from_jax_params(params: dict) -> dict:
        sd = {}
        n = len(params["blocks"])
        for i, bp in enumerate(params["blocks"]):
            _lstm_from_jax(sd, f"model.{i}.lstm", bp["lstm"])
            for name, key in (("query", "q"), ("key", "k"), ("value", "v")):
                _linear_from_jax(sd, f"model.{i}.transformer.model.attention.self.{name}",
                                 bp["attn"][key])
        if "final_lstm" in params:
            _lstm_from_jax(sd, f"model.{n}", params["final_lstm"])
        _linear_from_jax(sd, "classification", params["cls"])
        return sd

    @staticmethod
    def _to_jax(sd: dict) -> dict:
        n = _count(sd, "model.{}.lstm.rnn.weight_ih_l0")
        a = "model.{}.transformer.model.attention.self"
        params = {"blocks": [
            {"lstm": _lstm_to_jax(sd, f"model.{i}.lstm"),
             "attn": {"q": _linear_to_jax(sd, a.format(i) + ".query"),
                      "k": _linear_to_jax(sd, a.format(i) + ".key"),
                      "v": _linear_to_jax(sd, a.format(i) + ".value")}}
            for i in range(n)
        ]}
        if f"model.{n}.rnn.weight_ih_l0" in sd:
            params["final_lstm"] = _lstm_to_jax(sd, f"model.{n}")
        params["cls"] = _linear_to_jax(sd, "classification")
        return params
