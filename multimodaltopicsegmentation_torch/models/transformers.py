"""Attention-based taggers: the transformer / Longformer / LongT5 families
(counterpart of the JAX package's models/transformers.py).

- `BertStyleEncoder`: BERT-style post-LN encoder over input embeddings with
  one learned positional table, dense or with a per-layer sliding window.
- `LongT5Encoder`: T5-style pre-RMSNorm blocks with unscaled local attention
  and a relative-position-bucket bias.
- Taggers: `TransformerSegmenter` (pyramidal windows, or dense),
  `TransformerCRF` (the dense encoder under a linear-chain CRF),
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

Training. `loss(x, lengths, tags, generator)` runs the forward with
`train=True`; dropout is active only with a generator (on x's device), which
tensors are dropped and at which rate follows the JAX package: the BERT-style
encoder drops its normalised embeddings and both sublayer outputs at
dropout_in and its attention weights at dropout_out (0.1 on the dense
variant, the HF default the reference never overrides); a LongT5 block drops
its attention weights and both sublayer outputs at its one rate; the
recurrent hybrids drop the LSTM's input at dropout_in and its output at
dropout_out, and the bare local-MHA block its attention weights at 0.1.
Validation and decode run without dropout.

Rematerialisation. Each encoder layer may run under
`torch.utils.checkpoint` (recompute in the backward instead of storing):
`remat=True/False` forces it, `None` decides per call from an estimate of the
stored bytes against a quarter of the card's own memory; on the CPU, where
the blocked attention path stores banded score tensors, it stays on. A
checkpointed layer that drops re-draws the same tiles: the generator is set
back to its state at the layer's entry for the recomputation.

Sequence parallelism: `BertStyleEncoder.forward` takes `attend_fn`,
`pos_offset` and `mask` (parallel/sequence.py); `embed` and `run_layers`
are its two halves, which the pipeline stages run apart
(parallel/pipeline.py).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import crf as crf_lib
from ..ops import rnn as rnn_lib
from ..ops.attention import (
    dense_attention,
    flash_attention_active,
    local_attention,
    merge_heads,
    relative_bias_fn,
    split_heads,
)
from ..ops.masks import length_mask
from .base import (TaggerConfig, dropout, head_decode, head_dim, head_loss, linear,
                   linear_from_jax, linear_to_jax)

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


def _attend(query, key, value, x, nheads, mask, window=None, bias_fn=None, scale=True,
            probs_drop=0.0, generator=None):
    """Projections + attention core -> merged heads [B, L, D] (no output
    projection). window None = dense. probs_drop/generator: train-time
    attention-probs dropout (no generator at eval)."""
    q = split_heads(query(x), nheads)
    k = split_heads(key(x), nheads)
    v = split_heads(value(x), nheads)
    if window is None:
        out = dense_attention(q, k, v, mask, probs_drop=probs_drop, generator=generator)
    else:
        out = local_attention(q, k, v, window, mask, bias_fn=bias_fn, scale=scale,
                              probs_drop=probs_drop, generator=generator)
    return merge_heads(out)


# -- rematerialisation -------------------------------------------------------

REMAT_MEMORY_SHARE = 4  # spend at most 1/4 of the card's memory on stored activations


def _auto_remat(device, B, L, d_model, d_ff, nheads, layer_windows, share=1, attn_drop=0.0):
    """Per-call rematerialisation policy: store activations when they fit
    comfortably, recompute when they would not.

    On a CUDA device (flash attention keeps the score tiles out of device
    memory) the stored bytes are estimated as about 12 d_model-wide unit
    tensors and 2 d_ff-wide FFN intermediates per layer, plus the softmax
    weights where a layer is dense and, with active attention-probs dropout,
    the largest layer's transient 0/1 tile; remat is OFF when `share` sibling
    stacks of this size stay under a quarter of that device's memory.
    Anywhere else the blocked path stores banded score tensors that the
    estimate leaves out, and remat stays ON."""
    device = torch.device(device)
    if not flash_attention_active(device):
        return True
    from ..ops.flash_attention import _flash_geometry

    est, mask_temp = 0, 0
    for w in layer_windows:
        est += B * L * (12 * d_model + 2 * d_ff) * 4
        if w is None:  # dense layer: the stored softmax weights dominate
            est += 2 * B * nheads * L * L * 4
        elif attn_drop and attn_drop > 0.0:
            block, nb, _ = _flash_geometry(L, w // 2)
            mask_temp = max(mask_temp, B * nheads * nb * block * 3 * block * 4)
    budget = torch.cuda.get_device_properties(device).total_memory // REMAT_MEMORY_SHARE
    return (est + mask_temp) * share > budget


def _checkpoint(fn, generator, *args):
    """`fn(*args)` under torch.utils.checkpoint. The recomputation in the
    backward runs with `generator` set back to its state at this call, so
    that a layer that drops draws the same tiles again; the state the
    generator had reached by then is put back afterwards."""
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False)
    entry = generator.get_state()
    calls = []

    def run(*a):
        calls.append(None)
        if len(calls) == 1:
            return fn(*a)
        reached = generator.get_state()
        generator.set_state(entry)
        try:
            return fn(*a)
        finally:
            generator.set_state(reached)

    return checkpoint(run, *args, use_reentrant=False)


# -- JAX pytree <-> state_dict leaves ---------------------------------------

def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


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

    def forward(self, x, mask, window=None, train=False, generator=None, drop=0.0,
                attn_drop=0.0, attend_fn=None):
        """`drop` is HF hidden_dropout_prob, on both sublayer outputs;
        `attn_drop` attention_probs_dropout_prob, on the softmaxed weights.
        `attend_fn(attention.self, x, mask, window)` -> merged heads [B, L, D]
        replaces the attention core (the sequence-parallel halo variant,
        which skips attention-probs dropout); every other sublayer is
        per-position."""
        att = getattr(self.attention, "self")
        if attend_fn is not None:
            a = attend_fn(att, x, mask, window)
        else:
            a = _attend(att.query, att.key, att.value, x, self.nheads, mask, window,
                        probs_drop=attn_drop if train else 0.0,
                        generator=generator if train else None)
        a = dropout(self.attention.output.dense(a), drop, generator, not train)
        x = self.attention.output.LayerNorm(x + a)
        # jax.nn.gelu's default is the tanh approximation
        h = self.output.dense(F.gelu(self.intermediate.dense(x), approximate="tanh"))
        return self.output.LayerNorm(x + dropout(h, drop, generator, not train))


class BertStyleEncoder(nn.Module):
    """windows: None (dense) or one window per layer. drop / attn_drop: the
    train-time rates (see `BertLayer.forward`). remat: True/False forces
    per-layer checkpointing in training, None decides by `_auto_remat`."""

    def __init__(self, d_model, nheads, n_layers, d_ff, windows, drop=0.0,
                 max_position=MAX_POSITION, remat=None, attn_drop=0.0, generator=None):
        super().__init__()
        self.d_model, self.nheads, self.d_ff = d_model, nheads, d_ff
        self.windows = windows
        self.drop, self.attn_drop, self.remat = drop, attn_drop, remat
        table = torch.empty(max_position, d_model).normal_(generator=generator) * 0.02
        emb = _bag(LayerNorm=nn.LayerNorm(d_model, eps=LAYER_NORM_EPS))
        emb.position_table = nn.Parameter(table)
        self.embeddings = emb
        self.encoder = _bag(layer=nn.ModuleList(
            BertLayer(d_model, nheads, d_ff, generator) for _ in range(n_layers)))

    def forward(self, x, lengths, train=False, generator=None, attend_fn=None, pos_offset=None,
                mask=None):
        """`attend_fn`, `pos_offset` and `mask` serve the sequence-parallel
        path, where x holds one shard's units: the positional rows start at
        the shard's global offset and the mask comes from global positions.
        Without them this is the plain encoder."""
        if mask is None:
            mask = length_mask(lengths.to(x.device), x.shape[1], x.dtype)
        x = self.embed(x, train, generator, pos_offset)
        return self.run_layers(x, mask, range(len(self.encoder.layer)), train, generator,
                               attend_fn)

    def embed(self, x, train=False, generator=None, pos_offset=None):
        """The embedding sublayer: positional rows (from `pos_offset`), LayerNorm
        and, in training, HF's hidden dropout of the normalised embeddings."""
        L = x.shape[1]
        table = self.embeddings.position_table
        start = 0 if pos_offset is None else int(pos_offset)
        if start + L > table.shape[0]:
            raise ValueError(f"{start + L} units exceed the positional table's "
                             f"{table.shape[0]} rows")
        x = self.embeddings.LayerNorm(x + table[start:start + L][None])
        return dropout(x, self.drop, generator, not train)

    def run_layers(self, x, mask, layers, train=False, generator=None, attend_fn=None):
        """The encoder layers of index `layers` (in order) on embedded x. A
        layer is checkpointed in training by `_use_remat`, never with an
        `attend_fn` unless remat is forced (its recomputation would run the
        attention's exchange again)."""
        B, L, _ = x.shape
        remat = train and torch.is_grad_enabled() and (
            self.remat is True if attend_fn is not None
            else self._use_remat(x.device, B, L, generator))
        self.last_remat = remat
        for i in layers:
            layer = self.encoder.layer[i]
            w = None if self.windows is None else self.windows[i]

            def one_layer(x, mask, _layer=layer, _w=w):
                return _layer(x, mask, _w, train, generator, self.drop, self.attn_drop, attend_fn)

            x = _checkpoint(one_layer, generator, x, mask) if remat else one_layer(x, mask)
        return x

    def _use_remat(self, device, B, L, generator):
        if self.remat is not None:
            return self.remat
        windows = self.windows if self.windows is not None else [None] * len(self.encoder.layer)
        dropping = generator is not None and self.attn_drop > 0.0
        return _auto_remat(device, B, L, self.d_model, self.d_ff, self.nheads, windows,
                           attn_drop=self.attn_drop if dropping else 0.0)

    @staticmethod
    def from_jax_params(p: dict, prefix: str) -> dict:
        sd = {f"{prefix}.embeddings.position_table": _t(p["pos"])}
        _norm_from_jax(sd, f"{prefix}.embeddings.LayerNorm", p["ln_emb"])
        for i, lp in enumerate(p["layers"]):
            b = f"{prefix}.encoder.layer.{i}"
            for name, key in (("query", "q"), ("key", "k"), ("value", "v")):
                linear_from_jax(sd, f"{b}.attention.self.{name}", lp["attn"][key])
            linear_from_jax(sd, f"{b}.attention.output.dense", lp["attn"]["o"])
            _norm_from_jax(sd, f"{b}.attention.output.LayerNorm", lp["ln1"])
            linear_from_jax(sd, f"{b}.intermediate.dense", lp["ff1"])
            linear_from_jax(sd, f"{b}.output.dense", lp["ff2"])
            _norm_from_jax(sd, f"{b}.output.LayerNorm", lp["ln2"])
        return sd

    @staticmethod
    def to_jax_params(sd: dict, prefix: str) -> dict:
        layers = []
        for i in range(_count(sd, prefix + ".encoder.layer.{}.attention.self.query.weight")):
            b = f"{prefix}.encoder.layer.{i}"
            layers.append({
                "attn": {
                    "q": linear_to_jax(sd, f"{b}.attention.self.query"),
                    "k": linear_to_jax(sd, f"{b}.attention.self.key"),
                    "v": linear_to_jax(sd, f"{b}.attention.self.value"),
                    "o": linear_to_jax(sd, f"{b}.attention.output.dense"),
                },
                "ln1": _norm_to_jax(sd, f"{b}.attention.output.LayerNorm"),
                "ff1": linear_to_jax(sd, f"{b}.intermediate.dense"),
                "ff2": linear_to_jax(sd, f"{b}.output.dense"),
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

    def __init__(self, d_model, nheads, n_layers, d_ff, window, drop=0.0, remat=None,
                 remat_share=1, generator=None):
        super().__init__()
        self.d_model, self.nheads, self.d_ff = d_model, nheads, d_ff
        # one rate for the attention weights and both sublayer outputs (HF T5's dropout_rate)
        self.drop, self.remat = drop, remat
        # sibling encoder stacks sharing the remat budget (RecurrentLongT5
        # interleaves num_layers one-block stacks in one loss)
        self.remat_share = remat_share
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

    def forward(self, x, lengths, train=False, generator=None):
        B, L, _ = x.shape
        mask = length_mask(lengths.to(x.device), L, x.dtype)
        remat = train and torch.is_grad_enabled() and self._use_remat(x.device, B, L, generator)
        self.last_remat = remat
        for block in self.encoder.block:

            def one_block(x, mask, _block=block):
                sa, ff = _block.layer[0], _block.layer[1]
                a = sa.LocalSelfAttention
                h = _attend(a.q, a.k, a.v, sa.layer_norm(x), self.nheads, mask, self.window,
                            bias_fn=self._bias_fn, scale=False,  # T5 attention is unscaled
                            probs_drop=self.drop if train else 0.0,
                            generator=generator if train else None)
                x = x + dropout(a.o(h), self.drop, generator, not train)
                h = ff.DenseReluDense.wo(F.relu(ff.DenseReluDense.wi(ff.layer_norm(x))))
                return x + dropout(h, self.drop, generator, not train)

            x = _checkpoint(one_block, generator, x, mask) if remat else one_block(x, mask)
        return self.encoder.final_layer_norm(x)

    def _use_remat(self, device, B, L, generator):
        if self.remat is not None:
            return self.remat
        dropping = generator is not None and self.drop > 0.0
        return _auto_remat(device, B, L, self.d_model, self.d_ff, self.nheads,
                           [self.window] * len(self.encoder.block), share=self.remat_share,
                           attn_drop=self.drop if dropping else 0.0)

    @staticmethod
    def from_jax_params(p: dict, prefix: str) -> dict:
        sd = {}
        for j, lp in enumerate(p["layers"]):
            b = f"{prefix}.encoder.block.{j}"
            for key in ("q", "k", "v", "o"):
                linear_from_jax(sd, f"{b}.layer.0.LocalSelfAttention.{key}", lp["attn"][key])
            _norm_from_jax(sd, f"{b}.layer.0.layer_norm", lp["ln1"])
            linear_from_jax(sd, f"{b}.layer.1.DenseReluDense.wi", lp["wi"])
            linear_from_jax(sd, f"{b}.layer.1.DenseReluDense.wo", lp["wo"])
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
                "attn": {key: linear_to_jax(sd, f"{b}.layer.0.LocalSelfAttention.{key}")
                         for key in ("q", "k", "v", "o")},
                "ln1": _norm_to_jax(sd, f"{b}.layer.0.layer_norm"),
                "wi": linear_to_jax(sd, f"{b}.layer.1.DenseReluDense.wi"),
                "wo": linear_to_jax(sd, f"{b}.layer.1.DenseReluDense.wo"),
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
    """scores -> loss / decode, and the state-dict view the converters work on."""

    def loss(self, x: torch.Tensor, lengths: torch.Tensor, tags: torch.Tensor,
             generator: torch.Generator = None) -> torch.Tensor:
        """Scalar training loss; `generator` (on x's device) turns dropout on."""
        logits = self.scores(x, lengths, train=True, generator=generator)
        return head_loss(self.cfg, logits, lengths, tags)

    def decode(self, x: torch.Tensor, lengths: torch.Tensor, threshold: float):
        logits = self.scores(x, lengths)
        return logits, head_decode(self.cfg, logits, threshold)

    def to_jax_params(self) -> dict:
        """This tagger's weights as the JAX pytree (numpy leaves)."""
        return self._to_jax(self.state_dict())


class TransformerSegmenter(_Tagger):
    """Pyramidal local-attention encoder (or a dense one) + classification
    head; d_model = embedding_dim, FFN width = hidden_dim.

    Train-time dropout as the reference's HF configs have it: hidden dropout
    = dropout_in, attention-probs dropout = dropout_out on the restricted
    path; the dense path never sets its attention-probs rate and so trains at
    BertConfig's default 0.1 whatever the flags say."""

    def __init__(self, cfg: TaggerConfig, restricted: bool = True,
                 generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        windows = pyramidal_windows(cfg.attention_window, cfg.num_layers) if restricted else None
        self.model = _bag(model=BertStyleEncoder(
            cfg.embedding_dim, cfg.nheads, cfg.num_layers, cfg.hidden_dim, windows,
            drop=cfg.dropout_in, attn_drop=cfg.dropout_out if restricted else 0.1,
            generator=generator))
        self.classification = linear(cfg.embedding_dim, head_dim(cfg), generator)

    def scores(self, x, lengths, train=False, generator=None):
        return self.classification(self.model.model(x, lengths, train, generator))

    @staticmethod
    def from_jax_params(params: dict) -> dict:
        sd = BertStyleEncoder.from_jax_params(params["encoder"], "model.model")
        linear_from_jax(sd, "classification", params["cls"])
        return sd

    @staticmethod
    def _to_jax(sd: dict) -> dict:
        return {"encoder": BertStyleEncoder.to_jax_params(sd, "model.model"),
                "cls": linear_to_jax(sd, "classification")}


class TransformerCRF(_Tagger):
    """Dense BERT-style encoder (d_model = embedding_dim, FFN width =
    hidden_dim) -> linear-chain CRF. Hidden dropout at dropout_in, no
    attention-probs dropout; decode is the Viterbi path (scores: one
    best-path score per document). The reference's TransformerCRF cannot
    write a checkpoint, so the names are those of `TransformerSegmenter`'s
    encoder plus `crf.fc.*` and `crf.transitions`."""

    def __init__(self, cfg: TaggerConfig, generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        self.model = _bag(model=BertStyleEncoder(
            cfg.embedding_dim, cfg.nheads, cfg.num_layers, cfg.hidden_dim, None,
            drop=cfg.dropout_in, generator=generator))
        self.crf = crf_lib.CRF(cfg.embedding_dim, cfg.tagset_size, generator)

    def loss(self, x, lengths, tags, generator=None):
        mask = length_mask(lengths.to(x.device), x.shape[1], x.dtype)
        h = self.model.model(x, lengths, True, generator)
        return crf_lib.crf_loss(self.crf, h, tags.long().clamp_min(0), mask)

    def decode(self, x, lengths, threshold=None):
        mask = length_mask(lengths.to(x.device), x.shape[1], x.dtype)
        score, paths = crf_lib.viterbi_decode(self.crf, self.model.model(x, lengths), mask)
        return score, paths.bool()

    @staticmethod
    def from_jax_params(params: dict) -> dict:
        sd = BertStyleEncoder.from_jax_params(params["encoder"], "model.model")
        crf_lib.from_jax_params(sd, "crf", params["crf"])
        return sd

    @staticmethod
    def _to_jax(sd: dict) -> dict:
        return {"encoder": BertStyleEncoder.to_jax_params(sd, "model.model"),
                "crf": crf_lib.to_jax_params(sd, "crf")}


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
                transformer=_bag(model=LongT5Encoder(
                    d, cfg.nheads, 1, d, cfg.attention_window, drop=cfg.dropout_in,
                    remat_share=cfg.num_layers, generator=generator)),
            ))
            in_dim = d
        self.model = nn.ModuleList(blocks)
        self.classification = linear(d, head_dim(cfg), generator)

    def scores(self, x, lengths, train=False, generator=None):
        # each LSTM sits in the reference's RNN wrapper: dropout_in on its
        # input, dropout_out on its output (train only)
        h = x
        for block in self.model:
            h = dropout(h, self.cfg.dropout_in, generator, not train)
            h = dropout(block.lstm(h, lengths), self.cfg.dropout_out, generator, not train)
            h = block.transformer.model(h, lengths, train, generator)
        return self.classification(h)

    @staticmethod
    def from_jax_params(params: dict) -> dict:
        sd = {}
        for i, bp in enumerate(params["blocks"]):
            _lstm_from_jax(sd, f"model.{i}.lstm", bp["lstm"])
            sd.update(LongT5Encoder.from_jax_params(bp["t5"], f"model.{i}.transformer.model"))
        linear_from_jax(sd, "classification", params["cls"])
        return sd

    @staticmethod
    def _to_jax(sd: dict) -> dict:
        blocks = [
            {"lstm": _lstm_to_jax(sd, f"model.{i}.lstm"),
             "t5": LongT5Encoder.to_jax_params(sd, f"model.{i}.transformer.model")}
            for i in range(_count(sd, "model.{}.lstm.rnn.weight_ih_l0"))
        ]
        return {"blocks": blocks, "cls": linear_to_jax(sd, "classification")}


class RecurrentLongformer(_Tagger):
    """Stacked [BiLSTM -> bare local-MHA block], topped by a final BiLSTM.

    The block is attention only and returns the merged-head context: no
    output projection, residual or LayerNorm. With
    `separate_forward_backward`, queries AND values come from the forward
    LSTM half `h[..., :H]` and only the keys from the backward half. Scores
    are scaled by 1/sqrt(head_dim); an odd window is rounded up. The
    reference never sets the block's attention-probs dropout, so it trains at
    the HF config default of 0.1."""

    NOFFN_ATTN_DROP = 0.1

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

    def scores(self, x, lengths, train=False, generator=None):
        H, nh = self.cfg.hidden_dim, self.cfg.nheads
        mask = length_mask(lengths.to(x.device), x.shape[1], x.dtype)
        din, dout = self.cfg.dropout_in, self.cfg.dropout_out
        h = x
        for block in list(self.model)[: self.cfg.num_layers]:
            h = dropout(h, din, generator, not train)
            h = dropout(block.lstm(h, lengths), dout, generator, not train)
            if self.sep_fb:
                q_src, k_src = h[..., :H], h[..., H:]
                v_src = q_src
            else:
                q_src = k_src = v_src = h
            att = getattr(block.transformer.model.attention, "self")
            h = merge_heads(local_attention(
                split_heads(att.query(q_src), nh), split_heads(att.key(k_src), nh),
                split_heads(att.value(v_src), nh), self.window, mask,
                probs_drop=self.NOFFN_ATTN_DROP if train else 0.0,
                generator=generator if train else None))
        if self.last_bilstm:
            h = dropout(h, din, generator, not train)
            h = dropout(self.model[self.cfg.num_layers](h, lengths), dout, generator, not train)
        return self.classification(h)

    @staticmethod
    def from_jax_params(params: dict) -> dict:
        sd = {}
        n = len(params["blocks"])
        for i, bp in enumerate(params["blocks"]):
            _lstm_from_jax(sd, f"model.{i}.lstm", bp["lstm"])
            for name, key in (("query", "q"), ("key", "k"), ("value", "v")):
                linear_from_jax(sd, f"model.{i}.transformer.model.attention.self.{name}",
                                 bp["attn"][key])
        if "final_lstm" in params:
            _lstm_from_jax(sd, f"model.{n}", params["final_lstm"])
        linear_from_jax(sd, "classification", params["cls"])
        return sd

    @staticmethod
    def _to_jax(sd: dict) -> dict:
        n = _count(sd, "model.{}.lstm.rnn.weight_ih_l0")
        a = "model.{}.transformer.model.attention.self"
        params = {"blocks": [
            {"lstm": _lstm_to_jax(sd, f"model.{i}.lstm"),
             "attn": {"q": linear_to_jax(sd, a.format(i) + ".query"),
                      "k": linear_to_jax(sd, a.format(i) + ".key"),
                      "v": linear_to_jax(sd, a.format(i) + ".value")}}
            for i in range(n)
        ]}
        if f"model.{n}.rnn.weight_ih_l0" in sd:
            params["final_lstm"] = _lstm_to_jax(sd, f"model.{n}")
        params["cls"] = linear_to_jax(sd, "classification")
        return params
