"""The long-document Transformer tagger: a learned positional table, a
post-LN encoder whose layers attend within a sliding window (windows
attention_window * k for k = layers .. 1, made even), GELU in its tanh form,
and a linear head; one document at a time at its own length. JAX layout:
encoder = {pos, ln_emb, layers[i] = {attn: {q, k, v, o}, ln1, ff1, ff2,
ln2}}, cls; linears {w [in, out], b}, norms {scale, bias}."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..models import dense_leaves, layer_norm, linear_init


def pyramid(window: int, layers: int):
    """The per-layer windows: window * k for k = layers .. 1, made even."""
    ws = [window * k for k in range(layers, 0, -1)]
    return [w + (w % 2) for w in ws]


def windows(tc: dict):
    return pyramid(tc["attention_window"], tc["num_layers"])


def leaves(tc: dict):
    D, F_ = tc["embedding_dim"], tc["hidden_dim"]
    out = [("encoder/pos", (tc["max_position"], D), 0.1, 0.0),
           ("encoder/ln_emb/scale", (D,), 0.1, 1.0), ("encoder/ln_emb/bias", (D,), 0.1, 0.0)]
    for i in range(tc["num_layers"]):
        base = f"encoder/layers/{i}"
        for key in ("q", "k", "v", "o"):
            out += dense_leaves(f"{base}/attn/{key}", D, D)
        out += [(f"{base}/ln1/scale", (D,), 0.1, 1.0), (f"{base}/ln1/bias", (D,), 0.1, 0.0)]
        out += dense_leaves(f"{base}/ff1", D, F_) + dense_leaves(f"{base}/ff2", F_, D)
        out += [(f"{base}/ln2/scale", (D,), 0.1, 1.0), (f"{base}/ln2/bias", (D,), 0.1, 0.0)]
    return out + dense_leaves("cls", D, 1)


def initial_params(tc: dict, seed: int) -> dict:
    """The reference trainer's init from one CPU generator, in the order the
    modules are built: the positional table N(0, 0.02^2), linears
    U(+-1/sqrt(fan_in)) (q, k, v, o, then ff1, ff2 of each layer), norms at
    scale 1, bias 0."""
    g = torch.Generator().manual_seed(seed)
    D, H = tc["embedding_dim"], tc["hidden_dim"]
    norm = lambda: {"scale": torch.ones(D), "bias": torch.zeros(D)}  # noqa: E731
    pos = torch.empty(tc["max_position"], D).normal_(generator=g) * 0.02
    blocks = []
    for _ in range(tc["num_layers"]):
        attn = {k: linear_init(g, D, D) for k in ("q", "k", "v", "o")}
        ln1 = norm()
        ff1 = linear_init(g, D, H)
        ff2 = linear_init(g, H, D)
        blocks.append({"attn": attn, "ln1": ln1, "ff1": ff1, "ff2": ff2, "ln2": norm()})
    return {"encoder": {"pos": pos, "ln_emb": norm(), "layers": blocks},
            "cls": linear_init(g, D, 1)}


def banded_attention(q, k, v, half: int, block: int = 512):
    """q, k, v [H, L, Dh] of one document -> softmax(q k^T / sqrt(Dh)) v over the
    keys j with |i - j| <= half, in blocks of queries."""
    H, L, Dh = q.shape
    outs = []
    for s in range(0, L, block):
        e = min(s + block, L)
        k0, k1 = max(0, s - half), min(L, e + half)
        scores = q[:, s:e] @ k[:, k0:k1].transpose(-1, -2) / math.sqrt(Dh)
        i = torch.arange(s, e, device=q.device)[:, None]
        j = torch.arange(k0, k1, device=q.device)[None, :]
        scores = scores.masked_fill((i - j).abs() > half, float("-inf"))
        outs.append(torch.softmax(scores, dim=-1) @ v[:, k0:k1])
    return torch.cat(outs, dim=1)


def document_logits(params: dict, x: torch.Tensor, tc: dict) -> torch.Tensor:
    """ONE document x [L, D] (no padding) -> logits [L]."""
    enc, heads, eps = params["encoder"], tc["nheads"], tc["layer_norm_eps"]
    L, D = x.shape
    lin = lambda t, p: t @ p["w"] + p["b"]  # noqa: E731
    h = layer_norm(x + enc["pos"][:L], enc["ln_emb"]["scale"], enc["ln_emb"]["bias"], eps)
    for p, w in zip(enc["layers"], windows(tc)):
        q, k, v = (lin(h, p["attn"][n]).view(L, heads, D // heads).transpose(0, 1)
                   for n in ("q", "k", "v"))
        a = banded_attention(q, k, v, w // 2).transpose(0, 1).reshape(L, D)
        h = layer_norm(h + lin(a, p["attn"]["o"]), p["ln1"]["scale"], p["ln1"]["bias"], eps)
        f = lin(F.gelu(lin(h, p["ff1"]), approximate="tanh"), p["ff2"])
        h = layer_norm(h + f, p["ln2"]["scale"], p["ln2"]["bias"], eps)
    return lin(h, params["cls"])[:, 0]


def logits(params: dict, x: torch.Tensor, lengths, tc: dict) -> torch.Tensor:
    """x [B, L, d] -> logits [B, Lmax]: each row alone at its own length,
    zero past it."""
    lengths = [int(n) for n in lengths]
    Lmax = max(lengths)
    rows = [F.pad(document_logits(params, x[b, :n], tc), (0, Lmax - n)) if n else x.new_zeros(Lmax)
            for b, n in enumerate(lengths)]
    return torch.stack(rows)
