"""Plain PyTorch WavLM (Chen et al. 2021, arXiv:2110.13900; the Hugging Face
`WavLMModel` with `feat_extract_norm="layer"` and `do_stable_layer_norm=True`,
as microsoft/wavlm-large sets them), written from its equations and nothing
of the program, over whole units. Weights in the Hugging Face names
(`mtsbench/wavlm.py` draws them); float32 unless the caller's `precision`
says otherwise.

- Each convolution is followed by a LayerNorm over its channels, per frame,
  and GELU.
- Pre-LN layers: x += Attn(LN1(x)); x += W2 GELU(W1 LN2(x)); no norm after
  the positional convolution, one after the last layer.
- Gated relative position bias: P[h, i, j] = rel_attn_embed[bucket(j - i), h]
  (T5's bidirectional buckets), built once and shared by every layer; each
  layer's gate per (row, head, query) from the head's slice u of LN1(x):
  (a, b) = sigmoid(sum over 4 of view(W_g u + b_g, [2, 4])), gate = a (b c - 1)
  + 2; scores = q k^T / sqrt(Dh) + gate P.

Departures from Hugging Face: `do_normalize` normalises each unit here (HF's
feature extractor does it before the model); every row is a whole unit, so
no key is masked (HF's -inf key mask never applies).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .models import layer_norm


def bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5's bidirectional bucket of each offset j - i: half the buckets a sign,
    exact below a quarter of them, log-spaced up to `max_distance`."""
    half = num_buckets // 2
    out = (rel > 0).long() * half
    n = rel.abs()
    exact = half // 2
    large = (exact + torch.log(n.float().clamp_min(1) / exact) / math.log(max_distance / exact)
             * (half - exact)).long().clamp_max(half - 1)
    return out + torch.where(n < exact, n, large)


def _linear(x, sd, name):
    return x @ sd[f"{name}.weight"].T + sd[f"{name}.bias"]


def _ln(x, sd, name, eps):
    return layer_norm(x, sd[f"{name}.weight"], sd[f"{name}.bias"], eps)


def frames(sd: dict, cfg: dict, audio: torch.Tensor) -> torch.Tensor:
    """audio [B, S] (each row one whole unit) -> frame embeddings [B, T, D]."""
    if cfg["feat_extract_norm"] != "layer" or not cfg["do_stable_layer_norm"]:
        raise ValueError("this reference is WavLM with a layer-norm conv stack and pre-LN layers")
    eps = cfg["layer_norm_eps"]
    x = audio
    if cfg["do_normalize"]:  # zero mean, unit variance per unit
        x = (x - x.mean(-1, keepdim=True)) / torch.sqrt(x.var(-1, correction=0, keepdim=True) + 1e-7)
    x = x[:, None, :]
    for i, s in enumerate(cfg["conv_stride"]):
        base = f"feature_extractor.conv_layers.{i}"
        x = F.conv1d(x, sd[f"{base}.conv.weight"], sd.get(f"{base}.conv.bias"), stride=s)
        x = F.gelu(_ln(x.transpose(1, 2), sd, f"{base}.layer_norm", 1e-5)).transpose(1, 2)
    x = _linear(_ln(x.transpose(1, 2), sd, "feature_projection.layer_norm", eps), sd,
                "feature_projection.projection")
    K = cfg["num_conv_pos_embeddings"]
    pos = F.conv1d(x.transpose(1, 2), sd["encoder.pos_conv_embed.conv.weight"],
                   sd["encoder.pos_conv_embed.conv.bias"], padding=K // 2,
                   groups=cfg["num_conv_pos_embedding_groups"])
    if K % 2 == 0:
        pos = pos[..., :-1]
    x = x + F.gelu(pos.transpose(1, 2))
    B, T, D = x.shape
    H = cfg["num_attention_heads"]
    Dh = D // H
    t = torch.arange(T)
    idx = bucket(t[None, :] - t[:, None], cfg["num_buckets"], cfg["max_bucket_distance"])
    P = sd["encoder.layers.0.attention.rel_attn_embed.weight"][idx.to(x.device)].permute(2, 0, 1)
    heads = lambda y: y.view(B, T, H, Dh).transpose(1, 2)  # noqa: E731
    for i in range(cfg["num_hidden_layers"]):
        L = f"encoder.layers.{i}"
        u = _ln(x, sd, f"{L}.layer_norm", eps)
        q, k, v = (heads(_linear(u, sd, f"{L}.attention.{p}")) for p in ("q_proj", "k_proj", "v_proj"))
        g = torch.sigmoid(_linear(heads(u), sd, f"{L}.attention.gru_rel_pos_linear")
                          .view(B, H, T, 2, 4).sum(-1))
        c = sd[f"{L}.attention.gru_rel_pos_const"].view(1, H, 1, 1)
        gate = g[..., 0:1] * (g[..., 1:2] * c - 1.0) + 2.0
        w = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(Dh) + gate * P[None], dim=-1)
        x = x + _linear((w @ v).transpose(1, 2).reshape(B, T, D), sd, f"{L}.attention.out_proj")
        h = F.gelu(_linear(_ln(x, sd, f"{L}.final_layer_norm", eps), sd,
                           f"{L}.feed_forward.intermediate_dense"))
        x = x + _linear(h, sd, f"{L}.feed_forward.output_dense")
    return _ln(x, sd, "encoder.layer_norm", eps)


@torch.no_grad()
def pooled_units(sd: dict, cfg: dict, units: torch.Tensor, block: int = 64) -> torch.Tensor:
    """units [N, S] -> the mean of each unit's frames [N, D], in blocks of rows."""
    return torch.cat([frames(sd, cfg, units[i:i + block]).mean(dim=1)
                      for i in range(0, units.shape[0], block)])
