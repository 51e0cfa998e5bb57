"""Plain PyTorch WavLM, for the tests: a function of a state dict under the
Hugging Face names (`WavLMModel`'s, positional conv weight-norm folded under
`encoder.pos_conv_embed.conv.weight`) and of a config dict under HF's keys.
Float32, with TF32 products off while it runs. Written from Chen et al.,
"WavLM" (arXiv:2110.13900) and the HF `WavLMModel` equations; it imports
neither JAX nor the port.

    frames(sd, cfg, audio [B, S], lengths [B] or None) -> [B, T, hidden]

Covers `feat_extract_norm` "group" (layer 0) and "layer" (every conv), the
convs' bias, post-LN and pre-LN (`do_stable_layer_norm`) layers and the gated
relative position bias (`num_buckets` > 0).

Departures from HF, each deliberate:
- Padded keys get an additive -1e9 (HF: -inf through `key_padding_mask`), so
  a zero-length row gets uniform attention weights where HF gives NaN.
- `do_normalize` (the feature extractor's zero-mean, unit-variance per
  utterance) is applied here, over each row's first `lengths[b]` samples,
  padded samples zero; HF's model takes audio already normalised.
- The group norm of "group" takes its statistics over each row's valid
  frames (HF's batched group norm sees the padding too).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

NEG_INF = -1e9


@contextlib.contextmanager
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5's bidirectional buckets of offsets j - i, HF WavLM's arithmetic:
    half the buckets a sign, exact below a quarter, log-spaced up to
    `max_distance`."""
    half = num_buckets // 2
    out = (rel > 0).long() * half
    n = rel.abs()
    exact = half // 2
    large = (exact + torch.log(n.float().clamp_min(1) / exact) / math.log(max_distance / exact)
             * (half - exact)).long().clamp_max(half - 1)
    return out + torch.where(n < exact, n, large)


def _ln(x, sd, name, eps):
    return F.layer_norm(x, (x.shape[-1],), sd[f"{name}.weight"], sd[f"{name}.bias"], eps)


def _linear(x, sd, name):
    return x @ sd[f"{name}.weight"].T + sd[f"{name}.bias"]


def _out_len(cfg, n):
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        n = torch.clamp_min((n - k) // s + 1, 0)
    return n


@torch.no_grad()
def frames(sd: dict, cfg: dict, audio: torch.Tensor, lengths=None) -> torch.Tensor:
    with no_tf32():
        return _frames(sd, cfg, audio.float(), lengths)


def _frames(sd, cfg, x, lengths):
    B, S = x.shape
    dev = x.device
    n = torch.full((B,), S, device=dev) if lengths is None else torch.as_tensor(lengths, device=dev)
    smask = (torch.arange(S, device=dev)[None] < n[:, None]).float()
    if cfg.get("do_normalize", False):
        cnt = smask.sum(-1, keepdim=True).clamp_min(1)
        mu = (x * smask).sum(-1, keepdim=True) / cnt
        var = (smask * (x - mu) ** 2).sum(-1, keepdim=True) / cnt
        x = (x * smask - mu) / torch.sqrt(var + 1e-7) * smask
    x = x[:, None, :]
    length = n
    for i, (k, s) in enumerate(zip(cfg["conv_kernel"], cfg["conv_stride"])):
        base = f"feature_extractor.conv_layers.{i}"
        x = F.conv1d(x, sd[f"{base}.conv.weight"], sd.get(f"{base}.conv.bias"), stride=s)
        length = torch.clamp_min((length - k) // s + 1, 0)
        if cfg["feat_extract_norm"] == "layer":
            x = _ln(x.transpose(1, 2), sd, f"{base}.layer_norm", 1e-5).transpose(1, 2)
        elif i == 0:  # one group per channel, statistics over the valid frames
            T = x.shape[-1]
            m = (torch.arange(T, device=dev)[None] < length[:, None]).float()[:, None, :]
            cnt = m.sum(-1, keepdim=True).clamp_min(1)
            mu = (x * m).sum(-1, keepdim=True) / cnt
            var = (m * (x - mu) ** 2).sum(-1, keepdim=True) / cnt
            x = (x - mu) / torch.sqrt(var + 1e-5)
            x = x * sd[f"{base}.layer_norm.weight"][:, None] + sd[f"{base}.layer_norm.bias"][:, None]
        x = F.gelu(x)
    eps = cfg["layer_norm_eps"]
    x = _linear(_ln(x.transpose(1, 2), sd, "feature_projection.layer_norm", eps), sd,
                "feature_projection.projection")
    T = x.shape[1]
    fmask = (torch.arange(T, device=dev)[None] < _out_len(cfg, n)[:, None]).float()
    x = x * fmask[..., None]
    K = cfg["num_conv_pos_embeddings"]
    pos = F.conv1d(x.transpose(1, 2), sd["encoder.pos_conv_embed.conv.weight"],
                   sd["encoder.pos_conv_embed.conv.bias"], padding=K // 2,
                   groups=cfg["num_conv_pos_embedding_groups"])
    if K % 2 == 0:
        pos = pos[..., :-1]
    x = x + F.gelu(pos.transpose(1, 2))
    pre_ln = cfg["do_stable_layer_norm"]
    if not pre_ln:
        x = _ln(x, sd, "encoder.layer_norm", eps)
    H = cfg["num_attention_heads"]
    D = x.shape[-1]
    Dh = D // H
    P = None
    if cfg.get("num_buckets", 0):
        t = torch.arange(T)
        idx = bucket(t[None, :] - t[:, None], cfg["num_buckets"], cfg["max_bucket_distance"])
        P = sd["encoder.layers.0.attention.rel_attn_embed.weight"][idx.to(dev)].permute(2, 0, 1)
    key_mask = (1.0 - fmask)[:, None, None, :] * NEG_INF
    for i in range(cfg["num_hidden_layers"]):
        L = f"encoder.layers.{i}"
        u = _ln(x, sd, f"{L}.layer_norm", eps) if pre_ln else x
        heads = lambda y: y.view(B, T, H, Dh).transpose(1, 2)  # noqa: E731
        q, k, v = (heads(_linear(u, sd, f"{L}.attention.{p}")) for p in ("q_proj", "k_proj", "v_proj"))
        scores = q @ k.transpose(-1, -2) / math.sqrt(Dh)
        if P is not None:
            g = _linear(heads(u), sd, f"{L}.attention.gru_rel_pos_linear").view(B, H, T, 2, 4).sum(-1)
            a, b = torch.sigmoid(g)[..., 0:1], torch.sigmoid(g)[..., 1:2]
            c = sd[f"{L}.attention.gru_rel_pos_const"].view(1, H, 1, 1)
            scores = scores + (a * (b * c - 1.0) + 2.0) * P[None]
        w = torch.softmax(scores + key_mask, dim=-1)
        att = _linear((w @ v).transpose(1, 2).reshape(B, T, D), sd, f"{L}.attention.out_proj")
        if pre_ln:
            x = x + att
            h = _ln(x, sd, f"{L}.final_layer_norm", eps)
            x = x + _linear(F.gelu(_linear(h, sd, f"{L}.feed_forward.intermediate_dense")), sd,
                            f"{L}.feed_forward.output_dense")
        else:
            x = _ln(x + att, sd, f"{L}.layer_norm", eps)
            h = _linear(F.gelu(_linear(x, sd, f"{L}.feed_forward.intermediate_dense")), sd,
                        f"{L}.feed_forward.output_dense")
            x = _ln(x + h, sd, f"{L}.final_layer_norm", eps)
    if pre_ln:
        x = _ln(x, sd, "encoder.layer_norm", eps)
    return x
