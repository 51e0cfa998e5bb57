"""Plain PyTorch pieces of the benchmarked models, written from their
published descriptions and nothing of the program: wav2vec2-base's encoder
(Baevski et al. 2020; the Hugging Face `Wav2Vec2Model` with
`feat_extract_norm="group"`), mean pooling of a unit's frames, the segments
of a document's boundary tags, and what the taggers (`taggers/<name>.py`)
share. Float32 unless the caller says otherwise; TF32 is the caller's
choice (`precision`).

Weights come in the layouts `mtsbench.weights` makes: Hugging Face names
for wav2vec2, the JAX-layout pytree for the taggers.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 products exactly (tf32=False) or on TF32 tensor cores."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


# -- wav2vec2 ---------------------------------------------------------------------

def wav2vec2_frames(sd: dict, cfg: dict, audio: torch.Tensor) -> torch.Tensor:
    """audio [B, S] (each row one whole unit) -> frame embeddings [B, T, D]."""
    eps = cfg["layer_norm_eps"]
    x = audio
    if cfg["do_normalize"]:  # the feature extractor's zero-mean, unit-variance per utterance
        x = (x - x.mean(-1, keepdim=True)) / torch.sqrt(x.var(-1, correction=0, keepdim=True) + 1e-7)
    x = x[:, None, :]
    for i, s in enumerate(cfg["conv_stride"]):
        base = f"feature_extractor.conv_layers.{i}"
        x = F.conv1d(x, sd[f"{base}.conv.weight"], stride=s)
        if i == 0:  # GroupNorm with one group per channel: each channel over time
            mu = x.mean(-1, keepdim=True)
            var = x.var(-1, correction=0, keepdim=True)
            x = (x - mu) / torch.sqrt(var + 1e-5)
            x = x * sd[f"{base}.layer_norm.weight"][:, None] + sd[f"{base}.layer_norm.bias"][:, None]
        x = F.gelu(x)
    x = x.transpose(1, 2)
    x = layer_norm(x, sd["feature_projection.layer_norm.weight"], sd["feature_projection.layer_norm.bias"],
            eps)
    x = x @ sd["feature_projection.projection.weight"].T + sd["feature_projection.projection.bias"]
    K = cfg["num_conv_pos_embeddings"]
    pos = F.conv1d(x.transpose(1, 2), sd["encoder.pos_conv_embed.conv.weight"],
                   sd["encoder.pos_conv_embed.conv.bias"], padding=K // 2,
                   groups=cfg["num_conv_pos_embedding_groups"])
    if K % 2 == 0:
        pos = pos[..., :-1]
    x = x + F.gelu(pos.transpose(1, 2))
    x = layer_norm(x, sd["encoder.layer_norm.weight"], sd["encoder.layer_norm.bias"], eps)
    H = cfg["num_attention_heads"]
    B, T, D = x.shape
    for i in range(cfg["num_hidden_layers"]):
        p = lambda n: sd[f"encoder.layers.{i}.{n}"]  # noqa: E731
        heads = [(x @ p(f"attention.{n}.weight").T + p(f"attention.{n}.bias"))
                 .view(B, T, H, D // H).transpose(1, 2) for n in ("q_proj", "k_proj", "v_proj")]
        q, k, v = heads
        w = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(D // H), dim=-1)
        a = (w @ v).transpose(1, 2).reshape(B, T, D)
        a = a @ p("attention.out_proj.weight").T + p("attention.out_proj.bias")
        x = layer_norm(x + a, p("layer_norm.weight"), p("layer_norm.bias"), eps)
        h = F.gelu(x @ p("feed_forward.intermediate_dense.weight").T
                   + p("feed_forward.intermediate_dense.bias"))
        h = h @ p("feed_forward.output_dense.weight").T + p("feed_forward.output_dense.bias")
        x = layer_norm(x + h, p("final_layer_norm.weight"), p("final_layer_norm.bias"), eps)
    return x


@torch.no_grad()
def pooled_units(sd: dict, cfg: dict, units: torch.Tensor, block: int = 64) -> torch.Tensor:
    """units [N, S] -> the mean of each unit's frames [N, D], in blocks of rows."""
    return torch.cat([wav2vec2_frames(sd, cfg, units[i:i + block]).mean(dim=1)
                      for i in range(0, units.shape[0], block)])


# -- what the taggers share ---------------------------------------------------------

def dense_leaves(prefix: str, n_in: int, n_out: int):
    """A JAX-layout linear's drawn leaves: w [in, out], b."""
    return [(f"{prefix}/w", (n_in, n_out), n_in ** -0.5, 0.0), (f"{prefix}/b", (n_out,), 0.02, 0.0)]


def linear_init(g: torch.Generator, n_in: int, n_out: int) -> dict:
    """A linear's reference init, U(+-1/sqrt(fan_in)) for weight then bias,
    in the JAX layout."""
    bound = 1.0 / math.sqrt(n_in)
    w = torch.empty(n_out, n_in).uniform_(-bound, bound, generator=g)
    b = torch.empty(n_out).uniform_(-bound, bound, generator=g)
    return {"w": w.T.contiguous(), "b": b}


def reverse_in_length(x: torch.Tensor, lengths) -> torch.Tensor:
    """x [B, L, ...]: each row's first lengths[b] steps reversed, the rest kept."""
    B, L = x.shape[:2]
    t = torch.arange(L, device=x.device)[None, :]
    n = torch.as_tensor(lengths, device=x.device)[:, None]
    idx = torch.where(t < n, n - 1 - t, t)
    return torch.gather(x, 1, idx.view(B, L, *([1] * (x.dim() - 2))).expand_as(x))


# -- decode and segments ------------------------------------------------------------

def segments(tags, n_samples: int, sr: int = 16000, interval: int = 1):
    """Boundary tags of 1-s units -> [(start, end)] sample spans: a span ends
    after each unit tagged 1, and the last span ends with the audio."""
    spans, prev = [], 0
    stride = sr * interval
    for u, tag in enumerate(tags):
        end = (u + 1) * stride
        if end > n_samples:
            break
        if tag:
            spans.append((prev, end))
            prev = end
    spans.append((prev, n_samples))
    return spans
