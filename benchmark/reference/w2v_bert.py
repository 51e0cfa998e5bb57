"""Plain PyTorch w2v-BERT 2.0 (facebook/w2v-bert-2.0; Seamless, arXiv:2312.05187):
Hugging Face's `SeamlessM4TFeatureExtractor` and `Wav2Vec2BertModel` as
`transformers` writes them (models/seamless_m4t/feature_extraction_*.py,
models/wav2vec2_bert/modeling_wav2vec2_bert.py, `position_embeddings_type`
"relative_key", no adapter), from their equations and nothing of the
program. Weights in the Hugging Face names and shapes (`mtsbench/w2v_bert.py`
draws them). Float32 with both TF32 flags off unless the caller asks for TF32
products (`tf32=True`, the check's control).

Front end, each utterance alone: the waveform times 2**15; frames of 400
samples every 160, no centring; per frame the mean removed, preemphasis 0.97,
the povey window (Hann, symmetric, to the power 0.85), |FFT_512|^2; 80
triangular filters in Kaldi's mel space (1127 ln(1 + f / 700)), 20 to 8000
Hz; log with floor 1.1920929e-7; each bin normalised over the utterance's
frames with var(ddof=1) + 1e-7 under the square root. A batch pads the
frames with zeros to the longest, then to an even count; pairs of frames
become rows of 160, and a row is valid when its second frame is.

Model: LayerNorm(160) and a linear to D; padded rows zeroed; per layer
  h += 0.5 FFN1(LN(h)); h += MHSA(LN(h)); h += Conv(h); h += 0.5 FFN2(LN(h));
  h = LN(h)
with swish FFNs, scores q k^T / sqrt(Dh) + einsum("bhld,lrd->bhlr", q,
E[clamp(r - l, -left, right) + left]) / sqrt(Dh) and HF's additive key mask
(the dtype's lowest value), and Conv = LN, padded rows zeroed, pointwise
conv D -> 2D, GLU over channels, a depthwise conv of kernel k after k - 1
zeros on the left, LN, swish, pointwise conv D -> D.

Departures from Hugging Face: steps before the normalisation run in float32
in torch (HF: float64 in numpy, the FFT rounded to complex64), so the
features differ from HF's by some 1e-5; an utterance of one frame reads 0
after the normalisation (HF: NaN); dropout and the masked-time embedding
(training only) are left out.
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from .models import layer_norm, precision


def _mel(f):
    return 1127.0 * math.log(1.0 + f / 700.0)


def mel_filters(device=None) -> torch.Tensor:
    """[257, 80]: filter m rises from edge m to edge m + 1 and falls to edge
    m + 2, linear in Kaldi's mel, the 82 edges even in mel from 20 to 8000
    Hz, each FFT bin placed at its own mel."""
    lo, hi = _mel(20.0), _mel(8000.0)
    edges = [lo + (hi - lo) * i / 81 for i in range(82)]
    bins = torch.tensor([_mel(k * 16000 / 512) for k in range(257)], dtype=torch.float64)
    cols = []
    for m in range(80):
        left, centre, right = edges[m], edges[m + 1], edges[m + 2]
        rise = (bins - left) / (centre - left)
        fall = (right - bins) / (right - centre)
        cols.append(torch.clamp(torch.minimum(rise, fall), min=0.0))
    return torch.stack(cols, dim=1).float().to(device)


def fbank(wave: torch.Tensor) -> torch.Tensor:
    """One utterance [n] (n >= 400) -> normalised log-mel frames [F, 80]."""
    n = torch.arange(400, device=wave.device, dtype=torch.float64)
    window = (0.5 - 0.5 * torch.cos(2 * math.pi * n / 399)).pow(0.85).float()
    frames = wave.unfold(0, 400, 160) * 32768.0  # [F, 400], frame i from sample 160 i
    count = frames.shape[0]
    frames = frames - frames.mean(dim=1, keepdim=True)
    emphasised = frames.clone()
    emphasised[:, 1:] = frames[:, 1:] - 0.97 * frames[:, :-1]
    emphasised[:, 0] = frames[:, 0] * (1 - 0.97)
    spectrum = torch.fft.rfft(emphasised * window, n=512)
    power = spectrum.real ** 2 + spectrum.imag ** 2
    x = torch.log(torch.clamp(power @ mel_filters(wave.device), min=1.1920928955078125e-07))
    var = x.var(dim=0, correction=1, keepdim=True) if count > 1 else torch.zeros_like(x[:1])
    return (x - x.mean(dim=0, keepdim=True)) / torch.sqrt(var + 1e-7)


def features(waves: List[torch.Tensor]):
    """Utterances -> (rows [B, T, 160], mask [B, T] of 0/1), as
    `SeamlessM4TFeatureExtractor.__call__` pads and stacks them."""
    feats = [fbank(w) for w in waves]
    longest = max(f.shape[0] for f in feats)
    longest += longest % 2
    B = len(feats)
    out = feats[0].new_zeros(B, longest, 80)
    valid = feats[0].new_zeros(B, longest)
    for b, f in enumerate(feats):
        out[b, :f.shape[0]] = f
        valid[b, :f.shape[0]] = 1.0
    return out.reshape(B, longest // 2, 160), valid[:, 1::2]


def _linear(x, sd, name):
    return x @ sd[f"{name}.weight"].T + sd[f"{name}.bias"]


def _ln(x, sd, name, eps):
    return layer_norm(x, sd[f"{name}.weight"], sd[f"{name}.bias"], eps)


def _ffn(x, sd, name):
    return _linear(F.silu(_linear(x, sd, f"{name}.intermediate_dense")), sd, f"{name}.output_dense")


def _conv_module(x, sd, name, cfg, mask):
    eps = cfg["layer_norm_eps"]
    y = _ln(x, sd, f"{name}.layer_norm", eps)
    y = y.masked_fill(~mask.bool()[..., None], 0.0).transpose(1, 2)
    y = F.glu(F.conv1d(y, sd[f"{name}.pointwise_conv1.weight"]), dim=1)
    w = sd[f"{name}.depthwise_conv.weight"]
    y = F.conv1d(F.pad(y, (w.shape[-1] - 1, 0)), w, groups=w.shape[0])
    y = _ln(y.transpose(1, 2), sd, f"{name}.depthwise_layer_norm", eps).transpose(1, 2)
    return F.conv1d(F.silu(y), sd[f"{name}.pointwise_conv2.weight"]).transpose(1, 2)


def encoder(sd: dict, cfg: dict, rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """rows [B, T, 160], mask [B, T] -> the last hidden state [B, T, D]."""
    eps = cfg["layer_norm_eps"]
    x = _linear(_ln(rows, sd, "feature_projection.layer_norm", eps), sd,
                "feature_projection.projection")
    x = x.masked_fill(~mask.bool()[..., None], 0.0)
    B, T, D = x.shape
    H = cfg["num_attention_heads"]
    Dh = D // H
    left, right = cfg["left_max_position_embeddings"], cfg["right_max_position_embeddings"]
    pos = torch.arange(T, device=x.device)
    distance = torch.clamp(pos[None, :] - pos[:, None], -left, right) + left
    key_mask = (1.0 - mask[:, None, None, :]) * torch.finfo(x.dtype).min
    heads = lambda y: y.view(B, T, H, Dh).transpose(1, 2)  # noqa: E731
    for i in range(cfg["num_hidden_layers"]):
        L = f"encoder.layers.{i}"
        x = _ffn(_ln(x, sd, f"{L}.ffn1_layer_norm", eps), sd, f"{L}.ffn1") * 0.5 + x
        u = _ln(x, sd, f"{L}.self_attn_layer_norm", eps)
        q, k, v = (heads(_linear(u, sd, f"{L}.self_attn.linear_{p}")) for p in "qkv")
        table = sd[f"{L}.self_attn.distance_embedding.weight"][distance]  # [T, T, Dh]
        scores = (q @ k.transpose(-1, -2) / math.sqrt(Dh)
                  + torch.einsum("bhld,lrd->bhlr", q, table) / math.sqrt(Dh) + key_mask)
        a = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(B, T, D)
        x = _linear(a, sd, f"{L}.self_attn.linear_out") + x
        x = x + _conv_module(x, sd, f"{L}.conv_module", cfg, mask)
        x = _ffn(_ln(x, sd, f"{L}.ffn2_layer_norm", eps), sd, f"{L}.ffn2") * 0.5 + x
        x = _ln(x, sd, f"{L}.final_layer_norm", eps)
    return x


@torch.no_grad()
def frames(sd: dict, cfg: dict, waves: List[torch.Tensor], tf32: bool = False):
    """Utterances -> (frame embeddings [B, T, D], mask [B, T])."""
    with precision(tf32):
        rows, mask = features(waves)
        return encoder(sd, cfg, rows, mask), mask


@torch.no_grad()
def pooled_units(sd: dict, cfg: dict, units: torch.Tensor, block: int = 64,
                 tf32: bool = False) -> torch.Tensor:
    """units [N, S] (each row one whole unit) -> the mean of each unit's valid
    frames [N, D], in blocks of rows."""
    out = []
    for i in range(0, units.shape[0], block):
        h, mask = frames(sd, cfg, list(units[i:i + block]), tf32)
        out.append((h * mask[..., None]).sum(1) / mask.sum(1, keepdim=True))
    return torch.cat(out)
