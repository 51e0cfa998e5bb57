"""wav2vec2 and WavLM audio encoders as one torch module with HF parameter
names.

Counterpart of the JAX package's encoders/wav2vec2.py, with the same
forward contract: `Wav2Vec2(cfg)(audio [B, S], lengths [B]) -> [B, T, hidden]`.

Architecture (wav2vec2-base, the defaults):
  7-layer strided conv feature extractor (group norm on layer 0, GELU)
  -> LayerNorm + linear feature projection (512 -> 768)
  -> grouped positional conv (k=128, groups=16) + GELU, add
  -> post-LN transformer encoder (12 layers, 12 heads, FFN 3072)

The HF options the larger checkpoints set (`Wav2Vec2Config.wavlm_large()`,
microsoft/wavlm-large; Chen et al. 2021, arXiv:2110.13900):
  feat_extract_norm="layer"   every conv is followed by a LayerNorm over its
                              channels, per frame, then GELU (conv_bias: the
                              convs' own bias)
  do_stable_layer_norm=True   pre-LN layers, x += Attn(LN1(x)); x +=
                              FFN(LN2(x)), no norm after the positional conv
                              and one after the last layer
  num_buckets > 0             WavLM's gated relative position bias: layer 0
                              holds `rel_attn_embed` [buckets, H]; P[h, i, j]
                              = rel_attn_embed[bucket(j - i), h] (T5's
                              bidirectional buckets) is built once a forward
                              and shared by every layer; each layer gates it
                              per (row, head, query) from the head's slice u
                              of its attention input: (a, b) = sigmoid(sum of
                              view(W_g u + b_g, [2, 4]) over 4), gate = a (b c_h
                              - 1) + 2, scores = q k^T / sqrt(Dh) + gate P

With `lengths`, every statistic respects each row's valid samples, so a
padded batch equals one-row-at-a-time runs (HF's own batched group norm does
not). Layer 0's group norm + GELU is kernel K1 (ops/instance_norm_gelu) when
the norm is per channel, as in wav2vec2-base; other geometries (`tiny()` has
4 groups over 16 channels) take the plain masked group norm on every device.
The layer norms of "layer" are per frame and need no mask.

Every dense linear of the forward (the feature projection, Q/K/V as one
[3D, D] product, out_proj, intermediate_dense with its GELU, output_dense:
4 L + 1 a forward) goes through ops/linear_tf32x3's `FusedLinear`: on the
card the 3xTF32 tensor-core kernel, on the CPU `F.linear` as before.

On the card the conv stack runs channels-last (`Wav2Vec2._features`): conv
layer 0 is ops/conv_tf32x3's `first_conv` under "layer" norms, or cuDNN's
conv then K1 (or the group norm) and one `channels_last` pass under "group";
conv layers 1.. are the 3xTF32 implicit GEMM `conv_tf32x3` (bias and
wav2vec2's GELU in its epilogue; L - 1 launches a forward), over frame
counts padded down the chain (`padded_frames`); WavLM's per-frame LayerNorms
and GELUs then act on contiguous rows, one `layer_norm_gelu` launch a conv.
The CPU keeps the [B, C, T] stack of `F.conv1d`. The positional conv, the
scores and WavLM's gate linear stay torch's.

The positional conv holds its weight-norm already folded, under
`encoder.pos_conv_embed.conv.weight`; `load_hf_state_dict` folds HF's
`weight_g`/`weight_v` (or `parametrizations`) pair. `from_jax_params` carries
the JAX parameter pytree (numpy leaves) over.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv_tf32x3 as CV
from ..ops.attention import dense_attention, merge_heads, split_heads, t5_relative_bucket
from ..ops.instance_norm_gelu import instance_norm_gelu
from ..ops.linear_tf32x3 import FusedLinear
from ..utils import profiling


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    conv_dim: Sequence[int] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    num_groupnorm_groups: int = 512
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    layer_norm_eps: float = 1e-5
    do_normalize: bool = True  # processor zero-mean/unit-var per utterance
    feat_extract_norm: str = "group"  # "group" (layer 0 only) or "layer" (every conv)
    do_stable_layer_norm: bool = False  # pre-LN layers and a final norm
    conv_bias: bool = False
    num_buckets: int = 0  # WavLM's relative position buckets; 0: no relative bias
    max_bucket_distance: int = 800

    def __post_init__(self):
        if self.feat_extract_norm not in ("group", "layer"):
            raise ValueError(f"feat_extract_norm must be 'group' or 'layer', "
                             f"not {self.feat_extract_norm!r}")

    @classmethod
    def base(cls):
        return cls()

    @classmethod
    def wavlm_large(cls):
        """microsoft/wavlm-large's config.json."""
        return cls(hidden_size=1024, num_layers=24, num_heads=16, ffn_dim=4096,
                   feat_extract_norm="layer", do_stable_layer_norm=True, num_buckets=320)

    @classmethod
    def from_hf(cls, hf: dict):
        """The config of an HF `config.json` of `model_type` "wav2vec2" or
        "wavlm" (keys it lacks take HF's defaults)."""
        kind = hf.get("model_type")
        if kind not in ("wav2vec2", "wavlm"):
            raise ValueError(f"model_type {kind!r} is neither 'wav2vec2' nor 'wavlm'")
        for key in ("hidden_act", "feat_extract_activation"):
            if hf.get(key, "gelu") != "gelu":
                raise ValueError(f"{key} {hf[key]!r}: only 'gelu' is implemented")
        conv_dim = tuple(hf.get("conv_dim", cls.conv_dim))
        return cls(
            conv_dim=conv_dim, conv_kernel=tuple(hf.get("conv_kernel", cls.conv_kernel)),
            conv_stride=tuple(hf.get("conv_stride", cls.conv_stride)),
            num_groupnorm_groups=conv_dim[0], hidden_size=hf.get("hidden_size", 768),
            num_layers=hf.get("num_hidden_layers", 12), num_heads=hf.get("num_attention_heads", 12),
            ffn_dim=hf.get("intermediate_size", 3072),
            pos_conv_kernel=hf.get("num_conv_pos_embeddings", 128),
            pos_conv_groups=hf.get("num_conv_pos_embedding_groups", 16),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
            feat_extract_norm=hf.get("feat_extract_norm", "group"),
            do_stable_layer_norm=hf.get("do_stable_layer_norm", False),
            conv_bias=hf.get("conv_bias", False),
            num_buckets=hf.get("num_buckets", 320) if kind == "wavlm" else 0,
            max_bucket_distance=hf.get("max_bucket_distance", 800))

    @classmethod
    def tiny(cls):
        """For parity tests."""
        return cls(
            conv_dim=(16, 16),
            conv_kernel=(10, 3),
            conv_stride=(5, 2),
            num_groupnorm_groups=4,
            hidden_size=24,
            num_layers=2,
            num_heads=2,
            ffn_dim=48,
            pos_conv_kernel=16,
            pos_conv_groups=2,
        )


def feature_extractor_output_length(cfg: Wav2Vec2Config, n_samples):
    """Frames the conv stack makes of `n_samples` (an int or an int tensor)."""
    n = n_samples
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        n = (n - k) // s + 1
    return n.clamp_min(0) if torch.is_tensor(n) else max(n, 0)


def padded_frames(cfg: Wav2Vec2Config, n_samples: int):
    """Frame counts [P_0, .., P_{L-1}] of the card's channels-last conv stack
    over `n_samples` samples: each at least the layer's frames and
    P_{i-1} = stride_i P_i, so that layer i's input reads as [B P_i,
    stride_i C] (ops/conv_tf32x3). 16000 samples: 3200, 1600, .., 50 for
    3199, 1599, .., 49 frames."""
    frames, n = [], n_samples
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        n = (n - k) // s + 1
        frames.append(n)
    if frames[-1] <= 0:
        raise ValueError(f"{n_samples} samples make no frame of the conv stack")
    last, scale = 1, 1  # scale: the product of the strides after layer i
    for i in range(len(frames) - 1, -1, -1):
        last = max(last, -(-frames[i] // scale))
        scale *= cfg.conv_stride[i]
    out, p = [], last
    for i in range(len(frames) - 1, -1, -1):
        out.append(p)
        p *= cfg.conv_stride[i]
    return out[::-1]


def group_norm(x, scale, bias, groups, lengths=None, eps=1e-5):
    """x: [B, C, T]; torch GroupNorm with statistics over each row's first
    `lengths[b]` frames only (counterpart of JAX `_group_norm(frame_mask=)`)."""
    B, C, T = x.shape
    xg = x.reshape(B, groups, C // groups, T)
    if lengths is None:
        mu = xg.mean(dim=(2, 3), keepdim=True)
        var = xg.var(dim=(2, 3), correction=0, keepdim=True)
    else:
        m = (torch.arange(T, device=x.device)[None, :] < lengths[:, None]).to(x.dtype)
        m = m[:, None, None, :]
        cnt = (m.sum(dim=3, keepdim=True) * (C // groups)).clamp_min(1.0)
        mu = (xg * m).sum(dim=(2, 3), keepdim=True) / cnt
        var = (m * (xg - mu) ** 2).sum(dim=(2, 3), keepdim=True) / cnt
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(B, C, T) * scale[:, None] + bias[:, None]


class _ConvLayer(nn.Module):
    def __init__(self, c_in, c_out, kernel, norm, bias, fused):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel, bias=bias)
        if fused:  # the card's implicit GEMM: conv layers 1..
            self.fused = CV.FusedConv(self.conv)
        if norm is not None:
            self.layer_norm = norm


class _FeatureExtractor(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c_in = 1
        layers = []
        for i, (c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
            if cfg.feat_extract_norm == "layer":
                norm = nn.LayerNorm(c)
            else:
                norm = nn.GroupNorm(cfg.num_groupnorm_groups, c) if i == 0 else None
            layers.append(_ConvLayer(c_in, c, k, norm, cfg.conv_bias, fused=i > 0))
            c_in = c
        self.conv_layers = nn.ModuleList(layers)


class _FeatureProjection(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)
        self.fused = FusedLinear(self.projection)


class _PosConv(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        D = cfg.hidden_size
        self.conv = nn.Conv1d(D, D, cfg.pos_conv_kernel, padding=cfg.pos_conv_kernel // 2,
                              groups=cfg.pos_conv_groups)


class _Attention(nn.Module):
    def __init__(self, cfg, first: bool):
        super().__init__()
        D, H = cfg.hidden_size, cfg.num_heads
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)
        self.qkv = FusedLinear(self.q_proj, self.k_proj, self.v_proj)
        self.out = FusedLinear(self.out_proj)
        if cfg.num_buckets:
            self.gru_rel_pos_const = nn.Parameter(torch.ones(1, H, 1, 1))
            self.gru_rel_pos_linear = nn.Linear(D // H, 8)
            if first:
                self.rel_attn_embed = nn.Embedding(cfg.num_buckets, H)

    def gated_bias(self, u, P):
        """u [B, T, D] (the attention's input), P [H, T, T] -> the gated bias
        [B, H, T, T] of WavLM: gate[b, h, i] * P[h, i, j]."""
        B, T, _ = u.shape
        H = P.shape[0]
        g = self.gru_rel_pos_linear(split_heads(u, H)).reshape(B, H, T, 2, 4).sum(-1)
        a, b = torch.sigmoid(g).chunk(2, dim=-1)
        return (a * (b * self.gru_rel_pos_const - 1.0) + 2.0) * P


class _FeedForward(nn.Module):
    def __init__(self, D, ffn):
        super().__init__()
        self.intermediate_dense = nn.Linear(D, ffn)
        self.output_dense = nn.Linear(ffn, D)
        self.intermediate = FusedLinear(self.intermediate_dense)
        self.output = FusedLinear(self.output_dense)

    def forward(self, x):
        return self.output(self.intermediate(x, gelu=True))


class _EncoderLayer(nn.Module):
    def __init__(self, cfg, first: bool):
        super().__init__()
        D = cfg.hidden_size
        self.attention = _Attention(cfg, first)
        self.layer_norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.feed_forward = _FeedForward(D, cfg.ffn_dim)
        self.final_layer_norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.num_heads = cfg.num_heads
        self.pre_ln = cfg.do_stable_layer_norm

    def forward(self, x, fmask, P=None):
        """x [B, T, D]; P: the relative position bias [H, T, T] or None."""
        att, ff = self.attention, self.feed_forward
        u = self.layer_norm(x) if self.pre_ln else x
        bias = None
        if P is not None:
            with profiling.span("encode_document.forward.gate", heads=self.num_heads):
                bias = att.gated_bias(u, P)
        q, k, v = (split_heads(t, self.num_heads) for t in att.qkv(u))
        a = att.out(merge_heads(dense_attention(q, k, v, fmask, bias=bias)))
        if self.pre_ln:
            x = x + a
            return x + ff(self.final_layer_norm(x))
        x = self.layer_norm(x + a)
        return self.final_layer_norm(x + ff(x))


class _Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.pos_conv_embed = _PosConv(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(_EncoderLayer(cfg, i == 0) for i in range(cfg.num_layers))


class Wav2Vec2(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = _FeatureExtractor(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)
        self._buckets = {}  # (T, device) -> [T, T] bucket indices of the relative bias

    def relative_bias(self, T: int, device):
        """P [H, T, T] = rel_attn_embed[bucket(j - i)], heads first."""
        key = (T, str(device))
        if key not in self._buckets:
            pos = torch.arange(T)
            self._buckets[key] = t5_relative_bucket(
                pos[None, :] - pos[:, None], self.cfg.num_buckets,
                self.cfg.max_bucket_distance).to(device)
        table = self.encoder.layers[0].attention.rel_attn_embed.weight
        return table[self._buckets[key]].permute(2, 0, 1)

    def forward(self, audio: torch.Tensor, lengths: Optional[torch.Tensor] = None):
        """audio: [B, S] raw 16 kHz -> [B, T, hidden] frame embeddings (~50 Hz)."""
        cfg = self.cfg
        B, S = audio.shape
        if lengths is not None:
            lengths = lengths.to(device=audio.device, dtype=torch.int32)
        if cfg.do_normalize:
            if lengths is None:
                mu = audio.mean(-1, keepdim=True)
                var = audio.var(-1, correction=0, keepdim=True)
            else:
                m = (torch.arange(S, device=audio.device)[None, :]
                     < lengths[:, None]).to(audio.dtype)
                cnt = m.sum(-1, keepdim=True).clamp_min(1.0)
                mu = (audio * m).sum(-1, keepdim=True) / cnt
                var = (m * (audio - mu) ** 2).sum(-1, keepdim=True) / cnt
                audio = audio * m
            audio = (audio - mu) * torch.rsqrt(var + 1e-7)
            if lengths is not None:
                audio = audio * m

        with profiling.span("encode_document.forward.features"):
            x = self._features(audio, lengths)

        T = x.shape[1]
        if lengths is not None:
            t_valid = feature_extractor_output_length(cfg, lengths)
            fmask = (torch.arange(T, device=x.device)[None, :] < t_valid[:, None]).to(x.dtype)
        else:
            fmask = torch.ones((B, T), dtype=x.dtype, device=x.device)

        # padded frames are zero before the positional conv, whose +-k/2
        # receptive field must see what a solo run of the row sees
        x = x * fmask[..., None]
        pos = self.encoder.pos_conv_embed.conv(x.transpose(1, 2))
        if cfg.pos_conv_kernel % 2 == 0:
            pos = pos[..., :-1]
        x = x + F.gelu(pos.transpose(1, 2))
        if not cfg.do_stable_layer_norm:
            x = self.encoder.layer_norm(x) * fmask[..., None]
        P = None
        if cfg.num_buckets:
            with profiling.span("encode_document.forward.rel_bias") as rel:
                P = self.relative_bias(T, x.device)
                rel.add("bias_bytes", P.numel() * P.element_size())
        for layer in self.encoder.layers:
            x = layer(x, fmask, P)
        if cfg.do_stable_layer_norm:
            x = self.encoder.layer_norm(x)
        return x

    def _features(self, audio, lengths):
        """audio [B, S] (normalised) -> the projected features [B, T, hidden]:
        the conv stack, its norms and GELUs, and the feature projection. The
        card takes the channels-last stack, the CPU the [B, C, T] one."""
        if audio.device.type == "cpu":
            return self._features_plain(audio, lengths)
        return self._features_channels_last(audio, lengths)

    def _features_channels_last(self, audio, lengths):
        """The conv stack on [B, P_i, C] activations (`padded_frames`): no
        transposes after conv layer 0's output, each conv of layers 1.. one
        launch of the implicit GEMM. Padded frames hold finite values that no
        valid frame reads; the last layer's are dropped before the
        projection."""
        cfg = self.cfg
        layers = self.feature_extractor.conv_layers
        frames = padded_frames(cfg, audio.shape[1])
        first, s0 = layers[0], cfg.conv_stride[0]
        layer_norm = cfg.feat_extract_norm == "layer"
        if layer_norm:
            ln = first.layer_norm
            x = CV.layer_norm_gelu(
                CV.first_conv(audio, first.conv.weight, first.conv.bias, s0, frames[0]),
                ln.weight, ln.bias, ln.eps)
        else:
            x = F.conv1d(audio[:, None, :], first.conv.weight, first.conv.bias, stride=s0)
            x = CV.channels_last(self._group_norm_gelu(x, lengths), frames[0])
        for i in range(1, len(layers)):
            layer = layers[i]
            x = layer.fused(x, cfg.conv_stride[i], gelu=not layer_norm)
            if layer_norm:
                ln = layer.layer_norm
                x = CV.layer_norm_gelu(x, ln.weight, ln.bias, ln.eps)
        x = x[:, :feature_extractor_output_length(cfg, audio.shape[1])]
        return self.feature_projection.fused(self.feature_projection.layer_norm(x))

    def _group_norm_gelu(self, x, lengths):
        """Conv layer 0's group norm and GELU under "group" norms on x [B, C,
        T], with statistics over each row's valid frames: K1 when the groups
        are the channels."""
        cfg = self.cfg
        cur_len = None
        if lengths is not None:
            cur_len = ((lengths - cfg.conv_kernel[0]) // cfg.conv_stride[0] + 1).clamp_min(0)
        gn = self.feature_extractor.conv_layers[0].layer_norm
        if cfg.num_groupnorm_groups == x.shape[1]:
            return instance_norm_gelu(x, gn.weight, gn.bias, cur_len)
        return F.gelu(group_norm(x, gn.weight, gn.bias, cfg.num_groupnorm_groups, cur_len))

    def _features_plain(self, audio, lengths):
        cfg = self.cfg
        x = audio[:, None, :]  # [B, 1, S]
        for i, layer in enumerate(self.feature_extractor.conv_layers):
            x = F.conv1d(x, layer.conv.weight, layer.conv.bias, stride=cfg.conv_stride[i])
            if cfg.feat_extract_norm == "layer":  # over the channels of each frame
                ln = layer.layer_norm
                x = F.gelu(F.layer_norm(x.transpose(1, 2), ln.normalized_shape, ln.weight,
                                        ln.bias, ln.eps)).transpose(1, 2)
            elif i == 0:
                x = self._group_norm_gelu(x, lengths)
            else:
                x = F.gelu(x)
        x = x.transpose(1, 2)  # [B, T, C]
        return self.feature_projection.fused(self.feature_projection.layer_norm(x))

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """Random weights with the JAX `init_params` distributions, drawn
        from `generator` (on the CPU, so a seed gives the same weights for
        every device the module later moves to)."""
        for name, p in self.named_parameters():
            if "norm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("gru_rel_pos_const"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                std = 0.02 if name.startswith("encoder.pos_conv_embed") else 0.05
                p.copy_(torch.randn(p.shape, generator=generator) * std)
        return self


def random_state_dict(cfg: Wav2Vec2Config, seed: int = 0) -> dict:
    """Random weights made from `seed` by a CPU torch.Generator."""
    with torch.device("meta"):
        model = Wav2Vec2(cfg)
    model = model.to_empty(device="cpu")
    return model.init_random_(torch.Generator().manual_seed(seed)).state_dict()


def build_model(cfg: Wav2Vec2Config, state_dict: dict, device) -> Wav2Vec2:
    """An eval-mode Wav2Vec2 holding `state_dict`, on `device`."""
    with torch.device("meta"):
        model = Wav2Vec2(cfg)
    model.load_state_dict(state_dict, assign=True)
    return model.to(device).eval()


def from_jax_params(params: dict, cfg: Wav2Vec2Config) -> dict:
    """JAX wav2vec2 param pytree (numpy leaves) -> this module's state_dict.
    The encoder layers may be stacked ([L, ...] leaves) or a per-layer list."""
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    sd = {}
    for i, layer in enumerate(params["feature_extractor"]):
        base = f"feature_extractor.conv_layers.{i}"
        sd[f"{base}.conv.weight"] = t(np.transpose(layer["w"], (2, 1, 0)))
        if "gn" in layer:
            sd[f"{base}.layer_norm.weight"] = t(layer["gn"]["scale"])
            sd[f"{base}.layer_norm.bias"] = t(layer["gn"]["bias"])
    sd["feature_projection.layer_norm.weight"] = t(params["fp_ln"]["scale"])
    sd["feature_projection.layer_norm.bias"] = t(params["fp_ln"]["bias"])
    sd["feature_projection.projection.weight"] = t(np.transpose(params["fp_w"]))
    sd["feature_projection.projection.bias"] = t(params["fp_b"])
    sd["encoder.pos_conv_embed.conv.weight"] = t(np.transpose(params["pos_conv_w"], (2, 1, 0)))
    sd["encoder.pos_conv_embed.conv.bias"] = t(params["pos_conv_b"])
    sd["encoder.layer_norm.weight"] = t(params["enc_ln"]["scale"])
    sd["encoder.layer_norm.bias"] = t(params["enc_ln"]["bias"])

    layers = params["encoder_layers"]
    if not isinstance(layers, (list, tuple)):  # stacked [L, ...] storage
        layers = [_index_tree(layers, i) for i in range(cfg.num_layers)]
    names = {
        "q": "attention.q_proj", "k": "attention.k_proj", "v": "attention.v_proj",
        "o": "attention.out_proj", "ff1": "feed_forward.intermediate_dense",
        "ff2": "feed_forward.output_dense",
    }
    for i, lp in enumerate(layers):
        base = f"encoder.layers.{i}"
        for key, name in names.items():
            sd[f"{base}.{name}.weight"] = t(np.transpose(lp[key]["w"]))
            sd[f"{base}.{name}.bias"] = t(lp[key]["b"])
        for key, name in (("ln1", "layer_norm"), ("ln2", "final_layer_norm")):
            sd[f"{base}.{name}.weight"] = t(lp[key]["scale"])
            sd[f"{base}.{name}.bias"] = t(lp[key]["bias"])
    return sd


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def load_hf_state_dict(sd: dict, cfg: Wav2Vec2Config) -> dict:
    """HF Wav2Vec2Model or WavLMModel state_dict -> this module's state_dict:
    the names are HF's (WavLM's `rel_attn_embed`, `gru_rel_pos_*` and the
    per-conv `layer_norm` included); the positional conv's weight norm
    (dim=2) is folded. A `wav2vec2.` or `wavlm.` prefix (CTC and other head
    checkpoints) is dropped, as are keys the encoder does not use (e.g.
    `masked_spec_embed`, `lm_head.*`)."""
    sd = {k.split(".", 1)[1] if k.startswith(("wav2vec2.", "wavlm.")) else k: v
          for k, v in sd.items()}
    pos = "encoder.pos_conv_embed.conv"
    if f"{pos}.weight_g" in sd:
        wg, wv = sd[f"{pos}.weight_g"], sd[f"{pos}.weight_v"]
    else:
        wg = sd[f"{pos}.parametrizations.weight.original0"]
        wv = sd[f"{pos}.parametrizations.weight.original1"]
    wg, wv = wg.float(), wv.float()
    norm = torch.sqrt(torch.sum(wv ** 2, dim=(0, 1), keepdim=True))
    out = {f"{pos}.weight": wg * wv / norm.clamp_min(1e-12)}
    with torch.device("meta"):
        names = list(Wav2Vec2(cfg).state_dict())
    for name in names:
        if name not in out:
            out[name] = sd[name].float()
    return out


def load_pretrained(path: str):
    """A local HF checkpoint -> (state_dict, config). `path` is its directory
    (pytorch_model.bin or model.safetensors) or the weights file itself. The
    config is the `config.json` beside the weights: a wav2vec2 or WavLM model
    here, a w2v-BERT 2.0 one (`model_type` "wav2vec2-bert") in
    encoders/w2v_bert.py; wav2vec2-base's when there is none."""
    folder = path if os.path.isdir(path) else os.path.dirname(path)
    if os.path.isdir(path):
        path = os.path.join(folder, "pytorch_model.bin")
        if not os.path.exists(path) and os.path.exists(os.path.join(folder, "model.safetensors")):
            path = os.path.join(folder, "model.safetensors")
    if not os.path.exists(path):
        raise RuntimeError(
            f"wav2vec2 weights {path!r} not found: point MTS_WAV2VEC2_WEIGHTS at a "
            "local HF checkpoint directory holding pytorch_model.bin or model.safetensors"
        )
    cfg, convert = Wav2Vec2Config.base(), load_hf_state_dict
    if os.path.exists(os.path.join(folder, "config.json")):
        with open(os.path.join(folder, "config.json")) as f:
            hf = json.load(f)
        if hf.get("model_type") == "wav2vec2-bert":
            from . import w2v_bert

            cfg, convert = w2v_bert.W2VBertConfig.from_hf(hf), w2v_bert.load_hf_state_dict
        else:
            cfg = Wav2Vec2Config.from_hf(hf)
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert(sd, cfg), cfg
