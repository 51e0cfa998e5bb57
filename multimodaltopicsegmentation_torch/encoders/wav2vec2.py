"""wav2vec2 audio encoder as a torch module with HF parameter names.

Counterpart of the JAX package's encoders/wav2vec2.py, with the same
forward contract: `Wav2Vec2(cfg)(audio [B, S], lengths [B]) -> [B, T, hidden]`.

Architecture (wav2vec2-base, do_stable_layer_norm=False):
  7-layer strided conv feature extractor (group norm on layer 0, GELU)
  -> LayerNorm + linear feature projection (512 -> 768)
  -> grouped positional conv (k=128, groups=16) + GELU, add
  -> post-LN transformer encoder (12 layers, 12 heads, FFN 3072)

With `lengths`, every statistic respects each row's valid samples, so a
padded batch equals one-row-at-a-time runs (HF's own batched group norm does
not). Layer 0's norm + GELU is kernel K1 (ops/instance_norm_gelu) when the
norm is per channel, as in wav2vec2-base; other geometries (`tiny()` has 4
groups over 16 channels) take the plain masked group norm on every device.

The positional conv holds its weight-norm already folded, under
`encoder.pos_conv_embed.conv.weight`; `load_hf_state_dict` folds HF's
`weight_g`/`weight_v` (or `parametrizations`) pair. `from_jax_params` carries
the JAX parameter pytree (numpy leaves) over.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dense_attention, merge_heads, split_heads
from ..ops.instance_norm_gelu import instance_norm_gelu


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

    @classmethod
    def base(cls):
        return cls()

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
    def __init__(self, c_in, c_out, kernel, norm_groups=None):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel, bias=False)
        if norm_groups is not None:
            self.layer_norm = nn.GroupNorm(norm_groups, c_out)


class _FeatureExtractor(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c_in = 1
        layers = []
        for i, (c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
            layers.append(_ConvLayer(c_in, c, k, cfg.num_groupnorm_groups if i == 0 else None))
            c_in = c
        self.conv_layers = nn.ModuleList(layers)


class _FeatureProjection(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)


class _PosConv(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        D = cfg.hidden_size
        self.conv = nn.Conv1d(D, D, cfg.pos_conv_kernel, padding=cfg.pos_conv_kernel // 2,
                              groups=cfg.pos_conv_groups)


class _Attention(nn.Module):
    def __init__(self, D):
        super().__init__()
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)


class _FeedForward(nn.Module):
    def __init__(self, D, ffn):
        super().__init__()
        self.intermediate_dense = nn.Linear(D, ffn)
        self.output_dense = nn.Linear(ffn, D)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        D = cfg.hidden_size
        self.attention = _Attention(D)
        self.layer_norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.feed_forward = _FeedForward(D, cfg.ffn_dim)
        self.final_layer_norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.num_heads = cfg.num_heads

    def forward(self, x, fmask):
        att = self.attention
        q = split_heads(att.q_proj(x), self.num_heads)
        k = split_heads(att.k_proj(x), self.num_heads)
        v = split_heads(att.v_proj(x), self.num_heads)
        a = att.out_proj(merge_heads(dense_attention(q, k, v, fmask)))
        x = self.layer_norm(x + a)
        h = self.feed_forward.output_dense(F.gelu(self.feed_forward.intermediate_dense(x)))
        return self.final_layer_norm(x + h)


class _Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.pos_conv_embed = _PosConv(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(_EncoderLayer(cfg) for _ in range(cfg.num_layers))


class Wav2Vec2(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = _FeatureExtractor(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)

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

        x = audio[:, None, :]  # [B, 1, S]
        cur_len = lengths
        for i, layer in enumerate(self.feature_extractor.conv_layers):
            x = F.conv1d(x, layer.conv.weight, stride=cfg.conv_stride[i])
            if cur_len is not None:
                cur_len = ((cur_len - cfg.conv_kernel[i]) // cfg.conv_stride[i] + 1).clamp_min(0)
            if i == 0:
                gn = layer.layer_norm
                if cfg.num_groupnorm_groups == x.shape[1]:
                    x = instance_norm_gelu(x, gn.weight, gn.bias, cur_len)
                    continue
                x = group_norm(x, gn.weight, gn.bias, cfg.num_groupnorm_groups, cur_len)
            x = F.gelu(x)

        x = x.transpose(1, 2)  # [B, T, C]
        x = self.feature_projection.projection(self.feature_projection.layer_norm(x))

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
        x = self.encoder.layer_norm(x) * fmask[..., None]
        for layer in self.encoder.layers:
            x = layer(x, fmask)
        return x

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """Random weights with the JAX `init_params` distributions, drawn
        from `generator` (on the CPU, so a seed gives the same weights for
        every device the module later moves to)."""
        for name, p in self.named_parameters():
            if "norm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
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
    """HF Wav2Vec2Model state_dict -> this module's state_dict: the names are
    HF's; the positional conv's weight norm (dim=2) is folded. A
    `wav2vec2.` prefix (CTC checkpoints) is dropped, as are keys the encoder
    does not use (e.g. `masked_spec_embed`, `lm_head.*`)."""
    sd = {(k[len("wav2vec2."):] if k.startswith("wav2vec2.") else k): v for k, v in sd.items()}
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
    """A local HF checkpoint (directory with pytorch_model.bin, or the file
    itself) -> (state_dict, Wav2Vec2Config.base())."""
    cfg = Wav2Vec2Config.base()
    if os.path.isdir(path):
        path = os.path.join(path, "pytorch_model.bin")
    if not os.path.exists(path):
        raise RuntimeError(
            f"wav2vec2 weights {path!r} not found: point MTS_WAV2VEC2_WEIGHTS at a "
            "local HF checkpoint directory holding pytorch_model.bin"
        )
    return load_hf_state_dict(torch.load(path, map_location="cpu", weights_only=True), cfg), cfg
