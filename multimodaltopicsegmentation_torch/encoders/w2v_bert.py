"""w2v-BERT 2.0 (facebook/w2v-bert-2.0; Seamless, arXiv:2312.05187) as a torch
module with Hugging Face's `Wav2Vec2BertModel` parameter names.

`W2VBert(cfg)(audio [B, S], lengths [B]) -> [B, T, hidden]`, the contract of
encoders/wav2vec2.py, so `encoders/engine.Wav2Vec2Encoder` runs either:

  a Kaldi fbank of each row (dsp/kaldi_fbank.py: 80 log-mel bins normalised
  per row over its valid frames, frames stacked in pairs: T = F // 2 rows of
  160) -> LayerNorm(160) + linear 160 -> hidden
  -> 24 conformer layers (Gulati et al. 2020, arXiv:2005.08100), each
       h += 0.5 FFN1(LN(h))          swish FFNs ("macaron" halves)
       h += MHSA(LN(h))              scores (q k^T + q E[clamp(j - i, -64, 8)
                                     + 64]^T) / sqrt(Dh), E [73, Dh] learned
       h += Conv(h)                  LN, padded frames zeroed, pointwise
                                     D -> 2D, GLU, causal depthwise conv (k 31,
                                     left pad 30), LN, swish, pointwise D -> D
       h += 0.5 FFN2(LN(h)); h = LN(h)
  no positional convolution, no final encoder norm, no adapter.

A row's valid frames are `output_length(n)` of its `n` samples: padded frames
are zeroed at the encoder's input and at the conv module's input, as HF does,
and masked out of the attention as keys. Because the depthwise conv is causal
and the padding lies at a row's end, the valid frames never see the padded
ones; their values follow HF's all the same.

Every dense product goes through ops/linear_tf32x3's `FusedLinear` (on the
card the 3xTF32 tensor-core kernel, on the CPU `F.linear`): the projection,
then per layer FFN1's two, Q/K/V as one, out, both pointwise convolutions (as
linears without bias) and FFN2's two: 8 L + 1 launches a forward. The
relative-key term is q E^T [B, H, T, 73] gathered by clamped distance into
a [B, H, T, T] score bias for `ops.attention.dense_attention`.

Spans (utils/profiling.py, inside `encode_document.forward`): `.features`
(the fbank and the projection; fbank_frames), one `.rel_key` a layer (q E^T
and the gather; distances) and one `.conv_module` a layer (frames).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..dsp import kaldi_fbank
from ..ops.attention import dense_attention, merge_heads, split_heads
from ..ops.linear_tf32x3 import FusedLinear
from ..utils import profiling


@dataclasses.dataclass(frozen=True)
class W2VBertConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_dim: int = 4096
    feature_dim: int = 160  # feature_projection_input_dim: 80 mel bins x stride 2
    conv_kernel: int = 31  # conv_depthwise_kernel_size
    left_max_position: int = 64
    right_max_position: int = 8
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_hf(cls, hf: dict):
        """The config of an HF `config.json` of `model_type` "wav2vec2-bert"
        (keys it lacks take HF's defaults, which are w2v-BERT 2.0's)."""
        if hf.get("model_type") != "wav2vec2-bert":
            raise ValueError(f"model_type {hf.get('model_type')!r} is not 'wav2vec2-bert'")
        if hf.get("hidden_act", "swish") not in ("swish", "silu"):
            raise ValueError(f"hidden_act {hf['hidden_act']!r}: only 'swish' is implemented")
        if hf.get("position_embeddings_type", "relative_key") != "relative_key":
            raise ValueError(f"position_embeddings_type {hf['position_embeddings_type']!r}: "
                             "only 'relative_key' is implemented")
        if hf.get("add_adapter") or hf.get("use_intermediate_ffn_before_adapter"):
            raise ValueError("the adapter and the FFN before it are not implemented")
        dim = hf.get("feature_projection_input_dim", 160)
        if dim != kaldi_fbank.N_MELS * kaldi_fbank.STRIDE:
            raise ValueError(f"feature_projection_input_dim {dim}: the front end gives "
                             f"{kaldi_fbank.N_MELS} bins x stride {kaldi_fbank.STRIDE}")
        return cls(
            hidden_size=hf.get("hidden_size", 1024), num_layers=hf.get("num_hidden_layers", 24),
            num_heads=hf.get("num_attention_heads", 16), ffn_dim=hf.get("intermediate_size", 4096),
            feature_dim=dim, conv_kernel=hf.get("conv_depthwise_kernel_size", 31),
            left_max_position=hf.get("left_max_position_embeddings", 64),
            right_max_position=hf.get("right_max_position_embeddings", 8),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-5))

    @classmethod
    def tiny(cls):
        """For parity tests: the distance clamp bites within a few frames."""
        return cls(hidden_size=32, num_layers=2, num_heads=4, ffn_dim=64, conv_kernel=5,
                   left_max_position=6, right_max_position=2)


def output_length(n_samples):
    """Valid frames of `n_samples` samples (an int or an int tensor)."""
    return kaldi_fbank.num_rows(n_samples)


def relative_key_index(T: int, left: int, right: int, device=None) -> torch.Tensor:
    """[T, T] int64: clamp(j - i, -left, right) + left, the row of E that
    query i reads for key j."""
    pos = torch.arange(T, device=device)
    return (pos[None, :] - pos[:, None]).clamp(-left, right) + left


def causal_depthwise_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x [B, T, C], weight [C, 1, k] -> [B, T, C]: each channel convolved with
    its own kernel over frames t - k + 1 .. t (zeros before the first)."""
    y = F.conv1d(F.pad(x.transpose(1, 2), (weight.shape[-1] - 1, 0)), weight,
                 groups=weight.shape[0])
    return y.transpose(1, 2)


class _FeatureProjection(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.feature_dim, eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.feature_dim, cfg.hidden_size)
        self.fused = FusedLinear(self.projection)


class _FeedForward(nn.Module):
    def __init__(self, D, ffn):
        super().__init__()
        self.intermediate_dense = nn.Linear(D, ffn)
        self.output_dense = nn.Linear(ffn, D)
        self.intermediate = FusedLinear(self.intermediate_dense)
        self.output = FusedLinear(self.output_dense)

    def forward(self, x):
        return self.output(F.silu(self.intermediate(x)))


class _SelfAttention(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        D = cfg.hidden_size
        self.linear_q = nn.Linear(D, D)
        self.linear_k = nn.Linear(D, D)
        self.linear_v = nn.Linear(D, D)
        self.linear_out = nn.Linear(D, D)
        self.distance_embedding = nn.Embedding(
            cfg.left_max_position + cfg.right_max_position + 1, D // cfg.num_heads)
        self.qkv = FusedLinear(self.linear_q, self.linear_k, self.linear_v)
        self.out = FusedLinear(self.linear_out)

    def relative_key_bias(self, q: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        """q [B, H, T, Dh], index [T, T] -> the score bias [B, H, T, T]:
        q_i . E[index[i, j]] / sqrt(Dh), gathered from q E^T."""
        B, H, T, Dh = q.shape
        qe = torch.matmul(q, self.distance_embedding.weight.t())  # [B, H, T, distances]
        return torch.gather(qe, 3, index.expand(B, H, T, T)) / math.sqrt(Dh)


class _ConvModule(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        D = cfg.hidden_size
        self.layer_norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.pointwise_conv1 = nn.Linear(D, 2 * D, bias=False)
        self.depthwise_conv = nn.Conv1d(D, D, cfg.conv_kernel, groups=D, bias=False)
        self.depthwise_layer_norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.pointwise_conv2 = nn.Linear(D, D, bias=False)
        self.pointwise1 = FusedLinear(self.pointwise_conv1)
        self.pointwise2 = FusedLinear(self.pointwise_conv2)

    def forward(self, x, fmask):
        a, g = self.pointwise1(self.layer_norm(x) * fmask[..., None]).chunk(2, dim=-1)
        y = causal_depthwise_conv(a * torch.sigmoid(g), self.depthwise_conv.weight)
        return self.pointwise2(F.silu(self.depthwise_layer_norm(y)))


class _ConformerLayer(nn.Module):
    ffn_scale = 0.5  # each FFN's half step

    def __init__(self, cfg):
        super().__init__()
        D = cfg.hidden_size
        self.ffn1_layer_norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.ffn1 = _FeedForward(D, cfg.ffn_dim)
        self.self_attn_layer_norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.self_attn = _SelfAttention(cfg)
        self.conv_module = _ConvModule(cfg)
        self.ffn2_layer_norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.ffn2 = _FeedForward(D, cfg.ffn_dim)
        self.final_layer_norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.num_heads = cfg.num_heads

    def forward(self, x, fmask, index):
        """x [B, T, D], fmask [B, T] (1 = valid frame), index [T, T] the
        relative-key rows (`relative_key_index`)."""
        x = x + self.ffn_scale * self.ffn1(self.ffn1_layer_norm(x))
        att = self.self_attn
        q, k, v = (split_heads(t, self.num_heads) for t in att.qkv(self.self_attn_layer_norm(x)))
        with profiling.span("encode_document.forward.rel_key",
                            distances=att.distance_embedding.num_embeddings):
            bias = att.relative_key_bias(q, index)
        x = x + att.out(merge_heads(dense_attention(q, k, v, fmask, bias=bias)))
        with profiling.span("encode_document.forward.conv_module", frames=fmask.numel()):
            x = x + self.conv_module(x, fmask)
        x = x + self.ffn_scale * self.ffn2(self.ffn2_layer_norm(x))
        return self.final_layer_norm(x)


class _Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList(_ConformerLayer(cfg) for _ in range(cfg.num_layers))


class W2VBert(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)
        self._index = {}  # (T, device) -> [T, T] relative-key rows

    def relative_index(self, T: int, device) -> torch.Tensor:
        key = (T, str(device))
        if key not in self._index:
            self._index[key] = relative_key_index(T, self.cfg.left_max_position,
                                                  self.cfg.right_max_position, device)
        return self._index[key]

    def forward(self, audio: torch.Tensor, lengths=None):
        """audio: [B, S] raw 16 kHz, lengths [B] valid samples -> [B, T,
        hidden] frame embeddings (50 Hz: 49 frames a second)."""
        with profiling.span("encode_document.forward.features") as features:
            rows, valid, n_frames = kaldi_fbank.seamless_features(audio, lengths)
            features.add("fbank_frames", n_frames)
            fp = self.feature_projection
            x = fp.fused(fp.layer_norm(rows))
        T = x.shape[1]
        fmask = (torch.arange(T, device=x.device)[None, :] < valid[:, None]).to(x.dtype)
        x = x * fmask[..., None]
        index = self.relative_index(T, x.device)
        for layer in self.encoder.layers:
            x = layer(x, fmask, index)
        return x

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """Random weights drawn from `generator` (on the CPU): norms at ones
        and zeros, biases zero, each weight normal with std fan_in ** -0.5
        (the distance table std 1, so that q E^T / sqrt(Dh) moves the scores
        as much as q k^T / sqrt(Dh) does)."""
        for name, p in self.named_parameters():
            if "norm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            elif name.endswith("distance_embedding.weight"):
                p.copy_(torch.randn(p.shape, generator=generator))
            else:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=generator) * fan_in ** -0.5)
        return self


def random_state_dict(cfg: W2VBertConfig, seed: int = 0) -> dict:
    """Random weights made from `seed` by a CPU torch.Generator."""
    with torch.device("meta"):
        model = W2VBert(cfg)
    model = model.to_empty(device="cpu")
    return model.init_random_(torch.Generator().manual_seed(seed)).state_dict()


def build_model(cfg: W2VBertConfig, state_dict: dict, device) -> W2VBert:
    """An eval-mode W2VBert holding `state_dict`, on `device`."""
    with torch.device("meta"):
        model = W2VBert(cfg)
    model.load_state_dict(state_dict, assign=True)
    return model.to(device).eval()


def load_hf_state_dict(sd: dict, cfg: W2VBertConfig) -> dict:
    """HF `Wav2Vec2BertModel` state_dict -> this module's: the names are
    HF's; the pointwise convolutions' [out, in, 1] weights lose their last
    axis. A `wav2vec2_bert.` prefix (CTC and other head checkpoints) is
    dropped, as are keys the encoder does not use (`masked_spec_embed`,
    heads)."""
    sd = {k[len("wav2vec2_bert."):] if k.startswith("wav2vec2_bert.") else k: v
          for k, v in sd.items()}
    with torch.device("meta"):
        names = list(W2VBert(cfg).state_dict())
    out = {}
    for name in names:
        w = sd[name].float()
        if name.endswith(("pointwise_conv1.weight", "pointwise_conv2.weight")) and w.dim() == 3:
            w = w[..., 0]
        out[name] = w
    return out
