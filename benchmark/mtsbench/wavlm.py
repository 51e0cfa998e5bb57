"""WavLM's seeded weights and model FLOPs (the `wavlm_large_bilstm` cells).

Weights: a state dict under the Hugging Face `WavLMModel` names (the
positional convolution's weight norm folded), drawn on the device from
`--seed` in one normal draw as `weights.py` draws wav2vec2's, which the
program (`encoders.wav2vec2.build_model`) and the plain reference
(`reference/wavlm.py`) both take. The leaves:

- every convolution (and its bias, with `conv_bias`) followed by its own
  LayerNorm over the channels (`feat_extract_norm="layer"`);
- the feature projection, the positional convolution and the final
  LayerNorm, as in wav2vec2;
- each layer's projections, norms and FFN as in wav2vec2, and its gate,
  `gru_rel_pos_linear` (64 -> 8) and `gru_rel_pos_const` [1, H, 1, 1];
- layer 0's `rel_attn_embed` [num_buckets, H].

The bias table's entries are drawn with std 1 and the gates' constants
around 1 (std 0.5): the bias then moves the scores as much as q k^T / 8 does
(of std about 1 at these scales), and each gate, a (b c - 1) + 2 with a and b
spread over (0, 1) by the gate's projection, ranges over about 0.5 to 3.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from . import roofline
from .weights import Leaf, _dense, _draw, _norm


def leaves(cfg: dict) -> List[Leaf]:
    out: List[Leaf] = []
    c_in = 1
    for i, (c, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        base = f"feature_extractor.conv_layers.{i}"
        out.append((f"{base}.conv.weight", (c, c_in, k), (c_in * k) ** -0.5, 0.0))
        if cfg["conv_bias"]:
            out.append((f"{base}.conv.bias", (c,), 0.02, 0.0))
        out += _norm(f"{base}.layer_norm", c)
        c_in = c
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    H = cfg["num_attention_heads"]
    G, K = cfg["num_conv_pos_embedding_groups"], cfg["num_conv_pos_embeddings"]
    out += _norm("feature_projection.layer_norm", c_in)
    out += _dense("feature_projection.projection", D, c_in)
    out += [("encoder.pos_conv_embed.conv.weight", (D, D // G, K), (D // G * K) ** -0.5, 0.0),
            ("encoder.pos_conv_embed.conv.bias", (D,), 0.02, 0.0)]
    out += _norm("encoder.layer_norm", D)
    for i in range(cfg["num_hidden_layers"]):
        base = f"encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += _dense(f"{base}.attention.{proj}", D, D)
        out += _dense(f"{base}.attention.gru_rel_pos_linear", 8, D // H)
        out.append((f"{base}.attention.gru_rel_pos_const", (1, H, 1, 1), 0.5, 1.0))
        if i == 0:
            out.append((f"{base}.attention.rel_attn_embed.weight", (cfg["num_buckets"], H), 1.0,
                        0.0))
        out += _norm(f"{base}.layer_norm", D)
        out += _dense(f"{base}.feed_forward.intermediate_dense", F, D)
        out += _dense(f"{base}.feed_forward.output_dense", D, F)
        out += _norm(f"{base}.final_layer_norm", D)
    return out


def weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """WavLM's state dict (Hugging Face names) on `device`."""
    return _draw(leaves(cfg), seed, "wavlm", device)


def unit_flops(cfg: dict, samples: int) -> float:
    """Forward FLOPs of one unit of `samples` samples through WavLM: wav2vec2's
    count at these widths (`roofline.wav2vec2_unit_flops`: the convolutions,
    the feature projection, the positional convolution, each layer's
    projections, FFN and attention) and each layer's gate: its projection of
    every head's slice (2 x Dh x 8 a head and frame) and its product with the
    bias and their sum into the scores (2 a head and (query, key) pair)."""
    t = samples
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        t = (t - k) // s + 1
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    gate = 2 * (D // H) * 8 * H * t + 2 * H * t * t
    return roofline.wav2vec2_unit_flops(cfg, samples) + cfg["num_hidden_layers"] * float(gate)
