"""w2v-BERT 2.0's seeded weights and model FLOPs (the `w2vbert2_bilstm` cells).

Weights: a state dict under the Hugging Face `Wav2Vec2BertModel` names and
shapes (the pointwise convolutions [out, in, 1]), drawn on the device from
`--seed` in one normal draw as `weights.py` draws wav2vec2's; the program
reads it through its own checkpoint loader
(`encoders.w2v_bert.load_hf_state_dict`), the plain reference
(`reference/w2v_bert.py`) as it is. The leaves:

- the feature projection's LayerNorm(160) and linear 160 -> D;
- per layer: four LayerNorms (FFN1, attention, FFN2, final), two FFNs of
  width F, Q/K/V and out, the relative-key table `distance_embedding`
  [left + right + 1, Dh], and the conv module (its two LayerNorms, the
  pointwise convolutions D -> 2D and D -> D without bias, the depthwise
  convolution [D, 1, k] without bias).

Every LayerNorm sits at ones and zeros (HF's init); each weight is normal
with std fan_in ** -0.5, each bias std 0.02. The distance table is drawn with
std 1 (DISTANCE_STD): q is of std about 1 a component, so q E^T / sqrt(Dh)
then spreads as q k^T / sqrt(Dh) does, where HF's 0.02 would leave the
relative term idle.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .weights import Leaf, _dense, _draw

DISTANCE_STD = 1.0
WINDOW, HOP, STRIDE = 400, 160, 2  # the Kaldi fbank's frames, stacked in pairs


def _unit_norm(prefix: str, dim: int) -> List[Leaf]:
    return [(f"{prefix}.weight", (dim,), 0.0, 1.0), (f"{prefix}.bias", (dim,), 0.0, 0.0)]


def leaves(cfg: dict) -> List[Leaf]:
    D, F, H = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_attention_heads"]
    C, k = cfg["feature_projection_input_dim"], cfg["conv_depthwise_kernel_size"]
    distances = cfg["left_max_position_embeddings"] + cfg["right_max_position_embeddings"] + 1
    out = _unit_norm("feature_projection.layer_norm", C)
    out += _dense("feature_projection.projection", D, C)
    for i in range(cfg["num_hidden_layers"]):
        base = f"encoder.layers.{i}"
        for ffn in ("ffn1", "ffn2"):
            out += _unit_norm(f"{base}.{ffn}_layer_norm", D)
            out += _dense(f"{base}.{ffn}.intermediate_dense", F, D)
            out += _dense(f"{base}.{ffn}.output_dense", D, F)
        out += _unit_norm(f"{base}.self_attn_layer_norm", D)
        for proj in ("linear_q", "linear_k", "linear_v", "linear_out"):
            out += _dense(f"{base}.self_attn.{proj}", D, D)
        out.append((f"{base}.self_attn.distance_embedding.weight", (distances, D // H),
                    DISTANCE_STD, 0.0))
        conv = f"{base}.conv_module"
        out += _unit_norm(f"{conv}.layer_norm", D)
        out.append((f"{conv}.pointwise_conv1.weight", (2 * D, D, 1), D ** -0.5, 0.0))
        out.append((f"{conv}.depthwise_conv.weight", (D, 1, k), k ** -0.5, 0.0))
        out += _unit_norm(f"{conv}.depthwise_layer_norm", D)
        out.append((f"{conv}.pointwise_conv2.weight", (D, D, 1), D ** -0.5, 0.0))
        out += _unit_norm(f"{base}.final_layer_norm", D)
    return out


def weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """w2v-BERT 2.0's state dict (Hugging Face names and shapes) on `device`."""
    return _draw(leaves(cfg), seed, "w2v_bert", device)


def frames(samples: int) -> int:
    """Valid frames of a unit of `samples` samples: its fbank frames over 2."""
    return ((samples - WINDOW) // HOP + 1) // STRIDE if samples >= WINDOW else 0


def unit_flops(cfg: dict, samples: int) -> float:
    """Forward FLOPs of one unit of `samples` samples (t frames) through
    w2v-BERT 2.0, a multiply-add two: once per frame the projection, 2 x 160 x
    D; per frame and layer the linears, 14 D^2 (Q/K/V 6, out 2, the pointwise
    convolutions 4 and 2) + 8 D F (two FFNs of two products), the attention's
    scores and weighted values 4 t D, the relative term's q E^T 2 (left +
    right + 1) D and its sum into the scores H t, and the depthwise
    convolution 2 k D. The fbank (FFT and mel product), the norms and the
    activations are not counted."""
    t = frames(samples)
    D, F, H = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_attention_heads"]
    distances = cfg["left_max_position_embeddings"] + cfg["right_max_position_embeddings"] + 1
    per_layer = (14 * D * D + 8 * D * F + 4 * t * D + 2 * distances * D + H * t
                 + 2 * cfg["conv_depthwise_kernel_size"] * D)
    return float(t * (2 * cfg["feature_projection_input_dim"] * D
                      + cfg["num_hidden_layers"] * per_layer))
