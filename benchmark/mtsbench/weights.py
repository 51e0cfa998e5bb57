"""Weights made from `--seed` on the device, in one draw per model.

Each model's leaves are listed with their shapes and scales; one normal draw
from a `torch.Generator` on the device fills them all, as views of one flat
buffer (scaled, plus 1 for the norms' scales). Both the program and the
plain reference take these same values:

- wav2vec2: a state dict under the Hugging Face names (the positional
  convolution's weight norm folded), which `encoders.wav2vec2.build_model`
  takes;
- the taggers: the JAX-layout pytree the repository's checkpoints hold
  (linears as {"w": [in, out], "b"}; an LSTM direction as w_ih [in, 4H],
  w_hh [H, 4H], b_ih, b_hh with PyTorch's gate order i, f, g, o), which the
  taggers' `from_jax_params` read.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .traffic import sub_seed

Leaf = Tuple[str, Tuple[int, ...], float, float]  # (name, shape, std, mean)


def _draw(leaves: List[Leaf], seed: int, stream: str, device) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(shape) for _, shape, _, _ in leaves)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, stream))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, i = {}, 0
    for name, shape, std, mean in leaves:
        n = math.prod(shape)
        out[name] = flat[i:i + n].view(shape).mul_(std).add_(mean)
        i += n
    return out


def _norm(prefix: str, dim: int, scale_name="weight", bias_name="bias") -> List[Leaf]:
    return [(f"{prefix}.{scale_name}", (dim,), 0.1, 1.0), (f"{prefix}.{bias_name}", (dim,), 0.1, 0.0)]


def _dense(prefix: str, n_out: int, n_in: int) -> List[Leaf]:
    """A torch-layout linear, weight [out, in]."""
    return [(f"{prefix}.weight", (n_out, n_in), n_in ** -0.5, 0.0),
            (f"{prefix}.bias", (n_out,), 0.02, 0.0)]


def wav2vec2_leaves(cfg: dict) -> List[Leaf]:
    leaves: List[Leaf] = []
    c_in = 1
    for i, (c, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        base = f"feature_extractor.conv_layers.{i}"
        leaves.append((f"{base}.conv.weight", (c, c_in, k), (c_in * k) ** -0.5, 0.0))
        if i == 0:
            leaves += _norm(f"{base}.layer_norm", c)
        c_in = c
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    G, K = cfg["num_conv_pos_embedding_groups"], cfg["num_conv_pos_embeddings"]
    leaves += _norm("feature_projection.layer_norm", c_in)
    leaves += _dense("feature_projection.projection", D, c_in)
    leaves += [("encoder.pos_conv_embed.conv.weight", (D, D // G, K), (D // G * K) ** -0.5, 0.0),
               ("encoder.pos_conv_embed.conv.bias", (D,), 0.02, 0.0)]
    leaves += _norm("encoder.layer_norm", D)
    for i in range(cfg["num_hidden_layers"]):
        base = f"encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            leaves += _dense(f"{base}.attention.{proj}", D, D)
        leaves += _norm(f"{base}.layer_norm", D)
        leaves += _dense(f"{base}.feed_forward.intermediate_dense", F, D)
        leaves += _dense(f"{base}.feed_forward.output_dense", D, F)
        leaves += _norm(f"{base}.final_layer_norm", D)
    return leaves


def wav2vec2(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """wav2vec2's state dict (Hugging Face names) on `device`."""
    return _draw(wav2vec2_leaves(cfg), seed, "wav2vec2", device)


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """{"a/0/b": t} -> {"a": [{"b": t}]} (numeric keys become list items)."""
    root: dict = {}
    for path, value in flat.items():
        node = root
        keys = path.split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def tagger(tagger_cfg: dict, seed: int, device) -> dict:
    """The tagger's JAX-layout pytree of device tensors, laid out by its
    architecture's reference module (`reference/taggers/<name>.py`)."""
    from reference import taggers

    kind = tagger_cfg["architecture"]
    return nest(_draw(taggers.load(kind).leaves(tagger_cfg), seed, kind, device))


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return tree
    return tree.detach().cpu().numpy()

