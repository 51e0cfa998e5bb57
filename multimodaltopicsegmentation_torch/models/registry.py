"""Architecture registry: reference architecture names -> tagger classes
(counterpart of the JAX package's models/registry.py; every name it builds)."""
from __future__ import annotations

import torch

from . import taggers
from .base import TaggerConfig

_TAGGERS = {
    "biLSTMCRF": taggers.BiRnnCrf,
    "BiLSTM": taggers.BiLSTMTagger,
    "BiLSTMLateFusion": taggers.BiLSTMLateFusion,
    "SimpleBiLSTM": taggers.SimpleBiLSTM,
    "MLP": taggers.MLPTagger,
    "SheikhBiLSTM": taggers.SheikhBiLSTM,
    "SwitchBiLSTM": taggers.SwitchBiLSTM,
}


def build(architecture: str, cfg: TaggerConfig, generator: torch.Generator = None):
    """Instantiate a tagger by its reference architecture name; weights are
    drawn from `generator`."""
    if architecture in _TAGGERS:
        return _TAGGERS[architecture](cfg, generator)
    if architecture in ("Transformer", "Transformer-CRF", "RecurrentLongT5",
                        "BiLSTMRestrictedMHA", "RecurrentLongformer"):
        from . import transformers as tr

        if architecture == "Transformer":
            # attention_window=0 encodes the dense (restricted=False) variant
            # that a converted reference BertModel checkpoint carries
            return tr.TransformerSegmenter(cfg, restricted=cfg.attention_window > 0,
                                           generator=generator)
        if architecture == "Transformer-CRF":
            return tr.TransformerCRF(cfg, generator)
        if architecture == "RecurrentLongT5":
            return tr.RecurrentLongT5(cfg, generator)
        return tr.RecurrentLongformer(cfg, generator=generator)
    raise ValueError(f"No architecture named {architecture!r} implemented")


def grads_from_jax(tagger, grads: dict) -> dict:
    """JAX gradients (a pytree of arrays in the parameter layout, as
    `jax.grad` of a tagger's loss gives them) -> {name: tensor} in the order
    of `tagger.named_parameters()`, so that gradient parity is one comparison.
    The layout maps as the parameters do."""
    sd = type(tagger).from_jax_params(grads)
    return {name: sd[name] for name, _ in tagger.named_parameters()}


def is_crf(architecture: str) -> bool:
    return architecture.lower().endswith("crf")


def is_double_input(architecture: str) -> bool:
    return architecture == "BiLSTMLateFusion"


def is_domain_adapt(architecture: str) -> bool:
    return architecture == "SwitchBiLSTM"
