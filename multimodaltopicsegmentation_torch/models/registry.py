"""Architecture registry: reference architecture names -> tagger classes
(counterpart of the JAX package's models/registry.py; BiLSTM only so far)."""
from __future__ import annotations

import torch

from . import taggers
from .base import TaggerConfig


def build(architecture: str, cfg: TaggerConfig, generator: torch.Generator = None):
    """Instantiate a tagger by its reference architecture name."""
    if architecture == "BiLSTM":
        return taggers.BiLSTMTagger(cfg, generator)
    raise NotImplementedError(
        f"architecture {architecture!r} is not ported yet: the BiLSTM tagger is; "
        "the transformer taggers, the CRF and the other BiLSTM variants are "
        "ROADMAP.md section 1 items 9 and 10"
    )
