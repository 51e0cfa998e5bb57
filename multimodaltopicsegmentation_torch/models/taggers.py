"""The BiLSTM tagger (counterpart of `BiLSTMTagger` in the JAX package's
models/taggers.py): recurrent stack -> linear head -> threshold decode.

State-dict names follow the reference tagger (`model.rnn.weight_ih_l0`,
`classification.weight`); under the reference Lightning module, whose keys
gain a `model.` prefix, they are what tools/convert_reference_checkpoint.py
reads. Inference only: dropout is inactive at decode in JAX as well.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops import rnn as rnn_lib
from .base import TaggerConfig, head_decode, head_dim, linear


class BiLSTMTagger(nn.Module):
    def __init__(self, cfg: TaggerConfig, generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        out_dim = 2 * cfg.hidden_dim if cfg.bidirectional else cfg.hidden_dim
        self.model = rnn_lib.RNNStack(cfg.embedding_dim, cfg.hidden_dim, cfg.num_layers,
                                      cfg.bidirectional, cfg.lstm, generator)
        self.classification = linear(out_dim, head_dim(cfg), generator)

    def scores(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """x [B, L, D], lengths [B] -> logits [B, L, head_dim]."""
        return self.classification(self.model(x, lengths))

    def decode(self, x: torch.Tensor, lengths: torch.Tensor, threshold: float):
        logits = self.scores(x, lengths)
        return logits, head_decode(self.cfg, logits, threshold)

    @staticmethod
    def from_jax_params(params: dict) -> dict:
        """JAX {"rnn": [...], "cls": {"w", "b"}} pytree -> state_dict."""
        sd = {f"model.{k}": v for k, v in rnn_lib.from_jax_params(params["rnn"]).items()}
        sd["classification.weight"] = torch.from_numpy(np.array(params["cls"]["w"], np.float32).T)
        sd["classification.bias"] = torch.from_numpy(np.array(params["cls"]["b"], np.float32))
        return sd

    def to_jax_params(self) -> dict:
        """This tagger's weights as the JAX pytree (numpy leaves)."""
        sd = {k[len("model."):]: v for k, v in self.state_dict().items() if k.startswith("model.")}
        return {
            "rnn": rnn_lib.to_jax_params(sd, self.cfg.num_layers, self.cfg.bidirectional),
            "cls": {"w": self.classification.weight.detach().cpu().numpy().T.copy(),
                    "b": self.classification.bias.detach().cpu().numpy().copy()},
        }
