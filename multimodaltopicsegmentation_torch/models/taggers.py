"""The BiLSTM tagger (counterpart of `BiLSTMTagger` in the JAX package's
models/taggers.py): recurrent stack -> linear head -> threshold decode.

State-dict names follow the reference tagger (`model.rnn.weight_ih_l0`,
`classification.weight`); under the reference Lightning module, whose keys
gain a `model.` prefix, they are what tools/convert_reference_checkpoint.py
reads.

`loss` runs the stack with dropout_in before it and dropout_out after it
(applied outside the recurrent module, as the reference does), drawn from an
explicit generator; without one, and at decode, dropout is inactive.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops import rnn as rnn_lib
from .base import TaggerConfig, dropout, head_decode, head_dim, head_loss, linear


class BiLSTMTagger(nn.Module):
    def __init__(self, cfg: TaggerConfig, generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        out_dim = 2 * cfg.hidden_dim if cfg.bidirectional else cfg.hidden_dim
        self.model = rnn_lib.RNNStack(cfg.embedding_dim, cfg.hidden_dim, cfg.num_layers,
                                      cfg.bidirectional, cfg.lstm, generator)
        self.classification = linear(out_dim, head_dim(cfg), generator)

    def scores(self, x: torch.Tensor, lengths: torch.Tensor, train: bool = False,
               generator: torch.Generator = None) -> torch.Tensor:
        """x [B, L, D], lengths [B] -> logits [B, L, head_dim]."""
        h = dropout(x, self.cfg.dropout_in, generator, not train)
        h = dropout(self.model(h, lengths), self.cfg.dropout_out, generator, not train)
        return self.classification(h)

    def loss(self, x: torch.Tensor, lengths: torch.Tensor, tags: torch.Tensor,
             generator: torch.Generator = None) -> torch.Tensor:
        """Scalar training loss; `generator` (on x's device) turns dropout on."""
        if self.cfg.cosine_loss:
            raise NotImplementedError("the auxiliary cosine loss is not ported yet "
                                      "(ROADMAP.md section 1 item 10)")
        logits = self.scores(x, lengths, train=True, generator=generator)
        return head_loss(self.cfg, logits, lengths, tags)

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
