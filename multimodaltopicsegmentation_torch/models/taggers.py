"""The BiLSTM tagger family (counterpart of the JAX package's
models/taggers.py): BiLSTM, BiLSTMLateFusion, BiRnnCrf (`biLSTMCRF`),
SimpleBiLSTM, MLP, SheikhBiLSTM and SwitchBiLSTM.

State-dict names follow the reference taggers, which
tools/convert_reference_checkpoint.py reads (under the reference Lightning
module, whose keys gain a `model.` prefix): `model.rnn.weight_ih_l0` and
`classification.weight` for the BiLSTM, `model1.rnn.*` / `model2.rnn.*` for
late fusion, `crf.fc.*` / `crf.transitions` for the CRF, a bare `lstm.*` and
`classifier` for SimpleBiLSTM, `layers.{i}` for the MLP, `lstm.rnn.*` with
`forward_dense` / `backward_dense` for Sheikh, and `model_1` / `model_2` or
`classification_1` / `classification_2` for the two Switch layouts. Each
tagger converts with `from_jax_params` / `to_jax_params`.

`loss` runs a recurrent stack with dropout_in before it and dropout_out after
it (outside the recurrent module, as the reference does), drawn from an
explicit generator; without one, and at decode, dropout is inactive.
SimpleBiLSTM and the MLP never drop.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import crf as crf_lib
from ..ops import losses as losses_lib
from ..ops import rnn as rnn_lib
from ..ops.cosine_loss import cosine_segment_loss
from ..ops.masks import length_mask
from .base import (TaggerConfig, dropout, head_decode, head_dim, head_loss, linear,
                   linear_from_jax, linear_to_jax)

COSINE_WEIGHT = 0.1  # the reference's weight of the auxiliary cosine loss


def _stack(cfg: TaggerConfig, in_dim: int, generator) -> rnn_lib.RNNStack:
    return rnn_lib.RNNStack(in_dim, cfg.hidden_dim, cfg.num_layers, cfg.bidirectional,
                            cfg.lstm, generator)


def _out_dim(cfg: TaggerConfig) -> int:
    return 2 * cfg.hidden_dim if cfg.bidirectional else cfg.hidden_dim


def _apply(stack, cfg: TaggerConfig, x, lengths, train: bool, generator):
    """The stack with dropout_in before it and dropout_out after it."""
    h = dropout(x, cfg.dropout_in, generator, not train)
    return dropout(stack(h, lengths), cfg.dropout_out, generator, not train)


def _head_loss(cfg: TaggerConfig, classification, h, lengths, tags):
    """The head's loss on states h, plus the weighted cosine loss on h with `-cos`."""
    loss = head_loss(cfg, classification(h), lengths, tags)
    if cfg.cosine_loss:
        loss = loss + COSINE_WEIGHT * cosine_segment_loss(h, lengths, tags)
    return loss


def _masked_bce(logits, lengths, tags):
    """BCE of the single logit over the unpadded positions."""
    mask = length_mask(lengths.to(logits.device), logits.shape[1], logits.dtype).reshape(-1)
    t = torch.where(mask > 0, tags.reshape(-1).to(logits.dtype), 0.0)
    return losses_lib.bce_loss(logits[..., 0].reshape(-1), t, mask)


def _rnn_from_jax(sd: dict, prefix: str, layers: list):
    sd.update({f"{prefix}.{k}": v for k, v in rnn_lib.from_jax_params(layers).items()})


def _rnn_to_jax(sd: dict, prefix: str, cfg: TaggerConfig) -> list:
    return rnn_lib.to_jax_params(sd, cfg.num_layers, cfg.bidirectional, prefix=f"{prefix}.rnn")


class _Tagger(nn.Module):
    def to_jax_params(self) -> dict:
        """This tagger's weights as the JAX pytree (numpy leaves)."""
        return self._to_jax(self.state_dict())


class BiLSTMTagger(_Tagger):
    """Recurrent stack -> linear head -> threshold decode."""

    def __init__(self, cfg: TaggerConfig, generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        self.model = _stack(cfg, cfg.embedding_dim, generator)
        self.classification = linear(_out_dim(cfg), head_dim(cfg), generator)

    def scores(self, x: torch.Tensor, lengths: torch.Tensor, train: bool = False,
               generator: torch.Generator = None) -> torch.Tensor:
        """x [B, L, D], lengths [B] -> logits [B, L, head_dim]."""
        return self.classification(_apply(self.model, self.cfg, x, lengths, train, generator))

    def loss(self, x: torch.Tensor, lengths: torch.Tensor, tags: torch.Tensor,
             generator: torch.Generator = None) -> torch.Tensor:
        """Scalar training loss; `generator` (on x's device) turns dropout on."""
        h = _apply(self.model, self.cfg, x, lengths, True, generator)
        return _head_loss(self.cfg, self.classification, h, lengths, tags)

    def decode(self, x: torch.Tensor, lengths: torch.Tensor, threshold: float):
        logits = self.scores(x, lengths)
        return logits, head_decode(self.cfg, logits, threshold)

    @staticmethod
    def from_jax_params(params: dict) -> dict:
        """JAX {"rnn": [...], "cls": {"w", "b"}} pytree -> state_dict."""
        sd = {}
        _rnn_from_jax(sd, "model", params["rnn"])
        linear_from_jax(sd, "classification", params["cls"])
        return sd

    def _to_jax(self, sd: dict) -> dict:
        return {"rnn": _rnn_to_jax(sd, "model", self.cfg),
                "cls": linear_to_jax(sd, "classification")}


class BiLSTMLateFusion(_Tagger):
    """Two recurrent towers over two modalities (x and x2, the same lengths),
    their states concatenated, one head."""

    def __init__(self, cfg: TaggerConfig, generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        self.model1 = _stack(cfg, cfg.embedding_dim, generator)
        self.model2 = _stack(cfg, cfg.embedding_dim2, generator)
        self.classification = linear(4 * cfg.hidden_dim, head_dim(cfg), generator)

    def _hidden(self, x, lengths, train, generator, x2):
        return torch.cat([_apply(self.model1, self.cfg, x, lengths, train, generator),
                          _apply(self.model2, self.cfg, x2, lengths, train, generator)], dim=-1)

    def scores(self, x, lengths, train=False, generator=None, x2=None):
        return self.classification(self._hidden(x, lengths, train, generator, x2))

    def loss(self, x, lengths, tags, generator=None, x2=None):
        h = self._hidden(x, lengths, True, generator, x2)
        return _head_loss(self.cfg, self.classification, h, lengths, tags)

    def decode(self, x, lengths, threshold, x2=None):
        logits = self.scores(x, lengths, x2=x2)
        return logits, head_decode(self.cfg, logits, threshold)

    @staticmethod
    def from_jax_params(params: dict) -> dict:
        sd = {}
        _rnn_from_jax(sd, "model1", params["rnn1"])
        _rnn_from_jax(sd, "model2", params["rnn2"])
        linear_from_jax(sd, "classification", params["cls"])
        return sd

    def _to_jax(self, sd: dict) -> dict:
        return {"rnn1": _rnn_to_jax(sd, "model1", self.cfg),
                "rnn2": _rnn_to_jax(sd, "model2", self.cfg),
                "cls": linear_to_jax(sd, "classification")}


class BiRnnCrf(_Tagger):
    """Recurrent stack -> linear-chain CRF over 2 * hidden_dim inputs; decode
    is the Viterbi path (scores: one best-path score per document)."""

    def __init__(self, cfg: TaggerConfig, generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        self.model = _stack(cfg, cfg.embedding_dim, generator)
        self.crf = crf_lib.CRF(2 * cfg.hidden_dim, cfg.tagset_size, generator)

    def loss(self, x, lengths, tags, generator=None):
        mask = length_mask(lengths.to(x.device), x.shape[1], x.dtype)
        h = _apply(self.model, self.cfg, x, lengths, True, generator)
        # padded tags may be -1 (labels padded for a non-CRF run) or 0
        return crf_lib.crf_loss(self.crf, h, tags.long().clamp_min(0), mask)

    def decode(self, x, lengths, threshold=None):
        mask = length_mask(lengths.to(x.device), x.shape[1], x.dtype)
        h = _apply(self.model, self.cfg, x, lengths, False, None)
        score, paths = crf_lib.viterbi_decode(self.crf, h, mask)
        return score, paths.bool()

    @staticmethod
    def from_jax_params(params: dict) -> dict:
        sd = {}
        _rnn_from_jax(sd, "model", params["rnn"])
        crf_lib.from_jax_params(sd, "crf", params["crf"])
        return sd

    def _to_jax(self, sd: dict) -> dict:
        return {"rnn": _rnn_to_jax(sd, "model", self.cfg), "crf": crf_lib.to_jax_params(sd, "crf")}


class SimpleBiLSTM(_Tagger):
    """A bare bidirectional `nn.LSTM` (always LSTM, always bidirectional, no
    dropout) -> one logit, BCE over the unpadded positions."""

    def __init__(self, cfg: TaggerConfig, generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        self.lstm = nn.LSTM(cfg.embedding_dim, cfg.hidden_dim, num_layers=cfg.num_layers,
                            bidirectional=True, batch_first=True)
        rnn_lib.tf_init(self.lstm, generator)
        self.classifier = linear(2 * cfg.hidden_dim, 1, generator)

    def scores(self, x, lengths, train=False, generator=None):
        if isinstance(self.lstm, nn.LSTM):
            return self.classifier(rnn_lib.run_packed(self.lstm, x, lengths))
        # a gate-sharded recurrence in the LSTM's place (parallel/tensor.py)
        return self.classifier(self.lstm(x, lengths))

    def loss(self, x, lengths, tags, generator=None):
        return _masked_bce(self.scores(x, lengths, train=True), lengths, tags)

    def decode(self, x, lengths, threshold):
        logits = self.scores(x, lengths)
        return logits, torch.sigmoid(logits[..., 0]) > threshold

    @staticmethod
    def from_jax_params(params: dict) -> dict:
        sd = rnn_lib.from_jax_params(params["rnn"], prefix="lstm")
        linear_from_jax(sd, "classifier", params["cls"])
        return sd

    def _to_jax(self, sd: dict) -> dict:
        return {"rnn": rnn_lib.to_jax_params(sd, self.cfg.num_layers, True, prefix="lstm"),
                "cls": linear_to_jax(sd, "classifier")}


class MLPTagger(_Tagger):
    """Per-unit MLP (num_layers ReLU layers of hidden_dim) -> one logit; no
    dropout, BCE over the unpadded positions."""

    def __init__(self, cfg: TaggerConfig, generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.embedding_dim] + [cfg.hidden_dim] * cfg.num_layers
        self.layers = nn.ModuleList(linear(i, o, generator) for i, o in zip(dims, dims[1:]))
        self.classifier = linear(dims[-1], 1, generator)

    def scores(self, x, lengths, train=False, generator=None):
        h = x
        for layer in self.layers:
            h = torch.relu(layer(h))
        return self.classifier(h)

    def loss(self, x, lengths, tags, generator=None):
        return _masked_bce(self.scores(x, lengths), lengths, tags)

    def decode(self, x, lengths, threshold):
        logits = self.scores(x, lengths)
        return logits, torch.sigmoid(logits[..., 0]) > threshold

    @staticmethod
    def from_jax_params(params: dict) -> dict:
        sd = {}
        for i, p in enumerate(params["layers"]):
            linear_from_jax(sd, f"layers.{i}", p)
        linear_from_jax(sd, "classifier", params["cls"])
        return sd

    def _to_jax(self, sd: dict) -> dict:
        return {"layers": [linear_to_jax(sd, f"layers.{i}") for i in range(len(self.layers))],
                "cls": linear_to_jax(sd, "classifier")}


class SheikhBiLSTM(_Tagger):
    """Coherence scorer: the projected forward state at t dotted with the
    projected backward state at t + 1 (L - 1 pairs), BCE against inverted
    labels (coherent, no boundary -> 1)."""

    def __init__(self, cfg: TaggerConfig, generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        self.lstm = _stack(cfg, cfg.embedding_dim, generator)
        self.forward_dense = linear(cfg.hidden_dim, cfg.hidden_dim, generator)
        self.backward_dense = linear(cfg.hidden_dim, cfg.hidden_dim, generator)

    def _coherence(self, x, lengths, train, generator):
        h = _apply(self.lstm, self.cfg, x, lengths, train, generator)
        H = self.cfg.hidden_dim
        x_for = self.forward_dense(h[:, :-1, :H])
        x_bac = self.backward_dense(h[:, 1:, H : 2 * H])
        return (x_for * x_bac).sum(dim=-1)  # [B, L - 1]

    def loss(self, x, lengths, tags, generator=None):
        dot = self._coherence(x, lengths, True, generator)
        Lm1 = dot.shape[1]
        inv = 1.0 - tags[:, :Lm1].to(x.dtype)
        probs = 1.0 - torch.sigmoid(dot)
        # lengths - 1 pairs; a zero-length row has none
        mask = length_mask(lengths.to(x.device) - 1, Lm1, x.dtype)
        inv = torch.where(mask > 0, inv, 0.0)
        eps = 1e-7
        bce = -(inv * torch.log(probs + eps) + (1 - inv) * torch.log(1 - probs + eps))
        return (bce * mask).sum() / losses_lib.reduce_count(mask.sum()).clamp_min(1.0)

    def decode(self, x, lengths, threshold):
        dot = self._coherence(x, lengths, False, None)
        scores = torch.cat([dot, dot.new_ones((dot.shape[0], 1))], dim=1)
        return scores[..., None], (1.0 - torch.sigmoid(scores)) < threshold

    @staticmethod
    def from_jax_params(params: dict) -> dict:
        sd = {}
        _rnn_from_jax(sd, "lstm", params["rnn"])
        linear_from_jax(sd, "forward_dense", params["fwd_dense"])
        linear_from_jax(sd, "backward_dense", params["bwd_dense"])
        return sd

    def _to_jax(self, sd: dict) -> dict:
        return {"rnn": _rnn_to_jax(sd, "lstm", self.cfg),
                "fwd_dense": linear_to_jax(sd, "forward_dense"),
                "bwd_dense": linear_to_jax(sd, "backward_dense")}


class SwitchBiLSTM(_Tagger):
    """Domain adaptation: per-domain recurrent towers (`switch` "lstm") or
    per-domain heads ("dense"), selected per document by a [B] domain flag
    (1 picks the first). Both branches run on the whole batch."""

    def __init__(self, cfg: TaggerConfig, generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        if cfg.switch == "lstm":
            self.model_1 = _stack(cfg, cfg.embedding_dim, generator)
            self.model_2 = _stack(cfg, cfg.embedding_dim, generator)
            self.classification = linear(_out_dim(cfg), head_dim(cfg), generator)
        else:
            self.model = _stack(cfg, cfg.embedding_dim, generator)
            self.classification_1 = linear(_out_dim(cfg), head_dim(cfg), generator)
            self.classification_2 = linear(_out_dim(cfg), head_dim(cfg), generator)

    def scores(self, x, lengths, domains, train=False, generator=None):
        dom = domains.to(x.device).bool()[:, None, None]
        if self.cfg.switch == "lstm":
            h1 = _apply(self.model_1, self.cfg, x, lengths, train, generator)
            h2 = _apply(self.model_2, self.cfg, x, lengths, train, generator)
            return self.classification(torch.where(dom, h1, h2))
        h = _apply(self.model, self.cfg, x, lengths, train, generator)
        return torch.where(dom, self.classification_1(h), self.classification_2(h))

    def loss(self, x, lengths, tags, domains, generator=None):
        logits = self.scores(x, lengths, domains, train=True, generator=generator)
        return head_loss(self.cfg, logits, lengths, tags)

    def decode(self, x, lengths, domains, threshold):
        logits = self.scores(x, lengths, domains)
        return logits, head_decode(self.cfg, logits, threshold)

    @staticmethod
    def from_jax_params(params: dict) -> dict:
        sd = {}
        if "rnn1" in params:
            _rnn_from_jax(sd, "model_1", params["rnn1"])
            _rnn_from_jax(sd, "model_2", params["rnn2"])
            linear_from_jax(sd, "classification", params["cls"])
        else:
            _rnn_from_jax(sd, "model", params["rnn"])
            linear_from_jax(sd, "classification_1", params["cls1"])
            linear_from_jax(sd, "classification_2", params["cls2"])
        return sd

    def _to_jax(self, sd: dict) -> dict:
        if self.cfg.switch == "lstm":
            return {"rnn1": _rnn_to_jax(sd, "model_1", self.cfg),
                    "rnn2": _rnn_to_jax(sd, "model_2", self.cfg),
                    "cls": linear_to_jax(sd, "classification")}
        return {"rnn": _rnn_to_jax(sd, "model", self.cfg),
                "cls1": linear_to_jax(sd, "classification_1"),
                "cls2": linear_to_jax(sd, "classification_2")}
