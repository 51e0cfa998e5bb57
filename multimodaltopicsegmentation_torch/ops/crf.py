"""Linear-chain CRF (counterpart of the JAX package's ops/crf.py): the forward
algorithm, the gold path's score, the loss and a Viterbi decode whose
backtrace stays on the device.

Semantics as there: START and STOP are appended to the tag set (C =
num_tags + 2, START = C - 2, STOP = C - 1), `transitions[i, j]` is the score
of moving FROM j TO i, and IMPOSSIBLE = -1e4 walls forbid moving into START
and out of STOP. The loss is the mean negative log-likelihood over the
documents with at least one valid unit.

Both recurrences are Python loops over time whose bodies launch a few small
kernels each and never wait for the device: no value is read back to the
host inside a loop. The JAX package runs each as one compiled `lax.scan`;
the forward algorithm's gradient is its reverse loop (`_LogPartition`).
Ties at a maximum resolve to the first index (`torch.argmax`, as
`jnp.argmax`), so the two packages give the same paths.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from . import losses as losses_lib

IMPOSSIBLE = -1e4


class CRF(nn.Module):
    """The CRF's parameters: the emission projection `fc` ([in_features] ->
    C) and `transitions` [C, C], named as the reference's state dict has
    them (`crf.fc.weight`, `crf.fc.bias`, `crf.transitions`)."""

    def __init__(self, in_features: int, num_tags: int, generator: torch.Generator = None):
        super().__init__()
        C = num_tags + 2
        self.fc = nn.Linear(in_features, C)
        bound = 1.0 / math.sqrt(in_features)
        trans = torch.randn(C, C, generator=generator)
        trans[C - 2, :] = IMPOSSIBLE  # nothing moves INTO start
        trans[:, C - 1] = IMPOSSIBLE  # nothing moves OUT of stop
        with torch.no_grad():
            self.fc.weight.uniform_(-bound, bound, generator=generator)
            self.fc.bias.uniform_(-bound, bound, generator=generator)
        self.transitions = nn.Parameter(trans)


def _init_scores(emissions: torch.Tensor) -> torch.Tensor:
    B, _, C = emissions.shape
    scores = torch.full((B, C), IMPOSSIBLE, dtype=emissions.dtype, device=emissions.device)
    scores[:, C - 2] = 0.0
    return scores


def forward_algorithm(transitions: torch.Tensor, emissions: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Log-partition per document. emissions [B, L, C], mask [B, L] -> [B];
    differentiable in transitions and emissions."""
    return _LogPartition.apply(transitions, emissions, mask)


class _LogPartition(torch.autograd.Function):
    """The forward algorithm as one autograd node. The forward keeps every
    step's scores; the backward walks the steps in reverse (the counterpart
    of JAX's reverse scan), each step one batched product of the incoming
    gradient with that step's softmax weights, which are rebuilt for all
    steps at once from the kept scores. Autograd through the Python loop
    would instead record and replay some ten nodes per unit."""

    @staticmethod
    def forward(ctx, transitions, emissions, mask):
        C = emissions.shape[-1]
        emit = emissions.transpose(0, 1)  # [L, B, C]
        valid = (mask > 0).transpose(0, 1)[..., None]  # [L, B, 1]
        scores = _init_scores(emissions)
        kept = [scores]
        for t in range(emit.shape[0]):
            # scores[b, j] + trans[i, j] + emit[b, i] -> logsumexp over j
            cand = scores[:, None, :] + transitions[None] + emit[t][:, :, None]
            top = cand.amax(dim=-1, keepdim=True)
            # logsumexp over j; the scores stay finite, so torch.logsumexp's
            # guards against infinite maxima are launches this loop can spare
            new = torch.log(torch.exp(cand - top).sum(dim=-1)) + top[..., 0]
            scores = torch.where(valid[t], new, scores)
            kept.append(scores)
        ctx.save_for_backward(transitions, emissions, valid, torch.stack(kept))
        return torch.logsumexp(scores + transitions[C - 1][None, :], dim=-1)

    @staticmethod
    def backward(ctx, grad):
        transitions, emissions, valid, kept = ctx.saved_tensors
        C = emissions.shape[-1]
        # d logZ / d (final scores) is the softmax over the final tags
        last = grad[:, None] * torch.softmax(kept[-1] + transitions[C - 1][None, :], dim=-1)
        # softmax weights of every step: cand[t, b, i, j] - new score[t, b, i]
        cand = kept[:-1, :, None, :] + transitions[None, None] + emissions.transpose(0, 1)[..., None]
        # a masked step passes its scores on untouched: no weights, no
        # gradient into its cand
        weights = torch.where(valid[..., None], torch.exp(cand - kept[1:, :, :, None]), 0.0)
        g, per_step = last, [None] * len(weights)
        for t in range(len(weights) - 1, -1, -1):
            per_step[t] = g  # the gradient of step t's output
            g = torch.where(valid[t], torch.bmm(g[:, None, :], weights[t])[:, 0], g)
        d_cand = torch.stack(per_step)[..., None] * weights  # [L, B, C, C]
        d_trans = d_cand.sum(dim=(0, 1))
        d_trans[C - 1] += last.sum(dim=0)
        return d_trans, d_cand.sum(dim=-1).transpose(0, 1), None


def gold_score(transitions: torch.Tensor, emissions: torch.Tensor, tags: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Score of the given tag path, masked to each length; a zero-length row
    scores trans[STOP, START]."""
    B, L, C = emissions.shape
    start, stop = C - 2, C - 1
    tags = tags.long()
    emit = emissions.gather(2, tags[..., None])[..., 0]
    prev = torch.cat([torch.full((B, 1), start, dtype=torch.long, device=tags.device),
                      tags[:, :-1]], dim=1)
    seq_score = ((emit + transitions[tags, prev]) * mask).sum(dim=1)
    lengths = mask.sum(dim=1).long()
    # the tag just before STOP: the last valid one, or START for an empty row
    last = tags.gather(1, (lengths - 1).clamp_min(0)[:, None])[:, 0]
    last = torch.where(lengths > 0, last, start)
    return seq_score + transitions[stop, last]


def crf_loss(crf: CRF, features: torch.Tensor, tags: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the documents with a valid unit, so
    that zero-length padding rows contribute nothing."""
    emissions = crf.fc(features)
    nll = forward_algorithm(crf.transitions, emissions, mask) \
        - gold_score(crf.transitions, emissions, tags, mask)
    valid = (mask.sum(dim=1) > 0).to(nll.dtype)
    return (nll * valid).sum() / losses_lib.reduce_count(valid.sum()).clamp_min(1.0)


def viterbi_decode(crf: CRF, features: torch.Tensor, mask: torch.Tensor):
    """-> (best score [B], best path [B, L] int64), on the device. Positions
    past each length hold the last valid tag (callers slice to lengths)."""
    emissions = crf.fc(features)
    L, C = emissions.shape[1:]
    trans = crf.transitions
    emit = emissions.transpose(0, 1)
    valid = (mask > 0).transpose(0, 1)[..., None]
    scores = _init_scores(emissions)
    backpointers = []
    for t in range(L):
        cand = scores[:, None, :] + trans[None]  # [B, i, j]
        backpointers.append(torch.argmax(cand, dim=-1))
        scores = torch.where(valid[t], cand.amax(dim=-1) + emit[t], scores)
    final = scores + trans[C - 1][None, :]
    best_score = final.amax(dim=-1)
    best_last = torch.argmax(final, dim=-1)

    # reverse backtrace: y[len - 1] = best_last, y[t] = bp[t + 1][y[t + 1]]
    lengths = mask.sum(dim=1).long()
    at_end = torch.arange(L, device=emissions.device)[:, None] >= (lengths - 1)[None, :]  # [L, B]
    path = [best_last] * L  # position L - 1 is the end of every row
    for t in range(L - 2, -1, -1):
        followed = backpointers[t + 1].gather(1, path[t + 1][:, None])[:, 0]
        path[t] = torch.where(at_end[t], best_last, followed)
    return best_score, torch.stack(path, dim=1)


def from_jax_params(sd: dict, prefix: str, p: dict):
    """The JAX CRF pytree {"fc_w" [in, C], "fc_b", "transitions"} into `sd`
    under `prefix` (`prefix.fc.weight`, `prefix.fc.bias`, `prefix.transitions`)."""
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    sd[f"{prefix}.fc.weight"] = t(np.transpose(p["fc_w"]))
    sd[f"{prefix}.fc.bias"] = t(p["fc_b"])
    sd[f"{prefix}.transitions"] = t(p["transitions"])


def to_jax_params(sd: dict, prefix: str) -> dict:
    """Inverse of `from_jax_params` (numpy leaves)."""
    n = lambda name: sd[f"{prefix}.{name}"].detach().cpu().numpy().copy()  # noqa: E731
    return {"fc_w": n("fc.weight").T.copy(), "fc_b": n("fc.bias"), "transitions": n("transitions")}
