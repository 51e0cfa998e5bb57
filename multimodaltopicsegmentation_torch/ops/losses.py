"""Loss functions for boundary tagging (counterpart of the JAX package's
ops/losses.py).

- sigmoid focal loss: RetinaNet form, alpha 0.9 and gamma 2 by default,
  computed from logits with the stable BCE-with-logits inside;
- BCE: takes logits and fuses the sigmoid;
- cross entropy with ignore_index -1: padded positions carry target -1 and
  are left out of the mean.

All losses take a [N] validity mask instead of unpadding on the host; the
masked mean over valid elements divides by max(sum(mask), 1), so a batch
with no valid element gives 0.

`reduce_count` is the one place a masked mean's count passes through (here,
in `ops/crf.crf_loss`, `ops/cosine_loss` and SheikhBiLSTM's coherence loss;
tests/test_torch_parallel.py holds every architecture's loss to it). Inside `global_counts(fn)` it
returns fn(count): the data- and sequence-parallel steps sum the count over
the ranks that share one batch, so that each rank's loss is its masked sum
over the global count and the ranks' losses add up to the batch's loss.
"""
from __future__ import annotations

import contextlib

import torch

_COUNT_REDUCER = []


@contextlib.contextmanager
def global_counts(reducer):
    """Within the block, `reduce_count(c)` returns `reducer(c)`."""
    _COUNT_REDUCER.append(reducer)
    try:
        yield
    finally:
        _COUNT_REDUCER.pop()


def reduce_count(count: torch.Tensor) -> torch.Tensor:
    """A masked mean's count (no gradient): as it is, or as the innermost
    `global_counts` block's reducer makes it."""
    count = count.detach()
    return _COUNT_REDUCER[-1](count) if _COUNT_REDUCER else count


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy from logits, stable form:
    max(x, 0) - x*y + log(1 + exp(-|x|))."""
    return logits.clamp_min(0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits, targets, mask, alpha: float = 0.9, gamma: float = 2.0):
    """Masked-mean sigmoid focal loss: ce * (1 - p_t)^gamma, alpha-weighted
    when alpha >= 0."""
    p = torch.sigmoid(logits)
    ce = bce_with_logits(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * torch.pow(1.0 - p_t, gamma)
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    return (loss * mask).sum() / reduce_count(mask.sum()).clamp_min(1.0)


def bce_loss(logits, targets, mask):
    """Masked-mean BCE from logits."""
    return (bce_with_logits(logits, targets) * mask).sum() / reduce_count(mask.sum()).clamp_min(1.0)


def cross_entropy_ignore_index(logits, targets, ignore_index: int = -1):
    """CE over [N, C] logits with integer targets; `ignore_index` entries are
    left out of the mean."""
    valid = (targets != ignore_index).to(logits.dtype)
    safe_t = torch.where(targets == ignore_index, 0, targets).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe_t[:, None])[:, 0]
    return (nll * valid).sum() / reduce_count(valid.sum()).clamp_min(1.0)
