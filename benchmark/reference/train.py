"""Plain PyTorch training of the benchmarked taggers: the focal loss, Adam
and the first steps of a fit, for any architecture of `taggers/`.

The program's trainer draws a new tagger from its seed on the CPU at the
start of every fit; `taggers.<architecture>.initial_params` works the same
values out from the seed, in the JAX layout.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import taggers

BETAS = (0.9, 0.999)
EPS = 1e-7  # the reference trainer's Adam epsilon


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float, gamma: float):
    """Sum of the sigmoid focal loss (RetinaNet form, alpha-weighted) over the
    given units; the caller divides by the units' count."""
    p = torch.sigmoid(logits)
    ce = logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    p_t = p * targets + (1 - p) * (1 - targets)
    weight = alpha * targets + (1 - alpha) * (1 - targets)
    return (weight * ce * (1 - p_t) ** gamma).sum()


def initial_params(tc: dict, seed: int) -> dict:
    return taggers.load(tc["architecture"]).initial_params(tc, seed)


def leaves(tree, prefix="") -> Dict[str, torch.Tensor]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}/{k}" if prefix else k))
    return out


def _rebuild(tree, flat: Dict[str, torch.Tensor], prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, flat, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return flat[prefix]


def batch_loss(tc: dict, params: dict, batch: dict, device, keep_rows=None,
               dtype=torch.float32) -> torch.Tensor:
    """Masked-mean focal loss of a padded batch (src_tokens [B, L, d],
    tgt_tokens, src_lengths), each document at its own length, in `dtype`.
    `keep_rows` limits the batch to those rows (a planted fault)."""
    arch = taggers.load(tc["architecture"])
    x = torch.as_tensor(batch["src_tokens"], device=device).to(dtype)
    tags = torch.as_tensor(batch["tgt_tokens"], device=device).to(dtype)
    lengths = [int(n) for n in batch["src_lengths"]]
    rows = [b for b, n in enumerate(lengths) if n > 0]
    if keep_rows is not None:
        rows = rows[:keep_rows]
    logits = arch.logits(params, x[rows], [lengths[b] for b in rows], tc)
    total = x.new_zeros(())
    for j, b in enumerate(rows):
        n = lengths[b]
        total = total + focal_loss(logits[j, :n], tags[b, :n], tc["alpha"], tc["gamma"])
    return total / max(sum(lengths[b] for b in rows), 1)


def first_steps(tc: dict, params: dict, batches: List[dict], valid: List[dict], lr: float,
                device, keep_rows=None, dtype=torch.float32) -> dict:
    """Adam steps over `batches` from `params` (JAX layout), computed in
    `dtype`, and after each the validation loss (the mean of the `valid`
    batches' losses, weighted by their real documents) -> {"losses": [...],
    "val_losses": [...], "grad1": {leaf: first gradient}, "end": {leaf: after
    the last step}}, leaves on the CPU."""
    flat = {k: v.detach().to(device, dtype).clone().requires_grad_(True)
            for k, v in leaves(params).items()}
    m = {k: torch.zeros_like(v) for k, v in flat.items()}
    s = {k: torch.zeros_like(v) for k, v in flat.items()}
    losses, val_losses, grad1 = [], [], None
    weights = [b.get("n_real", len(b["src_lengths"])) for b in valid]
    b1, b2 = BETAS
    for t, batch in enumerate(batches, start=1):
        loss = batch_loss(tc, _rebuild(params, flat), batch, device, keep_rows, dtype)
        grads = torch.autograd.grad(loss, list(flat.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for (k, p), g_ in zip(flat.items(), grads):
                if t == 1:
                    grad1 = grad1 or {}
                    grad1[k] = g_.detach().cpu().clone()
                m[k].mul_(b1).add_(g_, alpha=1 - b1)
                s[k].mul_(b2).addcmul_(g_, g_, value=1 - b2)
                denom = (s[k] / (1 - b2 ** t)).sqrt() + EPS
                p.sub_(lr * (m[k] / (1 - b1 ** t)) / denom)
            if valid:
                per_batch = [float(batch_loss(tc, _rebuild(params, flat), v, device, None, dtype))
                             for v in valid]
                val_losses.append(float(np.average(per_batch, weights=weights)))
    return {"losses": losses, "val_losses": val_losses, "grad1": grad1,
            "end": {k: v.detach().cpu().clone() for k, v in flat.items()}}
