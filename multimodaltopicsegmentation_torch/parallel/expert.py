"""Expert parallelism for the domain-adaptive tagger (counterpart of the JAX
package's parallel/expert.py).

SwitchBiLSTM with switch='lstm' holds two recurrent towers and picks one
per document by its domain flag (1 takes the first). The dense tagger runs
both towers on the whole batch. Here each of the N_EXPERTS = 2 ranks runs
one tower: expert 0 is `rnn1` (the port's `model_1`, selected where the
domain is 1), expert 1 `rnn2`. Each masks out the documents of the other
expert and `mesh.all_reduce_sum` combines them: x + 0 is x, so the combined
states equal the dense selection to the bit. Every rank then runs the head
and the loss on the combined states.

Gradients: the combine's backward is the identity (the loss after it is
the same on every rank, and counted once), so a tower's gradient lands on
its own rank only; the head's is the same on every rank. The train step
sums the towers' gradients over the ranks and takes the head's from index 0
(parallel/train_step.py).

`split_towers` / `join_towers` carry the JAX package's SwitchBiLSTM
parameters (numpy) into the two towers and back.
"""
from __future__ import annotations

import torch

from ..models.base import head_decode, head_loss
from ..models.taggers import _apply
from . import mesh as mesh_lib

N_EXPERTS = 2  # the reference's domain flag is binary


def _check(model, mesh):
    if model.cfg.switch != "lstm":
        raise ValueError(
            f"expert sharding applies to switch='lstm' towers, got {model.cfg.switch!r}")
    if mesh.size != N_EXPERTS:
        raise ValueError(f"expert sharding runs on {N_EXPERTS} ranks, the mesh has {mesh.size}")


def expert_sharded_switch_scores(mesh, model, x, lengths, domains, train: bool = False,
                                 generator=None) -> torch.Tensor:
    """SwitchBiLSTM.scores with the two LSTM towers one per rank -> logits
    [B, L, C], the same on every rank."""
    _check(model, mesh)
    tower = model.model_1 if mesh.index == 0 else model.model_2
    h = _apply(tower, model.cfg, x, lengths, train, generator)
    dom = domains.to(x.device).to(x.dtype)
    sel = dom if mesh.index == 0 else 1.0 - dom
    return model.classification(mesh_lib.all_reduce_sum(h * sel[:, None, None], mesh))


def expert_sharded_switch_loss(mesh, model, x, lengths, tags, domains, train: bool = True,
                               generator=None) -> torch.Tensor:
    """The batch's head loss through the sharded towers (on every rank)."""
    logits = expert_sharded_switch_scores(mesh, model, x, lengths, domains, train, generator)
    return head_loss(model.cfg, logits, lengths, tags)


@torch.no_grad()
def expert_sharded_switch_decode(mesh, model, x, lengths, domains, threshold: float):
    logits = expert_sharded_switch_scores(mesh, model, x, lengths, domains)
    return logits, head_decode(model.cfg, logits, threshold)


def split_towers(params: dict):
    """A JAX SwitchBiLSTM('lstm') pytree -> ([tower of expert 0, tower of
    expert 1], the shared head {"cls": ...})."""
    return [params["rnn1"], params["rnn2"]], {"cls": params["cls"]}


def join_towers(towers, shared: dict) -> dict:
    """Inverse of `split_towers`."""
    return {"rnn1": towers[0], "rnn2": towers[1], **shared}
