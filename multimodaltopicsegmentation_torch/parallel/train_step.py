"""Training steps and the decode of the parallel modes (counterpart of the
JAX package's parallel/train_step.py).

Every mode computes, on each rank, a part of the batch's loss such that the
parts add up to the loss over the ranks, and gradients whose sum over the
ranks is the gradient of that loss. The step then all-reduces the
gradients once (one flat buffer, a sum), clips them by the global norm and
steps the port's `loop.Optimizer`, so that every rank steps the same
replicated state:

- data parallelism over "data" (`make_sharded_train_step`): each rank's part
  is its share's masked sum over the batch's count, which `global_counts`
  sums over the ranks before any rank divides (a rank's local mean is not
  its share of the loss). With a "model" axis the tagger is sharded over it
  (parallel/tensor.py): the model ranks of a data coordinate compute one
  replicated loss, the gradients are summed over the data group only (a
  shard's gradient stays on its model rank, a replicated one is already
  the same on every model rank), and clipping takes the norm of the whole
  tree (the shards' squares summed over the model group, each replicated
  parameter counted once);
- the sequence-parallel step (parallel/sequence.py) is the same with the
  unit axis split instead of the documents;
- the pipeline (`make_pipeline_train_step`): the last stage's loss, zero
  elsewhere; a rank's gradients are those of the parameters its stage runs;
- expert parallelism (parallel/expert.py): the loss is computed on every
  rank from the combined towers, the part is index 0's; a tower's gradient
  lives on its rank, and the head's, the same on every rank, is taken from
  index 0 (`replicated`).
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch
import torch.distributed as dist

from ..ops import losses as losses_lib
from ..train.loop import clip_by_global_norm_, tagger_loss
from . import mesh as mesh_lib
from . import tensor as tensor_lib


def count_reducer(mesh) -> Callable:
    """For `ops.losses.global_counts`: a count summed over the data group."""
    def reduce(count):
        out = count.clone()
        dist.all_reduce(out, group=mesh.group)
        return out
    return reduce


def all_reduce_grads(params: Iterable[torch.nn.Parameter], mesh, replicated=()) -> None:
    """Sum each parameter's gradient over the data group in one flat buffer
    (a rank that did not touch a parameter adds zeros); the gradients of
    `replicated` parameters, computed alike on every rank, are data index
    0's instead."""
    replicated = {id(p) for p in replicated}
    summed = [p for p in params if id(p) not in replicated]
    copied = [p for p in params if id(p) in replicated]
    for group, reduce in ((summed, lambda b: dist.all_reduce(b, group=mesh.group)),
                          (copied, lambda b: mesh_lib.broadcast_(b, mesh))):
        if not group:
            continue
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in group])
        reduce(flat)
        offset = 0
        for p in group:
            n = p.numel()
            p.grad = flat[offset:offset + n].view_as(p).clone()
            offset += n


def sharded_square_norm(mesh, sharded) -> Callable:
    """square_norm(params) for `clip_by_global_norm_`: the squares of the
    `sharded` parameters' gradients summed over the model group, plus those
    of the others (replicated on every model rank), once."""
    ids = {id(p) for p in sharded}

    def square_norm(params):
        grads = [p for p in params if p.grad is not None]
        own = sum((p.grad * p.grad).sum() for p in grads if id(p) in ids)
        rest = sum((p.grad * p.grad).sum() for p in grads if id(p) not in ids)
        own = torch.as_tensor(own, dtype=torch.float32, device=mesh.device).clone()
        mesh_lib.stats["model_all_reduces"] += 1
        dist.all_reduce(own, group=mesh.model_group)
        return own + rest

    return square_norm


def make_train_step(part_and_backward: Callable, params, optimizer, mesh, clip: float = 0.0,
                    replicated=(), sharded=()) -> Callable:
    """step(batch, generator) -> the batch's loss (detached, on the device,
    the same on every rank). `part_and_backward(batch, generator)` leaves
    this rank's gradients in `.grad` and returns its part of the loss;
    `sharded` are the parameters held in shards over "model"."""
    params = list(params)
    square_norm = sharded_square_norm(mesh, sharded) if sharded else None

    def step(batch, generator):
        optimizer.zero_grad(set_to_none=True)
        part = part_and_backward(batch, generator)
        all_reduce_grads(params, mesh, replicated)
        if clip and clip > 0:
            clip_by_global_norm_(params, clip, square_norm)
        optimizer.step()
        return mesh_lib.all_reduce_sum(part.detach(), mesh)

    return step


def share_loss(loss_of: Callable, mesh) -> Callable:
    """part(batch, generator): loss_of on this rank's share, its masked
    means taken over the count of the whole batch (all ranks' shares)."""
    def part(batch, generator):
        with losses_lib.global_counts(count_reducer(mesh)):
            return loss_of(batch, generator)
    return part


def make_sharded_train_step(tagger, optimizer, mesh, extra_kind: str = "",
                            clip: float = 0.0) -> Callable:
    """Data parallelism over "data", tensor parallelism over "model":
    step(share, generator) on this rank's share of the batch
    (`mesh.shard_batch`) -> the batch's loss. With a "model" axis the tagger
    must be sharded (`parallel.tensor.tensor_parallel`) before its optimizer
    is built over its parameters."""
    if mesh.model_size > 1 and getattr(tagger, "tp_mesh", None) is not mesh:
        raise ValueError("a 'model' mesh axis needs the tagger sharded over it: call "
                         "parallel.tensor.tensor_parallel(tagger, mesh) before building its "
                         "optimizer")
    part = share_loss(tagger_loss(tagger, extra_kind), mesh)

    def part_and_backward(batch, generator):
        loss = part(batch, generator)
        loss.backward()
        return loss

    return make_train_step(part_and_backward, tagger.parameters(), optimizer, mesh, clip,
                           sharded=tensor_lib.sharded_parameters(tagger))


def make_pipeline_train_step(segmenter, optimizer, mesh, clip: float = 0.0) -> Callable:
    """The Transformer's layers pipelined over the mesh's ranks
    (parallel/pipeline.py), one microbatch per document:
    step(batch, generator) on the whole batch -> its loss."""
    from .pipeline import pipeline_transformer_loss

    def part_and_backward(batch, generator):
        return pipeline_transformer_loss(
            mesh, segmenter, batch["src_tokens"], batch["src_lengths"], batch["tgt_tokens"],
            int(batch["src_tokens"].shape[0]), generator=generator, backward=True)

    return make_train_step(part_and_backward, segmenter.parameters(), optimizer, mesh, clip)


def make_sharded_decode(tagger, mesh, threshold: float = 0.5) -> Callable:
    """Documents over "data", the tagger over "model": decode(batch) ->
    (scores, tags) of the whole batch as tensors on every rank (mesh
    position (0, 0) writes them); each data coordinate's model group decodes
    its share (`mesh.shard_batch`) once, replicated, and the shares are
    gathered over the data group. A tagger that is not sharded yet is
    sharded here (`parallel.tensor.tensor_parallel`, in place)."""
    tensor_lib.tensor_parallel(tagger, mesh)

    def decode(batch):
        share = mesh_lib.shard_batch(mesh, batch)
        x = torch.as_tensor(share["src_tokens"]).to(mesh.device)
        lengths = torch.as_tensor(share["src_lengths"]).to(mesh.device)
        with torch.inference_mode():
            scores, tags = tagger.decode(x, lengths, threshold)
        B = len(batch["src_lengths"])
        scores = mesh_lib.all_gather(scores.contiguous(), mesh)
        tags = mesh_lib.all_gather(tags.to(torch.uint8), mesh)
        return (scores.reshape(-1, *scores.shape[2:])[:B],
                tags.reshape(-1, *tags.shape[2:])[:B].bool())

    return decode
