"""Pipeline parallelism (GPipe microbatching) for the Transformer's encoder
stack (counterpart of the JAX package's parallel/pipeline.py).

The `BertStyleEncoder` layers split into S contiguous stages, one per rank
of the mesh; each stage keeps its own pyramidal windows (the layers' global
indices). A batch splits into M microbatches. The schedule is written by
hand, as JAX's `jax.grad` through its `lax.scan` clock is not available:

- forward: stage 0 runs the embedding sublayer and its layers on each
  microbatch in turn and sends the activations, with the microbatch's mask
  beside them as one extra feature column, to stage 1; every later stage
  receives, runs its layers and sends on; the last stage keeps its outputs,
  runs the head on all of them and takes the head loss of the whole batch;
- backward: the last stage's backward gives its gradients and those of its
  received inputs, which go back to the stage before in reverse microbatch
  order; each earlier stage runs the backward of microbatch m from the
  gradient it receives and sends its input's gradient on.

Transfers are `mesh.ppermute` between neighbours (staged through host
memory under gloo on a card). `torch.distributed.pipelining` hands CUDA
tensors to gloo as they are, which fails with several ranks on one card, so
it is not used. A rank's gradients are those of the parameters its stage
runs (the embedding sublayer on stage 0, the head on the last stage); the
train step sums them over the ranks (parallel/train_step.py), which keeps
every rank's copy of the whole tagger in step. Dropout draws from each
rank's own generator.
"""
from __future__ import annotations

import torch

from ..models.base import head_loss
from ..ops.masks import length_mask
from . import mesh as mesh_lib


def stage_layers(n_layers: int, n_stages: int, stage: int) -> range:
    """The encoder layers of one stage: a contiguous run of n_layers / S."""
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split over {n_stages} stages")
    K = n_layers // n_stages
    return range(stage * K, (stage + 1) * K)


def _send(x, pairs, mesh):
    with torch.no_grad():
        mesh_lib.ppermute(x, pairs, mesh)


def _recv(shape, like, pairs, mesh):
    with torch.no_grad():
        return mesh_lib.ppermute(like.new_empty(shape), pairs, mesh)


def _forward(mesh, segmenter, x, lengths, n_micro: int, train: bool, generator,
             backward: bool = False):
    """The forward schedule -> (inputs received per microbatch, outputs per
    microbatch) on this stage; with `backward` the received inputs take a
    gradient."""
    enc = segmenter.model.model
    S, s = mesh.size, mesh.index
    B, L, D = x.shape
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} microbatches")
    mb = B // n_micro
    layers = stage_layers(len(enc.encoder.layer), S, s)
    mask = length_mask(lengths.to(x.device), L, x.dtype)
    ins, outs = [], []
    for m in range(n_micro):
        rows = slice(m * mb, (m + 1) * mb)
        if s == 0:
            h_in, m_mb = None, mask[rows]
            h = enc.embed(x[rows], train, generator)
        else:
            packed = _recv((mb, L, D + 1), x, [(s - 1, s)], mesh)
            h_in = packed[..., :D].clone().requires_grad_(backward)
            h, m_mb = h_in, packed[..., D]
        h = enc.run_layers(h, m_mb, layers, train, generator)
        if s < S - 1:
            _send(torch.cat([h.detach(), m_mb[..., None]], dim=-1), [(s, s + 1)], mesh)
        ins.append(h_in)
        outs.append(h)
    return ins, outs


def pipeline_transformer_loss(mesh, segmenter, x, lengths, tags, n_micro: int, generator=None,
                              train: bool = True, backward: bool = True) -> torch.Tensor:
    """The head loss of the batch through the pipelined encoder: -> this
    rank's part (the loss on the last stage, 0 elsewhere). With `backward`,
    the reverse schedule runs too and each stage's gradients are left in its
    parameters' `.grad`. Every rank of the mesh calls it with the same batch."""
    S, s = mesh.size, mesh.index
    ins, outs = _forward(mesh, segmenter, x, lengths, n_micro, train, generator, backward)
    if s == S - 1:
        logits = segmenter.classification(torch.cat(outs))
        part = head_loss(segmenter.cfg, logits, lengths, tags)
    else:
        part = x.new_zeros(())
    if not backward:
        return part.detach()
    if s == S - 1:
        part.backward()
    B, L, D = x.shape
    mb = B // n_micro
    for m in reversed(range(n_micro)):
        if s < S - 1:
            grad = _recv((mb, L, D), x, [(s + 1, s)], mesh)
            torch.autograd.backward(outs[m], grad)
        if s > 0:
            _send(ins[m].grad, [(s, s - 1)], mesh)
    return part.detach()


@torch.no_grad()
def pipeline_transformer_scores(mesh, segmenter, x, lengths, n_micro: int) -> torch.Tensor:
    """`TransformerSegmenter.scores` with the encoder pipelined: -> logits
    [B, L, C] on every rank (the last stage's, broadcast)."""
    _, outs = _forward(mesh, segmenter, x, lengths, n_micro, False, None)
    if mesh.index == mesh.size - 1:
        logits = segmenter.classification(torch.cat(outs)).contiguous()
    else:
        C = segmenter.classification.out_features
        logits = x.new_empty((x.shape[0], x.shape[1], C))
    return mesh_lib.broadcast_(logits, mesh, src=mesh.size - 1)
