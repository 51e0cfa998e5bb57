"""Sequence (context) parallelism for local attention (counterpart of the
JAX package's parallel/sequence.py).

Attention is local (|i - j| <= window/2), so the unit axis shards over the
ranks with one halo exchange per layer: each rank holds L/n units of every
document and runs the whole stack on its slice; before attending it
receives the last window/2 keys and values of the rank on its left and the
first window/2 of the rank on its right, attends on [halo | shard | halo]
and keeps the centre. The positional rows are sliced at the shard's global
start.

The exchange runs along a line, not a ring: the first rank has no left halo
and the last no right one. A key is then valid iff its global position lies
below the document's length, which is a prefix of every rank's extended
window: its length is clamp(length - window start, 0, window length). The
flash kernels (K2 forward, K4/K3 backward) take prefix masks only
(`ops/flash_attention._lengths` sums the mask); JAX's ring, with the wrapped
halos zeroed, is no prefix on the first rank.

Gradients: the halo exchange's backward sends each halo's cotangent back to
the rank it came from, which adds it into its edge rows. Each rank's loss
is its slice's masked sum over the batch's count (`ops.losses.global_counts`
over the mesh); its parameter gradients are those of that part, and the
train step sums them over the ranks once (parallel/train_step.py), as the
shard_map transpose psums them in JAX. Dropout draws from each rank's own
generator; the halo attention skips attention-probs dropout, as in JAX.
"""
from __future__ import annotations

import torch

from ..models.base import head_decode, head_loss
from ..ops import losses as losses_lib
from ..ops.attention import local_attention, merge_heads, split_heads
from . import mesh as mesh_lib
from .train_step import count_reducer


class _HaloExchange(torch.autograd.Function):
    """x [..., Ls, F] (units on dim -2) -> (left halo, right halo): the last
    `halo` rows of the rank on the left (none on the first rank) and the
    first `halo` rows of the rank on the right (none on the last)."""

    @staticmethod
    def forward(ctx, x, halo, mesh):
        ctx.halo, ctx.mesh, ctx.shard_len = halo, mesh, x.shape[-2]
        i, n = mesh.index, mesh.size
        sends = []
        if i > 0:
            sends.append((x[..., :halo, :], i - 1))  # its right halo
        if i < n - 1:
            sends.append((x[..., -halo:, :], i + 1))  # its left halo
        edge = x[..., :halo, :]
        recvs = ([(edge, i - 1)] if i > 0 else []) + ([(edge, i + 1)] if i < n - 1 else [])
        got = iter(mesh_lib._exchange(sends, recvs, mesh))
        empty = x[..., :0, :]
        left = next(got) if i > 0 else empty.clone()
        right = next(got) if i < n - 1 else empty.clone()
        return left, right

    @staticmethod
    def backward(ctx, g_left, g_right):
        halo, mesh = ctx.halo, ctx.mesh
        i, n = mesh.index, mesh.size
        sends = []
        if i > 0:
            sends.append((g_left, i - 1))  # the cotangent of its last rows
        if i < n - 1:
            sends.append((g_right, i + 1))  # the cotangent of its first rows
        like = g_left if i > 0 else g_right
        recvs = ([(like, i - 1)] if i > 0 else []) + ([(like, i + 1)] if i < n - 1 else [])
        got = iter(mesh_lib._exchange(sends, recvs, mesh))
        shape = list(like.shape)
        shape[-2] = ctx.shard_len
        gx = like.new_zeros(shape)
        if i > 0:
            gx[..., :halo, :] += next(got)
        if i < n - 1:
            gx[..., -halo:, :] += next(got)
        return gx, None, None


def halo_exchange(x: torch.Tensor, halo: int, mesh):
    """(left, right) halos of x [..., Ls, F] from the neighbouring ranks on
    a line; differentiable (the reverse exchange, added into the edge rows)."""
    if not 0 < halo <= x.shape[-2]:
        raise ValueError(f"halo {halo} must lie in (0, shard length {x.shape[-2]}]")
    return _HaloExchange.apply(x, halo, mesh)


def _extended_mask(lengths, start: int, left: int, ext_len: int, dtype):
    """[B, ext_len] prefix mask of the window [start - left, start - left +
    ext_len): 1 where the global position lies below the length."""
    ext_start = start - left
    prefix = (lengths.to(torch.int64) - ext_start).clamp(0, ext_len)
    return (torch.arange(ext_len, device=lengths.device)[None, :] < prefix[:, None]).to(dtype)


def sharded_local_attention(q, k, v, window: int, lengths, start: int, mesh):
    """Local attention of this rank's queries q [B, H, Ls, Dh] over its keys
    and the neighbours' halos of window/2 (k, v exchanged); lengths [B]
    global; start the shard's first global unit -> [B, H, Ls, Dh]."""
    half = window // 2
    left, right = halo_exchange(torch.stack([k, v]), half, mesh)
    nl, Ls = left.shape[-2], q.shape[2]
    k_ext = torch.cat([left[0], k, right[0]], dim=2)
    v_ext = torch.cat([left[1], v, right[1]], dim=2)
    # halo query rows are placeholders: only the centre is kept
    q_ext = torch.cat([q.new_zeros(*q.shape[:2], nl, q.shape[3]), q,
                       q.new_zeros(*q.shape[:2], right.shape[-2], q.shape[3])], dim=2)
    m_ext = _extended_mask(lengths, start, nl, k_ext.shape[2], q.dtype)
    out = local_attention(q_ext, k_ext, v_ext, window, m_ext)
    return out[:, :, nl:nl + Ls]


def _check(segmenter, L: int, n: int):
    enc = segmenter.model.model
    if L % n:
        raise ValueError(f"{L} units do not split over {n} sequence shards")
    if not enc.windows:
        raise ValueError("sequence sharding needs LOCAL attention")
    if max(enc.windows) // 2 > L // n:
        raise ValueError(f"widest window {max(enc.windows)} exceeds shard length {L // n}")
    return enc


def sequence_sharded_transformer_scores(mesh, segmenter, x, lengths, train: bool = False,
                                        generator=None) -> torch.Tensor:
    """This rank's logits [B, L/n, C]: units [i L/n, (i + 1) L/n) of the
    global x [B, L, D] (L divisible by the mesh size, the widest window/2
    at most L/n), through the whole stack with a halo exchange per layer.
    Every rank of the mesh calls it with the same global batch."""
    n = mesh.size
    B, L, _ = x.shape
    enc = _check(segmenter, L, n)
    Ls = L // n
    start = mesh.index * Ls
    lengths = lengths.to(x.device)

    def attend(att, h, mask, window):
        q = split_heads(att.query(h), enc.nheads)
        k = split_heads(att.key(h), enc.nheads)
        v = split_heads(att.value(h), enc.nheads)
        return merge_heads(sharded_local_attention(q, k, v, window, lengths, start, mesh))

    gpos = start + torch.arange(Ls, device=x.device)
    mask = (gpos[None, :] < lengths[:, None]).to(x.dtype)
    h = enc(x[:, start:start + Ls], lengths, train, generator, attend_fn=attend,
            pos_offset=start, mask=mask)
    return segmenter.classification(h)


def sequence_sharded_transformer_loss(mesh, segmenter, x, lengths, tags, train: bool = True,
                                      generator=None) -> torch.Tensor:
    """This rank's part of the batch's head loss: its slice's masked sum over
    the count of the whole batch. The parts add up to the loss; each rank's
    backward gives the gradient of its part."""
    L = x.shape[1]
    Ls = L // mesh.size
    start = mesh.index * Ls
    logits = sequence_sharded_transformer_scores(mesh, segmenter, x, lengths, train, generator)
    local = (lengths.to(x.device).to(torch.int64) - start).clamp(0, Ls)
    with losses_lib.global_counts(count_reducer(mesh)):
        return head_loss(segmenter.cfg, logits, local, tags[:, start:start + Ls])


@torch.no_grad()
def sequence_sharded_transformer_decode(mesh, segmenter, x, lengths, threshold: float):
    """-> (logits [B, L, C], boolean tags [B, L]) of the whole batch on every
    rank: each rank's slice, gathered."""
    logits = sequence_sharded_transformer_scores(mesh, segmenter, x, lengths)
    full = mesh_lib.all_gather(logits.contiguous(), mesh)  # [n, B, Ls, C]
    full = full.permute(1, 0, 2, 3).reshape(x.shape[0], x.shape[1], -1)
    return full, head_decode(segmenter.cfg, full, threshold)
