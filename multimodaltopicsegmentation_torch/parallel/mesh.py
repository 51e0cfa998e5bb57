"""Process groups, the ("data", "model") shape and the communication ops
(counterpart of the JAX package's parallel/mesh.py).

JAX runs its parallel modes as one SPMD program over a device mesh. The
port runs one process per rank, started by `torchrun` or by
`torch.multiprocessing.spawn`. A `Mesh` is a process group (every rank, or
the first n) with the ("data", "model") shape, this rank's coordinates and
its device: `cuda:{local_rank % device_count}`, or `cpu` when the caller
asks for it.

The backend rule, printed by `init_process_group` and never retried: NCCL
when the ranks run on cuda and each has a card of its own (world_size <=
torch.cuda.device_count()), gloo otherwise (CPU ranks; several ranks on one
card). A failed initialisation raises. Under gloo, CUDA tensors go through
`all_reduce` and `broadcast` as they are; `ppermute` and `all_gather` copy
them to host memory, run the transfer and copy the result back inside the
op (`stats["staged_bytes"]` counts what they copy out), so the compute never
leaves the card.

Tensor parallelism over "model" is not ported: `model_parallel > 1` raises.
cuDNN's `nn.LSTM` takes W_hh whole, so the gate-sharded W_hh that JAX's
`param_spec` describes has no place in the port's recurrent stacks.
`param_spec` keeps the rule for that later work.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.torch_setup import resolve_device

stats = {"staged_bytes": 0}
_STATE = {"device": None}

TP_REASON = ("model_parallel > 1 (tensor parallelism over 'model') is not ported: cuDNN's "
             "nn.LSTM takes W_hh whole, so a gate-sharded W_hh has no place in the port's "
             "recurrent stacks (ROADMAP.md section 1 item 14)")


def backend_for(world_size: int, device) -> str:
    """NCCL when the ranks run on cuda and each has a card of its own, else gloo."""
    dev = torch.device(device)
    if dev.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device="cuda", local_rank: Optional[int] = None) -> torch.device:
    """This rank's device: `cuda:{local_rank % device_count}`, or the CPU
    when `device` is cpu. Raises if cuda is asked for and absent."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_process_group(rank: int, world_size: int, init_method: str, device="cuda",
                       local_rank: Optional[int] = None) -> torch.device:
    """Join the default process group with the backend of `backend_for`,
    printed on stderr. -> this rank's device. Raises on failure."""
    dev = rank_device(device, rank if local_rank is None else local_rank)
    backend = backend_for(world_size, dev)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"[parallel] rank {rank} of {world_size}: backend {backend} (device {dev}, "
          f"{cards} card(s) visible)", file=sys.stderr, flush=True)
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            **kwargs)
    _STATE["device"] = dev
    return dev


def world_size() -> int:
    """Ranks in the default group; 1 when no group was initialised."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def global_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def barrier():
    """Wait for every rank of the default group (nothing without one)."""
    if world_size() > 1:
        dev = _STATE["device"]
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[dev.index])
        else:
            dist.barrier()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group with the ("data", "model") shape ("model" is 1: see
    the module's docstring). `ranks` are the global ranks in mesh order;
    `index` is this rank's place among them, its "data" coordinate."""

    group: object
    ranks: tuple
    device: torch.device
    backend: str

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def shape(self) -> dict:
        return {"data": self.size, "model": 1}

    @property
    def index(self) -> int:
        return self.ranks.index(global_rank())

    @property
    def is_first(self) -> bool:
        return self.index == 0

    def barrier(self):
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1) -> Optional[Mesh]:
    """("data", "model") mesh over the first n ranks (default: all) of the
    initialised default group. Every rank must call it (a smaller mesh makes
    a subgroup); a rank outside the first n gets None."""
    if model_parallel != 1:
        raise NotImplementedError(TP_REASON)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call parallel.mesh.init_process_group or "
                           "parallel.multihost.initialize first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks needs that many, have {world}")
    group = None if n == world else dist.new_group(list(range(n)))
    if global_rank() >= n:
        return None
    device = _STATE["device"] or rank_device("cuda")
    return Mesh(group, tuple(range(n)), device, dist.get_backend(group))


def param_spec(path: str) -> tuple:
    """The JAX partition rule of a tagger parameter, by its tree path, as a
    tuple of axis names per dimension (() = replicated): gate-stacked
    recurrent weights w_ih/w_hh [in, 4H] shard the gate axis over "model",
    biases [4H] too, linear heads their input axis. Kept for the tensor-
    parallel work; nothing in the port shards by it yet."""
    leaf = path.split("/")[-1]
    if leaf in ("w_ih", "w_hh"):
        return (None, "model")
    if leaf in ("b", "b_ih", "b_hh"):
        return ("model",)
    if leaf == "w":
        return ("model", None)
    return ()


# -- batches ------------------------------------------------------------------

_BATCH_KEYS = ("src_tokens", "tgt_tokens", "src_lengths", "domain", "src_tokens2")


def pad_batch_axis(batch: dict, multiple: int) -> dict:
    """Pad the document axis to a multiple with zero-length documents (tag
    -1, length 0, zero features), which every loss ignores; `n_real` keeps
    the real count (the JAX Trainer's `_pad_batch_axis`)."""
    B = len(batch["src_lengths"])
    pad = (-B) % multiple
    if pad == 0:
        return batch
    out = dict(batch)
    for key in _BATCH_KEYS:
        if key in batch and hasattr(batch[key], "shape"):
            arr = np.asarray(batch[key])
            widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
            out[key] = np.pad(arr, widths, constant_values=-1.0 if key == "tgt_tokens" else 0)
    out["n_real"] = batch.get("n_real", B)
    return out


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's share of a global batch: the document axis padded to a
    multiple of the "data" size, then split by the data coordinate. `n_real`
    is the number of real documents in the share. A batch that
    `multihost.global_batch` made is already this rank's share."""
    if batch.get("sharded"):
        return batch
    n = mesh.shape["data"]
    padded = pad_batch_axis(batch, n)
    B = len(padded["src_lengths"])
    per = B // n
    lo = mesh.index * per
    out = {k: v for k, v in padded.items() if k not in _BATCH_KEYS and k != "ids"}
    for key in _BATCH_KEYS:
        if key in padded and hasattr(padded[key], "shape"):
            out[key] = np.asarray(padded[key])[lo:lo + per]
    if "ids" in batch:
        out["ids"] = list(batch["ids"])[lo:lo + per]
    out["n_real"] = int(np.clip(batch.get("n_real", len(batch["src_lengths"])) - lo, 0, per))
    out["sharded"] = True
    return out


# -- communication ------------------------------------------------------------

def _staged(t: torch.Tensor, mesh: Mesh) -> bool:
    return mesh.backend == "gloo" and t.device.type == "cuda"


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        y = x.clone()
        dist.all_reduce(y, group=mesh.group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over the mesh's ranks, on every rank.

    Autograd: the identity. The result is consumed in full by every rank
    (a replicated loss, each rank holding the same objective), so each
    rank's input gets that rank's cotangent as it is; summing the cotangents
    again, as `torch.distributed.nn.functional.all_reduce` does, would count
    the objective once per rank."""
    return _AllReduceSum.apply(x, mesh)


def _exchange(sends, recvs, mesh: Mesh) -> list:
    """Point-to-point in one batch: sends [(tensor, mesh index)], recvs
    [(template, mesh index)] -> the received tensors, shaped and placed like
    their templates."""
    bufs, ops = [], []
    for x, dst in sends:
        buf = x.detach().contiguous()
        if _staged(buf, mesh):
            buf = buf.cpu()
            stats["staged_bytes"] += buf.numel() * buf.element_size()
        ops.append(dist.P2POp(dist.isend, buf, mesh.ranks[dst], mesh.group))
    for like, src in recvs:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if _staged(like, mesh) else like.device)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, mesh.ranks[src], mesh.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [buf.to(like.device) for buf, (like, _) in zip(bufs, recvs)]


def _permute(x, pairs, mesh):
    me = mesh.index
    srcs = [s for s, d in pairs if d == me]
    if len(srcs) > 1:
        raise ValueError(f"ppermute pairs {pairs} send twice to mesh index {me}")
    got = _exchange([(x, d) for s, d in pairs if s == me], [(x, s) for s in srcs], mesh)
    return got[0] if got else torch.zeros_like(x)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pairs, mesh):
        ctx.pairs, ctx.mesh = pairs, mesh
        return _permute(x, pairs, mesh)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, [(d, s) for s, d in ctx.pairs], ctx.mesh), None, None


def ppermute(x: torch.Tensor, pairs, mesh: Mesh) -> torch.Tensor:
    """`lax.ppermute`: mesh index s sends x to d for each (s, d) in `pairs`;
    a rank that receives nothing gets zeros. Every rank named in `pairs`
    calls it with an x of the same shape and dtype (a receiver's values are
    not read).

    Autograd: the cotangent takes the reverse permutation, (d, s) for each
    (s, d); a rank that sent nothing gets a zero gradient."""
    return _PPermute.apply(x, [tuple(p) for p in pairs], mesh)


@torch.no_grad()
def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[n, *x.shape]: every rank's x in mesh order, on every rank (x of one
    shape on all ranks). No gradient: decode results and shapes only."""
    src = x.contiguous()
    if _staged(src, mesh):
        src = src.cpu()
        stats["staged_bytes"] += src.numel() * src.element_size()
    out = torch.empty((mesh.size, *src.shape), dtype=src.dtype, device=src.device)
    if mesh.backend == "nccl":
        dist.all_gather_into_tensor(out, src, group=mesh.group)
    else:
        dist.all_gather(list(out.unbind(0)), src, group=mesh.group)
    return out.to(x.device)


def gather_object(obj, mesh: Mesh, dst: int = 0):
    """Every rank's picklable `obj`, in mesh order, on mesh index `dst`
    (None elsewhere)."""
    out = [None] * mesh.size if mesh.index == dst else None
    dist.gather_object(obj, out, dst=mesh.ranks[dst], group=mesh.group)
    return out


def all_gather_object(obj, mesh: Mesh) -> list:
    """Every rank's picklable `obj`, in mesh order, on every rank."""
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def broadcast_object(obj, mesh: Mesh, src: int = 0):
    """Mesh index `src`'s picklable `obj`, on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=mesh.ranks[src], group=mesh.group)
    return box[0]


def broadcast_(x: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Mesh index `src`'s x, in place on every rank."""
    dist.broadcast(x, src=mesh.ranks[src], group=mesh.group)
    return x
