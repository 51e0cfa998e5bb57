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

A mesh of n ranks with `model_parallel` m is JAX's grid
`ranks.reshape(n // m, m)`: global rank r sits at data r // m, model r % m.
Each rank holds two subgroups, `group` (its data group: the ranks that
share its model coordinate) and `model_group` (those that share its data
coordinate). `index` and `size` are the "data" coordinate and size, so that
everything that splits documents, gathers results or reduces data-parallel
gradients runs over `group` as it does with m = 1. The "model" axis is
tensor parallelism (parallel/tensor.py): `param_spec` / `shard_spec` say
which axis of a parameter is split over it, `shard_of` takes this rank's
slice.
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

# bytes copied to the host by staged collectives; collectives over "model"
stats = {"staged_bytes": 0, "model_all_gathers": 0, "model_all_reduces": 0}
_STATE = {"device": None}


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
    """A ("data", "model") grid of ranks. `group` / `ranks` are this rank's
    data group and its global ranks in data order; `model_group` /
    `model_ranks` its model group in model order (empty with model 1);
    `mesh_group` every rank of the mesh (None: the default group or, with
    model 1, `group`). `index` is this rank's "data" coordinate."""

    group: object
    ranks: tuple
    device: torch.device
    backend: str
    model_group: object = None
    model_ranks: tuple = ()
    mesh_group: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def model_size(self) -> int:
        return max(len(self.model_ranks), 1)

    @property
    def n_ranks(self) -> int:
        return self.size * self.model_size

    @property
    def shape(self) -> dict:
        return {"data": self.size, "model": self.model_size}

    @property
    def index(self) -> int:
        return self.ranks.index(global_rank())

    @property
    def model_index(self) -> int:
        return self.model_ranks.index(global_rank()) if self.model_ranks else 0

    @property
    def is_first(self) -> bool:
        """Mesh position (0, 0): the rank that writes."""
        return self.index == 0 and self.model_index == 0

    def barrier(self):
        """Wait for every rank of the mesh."""
        group = self.mesh_group if self.model_ranks else self.group
        if self.backend == "nccl":
            dist.barrier(group=group, device_ids=[self.device.index])
        else:
            dist.barrier(group=group)


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1) -> Optional[Mesh]:
    """("data", "model") mesh over the first n ranks (default: all) of the
    initialised default group, laid out as JAX lays out its devices: rank r
    at data r // model_parallel, model r % model_parallel. Every rank must
    call it (new subgroups are collective); a rank outside the first n gets
    None. n must divide by model_parallel."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call parallel.mesh.init_process_group or "
                           "parallel.multihost.initialize first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    m = int(model_parallel)
    if m < 1 or n % m != 0:
        raise ValueError(f"model_parallel={m} does not divide a mesh of {n} ranks")
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks needs that many, have {world}")
    device = _STATE["device"] or rank_device("cuda")
    me = global_rank()
    mesh_group = None if n == world else dist.new_group(list(range(n)))
    if m == 1:
        if me >= n:
            return None
        return Mesh(mesh_group, tuple(range(n)), device, dist.get_backend(mesh_group))
    grid = np.arange(n).reshape(n // m, m)
    # every rank creates every subgroup, in one order
    data_groups = [(tuple(col), dist.new_group(col.tolist())) for col in grid.T]
    model_groups = [(tuple(row), dist.new_group(row.tolist())) for row in grid]
    if me >= n:
        return None
    ranks, group = data_groups[me % m]
    model_ranks, model_group = model_groups[me // m]
    return Mesh(group, tuple(int(r) for r in ranks), device, dist.get_backend(mesh_group),
                model_group, tuple(int(r) for r in model_ranks), mesh_group)


def param_spec(path: str) -> tuple:
    """The JAX partition rule of a tagger parameter, by its tree path, as a
    tuple of axis names per dimension (() = replicated): gate-stacked
    recurrent weights w_ih/w_hh [in, G*H] shard the gate axis over "model",
    biases [G*H] (and every linear's b [out]) too, linear weights w [in, out]
    their input axis."""
    leaf = path.split("/")[-1]
    if leaf in ("w_ih", "w_hh"):
        return (None, "model")
    if leaf in ("b", "b_ih", "b_hh"):
        return ("model",)
    if leaf == "w":
        return ("model", None)
    return ()


def shard_spec(path: str, shape, mesh: Mesh) -> tuple:
    """`param_spec` for one leaf of `shape` on `mesh`, replicated (()) when
    a sharded axis does not divide by its mesh size (JAX's
    `param_shardings`)."""
    spec = param_spec(path)
    for dim, name in enumerate(spec):
        if name is not None and shape[dim] % mesh.shape[name] != 0:
            return ()
    return spec


def shard_of(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of x under `spec` (a view): each dimension named
    "model" is split into model_size equal parts, the model_index-th kept."""
    for dim, name in enumerate(spec):
        if name == "model":
            part = x.shape[dim] // mesh.model_size
            x = x.narrow(dim, mesh.model_index * part, part)
    return x


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


def axis_group(mesh: Mesh, axis: str):
    """The subgroup of this rank along a mesh axis ("data" or "model")."""
    if axis == "data":
        return mesh.group
    if axis == "model":
        return mesh.model_group
    raise ValueError(f"no mesh axis {axis!r}")


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        y = x.clone()
        if axis == "model":
            stats["model_all_reduces"] += 1
        dist.all_reduce(y, group=axis_group(mesh, axis))
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """Sum over the ranks of this rank's `axis` group ("data": the mesh's
    ranks with model 1), on every one of them.

    Autograd: the identity. The result is consumed in full by every rank
    (a replicated loss, each rank holding the same objective), so each
    rank's input gets that rank's cotangent as it is; summing the cotangents
    again, as `torch.distributed.nn.functional.all_reduce` does, would count
    the objective once per rank."""
    return _AllReduceSum.apply(x, mesh, axis)


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
