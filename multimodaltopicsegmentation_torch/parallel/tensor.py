"""Tensor parallelism over the mesh's "model" axis.

JAX shards a tagger's parameters by `param_shardings` (the gate axis of every
w_ih / w_hh / b_ih / b_hh, the input axis of every linear w, the output axis
of every linear b, each where it divides) and XLA inserts the collectives
that make the sharded program compute the single-device one. The port
writes those collectives out, over this rank's model group:

- `all_gather_model(x, mesh, dim)`: the model ranks' slices joined along
  dim; its backward keeps this rank's slice of the cotangent (every model
  rank computes the same replicated downstream, so nothing is summed);
- `scatter_model(x, mesh, dim)`: this rank's slice of a replicated x; its
  backward gathers the slices' cotangents;
- `reduce_grad_model(x, mesh)`: the identity, whose backward sums the
  cotangent over the model ranks (a product with this rank's gate columns
  gives only a part of its input's cotangent);
- `mesh.all_reduce_sum(x, mesh, "model")`: the row-sharded products' sums.

The modules that use them:

- `ShardedRecurrence`: JAX's scan (ops/rnn.py `bidirectional_rnn`,
  `unidirectional_rnn`) on this rank's gate columns. The input projection
  takes the rank's columns of w_ih; each step adds h @ w_hh[:, columns],
  gathers the full gates [directions, B, G*H] and runs the cell update
  replicated (a GRU gathers its input projection once and h @ w_hh + b_hh
  per step). It replaces cuDNN's stack only under a "model" axis;
- `RowShardedLinear`: all_reduce_sum(x[..., columns] @ W[:, columns]^T) + b,
  b gathered where it is sharded.

`tensor_parallel(tagger, mesh)` decides each parameter's spec by its JAX
path (the tagger's `_to_jax` converter run on tagged tensors), so that a
rank's shard is, element for element, what JAX's `param_shardings` puts on
its device, and swaps the tagger's recurrent stacks and linears for these
modules in place (a bare `nn.LSTM` is replaced by a `ShardedRecurrence` that
the tagger calls with (x, lengths) itself). State-dict names do not change;
`full_state_dict` and `full_jax_params` gather the single-device layout back
(a collective over the model group: every model rank calls them; the
tagger's own `to_jax_params` would see only this rank's shards). Every
other parameter (norms, the positional table, CRF tables, relative biases)
is replicated and receives the same gradient on every model rank.

Collectives over "model" are counted in `mesh.stats` ("model_all_gathers",
"model_all_reduces"); under gloo, a gather of CUDA tensors is staged through
host memory and counted in `stats["staged_bytes"]`, as `mesh.all_gather` is.
"""
from __future__ import annotations

import bisect

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops import rnn as rnn_lib
from ..ops.masks import length_mask, reverse_in_length
from . import mesh as mesh_lib
from .mesh import all_reduce_sum, shard_of, shard_spec, stats


# -- collectives over "model" --------------------------------------------------

def _slice(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    part = x.shape[dim] // mesh.model_size
    return x.narrow(dim, mesh.model_index * part, part).contiguous()


def _gather(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    src = x.contiguous()
    if mesh_lib._staged(src, mesh):
        src = src.cpu()
        stats["staged_bytes"] += src.numel() * src.element_size()
    buf = torch.empty((mesh.model_size, *src.shape), dtype=src.dtype, device=src.device)
    if mesh.backend == "nccl":
        dist.all_gather_into_tensor(buf, src, group=mesh.model_group)
    else:
        dist.all_gather(list(buf.unbind(0)), src, group=mesh.model_group)
    stats["model_all_gathers"] += 1
    return torch.cat(buf.to(x.device).unbind(0), dim)


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _gather(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.mesh, ctx.dim), None, None


class _ScatterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _slice(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.dim), None, None


class _ReduceGradModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        stats["model_all_reduces"] += 1
        dist.all_reduce(g, group=ctx.mesh.model_group)
        return g, None


def all_gather_model(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The model ranks' x joined along `dim`, in model order (every rank's x
    of one shape). Backward: this rank's slice of the cotangent."""
    return _GatherModel.apply(x, mesh, dim)


def scatter_model(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This rank's slice of a replicated x along `dim`. Backward: the model
    ranks' cotangents gathered along `dim`."""
    return _ScatterModel.apply(x, mesh, dim)


def reduce_grad_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """x itself. Backward: the cotangent summed over the model ranks."""
    return _ReduceGradModel.apply(x, mesh)


# -- modules -------------------------------------------------------------------

class ShardedRecurrence(nn.Module):
    """A recurrent stack on this rank's gate columns, JAX's scan step for
    step. Built from an `nn.LSTM` / `nn.GRU` (torch layout, gate rows
    i f g o / r z n) with each parameter's spec; the parameters keep their
    torch names, under `.rnn` when `nested` (an `ops.rnn.RNNStack`'s keys)."""

    def __init__(self, rnn: nn.RNNBase, mesh, specs: dict, nested: bool):
        super().__init__()
        self.mesh = mesh
        self.lstm = isinstance(rnn, nn.LSTM)
        self.num_layers, self.bidirectional = rnn.num_layers, rnn.bidirectional
        self.hidden = rnn.hidden_size
        holder = nn.Module() if nested else self
        for name, p in rnn.named_parameters():
            holder.register_parameter(
                name, nn.Parameter(shard_of(p.detach(), specs[name], mesh).clone()))
        if nested:
            self.rnn = holder
        self.nested = nested

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """x [B, L, D], lengths [B] -> [B, L, H * directions], padding zeroed."""
        w = self.rnn if self.nested else self
        lengths = lengths.to(x.device)
        mask = length_mask(lengths, x.shape[1], x.dtype)[..., None]
        suffixes = ("", "_reverse") if self.bidirectional else ("",)
        h = x
        for k in range(self.num_layers):
            def stacked(name):
                return torch.stack([getattr(w, f"{name}_l{k}{s}") for s in suffixes])

            h = self._layer(h, lengths, stacked("weight_ih"), stacked("weight_hh"),
                            stacked("bias_ih"), stacked("bias_hh")) * mask
        return h

    def _layer(self, x, lengths, w_ih, w_hh, b_ih, b_hh):
        """One layer, both directions as one batch (JAX's direction-stacked
        scan): w_* [Z, G*H / m, *], b_* [Z, G*H / m] -> [B, L, Z * H]."""
        mesh, Z = self.mesh, w_ih.shape[0]
        B, L, _ = x.shape
        xs = x[None] if Z == 1 else torch.stack([x, reverse_in_length(x, lengths)])
        xp = torch.einsum("zbld,zgd->zblg", reduce_grad_model(xs, mesh), w_ih)
        if self.lstm:
            xp = xp + (b_ih + b_hh)[:, None, None]
        else:
            xp = all_gather_model(xp + b_ih[:, None, None], mesh, -1)
        w_hh_t = w_hh.transpose(1, 2)
        h = x.new_zeros((Z, B, self.hidden))
        c = torch.zeros_like(h)
        outs = []
        for t in range(L):
            hw = torch.bmm(reduce_grad_model(h, mesh), w_hh_t)
            if self.lstm:
                i, f, g, o = all_gather_model(xp[:, :, t] + hw, mesh, -1).chunk(4, -1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
            else:
                hr, hz, hn = all_gather_model(hw + b_hh[:, None], mesh, -1).chunk(3, -1)
                xr, xz, xn = xp[:, :, t].chunk(3, -1)
                r = torch.sigmoid(xr + hr)
                z = torch.sigmoid(xz + hz)
                h = (1.0 - z) * torch.tanh(xn + r * hn) + z * h
            outs.append(h)
        ys = torch.stack(outs, 2)  # [Z, B, L, H]
        if Z == 1:
            return ys[0]
        return torch.cat([ys[0], reverse_in_length(ys[1], lengths)], -1)


class RowShardedLinear(nn.Module):
    """An `nn.Linear` whose weight [out, in] holds this rank's input columns
    (when `w_spec` names "model") and whose bias holds its output rows (when
    `b_spec` does)."""

    def __init__(self, linear: nn.Linear, mesh, w_spec: tuple, b_spec: tuple):
        super().__init__()
        self.mesh = mesh
        self.w_sharded, self.b_sharded = "model" in w_spec, "model" in b_spec
        self.weight = nn.Parameter(shard_of(linear.weight.detach(), w_spec, mesh).clone())
        self.bias = nn.Parameter(shard_of(linear.bias.detach(), b_spec, mesh).clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.w_sharded:
            y = all_reduce_sum(F.linear(scatter_model(x, self.mesh, -1), self.weight),
                               self.mesh, "model")
        else:
            y = F.linear(x, self.weight)
        return y + (all_gather_model(self.bias, self.mesh, 0) if self.b_sharded else self.bias)


# -- sharding a tagger ---------------------------------------------------------

def tree_paths(tree, prefix=""):
    """(path, leaf) of a JAX-layout pytree, paths as JAX's `param_spec` reads them."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def jax_layout(tagger) -> dict:
    """{state-dict key: (JAX path, JAX shape, transposed)} of a tagger: its
    converter to the JAX layout run on a state dict whose entries are
    distinct float64 ranges, so that each JAX leaf names its source and
    whether the port holds it transposed."""
    sd = tagger.state_dict()
    tagged, starts, offset = {}, [], 0
    for key, v in sd.items():
        tagged[key] = torch.arange(offset, offset + v.numel(), dtype=torch.float64).reshape(v.shape)
        starts.append(offset)
        offset += v.numel()
    keys = list(tagged)
    out = {}
    for path, leaf in tree_paths(tagger._to_jax(tagged)):
        leaf = np.asarray(leaf)
        key = keys[bisect.bisect_right(starts, leaf.flat[0]) - 1]
        port = tagged[key].numpy()
        if leaf.shape == port.shape and np.array_equal(leaf, port):
            out[key] = (path, leaf.shape, False)
        elif leaf.ndim == 2 and np.array_equal(leaf, port.T):
            out[key] = (path, leaf.shape, True)
        else:
            raise ValueError(f"JAX leaf {path} is no layout of {key}")
    missing = sorted(set(sd) - set(out))
    if missing:
        raise ValueError(f"{type(tagger).__name__}: no JAX leaf for {missing}")
    return out


def port_specs(tagger, mesh) -> dict:
    """{state-dict key: spec in the port's layout}: JAX's `shard_spec` of
    the key's JAX leaf, its axes swapped where the port holds it transposed."""
    specs = {}
    for key, (path, shape, transposed) in jax_layout(tagger).items():
        spec = shard_spec(path, shape, mesh)
        specs[key] = tuple(reversed(spec)) if transposed and spec else spec
    return specs


def _sharded(spec) -> bool:
    return "model" in spec


def tensor_parallel(tagger: nn.Module, mesh) -> nn.Module:
    """Shard a built tagger over the mesh's "model" axis in place (nothing
    changes with model 1) -> the tagger. Every rank of the model group calls
    it with the same full weights; each keeps its shards."""
    if mesh is None or mesh.model_size == 1 or is_tensor_parallel(tagger):
        return tagger
    specs = port_specs(tagger, mesh)
    covered = set()

    def swap(name, new):
        parent, _, attr = name.rpartition(".")
        setattr(tagger.get_submodule(parent), attr, new)

    modules = dict(tagger.named_modules())
    for name, module in modules.items():
        parent = modules.get(name.rpartition(".")[0]) if name else None
        if isinstance(module, rnn_lib.RNNStack) or (
                isinstance(module, nn.RNNBase) and not isinstance(parent, rnn_lib.RNNStack)):
            nested = isinstance(module, rnn_lib.RNNStack)
            rnn = module.rnn if nested else module
            prefix = f"{name}.rnn." if nested else f"{name}."
            own = {n: specs[prefix + n] for n, _ in rnn.named_parameters()}
            if all(s == ("model", None) or s == ("model",) for s in own.values()):
                swap(name, ShardedRecurrence(rnn, mesh, own, nested))
                covered.update(prefix + n for n in own)
        elif isinstance(module, nn.Linear):
            w_spec, b_spec = specs[f"{name}.weight"], specs[f"{name}.bias"]
            if w_spec not in ((), (None, "model")):
                raise NotImplementedError(f"{name}.weight: spec {w_spec}")
            if _sharded(w_spec) or _sharded(b_spec):
                swap(name, RowShardedLinear(module, mesh, w_spec, b_spec))
                covered.update((f"{name}.weight", f"{name}.bias"))
    loose = sorted(k for k, s in specs.items() if _sharded(s) and k not in covered)
    if loose:
        raise NotImplementedError(f"sharded parameters outside a recurrent stack or a linear: "
                                  f"{loose}")
    tagger.tp_mesh, tagger.tp_specs = mesh, specs
    return tagger


def is_tensor_parallel(tagger) -> bool:
    return getattr(tagger, "tp_mesh", None) is not None


def sharded_parameters(tagger) -> list:
    """The parameters of which this rank holds a shard."""
    if not is_tensor_parallel(tagger):
        return []
    return [p for n, p in tagger.named_parameters() if _sharded(tagger.tp_specs[n])]


def full_tensors(tagger, named: dict) -> dict:
    """{state-dict key: this rank's shard (or a replicated tensor)} -> the
    full tensors, shards gathered over the model group (a collective)."""
    out = {}
    for key, t in named.items():
        spec = tagger.tp_specs[key]
        out[key] = _gather(t.detach(), tagger.tp_mesh, spec.index("model")) if _sharded(spec) \
            else t.detach()
    return out


def full_state_dict(tagger) -> dict:
    """The single-device state dict of a sharded tagger (a collective over
    the model group), for checkpoints and the carry-over of weights."""
    if not is_tensor_parallel(tagger):
        return tagger.state_dict()
    return full_tensors(tagger, tagger.state_dict())


def full_jax_params(tagger) -> dict:
    """The JAX-layout weights of a sharded tagger, as a single-device
    tagger's `to_jax_params()` gives them (a collective over the model
    group)."""
    return tagger._to_jax(full_state_dict(tagger))


def load_full_state_dict(tagger, sd: dict) -> None:
    """Load single-device weights into a sharded tagger: each rank takes
    its shard of every entry."""
    if not is_tensor_parallel(tagger):
        tagger.load_state_dict(sd)
        return
    mesh = tagger.tp_mesh
    tagger.load_state_dict({k: shard_of(v, tagger.tp_specs[k], mesh) for k, v in sd.items()})
