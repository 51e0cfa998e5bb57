"""Multi-host start-up and the per-rank input (counterpart of the JAX
package's parallel/multihost.py).

- `initialize()` joins the process group from the environment:
  MTS_COORDINATOR (host:port or a file:// store), MTS_NUM_PROCESSES and
  MTS_PROCESS_ID, else torchrun's WORLD_SIZE and RANK with its agent's store
  (env://); a second call does nothing;
- `shard_documents()` round-robins the corpus, so that each rank reads only
  its own documents;
- `global_batch()` pads every rank's local batch to one shape with
  zero-length documents (and -1 tags past the units), which every loss
  ignores, and marks it as this rank's share of one global batch: the
  data-parallel step (parallel/train_step.py) then gives the loss of a
  single process on the concatenated batch.
"""
from __future__ import annotations

import contextlib
import os
from typing import List, Optional

import numpy as np
import torch.distributed as dist

from . import mesh as mesh_lib


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda") -> None:
    """Join (or form) the process group; nothing if one exists already."""
    if dist.is_available() and dist.is_initialized():
        return
    env = os.environ
    coordinator = coordinator_address or env.get("MTS_COORDINATOR")
    if num_processes is None and env.get("MTS_NUM_PROCESSES"):
        num_processes = int(env["MTS_NUM_PROCESSES"])
    if process_id is None and env.get("MTS_PROCESS_ID"):
        process_id = int(env["MTS_PROCESS_ID"])
    if coordinator is None and env.get("MASTER_ADDR"):
        # torchrun's agent holds the store at MASTER_ADDR:MASTER_PORT: join it as a client
        coordinator = "env://"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator is None or num_processes is None or process_id is None:
        raise RuntimeError(
            "multihost.initialize needs a coordinator, a process count and a process id: pass "
            "them, or set MTS_COORDINATOR / MTS_NUM_PROCESSES / MTS_PROCESS_ID (or run under "
            "torchrun)")
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    local_rank = int(env.get("LOCAL_RANK", process_id))
    mesh_lib.init_process_group(process_id, num_processes, init_method, device, local_rank)


@contextlib.contextmanager
def process_group_from_environment(device="cuda"):
    """Under torchrun (WORLD_SIZE > 1 and no group yet): join the group for
    the block and leave it after; otherwise nothing."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or (dist.is_available()
                                                      and dist.is_initialized()):
        yield
        return
    initialize(device=device)
    try:
        yield
    finally:
        dist.destroy_process_group()


def global_mesh(model_parallel: int = 1):
    """("data", "model") mesh over every rank of every host."""
    return mesh_lib.make_mesh(model_parallel=model_parallel)


def shard_documents(docs: List, process_id: Optional[int] = None,
                    num_processes: Optional[int] = None) -> List:
    """Round-robin corpus split: rank p keeps docs[p::n], deterministic in
    the document order every rank derives alike (sorted listdir)."""
    p = mesh_lib.global_rank() if process_id is None else process_id
    n = mesh_lib.world_size() if num_processes is None else num_processes
    return docs[p::n]


def global_batch(local_batch: dict, mesh) -> dict:
    """This rank's batch as its share of one global batch: documents and
    units padded to the largest local shape over the mesh (zero-length
    documents, -1 tags), `sharded` set, `n_real` this rank's real documents
    and `n_global` those of all ranks."""
    B, L = np.asarray(local_batch["src_tokens"]).shape[:2]
    n_real = local_batch.get("n_real", B)
    shapes = mesh_lib.all_gather_object((B, L, n_real), mesh)
    B_max, L_max = max(s[0] for s in shapes), max(s[1] for s in shapes)
    # pad_batch_axis pads B up to its next multiple of B_max, which is B_max
    out = dict(mesh_lib.pad_batch_axis(local_batch, B_max))
    for key in ("src_tokens", "tgt_tokens", "src_tokens2"):
        if key in out and hasattr(out[key], "shape"):
            arr = np.asarray(out[key])
            widths = [(0, 0), (0, L_max - arr.shape[1])] + [(0, 0)] * (arr.ndim - 2)
            out[key] = np.pad(arr, widths, constant_values=-1.0 if key == "tgt_tokens" else 0)
    out["n_real"] = n_real
    out["n_global"] = sum(s[2] for s in shapes)
    out["sharded"] = True
    return out
