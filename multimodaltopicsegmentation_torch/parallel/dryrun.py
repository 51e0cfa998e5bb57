"""N ranks through every parallel mode at a tiny width: the port's
counterpart of the JAX package's `__graft_entry__.dryrun_multichip`.

    python -m multimodaltopicsegmentation_torch.parallel.dryrun --nproc N [--device cpu]

spawns N ranks (`torch.multiprocessing`, the spawn method, a `file://`
store in a temporary folder; the backend by `mesh.backend_for`). Each runs
one data-parallel BiLSTM step on an odd batch (padded with a zero-length
document; the ranks' losses, gathered on rank 0, must agree), the same
step over JAX's dryrun mesh (model_parallel 2 when N is even: the BiLSTM
sharded over "model"), the sequence-sharded decode and fit, the pipeline
fit and a
pipelined gradient, the expert-parallel gradient (and fit, at N = 2), the
sharded grid; then two more processes join from MTS_COORDINATOR /
MTS_NUM_PROCESSES / MTS_PROCESS_ID (`multihost.initialize`) and take one
data-parallel step on their own documents, which must agree. It prints one
line, `dryrun(N): mesh=... loss=... tp_mesh=... tp_loss=... seq_parallel=ok
pipeline=ok expert=ok grid=ok multihost=ok ok`, and exits non-zero if any
rank fails.

`spawn_ranks` is the launcher that the tests use too.
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile
import time

import numpy as np
import torch


def _rank_main(rank, fn, nprocs, store, device, args):
    from . import mesh as mesh_lib

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # N ranks share the host's cores
    mesh_lib.init_process_group(rank, nprocs, store, device)
    try:
        fn(rank, *args)
    finally:
        torch.distributed.destroy_process_group()


def spawn_ranks(fn, nprocs: int, args=(), device="cpu", timeout: float = 600.0,
                store_dir=None) -> None:
    """Run fn(rank, *args) in `nprocs` spawned processes that joined one
    process group (a `file://` store in `store_dir` or a new temporary
    folder). Raises if a rank fails or the time limit passes; every
    process is stopped before it returns or raises."""
    own = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="mts_store_") if own else store_dir
    store = "file://" + os.path.join(os.path.abspath(store_dir), "store")
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, nprocs, store, str(device), tuple(args)), nprocs=nprocs,
        join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks of {fn.__name__} still running after "
                                   f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        if own:
            import shutil

            shutil.rmtree(store_dir, ignore_errors=True)


def _config(**kw):
    from ..models.base import TaggerConfig

    return TaggerConfig(**{"loss_fn": "FocalLoss", **kw})


def _dryrun_rank(rank, out_dir):
    from ..models import registry
    from ..parallel import mesh as mesh_lib
    from ..parallel.expert import expert_sharded_switch_loss
    from ..parallel.pipeline import pipeline_transformer_loss
    from ..parallel.sequence import sequence_sharded_transformer_decode
    from ..train.grid import GridTrainer
    from ..train.loop import Trainer

    mesh = mesh_lib.make_mesh()
    n, dev = mesh.size, mesh.device
    rng = np.random.default_rng(0)
    done = {}
    with tempfile.TemporaryDirectory() as td:
        def fit(arch, cfg, batch, **kw):
            t = Trainer(arch, cfg, lr=1e-3, max_epochs=1, monitor="training_loss",
                        check_dir=os.path.join(td, arch), device=dev, **kw)
            _, history = t.fit([batch])
            loss = history[-1]["training_loss"]
            assert np.isfinite(loss), (arch, kw, loss)
            return loss

        # one data-parallel step of the replication BiLSTM on an odd batch
        cfg = _config(embedding_dim=32, hidden_dim=16, num_layers=2)
        B, L = 2 * n - 1, 32
        batch = {"src_tokens": rng.standard_normal((B, L, 32)).astype(np.float32),
                 "tgt_tokens": (rng.random((B, L)) < 0.1).astype(np.float32),
                 "src_lengths": np.full((B,), L, np.int32), "n_real": B}
        done["loss"] = fit("BiLSTM", cfg, batch, mesh=mesh)
        losses = mesh_lib.gather_object(done["loss"], mesh)  # one replicated loss
        assert losses is None or len(set(losses)) == 1, losses

        # the same step over JAX's dryrun mesh: model_parallel 2 on an even count
        m = 2 if n % 2 == 0 else 1
        tp_mesh = mesh_lib.make_mesh(model_parallel=m)
        B = max(n // m, 1) * 2 - 1
        tp_batch = {"src_tokens": rng.standard_normal((B, L, 32)).astype(np.float32),
                    "tgt_tokens": (rng.random((B, L)) < 0.1).astype(np.float32),
                    "src_lengths": np.full((B,), L, np.int32), "n_real": B}
        done["tp_loss"] = fit("BiLSTM", cfg, tp_batch, mesh=tp_mesh)
        losses = mesh_lib.gather_object(done["tp_loss"], tp_mesh)
        assert losses is None or len(set(losses)) == 1, losses
        done["tp_mesh"] = tp_mesh.shape

        # sequence parallelism: the decode, then one fit step over a unit
        # axis the Trainer pads to a multiple of the shards
        tcfg = _config(embedding_dim=16, hidden_dim=32, num_layers=2, nheads=2,
                       attention_window=4)
        seg = registry.build("Transformer", tcfg, torch.Generator().manual_seed(2)).to(dev)
        Ls = 16 * n
        xs = torch.as_tensor(rng.standard_normal((1, Ls, 16)), dtype=torch.float32).to(dev)
        scores, _ = sequence_sharded_transformer_decode(
            mesh, seg, xs, torch.tensor([Ls], device=dev), 0.5)
        assert torch.isfinite(scores).all()
        sbatch = {"src_tokens": rng.standard_normal((2, Ls - 3, 16)).astype(np.float32),
                  "tgt_tokens": (rng.random((2, Ls - 3)) < 0.2).astype(np.float32),
                  "src_lengths": np.asarray([Ls - 3, Ls // 2], np.int32), "n_real": 2}
        fit("Transformer", tcfg, sbatch, sequence_shards=n)

        # pipeline parallelism: one fit step, then the pipelined loss's gradient
        pcfg = _config(embedding_dim=16, hidden_dim=32, num_layers=n, nheads=2,
                       attention_window=4)
        pbatch = {"src_tokens": rng.standard_normal((4, 16, 16)).astype(np.float32),
                  "tgt_tokens": (rng.random((4, 16)) < 0.2).astype(np.float32),
                  "src_lengths": np.asarray([16, 12, 16, 7], np.int32), "n_real": 4}
        fit("Transformer", pcfg, pbatch, pipeline_stages=n)
        pseg = registry.build("Transformer", pcfg, torch.Generator().manual_seed(3)).to(dev)
        dev_batch = {k: torch.as_tensor(pbatch[k]).to(dev)
                     for k in ("src_tokens", "tgt_tokens", "src_lengths")}
        pipeline_transformer_loss(mesh, pseg, dev_batch["src_tokens"], dev_batch["src_lengths"],
                                  dev_batch["tgt_tokens"], 4)
        assert all(torch.isfinite(p.grad).all() for p in pseg.parameters() if p.grad is not None)

        # expert parallelism on the first two ranks: the loss's gradient, and
        # one fit step where the Trainer's auto-enable can take all ranks
        ex = torch.as_tensor(rng.standard_normal((4, 12, 16)), dtype=torch.float32).to(dev)
        etags = torch.as_tensor((rng.random((4, 12)) < 0.2).astype(np.float32)).to(dev)
        elens = torch.tensor([12, 9, 12, 5], device=dev)
        edoms = torch.tensor([1, 0, 1, 0], device=dev)
        emesh = mesh_lib.make_mesh(2)
        if emesh is not None:
            ecfg = _config(embedding_dim=16, hidden_dim=8, num_layers=1, switch="lstm")
            emodel = registry.build("SwitchBiLSTM", ecfg,
                                    torch.Generator().manual_seed(4)).to(dev)
            eloss = expert_sharded_switch_loss(emesh, emodel, ex, elens, etags, edoms)
            eloss.backward()
            assert torch.isfinite(eloss) and all(
                torch.isfinite(p.grad).all() for p in emodel.parameters() if p.grad is not None)
            if n == 2:
                fit("SwitchBiLSTM", ecfg, {
                    "src_tokens": ex.cpu().numpy(), "tgt_tokens": etags.cpu().numpy(),
                    "src_lengths": elens.cpu().numpy(), "domain": edoms.cpu().numpy(),
                    "n_real": 4})

        # the grid's configurations over the ranks
        gcfg = _config(embedding_dim=16, hidden_dim=8, num_layers=1)
        gt = GridTrainer("BiLSTM", gcfg, [(0.0, 0.0), (0.1, 0.2), (0.2, 0.1)], lr=1e-3,
                         max_epochs=2, monitor="training_loss",
                         check_dir=os.path.join(td, "grid"), mesh=mesh, device=dev)
        gt.fit([{"src_tokens": rng.standard_normal((3, 12, 16)).astype(np.float32),
                 "tgt_tokens": (rng.random((3, 12)) < 0.2).astype(np.float32),
                 "src_lengths": np.asarray([12, 9, 7], np.int32), "n_real": 3}])
        assert all(p is not None for p in gt.best_model_paths)
        assert all(np.isfinite(h[-1]["training_loss"]) for h in gt.histories)
    if rank == 0:
        done["mesh"] = mesh.shape
        with open(os.path.join(out_dir, "dryrun.pkl"), "wb") as f:
            pickle.dump(done, f)


def _multihost_rank(rank, out_dir, store):
    """One data-parallel step on this process's own documents, after joining
    from the MTS_* environment (the spawned group is left first)."""
    from ..models.base import TaggerConfig
    from ..models.registry import build
    from ..train.loop import make_optimizer
    from . import mesh as mesh_lib
    from . import multihost
    from .train_step import make_sharded_train_step

    device = mesh_lib._STATE["device"]
    torch.distributed.destroy_process_group()
    os.environ.update(MTS_COORDINATOR=store, MTS_NUM_PROCESSES="2", MTS_PROCESS_ID=str(rank))
    multihost.initialize(device=device)
    multihost.initialize(device=device)  # a second call does nothing
    rng = np.random.default_rng(0)
    L, D = 16, 12
    docs = [(rng.standard_normal((L, D)).astype(np.float32),
             (rng.random(L) < 0.2).astype(np.float32)) for _ in range(4)]
    mine = multihost.shard_documents(docs)
    mesh = multihost.global_mesh()
    local = {"src_tokens": np.stack([d[0] for d in mine]),
             "tgt_tokens": np.stack([d[1] for d in mine]),
             "src_lengths": np.full((len(mine),), L, np.int32)}
    batch = multihost.global_batch(local, mesh)
    cfg = TaggerConfig(embedding_dim=D, hidden_dim=8, num_layers=1, loss_fn="FocalLoss")
    tagger = build("BiLSTM", cfg, torch.Generator().manual_seed(0)).to(device)
    step = make_sharded_train_step(tagger, make_optimizer("Adam", tagger.parameters(), 1e-3),
                                   mesh)
    share = {k: torch.as_tensor(batch[k]).to(device)
             for k in ("src_tokens", "tgt_tokens", "src_lengths")}
    loss = float(step(share, None))
    with open(os.path.join(out_dir, f"multihost{rank}.txt"), "w") as f:
        f.write(repr(loss))


def dryrun(nproc: int, device="cpu", timeout: float = 600.0) -> str:
    """-> the summary line; raises if a rank fails."""
    with tempfile.TemporaryDirectory(prefix="mts_dryrun_") as out:
        spawn_ranks(_dryrun_rank, nproc, (out,), device, timeout, store_dir=out)
        with open(os.path.join(out, "dryrun.pkl"), "rb") as f:
            done = pickle.load(f)
        store = "file://" + os.path.join(out, "multihost_store")
        os.makedirs(os.path.join(out, "spawn2"))
        spawn_ranks(_multihost_rank, 2, (out, store), device, timeout,
                    store_dir=os.path.join(out, "spawn2"))
        losses = []
        for r in range(2):
            with open(os.path.join(out, f"multihost{r}.txt")) as f:
                losses.append(float(f.read()))
        if not (np.isfinite(losses[0]) and losses[0] == losses[1]):
            raise RuntimeError(f"the two processes disagree: losses {losses}")
    return (f"dryrun({nproc}): mesh={done['mesh']} loss={done['loss']:.5f} "
            f"tp_mesh={done['tp_mesh']} tp_loss={done['tp_loss']:.5f} seq_parallel=ok "
            f"pipeline=ok expert=ok grid=ok multihost=ok ok")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nproc", type=int, default=2)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--timeout", type=float, default=600.0)
    args = parser.parse_args(argv)
    if args.nproc < 2:
        parser.error("--nproc must be at least 2")
    print(dryrun(args.nproc, args.device, args.timeout), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
