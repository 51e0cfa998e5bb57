"""Rank functions for the port's parallel tests. Each runs in a process that
`multimodaltopicsegmentation_torch.parallel.dryrun.spawn_ranks` started and
joined to a gloo group, on the device it was given (the CPU, or ranks
sharing the one card: `spawn_on_one_card`); it imports torch and the port
only (no JAX, which the test process runs for the references) and pickles
what it computed, as numpy, to `out_dir/rank{r}.pkl`, rank by rank."""
import os
import pickle

import numpy as np
import torch

from multimodaltopicsegmentation_torch.models import registry
from multimodaltopicsegmentation_torch.models.base import TaggerConfig
from multimodaltopicsegmentation_torch.parallel import mesh as PM
from multimodaltopicsegmentation_torch.parallel import train_step as TS
from multimodaltopicsegmentation_torch.train.loop import batches_to_device, make_optimizer


def save(out_dir, rank, obj):
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def load(out_dir, nprocs):
    out = []
    for r in range(nprocs):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def spawn_on_one_card(fn, nprocs, args, store_dir, timeout=600):
    """`spawn_ranks` on "cuda" with the first card the only one visible: the
    ranks share it (gloo: more ranks than cards)."""
    from multimodaltopicsegmentation_torch.parallel.dryrun import spawn_ranks

    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = first
    try:
        spawn_ranks(fn, nprocs, args, "cuda", timeout=timeout, store_dir=store_dir)
    finally:
        if old is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES")
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old


def torchrun_on_one_card(module, argv, nprocs=2, timeout=600):
    """`python -m torch.distributed.run --standalone` of a CLI module from the
    repository's root, its ranks sharing the first card (each joins by
    env://); every process of the run is killed at its end or its time
    limit. -> its output; raises with it if the run fails."""
    import signal
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ,
               CUDA_VISIBLE_DEVICES=os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0])
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc_per_node", str(nprocs), "-m", module, *argv], cwd=root,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"torchrun {module} exited {proc.returncode}:\n{out[-3000:]}")
    return out


def tagger(arch, cfg: dict, params, device="cpu"):
    t = registry.build(arch, TaggerConfig(**cfg))
    t.load_state_dict(type(t).from_jax_params(params))
    return t.to(device)


def launches() -> tuple:
    """The flash kernels' launch counters of this process: (K2, K4, K5, K3)."""
    from multimodaltopicsegmentation_torch.ops import flash_attention as FA

    return tuple(f.launches for f in (FA._flash_fwd, FA._flash_dq, FA._flash_dq_dbias,
                                      FA._flash_dkv))


def force_flash():
    """The flash route on the CPU: the wrappers' plain versions, which take
    prefix masks (`ops/flash_attention._lengths`)."""
    from multimodaltopicsegmentation_torch.ops import attention as TA

    TA.flash_attention_active = lambda where: True


def grads(model) -> dict:
    return {n: p.grad.detach().cpu().numpy().copy() for n, p in model.named_parameters()
            if p.grad is not None}


def dp_steps(rank, out_dir, cases):
    """Data-parallel Adam steps: for each (name, arch, cfg, params, batch,
    steps, lr, extra) -> the batch losses, the final JAX-layout params and
    the first step's gradients as the step left them (summed over the
    ranks); under "launches", each case's flash launches."""
    mesh = PM.make_mesh()
    res = {"launches": {}}
    for name, arch, cfg, params, batch, steps, lr, extra in cases:
        before = launches()
        model = tagger(arch, cfg, params, mesh.device)
        step = TS.make_sharded_train_step(model, make_optimizer("Adam", model.parameters(), lr),
                                          mesh, extra)
        share = batches_to_device([PM.shard_batch(mesh, batch)], mesh.device)[0]
        losses = [float(step(share, None))]
        first = grads(model)
        losses += [float(step(share, None)) for _ in range(steps - 1)]
        res[name] = (losses, model.to_jax_params(), first)
        res["launches"][name] = tuple(n - m for n, m in zip(launches(), before))
    save(out_dir, rank, res)


def loss_parts(rank, out_dir, cases, batch, fit):
    """For each (name, arch, cfg, extra): the tagger drawn from seed 0, its
    loss and gradients on the whole batch in this process, then the sum over
    the ranks of each rank's part on its share (`share_loss`) and of the
    parts' gradients. Then `Trainer(mesh)` and `fit`'s keywords on [batch]
    -> (params, history)."""
    from multimodaltopicsegmentation_torch.train.loop import Trainer, tagger_loss

    mesh = PM.make_mesh()
    whole = batches_to_device([batch], mesh.device)[0]
    share = batches_to_device([PM.shard_batch(mesh, batch)], mesh.device)[0]
    res = {}
    for name, arch, cfg, extra in cases:
        model = registry.build(arch, TaggerConfig(**cfg),
                               torch.Generator().manual_seed(0)).to(mesh.device)
        loss = tagger_loss(model, extra)(whole, None)
        loss.backward()
        one = grads(model)
        model.zero_grad(set_to_none=True)
        part = TS.share_loss(tagger_loss(model, extra), mesh)(share, None)
        part.backward()
        TS.all_reduce_grads(list(model.parameters()), mesh)
        res[name] = dict(loss=float(loss.detach()), grads=one, parts=float(PM.all_reduce_sum(
            part.detach(), mesh)), part_grads=grads(model))
    arch, cfg, kw = fit
    trainer = Trainer(arch, TaggerConfig(**cfg), check_dir=os.path.join(out_dir, f"ckpt{rank}"),
                      device=mesh.device, mesh=mesh, **kw)
    res["fit"] = trainer.fit([batch], [batch])
    save(out_dir, rank, res)


def grid_fit(rank, out_dir, cfg, grid, batches, kw):
    from multimodaltopicsegmentation_torch.train.grid import GridTrainer

    mesh = PM.make_mesh()
    gt = GridTrainer("BiLSTM", TaggerConfig(**cfg), grid, mesh=mesh, device=mesh.device, **kw)
    finals, histories = gt.fit(batches, batches)
    paths = list(gt.best_model_paths)
    save(out_dir, rank, (finals, histories, paths, [gt.save_final(g) for g in range(len(grid))]))


def run_cli(rank, module, argv, cwd):
    """A CLI's cli_main(argv) in every rank (the group is up already)."""
    import importlib

    os.chdir(cwd)
    importlib.import_module(module).cli_main(argv)


def sequence_case(rank, out_dir, cfg, params, x, lengths, tags, flash, fit_batch):
    """The sequence-sharded logits, the batch's loss and its gradients (and
    the flash launches they took); then `Trainer(sequence_shards=n)` for 3
    epochs."""
    from multimodaltopicsegmentation_torch.parallel import sequence as SQ
    from multimodaltopicsegmentation_torch.train.loop import Trainer

    if flash:
        force_flash()
    mesh = PM.make_mesh()
    model = tagger("Transformer", cfg, params, mesh.device)
    x, lengths, tags = (torch.as_tensor(a).to(mesh.device) for a in (x, lengths, tags))
    logits, dec = SQ.sequence_sharded_transformer_decode(mesh, model, x, lengths, 0.5)
    part = SQ.sequence_sharded_transformer_loss(mesh, model, x, lengths, tags, train=False)
    part.backward()
    TS.all_reduce_grads(list(model.parameters()), mesh)
    loss = float(PM.all_reduce_sum(part.detach(), mesh))
    counted = launches()
    trainer = Trainer("Transformer", TaggerConfig(**cfg), lr=1e-3, max_epochs=3,
                      check_dir=os.path.join(out_dir, f"ckpt{rank}"), seed=0,
                      device=mesh.device, sequence_shards=mesh.size)
    _, history = trainer.fit([fit_batch], [fit_batch])
    test, _, scores = trainer.test(trainer.params, [fit_batch])
    save(out_dir, rank, dict(logits=logits.cpu().numpy(), tags=dec.cpu().numpy(), loss=loss,
                             grads=grads(model), history=history, test=test, scores=scores,
                             halo_bytes=PM.stats["staged_bytes"], launches=counted))


def pipeline_case(rank, out_dir, cfg, params, x, lengths, tags, n_micro, fit_batch):
    """The pipelined loss and its gradients, the pipelined logits (and the
    flash launches they took); then `Trainer(pipeline_stages=n)` for 3
    epochs."""
    from multimodaltopicsegmentation_torch.parallel import pipeline as PP
    from multimodaltopicsegmentation_torch.train.loop import Trainer

    mesh = PM.make_mesh()
    model = tagger("Transformer", cfg, params, mesh.device)
    x, lengths, tags = (torch.as_tensor(a).to(mesh.device) for a in (x, lengths, tags))
    part = PP.pipeline_transformer_loss(mesh, model, x, lengths, tags, n_micro, train=False)
    TS.all_reduce_grads(list(model.parameters()), mesh)
    loss = float(PM.all_reduce_sum(part, mesh))
    logits = PP.pipeline_transformer_scores(mesh, model, x, lengths, n_micro)
    counted = launches()
    trainer = Trainer("Transformer", TaggerConfig(**cfg), lr=1e-3, max_epochs=3,
                      check_dir=os.path.join(out_dir, f"ckpt{rank}"), seed=0,
                      device=mesh.device, pipeline_stages=mesh.size)
    _, history = trainer.fit([fit_batch], [fit_batch])
    save(out_dir, rank, dict(loss=loss, grads=grads(model), logits=logits.cpu().numpy(),
                             history=history, params=trainer.params, launches=counted))


def expert_case(rank, out_dir, cfg, params, x, lengths, tags, domains, fit_batch):
    """The expert-sharded logits, loss and gradients (the train step's sync:
    towers summed, the head from index 0); then the Trainer, whose expert
    mode turns on by itself, for 3 epochs."""
    from multimodaltopicsegmentation_torch.parallel import expert as EX
    from multimodaltopicsegmentation_torch.train.loop import Trainer

    mesh = PM.make_mesh()
    towers, shared = EX.split_towers(params)
    model = tagger("SwitchBiLSTM", cfg, EX.join_towers(towers, shared), mesh.device)
    x, lengths, tags, domains = (torch.as_tensor(a).to(mesh.device)
                                 for a in (x, lengths, tags, domains))
    logits = EX.expert_sharded_switch_scores(mesh, model, x, lengths, domains)
    loss = EX.expert_sharded_switch_loss(mesh, model, x, lengths, tags, domains, train=False)
    loss.backward()
    local = grads(model)
    TS.all_reduce_grads(list(model.parameters()), mesh, list(model.classification.parameters()))
    trainer = Trainer("SwitchBiLSTM", TaggerConfig(**cfg), lr=1e-3, max_epochs=3,
                      check_dir=os.path.join(out_dir, f"ckpt{rank}"), seed=0, device=mesh.device)
    _, history = trainer.fit([fit_batch], [fit_batch])
    test, _, _ = trainer.test(trainer.params, [fit_batch])
    save(out_dir, rank, dict(logits=logits.detach().cpu().numpy(), loss=float(loss), local=local,
                             grads=grads(model), history=history, test=test,
                             expert=trainer.expert_mesh is not None))


def multihost_main(out_dir):
    """A process of the two-process test: joins from MTS_* (file:// store),
    reads its round-robin share of the corpus and takes one data-parallel
    step on it."""
    from multimodaltopicsegmentation_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize(device="cpu")
    multihost.initialize(device="cpu")  # a second call does nothing
    rank = PM.global_rank()
    rng = np.random.default_rng(0)
    L, D = 16, 12
    docs = [(rng.standard_normal((L - 3 * i, D)).astype(np.float32),
             (rng.random(L - 3 * i) < 0.2).astype(np.float32)) for i in range(5)]
    mine = multihost.shard_documents(docs)
    Lm = max(len(d[0]) for d in mine)
    local = {"src_tokens": np.stack([np.pad(d[0], ((0, Lm - len(d[0])), (0, 0)))
                                     for d in mine]),
             "tgt_tokens": np.stack([np.pad(d[1], (0, Lm - len(d[1])), constant_values=-1.0)
                                     for d in mine]),
             "src_lengths": np.asarray([len(d[0]) for d in mine], np.int32)}
    mesh = multihost.global_mesh()
    batch = multihost.global_batch(local, mesh)
    cfg = dict(embedding_dim=D, hidden_dim=8, num_layers=1, loss_fn="FocalLoss")
    with open(os.path.join(out_dir, "params.pkl"), "rb") as f:
        params = pickle.load(f)
    model = tagger("BiLSTM", cfg, params)
    step = TS.make_sharded_train_step(model, make_optimizer("Adam", model.parameters(), 1e-3),
                                      mesh)
    share = batches_to_device([PM.shard_batch(mesh, batch)], "cpu")[0]
    losses = [float(step(share, None)) for _ in range(2)]
    save(out_dir, rank, dict(losses=losses, params=model.to_jax_params(),
                             shape=batch["src_tokens"].shape, n_global=batch["n_global"]))
    torch.distributed.destroy_process_group()


def card_case(rank, out_dir, cfg, params, x, lengths, tags):
    """Two ranks on the card(s): the sequence-sharded logits, loss and
    gradients, the backend and the bytes staged through the host."""
    from multimodaltopicsegmentation_torch.parallel import sequence as SQ

    mesh = PM.make_mesh()
    model = tagger("Transformer", cfg, params, mesh.device)
    x, lengths, tags = (torch.as_tensor(a).to(mesh.device) for a in (x, lengths, tags))
    logits, _ = SQ.sequence_sharded_transformer_decode(mesh, model, x, lengths, 0.5)
    part = SQ.sequence_sharded_transformer_loss(mesh, model, x, lengths, tags, train=False)
    part.backward()
    TS.all_reduce_grads(list(model.parameters()), mesh)
    save(out_dir, rank, dict(logits=logits.cpu().numpy(), grads={
        n: p.grad.cpu().numpy() for n, p in model.named_parameters()},
        loss=float(PM.all_reduce_sum(part.detach(), mesh)), backend=mesh.backend,
        device=str(mesh.device), staged=PM.stats["staged_bytes"]))


def tp_case(mesh, arch, cfg, params, batch, steps, lr, extra, clip):
    """Adam steps of a tagger sharded over the mesh's "model" axis on this
    rank's data share -> the batch losses, the final params (the gathered
    JAX layout), the first step's gradients (gathered, as the step left them,
    clipped where `clip`), this rank's shards before the first step and the
    shapes of the parameters' and their Adam state's tensors, and the flash
    launches of the steps."""
    from multimodaltopicsegmentation_torch.parallel import tensor as TP

    before = launches()
    model = TP.tensor_parallel(tagger(arch, cfg, params, mesh.device), mesh)
    shards = {k: v.cpu().numpy().copy() for k, v in model.state_dict().items()}
    opt = make_optimizer("Adam", model.parameters(), lr)
    step = TS.make_sharded_train_step(model, opt, mesh, extra, clip)
    share = batches_to_device([PM.shard_batch(mesh, batch)], mesh.device)[0]
    losses = [float(step(share, None))]
    first = {k: v.cpu().numpy().copy() for k, v in TP.full_tensors(
        model, {n: p.grad for n, p in model.named_parameters()}).items()}
    losses += [float(step(share, None)) for _ in range(steps - 1)]
    shapes = {n: (tuple(p.shape), [tuple(v.shape) for v in opt.state[p].values()
                                   if isinstance(v, torch.Tensor)])
              for n, p in model.named_parameters()}
    return dict(losses=losses, params=TP.full_jax_params(model), first=first, shards=shards,
                shapes=shapes, launches=tuple(n - m for n, m in zip(launches(), before)))


def tp_rank(rank, out_dir, plan):
    """Tensor parallelism on gloo ranks, by `plan`: "steps" {key: (model
    parallel, [(name, tp_case arguments)])}, "decode" {key: (model parallel,
    arch, cfg, params, batch)}, "trainer" (model parallel, arch, cfg,
    keywords, train, valid), "grid" (model parallel, cfg, grid, batches,
    keywords), "refuse" (a mesh size and model_parallel that must not
    make a mesh), "modes" (model parallel, arch, cfg: the Trainer's other
    parallel modes beside a "model" axis, each refused) and "global_mesh"
    (model parallel: `multihost.global_mesh`'s shape)."""
    from multimodaltopicsegmentation_torch.train.grid import GridTrainer
    from multimodaltopicsegmentation_torch.train.loop import Trainer

    meshes = {}

    def mesh_of(m):
        if m not in meshes:
            meshes[m] = PM.make_mesh(model_parallel=m)
        return meshes[m]

    res = {"steps": {}, "decode": {}}
    for key, (m, cases) in plan.get("steps", {}).items():
        mesh = mesh_of(m)
        res["steps"][key] = dict(position=(mesh.index, mesh.model_index), shape=mesh.shape,
                                 cases={name: tp_case(mesh, *case) for name, case in cases})
    for key, (m, arch, cfg, params, batch) in plan.get("decode", {}).items():
        mesh = mesh_of(m)
        decode = TS.make_sharded_decode(tagger(arch, cfg, params, mesh.device), mesh, 0.5)
        scores, tags = decode(batch)
        res["decode"][key] = (scores.cpu().numpy(), tags.cpu().numpy())
    if "trainer" in plan:
        m, arch, cfg, kw, train, valid = plan["trainer"]
        mesh = mesh_of(m)
        trainer = Trainer(arch, TaggerConfig(**cfg), check_dir=os.path.join(out_dir, "tp_ckpt"),
                          device=mesh.device, mesh=mesh, **kw)
        params, history = trainer.fit(train, valid)
        test = trainer.test(params, valid)[0]
        res["trainer"] = dict(params=params, history=history, path=trainer.best_model_path,
                              writer=trainer.is_writer, test=test,
                              seed=trainer.generator.initial_seed())
    if "grid" in plan:
        m, cfg, grid, batches, kw = plan["grid"]
        mesh = mesh_of(m)
        gt = GridTrainer("BiLSTM", TaggerConfig(**cfg), grid, mesh=mesh, device=mesh.device, **kw)
        finals, histories = gt.fit(batches, batches)
        res["grid"] = (finals, histories, list(gt.best_model_paths),
                       [gt.save_final(g) for g in range(len(grid))])
    if "modes" in plan:
        m, arch, cfg = plan["modes"]
        res["modes"] = []
        for kw in (dict(pipeline_stages=2), dict(sequence_shards=2), dict(expert_parallel=True)):
            try:
                Trainer(arch, TaggerConfig(**cfg), device=mesh_of(m).device, mesh=mesh_of(m),
                        **kw)
                res["modes"].append(None)
            except ValueError as e:
                res["modes"].append(str(e))
    if "global_mesh" in plan:
        from multimodaltopicsegmentation_torch.parallel import multihost

        res["global_mesh"] = multihost.global_mesh(plan["global_mesh"]).shape
    if "refuse" in plan:
        n, m = plan["refuse"]
        try:
            PM.make_mesh(n, model_parallel=m)
            res["refuse"] = None
        except ValueError as e:
            res["refuse"] = str(e)
    save(out_dir, rank, res)


def check_model_axis_refusals(store_dir):
    """make_mesh(model_parallel=2) in this process: without a process group
    it raises "no process group"; in a group of one rank, which 2 does not
    divide, ValueError."""
    import pytest

    with pytest.raises(RuntimeError, match="no process group"):
        PM.make_mesh(model_parallel=2)
    torch.distributed.init_process_group(
        "gloo", init_method="file://" + os.path.join(store_dir, "store"), world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="does not divide"):
            PM.make_mesh(model_parallel=2)
    finally:
        torch.distributed.destroy_process_group()
