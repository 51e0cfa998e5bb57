"""Tensor parallelism over the mesh's "model" axis (parallel/tensor.py, the
model axis of parallel/mesh.py and parallel/train_step.py, Trainer and
GridTrainer over a (data, model) mesh), on gloo ranks on the CPU, held to
the JAX package's single-device step on numpy-seeded inputs (JAX's own
shard_map suite, tests/test_parallel.py, holds model_parallel 1/2/4 equal to
one device there). One spawn per world size:

- 2 ranks, model_parallel 2: 3 Adam steps from the JAX first weights on an
  odd batch with a zero-length document (B 5, L 20, D 32, H 8) for the
  LSTM and GRU BiLSTM (bi- and unidirectional), the Transformer,
  RecurrentLongT5, biLSTMCRF, SheikhBiLSTM, SimpleBiLSTM's bare LSTM and the
  'double' and 'domain' extras, clipping on in one case: losses to 1e-5,
  first-step gradients and parameters to 1e-4; each rank's shards equal
  the slice that JAX's `param_shardings` places on its device, and the Adam
  state has the shards' shapes; the sharded decode's tags equal JAX's
  single-device decode; `Trainer(mesh)` with dropout 0.1 fits as one port
  process with the same seed and writes a checkpoint that the predict CLI
  serves as it serves the one-process checkpoint;
- 4 ranks: BiLSTM and Transformer on a 2 x 2 (data, model) grid and at
  model_parallel 4, the sharded decode on the grid, `GridTrainer` over the
  grid equal to the serial grid, `multihost.global_mesh(2)`, and a mesh
  that does not divide refused; a "model" axis beside the Trainer's other
  parallel modes refused;
- the dryrun at 4 ranks prints its ok line (model_parallel 2).
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import torch_dist_workers as W
from multimodaltopicsegmentation_tpu.models import registry as jax_registry
from multimodaltopicsegmentation_tpu.models.base import TaggerConfig as JaxTaggerConfig
from multimodaltopicsegmentation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multimodaltopicsegmentation_tpu.parallel.mesh import param_shardings
from multimodaltopicsegmentation_tpu.train.loop import make_optimizer as jax_optimizer
from multimodaltopicsegmentation_torch.models import registry
from multimodaltopicsegmentation_torch.models.base import TaggerConfig
from multimodaltopicsegmentation_torch.parallel import mesh as PM
from multimodaltopicsegmentation_torch.parallel.dryrun import spawn_ranks
from multimodaltopicsegmentation_torch.train.grid import GridTrainer
from multimodaltopicsegmentation_torch.train.loop import Trainer

pytestmark = pytest.mark.torch_distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL, PARAM_TOL = 1e-5, 1e-4
B, L, D, D2, H = 5, 20, 32, 12, 8
STEPS, LR, CLIP = 3, 1e-3, 0.05


def _batch(seed=0, lengths=(20, 14, 0, 9, 17)):  # a zero-length document among them
    rng = np.random.default_rng(seed)
    lengths = np.array(lengths, np.int32)
    tags = (rng.random((B, L)) < 0.2).astype(np.float32)
    tags[np.arange(L)[None, :] >= lengths[:, None]] = -1.0
    return {"src_tokens": rng.standard_normal((B, L, D)).astype(np.float32),
            "src_tokens2": rng.standard_normal((B, L, D2)).astype(np.float32),
            "tgt_tokens": tags, "src_lengths": lengths,
            "domain": np.array([1, 0, 0, 1, 1], np.int32), "n_real": B}


# name -> (architecture, config fields, extra kind, clip)
CASES = {
    "lstm_bi_focal": ("BiLSTM", dict(loss_fn="FocalLoss"), "", 0.0),
    "lstm_bi_ce_clipped": ("BiLSTM", dict(loss_fn="CrossEntropy"), "", CLIP),
    "gru_bi": ("BiLSTM", dict(loss_fn="FocalLoss", lstm=False), "", 0.0),
    "lstm_uni": ("BiLSTM", dict(loss_fn="BinaryCrossEntropy", bidirectional=False), "", 0.0),
    "gru_uni": ("BiLSTM", dict(loss_fn="FocalLoss", lstm=False, bidirectional=False), "", 0.0),
    "transformer": ("Transformer", dict(loss_fn="FocalLoss", nheads=2, attention_window=8), "",
                    0.0),
    "recurrent_longt5": ("RecurrentLongT5", dict(loss_fn="FocalLoss", nheads=2,
                                                 attention_window=4), "", 0.0),
    "crf": ("biLSTMCRF", dict(loss_fn="CrossEntropy"), "", 0.0),
    "sheikh": ("SheikhBiLSTM", dict(loss_fn="BinaryCrossEntropy"), "", 0.0),
    "simple_bilstm": ("SimpleBiLSTM", dict(loss_fn="BinaryCrossEntropy"), "", 0.0),
    "double": ("BiLSTMLateFusion", dict(loss_fn="BinaryCrossEntropy", embedding_dim2=D2),
               "double", 0.0),
    "domain": ("SwitchBiLSTM", dict(loss_fn="CrossEntropy"), "domain", 0.0),
}
# (key, world size, model_parallel) -> the cases run there
GRIDS = {("m2", 2, 2): tuple(CASES), ("2x2", 4, 2): ("lstm_bi_focal", "transformer"),
         ("m4", 4, 4): ("lstm_bi_focal", "transformer")}
DECODES = {"bilstm": ("BiLSTM", dict(loss_fn="CrossEntropy")),
           "transformer": ("Transformer", dict(loss_fn="FocalLoss", nheads=2, attention_window=8))}
TRAINER = ("BiLSTM", dict(loss_fn="FocalLoss", dropout_in=0.1, dropout_out=0.1),
           dict(lr=1e-3, max_epochs=3, seed=0))
VALID = _batch(2, lengths=(20, 14, 6, 9, 17))  # the metrics need a unit a document
GRID_CFG = dict(embedding_dim=12, hidden_dim=8, num_layers=1, loss_fn="FocalLoss")
GRID_RATES = [(0.0, 0.0), (0.2, 0.5), (0.5, 0.2)]


def _cfg(fields):
    return dict(embedding_dim=D, hidden_dim=H, num_layers=2, **fields)


def _jax_first(arch, fields, seed=0):
    jarch = jax_registry.build(arch, JaxTaggerConfig(**_cfg(fields)))
    return jarch, jax.tree.map(np.asarray, jarch.init(jax.random.PRNGKey(seed)))


def _jax_steps(jarch, params, batch, extra, clip):
    """Three Adam steps of the JAX tagger on the whole batch, one device ->
    losses, final params, the first step's gradients as the clipped chain
    hands them to Adam."""
    tx = jax_optimizer("Adam", LR, clip)
    state = tx.init(params)
    x, lengths, tags = (jnp.asarray(batch[k]) for k in ("src_tokens", "src_lengths",
                                                        "tgt_tokens"))

    def loss_fn(p):
        if extra == "domain":
            return jarch.loss(p, x, lengths, tags, jnp.asarray(batch["domain"]), rng=None)
        if extra == "double":
            return jarch.loss(p, x, lengths, tags, rng=None, x2=jnp.asarray(batch["src_tokens2"]))
        return jarch.loss(p, x, lengths, tags, rng=None)

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    losses, first = [], None
    for _ in range(STEPS):
        loss, g = value_and_grad(params)
        if first is None:
            first = g
            if clip:
                norm = optax.global_norm(g)
                assert float(norm) > clip, "the clipped case must clip"
                first = jax.tree.map(lambda t: t / norm * clip, g)
            first = jax.tree.map(np.asarray, first)
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params), first


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """One spawn per world size; the JAX references computed meanwhile in
    this process. -> ({n: [per-rank results]}, references, out dirs)."""
    import threading

    batch = _batch()
    plans, want, firsts = {2: {"steps": {}}, 4: {"steps": {}}}, {}, {}
    for (key, n, m), names in GRIDS.items():
        cases = []
        for name in names:
            arch, fields, extra, clip = CASES[name]
            if name not in firsts:
                firsts[name] = _jax_first(arch, fields)
            cases.append((name, (arch, _cfg(fields), firsts[name][1], batch, STEPS, LR, extra,
                                 clip)))
        plans[n]["steps"][key] = (m, cases)
    decode_params = {}
    for key, (arch, fields) in DECODES.items():
        jarch, params = _jax_first(arch, fields, seed=1)
        # sharper logits: some units above the threshold
        params["cls"]["w"] = params["cls"]["w"] * 20.0
        decode_params[key] = (jarch, params)
        for n, m in ((2, 2), (4, 2)):
            plans[n].setdefault("decode", {})[key] = (m, arch, _cfg(fields), params, batch)
    arch, fields, kw = TRAINER
    plans[2]["trainer"] = (2, arch, _cfg(fields), kw, [batch, _batch(1)], [VALID])
    grid_batch = [{"src_tokens": np.random.default_rng(3).standard_normal((3, 12, 12)).astype(
        np.float32), "tgt_tokens": (np.random.default_rng(4).random((3, 12)) < 0.2).astype(
        np.float32), "src_lengths": np.asarray([12, 9, 7], np.int32), "n_real": 3}]
    runs, outs = {}, {}
    for n in (2, 4):
        outs[n] = str(tmp_path_factory.mktemp(f"tp{n}"))
    plans[4]["grid"] = (2, GRID_CFG, GRID_RATES, grid_batch,
                        dict(lr=1e-3, max_epochs=3, seed=0,
                             check_dir=os.path.join(outs[4], "grid")))
    plans[4]["refuse"] = (3, 2)
    plans[4]["global_mesh"] = 2
    plans[2]["modes"] = (2, "Transformer", _cfg(dict(loss_fn="FocalLoss", nheads=2,
                                                     attention_window=8)))

    errors = []

    def spawn_all():
        try:
            for n in (2, 4):
                spawn_ranks(W.tp_rank, n, (outs[n], plans[n]), "cpu", timeout=300,
                            store_dir=outs[n])
                runs[n] = W.load(outs[n], n)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    thread = threading.Thread(target=spawn_all)
    thread.start()
    try:
        for name, (jarch, params) in firsts.items():
            want[name] = _jax_steps(jarch, params, batch, CASES[name][2], CASES[name][3])
        for key, (jarch, params) in decode_params.items():
            x, lengths = jnp.asarray(batch["src_tokens"]), jnp.asarray(batch["src_lengths"])
            want[f"decode_{key}"] = jax.tree.map(np.asarray,
                                                 jarch.decode(params, x, lengths, 0.5))
    finally:
        thread.join()
    if errors:
        raise errors[0]
    return runs, want, dict(outs=outs, firsts=firsts, grid_batch=grid_batch)


def _close(got, want, atol):
    flat_g, tree_g = jax.tree.flatten(got)
    flat_w, tree_w = jax.tree.flatten(want)
    assert tree_g == tree_w
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol, rtol=0)


STEP_CASES = [(key, n, m, name) for (key, n, m), names in GRIDS.items() for name in names]


@pytest.mark.parametrize("key,n,m,name", STEP_CASES,
                         ids=[f"{key}-{name}" for key, _, _, name in STEP_CASES])
def test_tensor_parallel_steps_match_the_jax_single_device_step(tp_runs, key, n, m, name):
    runs, want, _ = tp_runs
    want_losses, want_params, want_grads = want[name]
    arch, fields, _, _ = CASES[name]
    carried = registry.grads_from_jax(registry.build(arch, TaggerConfig(**_cfg(fields))),
                                      want_grads)
    for rank in runs[n]:
        got = rank["steps"][key]["cases"][name]
        np.testing.assert_allclose(got["losses"], want_losses, atol=LOSS_TOL, rtol=0)
        assert sorted(got["first"]) == sorted(carried)
        for k, g in got["first"].items():
            np.testing.assert_allclose(g, carried[k].numpy(), atol=PARAM_TOL, rtol=0, err_msg=k)
        _close(got["params"], want_params, PARAM_TOL)


@pytest.mark.parametrize("key,n,m,name", STEP_CASES,
                         ids=[f"{key}-{name}" for key, _, _, name in STEP_CASES])
def test_each_rank_holds_the_jax_shards_and_their_adam_state(tp_runs, key, n, m, name):
    runs, _, extra = tp_runs
    arch = CASES[name][0]
    params = extra["firsts"][name][1]
    n_sharded = 0
    for rank in runs[n]:
        run = rank["steps"][key]
        assert run["shape"] == {"data": n // m, "model": m}
        want = type(registry.build(arch, TaggerConfig(**_cfg(CASES[name][1])))).from_jax_params(
            _slices(params, n, m, run["position"]))
        got = run["cases"][name]
        assert sorted(got["shards"]) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got["shards"][k], v.numpy(), err_msg=k)
            shape, state = got["shapes"][k]
            assert shape == tuple(v.shape) and state and all(s == shape for s in state), k
        full = {k: v.shape for k, v in registry.build(
            arch, TaggerConfig(**_cfg(CASES[name][1]))).state_dict().items()}
        n_sharded += sum(got["shards"][k].shape != full[k] for k in full)
    assert n_sharded > 0  # the gate-stacked and linear weights are split


def _slices(params, n, m, position):
    """The leaves of `params` that JAX's `param_shardings` places on the
    device at (data, model) `position` of its n-device mesh."""
    jmesh = jax_make_mesh(n, model_parallel=m)
    device = jmesh.devices[position]
    return jax.tree.map(lambda a, s: np.asarray(a)[s.devices_indices_map(a.shape)[device]],
                        params, param_shardings(jmesh, params))


@pytest.mark.parametrize("n,key", [(2, k) for k in DECODES] + [(4, k) for k in DECODES])
def test_sharded_decode_over_model_gives_the_jax_single_device_tags(tp_runs, n, key):
    runs, want, _ = tp_runs
    want_scores, want_tags = want[f"decode_{key}"]
    assert 0 < want_tags.sum() < want_tags.size
    for rank in runs[n]:
        scores, tags = rank["decode"][key]
        np.testing.assert_array_equal(tags, want_tags)
        np.testing.assert_allclose(scores, want_scores, atol=LOSS_TOL, rtol=0)


def test_tensor_parallel_trainer_fits_and_checkpoints_as_one_process(tp_runs, tmp_path):
    """Dropout 0.1: the two model ranks draw the masks of one process with
    the same seed. Position (0, 0) writes the single-device checkpoint,
    which predict serves as it serves the one-process one."""
    from multimodaltopicsegmentation_torch.cli.predict import cli_main as predict
    from multimodaltopicsegmentation_torch.train import checkpoints as ckpt_lib

    runs, _, _ = tp_runs
    arch, fields, kw = TRAINER
    trainer = Trainer(arch, TaggerConfig(**_cfg(fields)), check_dir=str(tmp_path / "one"),
                      device="cpu", **kw)
    want_params, want_history = trainer.fit([_batch(), _batch(1)], [VALID])
    want_test = trainer.test(want_params, [VALID])[0]
    assert [r["trainer"]["writer"] for r in runs[2]] == [True, False]
    assert len({r["trainer"]["seed"] for r in runs[2]}) == 1
    for rank in runs[2]:
        got = rank["trainer"]
        for k in ("training_loss", "val_loss"):
            np.testing.assert_allclose([h[k] for h in got["history"]],
                                       [h[k] for h in want_history], atol=LOSS_TOL, rtol=0)
        _close(got["params"], want_params, LOSS_TOL)
        assert got["test"] == want_test
        assert os.path.basename(got["path"]) == os.path.basename(trainer.best_model_path)
    got_ckpt, want_ckpt = (ckpt_lib.load(p) for p in (runs[2][0]["trainer"]["path"],
                                                       trainer.best_model_path))
    _close(got_ckpt[0], want_ckpt[0], LOSS_TOL)
    assert got_ckpt[1:3] == want_ckpt[1:3]
    emb = tmp_path / "emb"
    emb.mkdir()
    rng = np.random.default_rng(5)
    for d, units in enumerate((40, 9, 25)):
        np.save(emb / f"doc{d}.npy", rng.standard_normal((units, D)).astype(np.float32))
    hyp = tmp_path / "results.txt"
    hyp.write_text(f"Sentence encoder: wav2vec_mean\nNeural architecture: {arch}\n")
    results = []
    for name, ckpt in (("tp", runs[2][0]["trainer"]["path"]),
                       ("one", trainer.best_model_path)):
        predict(["-ef", str(emb), "-hyp", str(hyp), "-model", ckpt, "-rjs", "--device", "cpu",
                 "-exp", str(tmp_path / f"exp_{name}")])
        with open(tmp_path / f"exp_{name}" / "results.pkl", "rb") as f:
            results.append(pickle.load(f))
    assert results[0] == results[1]
    assert [len(results[0][f"doc{d}.npy"]) for d in range(3)] == [40, 9, 25]


def test_grid_trainer_over_a_data_model_grid_equals_the_serial_grid(tp_runs, tmp_path):
    """Configurations over the 2 data coordinates, each run alike by its 2
    model ranks; model index 0 writes."""
    runs, _, extra = tp_runs
    gt = GridTrainer("BiLSTM", TaggerConfig(**GRID_CFG), GRID_RATES, device="cpu", lr=1e-3,
                     max_epochs=3, seed=0, check_dir=str(tmp_path))
    finals, histories = gt.fit(extra["grid_batch"], extra["grid_batch"])
    for rank in runs[4]:
        got_finals, got_histories, paths, final_paths = rank["grid"]
        assert got_histories == histories
        assert [os.path.basename(p) for p in paths] == [
            os.path.basename(p) for p in gt.best_model_paths]
        _close(got_finals, finals, 0.0)
        assert all(os.path.exists(p) for p in paths + final_paths)


def test_a_mesh_that_does_not_divide_is_refused(tp_runs):
    runs, _, _ = tp_runs
    for rank in runs[4]:
        assert rank["refuse"] and "does not divide" in rank["refuse"]


def test_a_model_axis_refuses_the_other_modes_and_multihost_builds_it(tp_runs):
    """As JAX's Trainer keeps its modes apart; `multihost.global_mesh(2)`
    over 4 ranks is the 2 x 2 grid."""
    runs, _, _ = tp_runs
    for rank in runs[2]:
        assert all(msg and "exclusive" in msg for msg in rank["modes"]), rank["modes"]
    for rank in runs[4]:
        assert rank["global_mesh"] == {"data": 2, "model": 2}


def test_dryrun_at_four_ranks_runs_model_parallel_two():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run(
        [sys.executable, "-m", "multimodaltopicsegmentation_torch.parallel.dryrun", "--nproc",
         "4", "--device", "cpu"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith("dryrun(4): mesh={'data': 4, 'model': 1} loss=")
    assert "tp_mesh={'data': 2, 'model': 2} tp_loss=" in line
    assert line.endswith("seq_parallel=ok pipeline=ok expert=ok grid=ok multihost=ok ok")


# the tensor-parallel cases on the card: cuDNN's place taken by the sharded
# recurrence, and the flash layers without and with T5's bias (K4 or K5)
CARD_CASES = {"lstm_bi_focal": (0, 0, 0, 0), "transformer": (2, 2, 0, 2),
              "recurrent_longt5": (2, 0, 2, 2)}  # flash launches a step: K2, K4, K5, K3


@pytest.mark.cuda
def test_cuda_two_ranks_on_one_card_match_one_rank(tmp_path):
    """A (data 1, model 2) mesh of two ranks sharing the card (gloo) against
    one rank on it: the Adam steps against one rank's data-parallel steps
    (losses to 1e-5, first-step gradients and parameters to 1e-4, the same
    flash launches), the sharded Transformer decode (scores to 1e-5, the
    same tags) and `Trainer(mesh)` with dropout 0.1 (history to 1e-5,
    parameters, test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    batch = _batch()
    cases = []
    for name in CARD_CASES:
        arch, fields, extra, clip = CASES[name]
        params = registry.build(arch, TaggerConfig(**_cfg(fields)),
                                torch.Generator().manual_seed(0)).to_jax_params()
        cases.append((name, (arch, _cfg(fields), params, batch, STEPS, LR, extra, clip)))
    arch, fields = DECODES["transformer"]
    decode_params = registry.build(arch, TaggerConfig(**_cfg(fields)),
                                   torch.Generator().manual_seed(1)).to_jax_params()
    decode_params["cls"]["w"] = decode_params["cls"]["w"] * 20.0
    t_arch, t_fields, kw = TRAINER
    runs = {}
    for m in (1, 2):
        plan = {"decode": {"transformer": (m, arch, _cfg(fields), decode_params, batch)},
                "trainer": (m, t_arch, _cfg(t_fields), kw, [batch, _batch(1)], [VALID])}
        if m == 2:
            plan["steps"] = {"card": (m, cases)}
        out = tmp_path / f"m{m}"
        out.mkdir()
        W.spawn_on_one_card(W.tp_rank, m, (str(out), plan), str(out))
        runs[m] = W.load(str(out), m)
    out = tmp_path / "dp1"
    out.mkdir()
    W.spawn_on_one_card(W.dp_steps, 1, (str(out), [(name, *case[:7]) for name, case in cases]),
                        str(out))
    (steps,) = W.load(str(out), 1)
    (one,) = runs[1]
    for rank in runs[2]:
        assert rank["steps"]["card"]["shape"] == {"data": 1, "model": 2}
        for name, per_step in CARD_CASES.items():
            got = rank["steps"]["card"]["cases"][name]
            losses, params, first = steps[name]
            np.testing.assert_allclose(got["losses"], losses, atol=LOSS_TOL, rtol=0)
            assert sorted(got["first"]) == sorted(first)
            for k, g in first.items():
                np.testing.assert_allclose(got["first"][k], g, atol=PARAM_TOL, rtol=0, err_msg=k)
            _close(got["params"], params, PARAM_TOL)
            assert got["launches"] == steps["launches"][name] == tuple(STEPS * n
                                                                       for n in per_step)
        scores, tags = rank["decode"]["transformer"]
        want_scores, want_tags = one["decode"]["transformer"]
        assert 0 < want_tags.sum() < want_tags.size
        np.testing.assert_array_equal(tags, want_tags)
        np.testing.assert_allclose(scores, want_scores, atol=LOSS_TOL, rtol=0)
        got, want = rank["trainer"], one["trainer"]
        for k in ("training_loss", "val_loss"):
            np.testing.assert_allclose([h[k] for h in got["history"]],
                                       [h[k] for h in want["history"]], atol=LOSS_TOL, rtol=0)
        _close(got["params"], want["params"], PARAM_TOL)
        assert got["test"] == want["test"]
