"""The port's parallel layer on gloo ranks on the CPU (parallel/mesh.py,
parallel/train_step.py, the sharded grid and decode, the dryrun), held to
the JAX package's single-device functions on numpy-seeded inputs; the JAX
shard_map suites (tests/test_parallel.py) show that sharded equals
single-device there.

- data parallelism: 3 Adam steps from the JAX first weights on an odd batch
  (a zero-length document pads it) at 2 and 4 ranks, for the '' / 'double'
  / 'domain' extras, a CRF, SheikhBiLSTM and the cosine loss: losses to
  1e-5, the first step's summed gradients (which Adam's update would not
  show scaled) and the parameters to 1e-4, every rank's state the same;
- every architecture's loss (each head loss for BiLSTM) on 2 ranks: the
  ranks' parts on their shares add up to the loss on the whole batch, and
  so do their gradients (`ops.losses.reduce_count` takes each count);
  `Trainer(mesh)` with SGD, whose update shows a gradient's scale, fits as
  one process does;
- the sharded predict decode over 2 ranks: results.pkl equal to the JAX
  predict CLI's;
- `GridTrainer(mesh)` equal to the serial grid;
- the dryrun at 2 ranks prints its ok line.
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
from multimodaltopicsegmentation_tpu.train import checkpoints as jax_ckpt
from multimodaltopicsegmentation_tpu.train.loop import make_optimizer as jax_optimizer
from multimodaltopicsegmentation_torch.models import registry
from multimodaltopicsegmentation_torch.models.base import TaggerConfig
from multimodaltopicsegmentation_torch.parallel import mesh as PM
from multimodaltopicsegmentation_torch.parallel.dryrun import spawn_ranks
from multimodaltopicsegmentation_torch.train.loop import Trainer

pytestmark = pytest.mark.torch_distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL, PARAM_TOL = 1e-5, 1e-4
B, L, D, D2 = 5, 20, 32, 12


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([20, 14, 0, 9, 17], np.int32)  # a zero-length document among them
    tags = (rng.random((B, L)) < 0.2).astype(np.float32)
    tags[np.arange(L)[None, :] >= lengths[:, None]] = -1.0
    return {"src_tokens": rng.standard_normal((B, L, D)).astype(np.float32),
            "src_tokens2": rng.standard_normal((B, L, D2)).astype(np.float32),
            "tgt_tokens": tags, "src_lengths": lengths,
            "domain": np.array([1, 0, 0, 1, 1], np.int32), "n_real": B}


# name -> (architecture, config fields, extra kind)
CASES = {
    "bilstm_focal": ("BiLSTM", dict(loss_fn="FocalLoss"), ""),
    "late_fusion_bce": ("BiLSTMLateFusion", dict(loss_fn="BinaryCrossEntropy",
                                                 embedding_dim2=D2), "double"),
    "switch_dense_ce": ("SwitchBiLSTM", dict(loss_fn="CrossEntropy"), "domain"),
    "crf": ("biLSTMCRF", dict(loss_fn="CrossEntropy"), ""),
    "bilstm_cosine": ("BiLSTM", dict(loss_fn="FocalLoss", cosine_loss=True), ""),
    "sheikh_bce": ("SheikhBiLSTM", dict(loss_fn="BinaryCrossEntropy"), ""),
}
FOUR_RANK_CASES = ("bilstm_focal", "crf")
STEPS, LR = 3, 1e-3


def _cfg(fields):
    return dict(embedding_dim=D, hidden_dim=16, num_layers=2, **fields)


def _jax_first(arch, fields, seed=0):
    jarch = jax_registry.build(arch, JaxTaggerConfig(**_cfg(fields)))
    return jarch, jax.tree.map(np.asarray, jarch.init(jax.random.PRNGKey(seed)))


def _jax_steps(jarch, params, batch, extra):
    """Three Adam steps of the JAX tagger on the whole batch, one device."""
    tx = jax_optimizer("Adam", LR)
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
        first = jax.tree.map(np.asarray, g) if first is None else first
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params), first


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Each case's data-parallel steps at 2 ranks (every case) and 4 ranks
    (FOUR_RANK_CASES): {n: [per-rank results]}; and the JAX references."""
    batch = _batch()
    runs, want = {}, {}
    for n, names in ((2, tuple(CASES)), (4, FOUR_RANK_CASES)):
        cases = []
        for name in names:
            arch, fields, extra = CASES[name]
            jarch, params = _jax_first(arch, fields)
            want[name] = _jax_steps(jarch, params, batch, extra)
            cases.append((name, arch, _cfg(fields), params, batch, STEPS, LR, extra))
        out = tmp_path_factory.mktemp(f"dp{n}")
        spawn_ranks(W.dp_steps, n, (str(out), cases), "cpu", timeout=300, store_dir=str(out))
        runs[n] = W.load(str(out), n)
    return runs, want


def _close(got, want, atol):
    flat_g, tree_g = jax.tree.flatten(got)
    flat_w, tree_w = jax.tree.flatten(want)
    assert tree_g == tree_w
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol, rtol=0)


@pytest.mark.parametrize("n,name", [(2, c) for c in CASES] + [(4, c) for c in FOUR_RANK_CASES])
def test_data_parallel_steps_match_the_jax_single_device_step(dp_runs, n, name):
    runs, want = dp_runs
    want_losses, want_params, want_grads = want[name]
    got_losses, got_params, got_grads = runs[n][0][name]
    np.testing.assert_allclose(got_losses, want_losses, atol=LOSS_TOL, rtol=0)
    arch, fields, _ = CASES[name]
    carried = registry.grads_from_jax(registry.build(arch, TaggerConfig(**_cfg(fields))),
                                      want_grads)
    assert sorted(got_grads) == sorted(carried)
    for key, g in got_grads.items():
        np.testing.assert_allclose(g, carried[key].numpy(), atol=PARAM_TOL, rtol=0, err_msg=key)
    _close(got_params, want_params, PARAM_TOL)
    for other in runs[n][1:]:  # one replicated state on every rank, to the bit
        assert other[name][0] == got_losses
        _close(other[name][1], got_params, 0.0)
        _close(other[name][2], got_grads, 0.0)


# every architecture the registry builds, and BiLSTM under each head loss
PART_FIELDS = dict(nheads=4, attention_window=4, embedding_dim2=D2)
PART_CASES = {
    "BiLSTM_focal": ("BiLSTM", dict(loss_fn="FocalLoss"), ""),
    "BiLSTM_bce": ("BiLSTM", dict(loss_fn="BinaryCrossEntropy"), ""),
    "BiLSTM_ce": ("BiLSTM", dict(loss_fn="CrossEntropy"), ""),
    "BiLSTM_cosine": ("BiLSTM", dict(loss_fn="FocalLoss", cosine_loss=True), ""),
    "biLSTMCRF": ("biLSTMCRF", dict(loss_fn="CrossEntropy"), ""),
    "BiLSTMLateFusion": ("BiLSTMLateFusion", dict(loss_fn="FocalLoss"), "double"),
    "SimpleBiLSTM": ("SimpleBiLSTM", dict(loss_fn="BinaryCrossEntropy"), ""),
    "MLP": ("MLP", dict(loss_fn="BinaryCrossEntropy"), ""),
    "SheikhBiLSTM": ("SheikhBiLSTM", dict(loss_fn="BinaryCrossEntropy"), ""),
    "SwitchBiLSTM_dense": ("SwitchBiLSTM", dict(loss_fn="FocalLoss"), "domain"),
    "SwitchBiLSTM_lstm": ("SwitchBiLSTM", dict(loss_fn="CrossEntropy", switch="lstm"), "domain"),
    "Transformer": ("Transformer", dict(loss_fn="FocalLoss"), ""),
    "Transformer-CRF": ("Transformer-CRF", dict(loss_fn="CrossEntropy"), ""),
    "RecurrentLongT5": ("RecurrentLongT5", dict(loss_fn="FocalLoss"), ""),
    "BiLSTMRestrictedMHA": ("BiLSTMRestrictedMHA", dict(loss_fn="BinaryCrossEntropy"), ""),
    "RecurrentLongformer": ("RecurrentLongformer", dict(loss_fn="CrossEntropy"), ""),
}
FIT = dict(lr=0.05, optimizer="SGD", max_epochs=3, seed=0)


@pytest.fixture(scope="module")
def part_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("parts")
    cases = [(name, arch, _cfg({**PART_FIELDS, **fields}), extra)
             for name, (arch, fields, extra) in PART_CASES.items()]
    fit = ("BiLSTM", _cfg(dict(loss_fn="FocalLoss")), FIT)
    spawn_ranks(W.loss_parts, 2, (str(out), cases, _batch(), fit), "cpu", timeout=300,
                store_dir=str(out))
    return W.load(str(out), 2)


@pytest.mark.parametrize("name", list(PART_CASES))
def test_every_loss_splits_into_parts_over_the_batch_count(part_runs, name):
    """A part that divided by its share's own count (a local mean) would add
    up to about twice the loss on 2 ranks: the shares' counts differ."""
    for rank in part_runs:
        got = rank[name]
        np.testing.assert_allclose(got["parts"], got["loss"], atol=LOSS_TOL, rtol=0)
        assert sorted(got["part_grads"]) == sorted(got["grads"])
        for key, g in got["grads"].items():
            np.testing.assert_allclose(got["part_grads"][key], g, atol=LOSS_TOL, rtol=0,
                                       err_msg=key)


def test_data_parallel_trainer_fits_as_one_process(part_runs, tmp_path):
    arch, cfg, kw = "BiLSTM", _cfg(dict(loss_fn="FocalLoss")), FIT
    trainer = Trainer(arch, TaggerConfig(**cfg), check_dir=str(tmp_path), device="cpu", **kw)
    want_params, want_history = trainer.fit([_batch()], [_batch()])
    for rank in part_runs:
        got_params, got_history = rank["fit"]
        assert [h["epoch"] for h in got_history] == [h["epoch"] for h in want_history]
        for key in ("training_loss", "val_loss"):
            np.testing.assert_allclose([h[key] for h in got_history],
                                       [h[key] for h in want_history], atol=LOSS_TOL, rtol=0)
        _close(got_params, want_params, LOSS_TOL)


def test_shard_batch_pads_an_odd_batch_with_zero_length_documents():
    batch = _batch()
    padded = PM.pad_batch_axis(batch, 2)
    assert len(padded["src_lengths"]) == 6 and padded["n_real"] == 5
    assert padded["src_lengths"][5] == 0 and (padded["tgt_tokens"][5] == -1).all()
    assert not padded["src_tokens"][5].any() and padded["domain"][5] == 0
    assert PM.pad_batch_axis(padded, 2) is padded
    # this process (rank 0 without a group) as mesh index 0, then as index 1
    shares = [PM.shard_batch(PM.Mesh(None, ranks, torch.device("cpu"), "gloo"), batch)
              for ranks in ((0, 1), (1, 0))]
    assert [len(s["src_lengths"]) for s in shares] == [3, 3]
    assert [s["n_real"] for s in shares] == [3, 2]
    for key in ("src_tokens", "src_tokens2", "tgt_tokens", "src_lengths", "domain"):
        np.testing.assert_array_equal(np.concatenate([s[key] for s in shares]), padded[key])
    assert PM.shard_batch(None, shares[1]) is shares[1]  # a share stays as it is


def test_backend_rule_and_param_spec(tmp_path):
    assert PM.backend_for(2, "cpu") == "gloo"
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert PM.backend_for(cards + 1, "cuda") == "gloo"  # more ranks than cards
    if cards:
        assert PM.backend_for(cards, "cuda") == "nccl"
    assert PM.param_spec("rnn/0/fwd/w_hh") == (None, "model")
    assert PM.param_spec("crf/transitions") == ()
    assert PM.param_spec("rnn/0/fwd/b_ih") == ("model",)
    assert PM.param_spec("cls/w") == ("model", None)
    W.check_model_axis_refusals(str(tmp_path))
    with pytest.raises(RuntimeError, match="no process group"):
        PM.make_mesh()


def test_sharded_predict_decode_matches_the_jax_predict_cli(tmp_path, monkeypatch):
    """Two ranks decode each chunk's documents (padded to a multiple of the
    ranks); rank 0 writes results.pkl, equal to the JAX CLI's."""
    from multimodaltopicsegmentation_tpu.cli.predict import cli_main as jax_predict

    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: devices(*a)[:1])
    rng = np.random.default_rng(0)
    emb = tmp_path / "emb"
    emb.mkdir()
    for d, n in enumerate((70, 9, 130, 33, 51)):  # 5 documents: chunks of 2 pad to 2 ranks
        np.save(emb / f"doc{d}.npy", rng.standard_normal((n, 32)).astype(np.float32))
    cfg = JaxTaggerConfig(embedding_dim=32, hidden_dim=32, num_layers=2, nheads=4,
                          attention_window=8, loss_fn="FocalLoss")
    params = jax.tree.map(np.asarray,
                          jax_registry.build("Transformer", cfg).init(jax.random.PRNGKey(1)))
    params["cls"]["w"] = params["cls"]["w"] * 20.0
    ckpt = str(tmp_path / "ckpt" / "best_model")
    jax_ckpt.save(ckpt, params, cfg, "Transformer")
    hyp = tmp_path / "results.txt"
    hyp.write_text("Sentence encoder: wav2vec_mean\nNeural architecture: Transformer\n")
    common = ["-ef", str(emb), "-hyp", str(hyp), "-model", ckpt, "-bs", "3", "-rjs"]
    jax_predict(common + ["-exp", str(tmp_path / "jexp")])
    spawn_ranks(W.run_cli, 2, ("multimodaltopicsegmentation_torch.cli.predict",
                               common + ["-exp", str(tmp_path / "texp"), "--device", "cpu"],
                               str(tmp_path)), "cpu", timeout=300, store_dir=str(tmp_path))
    results = []
    for exp in ("jexp", "texp"):
        with open(tmp_path / exp / "results.pkl", "rb") as f:
            results.append(pickle.load(f))
    assert results[1] == results[0]
    assert [len(results[1][f"doc{d}.npy"]) for d in range(5)] == [70, 9, 130, 33, 51]
    assert 0 < sum(map(sum, results[1].values())) < 293


def test_grid_trainer_over_a_mesh_equals_the_serial_grid(tmp_path):
    """Configurations 0 and 2 on rank 0, 1 on rank 1: histories, snapshot
    names and final parameters equal to the serial GridTrainer's, on every
    rank."""
    from multimodaltopicsegmentation_torch.train.grid import GridTrainer

    cfg = dict(embedding_dim=12, hidden_dim=8, num_layers=1, loss_fn="FocalLoss")
    grid = [(0.0, 0.0), (0.2, 0.5), (0.5, 0.2)]
    rng = np.random.default_rng(3)
    batches = [{"src_tokens": rng.standard_normal((3, 12, 12)).astype(np.float32),
                "tgt_tokens": (rng.random((3, 12)) < 0.2).astype(np.float32),
                "src_lengths": np.asarray([12, 9, 7], np.int32), "n_real": 3}]
    kw = dict(lr=1e-3, max_epochs=3, seed=0, check_dir=str(tmp_path / "ranks"))
    spawn_ranks(W.grid_fit, 2, (str(tmp_path), cfg, grid, batches, kw), "cpu", timeout=300,
                store_dir=str(tmp_path))
    kw["check_dir"] = str(tmp_path / "serial")
    gt = GridTrainer("BiLSTM", TaggerConfig(**cfg), grid, device="cpu", **kw)
    finals, histories = gt.fit(batches, batches)
    for got_finals, got_histories, paths, final_paths in W.load(str(tmp_path), 2):
        assert got_histories == histories
        assert [os.path.basename(p) for p in paths] == [
            os.path.basename(p) for p in gt.best_model_paths]
        _close(got_finals, finals, 0.0)
        assert all(os.path.exists(p) for p in final_paths)


def test_dryrun_at_two_ranks_prints_ok():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run(
        [sys.executable, "-m", "multimodaltopicsegmentation_torch.parallel.dryrun", "--nproc",
         "2", "--device", "cpu"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith("dryrun(2): mesh={'data': 2, 'model': 1} loss=")
    assert line.endswith("seq_parallel=ok pipeline=ok expert=ok grid=ok multihost=ok ok")
    assert "backend gloo" in proc.stderr


def test_a_failing_rank_fails_the_launch(tmp_path):
    with pytest.raises(torch.multiprocessing.ProcessRaisedException, match="no_such_cli"):
        spawn_ranks(W.run_cli, 2, ("multimodaltopicsegmentation_torch.cli.no_such_cli", [],
                                   str(tmp_path)), "cpu", timeout=120, store_dir=str(tmp_path))
