"""The port's grid trainer (train/grid.py) on the CPU.

Configuration g of a `GridTrainer` equals a serial port `Trainer` run of g
with the same seed, at nonzero dropout: history to 1e-6 (they are equal: the
same weights, generator and ops), the same snapshot names and weights,
`save_final` equal; early stops freeze a configuration; the `tag` keeps
folds apart; BiLSTMLateFusion and SimpleBiLSTM. Against the JAX package's
`GridTrainer` at dropout 0 from the JAX first weights: histories to 1e-5
and the same file layout. `train_fit -pg` writes what the serial CLI writes,
with a standard split and with k folds. Mirrors tests/test_grid_trainer.py.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from multimodaltopicsegmentation_tpu.models import registry as jax_registry
from multimodaltopicsegmentation_tpu.models.base import TaggerConfig as JaxTaggerConfig
from multimodaltopicsegmentation_tpu.train.grid import GridTrainer as JaxGridTrainer
from multimodaltopicsegmentation_torch.models.base import TaggerConfig
from multimodaltopicsegmentation_torch.train import checkpoints as ckpt
from multimodaltopicsegmentation_torch.train import loop as TLoop
from multimodaltopicsegmentation_torch.train.grid import GridTrainer
from synth import make_synthetic_corpus  # tests/synth.py: pytest puts this file's directory on sys.path

torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-6
JAX_ATOL = 1e-5
GRID = [(0.0, 0.0), (0.2, 0.5), (0.5, 0.2)]


def _batches(seed, n=2, B=4, L=20, dim=12, dim2=None):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = np.array([L, 15, 9, 4][:B], np.int32)
        tags = (rng.random((B, L)) < 0.2).astype(np.float32)
        tags[np.arange(L)[None, :] >= lengths[:, None]] = -1.0
        b = {"src_tokens": rng.standard_normal((B, L, dim)).astype(np.float32),
             "tgt_tokens": tags, "src_lengths": lengths, "n_real": B}
        if dim2:
            b["src_tokens2"] = rng.standard_normal((B, L, dim2)).astype(np.float32)
        out.append(b)
    return out


def _cfg(**kw):
    base = dict(embedding_dim=12, hidden_dim=8, num_layers=1, loss_fn="FocalLoss")
    base.update(kw)
    return TaggerConfig(**base)


def _serial(tmp_path, arch, cfg, g, train, valid, device="cpu", **kw):
    din, dout = GRID[g]
    t = TLoop.Trainer(arch, dataclasses.replace(cfg, dropout_in=din, dropout_out=dout),
                      check_dir=str(tmp_path / f"serial{g}"), seed=42, device=device, **kw)
    params, _ = t.fit(train, valid)
    return t, params


def _grid(tmp_path, arch, cfg, train, valid, grid=GRID, device="cpu", **kw):
    gt = GridTrainer(arch, cfg, grid, check_dir=str(tmp_path / "grid"), seed=42, device=device,
                     **kw)
    gt.fit(train, valid)
    return gt


def _assert_history(got, want, atol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["epoch"] == b["epoch"]
        assert a["training_loss"] == pytest.approx(b["training_loss"], abs=atol)
        if b["val_loss"] is None:
            assert a["val_loss"] is None
        else:
            assert a["val_loss"] == pytest.approx(b["val_loss"], abs=atol)


def _assert_same_weights(a, b, atol=ATOL):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=atol)


@pytest.mark.parametrize("arch,dim2", [("BiLSTM", None), ("BiLSTMLateFusion", 9)])
def test_grid_matches_serial_runs_at_nonzero_dropout(tmp_path, arch, dim2):
    train, valid = _batches(0, dim2=dim2), _batches(1, n=1, dim2=dim2)
    cfg = _cfg(embedding_dim2=dim2 or 0)
    kw = dict(lr=1e-2, max_epochs=4, patience=2)
    gt = _grid(tmp_path, arch, cfg, train, valid, **kw)
    for g, (din, dout) in enumerate(GRID):
        st, _ = _serial(tmp_path, arch, cfg, g, train, valid, **kw)
        _assert_history(gt.histories[g], st.history, ATOL)
        assert os.path.basename(gt.best_model_paths[g]) == os.path.basename(st.best_model_path)
        assert os.path.dirname(gt.best_model_paths[g]).endswith(f"grid_di{din:g}_do{dout:g}")
        pg, cfg_g, arch_g, _ = ckpt.load(gt.best_model_paths[g])
        assert (cfg_g.dropout_in, cfg_g.dropout_out, arch_g) == (din, dout, arch)
        _assert_same_weights(pg, ckpt.load(st.best_model_path)[0])


@pytest.mark.cuda
def test_cuda_grid_matches_serial_runs(tmp_path):
    """On the card (cuDNN's LSTM), at nonzero dropout: each configuration of
    the grid against its serial `Trainer` run there, as on the CPU: history
    to 1e-6, the same snapshot names and weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    train, valid = _batches(0), _batches(1, n=1)
    cfg = _cfg()
    kw = dict(lr=1e-2, max_epochs=4, patience=2, device="cuda")
    gt = _grid(tmp_path, "BiLSTM", cfg, train, valid, **kw)
    for g in range(len(GRID)):
        st, _ = _serial(tmp_path, "BiLSTM", cfg, g, train, valid, **kw)
        _assert_history(gt.histories[g], st.history, ATOL)
        assert os.path.basename(gt.best_model_paths[g]) == os.path.basename(st.best_model_path)
        _assert_same_weights(ckpt.load(gt.best_model_paths[g])[0],
                             ckpt.load(st.best_model_path)[0])


def test_grid_early_stop_freezes_a_configuration(tmp_path):
    """patience 1: configurations stop at their own epochs; each history
    ends there, and the final and best weights are the serial run's."""
    train, valid = _batches(0), _batches(1, n=1)
    kw = dict(lr=1e-2, max_epochs=12, patience=1)
    gt = _grid(tmp_path, "BiLSTM", _cfg(), train, valid, **kw)
    for g in range(len(GRID)):
        st, final = _serial(tmp_path, "BiLSTM", _cfg(), g, train, valid, **kw)
        _assert_history(gt.histories[g], st.history, ATOL)
        assert len(st.history) < 12 and gt._stop_params[g] is not None
        _assert_same_weights(gt.final_params(g), final)
        _assert_same_weights(ckpt.load(gt.best_model_paths[g])[0],
                             ckpt.load(st.best_model_path)[0])


def test_grid_save_final_matches_serial(tmp_path):
    train = _batches(0)
    kw = dict(lr=1e-2, max_epochs=3, monitor="training_loss", no_early_stop=True)
    gt = _grid(tmp_path, "BiLSTM", _cfg(), train, None, grid=GRID[:2], **kw)
    for g in range(2):
        path = gt.save_final(g)
        assert path.endswith("final=0.500.ckpt") and gt.best_model_paths[g] == path
        _, final = _serial(tmp_path, "BiLSTM", _cfg(), g, train, None, **kw)
        _assert_same_weights(ckpt.load(path)[0], final)


def test_grid_tag_keeps_fold_checkpoints_apart(tmp_path):
    train = _batches(0)
    paths = []
    for tag in ("f0", "f1"):
        gt = GridTrainer("BiLSTM", _cfg(), GRID[:2], lr=1e-2, max_epochs=2, no_early_stop=True,
                         monitor="training_loss", check_dir=str(tmp_path / "shared"), seed=42,
                         tag=tag, device="cpu")
        gt.fit(train, None)
        paths.extend(gt.save_final(g) for g in range(2))
    assert len(set(paths)) == 4 and all(os.path.exists(p) for p in paths)
    assert sorted(os.listdir(tmp_path / "shared")) == [
        "grid_f0_di0.2_do0.5", "grid_f0_di0_do0", "grid_f1_di0.2_do0.5", "grid_f1_di0_do0"]


def test_grid_simplebilstm_trains_identical_configurations(tmp_path):
    """SimpleBiLSTM has no dropout: every configuration is the serial run."""
    train, valid = _batches(0), _batches(1, n=1)
    cfg = _cfg(loss_fn="BinaryCrossEntropy")
    kw = dict(lr=1e-2, max_epochs=3, patience=2)
    gt = _grid(tmp_path, "SimpleBiLSTM", cfg, train, valid, **kw)
    st, _ = _serial(tmp_path, "SimpleBiLSTM", cfg, 0, train, valid, **kw)
    for g in range(len(GRID)):
        _assert_history(gt.histories[g], st.history, ATOL)


def test_grid_rejects_unsupported_architectures_and_a_mesh(tmp_path):
    with pytest.raises(ValueError, match="grid training supports"):
        GridTrainer("Transformer", _cfg(), GRID, device="cpu")
    with pytest.raises(ValueError, match="grid training supports"):
        GridTrainer("biLSTMCRF", _cfg(), GRID, device="cpu")
    # a mesh spreads the configurations over its ranks (tests/test_torch_parallel.py,
    # tests/test_torch_tensor_parallel.py); a "model" axis needs a process group
    # and a rank count it divides
    import torch_dist_workers as W

    W.check_model_axis_refusals(str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GridTrainer("BiLSTM", _cfg(), GRID)  # the default device is cuda


def _jax_first_weights(monkeypatch):
    """Port trainers start from the weights JAX draws for the same seed."""
    build = TLoop.Trainer._build

    def _build(self):
        build(self)
        fields = {f.name: getattr(self.cfg, f.name) for f in dataclasses.fields(self.cfg)
                  if f.name != "dtype"}
        jarch = jax_registry.build(self.arch_name, JaxTaggerConfig(**fields))
        k_init = jax.random.split(jax.random.PRNGKey(self.seed))[1]
        params = jax.tree.map(np.asarray, jarch.init(k_init))
        self.tagger.load_state_dict(type(self.tagger).from_jax_params(params))

    monkeypatch.setattr(TLoop.Trainer, "_build", _build)


@pytest.mark.parametrize("arch,grid,loss_fn", [
    ("SimpleBiLSTM", GRID, "BinaryCrossEntropy"),  # no dropout in the architecture
    ("BiLSTM", [(0.0, 0.0)], "FocalLoss")])
def test_grid_matches_the_jax_grid_trainer_at_dropout_0(tmp_path, monkeypatch, arch, grid,
                                                        loss_fn):
    _jax_first_weights(monkeypatch)
    train, valid = _batches(0), _batches(1, n=1)
    fields = dict(embedding_dim=12, hidden_dim=8, num_layers=1, loss_fn=loss_fn)
    kw = dict(lr=1e-2, max_epochs=4, patience=2, seed=42)
    jt = JaxGridTrainer(arch, JaxTaggerConfig(**fields), grid, check_dir=str(tmp_path / "j"), **kw)
    jt.fit([dict(b) for b in train], [dict(b) for b in valid])
    gt = GridTrainer(arch, TaggerConfig(**fields), grid, check_dir=str(tmp_path / "t"),
                     device="cpu", **kw)
    gt.fit(train, valid)
    for g in range(len(grid)):
        _assert_history(gt.histories[g], jt.histories[g], JAX_ATOL)
        assert os.path.relpath(gt.best_model_paths[g], tmp_path / "t") == \
            os.path.relpath(jt.best_model_paths[g], tmp_path / "j")
        _assert_same_weights(ckpt.load(gt.best_model_paths[g])[0],
                             ckpt.load(jt.best_model_paths[g])[0], JAX_ATOL)


def _run_cli(argv):
    from multimodaltopicsegmentation_torch.cli import train_fit

    cwd = os.getcwd()
    try:
        return train_fit.cli_main(argv)
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("kfold", [False, True])
def test_parallel_grid_cli_matches_serial(tmp_path, kfold):
    """train_fit -pg writes the serial grid's results.txt, per-document
    scores and grid CSVs; with k folds each (configuration, fold) tests its
    own weights."""
    emb_dir, lab_file, split = make_synthetic_corpus(str(tmp_path / "c"), n_docs=8, dim=30)
    argv = ["-arc", "BiLSTM", "-enc", "CNN", "-ef", emb_dir, "-lf", lab_file, "-lr", "1e-2",
            "-bs", "4", "-max", "3", "-vp", "0.25", "-pat", "3", "-loss", "FocalLoss", "-ar",
            "-as", "-hs", "-huss", "8", "-nlss", "1", "-diss", "0.0", "0.3", "-doss", "0.0",
            "0.2", "--device", "cpu"]
    argv += ["-s_last", "-kcv", "2"] if kfold else ["-split", split]
    for name, extra in (("serial", []), ("lockstep", ["-pg"])):
        _run_cli(argv + ["-exp", str(tmp_path / name)] + extra)
    read = lambda name, f: open(tmp_path / name / f).read()  # noqa: E731
    assert read("serial", "results.txt").split("\n")[2:] == \
        read("lockstep", "results.txt").split("\n")[2:]
    for f in ("Pk_fit_results.csv", "all_results.json"):
        assert read("serial", f) == read("lockstep", f)
    assert json.loads(read("serial", "all_scores.json")) == \
        json.loads(read("lockstep", "all_scores.json"))
    tags = ("f0", "f1") if kfold else ("f0",)
    assert sorted(d for d in os.listdir(tmp_path / "lockstep" / "checkpoints")
                  if d.startswith("grid")) == sorted(
        f"grid_{t}_di{a}_do{b}" for t in tags for a in ("0", "0.3") for b in ("0", "0.2"))
    assert "--parallel_grid ignored" not in read("lockstep", "logs")


def test_parallel_grid_warns_when_ineligible(tmp_path, capsys):
    emb_dir, lab_file, split = make_synthetic_corpus(str(tmp_path / "c"), n_docs=6, dim=30)
    exp = tmp_path / "exp"
    _run_cli(["-exp", str(exp), "-arc", "SheikhBiLSTM", "-enc", "CNN", "-ef", emb_dir, "-lf",
              lab_file, "-split", split, "-lr", "1e-2", "-bs", "4", "-max", "1", "-loss",
              "BinaryCrossEntropy", "-hs", "-huss", "8", "-nlss", "1", "-diss", "0.0", "0.2",
              "-doss", "0.0", "-pg", "--device", "cpu"])
    assert "--parallel_grid ignored: architecture 'SheikhBiLSTM'" in capsys.readouterr().err
    assert "--parallel_grid ignored" in open(exp / "logs").read()
