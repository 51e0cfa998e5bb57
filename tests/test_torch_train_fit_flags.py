"""The train CLI's single-device flags in the port, against the JAX CLI on
the CPU: `apply_pca` (torch, float64) against the JAX CLI's sklearn PCA at a
shape where sklearn's solver is exact (n_samples >= 10 x n_features: its
covariance eigensolver), to 1e-4 of each column's largest value; `--infer`
on a finished experiment; `--both_datasets` on a RadioNews/NonNews layout
built under tmp_path; `--zero_shot_labels`; `-pca` end to end. Both CLIs
start from the JAX first weights and must write the same results.txt lines.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest

import jax

from multimodaltopicsegmentation_tpu.cli import train_fit as jax_train_fit
from multimodaltopicsegmentation_tpu.models import registry as jax_registry
from multimodaltopicsegmentation_tpu.models.base import TaggerConfig as JaxTaggerConfig
from multimodaltopicsegmentation_torch.cli import train_fit
from multimodaltopicsegmentation_torch.train import loop as TLoop
from synth import make_synthetic_corpus  # tests/synth.py: pytest puts this file's directory on sys.path


@pytest.fixture(autouse=True)
def _one_jax_device_and_its_first_weights(monkeypatch):
    """The JAX CLI on one device, the corpora's 30-dim `-enc CNN` in both
    CLIs' tables (other tests of the JAX CLI set it to their own width); the
    port's Trainer starts from the weights the JAX Trainer draws for the
    same seed."""
    for table in (jax_train_fit.EMBEDDING_SIZES, train_fit.EMBEDDING_SIZES):
        monkeypatch.setitem(table, "CNN", 30)
    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: devices(*a)[:1])
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


def _run(main, argv):
    cwd = os.getcwd()
    try:
        return main(argv)
    finally:
        os.chdir(cwd)


def _results(exp):
    lines = open(os.path.join(exp, "results.txt")).read().split("\n")
    return [ln for ln in lines if ln and not ln.startswith("Results for experiment")]


def _both(tmp_path, argv, names=("jax", "torch")):
    exps = {}
    for name in names:
        exps[name] = str(tmp_path / f"exp_{name}")
        if name == "jax":
            _run(jax_train_fit.cli_main, argv + ["-exp", exps[name]])
        else:
            _run(train_fit.cli_main, argv + ["-exp", exps[name], "--device", "cpu"])
    return exps


def test_apply_pca_matches_the_jax_clis_sklearn_pca():
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((12, 12)).astype(np.float32)
    train = [((rng.standard_normal((60, 12)) @ mix).astype(np.float32), [0] * 60, f"t{i}")
             for i in range(3)]  # 180 samples of 12 features
    valid = [(rng.standard_normal((9, 12)).astype(np.float32), [1] * 9, "v0")]
    test = [(rng.standard_normal((7, 12)).astype(np.float32), [0] * 7, "x0")]
    got_train, (got_valid, got_test) = train_fit.apply_pca(train, [valid, test], 5)
    want_train, (want_valid, want_test) = jax_train_fit.apply_pca(train, [valid, test], 5)
    for got, want in ((got_train, want_train), (got_valid, want_valid), (got_test, want_test)):
        for (g, gl, gn), (w, wl, wn) in zip(got, want):
            assert g.dtype == np.float32 and g.shape == w.shape
            assert (gl, gn) == (wl, wn)
            scale = np.abs(w).max(0)
            assert (np.abs(g - w).max(0) <= 1e-4 * scale).all(), np.abs(g - w).max(0) / scale


def _corpus(tmp_path):
    return make_synthetic_corpus(str(tmp_path / "corpus"), n_docs=10, dim=30)


ARGV = ["-arc", "BiLSTM", "-enc", "CNN", "-lr", "1e-2", "-hu", "8", "-nl", "1", "-bs", "4",
        "-max", "3", "-pat", "3", "-vp", "0.25", "-loss", "FocalLoss", "-ar", "-as"]


def test_pca_and_zero_shot_labels_match_the_jax_cli(tmp_path):
    emb_dir, lab_file, split = _corpus(tmp_path)
    exps = _both(tmp_path, ARGV + ["-ef", emb_dir, "-lf", lab_file, "-split", split, "-pca",
                                   "-pca_v", "6", "-zsl", "news", "sport"])
    assert _results(exps["torch"]) == _results(exps["jax"])
    assert _results(exps["torch"])[-1] == "Labels: ['news', 'sport']"


def test_infer_on_a_finished_experiment_matches_the_jax_cli(tmp_path):
    """--infer tests checkpoints/final=0.500.ckpt of an existing experiment
    folder at threshold 0.5 and reports the last configuration."""
    emb_dir, lab_file, split = _corpus(tmp_path)
    argv = ARGV + ["-ef", emb_dir, "-lf", lab_file, "-split", split, "-s_last"]
    trained = str(tmp_path / "trained")
    _run(train_fit.cli_main, argv + ["-exp", trained, "--device", "cpu"])
    shutil.copy(os.path.join(trained, "checkpoints", "best_model"),
                os.path.join(trained, "checkpoints", "final=0.500.ckpt"))
    for name in ("jax", "torch"):
        shutil.copytree(trained, tmp_path / f"exp_{name}")
    grid = ["-hs", "-huss", "8", "-nlss", "1", "-diss", "0.0", "0.1", "-doss", "0.0", "--infer"]
    exps = {"jax": str(tmp_path / "exp_jax"), "torch": str(tmp_path / "exp_torch")}
    _run(jax_train_fit.cli_main, argv + grid + ["-exp", exps["jax"]])
    _run(train_fit.cli_main, argv + grid + ["-exp", exps["torch"], "--device", "cpu"])
    assert _results(exps["torch"]) == _results(exps["jax"])
    assert "Dropout in: 0.1" in _results(exps["torch"])
    # nothing trained, nothing renamed
    assert sorted(os.listdir(os.path.join(exps["torch"], "checkpoints"))) == \
        sorted(os.listdir(os.path.join(trained, "checkpoints")))
    # an experiment folder that does not exist is refused
    with pytest.raises(AssertionError, match="must exist"):
        _run(train_fit.cli_main, argv + ["--infer", "-exp", str(tmp_path / "none"),
                                         "--device", "cpu"])


def _sibling_corpora(root):
    """RadioNewsT/emb (+ labs) beside ../NonNewsT/NonNewsT/emb (+ labs), the
    layout --both_datasets derives by the Radio <-> Non swap."""
    work = root / "work"
    emb, lab, _ = make_synthetic_corpus(str(work / "RadioNewsT"), n_docs=6, dim=30, seed=1)
    make_synthetic_corpus(str(root / "NonNewsT" / "NonNewsT"), n_docs=6, dim=30, seed=2)
    return work, os.path.relpath(emb, work), os.path.relpath(lab, work)


def test_both_datasets_matches_the_jax_cli(tmp_path, monkeypatch):
    work, emb, lab = _sibling_corpora(tmp_path)
    monkeypatch.chdir(work)
    argv = ARGV + ["-ef", emb, "-lf", lab, "-kcv", "2", "-bd", "-zsl", "radio"]
    exps = _both(tmp_path, argv)
    assert _results(exps["torch"]) == _results(exps["jax"])
    assert _results(exps["torch"])[-1] == "Labels: ['radio']"
    # a corpus that is neither RadioNews nor NonNews is refused
    emb2, lab2, _ = make_synthetic_corpus(str(work / "Podcast"), n_docs=6, dim=30, seed=3)
    with pytest.raises(ValueError, match="RadioNews or NonNews"):
        _run(train_fit.cli_main, ARGV + ["-ef", os.path.relpath(emb2, work), "-lf", lab2, "-bd",
                                         "-exp", str(tmp_path / "bad"), "--device", "cpu"])
