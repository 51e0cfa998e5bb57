"""The logistic-regression baseline of the port (`predict -lgr`): its pickle
reader (utils/sklearn_pickle.py) against sklearn on binary and 3-class
`LogisticRegression` pickles fitted on float64 data (float64 coefficients,
as the reference's features give), float32 and float64 points within 1e-7
of the decision boundary included; a model fitted on float32 data away from
its boundary; the refusal of any other global; `LogReg_Predictor` and the
CLI against the JAX package's (results.pkl and segment wavs equal).

tests/data/logreg_prosodic_167.pkl is the model these tests serve (on the
card too): a `LogisticRegression(max_iter=5000, class_weight="balanced")`
fitted with sklearn 1.9 on the 167 prosodic features (as float64) of 80
one-second units (the port's extractor on the CPU over two synthetic 40-s
broadcasts, seed 11: sentences of 2-12 s, a carrier tone per topic with
vibrato and 0.2-0.6 s of near-silence after each sentence), labelled 1
where a seeded random projection of the standardized features exceeds its
85th percentile."""
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodaltopicsegmentation_tpu.cli import predict as JP
from multimodaltopicsegmentation_torch.cli import predict as PP
from multimodaltopicsegmentation_torch.utils import sklearn_pickle
from multimodaltopicsegmentation_torch.utils.audio import save_wav

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "logreg_prosodic_167.pkl")


def _fit(n_classes, dim=8, seed=0, dtype=np.float64):
    from sklearn.linear_model import LogisticRegression  # not installed beside every card

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((300, dim)).astype(dtype)
    y = (X[:, 0] > 0.8).astype(int) if n_classes == 2 else \
        np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.4, 0.4])
    return LogisticRegression().fit(X, y)


def _near_boundary(clf, n, seed):
    """Points moved onto a decision boundary, then 1e-7 to either side of it
    (float64), and the same points rounded to float32."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, clf.coef_.shape[1]))
    w = clf.coef_[0] - (clf.coef_[1] if len(clf.coef_) > 1 else 0.0)
    b = clf.intercept_[0] - (clf.intercept_[1] if len(clf.intercept_) > 1 else 0.0)
    d = X @ w + b
    X = X - (d / (w @ w))[:, None] * w
    X = X + (rng.choice([-1e-7, 1e-7], n) / np.linalg.norm(w))[:, None] * w
    return X, X.astype(np.float32)


def _dump(tmp_path, model, protocol=None, name="m.pkl"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        pickle.dump(model, f, protocol=protocol)
    return path


@pytest.mark.parametrize("n_classes", [2, 3])
def test_predict_equals_sklearn(tmp_path, n_classes):
    clf = _fit(n_classes)
    model = sklearn_pickle.load(_dump(tmp_path, clf))
    np.testing.assert_array_equal(model.coef_, clf.coef_)
    rng = np.random.default_rng(1)
    batches = [rng.standard_normal((500, 8)).astype(np.float32), *_near_boundary(clf, 400, 2)]
    for X in batches:
        np.testing.assert_array_equal(model.predict(X), clf.predict(X))
    decision = model.decision_function(batches[1]).numpy()
    if n_classes == 2:
        assert np.abs(decision).max() < 1e-6  # the points sit on the boundary
        assert 0 < clf.predict(batches[1]).mean() < 1
        assert 0 < clf.predict(batches[2]).mean() < 1


def test_committed_fixture_is_read_as_sklearn_reads_it():
    from sklearn.linear_model import LogisticRegression

    with open(FIXTURE, "rb") as f:
        clf = pickle.load(f)
    model = sklearn_pickle.load(FIXTURE)
    assert isinstance(clf, LogisticRegression) and clf.coef_.shape == (1, 167)
    np.testing.assert_array_equal(model.classes_, clf.classes_)
    rng = np.random.default_rng(3)
    X = np.abs(rng.standard_normal((400, 167)) * 50.0).astype(np.float32)
    X64, X32 = _near_boundary(clf, 200, 4)
    for batch in (X, X64, X32):
        np.testing.assert_array_equal(model.predict(batch), clf.predict(batch))


def test_numpy1_module_path_is_allowed(tmp_path):
    """A pickle from numpy 1 names numpy.core.multiarray._reconstruct."""
    clf = _fit(2)
    raw = pickle.dumps(clf, protocol=3)  # GLOBAL opcodes: "module\nname\n"
    assert b"numpy._core.multiarray\n_reconstruct" in raw
    path = tmp_path / "old.pkl"
    path.write_bytes(raw.replace(b"numpy._core.multiarray\n", b"numpy.core.multiarray\n"))
    X = np.random.default_rng(5).standard_normal((100, 8))
    np.testing.assert_array_equal(sklearn_pickle.load(str(path)).predict(X), clf.predict(X))


def test_float32_model_away_from_its_boundary(tmp_path):
    """sklearn keeps float32 coefficients for float32 training data and then
    scores float32 input in float32; the reader's float64 scores give the
    same labels wherever that rounding cannot reach the boundary."""
    clf = _fit(2, dtype=np.float32)
    assert clf.coef_.dtype == np.float32
    model = sklearn_pickle.load(_dump(tmp_path, clf))
    X = np.random.default_rng(7).standard_normal((2000, 8)).astype(np.float32)
    far = np.abs(clf.decision_function(X)) > 1e-4
    assert far.mean() > 0.99
    np.testing.assert_array_equal(model.predict(X)[far], clf.predict(X)[far])


class _Shell:
    def __reduce__(self):
        return (os.system, ("true",))


@pytest.mark.parametrize("what", ["os.system", "another class", "a plain dict"])
def test_other_globals_are_refused(tmp_path, what):
    if what == "os.system":
        path, match = _dump(tmp_path, _Shell()), r"refusing global posix\.system"
    elif what == "another class":
        from sklearn.linear_model import LinearRegression

        reg = LinearRegression().fit(np.eye(3), np.arange(3.0))
        path, match = _dump(tmp_path, reg), r"refusing global sklearn\.linear_model\._base"
    else:
        path, match = _dump(tmp_path, {"coef_": 1}), "holds a dict"
    with pytest.raises(pickle.UnpicklingError, match=match):
        sklearn_pickle.load(path)


def _corpus(tmp_path, dim, n_docs=2, seed=0):
    rng = np.random.default_rng(seed)
    emb_dir, audio_dir = tmp_path / "emb", tmp_path / "audio"
    emb_dir.mkdir()
    audio_dir.mkdir()
    for d in range(n_docs):
        n_units = 8 + 3 * d
        doc = rng.standard_normal((n_units, dim)).astype(np.float32)
        doc[4, 0] = 5.0  # a certain boundary at unit 5 under _fit(2)
        np.save(emb_dir / f"doc{d}.npy", doc)
        audio = 0.1 * rng.standard_normal(16000 * n_units + 3000)
        save_wav(str(audio_dir / f"doc{d}.wav"), audio.astype(np.float32), 16000)
    return str(emb_dir), str(audio_dir)


def _outputs(exp):
    with open(os.path.join(exp, "results.pkl"), "rb") as f:
        results = pickle.load(f)
    wavs = {n: Path(exp, n).read_bytes() for n in sorted(os.listdir(exp)) if n.endswith(".wav")}
    return results, wavs


def test_logreg_predictor_writes_jax_outputs(tmp_path):
    model = _dump(tmp_path, _fit(2))
    emb_dir, audio_dir = _corpus(tmp_path, 8)
    outs = []
    for pred, exp in ((JP.LogReg_Predictor(model), str(tmp_path / "jax")),
                      (PP.LogReg_Predictor(model, device="cpu"), str(tmp_path / "port"))):
        returned = pred.predict(emb_dir, exp, audio_directory=audio_dir)
        outs.append(_outputs(exp))
        assert returned == outs[-1][0]
    assert outs[0] == outs[1]
    results, wavs = outs[1]
    assert results["doc0.npy"][4] == 1 and len(wavs) >= 4


@pytest.mark.parametrize("flags", [[], ["-rjs", "-ui", "2"]], ids=["segments", "rjs"])
def test_cli_lgr_equals_jax(tmp_path, flags):
    emb_dir, audio_dir = _corpus(tmp_path, 167, n_docs=3, seed=1)
    common = ["-lgr", "-ef", emb_dir, "-model", FIXTURE, "-af", audio_dir, *flags]
    JP.cli_main(common + ["-exp", str(tmp_path / "jax")])
    got = PP.cli_main(common + ["-exp", str(tmp_path / "port"), "--device", "cpu", "-gpus", "1",
                                "-pca", "-pca_v", "50", "-ext", ".wav"])
    want = _outputs(str(tmp_path / "jax"))
    assert _outputs(str(tmp_path / "port")) == want
    assert got == want[0] and sum(map(sum, got.values())) > 0


def test_lgr_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PP.cli_main(["-lgr", "-ef", "unused", "-model", FIXTURE, "-exp", "unused"])


@pytest.mark.cuda
def test_cuda_lgr_ee_on_the_card_classifies_as_the_cpu(tmp_path):
    """predict -lgr -ee on the card (the prosodic features extracted there,
    the pickled LogisticRegression applied there), then -lgr on the CPU over
    the features the card wrote: the same results.pkl and segment wavs. (Card
    and CPU prosodic features differ where pYIN's states do, so each device
    classifies the same features.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, audio_dir = _corpus(tmp_path, 167, n_docs=3, seed=1)
    common = ["-lgr", "-model", FIXTURE, "-af", audio_dir, "-ef", str(tmp_path / "card_emb"),
              "-ui", "1.0"]
    got = PP.cli_main(common + ["-ee", "-exp", str(tmp_path / "card"), "--device", "cuda"])
    PP.cli_main(common + ["-exp", str(tmp_path / "cpu"), "--device", "cpu"])
    want = _outputs(str(tmp_path / "cpu"))
    assert _outputs(str(tmp_path / "card")) == want and got == want[0]
    assert [len(want[0][f"doc{d}.npy"]) for d in range(3)] == [8, 11, 14]
