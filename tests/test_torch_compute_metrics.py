"""The port's post-hoc metrics CLI (cli/compute_accuracy_metrics_sentence.py,
no pandas, no sklearn) against the JAX package's: the CSV is byte-identical
on the experiment tree of tests/test_compute_metrics_cli.py, on a variant
with a tied F1, a constant score column and a document with no predicted
boundary, with the baselines missing, and on the nonnews layout. The port's
binary f1/precision/recall equal sklearn's (zero_division -> 0.0), and its
descending sort is pandas' (ties first-seen, NaN last)."""
import json
import pickle
import warnings

import numpy as np
import pandas as pd
import pytest

from multimodaltopicsegmentation_torch.cli import compute_accuracy_metrics_sentence as P

BASELINES = ["radio_news_topseg", "x-vectors",
             "openl3/_mean_std+radio_news_roberta+radio_news_topseg"]


def _jax_cli():
    """The JAX module imports pandas and sklearn, which not every machine with
    a card has: imported where a test runs it, so that collection needs neither."""
    from multimodaltopicsegmentation_tpu.cli import compute_accuracy_metrics_sentence as J

    return J


def _tree(tmp_path, encoders, corpus="radionews", seed=0, n_docs=5, special=None):
    """The reference layout: labels, split and one all_scores.json per
    encoder, scores biased toward the truth. `special` maps an encoder to
    "copy:<other>" (the same scores: tied metrics), "silent" (no predicted
    boundary anywhere: a constant column) or "silent_first" (no predicted
    boundary in the first document)."""
    rng = np.random.default_rng(seed)
    name, sub = (("RadioNewsSentence", "RadioNews") if corpus == "radionews"
                 else ("NonNewsSentence", "NonNews"))
    root = tmp_path / name
    (root / name).mkdir(parents=True)
    files = [f"{i:03d}doc.npy" for i in range(n_docs)]
    labs = {}
    for f in files:
        n = int(rng.integers(20, 40))
        lab = (rng.random(n) < 0.2).astype(int)
        lab[-1] = 1
        labs[f[:-4]] = lab.tolist()
    with open(root / name / "labs_dict.pkl", "wb") as fh:
        pickle.dump(labs, fh)
    with open(root / f"{sub}_split.json", "w") as fh:
        json.dump({"train": [], "test": files, "validation": []}, fh)
    special = special or {}
    written = {}
    for enc in encoders:
        how = special.get(enc, "")
        if how.startswith("copy:"):
            d = written[how[5:]]
        else:
            d = {}
            for f in files:
                truth = np.asarray(labs[f[:-4]], float)
                d[f] = (4 * truth - 2 + rng.standard_normal(len(truth))).tolist()
                if how == "silent" or (how == "silent_first" and f == files[0]):
                    d[f] = [-5.0] * len(truth)
        written[enc] = d
        exp_dir = root / "UnimodalExperiments" / ("BiLSTM_bs10_" + enc)
        exp_dir.mkdir(parents=True)
        with open(exp_dir / "all_scores.json", "w") as fh:
            json.dump(d, fh)
    return root


def _both(tmp_path, root, encoders, corpus="radionews"):
    outs = []
    for mod, out in ((_jax_cli(), "jax.csv"), (P, "port.csv")):
        path = str(tmp_path / out)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # shapiro/ttest on constant input, sklearn 0/0
            table = mod.cli_main([corpus, "--root", str(root), "--encoders", *encoders,
                                  "--output", path])
        with open(path, "rb") as f:
            outs.append((table, f.read()))
    (df, want), (table, got) = outs
    assert got == want
    assert list(table) == list(df.columns)
    for col in df.columns:
        np.testing.assert_array_equal(np.asarray(table[col]), df[col].to_numpy())
    return table, got


def test_csv_byte_identical(tmp_path):
    root = _tree(tmp_path, BASELINES)
    table, csv = _both(tmp_path, root, BASELINES)
    assert csv.startswith(b",Precision,Precision Confidence,")
    assert (table["F1"] > 0.5).all() and "F1 P-value 4" in table


def test_tie_constant_column_and_a_silent_document(tmp_path):
    encoders = BASELINES + ["x-vectors_copy", "mfcc", "crepe"]
    special = {"x-vectors_copy": "copy:x-vectors", "mfcc": "silent", "crepe": "silent_first"}
    root = _tree(tmp_path, encoders, seed=1, special=special)
    table, csv = _both(tmp_path, root, encoders)
    f1 = list(table["F1"])
    assert f1[1] == f1[3]  # the tie
    assert f1[4] == 0.0 and table["Precision"][4] == 0.0  # nothing predicted
    assert table["F1 P-value"][int(np.argmin(table["F1"]))] == 0.0  # last sorted row keeps 0
    assert b",," in csv or b",\n" in csv  # a NaN p-value from the constant column


def test_missing_baselines(tmp_path):
    encoders = ["x-vectors", "mfcc", "openl3/_mean_std"]
    root = _tree(tmp_path, encoders, seed=2)
    table, _ = _both(tmp_path, root, encoders)
    assert not any("P-value" in c for c in table)


def test_text_baseline_only(tmp_path):
    encoders = ["radio_news_topseg", "mfcc"]
    root = _tree(tmp_path, encoders, seed=3, n_docs=4)
    table, _ = _both(tmp_path, root, encoders)
    assert "F1 P-value 2" in table and "F1 P-value3" not in table


def test_nonnews_layout(tmp_path):
    encoders = ["x-vectors", "radio_news_topseg",
                "NonNewsSentence/x-vectors+NonNewsSentence/non_news_topseg"]
    root = _tree(tmp_path, encoders, corpus="nonnews", seed=4)
    table, _ = _both(tmp_path, root, encoders, corpus="nonnews")
    assert table["embedding"][2] == "x-vectors+non_news_topseg"


def test_unknown_encoder_raises(tmp_path):
    root = _tree(tmp_path, ["x-vectors"])
    for mod in (_jax_cli(), P):
        with pytest.raises(ValueError, match="not found among the experiments"):
            mod.cli_main(["radionews", "--root", str(root), "--encoders", "nope",
                          "--output", str(tmp_path / "x.csv")])


def _vectors(case, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 50))
    if case == "random":
        return (rng.random(n) < 0.3).astype(int), (rng.random(n) < 0.3).astype(int)
    if case == "all_zero":
        return np.zeros(n, int), np.zeros(n, int)
    if case == "no_prediction":
        return (rng.random(n) < 0.3).astype(int) | (np.arange(n) == 0), np.zeros(n, int)
    return np.zeros(n, int), (rng.random(n) < 0.5).astype(int) | (np.arange(n) == 0)


@pytest.mark.parametrize("case", ["random", "all_zero", "no_prediction", "no_truth"])
@pytest.mark.parametrize("seed", [0, 1])
def test_binary_metrics_equal_sklearn(case, seed):
    from sklearn.metrics import f1_score, precision_score, recall_score  # not beside every card

    t, p = _vectors(case, seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = (f1_score(t, p), precision_score(t, p), recall_score(t, p))
    got = (P.f1(t, p), P.precision(t, p), P.recall(t, p))
    assert got == want


@pytest.mark.parametrize("values", [[0.5, 0.7, 0.5, 0.7, np.nan], [0.1], [np.nan, 0.3, np.nan],
                                    "random"])
def test_sort_desc_is_pandas(values):
    if values == "random":
        rng = np.random.default_rng(5)
        values = np.round(rng.random(40), 1)
        values[[3, 17]] = np.nan
    want = pd.Series(values, dtype=float).sort_values(ascending=False).index.to_numpy()
    np.testing.assert_array_equal(P.sort_desc(values), want)


def test_bootstrap_mean_ci_equal_to_jax():
    values = np.random.default_rng(6).random(9)
    J = _jax_cli()
    assert P.bootstrap_mean_ci(values) == J.bootstrap_mean_ci(values)
    assert P.bootstrap_mean_ci([0.5] * 4) == J.bootstrap_mean_ci([0.5] * 4)


def test_write_csv_is_to_csv(tmp_path):
    table = {"a": np.array([0.1 + 0.2, np.nan, -0.0, 1e-05, 1e16]),
             "embedding": np.array(["x,y", 'q"uote', "plain", "a+b/c", ""], object),
             "b": np.zeros(5)}
    P.write_csv(str(tmp_path / "p.csv"), table)
    pd.DataFrame(table).to_csv(str(tmp_path / "j.csv"))
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
