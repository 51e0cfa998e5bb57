"""Post-hoc evaluation over a grid of trained experiments: the JAX package's
cli/compute_accuracy_metrics_sentence.py without pandas and sklearn (the
port does not import that package).

Reference contract (compute_accuracy_metrics_sentence.py of the reference):
`... compute_accuracy_metrics_sentence {nonnews,radionews}` loads each
experiment's `all_scores.json` for the hard-coded 15-entry encoder lists
(:137-172), recomputes predictions as sigmoid(score) > 0.5 (:201), scores
per-document F1/precision/recall (final unit dropped, :203-207) and
B-measures (:209-213), bootstraps 10k CIs, runs pairwise significance
tests (Shapiro -> t-test with Welch variance-ratio switch, else
Mann-Whitney U, :280-326) against the text-only `radio_news_topseg` and the
best tri-modal fusion baselines, and writes `final_result_bilstm.csv`.

Fixed vs the reference (defect, not copied): the nonnews branch referenced
an undefined `experiment_name` (:84); here both corpora use explicit,
overridable directory roots. The directory layout and encoder lists default
to the reference's.

In place of the JAX module's libraries: `f1`, `precision` and `recall` are
sklearn's binary defaults (`zero_division` gives 0.0); the table is a dict
of numpy columns in the JAX module's column order; `sort_desc` is pandas'
`sort_values(ascending=False)` (ties in first-seen order, NaN last) and
`write_csv` writes `DataFrame.to_csv`'s bytes (an unnamed leading index
column, floats as `repr`, NaN as an empty cell). scipy's tests and the
port's `eval.metrics.b_measure` are used as in JAX.

Run: python -m multimodaltopicsegmentation_torch.cli.compute_accuracy_metrics_sentence
       radionews --root <corpus root> [--encoders ...] [--output out.csv]
"""
from __future__ import annotations

import argparse
import csv
import json
import math
import os
import pickle
import re

import numpy as np
from scipy.stats import mannwhitneyu, shapiro, ttest_ind

from ..eval.metrics import b_measure

ENCODERS = {
    "nonnews": [
        "x-vectors",
        "openl3/_mean_std",
        "radio_news_roberta",
        "radio_news_topseg",
        "radio_news_roberta+radio_news_topseg",
        "x-vectors+openl3/_mean_std",
        "NonNewsSentence/openl3/_mean_std+NonNewsSentence/non_news_roberta",
        "NonNewsSentence/openl3/_mean_std+NonNewsSentence/non_news_topseg",
        "NonNewsSentence/openl3/_mean_std+NonNewsSentence/non_news_roberta+NonNewsSentence/non_news_topseg",
        "NonNewsSentence/x-vectors+NonNewsSentence/non_news_roberta",
        "NonNewsSentence/x-vectors+NonNewsSentence/non_news_topseg",
        "NonNewsSentence/x-vectors+NonNewsSentence/non_news_roberta+NonNewsSentence/non_news_topseg",
        "NonNewsSentence/x-vectors+NonNewsSentence/openl3/_mean_std+NonNewsSentence/non_news_roberta",
        "NonNewsSentence/x-vectors+NonNewsSentence/openl3/_mean_std+NonNewsSentence/non_news_topseg",
        "NonNewsSentence/x-vectors+NonNewsSentence/openl3/_mean_std+NonNewsSentence/non_news_roberta+NonNewsSentence/non_news_topseg",
    ],
    "radionews": [
        "x-vectors",
        "openl3/_mean_std",
        "radio_news_roberta",
        "radio_news_topseg",
        "radio_news_roberta+radio_news_topseg",
        "x-vectors+openl3/_mean_std",
        "RadioNewsSentence/openl3/_mean_std+RadioNewsSentence/radio_news_roberta",
        "RadioNewsSentence/openl3/_mean_std+RadioNewsSentence/radio_news_topseg",
        "RadioNewsSentence/openl3/_mean_std+RadioNewsSentence/radio_news_roberta+RadioNewsSentence/radio_news_topseg",
        "RadioNewsSentence/x-vectors+RadioNewsSentence/radio_news_roberta",
        "RadioNewsSentence/x-vectors+RadioNewsSentence/radio_news_topseg",
        "RadioNewsSentence/x-vectors+RadioNewsSentence/radio_news_roberta+RadioNewsSentence/radio_news_topseg",
        "RadioNewsSentence/x-vectors+RadioNewsSentence/openl3/_mean_std+RadioNewsSentence/radio_news_roberta",
        "RadioNewsSentence/x-vectors+RadioNewsSentence/openl3/_mean_std+RadioNewsSentence/radio_news_topseg",
        "RadioNewsSentence/x-vectors+RadioNewsSentence/openl3/_mean_std+RadioNewsSentence/radio_news_roberta+RadioNewsSentence/radio_news_topseg",
    ],
}

TEXT_BASELINE = "radio_news_topseg"
FUSION_BASELINE = "openl3/_mean_std+radio_news_roberta+radio_news_topseg"


def sig(x):
    return 1.0 / (1.0 + np.exp(-x))


def _counts(y_true, y_pred):
    t = np.asarray(y_true).astype(bool)
    p = np.asarray(y_pred).astype(bool)
    return int((t & p).sum()), int((~t & p).sum()), int((t & ~p).sum())


def precision(y_true, y_pred) -> float:
    """sklearn's precision_score for binary 0/1 labels (0.0 without a
    predicted positive)."""
    tp, fp, _ = _counts(y_true, y_pred)
    return tp / (tp + fp) if tp + fp else 0.0


def recall(y_true, y_pred) -> float:
    """sklearn's recall_score for binary 0/1 labels (0.0 without a true
    positive)."""
    tp, _, fn = _counts(y_true, y_pred)
    return tp / (tp + fn) if tp + fn else 0.0


def f1(y_true, y_pred) -> float:
    """sklearn's f1_score for binary 0/1 labels: 2 tp / (2 tp + fp + fn),
    0.0 when there is neither a true nor a predicted positive."""
    tp, fp, fn = _counts(y_true, y_pred)
    return 2 * tp / (2 * tp + fp + fn) if tp + fp + fn else 0.0


def bootstrap_mean_ci(values, samples=10000, seed=0):
    values = np.asarray(values, np.float64)
    rng = np.random.default_rng(seed)
    boots = rng.choice(values, size=(samples, len(values)), replace=True).mean(axis=1)
    ci = (np.percentile(boots, 97.5) - np.percentile(boots, 2.5)) / 2
    return float(np.mean(boots)), float(ci)


def sort_desc(values) -> np.ndarray:
    """Row order of pandas' `Series.sort_values(ascending=False)` (its
    `nargsort`): the reversed array's quicksort, reversed back, so ties keep
    their first-seen order; NaN rows last."""
    items = np.asarray(values, np.float64)
    nan = np.isnan(items)
    idx = np.arange(len(items))
    non_nans, non_nan_idx = items[~nan][::-1], idx[~nan][::-1]
    order = non_nan_idx[non_nans.argsort(kind="quicksort")][::-1]
    return np.concatenate([order, np.nonzero(nan)[0]])


def compute_pvalues(scores, sorted_indices, table, b, normal_b, use_ttest=True):
    """Pairwise significance vs baseline `b` and vs the best system `c`
    (reference compute_pvalues, :280-326)."""
    n_rows = len(table["embedding"])
    p1s = np.zeros(n_rows)
    p2s = np.zeros(n_rows)
    c = None
    normal_c = False
    for index, e in enumerate(sorted_indices[:-1]):
        if not index:
            c = scores[table["embedding"][e]]
            normal_c = shapiro(c).pvalue > 0.05
        a = scores[table["embedding"][e]]
        normal_a = shapiro(a).pvalue > 0.01

        def pvalue(x, y, alternative="two-sided", normal_y=True):
            if (normal_a and normal_y) or use_ttest:
                var_x, var_y = np.var(x), np.var(y)
                ratio = max(var_x, var_y) / max(min(var_x, var_y), 1e-12)
                if ratio > 4:
                    return ttest_ind(x, y, equal_var=False, alternative=alternative).pvalue
                return ttest_ind(x, y, alternative=alternative).pvalue
            return mannwhitneyu(x, y).pvalue

        p1s[e] = pvalue(a, b, normal_y=normal_b)
        p2s[e] = pvalue(a, c, alternative="less", normal_y=normal_c)
    return p1s, p2s


def _cell(value) -> str:
    if isinstance(value, (float, np.floating)):
        return "" if math.isnan(value) else repr(float(value))
    return str(value)


def write_csv(path, table):
    """`DataFrame(table).to_csv(path)`'s bytes: an unnamed index column of
    row numbers, then the columns in order; floats as repr, NaN empty."""
    columns = list(table)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow([""] + columns)
        for i in range(len(table[columns[0]])):
            writer.writerow([str(i)] + [_cell(table[col][i]) for col in columns])


def main(args):
    corpus = args.corpus
    if corpus not in ("nonnews", "radionews"):
        raise ValueError("Enter one of nonnews or radionews as function argument!")

    if corpus == "nonnews":
        root = args.root or "NonNewsSentence"
        split_path = os.path.join(root, "NonNews_split.json")
        lab_path = os.path.join(root, "NonNewsSentence", "labs_dict.pkl")
        prefixes = [os.path.join(root, args.experiments or "UnimodalExperiments")]
    else:
        root = args.root or "RadioNewsSentence"
        split_path = os.path.join(root, "RadioNews_split.json")
        lab_path = os.path.join(root, "RadioNewsSentence", "labs_dict.pkl")
        prefixes = [
            os.path.join(root, args.experiments or "UnimodalExperiments"),
            os.path.join(root, "NewLateFusion"),
            os.path.join(root, "ExperimentsMultimodalEarlyFusion"),
        ]

    with open(split_path) as f:
        files = json.load(f)["test"]
    with open(lab_path, "rb") as f:
        lab = pickle.load(f)

    encoders = args.encoders or ENCODERS[corpus]

    table = {
        "Precision": [], "Precision Confidence": [],
        "Recall": [], "Recall Confidence": [],
        "F1": [], "F1 Confidence": [],
        "B-F1": [], "B-Precision": [], "B-Recall": [],
        "B-F1 Confidence": [], "B-Precision Confidence": [], "B-Recall Confidence": [],
        "embedding": [],
    }
    per_metric_scores = {m: {} for m in ("f1", "precision", "recall", "bf1", "bprecision", "brecall")}

    for enc in encoders:
        d = None
        for prefix in prefixes:
            path = os.path.join(prefix, args.arch_prefix + enc, "all_scores.json")
            if os.path.exists(path):
                with open(path) as f:
                    d = json.load(f)
                break
        if d is None:
            raise ValueError(f"Directory {enc} not found among the experiments!")

        enc_clean = re.sub(r"(RadioNewsSentence|NonNewsSentence)/", "", enc)

        rows = {m: [] for m in per_metric_scores}
        for k in files:
            lab_k = k[:-4]
            pred = (sig(np.asarray(d[k]).reshape(-1)) > 0.5) + 0
            truth = np.asarray(lab[lab_k])
            rows["f1"].append(f1(truth[:-1], pred[:-1]))
            rows["recall"].append(recall(truth[:-1], pred[:-1]))
            rows["precision"].append(precision(truth[:-1], pred[:-1]))
            prec, rec, bf1, _ = b_measure(pred.tolist(), truth.tolist())
            rows["bf1"].append(bf1)
            rows["bprecision"].append(prec)
            rows["brecall"].append(rec)

        for m in per_metric_scores:
            per_metric_scores[m][enc_clean] = rows[m]

        for m, (col, ccol) in {
            "f1": ("F1", "F1 Confidence"),
            "precision": ("Precision", "Precision Confidence"),
            "recall": ("Recall", "Recall Confidence"),
            "bf1": ("B-F1", "B-F1 Confidence"),
            "bprecision": ("B-Precision", "B-Precision Confidence"),
            "brecall": ("B-Recall", "B-Recall Confidence"),
        }.items():
            mean, ci = bootstrap_mean_ci(rows[m])
            table[col].append(mean)
            table[ccol].append(ci)
        table["embedding"].append(enc_clean)

    table = {col: (np.asarray(v, object) if col == "embedding" else np.asarray(v, np.float64))
             for col, v in table.items()}

    pval_specs = {
        "f1": "F1",
        "precision": "Precision",
        "recall": "Recall",
        "bf1": "B-F1",
        "bprecision": "B-Precision",
        "brecall": "B-Recall",
    }
    for baseline_key, suffixes in ((TEXT_BASELINE, ("", " 2")), (FUSION_BASELINE, ("3", " 4"))):
        for m, col in pval_specs.items():
            scores = per_metric_scores[m]
            if baseline_key not in scores:
                continue
            b = scores[baseline_key]
            normal_b = shapiro(b).pvalue > 0.05
            order = sort_desc(table[col])
            p1, p2 = compute_pvalues(scores, order, table, b, normal_b)
            table[f"{col} P-value{suffixes[0]}"] = p1
            table[f"{col} P-value{suffixes[1]}"] = p2

    out = args.output or "final_result_bilstm.csv"
    write_csv(out, table)
    print(f"Wrote {out} with {len(table['embedding'])} encoder rows")
    return table


def build_parser():
    parser = argparse.ArgumentParser(description="Aggregate per-experiment scores")
    parser.add_argument("corpus", choices=["nonnews", "radionews"])
    parser.add_argument("--root", type=str, default=None,
                        help="corpus root (default: reference layout)")
    parser.add_argument("--experiments", type=str, default=None,
                        help="experiment subdirectory (default UnimodalExperiments)")
    parser.add_argument("--arch_prefix", type=str, default="BiLSTM_bs10_")
    parser.add_argument("--encoders", nargs="*", default=None,
                        help="override the hard-coded encoder list")
    parser.add_argument("--output", type=str, default=None)
    return parser


def cli_main(argv=None):
    return main(build_parser().parse_args(argv))


if __name__ == "__main__":
    cli_main()
