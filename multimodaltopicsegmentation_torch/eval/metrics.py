"""Segmentation evaluation metrics: Pk, WindowDiff, WinPR, B-measure, F1.

A copy of the JAX package's eval/metrics.py (numpy only; the port does not
import that package). From-scratch implementations with the exact conventions
the reference relies on (it delegates Pk/WindowDiff/B to the `segeval`
package and implements WinPR inline, lightning_model.py:16-152):

- `get_boundaries` converts a 0/1 boundary vector (1 = last unit of a topic
  segment) into segment masses.
- `compute_Pk` / `compute_window_diff` force the final boundary of both
  hypothesis and reference to 1 before scoring (lightning_model.py:27-28,
  43-44) — done here on copies instead of mutate-and-restore.
- The Pk/WindowDiff window size defaults to `round(mean reference segment
  mass / 2)` computed with Decimal half-even rounding, matching segeval.
- `window_diff` raises AssertionError when the window does not fit, which the
  reference catches to fall back to Pk (lightning_model.py:636-638).
- WinPR follows Scaiano & Inkpen 2012 with the same edge handling as the
  reference's inline implementation (k=10 default).
- B-measure follows Fournier 2013 boundary edit distance (matches /
  transpositions within n_t units / additions), with transpositions weighted
  by spanned distance. n_t=4 for the confusion-matrix P/R/F1 and n_t=10 for
  boundary similarity, as in lightning_model.py:137-148.

All functions take Python sequences / numpy arrays on host: metric
computation is a per-document epilogue, not a device hot path.
"""
from __future__ import annotations

from decimal import Decimal
from typing import List, Sequence, Tuple

import numpy as np


def get_boundaries(boundaries: Sequence[int]) -> List[int]:
    """0/1 boundary vector -> segment masses. 1 marks the LAST unit of a segment."""
    masses = []
    tot = 0
    for b in boundaries:
        tot += 1
        if b:
            masses.append(tot)
            tot = 0
    return masses


def _positions_from_masses(masses: Sequence[int]) -> np.ndarray:
    """Per-unit segment ids, e.g. [2,3] -> [0,0,1,1,1]."""
    return np.repeat(np.arange(len(masses)), masses)


def _default_window_size(ref_masses: Sequence[int]) -> int:
    """segeval convention: round(mean reference mass / 2), Decimal half-even,
    clamped to a MINIMUM OF 2 (segeval's __compute_window_size returns
    `window_size if window_size > 1 else 2`) — fine-grained segmentations
    would otherwise diverge from what the reference stack reports."""
    avg = Decimal(int(sum(ref_masses))) / Decimal(len(ref_masses))
    k = int(round(avg / 2))
    return k if k > 1 else 2


def pk(hyp_masses: Sequence[int], ref_masses: Sequence[int], window_size: int = None) -> float:
    """Beeferman Pk: probability that two units k apart are wrongly classified
    as same/different segment. Lower is better."""
    k = window_size if window_size is not None else _default_window_size(ref_masses)
    k = max(k, 1)
    ref_pos = _positions_from_masses(ref_masses)
    hyp_pos = _positions_from_masses(hyp_masses)
    n = len(ref_pos)
    assert len(hyp_pos) == n, "Hypothesis and reference must cover the same units"
    if n - k <= 0:
        raise AssertionError("window size does not fit the document")
    ref_same = ref_pos[: n - k] == ref_pos[k:]
    hyp_same = hyp_pos[: n - k] == hyp_pos[k:]
    return float(np.sum(ref_same != hyp_same)) / (n - k)


def window_diff(
    hyp_masses: Sequence[int], ref_masses: Sequence[int], window_size: int = None
) -> float:
    """Pevzner & Hearst WindowDiff: fraction of windows where the boundary
    counts differ. Lower is better."""
    k = window_size if window_size is not None else _default_window_size(ref_masses)
    k = max(k, 1)
    ref_pos = _positions_from_masses(ref_masses)
    hyp_pos = _positions_from_masses(hyp_masses)
    n = len(ref_pos)
    assert len(hyp_pos) == n, "Hypothesis and reference must cover the same units"
    if n - k <= 0:
        raise AssertionError("window size does not fit the document")
    # number of boundaries inside each window = seg_id[i+k] - seg_id[i]
    ref_b = ref_pos[k:] - ref_pos[: n - k]
    hyp_b = hyp_pos[k:] - hyp_pos[: n - k]
    return float(np.sum(ref_b != hyp_b)) / (n - k)


def compute_Pk(boundaries, ground_truth, window_size: int = None) -> float:
    """Reference-contract wrapper: force final boundary to 1 on both sides."""
    h = list(np.asarray(boundaries, dtype=int))
    t = list(np.asarray(ground_truth, dtype=int))
    h[-1] = 1
    t[-1] = 1
    return pk(get_boundaries(h), get_boundaries(t), window_size)


def compute_window_diff(boundaries, ground_truth, window_size: int = None) -> float:
    h = list(np.asarray(boundaries, dtype=int))
    t = list(np.asarray(ground_truth, dtype=int))
    h[-1] = 1
    t[-1] = 1
    return window_diff(get_boundaries(h), get_boundaries(t), window_size)


def win_pr(reference: Sequence[int], hypothesis: Sequence[int], k: int = 10):
    """WinPR (Scaiano & Inkpen 2012): windowed precision/recall/F1.

    Matches the reference's inline implementation
    (lightning_model.py:57-124), including its handling of the leading
    partial windows and the "previous span first element" carry.
    """
    reference = [int(b) for b in reference]
    hypothesis = [int(b) for b in hypothesis]
    assert len(reference) == len(hypothesis), (
        "Hypothesis and reference should be the same length!"
    )
    n = len(reference)
    rc = []
    # the carry comes from the FIRST element of the previous iteration's
    # raw python slice reference[i:i+k] — for documents SHORTER than k the
    # negative start wraps to the array tail and the carry can fire during
    # the leading partial windows; keep the literal slice bookkeeping so
    # that quirk is preserved (lightning_model.py:83-99)
    span_r_prev: list = []
    span_c_prev: list = []
    for i in range(1 - k, n + 1):
        prev_br = 1 if span_r_prev and span_r_prev[0] == 1 else 0
        prev_bc = 1 if span_c_prev and span_c_prev[0] == 1 else 0
        span_r_prev = reference[i : i + k]
        span_c_prev = hypothesis[i : i + k]
        r = sum(reference[max(i, 0) : i + k]) + prev_br
        c = sum(hypothesis[max(i, 0) : i + k]) + prev_bc
        rc.append((r, c))

    tp = sum(min(r, c) for r, c in rc)
    tn = -k * (k - 1) + sum(k - max(r, c) for r, c in rc)
    fp = sum(max(0, c - r) for r, c in rc)
    fn = sum(max(0, r - c) for r, c in rc)
    del tn  # computed for completeness/debugging parity
    if tp + fp == 0:
        return 0.0, 0.0, 0.0
    precision = tp / (tp + fp)
    recall = tp / (tp + fn) if tp + fn else 0.0
    if precision + recall == 0:
        return precision, recall, 0.0
    f1 = 2 * (precision * recall / (precision + recall))
    return precision, recall, f1


# ---------------------------------------------------------------------------
# Boundary edit distance (Fournier 2013) and B-measure
# ---------------------------------------------------------------------------


def _boundary_positions(masses: Sequence[int]) -> set:
    """Internal boundary positions (between units), e.g. [2,3] -> {2}."""
    pos = set()
    acc = 0
    for m in masses[:-1]:
        acc += m
        pos.add(acc)
    return pos


def boundary_edit_distance(
    masses_a: Sequence[int], masses_b: Sequence[int], n_t: int = 2
) -> Tuple[int, List[int], int, int]:
    """Boundary edit distance between two single-boundary-type segmentations.

    Returns (matches, transposition_distances, additions_a_only,
    additions_b_only) where transpositions pair an a-only boundary with a
    b-only boundary at distance 1..n_t-1 (a transposition may span at most
    n_t units). The pairing is chosen to maximise the number of
    transpositions and, among those, minimise total spanned distance
    (optimal assignment — sizes are tiny).
    """
    a = _boundary_positions(masses_a)
    b = _boundary_positions(masses_b)
    matches = len(a & b)
    a_only = sorted(a - b)
    b_only = sorted(b - a)

    transp_dists: List[int] = []
    if a_only and b_only and n_t > 1:
        # max-cardinality min-cost matching on the small bipartite graph
        from scipy.optimize import linear_sum_assignment

        BIG = 10**6
        cost = np.full((len(a_only), len(b_only)), BIG, dtype=np.int64)
        for i, pa in enumerate(a_only):
            for j, pb in enumerate(b_only):
                d = abs(pa - pb)
                if 0 < d <= n_t - 1:
                    cost[i, j] = d
        # pad to square so unmatched boundaries take the BIG cost
        m = max(cost.shape)
        pad = np.full((m, m), BIG, dtype=np.int64)
        pad[: cost.shape[0], : cost.shape[1]] = cost
        rows, cols = linear_sum_assignment(pad)
        for i, j in zip(rows, cols):
            if i < cost.shape[0] and j < cost.shape[1] and cost[i, j] < BIG:
                transp_dists.append(int(cost[i, j]))

    n_transp = len(transp_dists)
    add_a = len(a_only) - n_transp
    add_b = len(b_only) - n_transp
    return matches, transp_dists, add_a, add_b


def boundary_similarity(
    masses_a: Sequence[int], masses_b: Sequence[int], n_t: int = 2
) -> float:
    """Fournier 2013 boundary similarity B in [0, 1] (1 = identical).

    B = 1 - (additions + sum(d_i / n_t)) / (matches + transpositions + additions).
    Transpositions are distance-weighted errors (d/n_t), additions full errors.
    """
    matches, transp, add_a, add_b = boundary_edit_distance(masses_a, masses_b, n_t)
    additions = add_a + add_b
    total = matches + len(transp) + additions
    if total == 0:
        return 1.0  # neither has internal boundaries -> identical
    penalty = additions + sum(d / n_t for d in transp)
    return 1.0 - penalty / total


def boundary_confusion_counts(
    hyp_masses: Sequence[int], ref_masses: Sequence[int], n_t: int = 4
):
    """Per-boundary-type confusion counts for B-precision / B-recall.

    Matches count 1; a transposition spanning d units contributes (1 - d/n_t)
    correct and d/n_t error split between precision and recall denominators;
    hyp-only boundaries are false positives, ref-only false negatives.
    """
    matches, transp, add_hyp, add_ref = boundary_edit_distance(
        hyp_masses, ref_masses, n_t
    )
    correct = matches + sum(1.0 - d / n_t for d in transp)
    # every transposed pair involves one hyp boundary and one ref boundary
    hyp_claimed = matches + len(transp) + add_hyp
    ref_actual = matches + len(transp) + add_ref
    return correct, hyp_claimed, ref_actual


def b_measure(boundaries, ground_truth):
    """Reference-contract wrapper returning (b_precision, b_recall, b_f1, b).

    Forces final boundaries to 1 (on copies), uses n_t=4 for the confusion
    matrix and n_t=10 for boundary similarity
    (lightning_model.py:126-152).
    """
    h = list(np.asarray(boundaries, dtype=int))
    t = list(np.asarray(ground_truth, dtype=int))
    h[-1] = 1
    t[-1] = 1
    hm = get_boundaries(h)
    tm = get_boundaries(t)
    correct, hyp_claimed, ref_actual = boundary_confusion_counts(hm, tm, n_t=4)
    b_precision = correct / hyp_claimed if hyp_claimed else 0.0
    b_recall = correct / ref_actual if ref_actual else 0.0
    if b_precision + b_recall == 0:
        b_f1 = 0.0
    else:
        b_f1 = 2 * (b_precision * b_recall) / (b_precision + b_recall)
    b = boundary_similarity(hm, tm, n_t=10)
    return float(b_precision), float(b_recall), float(b_f1), float(b)


def boundary_f1(target: Sequence[int], prediction: Sequence[int]) -> float:
    """F1 on the positive (boundary) class, sklearn f1_score(labels=[1]) semantics."""
    t = np.asarray(target, dtype=int)
    p = np.asarray(prediction, dtype=int)
    tp = int(np.sum((t == 1) & (p == 1)))
    fp = int(np.sum((t != 1) & (p == 1)))
    fn = int(np.sum((t == 1) & (p != 1)))
    if 2 * tp + fp + fn == 0:
        return 0.0
    return 2 * tp / (2 * tp + fp + fn)
