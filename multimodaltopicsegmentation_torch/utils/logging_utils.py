"""Logging + prediction-analysis helpers (reference utils/utils.py:32-175): a
copy of the JAX package's utils/logging_utils.py (the port does not import
that package)."""
from __future__ import annotations

import logging
import sys
from typing import Sequence


def setup_logger(name: str, log_file: str, level=logging.INFO, delay: bool = False):
    """File + stderr logger (reference utils/utils.py:32-44)."""
    formatter = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    fh = logging.FileHandler(log_file, delay=delay)
    fh.setFormatter(formatter)
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(formatter)
    logger.setLevel(level)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


def predictions_analysis(targets: Sequence[int], predictions: Sequence[int]) -> dict:
    """Confusion counts + precision/recall/F1 for boundary predictions."""
    tp = fp = fn = tn = 0
    for t, p in zip(targets, predictions):
        if p == 1 and t == 1:
            tp += 1
        elif p == 1:
            fp += 1
        elif t == 1:
            fn += 1
        else:
            tn += 1
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    return {
        "tp": tp, "fp": fp, "fn": fn, "tn": tn,
        "precision": precision, "recall": recall, "f1": f1,
    }
