"""Read a pickled scikit-learn `LogisticRegression` without scikit-learn.

The logistic-regression baseline of `cli/predict.py -lgr` serves a model
that the reference pickled with sklearn. This module replaces `pickle.load`
and sklearn's `predict` where sklearn is not installed:

- `load` unpickles through a restricted `pickle.Unpickler` whose
  `find_class` allows numpy's array reconstructors (`_reconstruct` and
  `scalar`, under numpy 2's `numpy._core.multiarray` and numpy 1's
  `numpy.core.multiarray`), `numpy.ndarray`, `numpy.dtype` and
  `sklearn.linear_model._logistic.LogisticRegression`, which maps to
  `LogisticRegression` below. Any other global is refused with an error that
  names it, so a pickle cannot call `os.system` or the like.
- `LogisticRegression.predict` gives sklearn's labels: `classes_[argmax(X @
  coef_.T + intercept_)]`, or for two classes `classes_[decision > 0]`,
  computed in float64 on the caller's device (sklearn upcasts float32 input
  against its float64 coefficients; float32 would flip labels near the
  decision boundary). A model fitted on float32 data keeps float32
  coefficients, and sklearn then scores float32 input in float32: there the
  labels agree except within that rounding (about 1e-7 relative) of the
  boundary, where the float64 score is the closer one.
"""
from __future__ import annotations

import importlib
import pickle

import numpy as np
import torch

SKLEARN_CLASS = ("sklearn.linear_model._logistic", "LogisticRegression")
_NUMPY_RECONSTRUCTORS = ("_reconstruct", "scalar")


def _multiarray():
    try:
        return importlib.import_module("numpy._core.multiarray")
    except ImportError:  # numpy 1
        return importlib.import_module("numpy.core.multiarray")


class LogisticRegression:
    """The fitted state of sklearn's LogisticRegression (`coef_`,
    `intercept_`, `classes_`, ...), as its pickle's `__setstate__` dict
    gives it, with sklearn's `decision_function` and `predict`."""

    def __setstate__(self, state: dict):
        self.__dict__.update(state)

    def decision_function(self, X, device="cpu") -> torch.Tensor:
        """X [n, features] -> [n, classes or 1] float64 scores on `device`."""
        X = torch.as_tensor(np.asarray(X), device=device).to(torch.float64)
        coef = torch.as_tensor(np.asarray(self.coef_, np.float64), device=device)
        intercept = torch.as_tensor(np.asarray(self.intercept_, np.float64), device=device)
        return X @ coef.T + intercept

    def predict(self, X, device="cpu") -> np.ndarray:
        scores = self.decision_function(X, device)
        if scores.shape[1] == 1:
            index = (scores[:, 0] > 0).long()
        else:
            index = scores.argmax(dim=1)  # first maximum, as numpy's
        return np.asarray(self.classes_)[index.cpu().numpy()]


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == SKLEARN_CLASS:
            return LogisticRegression
        if module in ("numpy._core.multiarray", "numpy.core.multiarray") \
                and name in _NUMPY_RECONSTRUCTORS:
            return getattr(_multiarray(), name)
        if module == "numpy" and name in ("ndarray", "dtype"):
            return getattr(np, name)
        raise pickle.UnpicklingError(
            f"refusing global {module}.{name} in a logistic-regression pickle: only "
            f"{'.'.join(SKLEARN_CLASS)} and numpy's array reconstructors are allowed")


def load(path: str) -> LogisticRegression:
    with open(path, "rb") as f:
        model = _Unpickler(f).load()
    if not isinstance(model, LogisticRegression):
        raise pickle.UnpicklingError(
            f"{path!r} holds a {type(model).__name__}, not a {'.'.join(SKLEARN_CLASS)}")
    return model
