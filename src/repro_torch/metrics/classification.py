"""Accuracy and F1 (the paper's evaluation metrics), numpy-only.

F1 is macro-averaged for multi-class (MNIST/FMNIST) and the positive
-class F1 for binary tasks when average='binary', matching sklearn's
conventions used by the paper's reference implementation.

Both metrics refuse non-finite inputs: a NaN prediction row (e.g. an
argmax over NaN logits from a diverged or corrupted model that
slipped past the exchange guard) silently compares unequal to every
label, which would report a plausible-looking near-zero score instead
of the actual failure.  The guard names the offending argument and
count so the caller can trace it back to the run.
"""
from __future__ import annotations

import numpy as np


def _check_finite(name, arr):
    """Refuse NaN/Inf metric inputs with an actionable error (float
    arrays only -- integer label arrays cannot hold non-finite
    values)."""
    if np.issubdtype(arr.dtype, np.floating):
        bad = ~np.isfinite(arr)
        if bad.any():
            raise ValueError(
                f"{name} contains {int(bad.sum())} non-finite "
                f"value(s) (of {arr.size}): a NaN/Inf prediction "
                "compares unequal to every label and would score as "
                "silently-wrong instead of failing; this usually "
                "means a diverged model or a corrupted exchange -- "
                "check the run's fault telemetry / loss history")
    return arr


def accuracy(y_true, y_pred) -> float:
    y_true = _check_finite("y_true", np.asarray(y_true))
    y_pred = _check_finite("y_pred", np.asarray(y_pred))
    return float((y_true == y_pred).mean())


def f1_score(y_true, y_pred, average="macro") -> float:
    y_true = _check_finite("y_true", np.asarray(y_true))
    y_pred = _check_finite("y_pred", np.asarray(y_pred))
    classes = np.unique(np.concatenate([y_true, y_pred]))
    if average == "binary":
        classes = np.array([1])
    f1s = []
    for c in classes:
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1s.append(2 * prec * rec / (prec + rec) if prec + rec else 0.0)
    return float(np.mean(f1s))
