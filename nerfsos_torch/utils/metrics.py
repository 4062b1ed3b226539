"""Segmentation metrics in numpy (no sklearn).

``adjusted_rand_score`` follows sklearn's pair-confusion formulation
(``sklearn.metrics.adjusted_rand_score``): the 2x2 pair counts come from the
contingency table in exact integer arithmetic, then one float division.
"""
from __future__ import annotations

import numpy as np


def _pair_confusion(labels_true: np.ndarray, labels_pred: np.ndarray):
    n = int(labels_true.shape[0])
    _, t = np.unique(labels_true, return_inverse=True)
    _, p = np.unique(labels_pred, return_inverse=True)
    n_p = int(p.max()) + 1 if n else 0
    contingency = np.bincount(t.reshape(-1) * n_p + p.reshape(-1)) if n else np.zeros(0, np.int64)
    sum_squares = int(np.sum(contingency.astype(np.int64) ** 2))
    a = np.bincount(t.reshape(-1)).astype(np.int64) if n else np.zeros(0, np.int64)
    b = np.bincount(p.reshape(-1)).astype(np.int64) if n else np.zeros(0, np.int64)
    tp = sum_squares - n
    fp = int(np.sum(b**2)) - sum_squares
    fn = int(np.sum(a**2)) - sum_squares
    tn = n * n - fp - fn - sum_squares
    return tn, fp, fn, tp


def adjusted_rand_score(labels_true: np.ndarray, labels_pred: np.ndarray) -> float:
    """Permutation-invariant clustering agreement (1.0 for identical partitions)."""
    labels_true = np.asarray(labels_true).reshape(-1)
    labels_pred = np.asarray(labels_pred).reshape(-1)
    tn, fp, fn, tp = _pair_confusion(labels_true, labels_pred)
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))
