"""Evaluation metrics on the host: exact AUC, logloss, RMSE.

Copied from ``deepctr_tpu/utils/metrics.py`` (numpy only), because that
module imports jax. Its on-device histogram AUC comes with sharded
evaluation (ROADMAP.md, slice 5).
"""

from __future__ import annotations

import numpy as np


def exact_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Exact ROC-AUC via the rank statistic (ties take midranks)."""
    labels = np.asarray(labels).astype(np.float64)
    scores = np.asarray(scores).astype(np.float64)
    order = np.argsort(scores, kind="mergesort")
    s = scores[order]
    y = labels[order]
    n = len(s)
    ranks = np.empty(n, dtype=np.float64)
    i = 0
    while i < n:
        j = i
        while j + 1 < n and s[j + 1] == s[i]:
            j += 1
        ranks[i : j + 1] = 0.5 * (i + j) + 1.0
        i = j + 1
    npos = y.sum()
    nneg = n - npos
    if npos == 0 or nneg == 0:
        return float("nan")
    return float((ranks[y == 1].sum() - npos * (npos + 1) / 2) / (npos * nneg))


def logloss(labels: np.ndarray, probs: np.ndarray, eps: float = 1e-7) -> float:
    p = np.clip(np.asarray(probs, np.float64), eps, 1 - eps)
    y = np.asarray(labels, np.float64)
    return float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).mean())


def rmse(labels: np.ndarray, probs: np.ndarray) -> float:
    d = np.asarray(probs, np.float64) - np.asarray(labels, np.float64)
    return float(np.sqrt((d * d).mean()))
