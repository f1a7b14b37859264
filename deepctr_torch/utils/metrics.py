"""Evaluation metrics: exact AUC, logloss and RMSE on the host, and the
streaming histogram AUC on the device.

Port of ``deepctr_tpu/utils/metrics.py``: the host metrics are copied (that
module imports jax); ``AucState`` and its functions are the reference's
in torch ops, accumulated on the logits' device. Its user is sharded
evaluation (ROADMAP.md, slice 5), where the histograms of the shards add.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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


# ---------------------------------------------------------------------------
# Streaming on-device AUC
# ---------------------------------------------------------------------------


class AucState(NamedTuple):
    """Histogram of sigmoid scores per class, f32 on the device. Addable
    across batches and devices."""

    pos: torch.Tensor  # f32[num_bins]
    neg: torch.Tensor  # f32[num_bins]


def auc_state_init(num_bins: int = 4096, device=None) -> AucState:
    return AucState(pos=torch.zeros(num_bins, device=device),
                    neg=torch.zeros(num_bins, device=device))


def auc_state_update(state: AucState, logits: torch.Tensor, labels: torch.Tensor,
                     weights: torch.Tensor) -> AucState:
    """Accumulate a batch, in place. Bins are uniform in sigmoid(score) in
    [0, 1]. ``index_add_`` sums in any order on the card; with the 0/1
    labels and weights of this system every addend and every partial sum
    is an integer below 2^24, so the counts are exact whatever the order."""
    nb = state.pos.shape[0]
    p = torch.sigmoid(logits.float())
    idx = torch.clamp((p * nb).to(torch.int32), 0, nb - 1)
    wpos = weights * labels
    wneg = weights * (1.0 - labels)
    state.pos.index_add_(0, idx, wpos.to(state.pos.dtype))
    state.neg.index_add_(0, idx, wneg.to(state.neg.dtype))
    return state


def auc_state_finalize(state: AucState) -> float:
    """AUC from histograms: P(score_pos > score_neg) + 0.5 P(equal-bin).
    The two ``[num_bins]`` vectors are all that reach the host."""
    pos = state.pos.cpu().numpy().astype(np.float64)
    neg = state.neg.cpu().numpy().astype(np.float64)
    npos, nneg = pos.sum(), neg.sum()
    if npos == 0 or nneg == 0:
        return float("nan")
    cneg = np.cumsum(neg)  # negatives in bins <= b
    wins = (pos * (cneg - neg)).sum()   # strictly lower bins
    ties = (pos * neg).sum()
    return float((wins + 0.5 * ties) / (npos * nneg))
