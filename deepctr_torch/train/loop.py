"""Training loop: epochs, per-epoch eval, early stopping.

Port of ``deepctr_tpu/train/loop.py`` (``evaluate`` and ``fit`` on its
per-step route). Epochs shuffle through the shared ``minibatches`` with
``seed + epoch`` and drop the last partial batch; the learning rate decays
by ``lr_decay ** epoch``; training stops early when the held-out AUC has not
improved for more than ``early_stop_patience`` epochs. ``start_epoch``
continues the epoch schedule of a saved run.

Not here: the reference's ``lax.scan`` route (a JAX dispatch device), its
background device prefetcher (ROADMAP.md slice 4), streaming input
(``train_source``) and SNN pretraining (both later slices).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..shared import Schema, minibatches
from ..utils import metrics as M
from ..utils.logging import MetricsLogger
from .step import TrainState, init_state, make_eval_step, make_train_step


@dataclasses.dataclass
class FitResult:
    state: TrainState
    history: list[dict]
    best_auc: float
    best_epoch: int


def evaluate(eval_step: Callable, model: nn.Module, ids: np.ndarray,
             labels: np.ndarray, schema: Schema, batch_size: int = 8192) -> dict:
    """Full-dataset eval -> ``{auc, logloss, rmse}``."""
    logits_all = []
    for b in minibatches(ids, labels, batch_size, schema=schema, shuffle=False,
                         drop_remainder=False):
        logits = eval_step(model, b.ids).cpu().numpy()
        logits_all.append(logits[b.weights > 0])
    logits_np = np.concatenate(logits_all)
    probs = 1.0 / (1.0 + np.exp(-logits_np))
    return {
        "auc": M.exact_auc(labels, probs),
        "logloss": M.logloss(labels, probs),
        "rmse": M.rmse(labels, probs),
    }


def fit(
    model: nn.Module,
    schema: Schema,
    train_ids: np.ndarray,
    train_labels: np.ndarray,
    test_ids: np.ndarray,
    test_labels: np.ndarray,
    *,
    sparse_opt,
    dense_opt,
    batch_size: int = 1024,
    epochs: int = 10,
    l2: float = 0.0,
    seed: int = 0,
    early_stop_patience: int = 2,
    lr_decay: float = 1.0,
    state: TrainState | None = None,
    logger: MetricsLogger | None = None,
    on_epoch: Callable[[int, TrainState, dict], None] | None = None,
    start_epoch: int = 0,
    table_dtype: str = "f32",
) -> FitResult:
    """Train ``model`` (in place) with per-epoch eval and early stop on
    held-out AUC. Without ``state``, the model is initialised from
    ``seed``."""
    step = make_train_step(schema, sparse_opt, dense_opt, l2=l2)
    eval_step = make_eval_step(schema)
    if state is None:
        state = init_state(model, schema, sparse_opt, dense_opt, seed=seed,
                           table_dtype=table_dtype)
    sync = (torch.cuda.synchronize if model.table.device.type == "cuda"
            else (lambda: None))

    history: list[dict] = []
    best_auc, best_epoch, since_best = -np.inf, -1, 0
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        lr_scale = lr_decay**epoch
        n_batches = 0
        losses = []  # device scalars, read once per epoch
        for b in minibatches(train_ids, train_labels, batch_size, schema=schema,
                             shuffle=True, seed=seed + epoch,
                             drop_remainder=True):
            state, m = step(state, b.ids, b.labels, b.weights, lr_scale)
            losses.append(m.loss)
            n_batches += 1
        sync()
        train_time = time.perf_counter() - t0
        loss_sum = float(torch.stack(losses).sum()) if losses else 0.0
        ev = evaluate(eval_step, state.model, test_ids, test_labels, schema)
        rec = {
            "epoch": epoch,
            "train_loss": loss_sum / max(n_batches, 1),
            "examples_per_s": n_batches * batch_size / max(train_time, 1e-9),
            **ev,
        }
        history.append(rec)
        if logger is not None:
            logger.log(rec)
        if on_epoch is not None:
            on_epoch(epoch, state, rec)
        if ev["auc"] > best_auc:
            best_auc, best_epoch, since_best = ev["auc"], epoch, 0
        else:
            since_best += 1
            if since_best > early_stop_patience:
                break
    if not history:  # resumed past the epoch target: evaluate only
        ev = evaluate(eval_step, state.model, test_ids, test_labels, schema)
        rec = {"epoch": start_epoch, "eval_only": True, **ev}
        history.append(rec)
        if logger is not None:
            logger.log(rec)
        best_auc, best_epoch = ev["auc"], start_epoch
    return FitResult(state=state, history=history, best_auc=float(best_auc),
                     best_epoch=best_epoch)
