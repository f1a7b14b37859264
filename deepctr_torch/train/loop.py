"""Training loop: epochs, per-epoch eval, early stopping.

Port of ``deepctr_tpu/train/loop.py`` (``evaluate``, ``fit`` on both its
routes, and ``pretrain_snn``). Epochs shuffle with ``seed + epoch`` and drop
the last partial batch (pretraining epochs too), or stream shards through a
``data.stream.StreamSource`` (``train_source``); the learning rate decays
by ``lr_decay ** epoch``; training stops early when the held-out AUC has not
improved for more than ``early_stop_patience`` epochs. ``start_epoch``
continues the epoch schedule of a saved run, so a killed and resumed run
gives the uninterrupted run's bits. ``prefetch`` stages the training
batches, or chunks, on a background thread (``data.DevicePrefetcher``); as
in the reference, eval and ``pretrain_snn`` do not prefetch.

``scan_steps = K > 1`` is the reference's chunked route, its default: an
epoch is chunks of K steps (:func:`ram_chunks`, or the stream's
``scan_chunks``), each trained by ``train.step.make_scan_train_step`` (on
the card one CUDA graph replay), or in a sharded run by its
``scan_step`` (``parallel.make_sharded_scan_train_step``). A short last
chunk is padded to K with weight-0 steps, which are real steps:
``state.step`` counts them and they draw dropout seeds, as the
reference's do.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..data import DevicePrefetcher, Schema, minibatches
from ..utils import metrics as M
from ..utils.logging import MetricsLogger
from .step import (
    TrainState,
    init_state,
    make_eval_step,
    make_pretrain_step,
    make_scan_train_step,
    make_train_step,
)


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


def ram_chunks(ids: np.ndarray, labels: np.ndarray, batch_size: int,
               scan_steps: int, *, schema: Schema, seed: int):
    """An in-RAM epoch in chunks, as the reference's scan route cuts it:
    ``(nb, (ids [K, B, S], labels [K, B], weights [K, B]))``. The order is
    ``np.arange(n)`` shuffled by ``default_rng(seed)`` (``minibatches``'),
    a chunk holds K·B rows and only whole batches, and a short last chunk
    is padded to K steps of pad ids, label 0 and weight 0."""
    n, s = ids.shape
    order = np.arange(n)
    np.random.default_rng(seed).shuffle(order)
    chunk = scan_steps * batch_size
    for start in range(0, n - batch_size + 1, chunk):
        sel = order[start:start + chunk]
        nb = len(sel) // batch_size
        sel = sel[:nb * batch_size]
        ids_t = ids[sel].reshape(nb, batch_size, s)
        y_t = labels[sel].reshape(nb, batch_size)
        w_t = np.ones((nb, batch_size), np.float32)
        if nb < scan_steps:
            pad = scan_steps - nb
            ids_t = np.concatenate(
                [ids_t, np.full((pad, batch_size, s), schema.pad_id, np.int32)])
            y_t = np.concatenate([y_t, np.zeros((pad, batch_size), np.float32)])
            w_t = np.concatenate([w_t, np.zeros((pad, batch_size), np.float32)])
        yield nb, (ids_t, y_t, w_t)


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
    prefetch: bool = True,
    train_source=None,
    debug_nans: bool = False,
    step: Callable | None = None,
    evaluate_state: Callable[[TrainState], dict] | None = None,
    batch_transform: Callable | None = None,
    scan_steps: int = 0,
    scan_step: Callable | None = None,
) -> FitResult:
    """Train ``model`` (in place) with per-epoch eval and early stop on
    held-out AUC. Without ``state``, the model is initialised from
    ``seed``.

    ``train_source`` (a ``data.stream.StreamSource``) replaces the in-RAM
    ``train_ids``/``train_labels`` (pass None): each epoch is
    ``train_source.batches(epoch)``, or ``train_source.scan_chunks(epoch,
    scan_steps)``. ``debug_nans`` raises ``FloatingPointError`` at the first
    step whose loss is not finite (a chunk then runs as K eager steps).

    ``scan_steps > 1`` trains in chunks of that many steps (the module's
    docstring). The epoch's loss is the mean over its real steps.

    A sharded run (``cli._sharded_parts``) replaces four parts: ``step``
    (``(state, ids, labels, weights, lr_scale) -> (state, metrics)``; a
    ``dropped`` field in its metrics puts the epoch's sum in the record as
    ``dropped_ids``), ``scan_step`` (``parallel.make_sharded_scan_train_step``:
    ``(state, ids, labels, weights, lr_scale) -> (state, metrics)`` on a
    chunk, with ``losses`` and ``dropped`` fields; ``dropped_ids`` then
    sums all K steps of every chunk, pad steps included, as the
    reference's), ``evaluate_state`` (``state -> {auc, ...}``, in place of
    the full-dataset :func:`evaluate` of ``test_ids``) and
    ``batch_transform`` (applied to every training batch, or chunk, before
    the prefetcher stages it, which so stages only the rank's rows). A
    given ``step`` without a ``scan_step`` keeps the per-step route
    whatever ``scan_steps`` says."""
    if scan_steps <= 1:
        scan_step = None
    elif scan_step is None and step is None:
        scan_step = make_scan_train_step(schema, sparse_opt, dense_opt, l2=l2,
                                         check_finite=debug_nans)
    if step is None:
        step = make_train_step(schema, sparse_opt, dense_opt, l2=l2,
                               check_finite=debug_nans)
    if evaluate_state is None:
        eval_step = make_eval_step(schema)

        def evaluate_state(st):
            return evaluate(eval_step, st.model, test_ids, test_labels, schema)
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
        losses, drops = [], []  # device scalars, read once per epoch
        if scan_step is not None:
            it = (train_source.scan_chunks(epoch, scan_steps)
                  if train_source is not None
                  else ram_chunks(train_ids, train_labels, batch_size, scan_steps,
                                  schema=schema, seed=seed + epoch))
        else:
            it = (train_source.batches(epoch) if train_source is not None
                  else minibatches(train_ids, train_labels, batch_size,
                                   schema=schema, shuffle=True, seed=seed + epoch,
                                   drop_remainder=True))
        if batch_transform is not None:
            it = map(batch_transform, it)
        if prefetch:
            it = DevicePrefetcher(it, model.table.device)
        try:
            if scan_step is not None:
                for nb, chunk in it:
                    state, out = scan_step(state, *chunk, lr_scale)
                    losses.append(getattr(out, "losses", out)[:nb].sum())
                    if hasattr(out, "dropped"):
                        drops.append(out.dropped.sum())
                    n_batches += nb
            else:
                for b in it:
                    state, m = step(state, b.ids, b.labels, b.weights, lr_scale)
                    losses.append(m.loss)
                    if hasattr(m, "dropped"):
                        drops.append(m.dropped)
                    n_batches += 1
        finally:
            if prefetch:
                it.close()
        sync()
        train_time = time.perf_counter() - t0
        loss_sum = float(torch.stack(losses).sum()) if losses else 0.0
        ev = evaluate_state(state)
        rec = {
            "epoch": epoch,
            "train_loss": loss_sum / max(n_batches, 1),
            **({"dropped_ids": int(torch.stack(drops).sum())} if drops else {}),
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
        ev = evaluate_state(state)
        rec = {"epoch": start_epoch, "eval_only": True, **ev}
        history.append(rec)
        if logger is not None:
            logger.log(rec)
        best_auc, best_epoch = ev["auc"], start_epoch
    return FitResult(state=state, history=history, best_auc=float(best_auc),
                     best_epoch=best_epoch)


def pretrain_snn(
    pretrainer,
    schema: Schema,
    hidden1: int,
    train_ids: np.ndarray,
    *,
    sparse_opt,
    dense_lr: float = 0.1,
    batch_size: int = 1024,
    epochs: int = 1,
    seed: int = 0,
    logger: MetricsLogger | None = None,
    device: torch.device | str,
):
    """Unsupervised pretraining of SNN's bottom layer on ``device``.

    Returns ``(table, b1)`` to seed ``SNNModel``'s supervised phase. The
    table starts normal with sigma 0.01 (pad row zero) from a
    ``torch.Generator`` seeded with ``seed``, which also gives the steps'
    noise."""
    from ..models.base import init_table
    from ..models.snn import init_pretrain_dense

    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    table = torch.zeros(schema.padded_vocab_size, hidden1, device=device)
    init_table(table, generator, 0.01, schema.pad_id)
    dense = init_pretrain_dense(schema, hidden1, device)
    sparse_state = sparse_opt.init(table)
    pstep = make_pretrain_step(pretrainer, schema, sparse_opt, dense_lr)

    dummy_labels = np.zeros(train_ids.shape[0], np.float32)
    for epoch in range(epochs):
        losses = []  # device scalars, read once per epoch
        for b in minibatches(train_ids, dummy_labels, batch_size, schema=schema,
                             shuffle=True, seed=seed + epoch, drop_remainder=True):
            table, sparse_state, dense, generator, loss = pstep(
                table, sparse_state, dense, generator, b.ids)
            losses.append(loss)
        if logger is not None:
            logger.log({
                "pretrain_epoch": epoch,
                "pretrain_loss": (float(torch.stack(losses).mean()) if losses
                                  else float("nan")),
            })
    return table, dense["b1"]
