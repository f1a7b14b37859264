"""Train and eval steps: the port of ``deepctr_tpu/train/step.py``.

The reference's structure is kept: the loss is differentiated with respect
to the gathered rows ``[B, S, D]`` and the dense parameters, never the
``[V, D]`` table, and the occurrence gradients go to the sparse optimizer,
so the table update costs O(batch) however large the vocabulary.

What differs from the reference, and why:

- The model module holds the parameters (table and tower), and a step
  updates them in place, with the optimizers' states, instead of returning
  new arrays. ``TrainState.clone`` copies a state where a caller needs two.
- The dropout seed of each step is an int below 2^24 drawn from the state's
  ``torch.Generator`` (on the CPU), or given as ``seed=`` so that a test can
  feed the JAX step's seeds.
- The reference's split plan (``ops/split_embed.py``) is not ported: its
  one-hot matmuls are a TPU gather mechanism. One gather of all slots and
  one scatter of the occurrence gradients give the same per-row sums, up to
  f32 summation order; the parity tests hold the port against the JAX step
  with and without the plan.
- ``make_scan_train_step`` is a JAX dispatch device and is not ported.
- ``make_pretrain_step`` has no ``jit`` and no ``donate_argnums``, and takes
  a ``torch.Generator`` where the reference threads a PRNG key: the table,
  the optimizer's state and ``b1`` are updated in place.

On the card the step is bitwise repeatable: the gather's backward is never
taken (rows are a leaf), the tower's backward kernel and the FM scorer
kernel sum in a fixed order, and the sparse optimizers sum duplicate ids
with ``ops/scatter.py``'s prefix sums in 61-bit fixed point, exact in any
order (``scatter_totals`` in dense mode, ``dedupe_grads`` in sorted mode);
no float atomics.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from ..models.base import lazy_l2, weighted_bce_with_logits
from ..ops.kernels.mlp import SEED_LIMIT
from ..data import Schema


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module              # table and dense parameters, updated in place
    sparse_state: Any
    dense_state: Any              # the dense optimizer's (a list, or AdamState)
    generator: torch.Generator    # dropout seeds, on the CPU

    @property
    def table(self) -> torch.Tensor:
        return self.model.table

    def clone(self) -> "TrainState":
        generator = torch.Generator()
        generator.set_state(self.generator.get_state())
        return TrainState(
            step=self.step,
            model=copy.deepcopy(self.model),
            sparse_state=type(self.sparse_state)(
                *(t.clone() for t in self.sparse_state)),
            dense_state=_clone_tree(self.dense_state),
            generator=generator,
        )


def _clone_tree(node):
    """A copy of a state made of tensors, lists and NamedTuples."""
    if isinstance(node, torch.Tensor):
        return node.clone()
    if isinstance(node, tuple):
        return type(node)(*(_clone_tree(sub) for sub in node))
    return [_clone_tree(sub) for sub in node]


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    logits: torch.Tensor


def dense_params(model: nn.Module) -> list[torch.Tensor]:
    """The dense parameters (tower, bias) in ``named_parameters`` order
    (the table is the sparse optimizer's)."""
    return [p for name, p in model.named_parameters() if name != "table"]


def init_state(model: nn.Module, schema: Schema, sparse_opt, dense_opt,
               seed: int = 0, table_dtype: str = "f32") -> TrainState:
    """Initialise ``model`` in place from ``seed`` and build the state.

    ``table_dtype="bf16"`` stores the table in bfloat16; the gathered rows,
    the gradients and the Adagrad accumulator stay f32, and updates round on
    write."""
    device = model.table.device
    model.init_parameters(torch.Generator(device=device).manual_seed(seed),
                          schema.pad_id)
    if table_dtype == "bf16":
        model.table.data = model.table.data.to(torch.bfloat16)
    elif table_dtype != "f32":
        raise ValueError(f"table_dtype {table_dtype!r} (f32|bf16)")
    model.table.requires_grad_(False)
    return TrainState(
        step=0,
        model=model,
        sparse_state=sparse_opt.init(model.table),
        dense_state=dense_opt.init(dense_params(model)),
        generator=torch.Generator().manual_seed(seed),
    )


def _to_device(a, device, dtype) -> torch.Tensor:
    """A numpy array or tensor on ``device`` in ``dtype``. A tensor already
    there (a prefetched batch) is not copied again; a dtype change is then
    an op on the device."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=dtype, non_blocking=True)


def make_train_step(schema: Schema, sparse_opt, dense_opt, l2: float = 0.0,
                    check_finite: bool = False):
    """Build ``step(state, ids, labels, weights, lr_scale=1.0, seed=None)
    -> (state, StepMetrics)``. Batches are numpy arrays or tensors; they
    go to the model's device.

    ``check_finite`` (the CLI's ``train.debug_nans``) reads the loss on the
    host before the backward pass, a sync every step, and raises
    ``FloatingPointError`` at the first step whose loss is not finite,
    before anything is updated."""
    pad_id = schema.pad_id

    def step(state: TrainState, ids, labels, weights, lr_scale: float = 1.0,
             seed: int | None = None):
        model = state.model
        device = model.table.device
        drawn = int(torch.randint(0, SEED_LIMIT, (), generator=state.generator))
        seed = drawn if seed is None else seed
        ids = _to_device(ids, device, torch.long)
        labels = _to_device(labels, device, torch.float32)
        weights = _to_device(weights, device, torch.float32)
        mask = (ids != pad_id).float()
        rows = model.table.detach()[ids].float().requires_grad_(True)
        params = dense_params(model)

        logits = model.apply_rows(rows, mask, train=True, seed=seed)
        loss = weighted_bce_with_logits(logits, labels, weights)
        loss = loss + lazy_l2(rows, mask, l2)
        if check_finite and not bool(torch.isfinite(loss)):
            raise FloatingPointError(f"train step {state.step + 1}: loss "
                                     f"{float(loss.detach())} is not finite")
        g_rows, *g_dense = torch.autograd.grad(loss, [rows] + params)

        sparse_opt.update(model.table.data, state.sparse_state,
                          ids.reshape(-1), g_rows.reshape(-1, g_rows.shape[-1]),
                          lr_scale=lr_scale)
        dense_opt.update(params, g_dense, state.dense_state, lr_scale=lr_scale)
        state.step += 1
        return state, StepMetrics(loss=loss.detach(), logits=logits.detach())

    return step


def make_eval_step(schema: Schema):
    """Build ``eval_step(model, ids) -> logits`` (no dropout)."""
    pad_id = schema.pad_id

    @torch.no_grad()
    def eval_step(model: nn.Module, ids) -> torch.Tensor:
        ids = _to_device(ids, model.table.device, torch.long)
        rows = model.table[ids].float()
        return model.apply_rows(rows, (ids != pad_id).float(), train=False)

    return eval_step


# ---------------------------------------------------------------------------
# SNN unsupervised pretraining step (shared by DAE and RBM)
# ---------------------------------------------------------------------------


def make_pretrain_step(pretrainer, schema: Schema, sparse_opt, dense_lr: float,
                       with_noise: bool = False):
    """Build ``pstep(table, sparse_state, dense, generator, ids) -> (table,
    sparse_state, dense, generator, loss)`` where ``dense`` = ``{"b1",
    "vbias"}`` (``init_pretrain_dense``). The table goes through
    ``sparse_opt.update`` (duplicates of an id, a sampled negative that is
    also active among them, are summed before the rule); ``vbias`` takes
    plain SGD through a deduplicated scatter, ``b1`` plain SGD. The table,
    the sparse state and ``b1`` are updated in place; ``dense`` is the same
    dict with a new ``vbias``.

    ``with_noise=True`` builds ``pstep(..., ids, noise)`` where ``noise`` is
    the pretrainer's dict of uniforms: the same uniforms fed to the
    reference's step and to the NumPy oracle make the trajectories
    comparable."""
    from ..models.snn import field_sampling
    from ..ops.scatter import scatter_add_dedup

    pad_id = schema.pad_id
    sampling = {}  # device -> FieldSampling

    @torch.no_grad()
    def pstep(table, sparse_state, dense, generator, ids, noise=None):
        device = table.device
        if device not in sampling:
            sampling[device] = field_sampling(schema, device)
        ids = _to_device(ids, device, torch.long)
        loss, occ_ids, occ_rows, dgrads = pretrainer.loss_and_grads(
            table, dense, ids, pad_id, sampling[device], generator, noise=noise)
        table, sparse_state = sparse_opt.update(table, sparse_state, occ_ids, occ_rows)
        dense["vbias"] = scatter_add_dedup(
            dense["vbias"][:, None], dgrads["vbias_ids"],
            -dense_lr * dgrads["vbias_grads"][:, None])[:, 0]
        dense["b1"].sub_(dense_lr * dgrads["b1"])
        return table, sparse_state, dense, generator, loss

    if with_noise:
        return pstep
    return lambda table, sparse_state, dense, generator, ids: pstep(
        table, sparse_state, dense, generator, ids)
