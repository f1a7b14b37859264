"""Sparse per-row optimizers for embedding tables.

Port of ``deepctr_tpu/optim/sparse.py``. Duplicate ids in a batch are summed
into one per-row gradient BEFORE the update rule (Adagrad's accumulator
sees ``(sum_i g_i)^2``). Two strategies, chosen per table size
(``mode="auto"``, the reference's ``_DENSE_AUTO_LIMIT``):

- **dense**: one deterministic scatter (``ops/scatter.py::scatter_totals``)
  builds the per-row summed gradient G in an f32 ``[V, D]`` scratch, then
  the update is a full-table elementwise pass; untouched rows have G = 0
  and keep their bits;
- **sorted**: the occurrence ids are sorted and summed per id
  (``ops/scatter.py``), and only those rows are updated; no ``[V, D]``
  temporary.

Both have static shapes and no host sync, so a CUDA graph can capture
them: the sorted update computes the new row for every occurrence from its
id's total (:func:`_occurrence_totals`) and writes all occurrences with a
non-accumulating ``index_put_``; duplicates write the same bits, so the
order of the writes does not matter. (Selecting the unique ids with a mask,
``ids[is_last]``, is a ``nonzero`` and a sync.)

A bf16 table keeps an f32 accumulator and an f32 scratch; updates are
computed in f32 and rounded on write. The pad row stays frozen because its
occurrence gradients are zero (the models mask pad slots).

Unlike the reference, which is functional, ``update`` writes the table and
the accumulator in place (it saves a table-sized copy per step) and returns
them. The reference's ``patches`` (dense per-field gradients of its split
embedding plan, a TPU gather mechanism the port does not have) and its
``scratch_dtype`` knob are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.scatter import dedupe_grads, scatter_totals

# tables up to this many elements use the dense-scratch strategy in "auto"
_DENSE_AUTO_LIMIT = 64 * 1024 * 1024


class SparseSgdState(NamedTuple):
    pass


class SparseAdagradState(NamedTuple):
    acc: torch.Tensor  # per-coordinate f32 accumulator, the table's shape


def _occurrence_totals(ids: torch.Tensor, rows: torch.Tensor,
                       ids_sorted: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sorted ids, totals)``: each occurrence beside its id's summed
    f32 gradient, all of static shape ``[M]`` and ``[M, D]``."""
    d = dedupe_grads(ids, rows.float(), ids_sorted=ids_sorted)
    last = torch.searchsorted(d.ids, d.ids, right=True) - 1
    return d.ids, d.rows[last]


def _pick_dense(mode: str, table: torch.Tensor) -> bool:
    if mode == "dense":
        return True
    if mode == "sorted":
        return False
    if mode != "auto":
        raise ValueError(f"sparse mode {mode!r} (auto|dense|sorted)")
    return table.numel() <= _DENSE_AUTO_LIMIT


@dataclasses.dataclass(frozen=True)
class SparseSgd:
    """Plain SGD on touched rows: ``row -= lr * sum_of_row_grads``."""

    learning_rate: float

    def init(self, table: torch.Tensor) -> SparseSgdState:
        del table
        return SparseSgdState()

    @torch.no_grad()
    def update(self, table: torch.Tensor, state: SparseSgdState,
               ids: torch.Tensor, rows: torch.Tensor, lr_scale: float = 1.0,
               ids_sorted: bool = False):
        lr = self.learning_rate * lr_scale
        # duplicates are summed in f32 and each touched row rounds once, on
        # write, as the reference's split path does for its small fields (its
        # gather path adds each occurrence in the table's dtype instead)
        sid, g = _occurrence_totals(ids, rows, ids_sorted)
        table.index_put_((sid,), (table[sid].float() - lr * g).to(table.dtype))
        return table, state


@dataclasses.dataclass(frozen=True)
class SparseAdagrad:
    """Per-coordinate Adagrad on touched rows.

    acc[i] += g_i^2 ; row_i -= lr * g_i / (sqrt(acc[i]) + eps)
    with g_i the per-row gradient summed over batch occurrences.
    """

    learning_rate: float
    eps: float = 1e-6
    initial_accumulator: float = 0.0
    mode: str = "auto"  # auto | dense | sorted

    def init(self, table: torch.Tensor) -> SparseAdagradState:
        return SparseAdagradState(acc=torch.full(
            table.shape, self.initial_accumulator, dtype=torch.float32,
            device=table.device))

    @torch.no_grad()
    def update(self, table: torch.Tensor, state: SparseAdagradState,
               ids: torch.Tensor, rows: torch.Tensor, lr_scale: float = 1.0,
               ids_sorted: bool = False):
        lr = self.learning_rate * lr_scale
        acc = state.acc
        if _pick_dense(self.mode, table):
            g = scatter_totals(table.shape[0], ids, rows.float())
            acc.add_(g * g)
            table.copy_(table.float() - lr * g / (acc.sqrt() + self.eps))
        else:
            sid, g = _occurrence_totals(ids, rows, ids_sorted)
            new_acc = acc[sid] + g * g
            acc.index_put_((sid,), new_acc)
            delta = -lr * g / (new_acc.sqrt() + self.eps)
            table.index_put_((sid,), (table[sid].float()
                                      + delta.to(table.dtype).float()).to(table.dtype))
        return table, state


def make_sparse_optimizer(name: str, learning_rate: float, **kw):
    name = name.lower()
    if name == "sgd":
        return SparseSgd(learning_rate)
    if name == "adagrad":
        return SparseAdagrad(learning_rate, **kw)
    raise ValueError(f"unknown sparse optimizer {name!r} (sgd|adagrad)")
