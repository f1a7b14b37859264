"""Deduplicating segment sums of occurrence gradients for sparse row updates.

Port of ``deepctr_tpu/ops/scatter.py``. Adagrad's accumulator takes
``(sum_i g_i)^2`` per row, so duplicate ids in a batch are summed before
the update rule. As in the reference, occurrence ids are stably sorted and
each distinct id's total lands on its LAST occurrence, every other
occurrence being zero.

The reference sums with a segmented ``associative_scan``, a TPU-friendly
form. Here a segment's total is the difference of a prefix sum over the
sorted rows at its last occurrence and just before its first (found by a
binary search of the sorted ids). The prefix sum is taken in 61-bit fixed
point, exact whatever order the scan associates in: no float atomics and no
host sync, so the bits do not change from run to run on the card, which the
bitwise-repeatable train step rests on. Measured on an H100 at the training
step's shape, ``index_put_(accumulate=True)``, also deterministic, takes
most of the step's device time (PERF.md, PR 2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DedupedGrads(NamedTuple):
    """Occurrence-aligned deduplicated gradients.

    ids:     int64[M] sorted occurrence ids.
    rows:    f32[M, D]; the TOTAL for each distinct id sits at that id's last
             occurrence, zeros elsewhere.
    is_last: bool[M] marks those last occurrences (the "unique" rows).
    """

    ids: torch.Tensor
    rows: torch.Tensor
    is_last: torch.Tensor


def segment_totals(sorted_ids: torch.Tensor, sorted_rows: torch.Tensor):
    """``(totals, is_last)`` of ascending ``sorted_ids``: each distinct id's
    row sum at its last occurrence (f32, zeros elsewhere), and the mask of
    last occurrences."""
    m = sorted_ids.shape[0]
    is_last = torch.ones(m, dtype=torch.bool, device=sorted_ids.device)
    is_last[:-1] = sorted_ids[1:] != sorted_ids[:-1]
    # one flat prefix sum, column after column (a 1-D scan is one cub pass),
    # in fixed point: int64 sums are exact, so the scan's order of
    # association, which varies from run to run on the card, cannot change
    # the bits. The scale puts the whole sum of |rows| below 2^61.
    d = sorted_rows.shape[1]
    flat = sorted_rows.double().t().reshape(-1)
    _, exponent = torch.frexp(flat.abs().max() * flat.numel())
    scale = torch.ldexp(torch.ones_like(flat[0]), 61 - exponent)
    csum = torch.cumsum(torch.round(flat * scale).long(), 0)
    # a segment's total: the prefix at its end less the prefix before its
    # first occurrence, which a binary search finds
    first = torch.searchsorted(sorted_ids, sorted_ids)
    before = (torch.arange(d, device=csum.device)[:, None] * m
              + first[None, :] - 1)
    base = torch.where(before >= 0, csum[before.clamp(min=0)], 0)
    totals = torch.where(is_last[None, :], csum.view(d, m) - base, 0)
    return (totals.double() / scale).t().to(torch.float32).contiguous(), is_last


def scatter_totals(num_rows: int, ids: torch.Tensor,
                   rows: torch.Tensor) -> torch.Tensor:
    """The dense f32 ``[num_rows, D]`` sum of ``rows`` by ``ids``: the
    reference's ``zeros.at[ids].add(rows)``, deterministic on the card. Each
    distinct id's total is written once; the other occurrences write to a
    spare row past the end, which is dropped."""
    sid, order = torch.sort(ids.long(), stable=True)
    totals, is_last = segment_totals(sid, rows[order])
    out = torch.zeros((num_rows + 1,) + rows.shape[1:], dtype=torch.float32,
                      device=rows.device)
    out[torch.where(is_last, sid, num_rows)] = totals
    return out[:num_rows]


def dedupe_grads(ids: torch.Tensor, rows: torch.Tensor,
                 ids_sorted: bool = False) -> DedupedGrads:
    """Combine duplicate-id gradient rows.

    ids:  int[M] (may contain duplicates and pad ids).
    rows: f32[M, D] per-occurrence gradients.
    ids_sorted: True when ``ids`` is already ascending, to skip the sort.
    """
    ids = ids.long()
    if ids_sorted:
        sid, srows = ids, rows
    else:
        sid, order = torch.sort(ids, stable=True)
        srows = rows[order]
    totals, is_last = segment_totals(sid, srows)
    return DedupedGrads(ids=sid, rows=totals, is_last=is_last)


def scatter_add_dedup(table: torch.Tensor, ids: torch.Tensor,
                      rows: torch.Tensor) -> torch.Tensor:
    """``table[ids] += rows`` with duplicate ids summed first; returns a new
    tensor, as the reference does."""
    d = dedupe_grads(ids, rows)
    return table.index_put((d.ids[d.is_last],), d.rows[d.is_last],
                           accumulate=True)


def segment_sum_dense(ids: torch.Tensor, rows: torch.Tensor,
                      num_rows: int) -> torch.Tensor:
    """Oracle: the dense ``[num_rows, D]`` segment sum of ``rows`` by
    ``ids``, a plain ``index_add_`` into zeros (the reference's
    ``jax.ops.segment_sum``). Its order of addition is the library's, so on
    the card its bits may change from run to run; the tests compare
    against it."""
    out = torch.zeros((num_rows,) + rows.shape[1:], dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, ids.long(), rows)
