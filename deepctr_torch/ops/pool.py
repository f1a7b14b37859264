"""Multi-hot pooling: each field's gathered rows, masked and summed, in one
batched product; and the count of ids the train steps gather.

A multi-hot field holds many ids an example (DLRM's Criteo fields 1 to 100),
so the pooled input ``[B, F, D]`` is a small share of the gathered rows
``[B, S, D]``. :func:`pool_slots` sums them with one batched float32 product
of the masked slot-to-field map ``[B, S, F]`` and the rows, forward and
backward: the rows are read once and never copied masked, and a slot's
gradient is its field's, times its mask, exactly (a product by 1 or 0 and
a sum of one term). It equals ``models/base.py::pool_fields`` up to the
order of each field's float32 sum.

``OCCURRENCES`` counts the ids the train steps gathered (``train/step.py``:
``B·S`` a step, pad slots included), beside the kernels' launch counters
(:mod:`.kernels`): a graph's capture takes its count back and adds it at
every replay.
"""

from __future__ import annotations

import torch

from .layers import f32_products

# ids gathered by train steps since the last reset (a replay's included)
OCCURRENCES = 0


def count_occurrences(n: int) -> None:
    """Add ``n`` gathered ids to :data:`OCCURRENCES`."""
    global OCCURRENCES
    OCCURRENCES += int(n)


class _PoolSlots(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, weights):
        ctx.save_for_backward(weights)
        with f32_products():
            return torch.bmm(weights.transpose(1, 2), rows)

    @staticmethod
    def backward(ctx, g):
        (weights,) = ctx.saved_tensors
        with f32_products():
            return torch.bmm(weights, g.contiguous()), None


def pool_slots(rows: torch.Tensor, mask: torch.Tensor,
               slot_onehot: torch.Tensor) -> torch.Tensor:
    """rows ``[B, S, D]``, mask ``[B, S]``, the slot-to-field map ``[S, F]``
    -> each field's masked slot sum ``[B, F, D]``; differentiable in the
    rows."""
    weights = mask[..., None] * slot_onehot
    return _PoolSlots.apply(rows, weights)
