"""Per-step communication volume of the sharded train step.

Port of ``exchange_capacity``, ``CommVolume``, ``comm_volume`` and
``dense_param_bytes`` from ``deepctr_tpu/parallel/comm.py``: the volumes
are closed-form in the step's shapes, and the sharded step
(``parallel/sharded.py``) takes its capacity from :func:`exchange_capacity`,
so the accounting cannot drift from execution.

Exchange inventory of one sharded train step:

================  =========================  ==========================
collective        payload (per rank)         purpose
================  =========================  ==========================
all_to_all        [N, C] int64 (counted i32) id requests
all_to_all        [N, C, D] f32 or bf16      gathered rows, owner->user
all_to_all        [N, C, D] f32 or bf16      occurrence grads, user->owner
all_reduce        dense params               tower grad sync
all_reduce        3 scalars                  weight sum, loss, drop counter
================  =========================  ==========================

with N = world size, C = exchange capacity, D = row width. Every slot
rides the exchange: the reference's split plan (small fields all-gathered
as replicated subtables) is a TPU gather mechanism that the port does not
have, so its small-field terms are absent here. The ids are counted at 4
bytes, as the reference counts them; the port sends them as int64, its
index type. The reference's ``predict_scaling`` models a TPU's ICI and DCN
links and is not ported.
"""

from __future__ import annotations

import dataclasses

import torch


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def exchange_capacity(m: int, n: int, capacity_factor: float) -> int:
    """Per-owner bucket capacity C for m local occurrences over n shards."""
    return max(1, min(max(m, 1), int(capacity_factor * _cdiv(max(m, 1), n))))


@dataclasses.dataclass(frozen=True)
class CommVolume:
    """Per-rank, per-step exchanged bytes, by collective.

    ``*_wire`` apply the cross-rank fraction: an all_to_all keeps 1/N of
    its payload local; a ring all-reduce moves 2(N-1)/N of its operand."""

    n_devices: int
    batch_per_device: int
    capacity: int
    ids_a2a: int            # [N, C] ids, one direction
    rows_a2a_fwd: int       # [N, C, D]
    rows_a2a_bwd: int       # [N, C, D]
    dense_psum: int         # dense param bytes (operand size)

    @property
    def a2a_wire(self) -> int:
        f = (self.n_devices - 1) / self.n_devices
        return int((self.ids_a2a + self.rows_a2a_fwd + self.rows_a2a_bwd) * f)

    @property
    def psum_wire(self) -> int:
        return int(self.dense_psum * 2 * (self.n_devices - 1) / self.n_devices)

    @property
    def total_wire(self) -> int:
        return self.a2a_wire + self.psum_wire

    @property
    def bytes_per_example(self) -> float:
        return self.total_wire / max(self.batch_per_device, 1)


def comm_volume(schema, batch_per_device: int, n_devices: int,
                capacity_factor: float = 2.0, dense_param_bytes: int = 0,
                row_dim: int = 11, exchange_bytes: int = 4) -> CommVolume:
    """Closed-form per-rank, per-step exchange volumes of the sharded step.
    ``exchange_bytes`` is the width of the row and gradient payload (4 for
    f32, 2 for ``train.exchange_dtype=bf16``)."""
    n = n_devices
    m = batch_per_device * schema.num_slots
    cap = exchange_capacity(m, n, capacity_factor) if schema.num_slots else 0
    return CommVolume(
        n_devices=n,
        batch_per_device=batch_per_device,
        capacity=cap,
        ids_a2a=n * cap * 4,
        rows_a2a_fwd=n * cap * row_dim * exchange_bytes,
        rows_a2a_bwd=n * cap * row_dim * exchange_bytes,
        dense_psum=dense_param_bytes,
    )


def dense_param_bytes(model: torch.nn.Module) -> int:
    """Byte size of the replicated dense parameters (all-reduced every
    step): every parameter but the table."""
    return sum(p.numel() * p.element_size()
               for name, p in model.named_parameters() if name != "table")
