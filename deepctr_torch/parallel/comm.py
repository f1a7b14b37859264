"""Per-step communication volume of the sharded train step.

Port of ``exchange_capacity``, ``CommVolume``, ``comm_volume`` and
``dense_param_bytes`` from ``deepctr_tpu/parallel/comm.py``: the volumes
are closed-form in the step's shapes, and the sharded step
(``parallel/sharded.py``) takes its capacity from :func:`exchange_capacity`.
What holds the accounting to execution is a check, not the shared formula:
``parallel/sharded.py::record_collectives`` records every collective the
train and eval steps issue, and ``python -m
deepctr_torch.tools.scaling_report`` (with ``tests/test_torch_scaling_report.py``
on two gloo ranks, and ``chip_smoke.py`` on the card) requires its bytes
and calls to equal :func:`sent_volume`'s, exactly.

Exchange inventory of one sharded train step:

================  =========================  ==========================
collective        payload (per rank)         purpose
================  =========================  ==========================
all_to_all        [N, C] int64               id requests
all_to_all        [N, C, D] table or wire    gathered rows, owner->user
all_to_all        [N, C, D] f32 or bf16      occurrence grads, user->owner
all_reduce        dense params               tower grad sync
all_reduce        3 scalars                  weight sum, loss, drop counter
================  =========================  ==========================

with N = world size, C = exchange capacity, D = row width. Every slot
rides the exchange: the reference's split plan (small fields all-gathered
as replicated subtables) is a TPU gather mechanism that the port does not
have, so its small-field terms are absent here. An eval step sends the
first two all-to-alls and nothing else.

:func:`comm_volume` keeps the reference's accounting: ids at 4 bytes, the
rows at the wire's width both ways. :func:`sent_volume` counts what the
port's step sends: ids as int64 (its index type), the looked-up rows in the
narrower of the table's dtype and the wire's (a bf16 table on an f32 wire
sends bf16 rows), the gradients at the wire's width.

The scaling model (:func:`predict_scaling`, the reference's, in a GPU
form) combines these volumes with the links' times into a predicted step
and weak-scaling efficiency. Its intra-host terms are a :class:`LinkModel`:
a bandwidth and a latency for the all-to-all and for the ring all-reduce,
fitted by :func:`fit_links` to a sweep of the two collectives on the cards
(``python -m deepctr_torch.parallel.scaling``); a step sends
``A2A_PER_STEP`` all-to-alls and ``ALLREDUCE_PER_STEP`` all-reduces, and
each pays its latency once. The inter-host term keeps the reference's
per-host accounting (:func:`inter_host_bytes`); its bandwidth has no
default, since one box cannot measure a link between hosts.
``DEFAULT_LINKS`` holds the fit of a sweep on four NVIDIA H100 80GB HBM3 at
700.00 W, joined pairwise by NVLink (NCCL 2.28.9; PERF.md §5): its comment
gives the card, the topology and the values.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def exchange_capacity(m: int, n: int, capacity_factor: float) -> int:
    """Per-owner bucket capacity C for m local occurrences over n shards."""
    return max(1, min(max(m, 1), int(capacity_factor * _cdiv(max(m, 1), n))))


ID_BYTES = 8        # the port's index dtype, int64
DTYPE_BYTES = {"f32": 4, "bf16": 2}   # train.exchange_dtype and train.table_dtype
_DTYPE_NAMES = {"ids": {4: "int32", 8: "int64"}, "rows": {2: "bf16", 4: "f32"}}


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
    row_dim: int = 11       # D

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

    def _dtype(self, kind: str, payload: int, per_slot: int) -> str:
        slots = self.n_devices * self.capacity * per_slot
        width = payload // slots if slots else 0
        return _DTYPE_NAMES[kind].get(width, f"{width}-byte")

    def table(self) -> str:
        """A markdown table of the collectives, each labelled with the dtype
        its payload is sent in, payload and wire bytes a rank; the
        reference's ``CommVolume.table`` without the split plan's rows."""
        d = self.row_dim
        rows = [
            (f"id all_to_all [N,C] {self._dtype('ids', self.ids_a2a, 1)}",
             self.ids_a2a, "all_to_all"),
            (f"row all_to_all fwd [N,C,D] {self._dtype('rows', self.rows_a2a_fwd, d)}",
             self.rows_a2a_fwd, "all_to_all"),
            (f"grad all_to_all bwd [N,C,D] {self._dtype('rows', self.rows_a2a_bwd, d)}",
             self.rows_a2a_bwd, "all_to_all"),
            ("dense tower grad all_reduce f32 (operand)", self.dense_psum, "all_reduce"),
        ]
        out = ["| collective | payload bytes/rank | wire bytes/rank |", "|---|---|---|"]
        for name, b, collective in rows:
            out.append(f"| {name} | {b:,} | {int(wire_bytes(collective, b, self.n_devices)):,} |")
        out.append(f"| **total wire** |  | **{self.total_wire:,}** |")
        return "\n".join(out)


def comm_volume(schema, batch_per_device: int, n_devices: int,
                capacity_factor: float = 2.0, dense_param_bytes: int = 0,
                row_dim: int = 11, exchange_bytes: int = 4) -> CommVolume:
    """Closed-form per-rank, per-step exchange volumes of the sharded step,
    the reference's accounting: ids at 4 bytes, the rows at the wire's
    width both ways (:func:`sent_volume` counts what the port sends).
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
        row_dim=row_dim,
    )


def sent_volume(schema, batch_per_device: int, n_devices: int,
                capacity_factor: float = 2.0, dense_param_bytes: int = 0,
                row_dim: int = 11, exchange_bytes: int = 4,
                table_bytes: int = 4) -> CommVolume:
    """The bytes the port's sharded step sends a rank a step
    (``parallel/sharded.py``): :func:`comm_volume` with the ids as int64
    and the looked-up rows in the narrower of the table's dtype
    (``table_bytes``) and the wire's (``exchange_bytes``); the occurrence
    gradients at the wire's width and the dense gradients as one f32
    all-reduce of ``dense_param_bytes``, as there. The three scalar
    all-reduces (weight sum, loss, dropped count) are not counted, as the
    reference counts none. An eval step sends ``ids_a2a`` and
    ``rows_a2a_fwd`` only."""
    vol = comm_volume(schema, batch_per_device, n_devices, capacity_factor,
                      dense_param_bytes, row_dim, exchange_bytes)
    slots = n_devices * vol.capacity
    return dataclasses.replace(
        vol, ids_a2a=slots * ID_BYTES,
        rows_a2a_fwd=slots * row_dim * min(table_bytes, exchange_bytes))


def dense_param_bytes(model: torch.nn.Module) -> int:
    """Byte size of the replicated dense parameters (all-reduced every
    step): every parameter but the table."""
    return sum(p.numel() * p.element_size()
               for name, p in model.named_parameters() if name != "table")


# collectives a sharded train step issues (parallel/sharded.py): the id,
# row and gradient all-to-alls; the weight-sum, loss, dense-gradient and
# dropped-count all-reduces
A2A_PER_STEP = 3
ALLREDUCE_PER_STEP = 4


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Intra-host link terms of the sharded step's collectives: a call's
    time is ``latency + wire bytes / bandwidth``, with the wire bytes a rank
    moves as :class:`CommVolume` counts them (an all-to-all's payload times
    (N-1)/N, a ring all-reduce's operand times 2(N-1)/N)."""

    a2a_bytes_per_s: float
    a2a_latency_s: float
    allreduce_bytes_per_s: float
    allreduce_latency_s: float


# fitted to the sweep of `python -m deepctr_torch.parallel.scaling --device
# cuda --ranks 1,2,4` on four NVIDIA H100 80GB HBM3 at 700.00 W (nvidia-smi
# --query-gpu=name,power.limit), NVLink between every pair (nvidia-smi topo
# -p2p n; topo -m failed on that machine), NCCL 2.28.9, torch 2.11.0+cu128
# (PERF.md §5): 223 GB/s and 12.2 µs a call for the all-to-all, 261 GB/s and
# 12.7 µs for the ring all-reduce
DEFAULT_LINKS = LinkModel(
    a2a_bytes_per_s=223391597961.4667, a2a_latency_s=1.2231261984842842e-05,
    allreduce_bytes_per_s=260732360180.9317, allreduce_latency_s=1.2673683726299912e-05)


def wire_bytes(collective: str, payload: int, n: int) -> float:
    """Bytes a rank moves over the links for one call on ``payload`` bytes
    a rank in a world of ``n``: the all-to-all keeps 1/n of its payload
    local; the ring all-reduce moves 2(n-1)/n of its operand."""
    if collective == "all_to_all":
        return payload * (n - 1) / n
    if collective == "all_reduce":
        return payload * 2 * (n - 1) / n
    raise ValueError(f"collective {collective!r} (all_to_all|all_reduce)")


def _fit_line(wire: np.ndarray, seconds: np.ndarray) -> tuple[float, float]:
    """``(latency s, bandwidth bytes/s)`` of ``seconds = latency + wire /
    bandwidth`` by least squares on the relative error (each point weighs
    1/seconds, so that small payloads fix the latency and large ones the
    bandwidth); the latency is held at 0 where the free fit makes it
    negative."""
    a = np.stack([1.0 / seconds, wire / seconds], axis=1)
    (lat, inv_bw), *_ = np.linalg.lstsq(a, np.ones_like(seconds), rcond=None)
    if lat < 0.0:
        x = wire / seconds
        lat, inv_bw = 0.0, float(x.sum() / (x * x).sum())
    if inv_bw <= 0.0:
        raise ValueError("the sweep's times do not grow with the payload: no "
                         "bandwidth term to fit")
    return float(lat), float(1.0 / inv_bw)


def fit_links(records: Iterable[dict]) -> LinkModel:
    """A :class:`LinkModel` fitted to a collective sweep: records
    ``{"collective": "all_to_all" | "all_reduce", "ranks": N, "bytes":
    payload a rank, "ms": time of one call}`` (the sweep of
    ``parallel/scaling.py``). Points of one rank move nothing over a link
    and are left out. Each collective needs at least two payload sizes."""
    points = {"all_to_all": [], "all_reduce": []}
    for r in records:
        if r["ranks"] > 1:
            points[r["collective"]].append((
                r["bytes"], wire_bytes(r["collective"], r["bytes"], r["ranks"]),
                r["ms"] / 1e3))
    fitted = {}
    for collective, pts in points.items():
        if len({payload for payload, _, _ in pts}) < 2:
            raise ValueError(f"{collective}: {len(pts)} sweep points of more than one "
                             f"rank; the fit needs two payload sizes or more")
        _, wire, seconds = (np.array(v, np.float64) for v in zip(*pts))
        fitted[collective] = _fit_line(wire, seconds)
    (a2a_lat, a2a_bw), (ar_lat, ar_bw) = fitted["all_to_all"], fitted["all_reduce"]
    return LinkModel(a2a_bytes_per_s=a2a_bw, a2a_latency_s=a2a_lat,
                     allreduce_bytes_per_s=ar_bw, allreduce_latency_s=ar_lat)


def inter_host_bytes(vol: CommVolume, n_hosts: int, chips_per_host: int) -> int:
    """A host's bytes a step over the link between hosts, the reference's
    per-host accounting: the remote share of each of the host's devices'
    all-to-all payloads, and twice the all-reduced operand (reduced within
    the host first); 0 on one host."""
    n = vol.n_devices
    if n_hosts <= 1 or n <= chips_per_host:
        return 0
    remote_frac = (n - chips_per_host) / n
    a2a_payload = vol.ids_a2a + vol.rows_a2a_fwd + vol.rows_a2a_bwd
    return int(a2a_payload * remote_frac * chips_per_host + 2 * vol.dense_psum)


@dataclasses.dataclass(frozen=True)
class ScalingPoint:
    """Predicted weak-scaling step and efficiency at one topology point
    (the reference's, with its ICI and DCN terms as intra- and inter-host
    terms)."""

    n_devices: int
    n_hosts: int
    wire_bytes: int            # a rank's bytes a step over intra-host links
    inter_bytes_per_host: int  # a host's bytes a step over the inter-host link
    t_comp_ms: float
    t_intra_ms: float
    t_inter_ms: float
    efficiency_no_overlap: float   # t_comp / (t_comp + t_comm)
    efficiency_overlapped: float   # t_comp / max(t_comp, t_comm)

    @property
    def step_ms(self) -> float:
        """The predicted step with the exchange not overlapped."""
        return self.t_comp_ms + self.t_intra_ms + self.t_inter_ms


def predict_scaling(vol: CommVolume, t_comp_ms: float, n_hosts: int = 1,
                    chips_per_host: int | None = None, links: LinkModel | None = None,
                    inter_bytes_per_s_per_host: float | None = None) -> ScalingPoint:
    """Combine a step's volumes with link times into its predicted step and
    efficiency, as the reference's ``predict_scaling`` does.

    Weak scaling: ``t_comp_ms`` is the step measured on one device at the
    same per-device batch; the exchange adds its time on top. Intra-host:
    the all-to-alls' and the all-reduce's wire bytes over ``links``'
    bandwidths, and ``A2A_PER_STEP`` and ``ALLREDUCE_PER_STEP`` latencies
    where there is more than one device (``links`` defaults to
    ``DEFAULT_LINKS``). Inter-host, with ``n_hosts`` > 1: the reference's
    per-host bytes (an all-to-all's remote share of each of the host's
    devices' payloads, and twice the all-reduced operand, reduced within the
    host first) over ``inter_bytes_per_s_per_host``, which has no default.
    ``efficiency_no_overlap`` puts the exchange after the compute;
    ``efficiency_overlapped`` assumes it hides entirely."""
    links = links or DEFAULT_LINKS
    n = vol.n_devices
    chips_per_host = chips_per_host or _cdiv(n, n_hosts)
    t_intra = 0.0
    if n > 1:
        t_intra = (A2A_PER_STEP * links.a2a_latency_s
                   + vol.a2a_wire / links.a2a_bytes_per_s
                   + ALLREDUCE_PER_STEP * links.allreduce_latency_s
                   + vol.psum_wire / links.allreduce_bytes_per_s) * 1e3
    inter_bytes, t_inter = inter_host_bytes(vol, n_hosts, chips_per_host), 0.0
    if inter_bytes:
        if inter_bytes_per_s_per_host is None:
            raise ValueError("a prediction across hosts needs "
                             "inter_bytes_per_s_per_host: one box cannot measure it")
        t_inter = inter_bytes / inter_bytes_per_s_per_host * 1e3
    t_comm = t_intra + t_inter
    return ScalingPoint(
        n_devices=n, n_hosts=n_hosts, wire_bytes=vol.total_wire,
        inter_bytes_per_host=inter_bytes, t_comp_ms=t_comp_ms, t_intra_ms=t_intra,
        t_inter_ms=t_inter, efficiency_no_overlap=t_comp_ms / (t_comp_ms + t_comm),
        efficiency_overlapped=t_comp_ms / max(t_comp_ms, t_comm))
