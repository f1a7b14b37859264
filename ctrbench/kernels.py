"""The device time of the port's tower kernels in a rank's slice, found by
their names, for the per-layer readers.

The forward is ``tower_fwd_kernel``; the backward is
``tower_bwd_rows_kernel``, ``tower_x_copy_kernel``, ``tower_wgrad_kernel``
and ``tower_wgrad_reduce_kernel``. Both first launch ``tower_pack_kernel``
(the weights' images): its time is split by launches, one to each
forward, the rest to the backward."""

from __future__ import annotations

FWD = ("tower_fwd_kernel",)
BWD = ("tower_bwd_rows_kernel", "tower_x_copy_kernel", "tower_wgrad_kernel",
       "tower_wgrad_reduce_kernel")
PACK = "tower_pack_kernel"


def _sum(ops: dict, names) -> tuple[float, int]:
    seconds, launches = 0.0, 0
    for op, (s, n) in ops.items():
        if any(name in op for name in names):
            seconds, launches = seconds + s, launches + n
    return seconds, launches


def split(ops: dict) -> tuple[float, int, float] | None:
    """``(forward seconds, forward launches, backward seconds)``, or None
    where the slice holds no forward."""
    fwd_s, fwd_n = _sum(ops, FWD)
    bwd_s, _ = _sum(ops, BWD)
    pack_s, pack_n = _sum(ops, (PACK,))
    if fwd_n == 0:
        return None
    to_fwd = pack_s * min(fwd_n, pack_n) / pack_n if pack_n else 0.0
    return fwd_s + to_fwd, fwd_n, bwd_s + pack_s - to_fwd
