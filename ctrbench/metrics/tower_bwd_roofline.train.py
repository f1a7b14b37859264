"""``tower_bwd_roofline.train``: the tower backward's least time on the card
(``4·B·Σ in·out`` at the 3xTF32 peak, or its bytes at the HBM rate, the
larger) over the device time of the backward's kernels per step, averaged
over the ranks."""

from ctrbench import arith
from ctrbench.kernels import split
from ctrbench.weights import tower_dims


def read(view):
    if view.peak is None:
        return None
    dims, b = tower_dims(view.config), int(view.config["batch"])
    bound = arith.bound_s(arith.tower_bwd_flop(b, dims), arith.tower_bwd_bytes(b, dims),
                          view.peak)
    times = []
    for r in view.readings:
        parts = split(r["ops"])
        if parts is not None and parts[2] > 0 and r["steps"]:
            times.append(parts[2] / r["steps"])
    return 100.0 * bound / (sum(times) / len(times)) if times else None
