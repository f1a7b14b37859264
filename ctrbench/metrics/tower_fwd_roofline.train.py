"""``tower_fwd_roofline.train``: the tower forward's least time on the card
(its FLOP at the 3xTF32 peak, or its bytes at the HBM rate, the larger)
over its device time per launch, averaged over the ranks."""

from ctrbench import arith
from ctrbench.kernels import split
from ctrbench.weights import tower_dims


def read(view):
    if view.peak is None:
        return None
    dims, b = tower_dims(view.config), int(view.config["batch"])
    bound = arith.bound_s(arith.tower_fwd_flop(b, dims), arith.tower_fwd_bytes(b, dims),
                          view.peak)
    times = []
    for r in view.readings:
        parts = split(r["ops"])
        if parts is not None:
            times.append(parts[0] / parts[1])
    return 100.0 * bound / (sum(times) / len(times)) if times else None
