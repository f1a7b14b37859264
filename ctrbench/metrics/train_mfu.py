"""``train_mfu``: the tower's model FLOP of the slice's steps (forward
``2·B·Σ in·out``, backward ``4·B·Σ in·out``, ``arith.py``) over the slice's
seconds, over the card's 3xTF32 peak; on several ranks each rank's share of
the work over its own peak, the slowest rank."""

from ctrbench import arith
from ctrbench.weights import tower_dims


def read(view):
    if view.peak is None:
        return None
    dims, b = tower_dims(view.config), int(view.config["batch"])
    flop = arith.tower_fwd_flop(b, dims) + arith.tower_bwd_flop(b, dims)
    shares = [r["steps"] * flop / r["window_s"] / view.peak["tf32x3_flops"]
              for r in view.readings if r["window_s"] > 0 and r["steps"]]
    return 100.0 * min(shares) if shares else None
