"""``train_mfu.train_multihot``: DLRM-DCNv2's model FLOP of the slice's
steps (``6·B·Σ in·out`` over the bottom MLP, the cross layers' factors and
the top MLP, ``arith_dlrm.py``) over the slice's seconds, over the card's
3xTF32 peak."""

from ctrbench import arith_dlrm


def read(view):
    if view.peak is None:
        return None
    flop = arith_dlrm.train_flop(int(view.config["batch"]), view.config)
    shares = [r["steps"] * flop / r["window_s"] / view.peak["tf32x3_flops"]
              for r in view.readings if r["window_s"] > 0 and r["steps"]]
    return 100.0 * min(shares) if shares else None
