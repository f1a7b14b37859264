"""``train_mfu.train_cin``: xDeepFM's model FLOP of the slice's steps
(``6·B·(D·Σ H_k·H_{k-1}·m + Σ_DNN in·out + Σ H_k)``, ``arith_xdeepfm.py``)
over the slice's seconds, over the card's 3xTF32 peak."""

from ctrbench import arith_xdeepfm


def read(view):
    if view.peak is None:
        return None
    flop = arith_xdeepfm.train_flop(int(view.config["batch"]), view.config)
    shares = [r["steps"] * flop / r["window_s"] / view.peak["tf32x3_flops"]
              for r in view.readings if r["window_s"] > 0 and r["steps"]]
    return 100.0 * min(shares) if shares else None
