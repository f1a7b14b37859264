"""``cin_bwd_roofline.train_cin``: the CIN backward's model FLOP (each
layer's weight gradient and its outer product's gradient, ``4·B·D·Σ
H_k·H_{k-1}·m``, ``arith_xdeepfm.py``) at the card's 3xTF32 peak over the
program's device phase ``cin_bwd`` a step, which the CIN's backward alone
stamps. Nothing where the program stamps no such phase."""

from ctrbench import arith_xdeepfm


def read(view):
    if view.peak is None:
        return None
    bound = arith_xdeepfm.cin_bwd_flop(int(view.config["batch"]), view.config) \
        / view.peak["tf32x3_flops"]
    times = [r["phase_s"]["cin_bwd"] / r["steps"] for r in view.readings
             if r.get("phase_s", {}).get("cin_bwd") and r["steps"]]
    return 100.0 * bound / (sum(times) / len(times)) if times else None
