"""``cin_fwd_roofline.train_cin``: the CIN forward's model FLOP
(``2·B·D·Σ H_k·H_{k-1}·m``, ``arith_xdeepfm.py``) at the card's 3xTF32 peak
over the program's device phase ``cin`` a step (the stamps of the slice's
replays, ``utils/prof.py``). Nothing where the program stamps no such
phase."""

from ctrbench import arith_xdeepfm


def read(view):
    if view.peak is None:
        return None
    bound = arith_xdeepfm.cin_fwd_flop(int(view.config["batch"]), view.config) \
        / view.peak["tf32x3_flops"]
    times = [r["phase_s"]["cin"] / r["steps"] for r in view.readings
             if r.get("phase_s", {}).get("cin") and r["steps"]]
    return 100.0 * bound / (sum(times) / len(times)) if times else None
