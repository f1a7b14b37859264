"""``cross_fwd_roofline.train_multihot``: the cross layers' forward's least
time on the card (its FLOP at the 3xTF32 peak, or its bytes at the HBM
rate, the larger; ``arith_dlrm.py``) over the program's device phase
``cross`` a step (the stamps of the slice's replays, ``utils/prof.py``).
Nothing where the program stamps no such phase."""

from ctrbench import arith, arith_dlrm


def read(view):
    if view.peak is None:
        return None
    b = int(view.config["batch"])
    bound = arith.bound_s(arith_dlrm.cross_fwd_flop(b, view.config),
                          arith_dlrm.cross_fwd_bytes(b, view.config), view.peak)
    times = [r["phase_s"]["cross"] / r["steps"] for r in view.readings
             if r.get("phase_s", {}).get("cross") and r["steps"]]
    return 100.0 * bound / (sum(times) / len(times)) if times else None
