"""``pool_roofline.train_multihot``: the multi-hot gather and pooling's
least time on the card (its bytes at the HBM rate: the ids and gathered
rows read, the pooled fields written; ``arith_dlrm.py``) over the program's
device phases ``lookup`` and ``pool`` a step. Nothing where the program
stamps no such phases."""

from ctrbench import arith, arith_dlrm


def read(view):
    if view.peak is None:
        return None
    b = int(view.config["batch"])
    bound = arith.bound_s(0, arith_dlrm.pool_bytes(b, view.config), view.peak)
    times = []
    for r in view.readings:
        phases = r.get("phase_s", {})
        if phases.get("lookup") and phases.get("pool") and r["steps"]:
            times.append((phases["lookup"] + phases["pool"]) / r["steps"])
    return 100.0 * bound / (sum(times) / len(times)) if times else None
