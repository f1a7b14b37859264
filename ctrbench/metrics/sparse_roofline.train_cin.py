"""``sparse_roofline.train_cin``: xDeepFM's dense-mode sparse update's least
time on the card (the touched rows' bytes at the HBM rate: ids and gradient
rows read once, each distinct row's accumulator and table row read and
written once, with the distinct rows of the slice's own steps;
``arith_xdeepfm.py``) over the program's device phase ``sparse`` a step.
Nothing where the program stamps no such phase."""

from ctrbench import arith, arith_xdeepfm


def read(view):
    if view.peak is None:
        return None
    m = arith_xdeepfm.occurrences(int(view.config["batch"]), view.config)
    shares = []
    for r in view.readings:
        sparse_s = r.get("phase_s", {}).get("sparse")
        if sparse_s and r["steps"] and r.get("distinct_rows"):
            nbytes = arith_xdeepfm.sparse_bytes(m, r["distinct_rows"] / r["steps"],
                                                view.config)
            shares.append(arith.bound_s(0, nbytes, view.peak) / (sparse_s / r["steps"]))
    return 100.0 * sum(shares) / len(shares) if shares else None
