"""``hstu_attn_fwd_roofline.train_seq``: the HSTU attention forward's least
time on the card (``arith.bound_s``: the larger of its causal FLOP on the
valid positions at the 3xTF32 peak and its least bytes, Q, K, V and U read,
the output, the timestamps and both bias tables, at the HBM rate;
``arith_hstu.py``, every block) over the program's device phase
``hstu_attn`` a step, which each block stamps around its attention.
Nothing where the program stamps no such phase."""

from ctrbench import arith, arith_hstu


def read(view):
    if view.peak is None:
        return None
    shares = []
    for r in view.readings:
        attn_s = r.get("phase_s", {}).get("hstu_attn")
        if attn_s and r["steps"] and r.get("tokens"):
            bound = arith.bound_s(arith_hstu.attn_fwd_flop(r["pairs"] / r["steps"], view.config),
                                  arith_hstu.attn_fwd_bytes(r["tokens"] / r["steps"],
                                                            view.config), view.peak)
            shares.append(bound / (attn_s / r["steps"]))
    return 100.0 * sum(shares) / len(shares) if shares else None
