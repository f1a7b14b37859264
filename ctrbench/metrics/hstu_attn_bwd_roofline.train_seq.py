"""``hstu_attn_bwd_roofline.train_seq``: the HSTU attention backward's least
time on the card (``arith.bound_s``: the larger of twice the forward's
causal FLOP on the valid positions at the 3xTF32 peak and its least bytes,
the forward's inputs read and their gradients written, the output's
gradient, the timestamps and the bias tables and their gradients, at the
HBM rate; ``arith_hstu.py``, every block) over the program's device phase
``hstu_attn_bwd`` a step, which each block's backward stamps around its
attention's. Nothing where the program stamps no such phase."""

from ctrbench import arith, arith_hstu


def read(view):
    if view.peak is None:
        return None
    shares = []
    for r in view.readings:
        attn_s = r.get("phase_s", {}).get("hstu_attn_bwd")
        if attn_s and r["steps"] and r.get("tokens"):
            bound = arith.bound_s(arith_hstu.attn_bwd_flop(r["pairs"] / r["steps"], view.config),
                                  arith_hstu.attn_bwd_bytes(r["tokens"] / r["steps"],
                                                            view.config), view.peak)
            shares.append(bound / (attn_s / r["steps"]))
    return 100.0 * sum(shares) / len(shares) if shares else None
