"""``train_mfu.train_seq``: HSTU's model FLOP on the valid positions of the
slice's steps (projections, causal attention and the sampled softmax's
cosines, three times the forward; ``arith_hstu.py``, on the ``tokens``,
``pairs`` and ``supervised`` positions the runner counts from the pool) over
the slice's seconds, over the card's 3xTF32 peak. The padded positions'
work is not model work: padding shows as lost utilisation."""

from ctrbench import arith_hstu


def read(view):
    if view.peak is None:
        return None
    shares = [arith_hstu.train_flop(r["tokens"], r["pairs"], r["supervised"], view.config)
              / r["window_s"] / view.peak["tf32x3_flops"]
              for r in view.readings if r["window_s"] > 0 and r.get("tokens")]
    return 100.0 * min(shares) if shares else None
