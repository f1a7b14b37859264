"""The comparison that decides ``correct``, frozen here.

Training cells compare five numbers:

- ``loss_gap``: the first step's loss, ``|program - reference| /
  |reference|``;
- ``late_loss_gap``: the same of the second and third steps' losses, the
  worse: the losses of the window's own call once the updates have moved
  the state;
- ``grad_gap``: the norm of each leaf's first gradient as the optimizer got
  it, ``|program - reference|`` over the larger of the reference's norm of
  that leaf and of the median leaf, the worst leaf;
- ``change_gap``: the norm of each leaf's change after the three steps, the
  same way, the median over the leaves whose reference gradient is at least
  a thousandth of the median leaf's (a leaf below that moves by round-off
  alone);
- ``table_change_gap``: the table leaf's change gap alone, which holds the
  sparse update (dense mode or sorted) to the reference directly.

The worst leaf's change is not steady from seed to seed: where a hot row's
occurrence gradients nearly cancel, Adagrad's first step (its accumulator
at 0, eps 1e-6) turns a 1e-7 difference between the program's products and
the reference's into a change of the row a thousand times larger. The later
losses carry some of it, so they have a limit of their own, wider than the
first step's. ``train_detail`` keeps every step and leaf, for the readings.

The scoring cell compares ``score_gap``: the largest ``|program -
reference|`` of a sampled request's click probabilities, and a request whose
answer has the wrong length or is not finite is wrong whatever it says.

A number passes when it is finite and at most its limit (``limits/<cell>.json``).
"""

from __future__ import annotations

import math
import statistics

TRAIN_NUMBERS = ("loss_gap", "late_loss_gap", "grad_gap", "change_gap", "table_change_gap")
SERVE_NUMBERS = ("score_gap",)


def _worst(values) -> float:
    """The largest of ``values``; infinite where one is not finite (``max``
    would pass a NaN over)."""
    values = list(values)
    return max(values) if all(math.isfinite(v) for v in values) else math.inf


def _gaps(prog: dict, ref: dict, leaves) -> list[float]:
    """Each leaf's ``|program - reference|`` over the larger of its reference
    norm and the median leaf's."""
    med = statistics.median(ref[leaf] for leaf in leaves)
    return [abs(prog[leaf] - ref[leaf]) / max(ref[leaf], med, 1e-30) for leaf in leaves]


def _loss_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a) else math.inf


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``{"losses", "grad_norms", "change_norms"}``."""
    losses = [_loss_gap(a, b) for a, b in zip(prog["losses"], ref["losses"], strict=True)]
    grads = ref["grad_norms"]
    med = statistics.median(grads.values())
    kept = [leaf for leaf, g in grads.items() if g >= 1e-3 * med]
    changes = _gaps(prog["change_norms"], ref["change_norms"], kept)
    every = list(ref["change_norms"])
    table = dict(zip(every, _gaps(prog["change_norms"], ref["change_norms"], every)))["table"]
    return {"loss_gap": losses[0],
            "late_loss_gap": _worst(losses[1:]),
            "grad_gap": _worst(_gaps(prog["grad_norms"], grads, list(grads))),
            "change_gap": (statistics.median(changes)
                           if all(math.isfinite(c) for c in changes) else math.inf),
            "table_change_gap": table if math.isfinite(table) else math.inf}


def train_detail(prog: dict, ref: dict) -> dict:
    """Each step's loss gap and each leaf's gradient and change gaps, for the
    readings that limits are set from (``calibrate.py``)."""
    grads, changes = ref["grad_norms"], ref["change_norms"]
    gmed, cmed = statistics.median(grads.values()), statistics.median(changes.values())
    return {"loss": [abs(a - b) / max(abs(b), 1e-30)
                     for a, b in zip(prog["losses"], ref["losses"])],
            "grad": {k: abs(prog["grad_norms"][k] - g) / max(g, gmed, 1e-30)
                     for k, g in grads.items()},
            "change": {k: abs(prog["change_norms"][k] - c) / max(c, cmed, 1e-30)
                       for k, c in changes.items()}}


def serve_number(prog: list, ref: list) -> float:
    """``prog`` and ``ref``: the sampled requests' probabilities, request by
    request (numpy arrays)."""
    worst = 0.0
    for p, r in zip(prog, ref, strict=True):
        if p is None or p.shape != r.shape:
            return math.inf
        gap = float(abs(p.astype("float64") - r).max()) if r.size else 0.0
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def verdict(numbers: dict, limits: dict) -> tuple[dict, bool]:
    """``({name: {"value", "limit"}}, correct)``."""
    checks = {name: {"value": value, "limit": limits[name]["limit"]}
              for name, value in numbers.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return checks, ok
