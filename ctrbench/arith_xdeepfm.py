"""FLOP and byte arithmetic of xDeepFM's train step, frozen here. It counts
the work the model needs, whatever implements it; the peaks are
``arith.py``'s.

One example's multiply-adds in the forward's products:

- the CIN (arXiv:1803.05170, Eq. 6): layer k forms ``H_k`` maps of ``D``
  values, each a sum over ``H_{k-1}·m`` products, so ``D·H_k·H_{k-1}·m``,
  with ``H_0 = m``;
- the DNN: ``Σ in·out`` over its layers, ``m·D`` -> hidden... -> 1;
- the CIN's output weights ``w_cin``: ``Σ_k H_k``.

A train step of B examples is ``6·B`` times that: the forward's products
(2) and the backward's input and weight gradients (4). The CIN's outer
products and reductions, the sum pooling, the activations, the linear term
and the optimizers are element-wise and not counted in the FLOP; the
sparse update's bytes are (:func:`sparse_bytes`).
"""

from __future__ import annotations


def dims(config: dict) -> tuple[int, int, list[int], list[int]]:
    """``(m fields, D, CIN maps a layer, DNN widths with its input and its
    one output)``."""
    m, d = len(config["fields"]), int(config["k"])
    dnn = [m * d] + [int(x) for x in config["dnn_hidden"]] + [1]
    return m, d, [int(h) for h in config["cin_layer_sizes"]], dnn


def cin_macs(config: dict) -> int:
    """One example's multiply-adds in the CIN's products."""
    m, d, maps, _ = dims(config)
    widths = [m] + maps
    return sum(d * h * h_in * m for h_in, h in zip(widths[:-1], widths[1:]))


def macs(config: dict) -> int:
    """One example's multiply-adds in every product of the forward."""
    _, _, maps, dnn = dims(config)
    return cin_macs(config) + sum(a * b for a, b in zip(dnn[:-1], dnn[1:])) + sum(maps)


def train_flop(batch: int, config: dict) -> int:
    return 6 * batch * macs(config)


def cin_fwd_flop(batch: int, config: dict) -> int:
    return 2 * batch * cin_macs(config)


def cin_bwd_flop(batch: int, config: dict) -> int:
    """The CIN's backward: each layer's weight gradient and its outer
    product's gradient, each as many FLOP as the layer's forward."""
    return 4 * batch * cin_macs(config)


def occurrences(batch: int, config: dict) -> int:
    """Ids gathered a step: every slot of every example."""
    return batch * sum(int(slots) for _, _, slots in config["fields"])


def sparse_bytes(occurrences_: int, distinct: float, config: dict) -> float:
    """The dense-mode update of ``occurrences_`` ids touching ``distinct``
    rows of the f32 ``[V+1, 1+k]`` table and its f32 accumulator: int64 ids
    and f32 gradient rows read once, each distinct row's accumulator and
    table row read and written once."""
    d = 1 + int(config["k"])
    return 8 * occurrences_ + 4 * occurrences_ * d + distinct * d * 2 * (4 + 4)
