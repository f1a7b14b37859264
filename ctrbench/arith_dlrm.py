"""FLOP and byte arithmetic of DLRM-DCNv2's train step, frozen here. It
counts the work the model needs, whatever implements it; the peaks are
``arith.py``'s.

Model FLOP of one train step of B examples: ``6·B·Σ in·out`` over the
bottom MLP's layers, each cross layer's two factors (``V``: width → rank,
``W``: rank → width) and the top MLP's layers: the forward's products
(2), and the backward's input and weight gradients (4). The element-wise
work (the cross layers' products with ``x0``, the activations, the pooling's
sums) is not counted.

Bytes count each input read once and each output written once:

- the cross layers' forward: ``x0`` read, the last layer's output written,
  every cross parameter read;
- the gather and pooling: the ids, the gathered rows, and the pooled
  ``[B, F, D]`` written;
- the dense-mode sparse update (the touched rows' model, ROOFLINE_TORCH.md):
  the M ids and ``[M, D]`` gradient rows read once, each distinct row's
  accumulator and table row read and written once.
"""

from __future__ import annotations


def dims(config: dict) -> tuple[list[int], int, int, int, list[int]]:
    """``(bottom widths, cross width, rank, cross layers, top widths)``."""
    d = int(config["embedding_dim"])
    bottom = [int(config["num_dense"])] + [int(x) for x in config["dense_arch_layer_sizes"]]
    width = bottom[-1] + len(config["num_embeddings_per_feature"]) * d
    top = [width] + [int(x) for x in config["over_arch_layer_sizes"]]
    return bottom, width, int(config["dcn_low_rank_dim"]), int(config["dcn_num_layers"]), top


def _macs(dims) -> int:
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def cross_macs(config: dict) -> int:
    """One example's multiply-adds in the cross layers."""
    _, width, rank, layers, _ = dims(config)
    return layers * 2 * width * rank


def macs(config: dict) -> int:
    """One example's multiply-adds in every product of the forward."""
    bottom, _, _, _, top = dims(config)
    return _macs(bottom) + cross_macs(config) + _macs(top)


def train_flop(batch: int, config: dict) -> int:
    return 6 * batch * macs(config)


def cross_fwd_flop(batch: int, config: dict) -> int:
    return 2 * batch * cross_macs(config)


def cross_fwd_bytes(batch: int, config: dict) -> int:
    """f32: ``x0`` in and the last cross layer's output out, and every
    cross layer's ``V``, ``W`` and ``b``."""
    _, width, rank, layers, _ = dims(config)
    return 4 * (2 * batch * width + layers * (2 * width * rank + width))


def occurrences(batch: int, config: dict) -> int:
    """Ids gathered a step: every slot of every example."""
    return batch * sum(int(h) for h in config["multi_hot_sizes"])


def pool_bytes(batch: int, config: dict) -> int:
    """int64 ids and f32 rows read, f32 ``[B, F, D]`` written."""
    d, f = int(config["embedding_dim"]), len(config["num_embeddings_per_feature"])
    m = occurrences(batch, config)
    return 8 * m + 4 * m * d + 4 * batch * f * d


def sparse_bytes(occurrences_: int, distinct: float, config: dict) -> float:
    """The dense-mode update of ``occurrences_`` ids touching ``distinct``
    rows of an f32 table and its f32 accumulator."""
    d = int(config["embedding_dim"])
    return 8 * occurrences_ + 4 * occurrences_ * d + distinct * d * 2 * (4 + 4)
