"""FLOP and byte arithmetic of HSTU's train step, frozen here. It counts the
work the model needs on the valid positions of a step's histories, whatever
implements it (padded operations today, a jagged kernel later); the peaks
are ``arith.py``'s.

With ``T`` a step's valid positions, ``P = Σ_b len_b·(len_b + 1)/2`` its
causal pairs (a query and each key at or before it) and ``S = Σ_b (len_b -
1)`` its supervised positions, the forward's FLOP:

- the projections, a block: ``2·T·D·2H(d_v + d_qk)`` (U, V, Q, K) and
  ``2·T·H·d_v·D`` (the output's);
- the attention, a block: ``2·P·H·(d_qk + d_v)`` (``Q·K^T`` and ``A·V`` on
  the causal pairs alone);
- the loss: ``2·S·(1 + negatives)·D`` (the cosines).

A train step is 3 times the forward (the backward's input and weight
gradients). Layer norms, activations, the bias, the gathers and the
optimizer are element-wise and not counted.

The attention's least bytes, a block, float32: forward, ``Q``, ``K``, ``V``
and ``U`` read (``4·T·2H(d_qk + d_v)``), its output written (``4·T·H·d_v``),
the timestamps read (``8·T``) and both bias tables read; backward, the same
inputs read and their gradients written, the output's gradient read, the
timestamps read, the tables read and their gradients written.
"""

from __future__ import annotations

import torch


def dims(config: dict) -> tuple[int, int, int, int, int, int]:
    """``(D, blocks, heads, d_qk, d_v, negatives)``."""
    return (int(config["item_embedding_dim"]), int(config["num_blocks"]),
            int(config["num_heads"]), int(config["dqk"]), int(config["dv"]),
            int(config["num_negatives"]))


def work(lengths: torch.Tensor) -> tuple[int, int, int]:
    """``(T, P, S)`` of a step whose histories have ``lengths``."""
    lengths = lengths.long()
    return (int(lengths.sum()), int((lengths * (lengths + 1) // 2).sum()),
            int((lengths - 1).clamp(min=0).sum()))


def proj_flop(tokens: float, config: dict) -> float:
    d, blocks, h, dqk, dv, _ = dims(config)
    return blocks * 2.0 * tokens * (d * 2 * h * (dv + dqk) + h * dv * d)


def attn_fwd_flop(pairs: float, config: dict) -> float:
    _, blocks, h, dqk, dv, _ = dims(config)
    return blocks * 2.0 * pairs * h * (dqk + dv)


def attn_bwd_flop(pairs: float, config: dict) -> float:
    """Four products a block (the gradients of ``A`` and ``V``, then of
    ``Q`` and ``K``), twice the forward's."""
    return 2.0 * attn_fwd_flop(pairs, config)


def loss_flop(supervised: float, config: dict) -> float:
    d, _, _, _, _, neg = dims(config)
    return 2.0 * supervised * (1 + neg) * d


def train_flop(tokens: float, pairs: float, supervised: float, config: dict) -> float:
    return 3.0 * (proj_flop(tokens, config) + attn_fwd_flop(pairs, config)
                  + loss_flop(supervised, config))


def _tables(config: dict) -> int:
    return 4 * (2 * int(config["max_sequence_length"]) - 1 + int(config["time_buckets"]) + 1)


def attn_fwd_bytes(tokens: float, config: dict) -> float:
    _, blocks, h, dqk, dv, _ = dims(config)
    per = 4.0 * tokens * (2 * h * (dqk + dv) + h * dv) + 8.0 * tokens + _tables(config)
    return blocks * per


def attn_bwd_bytes(tokens: float, config: dict) -> float:
    _, blocks, h, dqk, dv, _ = dims(config)
    per = 4.0 * tokens * (2 * 2 * h * (dqk + dv) + h * dv) + 8.0 * tokens \
        + 2 * _tables(config)
    return blocks * per
