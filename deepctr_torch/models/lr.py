"""LR, sparse logistic regression.

Port of ``deepctr_tpu/models/lr.py``: ``logit = sum_s w_s m_s + b`` with the
weight vector as a ``[V+1, 1]`` table, so the shared gather and sparse
update apply unchanged. The reference's ``init_scale`` is 0: the table
starts at zero.
"""

from __future__ import annotations

import torch
from torch import nn


class LRModel(nn.Module):
    name = "lr"

    def __init__(self, vocab_rows: int, *, device: torch.device | str):
        super().__init__()
        self.table = nn.Parameter(torch.zeros(vocab_rows, 1, device=device))
        self.bias = nn.Parameter(torch.zeros((), device=device))

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator, pad_id: int) -> None:
        """Zeros, as the reference's ``init_params`` with ``init_scale`` 0."""
        del generator, pad_id
        self.table.zero_()
        self.bias.zero_()

    def apply_rows(self, rows: torch.Tensor, mask: torch.Tensor, *,
                   train: bool = False, seed: int | None = None) -> torch.Tensor:
        """rows ``[B, S, 1]``, mask ``[B, S]`` -> logits ``[B]``."""
        del train, seed
        return (rows[..., 0] * mask).sum(dim=1) + self.bias

    forward = apply_rows


def make_lr(schema, *, device: torch.device | str) -> LRModel:
    return LRModel(schema.padded_vocab_size, device=device)
