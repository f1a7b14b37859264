"""FM, the factorization machine with k latent factors.

Port of ``deepctr_tpu/models/fm.py``: ``logit = b + sum_s w_s m_s +
sum_{i<j} <v_i, v_j>`` over the active slots, with the table's row
``(w_i, v_i1..v_ik)`` (``[V+1, 1+k]``), the layout FNN's bottom layer takes,
so the FM -> FNN hand-off is a table copy. The logit part is the fused FM
scorer (``ops/kernels/interaction.py``): the CUDA kernel for CUDA tensors,
its plain version for CPU tensors. Its autograd Function records nothing
where gradients are off, so scoring and training share the one call. The
JAX model's ``use_pallas`` has no counterpart: the device decides.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels.interaction import fm_score
from .base import init_table


class FMModel(nn.Module):
    name = "fm"

    def __init__(self, vocab_rows: int, k: int = 10, init_sigma: float = 0.01, *,
                 device: torch.device | str):
        super().__init__()
        self.init_sigma = init_sigma
        self.table = nn.Parameter(torch.zeros(vocab_rows, 1 + k, device=device))
        self.bias = nn.Parameter(torch.zeros((), device=device))

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator, pad_id: int) -> None:
        """The reference's ``init_params``, in place: the table normal with
        ``init_sigma``, its linear column and its pad row zero; bias 0."""
        init_table(self.table, generator, self.init_sigma, pad_id, zero_linear=True)
        self.bias.zero_()

    def apply_rows(self, rows: torch.Tensor, mask: torch.Tensor, *,
                   train: bool = False, seed: int | None = None) -> torch.Tensor:
        """rows ``[B, S, 1+k]``, mask ``[B, S]`` -> logits ``[B]``."""
        del train, seed
        return fm_score(rows, mask) + self.bias

    forward = apply_rows


def make_fm(schema, k: int = 10, init_sigma: float = 0.01, *,
            device: torch.device | str) -> FMModel:
    return FMModel(schema.padded_vocab_size, k=k, init_sigma=init_sigma,
                   device=device)
