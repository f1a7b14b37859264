"""FM second-order interaction (the sum-of-squares identity), plain PyTorch.

Port of ``deepctr_tpu/ops/interaction.py``: the pairwise term
``sum_{i<j} <v_i, v_j>`` over an example's active slots, computed as

    1/2 * sum_f [ (sum_i v_if)^2 - sum_i v_if^2 ]

in O(S k) instead of the O(S^2 k) double sum, which
:func:`fm_interaction_bruteforce` keeps for the tests. The fused kernel that
adds the linear term is ``ops/kernels/interaction.py``.
"""

from __future__ import annotations

import torch


def fm_interaction(v_rows: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Second-order FM term per example: ``v_rows`` f32 ``[B, S, k]``
    (gathered factor rows), optional ``mask`` f32 ``[B, S]`` multiplied in
    -> f32 ``[B]``."""
    if mask is not None:
        v_rows = v_rows * mask[..., None]
    s = v_rows.sum(dim=1)                 # [B, k]
    sq = v_rows.square().sum(dim=1)       # [B, k]
    return 0.5 * (s.square() - sq).sum(dim=1)


def fm_interaction_bruteforce(v_rows: torch.Tensor,
                              mask: torch.Tensor | None = None) -> torch.Tensor:
    """The O(S^2 k) form: the upper triangle of each example's Gram matrix."""
    if mask is not None:
        v_rows = v_rows * mask[..., None]
    gram = torch.einsum("bik,bjk->bij", v_rows, v_rows)   # [B, S, S]
    upper = torch.triu(torch.ones(gram.shape[-2:], dtype=gram.dtype,
                                  device=gram.device), diagonal=1)
    return (gram * upper).sum(dim=(1, 2))
