"""Common model pieces: the MLP spec, the tower's parameters, apply_model.

Port of ``deepctr_tpu/models/base.py`` for the serving path. The contract
is the JAX package's, in PyTorch form: a model holds the embedding
``table`` [V+1, D] and its dense head as parameters, and

    rows   = model.table[ids]                  # [B, S, D]
    logits = model.apply_rows(rows, mask)      # [B]

Parameters keep the JAX layout (``w`` is ``[in, out]``), and a module's
``state_dict`` keys mirror the JAX parameter pytree (``mlp.layers.0.w`` is
``dense["mlp"]["layers"][0]["w"]``), so ``utils/checkpoint.py`` converts one
into the other. Constructors give shapes only (zeros); weights come from a
checkpoint or from ``params_from_jax``. The port is forward-only for now:
dropout, initialisation and losses come with the training slice.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.kernels.mlp import ACTIVATIONS


@dataclasses.dataclass(frozen=True)
class MlpSpec:
    hidden: tuple[int, ...] = (300, 100)
    activation: str = "tanh"

    def __post_init__(self):
        if self.activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {self.activation!r}")


class Dense(nn.Module):
    """One tower layer: ``w`` [in, out] and ``b`` [out]."""

    def __init__(self, d_in: int, d_out: int, *, device: torch.device | str):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_in, d_out, device=device))
        self.b = nn.Parameter(torch.zeros(d_out, device=device))


class MlpTower(nn.Module):
    """Hidden stack + scalar-output layer, ``in_dim -> hidden... -> 1``."""

    def __init__(self, in_dim: int, spec: MlpSpec, *,
                 device: torch.device | str):
        super().__init__()
        self.spec = spec
        dims = (in_dim,) + tuple(spec.hidden) + (1,)
        self.layers = nn.ModuleList(
            Dense(dims[i], dims[i + 1], device=device)
            for i in range(len(dims) - 1)
        )

    def params(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        return [(layer.w, layer.b) for layer in self.layers]


def apply_model(model: nn.Module, ids: torch.Tensor, pad_id: int) -> torch.Tensor:
    """Full forward: gather + head. ``[B, S]`` ids -> ``[B]`` logits."""
    rows = model.table[ids]
    mask = (ids != pad_id).to(rows.dtype)
    return model.apply_rows(rows, mask)
