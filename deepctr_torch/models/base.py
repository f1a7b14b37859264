"""Common model pieces: the MLP spec, the tower's parameters and their
initialisation, apply_model, the loss and the lazy L2.

Port of ``deepctr_tpu/models/base.py``. The contract
is the JAX package's, in PyTorch form: a model holds the embedding
``table`` [V+1, D] and its dense head as parameters, and

    rows   = model.table[ids]                  # [B, S, D]
    logits = model.apply_rows(rows, mask)      # [B]

Parameters keep the JAX layout (``w`` is ``[in, out]``), and a module's
``state_dict`` keys mirror the JAX parameter pytree (``mlp.layers.0.w`` is
``dense["mlp"]["layers"][0]["w"]``), so ``utils/checkpoint.py`` converts one
into the other. Constructors give shapes only (zeros); weights come from
:func:`init_mlp` and a model's ``init_parameters`` (each with an explicit
``torch.Generator``), a checkpoint, or ``params_from_jax``. The JAX PRNG is
never reproduced: parity tests load JAX's initial values instead.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..ops.kernels.mlp import ACTIVATIONS, mlp_tower, mlp_tower_fwd


@dataclasses.dataclass(frozen=True)
class MlpSpec:
    hidden: tuple[int, ...] = (300, 100)
    activation: str = "tanh"
    dropout: float = 0.0

    def __post_init__(self):
        if self.activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {self.activation!r}")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout {self.dropout} outside [0, 1)")


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

    def forward(self, x: torch.Tensor, *, train: bool = False,
                seed: int | torch.Tensor | None = None) -> torch.Tensor:
        """``[B, in]`` -> logits ``[B]`` through the tower kernels.

        With ``train`` and a spec with dropout, the tower drops with the
        counter-hash mask of ``seed`` (an int below 2^24, or a 0-d int32
        tensor on the device that holds one). Where autograd
        may need the tower's gradients, the tower is the differentiable
        :func:`mlp_tower`; otherwise the forward kernel alone.
        """
        drop = self.spec.dropout if train else 0.0
        if drop > 0.0 and seed is None:
            raise ValueError("dropout requires a seed in train mode")
        if torch.is_grad_enabled() or drop > 0.0:
            return mlp_tower(x, self.params(), self.spec.activation, drop,
                             0 if seed is None else seed)
        return mlp_tower_fwd(x, self.params(), self.spec.activation)


def slot_onehot(slot_field, num_fields: int, *,
                device: torch.device | str) -> torch.Tensor:
    """The static one-hot slot -> field map ``[S, F]``."""
    onehot = torch.zeros(len(slot_field), num_fields, device=device)
    onehot[torch.arange(len(slot_field)), torch.as_tensor(slot_field)] = 1.0
    return onehot


def pool_fields(rows: torch.Tensor, mask: torch.Tensor,
                onehot: torch.Tensor) -> torch.Tensor:
    """Each field's slots masked and sum-pooled: rows ``[B, S, D]``, mask
    ``[B, S]`` -> ``[B, F, D]`` (``einsum("bsd,sf->bfd")``, as the JAX
    models pool)."""
    return torch.einsum("bsd,sf->bfd", rows * mask[..., None], onehot)


@torch.no_grad()
def init_table(table: torch.Tensor, generator: torch.Generator, sigma: float,
               pad_id: int, zero_linear: bool = False) -> None:
    """A ``(w | v)`` table normal with ``sigma``, in place, its pad row zero
    and, with ``zero_linear``, its column 0 (FM's linear weights) zero."""
    draw = torch.randn(table.shape, generator=generator, device=generator.device,
                       dtype=torch.float32)
    draw[pad_id] = 0.0
    if zero_linear:
        draw[:, 0] = 0.0
    table.copy_(sigma * draw)


@torch.no_grad()
def init_mlp(tower: MlpTower, generator: torch.Generator) -> None:
    """Glorot-uniform weights and zero biases, in place (the reference's
    ``init_mlp``); every draw comes from ``generator``."""
    for layer in tower.layers:
        fan_in, fan_out = layer.w.shape
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        draw = torch.rand(layer.w.shape, generator=generator,
                          device=generator.device, dtype=torch.float32)
        layer.w.copy_(draw * (2 * limit) - limit)
        layer.b.zero_()


def apply_model(model: nn.Module, ids: torch.Tensor, pad_id: int) -> torch.Tensor:
    """Full forward: gather + head. ``[B, S]`` ids -> ``[B]`` logits. Rows
    of a bf16 table are widened to f32 after the gather."""
    rows = model.table[ids].float()
    mask = (ids != pad_id).to(rows.dtype)
    return model.apply_rows(rows, mask)


def weighted_bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                             weights: torch.Tensor,
                             weight_sum: torch.Tensor | None = None) -> torch.Tensor:
    """Mean binary cross-entropy over weighted examples (pad rows weight 0).
    ``weight_sum`` replaces ``weights.sum()`` as the divisor: a sharded
    step's share of the global mean divides by the global sum."""
    per = -(labels * nn.functional.logsigmoid(logits)
            + (1.0 - labels) * nn.functional.logsigmoid(-logits))
    if weight_sum is None:
        weight_sum = weights.sum()
    return (per * weights).sum() / torch.clamp(weight_sum, min=1.0)


def lazy_l2(rows: torch.Tensor, mask: torch.Tensor, coeff: float,
            batch: int | None = None) -> torch.Tensor:
    """L2 on the rows this batch touches only (the sparse analogue of weight
    decay, applied where gradients flow), divided by the batch's rows, or
    by ``batch`` (a sharded step's global batch)."""
    if coeff == 0.0:
        return rows.new_zeros(())
    return coeff * (rows.square() * mask[..., None]).sum() / (batch or rows.shape[0])
