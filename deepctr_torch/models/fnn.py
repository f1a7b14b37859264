"""FNN, the flagship model.

Port of ``deepctr_tpu/models/fnn.py``. Each field's slots are masked and
sum-pooled to one (1+k)-vector (``einsum("bsd,sf->bfd")`` with a static
one-hot slot->field map, as in the JAX model), the field vectors are
concatenated to ``[B, F*(1+k)]``, and the tower maps that to one logit.
The tower is ``ops/kernels/mlp.py``: the fused CUDA kernels for CUDA
tensors, their plain versions for CPU tensors. The JAX model's
``use_pallas`` switch has no counterpart: the device decides. So the port
has one dropout, the reference kernel's counter hash, seeded per step
(``train=True, seed=...``); the reference's non-kernel
``jax.random.bernoulli`` dropout cannot be reproduced in torch. The pooling
and the gather stay plain PyTorch, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels.mlp import mlp_tower, mlp_tower_fwd
from ..shared import Schema
from .base import MlpSpec, MlpTower, init_mlp

_DEFAULT_MLP = MlpSpec(hidden=(200, 300, 100), activation="tanh", dropout=0.5)


class FNNModel(nn.Module):
    """Construct via :func:`make_fnn`, which binds the schema's slot map."""

    def __init__(self, slot_field: tuple[int, ...], num_fields: int,
                 vocab_rows: int, k: int = 10, mlp: MlpSpec = _DEFAULT_MLP,
                 init_sigma: float = 0.01, *, device: torch.device | str):
        super().__init__()
        self.init_sigma = init_sigma
        self.table = nn.Parameter(torch.zeros(vocab_rows, 1 + k, device=device))
        onehot = torch.zeros(len(slot_field), num_fields, device=device)
        onehot[torch.arange(len(slot_field)), torch.as_tensor(slot_field)] = 1.0
        self.register_buffer("slot_onehot", onehot, persistent=False)
        self.mlp = MlpTower(num_fields * (1 + k), mlp, device=device)

    def tower_input(self, rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """rows ``[B, S, 1+k]``, mask ``[B, S]`` -> pooled ``[B, F*(1+k)]``."""
        x = rows * mask[..., None]
        pooled = torch.einsum("bsd,sf->bfd", x, self.slot_onehot)  # [B, F, 1+k]
        return pooled.reshape(pooled.shape[0], -1).contiguous()

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator, pad_id: int) -> None:
        """The reference's ``init_params``, in place: the table normal with
        ``init_sigma`` and its pad row zero, the tower Glorot-uniform."""
        table = torch.randn(self.table.shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
        table[pad_id] = 0.0
        self.table.copy_(self.init_sigma * table)
        init_mlp(self.mlp, generator)

    def apply_rows(self, rows: torch.Tensor, mask: torch.Tensor, *,
                   train: bool = False, seed: int | None = None) -> torch.Tensor:
        """rows ``[B, S, 1+k]``, mask ``[B, S]`` -> logits ``[B]``.

        With ``train`` and a spec with dropout, the tower drops with the
        counter-hash mask of ``seed`` (an int below 2^24). Where autograd
        may need the tower's gradients, the tower is the differentiable
        :func:`mlp_tower`; otherwise the forward kernel alone.
        """
        x = self.tower_input(rows, mask)
        spec = self.mlp.spec
        drop = spec.dropout if train else 0.0
        if drop > 0.0 and seed is None:
            raise ValueError("dropout requires a seed in train mode")
        if torch.is_grad_enabled() or drop > 0.0:
            return mlp_tower(x, self.mlp.params(), spec.activation, drop,
                             seed or 0)
        return mlp_tower_fwd(x, self.mlp.params(), spec.activation)

    forward = apply_rows


def make_fnn(schema: Schema, k: int = 10, mlp: MlpSpec | None = None,
             init_sigma: float = 0.01, *,
             device: torch.device | str) -> FNNModel:
    return FNNModel(
        slot_field=tuple(int(f) for f in schema.slot_field),
        num_fields=schema.num_fields,
        vocab_rows=schema.padded_vocab_size,
        k=k,
        mlp=mlp or _DEFAULT_MLP,
        init_sigma=init_sigma,
        device=device,
    )
