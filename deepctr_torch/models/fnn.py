"""FNN, the flagship model, forward only.

Port of ``deepctr_tpu/models/fnn.py``. Each field's slots are masked and
sum-pooled to one (1+k)-vector (``einsum("bsd,sf->bfd")`` with a static
one-hot slot->field map, as in the JAX model), the field vectors are
concatenated to ``[B, F*(1+k)]``, and the tower maps that to one logit.
The tower is ``ops/kernels/mlp.py::mlp_tower_fwd``: the fused CUDA kernel
for CUDA tensors, its plain version for CPU tensors. The JAX model's
``use_pallas`` switch has no counterpart: the device decides. The pooling
and the gather stay plain PyTorch, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels.mlp import mlp_tower_fwd
from ..shared import Schema
from .base import MlpSpec, MlpTower

_DEFAULT_MLP = MlpSpec(hidden=(200, 300, 100), activation="tanh")


class FNNModel(nn.Module):
    """Construct via :func:`make_fnn`, which binds the schema's slot map."""

    def __init__(self, slot_field: tuple[int, ...], num_fields: int,
                 vocab_rows: int, k: int = 10, mlp: MlpSpec = _DEFAULT_MLP,
                 *, device: torch.device | str):
        super().__init__()
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

    def apply_rows(self, rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """rows ``[B, S, 1+k]``, mask ``[B, S]`` -> logits ``[B]``."""
        return mlp_tower_fwd(self.tower_input(rows, mask), self.mlp.params(),
                             self.mlp.spec.activation)

    forward = apply_rows


def make_fnn(schema: Schema, k: int = 10, mlp: MlpSpec | None = None, *,
             device: torch.device | str) -> FNNModel:
    return FNNModel(
        slot_field=tuple(int(f) for f in schema.slot_field),
        num_fields=schema.num_fields,
        vocab_rows=schema.padded_vocab_size,
        k=k,
        mlp=mlp or _DEFAULT_MLP,
        device=device,
    )
