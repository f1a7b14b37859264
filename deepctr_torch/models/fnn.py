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

from ..data import Schema
from .base import (MlpSpec, MlpTower, init_mlp, init_table, pool_fields, refuse_dense,
                   slot_onehot)

_DEFAULT_MLP = MlpSpec(hidden=(200, 300, 100), activation="tanh", dropout=0.5)


class FNNModel(nn.Module):
    """Construct via :func:`make_fnn`, which binds the schema's slot map."""

    name = "fnn"

    def __init__(self, slot_field: tuple[int, ...], num_fields: int,
                 vocab_rows: int, k: int = 10, mlp: MlpSpec = _DEFAULT_MLP,
                 init_sigma: float = 0.01, *, device: torch.device | str):
        super().__init__()
        self.init_sigma = init_sigma
        self.table = nn.Parameter(torch.zeros(vocab_rows, 1 + k, device=device))
        self.register_buffer("slot_onehot",
                             slot_onehot(slot_field, num_fields, device=device),
                             persistent=False)
        self.mlp = MlpTower(num_fields * (1 + k), mlp, device=device)

    def tower_input(self, rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """rows ``[B, S, 1+k]``, mask ``[B, S]`` -> pooled ``[B, F*(1+k)]``."""
        pooled = pool_fields(rows, mask, self.slot_onehot)   # [B, F, 1+k]
        return pooled.reshape(pooled.shape[0], -1).contiguous()

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator, pad_id: int) -> None:
        """The reference's ``init_params``, in place: the table normal with
        ``init_sigma`` and its pad row zero, the tower Glorot-uniform."""
        init_table(self.table, generator, self.init_sigma, pad_id)
        init_mlp(self.mlp, generator)

    def apply_rows(self, rows: torch.Tensor, mask: torch.Tensor, *,
                   dense: torch.Tensor | None = None, train: bool = False,
                   seed: int | None = None) -> torch.Tensor:
        """rows ``[B, S, 1+k]``, mask ``[B, S]`` -> logits ``[B]``; the tower
        drops with the counter-hash mask of ``seed`` in train mode
        (:meth:`MlpTower.forward`)."""
        refuse_dense(self, dense)
        return self.mlp(self.tower_input(rows, mask), train=train, seed=seed)

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
