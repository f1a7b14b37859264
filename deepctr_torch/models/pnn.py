"""PNN: product-based neural networks (IPNN, OPNN) over one shared table.

Port of ``deepctr_tpu/models/pnn.py``. The tower takes the pooled fields
``[B, F*D]`` and, beside them, explicit product features of the field
vectors ``f_i`` (``D = 1+k``):

- IPNN (``product="inner"``): the inner products ``<f_i, f_j>``, ``i < j``,
  the upper triangle of each example's Gram matrix (``F(F-1)/2`` of them);
- OPNN (``product="outer"``): the compressed outer product, one D-vector
  ``1/2 [(sum_i f_i)^2 - sum_i f_i^2]``.

The tower goes through the tower kernels (``MlpTower``), deciding by the
device; its dropout is the counter hash, seeded per step. The reference
always takes ``apply_mlp``, whose dropout is ``jax.random.bernoulli``, so
the two agree at dropout 0 only. Unlike FM's, the table's column 0 is drawn
like the rest, and there is no bias: the dense parameters are ``mlp``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..data import Schema
from .base import (MlpSpec, MlpTower, init_mlp, init_table, pool_fields, refuse_dense,
                   slot_onehot)

_DEFAULT_MLP = MlpSpec(hidden=(200, 200), activation="relu", dropout=0.5)
PRODUCTS = ("inner", "outer")


class PNNModel(nn.Module):
    """Construct via :func:`make_pnn`, which binds the schema's slot map."""

    def __init__(self, slot_field: tuple[int, ...], num_fields: int,
                 vocab_rows: int, k: int = 10, product: str = "inner",
                 mlp: MlpSpec = _DEFAULT_MLP, init_sigma: float = 0.01, *,
                 device: torch.device | str):
        super().__init__()
        if product not in PRODUCTS:
            raise ValueError(f"unknown PNN product {product!r} (inner|outer)")
        self.name = f"pnn_{product}"
        self.product = product
        self.init_sigma = init_sigma
        self.table = nn.Parameter(torch.zeros(vocab_rows, 1 + k, device=device))
        self.register_buffer("slot_onehot",
                             slot_onehot(slot_field, num_fields, device=device),
                             persistent=False)
        upper = torch.triu_indices(num_fields, num_fields, offset=1, device=device)
        self.register_buffer("upper", upper, persistent=False)
        products = upper.shape[1] if product == "inner" else 1 + k
        self.mlp = MlpTower(num_fields * (1 + k) + products, mlp, device=device)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator, pad_id: int) -> None:
        """The reference's ``init_params``, in place: the table normal with
        ``init_sigma`` and its pad row zero, the tower Glorot-uniform."""
        init_table(self.table, generator, self.init_sigma, pad_id)
        init_mlp(self.mlp, generator)

    def tower_input(self, rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """rows ``[B, S, D]``, mask ``[B, S]`` -> ``[B, F*D + products]``."""
        fields = pool_fields(rows, mask, self.slot_onehot)     # [B, F, D]
        flat = fields.reshape(fields.shape[0], -1)
        if self.product == "inner":
            gram = torch.einsum("bfd,bgd->bfg", fields, fields)
            prods = gram[:, self.upper[0], self.upper[1]]      # [B, F(F-1)/2]
        else:
            s = fields.sum(dim=1)
            prods = 0.5 * (s * s - (fields * fields).sum(dim=1))
        return torch.cat([flat, prods], dim=1)

    def apply_rows(self, rows: torch.Tensor, mask: torch.Tensor, *,
                   dense: torch.Tensor | None = None, train: bool = False,
                   seed: int | None = None) -> torch.Tensor:
        """rows ``[B, S, D]``, mask ``[B, S]`` -> logits ``[B]``."""
        refuse_dense(self, dense)
        return self.mlp(self.tower_input(rows, mask), train=train, seed=seed)

    forward = apply_rows


def make_pnn(schema: Schema, k: int = 10, product: str = "inner",
             mlp: MlpSpec | None = None, init_sigma: float = 0.01, *,
             device: torch.device | str) -> PNNModel:
    return PNNModel(
        slot_field=tuple(int(f) for f in schema.slot_field),
        num_fields=schema.num_fields,
        vocab_rows=schema.padded_vocab_size,
        k=k,
        product=product,
        mlp=mlp or _DEFAULT_MLP,
        init_sigma=init_sigma,
        device=device,
    )
