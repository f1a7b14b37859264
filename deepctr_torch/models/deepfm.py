"""DeepFM: an FM scorer and a deep tower over one shared table.

Port of ``deepctr_tpu/models/deepfm.py``: ``logit = FM(rows) + MLP(pooled
fields) + b``, the table ``[V+1, 1+k]`` as FM's and FNN's, so an FM table
can seed it. The FM part is the fused FM scorer and the deep part FNN's
pooling followed by the tower kernels (``MlpTower``), both deciding by the
device. As in FNN, the port has one dropout, the counter hash of the
reference's kernel, seeded per step; the reference's non-kernel
``jax.random.bernoulli`` dropout (``use_pallas=False``) cannot be
reproduced in torch.

The dense parameters are ``bias`` and ``mlp``, so that ``state_dict`` keys
follow the JAX pytree (``bias``, ``mlp.layers.N.w``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels.interaction import fm_score
from ..data import Schema
from .base import (MlpSpec, MlpTower, init_mlp, init_table, pool_fields, refuse_dense,
                   slot_onehot)

_DEFAULT_MLP = MlpSpec(hidden=(200, 200), activation="relu", dropout=0.5)


class DeepFMModel(nn.Module):
    """Construct via :func:`make_deepfm`, which binds the schema's slot map."""

    name = "deepfm"

    def __init__(self, slot_field: tuple[int, ...], num_fields: int,
                 vocab_rows: int, k: int = 10, mlp: MlpSpec = _DEFAULT_MLP,
                 init_sigma: float = 0.01, *, device: torch.device | str):
        super().__init__()
        self.init_sigma = init_sigma
        self.table = nn.Parameter(torch.zeros(vocab_rows, 1 + k, device=device))
        self.bias = nn.Parameter(torch.zeros((), device=device))
        self.register_buffer("slot_onehot",
                             slot_onehot(slot_field, num_fields, device=device),
                             persistent=False)
        self.mlp = MlpTower(num_fields * (1 + k), mlp, device=device)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator, pad_id: int) -> None:
        """The reference's ``init_params``, in place: the table as FM's
        (normal, linear column and pad row zero), the tower Glorot-uniform,
        bias 0."""
        init_table(self.table, generator, self.init_sigma, pad_id, zero_linear=True)
        init_mlp(self.mlp, generator)
        self.bias.zero_()

    def apply_rows(self, rows: torch.Tensor, mask: torch.Tensor, *,
                   dense: torch.Tensor | None = None, train: bool = False,
                   seed: int | None = None) -> torch.Tensor:
        """rows ``[B, S, 1+k]``, mask ``[B, S]`` -> logits ``[B]``."""
        refuse_dense(self, dense)
        pooled = pool_fields(rows, mask, self.slot_onehot)
        flat = pooled.reshape(pooled.shape[0], -1).contiguous()
        deep = self.mlp(flat, train=train, seed=seed)
        return fm_score(rows, mask) + deep + self.bias

    forward = apply_rows


def make_deepfm(schema: Schema, k: int = 10, mlp: MlpSpec | None = None,
                init_sigma: float = 0.01, *,
                device: torch.device | str) -> DeepFMModel:
    return DeepFMModel(
        slot_field=tuple(int(f) for f in schema.slot_field),
        num_fields=schema.num_fields,
        vocab_rows=schema.padded_vocab_size,
        k=k,
        mlp=mlp or _DEFAULT_MLP,
        init_sigma=init_sigma,
        device=device,
    )
