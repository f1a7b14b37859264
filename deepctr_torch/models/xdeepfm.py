"""xDeepFM: a linear term, a Compressed Interaction Network and a DNN over
one shared table (Lian et al., *xDeepFM: Combining Explicit and Implicit
Feature Interactions for Recommender Systems*, KDD 2018, arXiv:1803.05170).

It has no counterpart in the JAX package. It keeps the port's model
contract::

    rows   = model.table[ids]                  # [B, S, 1+k]
    logits = model.apply_rows(rows, mask)      # [B]

- the table ``[V+1, 1+k]`` in FM's layout: column 0 the linear weight,
  columns 1..k the factors, the pad row zero. Each field's slots are masked
  and summed (``ops/pool.py``; a one-hot field's sum is its one row);
- ``X^0 = [e_1..e_m]``, the fields' factors ``[m, k]``;
- the logit (the paper's Eq. 8) is ``Σ_fields w_lin + DNN(flatten X^0) +
  w_cin · [p^1..p^T] + b``: the linear term; the DNN, ReLU on its hidden
  layers and no dropout, ending in one output, on the tower kernels
  (``models/base.py::MlpTower``, as FNN's); and the CIN's pooled maps
  (``ops/cin.py``, Eq. 6: direct connections, no bias, no activation,
  float32 with TF32 off) through ``w_cin``.

There is no dropout; ``train`` and ``seed`` are taken for the step's
contract and change nothing. In a traced graph the forward marks the phase
``cin`` (the pooling and the CIN), the train step marks ``dnn`` after the
loss (:attr:`XDeepFMModel.loss_phase`: the DNN, the linear term, the logit
and the loss) and ``backward`` after the backward, inside which the CIN's
own backward marks ``backward`` and ``cin_bwd`` (``ops/cin.py``).

Parameters, in ``named_parameters`` order: ``table``, ``bias``, ``w_cin``
``[Σ H_l]``, ``cin.l`` (``W^l`` ``[H_{l-1}·m, H_l]``, row ``i·m + j``) and
``mlp.layers.i.w`` / ``.b`` (``w`` ``[in, out]``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..data import Schema
from ..ops import cin as cin_op
from ..ops.layers import f32_products
from ..ops.pool import pool_slots
from ..utils import prof
from .base import MlpSpec, MlpTower, init_mlp, init_table, refuse_dense, slot_onehot


class XDeepFMModel(nn.Module):
    """Construct via :func:`make_xdeepfm`, which binds the schema's slot map."""

    name = "xdeepfm"
    loss_phase = "dnn"
    backward_phase = "backward"

    def __init__(self, slot_field: tuple[int, ...], num_fields: int, vocab_rows: int,
                 k: int, cin_maps: tuple[int, ...], dnn: tuple[int, ...],
                 init_sigma: float, *, device: torch.device | str):
        super().__init__()
        self.init_sigma = init_sigma
        self.table = nn.Parameter(torch.zeros(vocab_rows, 1 + k, device=device))
        self.bias = nn.Parameter(torch.zeros((), device=device))
        self.register_buffer("slot_onehot",
                             slot_onehot(slot_field, num_fields, device=device),
                             persistent=False)
        widths = (num_fields,) + tuple(cin_maps)
        self.cin = nn.ParameterList(
            nn.Parameter(torch.zeros(h_in * num_fields, h, device=device))
            for h_in, h in zip(widths[:-1], widths[1:]))
        self.w_cin = nn.Parameter(torch.zeros(sum(cin_maps), device=device))
        self.mlp = MlpTower(num_fields * k, MlpSpec(hidden=tuple(dnn), activation="relu",
                                                    dropout=0.0), device=device)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator, pad_id: int) -> None:
        """In place: the table as FM's (normal with ``init_sigma``, linear
        column and pad row zero), each ``W^l`` and ``w_cin`` Glorot-uniform,
        the DNN Glorot-uniform with zero biases, ``bias`` 0."""
        init_table(self.table, generator, self.init_sigma, pad_id, zero_linear=True)
        for p in list(self.cin) + [self.w_cin]:
            fan_in, fan_out = p.shape if p.dim() == 2 else (p.shape[0], 1)
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            draw = torch.rand(p.shape, generator=generator, device=generator.device)
            p.copy_(draw * (2 * limit) - limit)
        init_mlp(self.mlp, generator)
        self.bias.zero_()

    def apply_rows(self, rows: torch.Tensor, mask: torch.Tensor, *,
                   dense: torch.Tensor | None = None, train: bool = False,
                   seed: int | torch.Tensor | None = None) -> torch.Tensor:
        """rows ``[B, S, 1+k]``, mask ``[B, S]`` -> logits ``[B]``."""
        refuse_dense(self, dense)
        del train, seed   # no dropout
        pooled = pool_slots(rows, mask, self.slot_onehot)        # [B, m, 1+k]
        x0 = pooled[:, :, 1:]
        p = cin_op.cin(x0.transpose(1, 2).contiguous(), list(self.cin))
        prof.phase("cin")
        deep = self.mlp(x0.reshape(x0.shape[0], -1).contiguous())
        with f32_products():
            explicit = p @ self.w_cin
        return pooled[:, :, 0].sum(1) + deep + explicit + self.bias

    forward = apply_rows


def make_xdeepfm(schema: Schema, k: int = 10, cin: tuple[int, ...] = (200, 200, 200),
                 dnn: tuple[int, ...] = (400, 400), init_sigma: float = 0.01, *,
                 device: torch.device | str) -> XDeepFMModel:
    """xDeepFM over ``schema``'s fields, at the paper's Criteo widths by
    default: ``cin`` lists the CIN's feature maps a layer, ``dnn`` the DNN's
    hidden widths; the DNN ends in one output."""
    return XDeepFMModel(
        slot_field=tuple(int(f) for f in schema.slot_field),
        num_fields=schema.num_fields,
        vocab_rows=schema.padded_vocab_size,
        k=k,
        cin_maps=tuple(cin),
        dnn=tuple(dnn),
        init_sigma=init_sigma,
        device=device,
    )
