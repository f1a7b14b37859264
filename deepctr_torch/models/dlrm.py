"""DLRM with a DCN-V2 interaction: the recommendation model of MLPerf
Training (DLRM, arXiv:1906.00091; DCN-V2, arXiv:2008.13535; the reference
is ``recommendation_v2/torchrec_dlrm`` of ``github.com/mlcommons/training``).

It has no counterpart in the JAX package. It keeps the port's model
contract, with dense (continuous) features beside the ids::

    rows   = model.table[ids]                         # [B, S, D]
    logits = model.apply_rows(rows, mask, dense=x)    # [B]

- ``e_t``: each field's slots, masked and summed (``ops/pool.py``), from one
  table ``[V+1, D]`` whose row ``pad_id`` is zero: no linear column, as
  FNN's and FM's tables have;
- ``d = bottom(log(1 + dense))``: the bottom MLP, ReLU on every layer;
- ``x0 = concat(d, e_1..e_F)``, then ``cross_layers`` low-rank cross layers
  ``x_{l+1} = x0 ⊙ (W_l (V_l x_l) + b_l) + x_l``;
- ``logit = top(x_L)``, ReLU on all but its last layer, which has one
  output.

The dense layers are ``ops/layers.py``'s float32 path on cuBLAS (the tower
kernels take none of these widths). There is no dropout; ``train`` and
``seed`` are taken for the step's contract and change nothing. In a
traced graph the forward marks the phases ``pool``, ``bottom``, ``cross``
and ``top`` (``utils/prof.py``), and the train step names its backward
``backward`` (:attr:`DLRMModel.backward_phase`).

Parameters keep the port's layout, ``w`` ``[in, out]``: ``bottom.layers.i``
and ``top.layers.i`` hold ``w`` and ``b``, ``cross.layers.l`` holds ``v``
``[in, rank]``, ``w`` ``[rank, in]`` and ``b`` ``[in]``, in that order.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..data import Schema
from ..ops.layers import low_rank_cross, mlp
from ..ops.pool import pool_slots
from ..utils import prof
from .base import Dense, init_table, slot_onehot


class _Stack(nn.Module):
    def __init__(self, dims, *, device):
        super().__init__()
        self.layers = nn.ModuleList(Dense(a, b, device=device)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def params(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        return [(layer.w, layer.b) for layer in self.layers]


class CrossLayer(nn.Module):
    """One low-rank cross layer: ``v`` [in, rank], ``w`` [rank, in], ``b`` [in]."""

    def __init__(self, width: int, rank: int, *, device):
        super().__init__()
        self.v = nn.Parameter(torch.zeros(width, rank, device=device))
        self.w = nn.Parameter(torch.zeros(rank, width, device=device))
        self.b = nn.Parameter(torch.zeros(width, device=device))


class _Cross(nn.Module):
    def __init__(self, width: int, rank: int, layers: int, *, device):
        super().__init__()
        self.layers = nn.ModuleList(CrossLayer(width, rank, device=device)
                                    for _ in range(layers))


class DLRMModel(nn.Module):
    """Construct via :func:`make_dlrm_dcnv2`, which binds the schema's slot map."""

    name = "dlrm_dcnv2"
    backward_phase = "backward"

    def __init__(self, slot_field: tuple[int, ...], num_fields: int, vocab_rows: int,
                 embed_dim: int, bottom: tuple[int, ...], cross_layers: int,
                 cross_rank: int, top: tuple[int, ...], num_dense: int,
                 init_sigma: float, *, device: torch.device | str):
        super().__init__()
        self.init_sigma = init_sigma
        self.table = nn.Parameter(torch.zeros(vocab_rows, embed_dim, device=device))
        self.register_buffer("slot_onehot",
                             slot_onehot(slot_field, num_fields, device=device),
                             persistent=False)
        self.bottom = _Stack((num_dense,) + tuple(bottom), device=device)
        width = bottom[-1] + num_fields * embed_dim
        self.cross = _Cross(width, cross_rank, cross_layers, device=device)
        self.top = _Stack((width,) + tuple(top) + (1,), device=device)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator, pad_id: int) -> None:
        """In place: the table normal with ``init_sigma`` and its pad row
        zero; the MLPs' weights Glorot-uniform and biases zero; the cross
        layers' ``v`` and ``w`` Glorot-normal (DCN-V2's) and ``b`` zero."""
        init_table(self.table, generator, self.init_sigma, pad_id)
        for stack in (self.bottom, self.top):
            for layer in stack.layers:
                fan_in, fan_out = layer.w.shape
                limit = math.sqrt(6.0 / (fan_in + fan_out))
                draw = torch.rand(layer.w.shape, generator=generator,
                                  device=generator.device)
                layer.w.copy_(draw * (2 * limit) - limit)
                layer.b.zero_()
        for layer in self.cross.layers:
            for p in (layer.v, layer.w):
                std = math.sqrt(2.0 / sum(p.shape))
                p.copy_(std * torch.randn(p.shape, generator=generator,
                                          device=generator.device))
            layer.b.zero_()

    def apply_rows(self, rows: torch.Tensor, mask: torch.Tensor, *,
                   dense: torch.Tensor | None = None, train: bool = False,
                   seed: int | torch.Tensor | None = None) -> torch.Tensor:
        """rows ``[B, S, D]``, mask ``[B, S]``, dense ``[B, num_dense]``
        (counts, >= 0) -> logits ``[B]``; raises without ``dense``."""
        if dense is None:
            raise ValueError("DLRMModel takes dense features: dense=[B, num_dense]")
        del train, seed   # no dropout
        pooled = pool_slots(rows, mask, self.slot_onehot)
        prof.phase("pool")
        d = mlp(torch.log1p(dense), self.bottom.params(), relu_last=True)
        prof.phase("bottom")
        x0 = torch.cat([d, pooled.reshape(pooled.shape[0], -1)], 1)
        x = x0
        for layer in self.cross.layers:
            x = low_rank_cross(x0, x, layer.v, layer.w, layer.b)
        prof.phase("cross")
        logits = mlp(x, self.top.params(), relu_last=False)[:, 0]
        prof.phase("top")
        return logits

    forward = apply_rows


def make_dlrm_dcnv2(schema: Schema, embed_dim: int = 128,
                    bottom: tuple[int, ...] = (512, 256, 128), cross_layers: int = 3,
                    cross_rank: int = 512, top: tuple[int, ...] = (1024, 1024, 512, 256),
                    num_dense: int = 13, init_sigma: float = 0.01, *,
                    device: torch.device | str) -> DLRMModel:
    """DLRM-DCNv2 over ``schema``'s fields (MLPerf's widths by default):
    ``top`` lists the top MLP's hidden widths; its last layer has one
    output."""
    return DLRMModel(
        slot_field=tuple(int(f) for f in schema.slot_field),
        num_fields=schema.num_fields,
        vocab_rows=schema.padded_vocab_size,
        embed_dim=embed_dim,
        bottom=tuple(bottom),
        cross_layers=cross_layers,
        cross_rank=cross_rank,
        top=tuple(top),
        num_dense=num_dense,
        init_sigma=init_sigma,
        device=device,
    )
