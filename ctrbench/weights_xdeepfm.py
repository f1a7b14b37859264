"""The initial weights of an xDeepFM run, frozen here: made from the seed
on the device and handed alike to the program and to the reference.

The table ``[rows, 1+k]`` is drawn in blocks of ``BLOCK_ROWS`` rows, each
from its own stream of the seed, so that any block, or any set of rows, can
be made again alone: the program's table is filled block by block, the
reference gets the rows its steps touch, and the change of the whole table
is read block by block, never holding a second copy of it. Column 0 (the
linear weight) is normal with ``linear_sigma``, columns 1..k (the factors)
with ``factor_sigma``, and the pad row is zero. The dense leaves, in the
port's parameter order (:func:`leaf_shapes`): ``bias`` 0; ``w_cin`` and
each CIN layer's ``W^k`` Glorot-uniform (``w_cin`` as a ``[Σ H_k, 1]``
matrix); the DNN's ``w`` Glorot-uniform and ``b`` zero. The draws are the
harness's, not the program's.
"""

from __future__ import annotations

import math

import torch

from .arith_xdeepfm import dims
from .traffic import Fields, generator

BLOCK_ROWS = 1 << 20


def leaf_shapes(config: dict) -> list[tuple[str, tuple[int, ...]]]:
    """Every dense leaf's name and shape, in the port's parameter order:
    ``bias``, ``w_cin``, ``cin.l``, ``mlp.layers.i.w``, ``mlp.layers.i.b``."""
    m, _, maps, dnn = dims(config)
    widths = [m] + maps
    out = [("bias", ()), ("w_cin", (sum(maps),))]
    out += [(f"cin.{i}", (h_in * m, h)) for i, (h_in, h) in
            enumerate(zip(widths[:-1], widths[1:]))]
    for i, (a, b) in enumerate(zip(dnn[:-1], dnn[1:])):
        out += [(f"mlp.layers.{i}.w", (a, b)), (f"mlp.layers.{i}.b", (b,))]
    return out


def initial_dense(config: dict, seed: int, device) -> list[torch.Tensor]:
    """The dense leaves, in :func:`leaf_shapes` order."""
    g = generator(device, seed, "dense")
    out = []
    for name, shape in leaf_shapes(config):
        if name == "bias" or name.endswith(".b"):
            out.append(torch.zeros(shape, device=device))
            continue
        fan_in, fan_out = shape if len(shape) == 2 else (shape[0], 1)
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        out.append(torch.rand(shape, generator=g, device=device) * (2 * limit) - limit)
    return out


def num_rows(config: dict) -> int:
    """The table's rows: every field's and the pad row."""
    return Fields(config).rows


def blocks(config: dict) -> range:
    return range(-(-num_rows(config) // BLOCK_ROWS))


def table_block(config: dict, seed: int, device, block: int) -> torch.Tensor:
    """Rows ``[block·BLOCK_ROWS, ...)`` of the initial table, f32."""
    f = Fields(config)
    start = block * BLOCK_ROWS
    end = min(start + BLOCK_ROWS, f.rows)
    g = generator(device, seed, "table", block)
    out = torch.randn((end - start, 1 + int(config["k"])), generator=g, device=device)
    out[:, 0] *= float(config["linear_sigma"])
    out[:, 1:] *= float(config["factor_sigma"])
    if end == f.rows:
        out[-1] = 0.0   # the pad row
    return out


@torch.no_grad()
def fill_table(table: torch.Tensor, config: dict, seed: int) -> None:
    """The initial table into ``table`` (``[rows, 1+k]``), in place."""
    for blk in blocks(config):
        start = blk * BLOCK_ROWS
        table[start:start + BLOCK_ROWS].copy_(table_block(config, seed, table.device, blk))


def table_rows(config: dict, seed: int, device, ids: torch.Tensor) -> torch.Tensor:
    """The initial table's rows ``ids`` (sorted, unique), f32 ``[len(ids), 1+k]``."""
    out = torch.empty((ids.shape[0], 1 + int(config["k"])), device=device)
    block_of = ids // BLOCK_ROWS
    for blk in torch.unique(block_of).tolist():
        here = (block_of == blk).nonzero()[:, 0]
        out[here] = table_block(config, seed, device, blk)[ids[here] - blk * BLOCK_ROWS]
    return out
