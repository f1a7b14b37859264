"""The initial weights of a DLRM-DCNv2 run, frozen here: made from the seed
on the device and handed alike to the program and to the reference.

The table is drawn in blocks of ``BLOCK_ROWS`` rows, each from its own
stream of the seed, so that any block, or any set of rows, can be made
again alone: the program's table is filled block by block, the reference
gets the rows its steps touch, and the change of the whole table is read
block by block, never holding a second copy of 13.6 GB. A row of table t
is uniform in ``+-sqrt(1 / n_t)``, ``n_t`` the table's published rows
(torchrec's default, as recalled), and the pad row is zero. The MLPs'
layers (``w [in, out]``) have ``w`` and ``b`` uniform in
``+-1/sqrt(in)`` (``torch.nn.Linear``'s default); the cross layers' ``v
[in, rank]`` and ``w [rank, in]`` are Glorot-normal and ``b`` zero
(torchrec's low-rank cross net, as recalled). The draws are the harness's,
not the program's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .arith_dlrm import dims
from .traffic import generator
from .traffic_dlrm import fields

BLOCK_ROWS = 1 << 20


def leaf_shapes(config: dict) -> list[tuple[str, tuple[int, ...]]]:
    """Every dense leaf's name and shape, in the port's parameter order:
    ``bottom.i.w``, ``bottom.i.b``, ``cross.l.v``, ``cross.l.w``,
    ``cross.l.b``, ``top.i.w``, ``top.i.b``."""
    bottom, width, rank, layers, top = dims(config)
    out = []
    for i, (a, b) in enumerate(zip(bottom[:-1], bottom[1:])):
        out += [(f"bottom.{i}.w", (a, b)), (f"bottom.{i}.b", (b,))]
    for i in range(layers):
        out += [(f"cross.{i}.v", (width, rank)), (f"cross.{i}.w", (rank, width)),
                (f"cross.{i}.b", (width,))]
    for i, (a, b) in enumerate(zip(top[:-1], top[1:])):
        out += [(f"top.{i}.w", (a, b)), (f"top.{i}.b", (b,))]
    return out


def initial_dense(config: dict, seed: int, device) -> list[torch.Tensor]:
    """The dense leaves, in :func:`leaf_shapes` order."""
    g = generator(device, seed, "dense")
    out = []
    for name, shape in leaf_shapes(config):
        part, kind = name.split(".")[0], name.split(".")[-1]
        if part == "cross" and kind == "b":
            out.append(torch.zeros(shape, device=device))
        elif part == "cross":
            std = math.sqrt(2.0 / sum(shape))
            out.append(torch.randn(shape, generator=g, device=device) * std)
        else:
            fan_in = out[-1].shape[0] if kind == "b" else shape[0]
            bound = 1.0 / math.sqrt(fan_in)
            out.append(torch.rand(shape, generator=g, device=device) * (2 * bound) - bound)
    return out


def num_rows(config: dict) -> int:
    """The table's rows: every table's and the pad row."""
    return fields(config).rows


def table_block(config: dict, seed: int, device, block: int) -> torch.Tensor:
    """Rows ``[block·BLOCK_ROWS, ...)`` of the initial table, f32."""
    f = fields(config)
    start = block * BLOCK_ROWS
    end = min(start + BLOCK_ROWS, f.rows)
    g = generator(device, seed, "table", block)
    u = torch.rand((end - start, int(config["embedding_dim"])), generator=g, device=device)
    published = np.asarray(config["published_num_embeddings_per_feature"], dtype=np.float64)
    bounds = torch.tensor(np.append(np.sqrt(1.0 / published), 0.0), dtype=torch.float32,
                          device=device)
    offsets = torch.tensor(np.append(f.offsets[1:], f.vocab), device=device)
    table_of = torch.searchsorted(offsets, torch.arange(start, end, device=device),
                                  right=True)   # the pad row: past the last table
    return (u * 2 - 1) * bounds[table_of][:, None]


def blocks(config: dict) -> range:
    return range(-(-num_rows(config) // BLOCK_ROWS))


@torch.no_grad()
def fill_table(table: torch.Tensor, config: dict, seed: int) -> None:
    """The initial table into ``table`` (``[rows, D]``), in place."""
    for blk in blocks(config):
        start = blk * BLOCK_ROWS
        table[start:start + BLOCK_ROWS].copy_(table_block(config, seed, table.device, blk))


def table_rows(config: dict, seed: int, device, ids: torch.Tensor) -> torch.Tensor:
    """The initial table's rows ``ids`` (sorted, unique), f32 ``[len(ids), D]``."""
    out = torch.empty((ids.shape[0], int(config["embedding_dim"])), device=device)
    block_of = ids // BLOCK_ROWS
    for blk in torch.unique(block_of).tolist():
        here = (block_of == blk).nonzero()[:, 0]
        out[here] = table_block(config, seed, device, blk)[ids[here] - blk * BLOCK_ROWS]
    return out
