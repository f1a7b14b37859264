"""The initial weights of a run, frozen here: made from the seed on the
device in a few large calls, in the dtype they are trained or served in,
and handed alike to the program and to the reference.

The table is normal with the configuration's ``init_sigma``, its pad row
zero, then cast to ``table_dtype``; a scoring cell serves a table drawn the
same way with ``served_table_sigma``, the scale of a trained model's rows
(at ``init_sigma`` the tower's inputs are a few hundredths, where tanh is
all but linear and a fault in it would not show); each tower layer ``w [in, out]`` is
Glorot-uniform and its bias zero, as the port's ``init_parameters`` draws
them (the draws themselves are the harness's, not the program's)."""

from __future__ import annotations

import math

import torch

from .traffic import Fields, generator

TABLE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def tower_dims(config: dict) -> list[int]:
    """``[F·(1+k), hidden..., 1]``."""
    f = Fields(config)
    return [f.num_fields * (1 + int(config["k"]))] + [int(h) for h in config["hidden"]] + [1]


def initial_table(config: dict, seed: int, device, sigma: float | None = None) -> torch.Tensor:
    f = Fields(config)
    g = generator(device, seed, "table")
    table = torch.randn((f.rows, 1 + int(config["k"])), generator=g, device=device)
    table.mul_(float(config["init_sigma"]) if sigma is None else sigma)
    table[f.pad_id] = 0.0
    return table.to(TABLE_DTYPES[config["table_dtype"]])


def served_table(config: dict, seed: int, device) -> torch.Tensor:
    return initial_table(config, seed, device, float(config["served_table_sigma"]))


def initial_tower(config: dict, seed: int, device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    g = generator(device, seed, "tower")
    dims = tower_dims(config)
    layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        limit = math.sqrt(6.0 / (d_in + d_out))
        w = torch.rand((d_in, d_out), generator=g, device=device).mul_(2 * limit).sub_(limit)
        layers.append((w, torch.zeros(d_out, device=device)))
    return layers
