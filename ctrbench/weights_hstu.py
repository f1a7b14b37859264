"""The initial weights of an HSTU run, frozen here: made from the seed on the
device and handed alike to the program and to the reference, every leaf in
the port's parameter order (:func:`leaf_shapes`).

- ``table`` ``[items + 1, D]``: normal with ``table_sigma``, the pad row
  (the last) zero;
- ``pos_emb`` ``[N, D]``: normal with ``pos_sigma``;
- each block's ``uvqk`` ``[D, 2H(d_v + d_qk)]`` normal with ``uvqk_sigma``,
  ``w_o`` ``[H·d_v, D]`` Glorot-uniform, ``b_o`` uniform within
  ``1/sqrt(H·d_v)``, ``w_pos`` ``[2N - 1]`` and ``w_time`` ``[129]`` normal
  with ``bias_sigma``.

Each leaf is drawn from its own stream of the seed. The draws are the
harness's, not the program's.
"""

from __future__ import annotations

import math

import torch

from .traffic import generator


def leaf_shapes(config: dict) -> list[tuple[str, tuple[int, ...]]]:
    d, n = int(config["item_embedding_dim"]), int(config["max_sequence_length"])
    h, dqk, dv = int(config["num_heads"]), int(config["dqk"]), int(config["dv"])
    out = [("table", (int(config["items"]) + 1, d)), ("pos_emb", (n, d))]
    for b in range(int(config["num_blocks"])):
        out += [(f"blocks.{b}.uvqk", (d, 2 * h * (dv + dqk))), (f"blocks.{b}.w_o", (h * dv, d)),
                (f"blocks.{b}.b_o", (d,)), (f"blocks.{b}.w_pos", (2 * n - 1,)),
                (f"blocks.{b}.w_time", (int(config["time_buckets"]) + 1,))]
    return out


def initial_leaves(config: dict, seed: int, device) -> list[torch.Tensor]:
    """Every leaf, in :func:`leaf_shapes` order."""
    out = []
    for name, shape in leaf_shapes(config):
        g = generator(device, seed, "leaf", name)
        kind = name.split(".")[-1]
        if kind in ("w_o", "b_o"):
            fan_in = int(config["num_heads"]) * int(config["dv"])
            limit = (math.sqrt(6.0 / (fan_in + shape[-1])) if kind == "w_o"
                     else 1.0 / math.sqrt(fan_in))
            out.append(torch.rand(shape, generator=g, device=device) * (2 * limit) - limit)
            continue
        sigma = {"table": "table_sigma", "pos_emb": "pos_sigma", "uvqk": "uvqk_sigma",
                 "w_pos": "bias_sigma", "w_time": "bias_sigma"}[kind]
        t = torch.randn(shape, generator=g, device=device) * float(config[sigma])
        if kind == "table":
            t[-1] = 0.0   # the pad row
        out.append(t)
    return out
