"""The traffic of a ``train_hstu`` cell, frozen here: users' histories made
from the run's seed, on the device, chunk by chunk (``traffic.py``'s
streams, so that a chunk can be made again alone).

A history's length is lognormal with the mix's ``length_median`` and
``length_mean`` (sigma ``sqrt(2·ln(mean/median))``), rounded, at least
``length_min`` and cut at the configuration's ``max_sequence_length``. Its
items are Zipf(``zipf_alpha``) over ranks permuted from the seed
(``traffic.IdSampler`` over one field of the items). Its first timestamp is
uniform over ``[t_first, t_last)`` and the gaps lognormal (median
``gap_median_s``, sigma ``gap_sigma``), floored to whole seconds, so the
timestamps rise (a gap of 0 included).

A chunk is int64 ``[K, B, 2, N]`` as the program reads a batch: row 0 the
items, the pad id (the item count) after the length; row 1 the timestamps,
0 there.
"""

from __future__ import annotations

import math

import torch

from .traffic import Fields, IdSampler, generator


def fields(config: dict) -> Fields:
    return Fields({"fields": [["item", int(config["items"]), 1]]})


def lengths(n: int, config: dict, traffic: dict, g: torch.Generator, device) -> torch.Tensor:
    """int64 ``[n]`` history lengths."""
    med, mean = float(traffic["length_median"]), float(traffic["length_mean"])
    sigma = math.sqrt(2.0 * math.log(mean / med))
    z = torch.randn(n, generator=g, device=device, dtype=torch.float64)
    out = torch.round(torch.exp(math.log(med) + sigma * z))
    return out.clamp(int(traffic["length_min"]), int(config["max_sequence_length"])).long()


def histories(sampler: IdSampler, n: int, config: dict, traffic: dict,
              g: torch.Generator) -> torch.Tensor:
    """int64 ``[n, 2, N]`` histories."""
    dev = sampler.device
    big_n = int(config["max_sequence_length"])
    lens = lengths(n, config, traffic, g, dev)
    items = sampler.draw(n * big_n, g).view(n, big_n)
    gaps = torch.exp(math.log(float(traffic["gap_median_s"]))
                     + float(traffic["gap_sigma"])
                     * torch.randn((n, big_n), generator=g, device=dev, dtype=torch.float64))
    lo, hi = float(traffic["t_first"]), float(traffic["t_last"])
    gaps[:, 0] = lo + (hi - lo) * torch.rand(n, generator=g, device=dev, dtype=torch.float64)
    ts = torch.cumsum(torch.floor(gaps).long(), 1)
    live = torch.arange(big_n, device=dev)[None, :] < lens[:, None]
    return torch.stack([torch.where(live, items, sampler.f.pad_id),
                        torch.where(live, ts, 0)], 1)


def train_chunk(sampler: IdSampler, config: dict, traffic: dict, seed: int,
                chunk: int) -> torch.Tensor:
    """Chunk ``chunk`` of the pool: int64 ``[K, B, 2, N]``."""
    k, b = int(config["scan_steps"]), int(config["batch"])
    g = generator(sampler.device, seed, "pool", 0, chunk)
    return histories(sampler, k * b, config, traffic, g).view(k, b, 2, -1)


def train_pool(sampler: IdSampler, config: dict, traffic: dict, seed: int) -> torch.Tensor:
    """The staged pool: int64 ``[C, K, B, 2, N]`` of ``pool_chunks`` chunks."""
    return torch.stack([train_chunk(sampler, config, traffic, seed, c)
                        for c in range(int(traffic["pool_chunks"]))])


def sampler(config: dict, traffic: dict, seed: int, device) -> IdSampler:
    return IdSampler(fields(config), float(traffic["zipf_alpha"]), seed, device)
