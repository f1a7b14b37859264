"""The generator of multi-hot training traffic with dense features (the
``train_dlrm`` kind), frozen here: every input made from the run's seed, on
the device, beside ``traffic.py`` and with its draws.

A configuration's fields are its tables, ``num_embeddings_per_feature``
rows each, with ``multi_hot_sizes`` slots an example, packed as
``traffic.Fields`` packs them (global id = table offset + row, the pad id
the total rows). Every slot holds an id (the fixed hotness of MLPerf's
multi-hot data); each is drawn alone from its table's Zipf marginal
(exponent ``zipf_alpha``), ranks permuted from the seed
(``traffic.IdSampler``), so a multi-hot field may repeat an id. The
``num_dense`` dense features of an example are counts ``floor(exp(N(
dense_log_mean, dense_log_sigma)))``, heavy-tailed; labels are
Bernoulli(``label_rate``) of the configuration. Chunk ``c`` of the pool
comes from its own stream, so it can be made again alone.
"""

from __future__ import annotations

import torch

from .traffic import Fields, IdSampler, generator


def fields(config: dict) -> Fields:
    """The configuration's tables as ``traffic.Fields``."""
    return Fields({"fields": [[f"C{i + 1}", int(v), int(h)] for i, (v, h) in enumerate(
        zip(config["num_embeddings_per_feature"], config["multi_hot_sizes"], strict=True))]})


def draw_ids(sampler: IdSampler, n: int, g: torch.Generator) -> torch.Tensor:
    """``int64 [n, S]``: every slot of every field filled."""
    f, dev = sampler.f, sampler.device
    cols = []
    for fi, (_, vocab, hot) in enumerate(f.fields):
        u = torch.rand(n * hot, generator=g, device=dev, dtype=torch.float64)
        rank = torch.searchsorted(sampler.cdf[fi], u).clamp_(max=vocab - 1)
        cols.append((sampler.perm[fi][rank] + int(f.offsets[fi])).view(n, hot))
    return torch.cat(cols, 1)


def draw_dense(n: int, config: dict, traffic: dict, g: torch.Generator,
               device) -> torch.Tensor:
    """``f32 [n, num_dense]`` counts."""
    z = torch.randn((n, int(config["num_dense"])), generator=g, device=device)
    return torch.floor(torch.exp(z * float(traffic["dense_log_sigma"])
                                 + float(traffic["dense_log_mean"])))


def train_chunk(sampler: IdSampler, config: dict, traffic: dict, seed: int, chunk: int):
    """Chunk ``chunk`` of the pool: ``(ids int64 [K, B, S], labels f32 [K, B],
    dense f32 [K, B, num_dense])``, K = ``scan_steps``, B = ``batch``."""
    k, b = int(config["scan_steps"]), int(config["batch"])
    g = generator(sampler.device, seed, "pool", chunk)
    ids = draw_ids(sampler, k * b, g).view(k, b, -1)
    dense = draw_dense(k * b, config, traffic, g, sampler.device).view(k, b, -1)
    labels = sampler.labels(k * b, float(config["label_rate"]), g).view(k, b)
    return ids, labels, dense


def train_pool(sampler: IdSampler, config: dict, traffic: dict, seed: int):
    """The staged pool: ``(ids [C, K, B, S], labels [C, K, B], dense [C, K,
    B, num_dense])`` of ``pool_chunks`` chunks, on the device."""
    parts = [train_chunk(sampler, config, traffic, seed, c)
             for c in range(int(traffic["pool_chunks"]))]
    return tuple(torch.stack([p[i] for p in parts]) for i in range(3))
