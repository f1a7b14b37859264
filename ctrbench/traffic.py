"""The traffic generator, frozen here: every input of a run made from its
seed, on the device.

Ids follow per-field Zipf marginals (exponent ``zipf_alpha``, 1.05 in the
mixes, as ``deepctr_torch/data/synthetic.py`` draws them), with a random
permutation of each field's ranks, drawn from the seed, so that the hot rows
are scattered over the table as hashing scatters them. A field of
``max_len`` > 1 slots holds 1 + Binomial(max_len - 1, 0.6) values packed
from its first slot, the rest pad ids (the synthetic generator's rule).
Labels are Bernoulli(``label_rate``) of the configuration.

Every draw comes from a ``torch.Generator`` on the run's device seeded by
:func:`sub_seed` of the run's seed and a named stream, so the same seed gives
the same inputs and a chunk can be made again alone: the training pool is
drawn chunk by chunk, each chunk from its own stream.

Scoring requests take their sizes from a fixed set, the quantiles of a
lognormal (median ``size_median``, sigma ``size_sigma``, clipped to
``size_min``..``size_max``) at ``(i + 0.5) / pool_requests``, in an order
drawn from the seed: every seed serves the same sizes, so the seed does
not change the work.
"""

from __future__ import annotations

import hashlib
import math
import statistics

import numpy as np
import torch

SEED_LIMIT = 1 << 24   # the tower kernels' dropout seeds are below 2^24


def sub_seed(seed: int, *stream) -> int:
    """A 63-bit seed for the named stream of draws of the run ``seed``."""
    digest = hashlib.sha256(repr((int(seed),) + stream).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device, seed: int, *stream) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *stream))


class Fields:
    """The configuration's fields ``[name, vocab_size, max_len]``, in the
    packed layout of the port's ``Schema``: global id = field offset + local
    value, the pad id is the total vocabulary."""

    def __init__(self, config: dict):
        self.fields = [(str(n), int(v), int(m)) for n, v, m in config["fields"]]
        sizes = [v for _, v, _ in self.fields]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        self.vocab = int(sum(sizes))
        self.pad_id = self.vocab
        self.rows = self.vocab + 1
        self.slot_field = [i for i, (_, _, m) in enumerate(self.fields) for _ in range(m)]
        self.num_slots = len(self.slot_field)
        self.num_fields = len(self.fields)


class IdSampler:
    """Draws packed id rows ``int64 [n, S]`` of a configuration's fields."""

    def __init__(self, fields: Fields, alpha: float, seed: int, device):
        self.f = fields
        self.device = torch.device(device)
        g = generator(device, seed, "fields")
        self.cdf, self.perm = [], []
        for _, vocab, _ in fields.fields:
            p = torch.arange(1, vocab + 1, dtype=torch.float64, device=device) ** -alpha
            cdf = torch.cumsum(p, 0)
            self.cdf.append(cdf / cdf[-1])
            self.perm.append(torch.randperm(vocab, generator=g, device=device))

    def draw(self, n: int, g: torch.Generator) -> torch.Tensor:
        cols = []
        dev = self.device
        for fi, (_, vocab, max_len) in enumerate(self.f.fields):
            count = 1 + (torch.rand((n, max_len - 1), generator=g, device=dev)
                         < 0.6).sum(1)
            for j in range(max_len):
                u = torch.rand(n, generator=g, device=dev, dtype=torch.float64)
                rank = torch.searchsorted(self.cdf[fi], u).clamp_(max=vocab - 1)
                gid = self.perm[fi][rank] + int(self.f.offsets[fi])
                if j > 0:
                    gid = torch.where(count > j, gid, self.f.pad_id)
                cols.append(gid)
        return torch.stack(cols, 1)

    def labels(self, n: int, rate: float, g: torch.Generator) -> torch.Tensor:
        return (torch.rand(n, generator=g, device=self.device) < rate).float()


def train_chunk(sampler: IdSampler, config: dict, seed: int, rank: int, chunk: int,
                rows: int):
    """Chunk ``chunk`` of rank ``rank``'s pool: ``(ids int64 [K, rows, S],
    labels f32 [K, rows])``, K = the configuration's ``scan_steps``."""
    k = int(config["scan_steps"])
    g = generator(sampler.device, seed, "pool", rank, chunk)
    ids = sampler.draw(k * rows, g).view(k, rows, -1)
    labels = sampler.labels(k * rows, float(config["label_rate"]), g).view(k, rows)
    return ids, labels


def train_pool(sampler: IdSampler, config: dict, traffic: dict, seed: int,
               rank: int, rows: int):
    """Rank ``rank``'s staged pool: ``(ids [C, K, rows, S], labels [C, K,
    rows])`` of ``pool_chunks`` chunks, on the device."""
    parts = [train_chunk(sampler, config, seed, rank, c, rows)
             for c in range(int(traffic["pool_chunks"]))]
    return torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])


def dropout_seeds(seed: int, n: int) -> list[int]:
    """``n`` dropout seeds below 2^24, one a step of the pool, the same on
    every rank."""
    rng = np.random.default_rng(sub_seed(seed, "dropout"))
    return [int(s) for s in rng.integers(0, SEED_LIMIT, size=n)]


def request_sizes(traffic: dict, seed: int) -> list[int]:
    """The pool's request sizes: the fixed quantile set, in the seed's order."""
    n = int(traffic["pool_requests"])
    med, sigma = float(traffic["size_median"]), float(traffic["size_sigma"])
    lo, hi = int(traffic["size_min"]), int(traffic["size_max"])
    sizes = []
    for i in range(n):
        z = statistics.NormalDist().inv_cdf((i + 0.5) / n)
        sizes.append(int(min(hi, max(lo, round(med * math.exp(sigma * z))))))
    order = np.random.default_rng(sub_seed(seed, "sizes")).permutation(n)
    return [sizes[i] for i in order]


def serve_requests(sampler: IdSampler, traffic: dict, seed: int) -> list[np.ndarray]:
    """The pool of scoring requests: packed ``int32 [n_i, S]`` id arrays in
    host memory, as a caller hands them to the scorer."""
    sizes = request_sizes(traffic, seed)
    g = generator(sampler.device, seed, "requests")
    ids = sampler.draw(sum(sizes), g).to(torch.int32).cpu().numpy()
    bounds = np.cumsum([0] + sizes)
    return [np.ascontiguousarray(ids[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


def sample_requests(served: int, sizes: list[int], count: int, seed: int) -> list[int]:
    """The requests whose answers ``correct`` compares: ``count`` of the
    first ``served`` of the pool, drawn from the seed, with the longest of
    them among them."""
    served = min(served, len(sizes))
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    picked = set(int(i) for i in rng.choice(served, size=min(count, served), replace=False))
    picked.add(int(np.argmax(sizes[:served])))
    return sorted(picked)
