"""Generated histories for HSTU: each user's items, oldest first, with
rising timestamps, padded to the schema's length.

The ``.yx`` formats carry no order and no time, so the CLI trains ``hstu``
on data made here from a seed (``cli.py``). The schema is one field whose
vocabulary is the items and whose slots are the history's length
(:func:`ml20m_schema`: MovieLens-20M's 26,744 rated movies, the last 200
ratings of a user, as the source truncates them). A history's length is
lognormal (median 68, mean 144 before the cap: ML-20M's ratings per user,
recalled), at least 20 and cut at ``N``; its first item is Zipf(1.05) over
ranks permuted from the seed, and each next one, with probability
``follow``, the fixed successor of the item before it (a permutation drawn
from the seed), else a fresh Zipf draw, so that a model can learn the next
item. The first timestamp is uniform over ML-20M's span (January 1995 to
March 2015, in seconds), the gaps lognormal (median 120 s, sigma 3).

:func:`pack` lays a batch out as the model reads it: int64 ``[n, 2, N]``,
row 0 the items (the pad id, the item count, after the length), row 1 the
timestamps (0 there).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .schema import FieldSpec, Schema

ML20M_ITEMS = 26_744
ML20M_USERS = 138_493
MAX_LEN = 200
LENGTH_MEDIAN, LENGTH_MEAN, MIN_LEN = 68.0, 144.0, 20
T_FIRST, T_LAST = 789_652_009, 1_427_784_002
GAP_MEDIAN_S, GAP_SIGMA = 120.0, 3.0


def ml20m_schema(items: int = ML20M_ITEMS, max_len: int = MAX_LEN) -> Schema:
    return Schema((FieldSpec("item", items, max_len),))


@dataclasses.dataclass
class HistoryDataset:
    ids: np.ndarray      # int64 [n, 2, N]: items (pad after the length), timestamps

    def __len__(self) -> int:
        return self.ids.shape[0]

    def lengths(self, pad_id: int) -> np.ndarray:
        return (self.ids[:, 0] != pad_id).sum(1)


def generate(schema: Schema, num_users: int, seed: int = 0, follow: float = 0.5,
             alpha: float = 1.05) -> HistoryDataset:
    """``num_users`` histories over ``schema``'s one field (module docstring)."""
    (field,) = schema.fields
    items, n = field.vocab_size, field.max_len
    rng = np.random.default_rng(seed)
    sigma = math.sqrt(2.0 * math.log(LENGTH_MEAN / LENGTH_MEDIAN))
    lengths = np.exp(math.log(LENGTH_MEDIAN) + sigma * rng.standard_normal(num_users))
    lengths = np.clip(np.round(lengths), min(MIN_LEN, n), n).astype(np.int64)
    p = np.arange(1, items + 1, dtype=np.float64) ** -alpha
    cdf = np.cumsum(p) / p.sum()
    perm = rng.permutation(items)
    successor = rng.permutation(items)
    fresh = perm[np.minimum(np.searchsorted(cdf, rng.random((num_users, n))), items - 1)]
    follows = rng.random((num_users, n)) < follow
    seq = np.empty((num_users, n), dtype=np.int64)
    seq[:, 0] = fresh[:, 0]
    for t in range(1, n):
        seq[:, t] = np.where(follows[:, t], successor[seq[:, t - 1]], fresh[:, t])
    gaps = np.exp(math.log(GAP_MEDIAN_S) + GAP_SIGMA * rng.standard_normal((num_users, n)))
    gaps[:, 0] = rng.uniform(T_FIRST, T_LAST, num_users)
    ts = np.cumsum(np.floor(gaps), axis=1).astype(np.int64)
    return HistoryDataset(pack(seq, ts, lengths, items))


def pack(seq: np.ndarray, ts: np.ndarray, lengths: np.ndarray, pad_id: int) -> np.ndarray:
    """int64 ``[n, 2, N]`` of items and timestamps, both padded after each
    length (items with ``pad_id``, timestamps with 0)."""
    n = seq.shape[1]
    live = np.arange(n)[None, :] < np.asarray(lengths)[:, None]
    return np.stack([np.where(live, seq, pad_id), np.where(live, ts, 0)], 1).astype(np.int64)
