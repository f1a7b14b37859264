"""Generated data for DLRM-DCNv2: multi-hot ids beside dense features.

The ``.yx`` formats carry ids alone, so the CLI trains ``dlrm_dcnv2`` on
data made here from a seed (``cli.py``). The schema is MLPerf's Criteo
multi-hot one (:func:`mlperf_dlrm_schema`): 26 fields whose table sizes are
the MLPerf run script's (``recommendation_v2/torchrec_dlrm``, with its 40 M
cap), each capped at ``row_cap`` rows, and whose slot counts are its
multi-hot sizes, 214 ids an example. Every slot holds an id (MLPerf's
multi-hot data has a fixed hotness a field); within a field the ids are
log-uniform over its rows (rank ``floor((vocab + 1) ** u) - 1``, a Zipf(1)-like
skew). The 13 dense features are counts, ``floor(exp(N(1, 1.5)))``,
heavy-tailed as Criteo's integer features. Labels are drawn from a planted
logistic teacher over the dense features' logs and a hashed effect of
every id, so that a model can learn them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .schema import FieldSpec, Schema

# the MLPerf run script's rows a table (40 M cap) and ids an example a field
MLPERF_ROWS = (40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
               3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000, 40000000,
               40000000, 590152, 12973, 108, 36)
MLPERF_HOTNESS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27,
                  10, 3, 1, 1)
NUM_DENSE = 13


def mlperf_dlrm_schema(row_cap: int | None = None) -> Schema:
    """MLPerf's 26 multi-hot Criteo fields, each table capped at ``row_cap``
    rows (None: the published sizes, 204,184,588 rows)."""
    return Schema(tuple(
        FieldSpec(f"C{i + 1}", rows if row_cap is None else min(rows, row_cap), hot)
        for i, (rows, hot) in enumerate(zip(MLPERF_ROWS, MLPERF_HOTNESS))))


@dataclasses.dataclass
class DenseFeatureDataset:
    ids: np.ndarray      # int32 [n, S], every slot filled
    dense: np.ndarray    # float32 [n, num_dense], counts >= 0
    labels: np.ndarray   # float32 [n]

    def __len__(self) -> int:
        return self.labels.shape[0]

    def slice(self, sel) -> "DenseFeatureDataset":
        return DenseFeatureDataset(self.ids[sel], self.dense[sel], self.labels[sel])


def _id_effect(gid: np.ndarray) -> np.ndarray:
    """A fixed pseudo-random effect in [-1, 1) of each global id."""
    h = (gid.astype(np.uint64) * np.uint64(2654435761)) % np.uint64(1 << 32)
    return h.astype(np.float64) / float(1 << 31) - 1.0


def generate(schema: Schema, num_examples: int, num_dense: int = NUM_DENSE,
             seed: int = 0) -> DenseFeatureDataset:
    """``num_examples`` examples over ``schema`` from ``seed``."""
    rng = np.random.default_rng(seed)
    n = num_examples
    cols = []
    logit = np.zeros(n)
    for f, offset in zip(schema.fields, schema.offsets):
        u = rng.random((n, f.max_len))
        rank = np.minimum(np.floor(float(f.vocab_size + 1) ** u).astype(np.int64) - 1,
                          f.vocab_size - 1)
        gid = rank + int(offset)
        logit += 0.5 * _id_effect(gid).mean(1)
        cols.append(gid.astype(np.int32))
    counts = np.floor(np.exp(rng.normal(1.0, 1.5, size=(n, num_dense))))
    logs = np.log1p(counts)
    weights = rng.normal(0.0, 1.0, size=num_dense) / np.sqrt(num_dense)
    logit += (logs - logs.mean(0)) @ weights - 1.0
    labels = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    return DenseFeatureDataset(np.concatenate(cols, 1), counts.astype(np.float32), labels)
