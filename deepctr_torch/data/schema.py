"""Field schema for multi-field one-hot categorical data.

Copy of ``deepctr_tpu/data/schema.py``. The port imports nothing of the JAX
package, so it keeps this copy; its behaviour is meant to be
identical, and ``tests/test_torch_data.py`` holds it to the original.

The reference (SURVEY.md §2.3) consumes iPinYou-style data: ~16 categorical
fields (weekday, hour, user-agent, region, city, ad-exchange, domain, slot
id/w/h/visibility/format, price bucket, creative, user tags), each with
exactly one active feature index — except multi-valued fields such as user
tags, which may have a few.

TPU-native representation (BASELINE.json:5 "sparse one-hot feature encoding
-> packed per-field ID tensors"): a batch is a dense ``int32[B, S]`` tensor
of *global* feature ids, where ``S = sum(max_len over fields)`` is a static
slot count.  Unused slots hold ``schema.pad_id`` which maps to a frozen
all-zero embedding row, so every shape the compiler sees is static.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """One categorical field.

    vocab_size: number of distinct values (local index space ``0..vocab-1``).
    max_len:    static number of id slots reserved for this field in a packed
                batch (1 for one-hot fields, >1 for multi-valued fields like
                user tags).
    """

    name: str
    vocab_size: int
    max_len: int = 1


@dataclasses.dataclass(frozen=True)
class Schema:
    """Immutable description of the global feature space.

    Global feature id of local value ``v`` of field ``f`` is
    ``offsets[f] + v``.  This mirrors the reference's flat "yx" index space
    (SURVEY.md §1 data layer: lines are ``y idx:1 idx:1 ...`` with global
    indices), but keeps the field structure explicit so embeddings can be
    gathered per-field.
    """

    fields: tuple[FieldSpec, ...]

    @property
    def num_fields(self) -> int:
        return len(self.fields)

    @property
    def offsets(self) -> np.ndarray:
        """int64[F] global id offset of each field."""
        sizes = [f.vocab_size for f in self.fields]
        return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)

    @property
    def vocab_size(self) -> int:
        """Total number of real features across all fields (= reference xdim)."""
        return int(sum(f.vocab_size for f in self.fields))

    @property
    def pad_id(self) -> int:
        """Reserved id for empty slots; row ``pad_id`` of every table is zero."""
        return self.vocab_size

    @property
    def padded_vocab_size(self) -> int:
        """Rows every embedding table must have (vocab + 1 padding row)."""
        return self.vocab_size + 1

    @property
    def num_slots(self) -> int:
        return int(sum(f.max_len for f in self.fields))

    @property
    def slot_field(self) -> np.ndarray:
        """int32[S] field index that owns each packed slot."""
        out = []
        for i, f in enumerate(self.fields):
            out.extend([i] * f.max_len)
        return np.asarray(out, dtype=np.int32)

    @property
    def slot_offsets(self) -> np.ndarray:
        """int32[F] first slot of each field in the packed layout."""
        lens = [f.max_len for f in self.fields]
        return np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)

    def field_of_global_id(self, gid: np.ndarray) -> np.ndarray:
        """Vectorised global id -> field index (for parsing flat yx lines)."""
        bounds = np.cumsum([f.vocab_size for f in self.fields])
        return np.searchsorted(bounds, gid, side="right").astype(np.int32)

    # ---- (de)serialisation -------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(
            {
                "fields": [
                    {"name": f.name, "vocab_size": f.vocab_size, "max_len": f.max_len}
                    for f in self.fields
                ]
            },
            indent=2,
        )

    @staticmethod
    def from_json(text: str) -> "Schema":
        raw = json.loads(text)
        return Schema(
            tuple(
                FieldSpec(f["name"], int(f["vocab_size"]), int(f.get("max_len", 1)))
                for f in raw["fields"]
            )
        )


def make_schema(specs: Sequence[tuple[str, int] | tuple[str, int, int]]) -> Schema:
    """Convenience constructor: ``make_schema([("weekday", 8), ("tags", 70, 3)])``."""
    fields = []
    for spec in specs:
        if len(spec) == 2:
            name, vocab = spec  # type: ignore[misc]
            fields.append(FieldSpec(name, vocab, 1))
        else:
            name, vocab, max_len = spec  # type: ignore[misc]
            fields.append(FieldSpec(name, vocab, max_len))
    return Schema(tuple(fields))


def ipinyou_full_schema() -> Schema:
    """Full-iPinYou-scale feature space (~0.94M one-hot features).

    The reference's headline FNN config trains on "full iPinYou"
    (BASELINE.json:9) whose global one-hot dimension is ~937k, dominated by
    the user/url/domain tails.  Used by bench.py so the headline throughput
    is measured at representative vocabulary scale.
    """
    return make_schema(
        [
            ("weekday", 8),
            ("hour", 25),
            ("useragent", 48),
            ("region", 36),
            ("city", 400),
            ("adexchange", 6),
            ("domain", 300_000),
            ("url", 500_000),
            ("slotid", 120_000),
            ("slotwidth", 22),
            ("slotheight", 15),
            ("slotvisibility", 12),
            ("slotformat", 5),
            ("slotprice", 10),
            ("creative", 7_000),
            ("usertag", 70, 3),
        ]
    )


def ipinyou_like_schema() -> Schema:
    """A schema shaped like the iPinYou feature space the reference trains on.

    Field list per SURVEY.md §2.3 [recall-med]; vocab sizes are realistic
    orders of magnitude for campaign-level iPinYou data, used for synthetic
    data and benchmarking (real data replaces this via a featindex file).
    """
    return make_schema(
        [
            ("weekday", 8),
            ("hour", 25),
            ("useragent", 40),
            ("region", 36),
            ("city", 400),
            ("adexchange", 6),
            ("domain", 12000),
            ("url", 25000),
            ("slotid", 8000),
            ("slotwidth", 22),
            ("slotheight", 15),
            ("slotvisibility", 12),
            ("slotformat", 5),
            ("slotprice", 10),
            ("creative", 130),
            ("usertag", 70, 3),
        ]
    )
