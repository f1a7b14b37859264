"""Criteo raw-format parser with hash-trick encoding.

Copy of ``deepctr_tpu/data/criteo.py``. The port imports nothing of the JAX
package, so it keeps this copy; its behaviour is meant to be
identical, and ``tests/test_torch_data.py`` holds it to the original.

The stretch config (BASELINE.json:11, "DeepFM-style FNN on Criteo 1TB-scale
hash space") needs data the reference never handled: Criteo's raw TSV
(``label \\t I1..I13 \\t C1..C26``, integer + hex-categorical columns, blanks
allowed).  Encoding follows the standard Criteo recipe:

- integer features: log-squash bucketing ``floor(log(x+1)^2)`` (negative /
  blank -> dedicated bucket), one small vocab per column;
- categorical features: deterministic 64-bit FNV-1a hash of the raw token
  modulo a per-column bucket count (the "hash trick") — the same hash on
  every host/restart, which the row-sharded tables rely on.

Produces a :class:`deepctr_torch.data.schema.Schema` (13 int + 26 cat fields)
and packed ``int32[B, 39]`` id tensors, directly consumable by every model
and by the sharded trainer.
"""

from __future__ import annotations

import math

import numpy as np

from .schema import FieldSpec, Schema

NUM_INT = 13
NUM_CAT = 26

_INT_BUCKETS = 64          # covers floor(log(x+1)^2) for x up to ~1e9, plus specials
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def criteo_schema(cat_buckets: int = 100_000) -> Schema:
    """13 bucketised integer fields + 26 hashed categorical fields."""
    fields = [FieldSpec(f"I{i+1}", _INT_BUCKETS) for i in range(NUM_INT)]
    fields += [FieldSpec(f"C{i+1}", cat_buckets) for i in range(NUM_CAT)]
    return Schema(tuple(fields))


def _int_bucket(tok: bytes) -> int:
    if not tok:
        return 0                      # missing
    try:
        v = int(tok)
    except ValueError:
        return 1                      # malformed
    if v < 0:
        return 2
    b = int(math.floor(math.log(v + 1.0) ** 2)) + 3
    return min(b, _INT_BUCKETS - 1)


def fnv1a64(data: bytes) -> int:
    """Deterministic 64-bit FNV-1a (stable across hosts/restarts/versions)."""
    h = _FNV_OFFSET
    for byte in data:
        h ^= byte
        h = (h * _FNV_PRIME) & _MASK64
    return h


def parse_criteo_lines(
    lines: list[bytes], schema: Schema
) -> tuple[np.ndarray, np.ndarray]:
    """Parse raw Criteo TSV lines -> (labels float32[B], ids int32[B, 39])."""
    cat_buckets = schema.fields[NUM_INT].vocab_size
    offsets = schema.offsets
    B = len(lines)
    labels = np.zeros(B, np.float32)
    ids = np.full((B, NUM_INT + NUM_CAT), schema.pad_id, np.int32)
    r = 0
    for line in lines:
        if isinstance(line, str):
            line = line.encode()
        line = line.rstrip(b"\r\n")
        if not line:
            continue
        cols = line.split(b"\t")
        labels[r] = float(cols[0] or 0)
        for i in range(NUM_INT):
            tok = cols[1 + i] if 1 + i < len(cols) else b""
            ids[r, i] = offsets[i] + _int_bucket(tok)
        for j in range(NUM_CAT):
            tok = cols[1 + NUM_INT + j] if 1 + NUM_INT + j < len(cols) else b""
            f = NUM_INT + j
            if tok:
                ids[r, f] = offsets[f] + fnv1a64(tok) % cat_buckets
            else:
                ids[r, f] = offsets[f]  # missing -> bucket 0
        r += 1
    return labels[:r], ids[:r]


def parse_criteo_file(
    path: str, schema: Schema, use_native: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    if use_native:
        try:
            from . import native

            return native.parse_criteo_file(path, schema)
        except Exception:
            pass
    with open(path, "rb") as f:
        return parse_criteo_lines(f.read().splitlines(), schema)


def write_synth_criteo_file(
    path: str,
    num_rows: int,
    schema: Schema | None = None,
    seed: int = 0,
    tokens_per_cat: int = 2000,
    k: int = 4,
    base_ctr: float = 0.2,
    noise: float = 0.5,
    teacher_seed: int | None = None,
) -> Schema:
    """Synthetic raw-format Criteo TSV with a PLANTED FM teacher.

    The environment ships no real Criteo data (SURVEY.md §0, zero egress),
    so scale rehearsals on the Criteo lane (BASELINE.json:11 stretch) use
    this writer: Zipf-popular hex-ish categorical tokens and heavy-tailed
    integers, with labels sampled from an FM teacher over the HASHED id
    space — exactly what a model consuming this file can learn — so
    held-out AUC is a meaningful quality signal, not noise.  ~15% of every
    column is blank (the raw format's missingness).  Returns the schema the
    teacher was planted against (same object shape as ``criteo_schema()``).

    ``teacher_seed`` (default: ``seed``) draws the token universes and the
    planted FM independently of the row draws, so a multi-shard corpus
    uses ONE consistent teacher (same teacher_seed) with disjoint rows
    (per-shard seed).
    """
    schema = schema or criteo_schema()
    cat_buckets = schema.fields[NUM_INT].vocab_size
    offsets = schema.offsets
    rng_t = np.random.default_rng(
        seed if teacher_seed is None else teacher_seed
    )
    rng = np.random.default_rng(seed)

    # token universes per categorical column; ids precomputed through the
    # same hash trick the parser applies, so the planted teacher sees the
    # ids a trained model will see
    cat_tokens: list[np.ndarray] = []
    cat_ids: list[np.ndarray] = []
    cat_probs: list[np.ndarray] = []
    for j in range(NUM_CAT):
        toks = np.array(
            [f"{rng_t.integers(0, 1 << 32):08x}"
             for _ in range(tokens_per_cat)]
        )
        ids = np.array(
            [offsets[NUM_INT + j] + fnv1a64(t.encode()) % cat_buckets
             for t in toks],
            np.int64,
        )
        ranks = np.arange(1, tokens_per_cat + 1, dtype=np.float64)
        p = ranks ** -1.05
        rng_t.shuffle(p)
        cat_tokens.append(toks)
        cat_ids.append(ids)
        cat_probs.append(p / p.sum())

    # integer columns: heavy-tailed counts; bucket ids via the parser's rule
    int_vals = rng.integers(0, 10_000, size=(num_rows, NUM_INT))
    int_vals = (np.exp(rng.normal(2.0, 2.0, size=(num_rows, NUM_INT)))
                ).astype(np.int64)
    int_missing = rng.random((num_rows, NUM_INT)) < 0.15
    int_buckets = np.minimum(
        np.floor(np.log(int_vals + 1.0) ** 2).astype(np.int64) + 3,
        _INT_BUCKETS - 1,
    )
    int_buckets[int_missing] = 0

    cat_choice = np.empty((num_rows, NUM_CAT), np.int64)
    cat_missing = rng.random((num_rows, NUM_CAT)) < 0.15
    for j in range(NUM_CAT):
        cat_choice[:, j] = rng.choice(tokens_per_cat, size=num_rows,
                                      p=cat_probs[j])

    ids = np.empty((num_rows, NUM_INT + NUM_CAT), np.int64)
    for i in range(NUM_INT):
        ids[:, i] = offsets[i] + int_buckets[:, i]
    for j in range(NUM_CAT):
        ids[:, NUM_INT + j] = np.where(
            cat_missing[:, j], offsets[NUM_INT + j],
            cat_ids[j][cat_choice[:, j]],
        )

    # planted FM teacher over the hashed vocab
    V = schema.vocab_size
    w = rng_t.normal(0.0, 0.3, size=V + 1).astype(np.float32)
    v = rng_t.normal(0.0, 0.3 / np.sqrt(k),
                     size=(V + 1, k)).astype(np.float32)
    lin = w[ids].sum(axis=1)
    vv = v[ids]
    s = vv.sum(axis=1)
    sq = (vv * vv).sum(axis=1)
    z = lin + 0.5 * (s * s - sq).sum(axis=1)
    z = (z - z.mean()) / (z.std() + 1e-9)
    b0 = float(np.log(base_ctr / (1 - base_ctr)))
    logits = b0 + 1.5 * z + rng.normal(0.0, noise, size=num_rows)
    labels = (rng.random(num_rows) < 1.0 / (1.0 + np.exp(-logits))).astype(
        np.int32
    )

    with open(path, "w") as f:
        for r in range(num_rows):
            cols = [str(labels[r])]
            for i in range(NUM_INT):
                cols.append("" if int_missing[r, i] else str(int_vals[r, i]))
            for j in range(NUM_CAT):
                cols.append("" if cat_missing[r, j]
                            else cat_tokens[j][cat_choice[r, j]])
            f.write("\t".join(cols) + "\n")
    return schema
