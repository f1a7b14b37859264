"""Pre-tokenised binary cache format.

Copy of ``deepctr_tpu/data/cache.py``. The port imports nothing of the JAX
package, so it keeps this copy; its behaviour is meant to be
identical, and ``tests/test_torch_data.py`` holds it to the original.

SURVEY.md §7 ("host input pipeline throughput — text parsing will bottleneck
a v5e; needs pre-tokenized binary cache format"): after parsing a yx text
file once, persist the packed tensors so subsequent epochs/jobs are a single
mmap-able read instead of a re-parse.

Layout: ``<path>.npz`` containing ``ids`` (int32[N, S]), ``labels``
(float32[N]) and the schema JSON, plus a format version for forward compat.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .schema import Schema

_VERSION = 1


def write_cache(path: str, ids: np.ndarray, labels: np.ndarray, schema: Schema,
                compress: bool = False) -> None:
    """``compress=False`` (default since round 4): zlib inflate on every
    epoch's read was the streaming fast-lane's bottleneck (~2.1M rows/s);
    uncompressed npz reads at page-cache/memcpy speed.  Pass True to trade
    read speed for disk when archiving."""
    tmp = path + ".tmp.npz"
    (np.savez_compressed if compress else np.savez)(
        tmp,
        version=np.int64(_VERSION),
        ids=ids.astype(np.int32),
        labels=labels.astype(np.float32),
        schema=np.frombuffer(schema.to_json().encode(), dtype=np.uint8),
    )
    # np.savez appends .npz if missing; normalise
    src = tmp if os.path.exists(tmp) else tmp + ".npz"
    os.replace(src, path)


def read_cache(path: str) -> tuple[np.ndarray, np.ndarray, Schema]:
    with np.load(path) as z:
        if int(z["version"]) != _VERSION:
            raise ValueError(f"cache version mismatch: {int(z['version'])}")
        ids = z["ids"]
        labels = z["labels"]
        schema = Schema.from_json(bytes(z["schema"]).decode())
    return ids, labels, schema


def cache_text_file(
    path: str,
    schema: Schema,
    cache_path: str | None = None,
    fmt: str = "yx",
    use_native: bool = True,
) -> str:
    """Parse a text file (native parser when available) and persist the
    cache.  ``fmt`` selects the parser: ``yx`` (the reference's one-hot
    format) or ``criteo`` (raw TSV with the hash trick, data/criteo.py)."""
    cache_path = cache_path or path + ".cache.npz"
    if os.path.exists(cache_path) and os.path.getmtime(cache_path) >= os.path.getmtime(
        path
    ):
        return cache_path
    labels = ids = None
    if use_native:
        try:
            from . import native

            if fmt == "criteo":
                labels, ids = native.parse_criteo_file(path, schema)
            else:
                labels, ids = native.parse_yx_file(path, schema)
        except Exception:
            pass
    if ids is None:
        if fmt == "criteo":
            from .criteo import parse_criteo_file

            labels, ids = parse_criteo_file(path, schema, use_native=False)
        else:
            from . import parser

            labels, ids = parser.parse_yx_file(path, schema)
    write_cache(cache_path, ids, labels, schema)
    return cache_path


def cache_yx_file(
    yx_path: str, schema: Schema, cache_path: str | None = None, use_native: bool = True
) -> str:
    """Back-compat alias: ``cache_text_file(..., fmt="yx")``."""
    return cache_text_file(yx_path, schema, cache_path, fmt="yx",
                           use_native=use_native)
