"""Parsers for the reference's "yx" / libsvm one-hot text format.

Copy of ``deepctr_tpu/data/parser.py``. The port imports nothing of the JAX
package, so it keeps this copy; its behaviour is meant to be
identical, and ``tests/test_torch_data.py`` holds it to the original.

The reference's data layer (SURVEY.md §1, C3) reads text lines of the form::

    <label> <gid>:<val> <gid>:<val> ...

where ``gid`` is a *global* one-hot feature index and ``val`` is 1 (the
reference only ever emits ``:1``).  This module parses that format into the
packed ``int32[B, S]`` per-field id tensors of :mod:`deepctr_torch.data.schema`
(BASELINE.json:5 "sparse one-hot feature encoding -> packed per-field ID
tensors").

Two implementations:

- :func:`parse_yx_lines` — NumPy reference implementation.
- :func:`parse_yx_bytes_native` — C++ fast path (ctypes, built on demand by
  :mod:`deepctr_torch.data.native`), for the host-side streaming pipeline where
  text parsing is the likely bottleneck at TPU speeds (SURVEY.md §3.5c).

Both produce identical output (covered by tests/test_data.py).
"""

from __future__ import annotations

import numpy as np

from .schema import Schema


def pack_ids(
    gids_per_row: list[np.ndarray], schema: Schema, strict: bool = False
) -> np.ndarray:
    """Pack variable-length per-row global-id lists into ``int32[B, S]``.

    Each global id is routed to the slot range of the field it falls in;
    ids beyond a field's ``max_len`` are dropped (``strict=True`` raises
    instead).  Empty slots get ``schema.pad_id``.
    """
    B = len(gids_per_row)
    S = schema.num_slots
    out = np.full((B, S), schema.pad_id, dtype=np.int32)
    slot_base = schema.slot_offsets
    max_lens = np.asarray([f.max_len for f in schema.fields])
    for r, gids in enumerate(gids_per_row):
        gids = np.asarray(gids, dtype=np.int64)
        if gids.size == 0:
            continue
        fields = schema.field_of_global_id(gids)
        cursor = np.zeros(schema.num_fields, dtype=np.int64)
        for gid, f in zip(gids, fields):
            if f >= schema.num_fields or gid >= schema.vocab_size or gid < 0:
                if strict:
                    raise ValueError(f"global id {gid} out of vocab range")
                continue
            k = cursor[f]
            if k >= max_lens[f]:
                if strict:
                    raise ValueError(
                        f"field {schema.fields[f].name} overflow: >{max_lens[f]} ids"
                    )
                continue
            out[r, slot_base[f] + k] = gid
            cursor[f] += 1
    return out


def raw_yx_rows(
    lines: list[str] | list[bytes], strict: bool = False
) -> tuple[np.ndarray, list[np.ndarray]]:
    """Parse yx text lines -> (labels float32[B], per-row global-id lists).

    The unpacked form; callers that need a different global-id space (e.g.
    the featindex importer's remap) transform the lists before packing.
    """
    labels_list: list[float] = []
    rows: list[np.ndarray] = []
    for line in lines:
        if isinstance(line, bytes):
            line = line.decode("utf-8", errors="replace")
        parts = line.split()
        if not parts:  # blank lines are skipped (native parser semantics)
            continue
        try:
            label = float(parts[0])
        except ValueError:
            if strict:
                raise
            label = 0.0  # lenient mode matches the native digit-scanner
        labels_list.append(label)
        gids = []
        for tok in parts[1:]:
            colon = tok.rfind(":")
            gid_str = tok[:colon] if colon >= 0 else tok
            try:
                gids.append(int(gid_str))
            except ValueError:
                if strict:
                    raise
        rows.append(np.asarray(gids, dtype=np.int64))
    return np.asarray(labels_list, dtype=np.float32), rows


def parse_yx_lines(
    lines: list[str] | list[bytes], schema: Schema, strict: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Parse yx text lines -> (labels float32[B], ids int32[B, S])."""
    labels, rows = raw_yx_rows(lines, strict=strict)
    return labels, pack_ids(rows, schema, strict=strict)


def parse_yx_file(
    path: str, schema: Schema, strict: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        lines = f.read().splitlines()
    return parse_yx_lines(lines, schema, strict=strict)


def infer_flat_schema(paths: list[str], max_len_per_row: int | None = None):
    """Infer a single-field flat schema from raw yx files (reference behaviour:
    ``xdim = max_index + 1``, SURVEY.md C3) when no field map is available.

    Returns ``(Schema with one field, observed max ids-per-row)``.
    """
    from .schema import FieldSpec

    max_gid = -1
    max_row = 0
    for path in paths:
        with open(path, "rb") as f:
            for line in f:
                parts = line.split()
                n = 0
                for tok in parts[1:]:
                    colon = tok.rfind(b":")
                    gid = int(tok[:colon] if colon >= 0 else tok)
                    max_gid = max(max_gid, gid)
                    n += 1
                max_row = max(max_row, n)
    max_len = max_len_per_row if max_len_per_row is not None else max_row
    return Schema((FieldSpec("flat", max_gid + 1, max_len),)), max_row
