"""featindex importer: the make-ipinyou-data on-ramp for real iPinYou data.

Copy of ``deepctr_tpu/data/featindex.py``. The port imports nothing of the JAX
package, so it keeps this copy; its behaviour is meant to be
identical, and ``tests/test_torch_data.py`` holds it to the original.

Reference parity: the reference's README points users at
``wnzhang/make-ipinyou-data`` to produce its train/test yx files (SURVEY.md
§1 data-layer row, C1).  That pipeline also emits ``featindex.txt`` — one
line per one-hot feature, ``<field>:<value><TAB><index>`` — which *defines*
the global index space the yx files reference.  The reference only ever
needs ``xdim = max index + 1``; the TPU schema needs the field structure
(per-field embedding gathers, split-embedding planning, packed slots), so
this importer reconstructs it:

- fields ordered by first appearance in the file;
- per-field vocab = number of distinct values seen;
- a **remap** array old-global-index -> new contiguous global id
  (``schema.offsets[field] + local``).  make-ipinyou-data assigns indices in
  first-seen order *across* fields, so a field's index range is interleaved
  with other fields'; :class:`deepctr_torch.data.schema.Schema` requires
  contiguous per-field blocks (that is what makes static split plans and
  shard-local slices possible), hence the remap at ingest time.

With this module, dropping real make-ipinyou-data output next to a config is
enough: ``data.featindex_path=featindex.txt data.train_path=train.yx``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .parser import pack_ids, raw_yx_rows
from .schema import FieldSpec, Schema


@dataclasses.dataclass(frozen=True)
class FeatIndex:
    """A schema plus the old-index -> new-global-id remap."""

    schema: Schema
    remap: np.ndarray  # int32[old_space]; -1 marks unmapped old indices

    def remap_rows(self, rows: list[np.ndarray]) -> list[np.ndarray]:
        """Map per-row old-global-id lists into the schema's id space.

        Old ids outside the featindex (or negative) become -1, which
        ``pack_ids`` drops in lenient mode — matching the reference's
        behaviour of ignoring features absent from the training index.
        """
        n = self.remap.shape[0]
        out = []
        for gids in rows:
            ok = (gids >= 0) & (gids < n)
            mapped = np.where(ok, self.remap[np.clip(gids, 0, n - 1)], -1)
            out.append(mapped[mapped >= 0])
        return out


def parse_max_len_spec(spec: str) -> dict[str, int]:
    """Parse ``"usertag=3,foo=2"`` -> {"usertag": 3, "foo": 2} (CLI knob)."""
    out: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, n = part.partition("=")
        if not n:
            raise ValueError(f"bad max_len spec entry {part!r} (want name=N)")
        out[name.strip()] = int(n)
    return out


def load_featindex(
    path: str, max_len: dict[str, int] | str | None = None
) -> FeatIndex:
    """Read a make-ipinyou-data ``featindex.txt`` into (Schema, remap).

    Line format: ``<feat><whitespace><index>`` where ``feat`` is
    ``field:value`` (everything before the LAST colon is the field, so
    values containing colons — urls — stay intact).  Colon-less feats (the
    pipeline's special ``truncate``/``other`` entries) become single-value
    fields of their own: they are real features of the reference space and
    must keep a (trainable) embedding row.

    ``max_len``: per-field slot counts for multi-valued fields (e.g.
    ``{"usertag": 3}`` or the CLI string ``"usertag=3"``); default 1 slot.
    """
    if isinstance(max_len, str):
        max_len = parse_max_len_spec(max_len)
    max_len = max_len or {}

    field_order: list[str] = []
    field_values: dict[str, int] = {}        # field -> count of values seen
    entries: list[tuple[int, str, int]] = [] # (old_index, field, local)
    with open(path, "rb") as f:
        for raw in f:
            parts = raw.split()
            if len(parts) < 2:
                continue
            feat = parts[0].decode("utf-8", errors="replace")
            try:
                old = int(parts[-1])
            except ValueError:
                continue
            colon = feat.rfind(":")
            field = feat[:colon] if colon > 0 else feat
            if field not in field_values:
                field_order.append(field)
                field_values[field] = 0
            local = field_values[field]
            field_values[field] += 1
            entries.append((old, field, local))
    if not entries:
        raise ValueError(f"featindex file {path} contains no feature lines")

    fields = tuple(
        FieldSpec(name, field_values[name], max_len.get(name, 1))
        for name in field_order
    )
    schema = Schema(fields)
    offsets = {name: int(off) for name, off in
               zip(field_order, schema.offsets)}
    old_space = max(old for old, _, _ in entries) + 1
    remap = np.full(old_space, -1, dtype=np.int32)
    for old, field, local in entries:
        remap[old] = offsets[field] + local
    return FeatIndex(schema=schema, remap=remap)


def parse_yx_file(
    path: str, fi: FeatIndex, strict: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Parse a yx file whose indices live in the featindex's OLD space."""
    with open(path, "rb") as f:
        lines = f.read().splitlines()
    labels, rows = raw_yx_rows(lines, strict=strict)
    return labels, pack_ids(fi.remap_rows(rows), fi.schema, strict=strict)


def cache_yx_file(
    path: str, fi: FeatIndex, featindex_path: str,
    cache_path: str | None = None,
) -> str:
    """Parse + persist the packed cache (same .npz layout as data/cache.py).

    The cache is invalidated when either the yx file or the featindex file
    is newer — a regenerated featindex silently changes every id.
    """
    from .cache import write_cache

    cache_path = cache_path or path + ".fi.cache.npz"
    src_mtime = max(os.path.getmtime(path), os.path.getmtime(featindex_path))
    if os.path.exists(cache_path) and os.path.getmtime(cache_path) >= src_mtime:
        return cache_path
    labels, ids = parse_yx_file(path, fi)
    write_cache(cache_path, ids, labels, fi.schema)
    return cache_path
