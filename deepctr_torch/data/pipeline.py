"""Host-side input pipeline: fixed-shape minibatches and yx streaming.

Copy of ``minibatches``, ``epoch_iterator``, ``Batch`` and
``stream_yx_batches`` from ``deepctr_tpu/data/pipeline.py``. The port
imports nothing of the JAX package, so it keeps this copy; its behaviour is
meant to be identical, and ``tests/test_torch_data.py`` holds it to the
original. The reference's ``DevicePrefetcher`` stages batches with JAX and
is not copied.

- iterates packed ``(ids, labels)`` arrays in shuffled minibatches with a
  static batch size (last partial batch padded with pad_id rows and weight 0
  so every step sees one shape);
- can stream from yx text files through the native C++ parser chunk by chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from .schema import Schema


@dataclasses.dataclass
class Batch:
    """One packed minibatch. ``weights`` is 0.0 for padding rows (partial
    final batch) and 1.0 otherwise; every loss/metric must honour it."""

    ids: np.ndarray      # int32[B, S]
    labels: np.ndarray   # float32[B]
    weights: np.ndarray  # float32[B]


def minibatches(
    ids: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    *,
    schema: Schema,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = False,
) -> Iterator[Batch]:
    """Yield fixed-shape minibatches over an in-memory packed dataset."""
    n = ids.shape[0]
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for start in range(0, n, batch_size):
        sel = order[start : start + batch_size]
        b = sel.shape[0]
        if b < batch_size:
            if drop_remainder:
                return
            pad = batch_size - b
            yield Batch(
                ids=np.concatenate(
                    [ids[sel], np.full((pad, ids.shape[1]), schema.pad_id, np.int32)]
                ),
                labels=np.concatenate([labels[sel], np.zeros(pad, np.float32)]),
                weights=np.concatenate(
                    [np.ones(b, np.float32), np.zeros(pad, np.float32)]
                ),
            )
        else:
            yield Batch(
                ids=ids[sel],
                labels=labels[sel],
                weights=np.ones(b, np.float32),
            )


def epoch_iterator(
    ids: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    *,
    schema: Schema,
    num_epochs: int | None = None,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
) -> Iterator[tuple[int, Batch]]:
    """Yield ``(epoch, batch)`` over repeated shuffled epochs."""
    epoch = 0
    while num_epochs is None or epoch < num_epochs:
        for b in minibatches(
            ids,
            labels,
            batch_size,
            schema=schema,
            shuffle=shuffle,
            seed=seed + epoch,
            drop_remainder=drop_remainder,
        ):
            yield epoch, b
        epoch += 1


def stream_yx_batches(
    paths: Sequence[str],
    schema: Schema,
    batch_size: int,
    *,
    chunk_lines: int = 65536,
    use_native: bool = True,
) -> Iterator[Batch]:
    """Stream yx text files in bounded-memory chunks -> packed batches.

    Uses the native C++ parser when available, else the NumPy parser.
    """
    from . import parser as py_parser

    parse = py_parser.parse_yx_lines
    if use_native:
        try:
            from . import native

            parse = native.parse_yx_lines  # type: ignore[assignment]
        except Exception:
            pass

    carry_ids: list[np.ndarray] = []
    carry_labels: list[np.ndarray] = []
    carried = 0
    for path in paths:
        with open(path, "rb") as f:
            tail = b""
            while True:
                chunk = f.read(chunk_lines * 64)
                if not chunk:
                    if tail:
                        chunk, tail = tail, b""
                    else:
                        break
                else:
                    chunk = tail + chunk
                    # keep any partial final line for the next read
                    nl = chunk.rfind(b"\n")
                    if nl < 0:
                        tail = chunk
                        continue
                    chunk, tail = chunk[: nl + 1], chunk[nl + 1 :]
                lines = [ln for ln in chunk.splitlines() if ln.strip()]
                if not lines:
                    continue
                labels, ids = parse(lines, schema)
                carry_ids.append(ids)
                carry_labels.append(labels)
                carried += ids.shape[0]
                while carried >= batch_size:
                    all_ids = np.concatenate(carry_ids)
                    all_lab = np.concatenate(carry_labels)
                    yield Batch(
                        ids=all_ids[:batch_size],
                        labels=all_lab[:batch_size],
                        weights=np.ones(batch_size, np.float32),
                    )
                    carry_ids = [all_ids[batch_size:]]
                    carry_labels = [all_lab[batch_size:]]
                    carried -= batch_size
    if carried:
        all_ids = np.concatenate(carry_ids)
        all_lab = np.concatenate(carry_labels)
        pad = batch_size - carried
        yield Batch(
            ids=np.concatenate(
                [all_ids, np.full((pad, all_ids.shape[1]), schema.pad_id, np.int32)]
            ),
            labels=np.concatenate([all_lab, np.zeros(pad, np.float32)]),
            weights=np.concatenate(
                [np.ones(carried, np.float32), np.zeros(pad, np.float32)]
            ),
        )
