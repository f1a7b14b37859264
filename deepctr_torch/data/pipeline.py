"""Host-side input pipeline: fixed-shape minibatches, yx streaming, and the
device prefetcher.

Copy of ``minibatches``, ``epoch_iterator``, ``Batch`` and
``stream_yx_batches`` from ``deepctr_tpu/data/pipeline.py``. The port
imports nothing of the JAX package, so it keeps this copy; its behaviour is
meant to be identical, and ``tests/test_torch_data.py`` holds it to the
original. ``DevicePrefetcher`` is the reference's, written anew for CUDA
streams (its ``sharding`` and ``process_axis`` belong to the multi-GPU
runs, ROADMAP.md items 15-16).

- iterates packed ``(ids, labels)`` arrays in shuffled minibatches with a
  static batch size (last partial batch padded with pad_id rows and weight 0
  so every step sees one shape);
- can stream from yx text files through the native C++ parser chunk by chunk.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
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
    dense: np.ndarray | None = None  # float32[B, n], a model with dense inputs


def minibatches(
    ids: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    *,
    schema: Schema,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = False,
    dense: np.ndarray | None = None,
) -> Iterator[Batch]:
    """Yield fixed-shape minibatches over an in-memory packed dataset.
    ``dense`` (``[n, d]``, the port's: the reference has no dense inputs)
    goes with the ids into each batch's ``dense``, its pad rows 0."""
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
                dense=None if dense is None else np.concatenate(
                    [dense[sel], np.zeros((pad, dense.shape[1]), np.float32)]),
            )
        else:
            yield Batch(
                ids=ids[sel],
                labels=labels[sel],
                weights=np.ones(b, np.float32),
                dense=None if dense is None else dense[sel],
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


class DevicePrefetcher:
    """Background-thread staging of host batches onto ``device``.

    Overlaps host work (parse, shuffle, pack) and the host-to-device copy
    with the device's work: while step N runs, batches N+1 .. N+depth are
    being staged. Iterating it yields what the wrapped iterator yields,
    in order. Items are ``Batch``es, or the scan route's chunks
    ``(nb, (ids, labels, weights[, dense]))``, staged alike.

    On a CUDA device each item's arrays are copied into pinned host
    buffers from a small ring, then to the card with ``non_blocking`` copies
    on a side stream, followed by an event. The consumer's stream waits on
    that event before the batch is handed out, and each tensor is marked
    with ``record_stream`` so that the caching allocator does not give its
    memory to a later batch while the step still reads it. A ring slot is
    refilled only once its last copy has finished (the worker waits on the
    slot's event), so no buffer is pinned per batch. A batch that cannot be
    staged raises; nothing falls back to a synchronous copy. On the CPU
    batches pass through unchanged.

    An exception in the worker reaches the consumer. ``close()`` stops the
    worker (``fit`` calls it when an epoch ends or raises); the worker is a
    daemon thread, so a prefetcher abandoned by its consumer does not keep
    the process alive.
    """

    _DONE = object()

    def __init__(self, it, device, depth: int = 2):
        import torch

        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self._done = False
        if self._cuda:
            self._stream = torch.cuda.Stream(device=self._device)
            # a slot per queued batch and one being staged
            self._ring: list = [None] * (depth + 1)
        self._t = threading.Thread(target=self._work, args=(iter(it),), daemon=True)
        self._t.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self, it) -> None:
        try:
            for n, item in enumerate(it):
                if self._stop.is_set() or not self._put(
                        self._stage(item, n) if self._cuda else item):
                    return
        except BaseException as e:  # propagate to the consumer
            self._err = e
        finally:
            self._put(self._DONE)

    def _stage(self, item, n: int):
        import torch

        slot = n % len(self._ring)
        chunk = not isinstance(item, Batch)
        host = item[1] if chunk else tuple(
            a for a in (item.ids, item.labels, item.weights, item.dense) if a is not None)
        arrays = [torch.from_numpy(np.ascontiguousarray(a)) for a in host]
        pinned, event = self._ring[slot] or (None, None)
        if event is not None:
            event.synchronize()   # the slot's last copy has finished
        if pinned is None or any(p.shape != a.shape or p.dtype != a.dtype
                                 for p, a in zip(pinned, arrays)):
            pinned = [torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                      for a in arrays]
        for p, a in zip(pinned, arrays):
            p.copy_(a)
        with torch.cuda.stream(self._stream):
            staged = [p.to(self._device, non_blocking=True) for p in pinned]
            event = torch.cuda.Event()
            event.record(self._stream)
        self._ring[slot] = (pinned, event)
        return (item[0], tuple(staged)) if chunk else Batch(*staged), staged, event

    def close(self) -> None:
        """Stop the worker and wait for it (it stops between batches)."""
        self._stop.set()
        self._t.join()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._DONE if self._done else self._q.get()
        if item is self._DONE:
            self._done = True
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        if not self._cuda:
            return item
        import torch

        out, staged, event = item
        consumer = torch.cuda.current_stream(self._device)
        consumer.wait_event(event)
        for t in staged:
            t.record_stream(consumer)
        return out


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
