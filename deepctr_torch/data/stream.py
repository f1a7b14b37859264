"""Streaming training ingestion: bounded-RAM epochs over text/cached shards.

Copy of ``deepctr_tpu/data/stream.py`` (numpy and the data layer only; the
port imports nothing of the JAX package). Its behaviour is meant to be
identical, and ``tests/test_torch_stream.py`` holds it to the original. The
port's ``fit`` takes ``batches``; ``scan_chunks`` (the reference's
``lax.scan`` feed) comes along unused. Two additions serve the port's
multi-process runs (``parallel/group.py::RankLocalStream``):
``epoch_order``, the per-epoch permutation every process slices, and
``count_rows``, a shard's row count by the parsers' own rule, without
parsing. The original's text follows.

The reference loads the full dataset into host RAM and slices minibatches
(SURVEY.md §1 data layer, §3.1 hot loop) — fine for the bundled iPinYou
sample, impossible for the Criteo-scale stretch (BASELINE.json:11 "1TB-scale
hash space").  This module makes file-backed training honest at scale: an
epoch is a single pass over the shard files, parsed chunk by chunk through
the native C++ parser, with RAM bounded by ``buffer_rows + the prefetch
window`` regardless of dataset size.

Shuffling (the reference shuffles the whole in-RAM dataset per epoch) is
approximated the standard streaming way:

- **shard-level**: the file list is permuted per epoch (write many shard
  files for large datasets — the parser cost is per-byte, not per-file);
- **buffer-level**: a ``buffer_rows`` reservoir is kept full; each *round*
  draws ``R`` rows uniformly without replacement from the full reservoir
  (one host permutation + one vectorised gather), the holes are refilled
  from the stream — the tf.data ``shuffle(buffer_size)`` algorithm with the
  per-row sampling batched into rounds of ``R = draws · batch_size`` rows.

Epoch coverage is exact: every row of every shard is emitted exactly once
per epoch (a multiset-equality test gates this, tests/test_stream.py).

Round-4 redesign (VERDICT r3 Missing #3: the previous per-4-batch
``rng.choice`` + per-batch ``.copy()`` loop topped out at ~2.1M rows/s
against a device consuming ~4M ex/s):

- the reservoir is drained **half a buffer per permutation**: one
  ``rng.permutation(K)`` both selects the emitted R = K/2 rows and gives the
  survivor set for compaction (``perm[R:]``) — O(2) permutation entries and
  ~3 vectorised row-copies per emitted row, no ``setdiff1d``, no per-batch
  copies (batches are views into the round's gather);
- shard files are parsed on **background producer threads** (ordered,
  exactly-once, deterministic: file *i+1..i+prefetch_files* parse while the
  consumer drains file *i*; the C++ parser releases the GIL via ctypes), so
  parse overlaps buffer bookkeeping and — during training — device compute;
- ``scan_chunks`` assembles [T, B, S] dispatch chunks straight from the
  round gathers (a contiguous view when a round covers a whole chunk).

Wire-up: ``StreamSource`` plugs into both training loops (``fit(...,
train_source=...)`` and the sharded CLI loop) via two iterators —
``batches(epoch)`` for step-per-dispatch training and
``scan_chunks(epoch, scan_steps)`` for lax.scan-fused dispatch.

Multi-host: ``process_index``/``process_count`` give each host a disjoint
slice of the per-epoch shard permutation (union over processes == the full
epoch, still exactly-once globally) so no host parses another host's data
(SURVEY.md §2.4 multi-host row; VERDICT r3 Missing #4).
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import queue as _queue
import re
import threading
from collections import deque
from typing import Iterator, Sequence

import numpy as np

from .pipeline import Batch
from .schema import Schema


# lines the parsers skip, each with its newline, and the bytes such a line
# starts with (``count_rows``)
_BLANK_YX = (re.compile(rb"^[ \t\r]*\n", re.M), np.frombuffer(b" \t\r\n", np.uint8))
_BLANK_CRITEO = (re.compile(rb"^\r*\n", re.M), np.frombuffer(b"\r\n", np.uint8))


def expand_shards(pattern_or_paths) -> list[str]:
    """Expand a glob pattern / comma list / list into a sorted shard list."""
    if isinstance(pattern_or_paths, str):
        parts = [p for p in pattern_or_paths.split(",") if p]
    else:
        parts = list(pattern_or_paths)
    out: list[str] = []
    for p in parts:
        hits = sorted(_glob.glob(p))
        out.extend(hits if hits else [p])
    return out


@dataclasses.dataclass
class StreamStats:
    """Observability for the bounded-memory claim (asserted in tests)."""

    rows_emitted: int = 0
    peak_resident_rows: int = 0  # buffer + in-flight parsed chunks, high-water
    chunks_parsed: int = 0


@dataclasses.dataclass
class StreamSource:
    """Epoch iterator over text shards with bounded host memory.

    ``fmt``: "yx" | "criteo" (native C++ parser, Python fallback) or
    "yx-featindex" (make-ipinyou-data raw indices remapped through a
    FeatIndex; Python parser — the remap is id-space-wide).

    ``prefetch_files`` worker threads parse upcoming shard files while the
    consumer drains the current one (0 = parse inline).  Chunk delivery
    order — and therefore the emitted stream — is identical either way.

    ``process_index``/``process_count``: this process consumes shards
    ``perm[process_index::process_count]`` of the per-epoch global shard
    permutation.  All processes must use the same ``seed``.
    """

    paths: Sequence[str]
    schema: Schema
    batch_size: int
    fmt: str = "yx"
    buffer_rows: int = 1 << 18
    # 16 MB chunks: big enough that the per-chunk Python/GIL handoff costs
    # amortise away (measured 3.5M rows/s vs 2.4M at 4 MB on the 2-core
    # host); residency = buffer + prefetch-window x chunk rows, see stats
    chunk_bytes: int = 16 << 20
    seed: int = 0
    use_native: bool = True
    featindex: object = None  # FeatIndex, required for fmt="yx-featindex"
    drop_remainder: bool = True
    prefetch_files: int = 2
    prefetch_chunks: int = 2  # queue depth per in-flight file
    process_index: int = 0
    process_count: int = 1
    stats: StreamStats = dataclasses.field(default_factory=StreamStats)

    def __post_init__(self):
        self.paths = expand_shards(self.paths)
        if not self.paths:
            raise ValueError("StreamSource needs at least one shard path")
        if self.fmt == "yx-featindex" and self.featindex is None:
            raise ValueError("fmt='yx-featindex' requires featindex=")
        if self.fmt not in ("yx", "criteo", "yx-featindex"):
            raise ValueError(f"unknown stream format {self.fmt!r}")
        if not (0 <= self.process_index < self.process_count):
            raise ValueError(
                f"process_index {self.process_index} out of range for "
                f"process_count {self.process_count}"
            )
        self._lock = threading.Lock()
        self._inflight_rows = 0  # parsed rows not yet folded into the buffer

    # ---- parsing ----------------------------------------------------------

    def _parse(self, chunk: bytes):
        """bytes (whole lines) -> (labels float32[N], ids int32[N, S])."""
        if self.fmt == "yx-featindex":
            from . import featindex as fidx
            from .parser import pack_ids, raw_yx_rows

            lines = [ln for ln in chunk.splitlines() if ln.strip()]
            labels, rows = raw_yx_rows(lines)
            fi = self.featindex
            return labels, pack_ids(fi.remap_rows(rows), fi.schema)
        if self.use_native:
            try:
                from . import native

                if self.fmt == "criteo":
                    return native.parse_criteo_bytes(chunk, self.schema)
                return native.parse_yx_bytes(chunk, self.schema)
            except Exception:
                pass
        lines = [ln for ln in chunk.splitlines() if ln.strip()]
        if self.fmt == "criteo":
            from .criteo import parse_criteo_lines

            return parse_criteo_lines(lines, self.schema)
        from .parser import parse_yx_lines

        return parse_yx_lines(lines, self.schema)

    def _file_chunks(self, path: str):
        """Stream (labels, ids) arrays of ONE shard, a bounded chunk at a time.

        ``.npz`` shards (written by data/cache.py, uncompressed by default
        since round 4 — zlib inflate was the old lane's bottleneck) skip the
        text parse entirely — the multi-epoch fast lane: text is parsed once
        into cache shards, every epoch streams the packed arrays.  Residency
        for npz shards is one shard + the buffer (keep shards reasonably
        sized)."""
        if path.endswith(".npz"):
            from .cache import read_cache

            ids, labels, sch = read_cache(path)
            if sch.num_slots != self.schema.num_slots:
                raise ValueError(
                    f"cache shard {path} was packed with a different "
                    f"schema ({sch.num_slots} slots vs "
                    f"{self.schema.num_slots})"
                )
            rows_per_chunk = max(1, self.chunk_bytes // (4 * ids.shape[1]))
            for s in range(0, ids.shape[0], rows_per_chunk):
                chunk_ids = ids[s : s + rows_per_chunk]
                with self._lock:
                    self.stats.chunks_parsed += 1
                yield labels[s : s + rows_per_chunk], chunk_ids
            return
        for raw in self._line_chunks(path):
            labels, ids = self._parse(raw)
            if len(labels):
                with self._lock:
                    self.stats.chunks_parsed += 1
                yield labels, ids

    def _line_chunks(self, path: str) -> Iterator[bytes]:
        """A text shard's bytes, ``chunk_bytes`` at a time, cut at line
        ends; chunks of whitespace only are skipped."""
        with open(path, "rb") as f:
            tail = b""
            while True:
                raw = f.read(self.chunk_bytes)
                if not raw:
                    if tail.strip():
                        raw, tail = tail, b""
                    else:
                        break
                else:
                    raw = tail + raw
                    nl = raw.rfind(b"\n")
                    if nl < 0:
                        tail = raw
                        continue
                    raw, tail = raw[: nl + 1], raw[nl + 1 :]
                if not raw.strip():
                    continue
                yield raw

    def count_rows(self, path: str) -> int:
        """The rows ``batches`` takes from one shard, counted without
        parsing: a ``.npz`` shard's labels, or a text shard's lines that
        the parser of ``fmt`` keeps. A yx line is kept when it holds a byte
        other than space, tab and CR (the native parser's rule); a Criteo
        line when it is not empty once its trailing CRs are cut (the rule
        of its parsers, the native one falling back to the Python one on a
        line of blanks). Chunks are cut as ``_file_chunks`` cuts them."""
        if path.endswith(".npz"):
            with np.load(path) as z:
                return int(z["labels"].shape[0])
        blank, starts = _BLANK_CRITEO if self.fmt == "criteo" else _BLANK_YX
        rows = 0
        for raw in self._line_chunks(path):
            # every chunk but a shard's unterminated last line ends in "\n"
            if not raw.endswith(b"\n"):
                raw += b"\n"
            buf = np.frombuffer(raw, np.uint8)
            ends = np.flatnonzero(buf == ord("\n"))
            rows += ends.size
            # the regex scans at a tenth of numpy's rate: only where a line
            # starts with a byte that a blank line may start with
            heads = buf[np.concatenate(([0], ends[:-1] + 1))]
            if np.isin(heads, starts).any():
                rows -= len(blank.findall(raw))
        return rows

    def _chunks(self, paths: Sequence[str]):
        """Chunks of ``paths`` in order; parse runs ``prefetch_files`` files
        ahead on daemon threads (the emitted sequence is identical to the
        inline parse — workers are per-file and drained in submission
        order)."""
        if self.prefetch_files <= 0 or len(paths) <= 1:
            for p in paths:
                yield from self._file_chunks(p)
            return

        stop = threading.Event()
        window: deque = deque()
        path_iter = iter(paths)

        def start_one() -> None:
            p = next(path_iter, None)
            if p is None:
                return
            q: _queue.Queue = _queue.Queue(maxsize=max(1, self.prefetch_chunks))

            def work():
                try:
                    for labels, ids in self._file_chunks(p):
                        with self._lock:
                            self._inflight_rows += len(labels)
                        item = ("ok", (labels, ids))
                        while not stop.is_set():
                            try:
                                q.put(item, timeout=0.25)
                                break
                            except _queue.Full:
                                continue
                        if stop.is_set():
                            return
                except BaseException as e:  # propagate to the consumer
                    # same stop-aware retry loop as data items: a bounded
                    # timeout here could silently drop the error and leave
                    # the consumer blocked on q.get() forever (no sentinel)
                    item = ("err", e)
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.25)
                            break
                        except _queue.Full:
                            continue
                    return
                while not stop.is_set():
                    try:
                        q.put(None, timeout=0.25)  # end-of-file sentinel
                        break
                    except _queue.Full:
                        continue

            t = threading.Thread(target=work, daemon=True)
            t.start()
            window.append(q)

        try:
            for _ in range(self.prefetch_files):
                start_one()
            while window:
                q = window.popleft()
                while True:
                    item = q.get()
                    if item is None:
                        break
                    tag, payload = item
                    if tag == "err":
                        raise payload
                    yield payload
                    with self._lock:
                        self._inflight_rows -= len(payload[0])
                start_one()
        finally:
            stop.set()

    # ---- epoch iteration ---------------------------------------------------

    def epoch_order(self, epoch: int) -> list[str]:
        """The epoch's global shard permutation, the same in every process."""
        rng = np.random.default_rng(self.seed + epoch)
        return [self.paths[i] for i in rng.permutation(len(self.paths))]

    def _epoch_paths(self, epoch: int) -> list[str]:
        """Per-epoch shard order; each process takes a disjoint slice of the
        same global permutation (multi-host exactly-once)."""
        return self.epoch_order(epoch)[self.process_index :: self.process_count]

    def _runs(self, epoch: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yield shuffled (ids [R, S], labels [R]) runs, one epoch.

        Every run except the final drain is an exact multiple of
        ``batch_size``; rows within a run are freshly gathered (safe to view
        without copying downstream).
        """
        rng = np.random.default_rng(
            (self.seed + epoch) * (self.process_count + 1) + self.process_index
        )
        chunk_it = self._chunks(self._epoch_paths(epoch))

        B = self.batch_size
        K = max(self.buffer_rows, B)
        S = self.schema.num_slots
        buf_ids = np.empty((K, S), np.int32)
        buf_y = np.empty(K, np.float32)
        filled = 0
        pend_y = pend_ids = None
        pend_off = 0

        def refill() -> bool:
            """Top the buffer up to K; False once the stream is exhausted."""
            nonlocal filled, pend_y, pend_ids, pend_off
            while filled < K:
                if pend_y is None or pend_off >= len(pend_y):
                    try:
                        pend_y, pend_ids = next(chunk_it)
                    except StopIteration:
                        pend_y = pend_ids = None
                        return False
                    pend_off = 0
                    with self._lock:
                        self.stats.peak_resident_rows = max(
                            self.stats.peak_resident_rows,
                            K + len(pend_y) + self._inflight_rows,
                        )
                take = min(K - filled, len(pend_y) - pend_off)
                buf_ids[filled : filled + take] = pend_ids[
                    pend_off : pend_off + take
                ]
                buf_y[filled : filled + take] = pend_y[pend_off : pend_off + take]
                filled += take
                pend_off += take
            return True

        live = refill()
        # drain half the buffer per permutation: one O(K) permutation serves
        # R emitted rows AND the survivor list (perm[R:]) for compaction
        R = max(1, K // (2 * B)) * B
        while live and filled == K:
            perm = rng.permutation(K)
            sel = perm[:R]
            yield buf_ids[sel], buf_y[sel]
            keep = perm[R:]
            buf_ids[: K - R] = buf_ids[keep]
            buf_y[: K - R] = buf_y[keep]
            filled = K - R
            live = refill()

        # drain: the residual buffer gets a full shuffle, then one final run
        if filled:
            perm = rng.permutation(filled)
            yield buf_ids[perm], buf_y[perm]

    def batches(self, epoch: int) -> Iterator[Batch]:
        """Shard+buffer-shuffled fixed-shape minibatches, one epoch.

        Full batches are zero-copy views into the round gathers; consumers
        must treat them as read-only (device upload copies anyway).
        """
        B = self.batch_size
        S = self.schema.num_slots
        ones = np.ones(B, np.float32)
        for run_ids, run_y in self._runs(epoch):
            n = len(run_y)
            nfull = n // B
            for j in range(nfull):
                self.stats.rows_emitted += B
                yield Batch(
                    run_ids[j * B : (j + 1) * B],
                    run_y[j * B : (j + 1) * B],
                    ones,
                )
            rem = n - nfull * B
            if rem and not self.drop_remainder:  # only the final drain run
                pad = B - rem
                self.stats.rows_emitted += rem
                yield Batch(
                    ids=np.concatenate(
                        [run_ids[nfull * B :],
                         np.full((pad, S), self.schema.pad_id, np.int32)]
                    ),
                    labels=np.concatenate(
                        [run_y[nfull * B :], np.zeros(pad, np.float32)]
                    ),
                    weights=np.concatenate(
                        [np.ones(rem, np.float32), np.zeros(pad, np.float32)]
                    ),
                )

    def scan_chunks(
        self, epoch: int, scan_steps: int
    ) -> Iterator[tuple[int, tuple[np.ndarray, np.ndarray, np.ndarray]]]:
        """Stack ``scan_steps`` batches per dispatch: (nb, (ids, y, w)) with
        ids [T, B, S]; the last chunk is padded to T with weight-0 steps.

        Assembled straight from the round gathers: when a round has a whole
        [T·B]-row window left, the chunk is a contiguous reshape view (no
        copy); seams between rounds are stitched with one concatenate.
        """
        B, S, T = self.batch_size, self.schema.num_slots, scan_steps
        target = T * B
        ones_w = np.ones((T, B), np.float32)
        pending: deque = deque()  # (ids_run, y_run, offset); multiples of B
        held = 0

        def emit_full():
            nonlocal held
            ids_run, y_run, off = pending[0]
            if len(y_run) - off >= target:
                ids_t = ids_run[off : off + target].reshape(T, B, S)
                y_t = y_run[off : off + target].reshape(T, B)
                if len(y_run) - off - target > 0:
                    pending[0] = (ids_run, y_run, off + target)
                else:
                    pending.popleft()
            else:
                parts_i, parts_y, need = [], [], target
                while need > 0:
                    ids_run, y_run, off = pending[0]
                    take = min(need, len(y_run) - off)
                    parts_i.append(ids_run[off : off + take])
                    parts_y.append(y_run[off : off + take])
                    need -= take
                    if off + take == len(y_run):
                        pending.popleft()
                    else:
                        pending[0] = (ids_run, y_run, off + take)
                ids_t = np.concatenate(parts_i).reshape(T, B, S)
                y_t = np.concatenate(parts_y).reshape(T, B)
            held -= target
            self.stats.rows_emitted += target
            return T, (ids_t, y_t, ones_w)

        tail_pad = 0  # weight-0 rows padding the final drain sub-batch
        for run_ids, run_y in self._runs(epoch):
            n = (len(run_y) // B) * B
            rem = len(run_y) - n
            if rem and not self.drop_remainder:
                # only the final drain run is not a multiple of B: pad it to
                # a full batch of weight-0 rows (mirrors batches()) so those
                # rows still train — exactly-once holds for this setting too
                pad = B - rem
                run_ids = np.concatenate(
                    [run_ids[: n + rem],
                     np.full((pad, S), self.schema.pad_id, np.int32)]
                )
                run_y = np.concatenate(
                    [run_y[: n + rem], np.zeros(pad, np.float32)]
                )
                n += B
                tail_pad = pad
            if n == 0:
                continue
            pending.append((run_ids[:n], run_y[:n], 0))
            held += n
            while held >= target:
                if tail_pad and held == target:
                    # the padded batch is the stream's last: re-emit this
                    # (final, full) chunk with the pad rows weighted 0
                    nb, (ids_t, y_t, _) = emit_full()
                    w_t = np.ones(target, np.float32)
                    w_t[target - tail_pad :] = 0.0
                    self.stats.rows_emitted -= tail_pad
                    yield nb, (ids_t, y_t, w_t.reshape(T, B))
                else:
                    yield emit_full()

        if held:  # final partial chunk, padded to T no-op steps
            nb = held // B
            parts_i = [ids_r[off:] for ids_r, _, off in pending]
            parts_y = [y_r[off:] for _, y_r, off in pending]
            padb = T - nb
            ids_t = np.concatenate(
                parts_i + [np.full((padb * B, S), self.schema.pad_id, np.int32)]
            ).reshape(T, B, S)
            y_t = np.concatenate(
                parts_y + [np.zeros(padb * B, np.float32)]
            ).reshape(T, B)
            w_flat = np.concatenate(
                [np.ones(held, np.float32), np.zeros(padb * B, np.float32)]
            )
            if tail_pad:
                w_flat[held - tail_pad : held] = 0.0
            self.stats.rows_emitted += held - tail_pad
            yield nb, (ids_t, y_t, w_flat.reshape(T, B))
