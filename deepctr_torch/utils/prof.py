"""The program's tracing: host spans, counters, device phase stamps inside
captured graphs, and a trace of a run for its operator.

One process-wide switch, :func:`enable`, off by default. Off, :func:`span`
returns one shared no-op context after one global read, :func:`count` and
:func:`phase` return at once, and a graph captured then holds exactly the
nodes it holds without tracing. On:

- ``with span(name, **attrs):`` records a :class:`Span` in a bounded
  in-memory buffer, which counts what it drops. Its parent is the innermost
  span open on the thread, and its ``unit`` the outermost's id: every span
  of one scored request or one chunk carries that request's or chunk's id.
  Under an active ``torch.profiler`` it also enters
  ``torch.profiler.record_function(name)``, so that it lands on the
  profiler's timeline next to the device's events.
- ``count(name, n)`` adds ``n`` to a counter.
- ``phase(name)`` marks the end of a phase of a train step. While
  ``train/step.py``'s ``_ChunkGraph`` captures a graph it launches a
  one-thread kernel that writes the card's clock into the graph's
  :class:`PhaseRing` (``csrc/phase_stamp.cu``); the host reads the ring only
  at :func:`drain`. Inside :func:`marking` of a step on the CPU it records
  the host's clock, which there times the work itself. Anywhere else, an
  eager step on a card included (where the host's clock would time the
  enqueue), it records nothing.
- :func:`drain` returns the spans, counters and phase readings, and clears
  them.

Host times are ``time.perf_counter_ns()`` plus one offset taken at
:func:`enable`, onto the clock the profiler stamps its host events with
(``CLOCK_REALTIME``, ``time.time_ns()``): a span's start lies within a few
microseconds of its ``record_function``'s, so each idle gap of the device
in a profile can be put down to what the program was doing. Device stamps
are ``%globaltimer``; only their differences are read.

``trace(dir)`` is the operator's: ``train.profile_dir`` of the CLI.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
import weakref
from typing import NamedTuple

import numpy as np
import torch

# spans (and host phase marks) kept between two drains; the rest are counted
MAX_SPANS = 1 << 18
# a ring's rows: the replays of a 15 s window of the fastest graph (about
# 110 replays a second) fit, with room
RING_REPLAYS = 4096
# the most phases one step of a captured body may mark
PHASES_A_STEP = 8
# the phase mark that opens a unit (a step, or a replay of K steps): the
# time up to it is no phase's
START = "start"


class Span(NamedTuple):
    id: int
    parent: int | None   # the innermost span open on the thread when it began
    unit: int            # the outermost's id: one request's, one chunk's
    name: str
    start_ns: int        # on the profiler's host clock
    end_ns: int
    attrs: dict


class PhaseReading(NamedTuple):
    """One graph's device stamps since the last drain: a row a replay, in
    order, one column a slot, named by ``names``; ``lost`` replays were
    overwritten before they were read."""

    graph: int
    names: list
    steps: int           # train steps a replay
    stamps: np.ndarray   # int64 [replays, len(names)], ns
    lost: int


_ON = False
_NOOP = contextlib.nullcontext()
_OFFSET_NS = 0
_IDS = itertools.count(1)
_LOCAL = threading.local()
_LOCK = threading.Lock()
_SPANS: list[tuple] = []   # Span fields, as plain tuples
_MARKS: list[tuple[str, int]] = []   # host phase marks
_DROPPED = 0
_COUNTERS: collections.Counter = collections.Counter()
_RINGS: list[PhaseRing] = []
_STAMPING: PhaseRing | None = None   # the ring of the graph being captured


def enable(on: bool) -> None:
    """Turn tracing on or off for the process. Turning it on takes the
    offset from ``perf_counter_ns`` to the profiler's host clock."""
    global _ON, _OFFSET_NS
    if on and not _ON:
        _OFFSET_NS = _clock_offset()
    _ON = bool(on)


def enabled() -> bool:
    return _ON


def _clock_offset() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the closest of a few
    pairs of reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


def now_ns() -> int:
    """The host's clock, on the profiler's timeline."""
    return time.perf_counter_ns() + _OFFSET_NS


def _stack() -> list:
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


def _keep(buf: list, item) -> None:
    global _DROPPED
    if len(buf) < MAX_SPANS:
        buf.append(item)
    else:
        _DROPPED += 1


class _Open:
    """An open span. Its record is kept as a plain tuple, made a
    :class:`Span` at :func:`drain`: a tuple is the cheaper while the
    program runs."""

    __slots__ = ("name", "attrs", "id", "parent", "unit", "start", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        self.id = next(_IDS)
        if stack:
            outer = stack[-1]
            self.parent, self.unit = outer.id, outer.unit
        else:
            self.parent, self.unit = None, self.id
        stack.append(self)
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        else:
            self.rf = None
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _LOCAL.stack.pop()
        _keep(_SPANS, (self.id, self.parent, self.unit, self.name,
                       self.start + _OFFSET_NS, end + _OFFSET_NS, self.attrs))
        return False


def span(name: str, **attrs):
    """``with span("score.pad"): ...``: a host span (no-op when off)."""
    if not _ON:
        return _NOOP
    return _Open(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (no-op when off)."""
    if not _ON:
        return
    with _LOCK:
        _COUNTERS[name] += n


def phase(name: str) -> None:
    """Mark the end of the phase ``name`` of a train step (no-op when off).
    Inside a capture that :func:`stamping` names a ring, a device stamp;
    inside :func:`marking`, the host's clock; elsewhere nothing."""
    if not _ON:
        return
    if _STAMPING is not None:
        _STAMPING.stamp(name)
    elif getattr(_LOCAL, "marking", False):
        _keep(_MARKS, (name, now_ns()))


def _host_does_the_work(device) -> bool:
    return torch.device(device).type == "cpu"


class _Marking:
    __slots__ = ("was",)

    def __enter__(self):
        self.was = getattr(_LOCAL, "marking", False)
        _LOCAL.marking = True

    def __exit__(self, *exc):
        _LOCAL.marking = self.was
        return False


def marking(device):
    """``with marking(device):`` takes the block's :func:`phase` marks on the
    host's clock, where the step's ``device`` is the CPU and the host does
    its work (no-op when off, and on a card, where that clock would time
    the enqueue and not the work)."""
    if not _ON or not _host_does_the_work(device):
        return _NOOP
    return _Marking()


@contextlib.contextmanager
def stamping(ring: PhaseRing | None):
    """Send :func:`phase` to ``ring`` for the block: a graph's capture
    (nothing when None)."""
    global _STAMPING
    if ring is None:
        yield
        return
    _STAMPING = ring
    try:
        yield
    finally:
        _STAMPING = None


class PhaseRing:
    """The device stamps of one captured graph: a ring of ``replays`` rows,
    one a replay, of up to ``1 + steps · PHASES_A_STEP`` slots, and the
    count of replays begun (``ops/kernels/stamp.py`` says the layout). The
    slots' names are set as the capture marks them. ``owner`` is the graph:
    once it is gone the ring is read one last time at the next drain."""

    def __init__(self, steps: int, device, owner, replays: int = RING_REPLAYS):
        self.id = next(_IDS)
        self.steps = steps
        self.replays = replays
        self.buf = torch.zeros((replays + 1, 1 + steps * PHASES_A_STEP), dtype=torch.int64,
                               device=device)
        self.names: list[str] = []
        self.read = 0   # replays drained so far
        self.owner = weakref.ref(owner)
        with _LOCK:
            _RINGS.append(self)

    def stamp(self, name: str) -> None:
        from ..ops.kernels.stamp import phase_stamp

        slot = len(self.names)
        if slot >= self.buf.shape[1]:
            raise ValueError(f"more than {PHASES_A_STEP} phases a step in a graph of "
                             f"{self.steps} steps")
        if (slot == 0) != (name == START):
            raise ValueError(f"a replay's first phase mark is {START!r}, not {name!r}")
        self.names.append(name)
        phase_stamp(self.buf, slot)

    def take(self) -> PhaseReading:
        """The replays stamped since the last take, in one copy to the host
        (which waits for the device)."""
        host = self.buf.cpu().numpy()
        rows, first, lost = ring_rows(int(host[self.replays, 0]), self.read, self.replays)
        self.read = first + len(rows)
        return PhaseReading(self.id, list(self.names), self.steps,
                            host[rows][:, :len(self.names)], lost)


def ring_rows(begun: int, read: int, replays: int) -> tuple[list[int], int, int]:
    """``(rows, first, lost)``: the ring's rows of the replays numbered
    ``first ..`` ``begun - 1`` in order, where ``read`` were read before;
    when more than ``replays`` are new, the oldest ``lost`` of them were
    overwritten and are skipped."""
    lost = max(0, begun - read - replays)
    first = read + lost
    return [n % replays for n in range(first, begun)], first, lost


def phase_ms(marks) -> dict[str, float]:
    """Milliseconds by phase over ``(name, ns)`` marks in order: each mark
    but :data:`START` takes the time since the mark before it; marks before
    the first ``START`` take none."""
    ms: dict[str, float] = collections.defaultdict(float)
    prev = None
    for name, t in marks:
        if name != START and prev is not None:
            ms[name] += (int(t) - prev) / 1e6
        if name == START or prev is not None:
            prev = int(t)
    return dict(ms)


def reading_ms(r: PhaseReading) -> dict[str, float]:
    """Device ms by phase of ``r``, summed over its replays."""
    marks = []
    for row in r.stamps:
        marks += zip(r.names, row.tolist())
    return phase_ms(marks)


def drain() -> dict:
    """Everything recorded since the last drain, then cleared: ``spans``
    (:class:`Span`), ``dropped`` (spans and marks over the bound),
    ``counters``, ``phases`` (a :class:`PhaseReading` a graph captured with
    tracing on) and ``marks`` (the host's phase marks, ``(name, ns)``)."""
    global _DROPPED
    with _LOCK:
        # what another thread appends meanwhile stays for the next drain
        spans, marks = _SPANS[:len(_SPANS)], _MARKS[:len(_MARKS)]
        del _SPANS[:len(spans)], _MARKS[:len(marks)]
        spans = [Span._make(s) for s in spans]
        dropped, _DROPPED = _DROPPED, 0
        counters = dict(_COUNTERS)
        _COUNTERS.clear()
        rings = _RINGS[:]
        _RINGS[:] = [r for r in rings if r.owner() is not None]
    return {"spans": spans, "dropped": dropped, "counters": counters,
            "phases": [r.take() for r in rings], "marks": marks}


def summary(out: dict) -> dict:
    """A drained reading as JSON: the spans as lists, and each graph's
    device ms a step by phase (and the host marks' ms a step, from steps on
    the CPU)."""
    graphs = []
    for r in out["phases"]:
        steps = len(r.stamps) * r.steps
        graphs.append({"graph": r.graph, "replays": len(r.stamps), "steps": steps,
                       "lost": r.lost,
                       "ms_a_step": {k: v / steps for k, v in reading_ms(r).items()}
                       if steps else {}})
    host_steps = sum(name == START for name, _ in out["marks"])
    return {"spans": [list(s) for s in out["spans"]], "dropped": out["dropped"],
            "counters": out["counters"], "phases": graphs,
            "host_phases": {"steps": host_steps, "ms_a_step": {
                k: v / host_steps for k, v in phase_ms(out["marks"]).items()}
                if host_steps else {}}}


@contextlib.contextmanager
def trace(dir_path: str | None):
    """Capture a profiler trace of the host and, where there is a card, of
    the device into ``dir_path``, as ``trace_<pid>.json`` (no-op when
    None). Tracing is on for the block, so the Chrome trace holds the
    program's spans as annotations, and ``spans_<pid>.json`` beside it holds
    what :func:`drain` gives at the end (:func:`summary`)."""
    if not dir_path:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dir_path, exist_ok=True)
    was = _ON
    enable(True)
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        enable(was)
    prof.export_chrome_trace(os.path.join(dir_path, f"trace_{os.getpid()}.json"))
    with open(os.path.join(dir_path, f"spans_{os.getpid()}.json"), "w") as f:
        json.dump(summary(drain()), f)
