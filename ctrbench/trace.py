"""A traced run's profile, frozen here: ``torch.profiler`` over a bounded
slice of the window, reduced to what the per-layer readers take.

The slice starts once a third of the window has passed and covers a fixed
number of units of the run's traffic (chunks of steps, or requests); no
whole-window trace is written. Its reduction, per rank:

- ``window_s``: the host clock from the slice's start to its end, each
  taken with the device idle (after a synchronize);
- ``busy_s``: the device seconds in which some kernel, memcpy or memset
  ran: the union of their intervals, so that ops that overlap on
  different streams (NCCL beside the compute, a graph's parallel
  branches) count once;
- ``ops``: device seconds and launches by operation name;
- ``gaps``: the device's idle seconds within the slice, by the innermost
  host operation that was running at each gap's midpoint (what the host
  was doing while the device waited);
- ``placed``: whether the device events' places on the time line hold;
- ``busy_exact``: whether ``busy_s`` is exact (placed, or one stream).

Durations are read from the device's own clock. The start of a device event
on the host's time line is not always right: in some runs the profiler
placed a slice's 300 requests' kernels within 5 ms of each other. Ops on one
stream never overlap, so where a stream's intervals cover less than 99% of
its summed durations, or where the union is longer than the window, the
places are wrong. The union is then not read: ``busy_s`` is the busiest
stream's summed durations, exact where the device ran one stream and a lower
bound otherwise, ``placed`` is false, and the idle time is given as
``(device times not placed)``. A stream whose summed durations are longer
than the window is a fault of the reduction and raises.
"""

from __future__ import annotations

import bisect
import collections
import time

import torch

DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}
NO_HOST_OP = "(no traced host op)"
NOT_PLACED = "(device times not placed)"


class Slice:
    """The profiler over a bounded slice of a window (:class:`Pace` says
    when it starts and stops). With ``enabled`` the profiler is set up when
    the slice is made, before the window: setting it up takes seconds, and
    on several ranks inside the window it would leave the ranks waiting on
    each other in the slice's first collectives. It then only records from
    :meth:`start` to :meth:`stop`."""

    def __init__(self, device: torch.device, enabled: bool):
        self.device = device
        self.prof = None
        self.units = 0
        self.t0 = self.window_s = 0.0
        self.done = False
        if enabled:
            from torch.profiler import ProfilerActivity, profile, schedule

            activities = [ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            # step 0 warms up (the set-up happens here), step 1 records
            self.prof = profile(activities=activities,
                                schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
            self.prof.start()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self.prof.step()
        self.t0 = time.perf_counter()

    def stop(self, units: int) -> None:
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.step()
        self.units, self.done = units, True

    def close(self) -> None:
        """End the profiler where the slice never ran to its end."""
        if self.prof is not None and not self.done:
            self.prof.stop()
            self.done = True

    def reading(self) -> dict | None:
        if self.prof is None or self.units == 0:
            return None
        return reduce(self.prof, self.units, self.window_s)


class Pace:
    """What each unit of a window does, decided by rank 0's clock: ``go``,
    ``start`` (start the slice, then go), ``end`` (stop it, then go) or
    ``stop`` (the window is over). The slice starts once a third of the
    window has passed and lasts ``length`` units. With a ``store`` (a
    ``torch.distributed`` store) rank 0 publishes each decision and the
    other ranks follow it, so that every rank runs the same units."""

    def __init__(self, seconds: float, trace: bool, length: int, rank: int = 0,
                 store=None):
        self.seconds, self.trace, self.length = seconds, trace, length
        self.rank, self.store = rank, store
        self.t0 = 0.0
        self.started_at: int | None = None
        self.ended = False

    def begin(self) -> None:
        self.t0 = time.perf_counter()

    def step(self, n: int) -> str:
        if self.rank == 0:
            elapsed = time.perf_counter() - self.t0
            if elapsed >= self.seconds:
                act = "stop"
            elif self.trace and self.started_at is None and elapsed >= self.seconds / 3:
                act = "start"
            elif (self.started_at is not None and not self.ended
                  and n - self.started_at >= self.length):
                act = "end"
            else:
                act = "go"
            if self.store is not None:
                self.store.set(f"pace{n}", act)
        else:
            act = self.store.get(f"pace{n}").decode()
        if act == "start":
            self.started_at = n
        elif act == "end":
            self.ended = True
        return act

    def apply(self, act: str, n: int, sl: Slice) -> bool:
        """Start or stop ``sl`` as ``act`` says; False once the window is over
        (a slice still running is stopped there)."""
        if act == "start":
            sl.start()
        elif act == "end" or (act == "stop" and self.started_at is not None
                               and not self.ended):
            sl.stop(n - self.started_at)
            self.ended = True
        return act != "stop"


def _events(prof):
    """``(device ops, host ops)``, each a list of ``(name, start_ns, end_ns,
    stream)`` (the stream is None for host ops)."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        span = (e.name(), start, start + e.duration_ns())
        annotation = e.is_user_annotation()
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        # some torch releases' events have no ``activity_type``
        if hasattr(e, "activity_type"):
            is_device = e.activity_type() in DEVICE_KINDS
        else:
            is_device = on_device and not annotation
        if is_device:
            stream = (e.device_index(), getattr(e, "device_resource_id", lambda: None)())
            device.append(span + (stream,))
        elif not on_device and not annotation:
            host.append(span + (None,))
    return device, host


def _innermost(host, starts, t: float) -> str:
    """The name of the latest-starting host op that covers ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 512, -1), -1):
        if host[j][2] >= t:
            return host[j][0]
    return NO_HOST_OP


def _union(spans) -> list[tuple[int, int]]:
    """The disjoint intervals that ``spans`` cover, in order."""
    merged: list[list[int]] = []
    for _, s, e, *_ in sorted(spans, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _length_s(intervals) -> float:
    return sum(e - s for s, e in intervals) / 1e9


def _streams(device) -> dict:
    by = collections.defaultdict(list)
    for op in device:
        by[op[3]].append(op)
    return by


def placed(device) -> bool:
    """True where no stream's ops overlap each other on the time line (a
    stream runs one op at a time, so an overlap there is a misplaced event)."""
    for ops in _streams(device).values():
        summed = sum(e - s for _, s, e, _ in ops) / 1e9
        if _length_s(_union(ops)) < 0.99 * summed:
            return False
    return True


def reduce(prof, units: int, window_s: float) -> dict:
    device, host = _events(prof)
    return reduce_events(device, host, units, window_s)


def reduce_events(device, host, units: int, window_s: float) -> dict:
    ops = collections.defaultdict(lambda: [0.0, 0])
    for name, s, e, _ in device:
        ops[name][0] += (e - s) / 1e9
        ops[name][1] += 1
    covered = _union(device)
    busy = _length_s(covered)
    ok = placed(device) and busy <= window_s * 1.001
    if ok:
        gaps = _gaps(covered, host)
    else:
        busy = max((sum(e - s for _, s, e, _ in v) / 1e9
                    for v in _streams(device).values()), default=0.0)
        if busy > window_s * 1.001:
            raise RuntimeError(f"a stream ran {busy!r} s of ops in a slice of {window_s!r} s")
        gaps = {NOT_PLACED: window_s - busy}
    exact = ok or len(_streams(device)) <= 1
    return {"units": units, "window_s": window_s, "busy_s": busy, "placed": ok,
            "busy_exact": exact,
            "ops": {k: list(v) for k, v in ops.items()}, "gaps": gaps}


def _gaps(covered, host) -> dict:
    """The device's idle seconds between the intervals it ``covered``, within
    the traced spans, by the host op at each gap's midpoint."""
    ends = [e for _, _, e, _ in host] + [e for _, e in covered]
    if not ends:
        return {}
    t0 = min([s for _, s, _, _ in host] + [s for s, _ in covered])
    t1 = max(ends)
    host = sorted(host, key=lambda x: x[1])
    starts = [s for _, s, _, _ in host]
    gaps = collections.defaultdict(float)
    cursor = t0
    for s, e in covered + [(t1, t1)]:
        if s > cursor:
            gaps[_innermost(host, starts, (cursor + s) / 2)] += (s - cursor) / 1e9
        cursor = max(cursor, e)
    return dict(gaps)


def breakdown(readings: list[dict], top: int = 10) -> dict:
    """The slice's device ops and idle gaps, seconds averaged over the ranks,
    the largest ``top`` of each."""
    def mean_of(key):
        total = collections.defaultdict(float)
        for r in readings:
            for name, v in r[key].items():
                total[name] += (v[0] if isinstance(v, list) else v) / len(readings)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:160], seconds] for name, seconds in ranked]

    return {"device_ops": mean_of("ops"), "idle_gaps": mean_of("gaps")}
