"""Profiling helpers: a trace of a run, named scopes, a throughput meter.

Port of ``deepctr_tpu/utils/prof.py``. ``trace`` runs ``torch.profiler``
where the reference runs ``jax.profiler`` and writes a Chrome trace (open
it in Perfetto or ``chrome://tracing``); ``scope`` is
``torch.profiler.record_function``; ``ThroughputMeter`` is copied as it is.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(dir_path: str | None):
    """Capture a profiler trace of the host and, where there is a card, of
    the device into ``dir_path``, as ``trace_<pid>.json`` (no-op when
    None)."""
    if not dir_path:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dir_path, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(dir_path, f"trace_{os.getpid()}.json"))


def scope(name: str):
    """Named scope visible in profiles: ``with scope("lookup"): ...``"""
    return torch.profiler.record_function(name)


class ThroughputMeter:
    """Steady-state examples/s with a warmup cutoff."""

    def __init__(self, warmup_steps: int = 5):
        self.warmup_steps = warmup_steps
        self._steps = 0
        self._examples = 0
        self._t0: float | None = None

    def step(self, batch_size: int) -> None:
        self._steps += 1
        if self._steps == self.warmup_steps:
            self._t0 = time.perf_counter()
        elif self._steps > self.warmup_steps:
            self._examples += batch_size

    @property
    def examples_per_s(self) -> float:
        if self._t0 is None or self._examples == 0:
            return float("nan")
        return self._examples / (time.perf_counter() - self._t0)
