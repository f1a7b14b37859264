"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m ctrbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. It exits 2, and prints no result, where torch
sees no CUDA device or fewer than the cell asks for, and 3 where ``jax``,
``jaxlib``, ``flax`` or ``deepctr_tpu`` is loaded once the window has
closed. The last lines on standard error are the numbers that decided
``correct``, each beside its limit; the last line on standard output is the
result. With ``--trace 0`` its metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a profiled slice of the
window (``trace.py``) by ``metrics/<name>.py``.

The build and kernel caches of the program are kept inside the checkout,
under ``build/`` at fixed paths (the port builds its kernels into
``build/kernels``).
"""

from __future__ import annotations

import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started, from ``/proc`` (0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            after_name = f.read().rsplit(")", 1)[1].split()
        started = int(after_name[19]) / os.sysconf("SC_CLK_TCK")
        return max(0.0, time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

# caches at fixed paths inside the checkout, for whatever in the run would
# keep one (the port builds its kernels into build/kernels by itself)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TRITON_CACHE_DIR"] = os.path.join(_ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_ROOT, "build", "torch_extensions")
os.environ["OMP_NUM_THREADS"] = "1"

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402

from . import arith, cells, checks  # noqa: E402
from .trace import breakdown  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "deepctr_tpu"}


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that a run may not load, compared
    whole (``deepctr_torch`` is not ``deepctr_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


@dataclasses.dataclass
class TraceView:
    """What a per-layer reader reads: the cell's configuration and traffic,
    each rank's reduced slice (``trace.reduce``: ``ops``, ``busy_s``,
    ``window_s``, ``gaps``, and ``steps`` or ``requests``), and the card's
    peaks (None for a card missing from ``arith.PEAKS``)."""

    config: dict
    traffic: dict
    readings: list
    peak: dict | None


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str,
             root: str = cells.ROOT, t_start: float = T_START) -> dict:
    """Run the cell ``name`` on ``device`` and return its result line."""
    import torch

    from .runners import Context

    cell = cells.load_cell(name, root)
    ctx = Context(config=cell.config, traffic=cell.traffic, seed=int(seed),
                  seconds=float(seconds), trace=bool(trace), device=device, t_start=t_start)
    res = cells.runner(cell.traffic["kind"]).run(ctx)
    on_gpu = torch.device(device).type == "cuda"
    kind = torch.cuda.get_device_name(torch.device(device)) if on_gpu else "cpu"
    metrics = {}
    if trace:
        view = TraceView(cell.config, cell.traffic, res["readings"], arith.peak(kind))
        for m in cell.per_layer:
            value = cells.metric_reader(m["name"]).read(view) if view.readings else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": res["e2e"][m["name"]], "unit": m["unit"]}
    found, ok = checks.verdict(res["numbers"], cell.limits)
    dev = {"platform": "gpu" if on_gpu else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": ok and res["failed"] == 0, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": dev}
    if trace and res["readings"]:
        dev["busy_s"] = sum(r["busy_s"] for r in res["readings"]) / len(res["readings"])
        dev["window_s"] = sum(r["window_s"] for r in res["readings"]) / len(res["readings"])
        line["breakdown"] = breakdown(res["readings"])
    line["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                      for k, v in found.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"ctrbench: {args.workload} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0")
    bad = forbidden_modules()
    if bad:
        print(f"ctrbench: loaded {', '.join(bad)}; a run may not", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
