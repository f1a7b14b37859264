"""Finding a cell's pieces by name: ``BENCHMARK.json``, its configuration,
traffic mix and limits (data files), its runner and its metric readers
(modules). Nothing here imports torch."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json, with its "kind"
    limits: dict        # limits/<cell>.json: number -> {"limit": ...}
    end_to_end: list    # the end-to-end metrics this cell reports
    per_layer: list     # the per-layer metrics read in this cell


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its data files,
    which lie under ``<root>/ctrbench/``."""
    bench = _read(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(sorted(cells))})")
    w = cells[name]
    data = os.path.join(root, "ctrbench")
    config = _read(os.path.join(data, "configs", f"{w['config']}.json"))
    traffic = _read(os.path.join(data, "traffic", f"{w['traffic']}.json"))
    limits = _read(os.path.join(data, "limits", f"{name}.json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in reported and _applies(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=per_layer)


def runner(kind: str):
    """``runners/<kind>.py``."""
    return importlib.import_module(f"ctrbench.runners.{kind}")


def metric_reader(name: str):
    """``metrics/<name>.py``, loaded by its path (a metric's name may hold
    dots)."""
    path = os.path.join(PKG_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "ctrbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
