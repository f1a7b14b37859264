"""A checkout root of a tiny xDeepFM cell for the CPU tests:
``BENCHMARK.json`` and data files derived from the real ones (five one-hot
fields, k 4, a 6-6-6 CIN, an 8-8 DNN, batch 64), beside the real cell whose
limits it takes."""

from __future__ import annotations

import copy
import json
import os

from ctrbench import cells

CELL = "tinyxdeepfm.train_cin"
REAL = "xdeepfm_criteo.train_cin"
SEED = 2**31 + 29


def _read(*parts):
    with open(os.path.join(cells.ROOT, *parts)) as f:
        return json.load(f)


def _write(root, rel, obj):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def tiny_config() -> dict:
    small = {"fields": [["I1", 64, 1], ["I2", 64, 1], ["C1", 500, 1], ["C2", 300, 1],
                        ["C3", 1000, 1]],
             "k": 4, "cin_layer_sizes": [6, 6, 6], "dnn_hidden": [8, 8], "batch": 64,
             "scan_steps": 4}
    return dict(_read("ctrbench", "configs", "xdeepfm_criteo.json"), **small)


def make_root(root: str) -> str:
    _write(root, "ctrbench/configs/tinyxdeepfm.json", tiny_config())
    traffic = dict(_read("ctrbench", "traffic", "train_cin.json"), pool_chunks=3,
                   profile_chunks=2, warmup_chunks=1)
    _write(root, "ctrbench/traffic/train_cin.json", traffic)
    bench = copy.deepcopy(_read("BENCHMARK.json"))
    bench["workloads"] = [{"name": CELL, "config": "tinyxdeepfm", "traffic": "train_cin",
                           "chips": 1, "why": f"tiny {REAL}"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELL] if REAL in m["workloads"] else []
    _write(root, "BENCHMARK.json", bench)
    _write(root, f"ctrbench/limits/{CELL}.json", _read("ctrbench", "limits", f"{REAL}.json"))
    return root
