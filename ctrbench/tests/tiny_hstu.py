"""A checkout root of a tiny HSTU cell for the CPU tests: ``BENCHMARK.json``
and data files derived from the real ones (200 items, N 24, D 32, 2 blocks
of 2 heads of 16, 16 negatives, batch 16, K 4), beside the real cell whose
limits it takes."""

from __future__ import annotations

import copy
import json
import os

from ctrbench import cells

CELL = "tinyhstu.train_seq"
REAL = "hstu_ml20m.train_seq"
SEED = 2**31 + 31


def _read(*parts):
    with open(os.path.join(cells.ROOT, *parts)) as f:
        return json.load(f)


def _write(root, rel, obj):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def tiny_config() -> dict:
    small = {"items": 200, "max_sequence_length": 24, "item_embedding_dim": 32,
             "num_blocks": 2, "num_heads": 2, "dqk": 16, "dv": 16, "num_negatives": 16,
             "batch": 16, "scan_steps": 4}
    return dict(_read("ctrbench", "configs", "hstu_ml20m.json"), **small)


def tiny_traffic() -> dict:
    return dict(_read("ctrbench", "traffic", "train_seq.json"), length_median=9,
                length_mean=14, length_min=2, pool_chunks=3, profile_chunks=2,
                warmup_chunks=1)


def make_root(root: str) -> str:
    _write(root, "ctrbench/configs/tinyhstu.json", tiny_config())
    _write(root, "ctrbench/traffic/train_seq.json", tiny_traffic())
    bench = copy.deepcopy(_read("BENCHMARK.json"))
    bench["workloads"] = [{"name": CELL, "config": "tinyhstu", "traffic": "train_seq",
                           "chips": 1, "why": f"tiny {REAL}"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELL] if REAL in m["workloads"] else []
    _write(root, "BENCHMARK.json", bench)
    _write(root, f"ctrbench/limits/{CELL}.json", _read("ctrbench", "limits", f"{REAL}.json"))
    return root
