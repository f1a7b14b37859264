"""A checkout root of a tiny DLRM-DCNv2 cell for the CPU tests:
``BENCHMARK.json`` and data files derived from the real ones (three tables
of 1-5 ids an example, width 8, cross rank 4, small MLPs, batch 64), beside
the real cell whose limits it takes."""

from __future__ import annotations

import copy
import json
import os

from ctrbench import cells

CELL = "tinydlrm.train_multihot"
REAL = "dlrm_dcnv2_criteo.train_multihot"
SEED = 2**31 + 23
SUBSTITUTES = ("tf32", "unchanged", "half_batch", "sparse_lr")


def _read(*parts):
    with open(os.path.join(cells.ROOT, *parts)) as f:
        return json.load(f)


def _write(root, rel, obj):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def tiny_config() -> dict:
    small = {"num_embeddings_per_feature": [40, 300, 7],
             "published_num_embeddings_per_feature": [320, 300, 7],
             "multi_hot_sizes": [3, 1, 5], "embedding_dim": 8, "num_dense": 13,
             "dense_arch_layer_sizes": [16, 8], "over_arch_layer_sizes": [24, 16, 1],
             "dcn_num_layers": 2, "dcn_low_rank_dim": 4, "batch": 64, "scan_steps": 4}
    return dict(_read("ctrbench", "configs", "dlrm_dcnv2_criteo.json"), **small)


def make_root(root: str) -> str:
    _write(root, "ctrbench/configs/tinydlrm.json", tiny_config())
    traffic = dict(_read("ctrbench", "traffic", "train_multihot.json"), pool_chunks=3,
                   profile_chunks=2, warmup_chunks=1)
    _write(root, "ctrbench/traffic/train_multihot.json", traffic)
    bench = copy.deepcopy(_read("BENCHMARK.json"))
    bench["workloads"] = [{"name": CELL, "config": "tinydlrm", "traffic": "train_multihot",
                           "chips": 1, "why": f"tiny {REAL}"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELL] if REAL in m["workloads"] else []
    _write(root, "BENCHMARK.json", bench)
    _write(root, f"ctrbench/limits/{CELL}.json", _read("ctrbench", "limits", f"{REAL}.json"))
    return root
