"""A checkout root of tiny cells for the CPU tests: ``BENCHMARK.json`` and
data files derived from the real ones (few fields, small vocabularies and
towers, batch 64), each tiny cell beside the real cell whose limits it
takes."""

from __future__ import annotations

import copy
import json
import os

from ctrbench import cells

# tiny cell -> (the real cell it stands for, its config, its traffic)
TINY = {
    "tiny.train": ("fnn_ipinyou.train", "tiny", "train"),
    "tiny.serve": ("fnn_ipinyou.serve", "tiny", "serve"),
    "tiny32.train": ("fnn_criteo.train", "tiny32", "train"),
    "tiny32.train2": ("fnn_criteo.train4", "tiny32", "train2"),
}
SEED = 2**31 + 11
# what each kind of cell can be broken by: the control and the faults
SUBSTITUTES = {"tiny.train": ("tf32", "unchanged", "half_batch", "sparse_lr"),
               "tiny32.train": ("tf32", "unchanged", "half_batch", "sparse_lr"),
               "tiny32.train2": ("tf32", "unchanged", "half_batch", "sparse_lr",
                                 "no_exchange"),
               "tiny.serve": ("tf32", "half_batch", "altered", "linear")}


def _read(*parts):
    with open(os.path.join(cells.ROOT, *parts)) as f:
        return json.load(f)


def _write(root, rel, obj):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_root(root: str) -> str:
    small = {"fields": [["a", 50, 1], ["b", 300, 1], ["c", 20, 3], ["d", 1000, 1]],
             "hidden": [24, 16], "batch": 64, "k": 4}
    ip = dict(_read("ctrbench", "configs", "fnn_ipinyou.json"), **small)
    cr = dict(_read("ctrbench", "configs", "fnn_criteo.json"), **small)
    _write(root, "ctrbench/configs/tiny.json", ip)
    _write(root, "ctrbench/configs/tiny32.json", cr)
    train = dict(_read("ctrbench", "traffic", "train.json"), pool_chunks=3, profile_chunks=2)
    train2 = dict(_read("ctrbench", "traffic", "train4.json"), pool_chunks=3,
                  profile_chunks=2, ranks=2)
    serve = dict(_read("ctrbench", "traffic", "serve.json"), pool_requests=64, size_min=1,
                 size_median=20, size_max=256, sample_requests=8, profile_requests=5)
    for name, t in (("train", train), ("train2", train2), ("serve", serve)):
        _write(root, f"ctrbench/traffic/{name}.json", t)
    bench = copy.deepcopy(_read("BENCHMARK.json"))
    real = {v[0]: k for k, v in TINY.items()}
    bench["workloads"] = [{"name": k, "config": c, "traffic": t,
                           "chips": 2 if t == "train2" else 1, "why": f"tiny {r}"}
                          for k, (r, c, t) in TINY.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [real[w] for w in m["workloads"] if w in real]
            # the sharded tiny cell reads what the one-chip training cells read
            if "tiny32.train" in m["workloads"] and "tiny32.train2" not in m["workloads"]:
                m["workloads"].append("tiny32.train2")
    _write(root, "BENCHMARK.json", bench)
    for k, (r, _, _) in TINY.items():
        _write(root, f"ctrbench/limits/{k}.json", _read("ctrbench", "limits", f"{r}.json"))
    return root
