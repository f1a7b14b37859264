"""The readings that a cell's limits are set from, on the chip at the cell's
own size (``limits/<cell>.json`` keeps them beside each limit).

    python3 -m ctrbench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 1] [--out FILE]

- the program: the cell run once for each of ``--seeds`` with a short
  window, in this process, each run's numbers (their largest is a limit's
  lower reading);
- the control: for each of ``--control-seeds``, the reference with TF32
  products put in the program's place, against the float32 reference on the
  same inputs and weights (its smallest reading is a limit's upper one);
- the faults: the same, with a fault planted in the reference put in the
  program's place: training ``unchanged``, ``half_batch``, ``sparse_lr``
  (the table's update at half its rate) and, where the cell has several
  ranks, ``no_exchange``; scoring ``half_batch`` (a request's second half of
  rows answered from a zero logit), ``altered`` (each request's first answer
  replaced by its second's) and ``linear`` (the tower's activation left
  out).

It prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import cells, checks
from .reference import fnn as reference
from .traffic import (Fields, IdSampler, dropout_seeds, sample_requests, serve_requests,
                      train_chunk)
from .weights import initial_table, initial_tower

TRAIN_SUBSTITUTES = ("tf32", "unchanged", "half_batch", "sparse_lr", "no_exchange")
SERVE_SUBSTITUTES = ("tf32", "half_batch", "altered", "linear")


def _train_inputs(cell, seed: int, dev):
    cfg, tr = cell.config, cell.traffic
    world = int(tr.get("ranks", 1))
    b, k = int(cfg["batch"]), int(cfg["scan_steps"])
    sampler = IdSampler(Fields(cfg), float(tr["zipf_alpha"]), seed, dev)
    parts = [train_chunk(sampler, cfg, seed, r, 0, b) for r in range(world)]
    batches = [(torch.cat([p[0][t] for p in parts]), torch.cat([p[1][t] for p in parts]))
               for t in range(3)]
    seeds = dropout_seeds(seed, int(tr["pool_chunks"]) * k)[:3]
    return batches, seeds, world


def substitute_numbers(cell, seed: int, dev, substitute: str) -> dict:
    """The cell's numbers where ``substitute`` (the control ``tf32`` or a
    fault) stands in the program's place, against the reference."""
    return substitute_readings(cell, seed, dev, substitute)[0]


def substitute_readings(cell, seed: int, dev, substitute: str) -> tuple[dict, dict | None]:
    """``(numbers, detail)`` of :func:`substitute_numbers`; the detail
    (``checks.train_detail``) of a training cell, else None."""
    cfg = cell.config
    if cell.traffic["kind"] == "serve":
        from .runners.serve import probabilities

        requests = serve_requests(IdSampler(Fields(cfg), float(cell.traffic["zipf_alpha"]),
                                            seed, dev), cell.traffic, seed)
        sizes = [len(r) for r in requests]
        picked = [requests[i] for i in sample_requests(
            len(requests), sizes, int(cell.traffic["sample_requests"]), seed)]
        ref = probabilities(cfg, seed, dev, picked)
        if substitute == "tf32":
            sub = probabilities(cfg, seed, dev, picked, precision="tf32")
        elif substitute == "half_batch":
            sub = [np.concatenate([p[:len(p) // 2], np.full(len(p) - len(p) // 2, 0.5)])
                   for p in ref]
        elif substitute == "altered":
            sub = [np.concatenate([p[1:2], p[1:]]) if len(p) > 1 else p for p in ref]
        elif substitute == "linear":
            sub = probabilities(cfg, seed, dev, picked, fault="linear")
        else:
            raise ValueError(substitute)
        return {"score_gap": checks.serve_number([s.astype(np.float32) for s in sub], ref)}, None
    batches, seeds, world = _train_inputs(cell, seed, dev)
    table0, tower0 = initial_table(cfg, seed, dev), initial_tower(cfg, seed, dev)
    ref = reference.train_reading(cfg, table0, tower0, batches, seeds, ranks=world)
    sub = reference.train_reading(
        cfg, table0, tower0, batches, seeds, ranks=world,
        precision="tf32" if substitute == "tf32" else "f32",
        fault=None if substitute == "tf32" else substitute)
    return checks.train_numbers(sub, ref), checks.train_detail(sub, ref)


def substitutes(cell) -> tuple[str, ...]:
    if cell.traffic["kind"] == "serve":
        return SERVE_SUBSTITUTES
    if int(cell.traffic.get("ranks", 1)) > 1:
        return TRAIN_SUBSTITUTES
    return TRAIN_SUBSTITUTES[:-1]


def main(argv=None) -> int:
    from .runners import Context

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload)
    torch.set_num_threads(1)
    dev = "cuda:0" if torch.cuda.is_available() else "cpu"
    out = {"workload": args.workload,
           "kind": torch.cuda.get_device_name(0) if dev != "cpu" else "cpu",
           "program": {}, "detail": {}, "substitutes": {}}
    for s in [int(x) for x in args.seeds.split(",") if x]:
        ctx = Context(config=cell.config, traffic=cell.traffic, seed=s,
                      seconds=args.seconds, trace=False, device=dev,
                      t_start=time.perf_counter())
        res = cells.runner(cell.traffic["kind"]).run(ctx)
        out["program"][s] = res["numbers"]
        out["detail"][s] = res.get("detail")
        print(json.dumps({"seed": s, "program": res["numbers"], "detail": res.get("detail")}),
              file=sys.stderr)
    for sub in substitutes(cell):
        out["substitutes"][sub] = {}
        for s in [int(x) for x in args.control_seeds.split(",") if x]:
            numbers, detail = substitute_readings(cell, s, torch.device(dev), sub)
            out["substitutes"][sub][s] = numbers
            print(json.dumps({"seed": s, sub: numbers, "detail": detail}), file=sys.stderr)
    text = json.dumps(out, indent=1, default=float)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
