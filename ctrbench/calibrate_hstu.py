"""The readings that a ``train_hstu`` cell's limits are set from, on the chip
at the cell's own size (``limits/<cell>.json`` keeps them beside each
limit), as ``calibrate_xdeepfm.py`` takes xDeepFM's.

    python3 -m ctrbench.calibrate_hstu --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 1] [--out FILE]

- the program: the cell run once for each of ``--seeds`` with a short
  window, in this process, each run's numbers (their largest is a limit's
  lower reading);
- the control: for each of ``--control-seeds``, the reference with TF32
  products put in the program's place, against the float32 reference on the
  same inputs, weights and seeds (its smallest reading is a limit's upper
  one);
- the faults: the same, with a fault planted in the reference put in the
  program's place (``reference.FAULTS``).

It prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import cells, checks, traffic_hstu
from .reference import hstu as reference
from .runners.train_hstu import reference_steps
from .traffic import dropout_seeds
from .weights_hstu import initial_leaves

SUBSTITUTES = ("tf32",) + reference.FAULTS


def substitute_readings(cell, seed: int, dev, substitute: str) -> tuple[dict, dict]:
    """``(numbers, detail)`` where ``substitute`` (the control ``tf32`` or a
    fault) stands in the program's place, against the reference, on the
    cell's first three steps of ``seed``, as the runner takes them."""
    cfg, tr = cell.config, cell.traffic
    sampler = traffic_hstu.sampler(cfg, tr, seed, dev)
    ids = traffic_hstu.train_chunk(sampler, cfg, tr, seed, 0)[:3]
    steps = reference_steps(ids, dropout_seeds(seed, 3), int(cfg["scan_steps"]))
    leaves0 = initial_leaves(cfg, seed, dev)
    ref = reference.train_reading(cfg, leaves0, steps)
    sub = reference.train_reading(
        cfg, leaves0, steps, precision="tf32" if substitute == "tf32" else "f32",
        fault=None if substitute == "tf32" else substitute)
    return checks.train_numbers(sub, ref), checks.train_detail(sub, ref)


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
        out["detail"][s] = res["detail"]
        print(json.dumps({"seed": s, "program": res["numbers"], "detail": res["detail"],
                          "rate": res["e2e"]["train_examples_per_s"],
                          "peak": res["memory_peak_bytes"]}), file=sys.stderr)
    for sub in SUBSTITUTES:
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
