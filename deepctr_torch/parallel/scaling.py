"""Weak scaling of the sharded train step: ``python -m deepctr_torch.parallel.scaling``.

For each N in ``--ranks`` (default 1,2,4), one ``torchrun --standalone
--nproc_per_node=N`` launch: one NCCL rank a GPU through ``group.py``
(``--device cuda``, the default), or gloo ranks on the CPU (``--device
cpu``). Each launch measures two things.

(a) A collective sweep: ``all_to_all_single`` and ``all_reduce`` on
    payloads of 64 KiB to 64 MiB a rank, in powers of 2. Each call is timed
    alone (CUDA events on the card, queued behind a sleep kernel so that
    they hold device time and not the host's dispatch; the host clock on
    the CPU); a size's time is the median of 20 calls after 5 warm-up
    calls, on the slowest rank. :func:`~deepctr_torch.parallel.comm.fit_links` fits the links to
    these points, and to nothing else.
(b) The sharded scan route's step, ``make_sharded_scan_train_step`` (one
    CUDA graph of K = 8 steps on the card), weak-scaled at 8192 rows a rank
    (the global batch is 8192 N), for each configuration: wall ms a step
    (host clock to a synchronize) and device ms a step (CUDA events) over 5
    chunks after a warm-up chunk that holds the capture, the slowest rank's;
    examples/s; occurrences dropped; the NCCL kernels' device µs a step by
    kernel name, from ``torch.profiler`` over 3 eager sharded steps (a
    graph's replay may not name them); and rank 0's device µs a step of
    the replay's largest kernels, from the profiler over one replay.

Configurations, at full width, each state made from a seed:
- ``criteo``: ``configs/criteo_sharded_stretch.json`` (``criteo_schema(
  1_000_000)``, 26,000,833 x 17 f32, sorted mode, tower 663-512-256-128
  tanh, dropout 0.5, capacity 2.0);
- ``criteo-2host``: the same with the reference's two-host recipe,
  ``capacity_factor=1.25`` and ``train.exchange_dtype=bf16``;
- ``fnn``: ``configs/fnn_full_ipinyou.json`` on ``ipinyou_full_schema()``,
  bf16 table, dense mode.

The record (``--out``, one JSON object) holds the cards' name and power
limit (``nvidia-smi``), ``nvidia-smi topo -m`` (null where the machine
refuses it) and ``topo -p2p n`` (which pairs of cards NVLink joins), which
cards reach each other's memory (peer access), the NCCL version, the sweep,
the steps, the fitted ``LinkModel``, and for each configuration and N > 1
``predict_scaling`` of the step's volume as the port sends it
(``comm.py::sent_volume``: int64 ids, rows in the narrower of the table's
and the wire's dtype) with ``t_comp_ms``
the configuration's N = 1 device ms, beside the measured step. A table of
them is printed. ``--small`` is the tool's own test: a tiny schema and
tower, 64 rows a rank, a sweep of 256 KiB to 4 MiB; on the CPU no number is
a device's (``device_ms``, ``nccl_us`` and ``replay_us`` are null).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .group import torchrun

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = {
    "criteo": ("configs/criteo_sharded_stretch.json", ["train.table_dtype=f32"]),
    "criteo-2host": ("configs/criteo_sharded_stretch.json",
                     ["train.table_dtype=f32", "train.capacity_factor=1.25",
                      "train.exchange_dtype=bf16"]),
    "fnn": ("configs/fnn_full_ipinyou.json",
            ["model.init_from=none", "train.table_dtype=bf16"]),
}
SMALL = ["model.k=3", "model.hidden=16,8"]
SEED = 0
ROWS_PER_RANK = 8192
SMALL_ROWS_PER_RANK = 64
SCAN_K = 8                # steps a chunk, the configs' train.scan_steps
TIMED_CHUNKS = 5
PROFILED_STEPS = 3
REPLAY_KERNELS = 16       # kernels of a replay's profile kept, by device µs a step
SWEEP_BYTES = [1 << p for p in range(16, 27)]           # 64 KiB .. 64 MiB
SMALL_SWEEP_BYTES = [1 << p for p in range(18, 23)]     # 256 KiB .. 4 MiB
SWEEP_CALLS, SWEEP_WARMUP = 20, 5
SLEEP_CYCLES = 20_000_000   # about 10 ms at the card's clock: the host's enqueue
LAUNCH_LIMIT_S = 1800


def _small_schema():
    from ..data import make_schema

    return make_schema([("a", 16), ("b", 48), ("c", 96), ("tags", 24, 2)])


def _slowest(values: list, group) -> list:
    """Every rank's values (a list of numbers or None), gathered; returns
    ``[the largest over the ranks of each entry, [each rank's list]]``."""
    every = [None] * group.world
    dist.all_gather_object(every, values)
    worst = [None if v is None else max(r[i] for r in every)
             for i, v in enumerate(values)]
    return [worst, every]


def _median_ms(fn, cuda: bool) -> float:
    """The median of SWEEP_CALLS calls of fn after SWEEP_WARMUP, each timed
    alone: between CUDA events on the card, by the host clock on the CPU.
    On the card a sleep kernel holds the stream while the host enqueues the
    timed calls, so that a call's events bracket its device time and not
    the host's dispatch (a graph's replay, which the model predicts, has
    none)."""
    for _ in range(SWEEP_WARMUP):
        fn()
    if not cuda:
        times = []
        for _ in range(SWEEP_CALLS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(SWEEP_CALLS)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def _sweep(group, sizes: list[int]) -> list[dict]:
    """The collective sweep of (a) in this world: one record a collective
    and payload."""
    cuda = group.device.type == "cuda"
    points, times = [], []
    for payload in sizes:
        x = torch.ones(payload // 4, dtype=torch.float32, device=group.device)
        out = torch.empty_like(x)
        for collective, fn in (("all_to_all", lambda: dist.all_to_all_single(out, x)),
                               ("all_reduce", lambda: dist.all_reduce(x))):
            dist.barrier()
            points.append((collective, payload))
            times.append(_median_ms(fn, cuda))
        del x, out
    worst, every = _slowest(times, group)
    return [{"collective": c, "ranks": group.world, "bytes": b, "ms": worst[i],
             "ms_by_rank": [r[i] for r in every]}
            for i, (c, b) in enumerate(points)]


def _case(name: str, small: bool):
    """(cfg, schema) of a configuration."""
    from .. import cli
    from ..config import RunConfig
    from ..data import ipinyou_full_schema

    path, overrides = CONFIGS[name]
    cfg = RunConfig.load(os.path.join(ROOT, path)).apply_overrides(
        overrides + (SMALL if small else []))
    if small:
        return cfg, _small_schema()
    return cfg, (ipinyou_full_schema() if cfg.data.format != "criteo"
                 else cli._load_schema_only(cfg))


def _device_us(run, calls: int, steps: int) -> dict:
    """Device µs a step of each kernel, by name, from ``torch.profiler``
    over ``calls`` calls of ``run`` (each of ``steps`` steps) after one call
    that starts the tracer, each call ended by a synchronize; largest
    first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    events = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls, repeat=1),
                 on_trace_ready=lambda p: events.extend(p.key_averages())) as prof:
        for _ in range(calls + 1):
            run()
            torch.cuda.synchronize()
            prof.step()
    out = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.key.startswith("ProfilerStep"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            name = e.key.replace("void ", "")[:80]
            out[name] = out.get(name, 0.0) + us / (calls * steps)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _step_case(name: str, group, small: bool) -> dict:
    """(b) for one configuration in this world."""
    from .. import cli
    from ..data import synthetic
    from .comm import DTYPE_BYTES, dense_param_bytes, sent_volume
    from .sharded import (
        init_sharded_state,
        make_sharded_scan_train_step,
        make_sharded_train_step,
    )

    dev = group.device
    cuda = dev.type == "cuda"
    cfg, schema = _case(name, small)
    rows = SMALL_ROWS_PER_RANK if small else ROWS_PER_RANK
    sopt, dopt = cli.build_optimizers(cfg)
    model = cli.build_model(cfg, schema, dev)
    sst = init_sharded_state(model, schema, sopt, dopt, group, seed=SEED,
                             table_dtype=cfg.train.table_dtype)
    kw = dict(l2=cfg.optim.l2, capacity_factor=cfg.train.capacity_factor,
              exchange_dtype=cfg.train.exchange_dtype)
    scan = make_sharded_scan_train_step(schema, sopt, dopt, group, **kw)
    step = make_sharded_train_step(schema, sopt, dopt, group, **kw)
    # this rank's rows: weak scaling, each rank its own 8192 a step
    ds = synthetic.generate(schema, num_examples=2 * SCAN_K * rows, k=cfg.model.k,
                            seed=SEED + 100 + group.rank)
    ids = torch.from_numpy(ds.ids).to(dev).long().view(2, SCAN_K, rows, -1)
    labels = torch.from_numpy(ds.labels).to(dev).view(2, SCAN_K, rows)
    weights = torch.ones(2, SCAN_K, rows, device=dev)
    chunks = [(ids[c], labels[c], weights[c]) for c in range(2)]
    del ds
    try:
        scan(sst, *chunks[0])   # warm-up: the capture on the card
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        dropped = []
        start = torch.cuda.Event(enable_timing=True) if cuda else None
        end = torch.cuda.Event(enable_timing=True) if cuda else None
        t0 = time.perf_counter()
        if cuda:
            start.record()
        for c in range(TIMED_CHUNKS):
            dropped.append(scan(sst, *chunks[c % 2])[1].dropped)
        if cuda:
            end.record()
            end.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / (TIMED_CHUNKS * SCAN_K)
        device_ms = start.elapsed_time(end) / (TIMED_CHUNKS * SCAN_K) if cuda else None
        peak_gib = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
        n_dropped = int(torch.stack(dropped).sum())
        dist.barrier()
        nccl = replay = None
        if cuda:
            # the NCCL kernels over eager steps, and where a replay's time goes
            def eager(order=iter(range(PROFILED_STEPS + 1))):
                i = next(order)
                step(sst, *(t[i] for t in chunks[1]))

            nccl = {k: v for k, v in _device_us(eager, PROFILED_STEPS, 1).items()
                    if "nccl" in k.lower()}
            replay = dict(list(_device_us(lambda: scan(sst, *chunks[1]), 1,
                                          SCAN_K).items())[:REPLAY_KERNELS])
        table = sst.model.table
        vol = sent_volume(schema, rows, group.world, cfg.train.capacity_factor,
                          dense_param_bytes(sst.model), row_dim=table.shape[1],
                          exchange_bytes=DTYPE_BYTES[cfg.train.exchange_dtype],
                          table_bytes=table.element_size())
    finally:
        scan.graph.clear()   # before the group ends (make_sharded_scan_train_step)
    every = [None] * group.world
    dist.all_gather_object(every, (wall_ms, device_ms, peak_gib, nccl))
    wall = max(r[0] for r in every)
    device, peak = ((max(r[1] for r in every), max(r[2] for r in every)) if cuda
                    else (None, None))
    if cuda:   # the slowest rank's time of each kernel any rank ran
        nccl = {k: max(r[3].get(k, 0.0) for r in every)
                for k in sorted(set().union(*(r[3] for r in every)))}
    ms = device if cuda else wall
    return {"config": name, "ranks": group.world, "rows_per_rank": rows,
            "global_batch": rows * group.world, "wall_ms": wall, "device_ms": device,
            "examples_per_s": rows * group.world / (wall / 1e3),
            "nccl_us": nccl,
            "replay_us": replay,
            "dropped_per_step": n_dropped / (TIMED_CHUNKS * SCAN_K),
            "volume": dataclasses.asdict(vol), "a2a_wire_bytes": vol.a2a_wire,
            "allreduce_wire_bytes": vol.psum_wire, "wire_bytes": vol.total_wire,
            "exchange_dtype": cfg.train.exchange_dtype,
            "capacity_factor": cfg.train.capacity_factor, "peak_gib": peak,
            "step_ms": ms}


def _worker(workdir: str, device: str, small: bool) -> None:
    """One rank of a launch: the sweep, then every configuration's step; rank
    0 writes ``<workdir>/ranks<N>.json``."""
    from .group import process_group

    with process_group(device) as group:
        out = {"sweep": _sweep(group, SMALL_SWEEP_BYTES if small else SWEEP_BYTES),
               "steps": []}
        for name in CONFIGS:
            out["steps"].append(_step_case(name, group, small))
            if group.device.type == "cuda":
                torch.cuda.empty_cache()
        if group.rank == 0:
            with open(os.path.join(workdir, f"ranks{group.world}.json"), "w") as f:
                json.dump(out, f)


def _smi(*args: str) -> str | None:
    try:
        return subprocess.run(["nvidia-smi", *args], check=True, capture_output=True,
                              text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def _device_record(device: str) -> dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": None, "count": None, "cards": None,
                "topology": None, "nvlink_p2p": None, "peer_access": None, "nccl": None,
                "torch": torch.__version__}
    cards = _smi("--query-gpu=name,power.limit", "--format=csv,noheader")
    count = torch.cuda.device_count()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "cards": cards.splitlines() if cards else None,
            "topology": _smi("topo", "-m"), "nvlink_p2p": _smi("topo", "-p2p", "n"),
            "peer_access": [[i == j or torch.cuda.can_device_access_peer(i, j)
                             for j in range(count)] for i in range(count)],
            "nccl": ".".join(map(str, torch.cuda.nccl.version())),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def predictions(sweep: list[dict], steps: list[dict]) -> tuple[dict, list[dict]]:
    """The fitted links (as a dict) and, for each configuration and N > 1,
    the predicted step beside the measured one."""
    from .comm import CommVolume, fit_links, predict_scaling

    links = fit_links(sweep)
    base = {s["config"]: s for s in steps if s["ranks"] == 1}
    out = []
    for s in steps:
        if s["ranks"] == 1 or s["config"] not in base:
            continue
        t1 = base[s["config"]]["step_ms"]
        pt = predict_scaling(CommVolume(**s["volume"]), t1, links=links)
        out.append({"config": s["config"], "ranks": s["ranks"], "t_comp_ms": t1,
                    "t_intra_ms": pt.t_intra_ms, "predicted_ms": pt.step_ms,
                    "measured_ms": s["step_ms"],
                    "error": pt.step_ms / s["step_ms"] - 1.0,
                    "efficiency_measured": t1 / s["step_ms"],
                    "efficiency_predicted_no_overlap": pt.efficiency_no_overlap,
                    "efficiency_predicted_overlapped": pt.efficiency_overlapped})
    return dataclasses.asdict(links), out


def _print_table(record: dict) -> None:
    pred = {(p["config"], p["ranks"]): p for p in record["predictions"]}
    print("config        N  wire MB  wall ms  device ms  examples/s  eff meas  "
          "eff pred  pred ms  err    NCCL us by kernel")
    for s in record["steps"]:
        p = pred.get((s["config"], s["ranks"]))
        dev = f"{s['device_ms']:9.4f}" if s["device_ms"] is not None else "     null"
        print(f"{s['config']:12s} {s['ranks']:2d} {s['wire_bytes'] / 1e6:8.3f} "
              f"{s['wall_ms']:8.4f} {dev} {s['examples_per_s']:11.0f}  "
              + (f"{p['efficiency_measured']:8.4f}  {p['efficiency_predicted_no_overlap']:8.4f}"
                 f" {p['predicted_ms']:8.4f} {100 * p['error']:+6.1f}%"
                 if p else "       -         -        -      -")
              + f"  {s['nccl_us']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m deepctr_torch.parallel.scaling",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: one NCCL rank a GPU; cpu: gloo ranks")
    ap.add_argument("--ranks", default="1,2,4", help="comma list of world sizes")
    ap.add_argument("--out", default="scaling.json", help="the record's path")
    ap.add_argument("--small", action="store_true",
                    help="a tiny schema, tower, batch and sweep: the tool's test")
    ap.add_argument("--workdir", help=argparse.SUPPRESS)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        _worker(args.workdir, args.device, args.small)
        return 0
    ranks = sorted({int(r) for r in args.ranks.split(",") if r})
    if args.device == "cuda":
        if torch.cuda.device_count() < max(ranks):
            raise SystemExit(f"--ranks {args.ranks} needs {max(ranks)} GPUs, one a rank; "
                             f"{torch.cuda.device_count()} here. Use --device cpu for "
                             f"gloo ranks")
        from ..ops.kernels import _build

        _build.compile_library()   # once, before the ranks load it
    record = {"tool": "deepctr_torch.parallel.scaling", "device": _device_record(args.device),
              "ranks": ranks, "configs": list(CONFIGS), "small": args.small,
              "rows_per_rank": SMALL_ROWS_PER_RANK if args.small else ROWS_PER_RANK,
              "scan_steps": SCAN_K, "timed_chunks": TIMED_CHUNKS,
              "sweep_calls": SWEEP_CALLS, "sweep": [], "steps": [], "launch_s": {}}
    with tempfile.TemporaryDirectory(prefix="deepctr_scaling_") as workdir:
        for n in ranks:
            wargs = ["-m", "deepctr_torch.parallel.scaling", "--worker",
                     "--workdir", workdir, "--device", args.device] + (
                         ["--small"] if args.small else [])
            _, _, _, seconds = torchrun(wargs, n, LAUNCH_LIMIT_S)
            record["launch_s"][n] = seconds
            with open(os.path.join(workdir, f"ranks{n}.json")) as f:
                part = json.load(f)
            record["sweep"] += part["sweep"]
            record["steps"] += part["steps"]
            print(f"scaling: {n} rank(s) measured in {seconds:.1f} s", flush=True)
    record["links"], record["predictions"] = (
        predictions(record["sweep"], record["steps"]) if max(ranks) > 1 else (None, []))
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({k: record["device"][k] for k in ("platform", "kind", "count",
                                                        "cards", "nccl")}))
    for key in ("topology", "nvlink_p2p"):
        if record["device"][key]:
            print(record["device"][key])
    print(f"peer access: {record['device']['peer_access']}")
    print(f"links fitted to the sweep: {record['links']}")
    _print_table(record)
    print(f"scaling: record written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
