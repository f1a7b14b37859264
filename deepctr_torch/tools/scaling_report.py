"""Write SCALING_TORCH.md: the sharded step's exchange accounting, held to
the bytes the step sends, beside the step measured at 1, 2 and 4 GPUs.

The counterpart of ``tools/scaling_report.py``, which writes ``SCALING.md``
from the JAX package's accounting. Its sections:

1. Per-step exchange inventory: ``parallel/comm.py::sent_volume`` of
   full-width iPinYou FNN (``configs/fnn_full_ipinyou.json``, bf16 table,
   dense mode, 8192 rows a GPU, capacity 2.0, f32 wire) at N = 4, and of
   Criteo (``configs/criteo_sharded_stretch.json``, f32 26,000,833 x 17) and
   its two-host recipe (capacity 1.25, bf16 wire), with bytes an example.
2. Accounted against executed, the counterpart of the reference's
   ``hlo_validation``: in a world of N ranks the sharded train step, eval
   step and scan step (``make_sharded_train_step``,
   ``make_sharded_eval_step``, ``make_sharded_scan_train_step``) of FM and
   FNN run under ``parallel/sharded.py::record_collectives`` for every
   capacity factor of 1.0, 1.25 and 2.0, wire of f32 and bf16, and table of
   f32 and bf16, and every collective's bytes and calls are compared with
   ``sent_volume``'s closed forms on every rank. On the card the scan step's
   first call captures a CUDA graph, whose replays issue what the capture
   recorded: its captured collectives are K steps' and its warm-up step's
   one step's; on the CPU the K steps run eagerly. The three scalar
   all-reduces (weight sum, loss, dropped count) have their own row, since
   ``CommVolume`` counts none, as the reference's does not. Any mismatch
   raises once the file is written.
3. Within one host, measured beside predicted: the record of ``python -m
   deepctr_torch.parallel.scaling`` (run here unless ``--record`` names
   one): for ``criteo``, ``criteo-2host`` and ``fnn`` at each N, the wire
   MB a rank, the step measured (device ms from CUDA events on the card),
   ``predict_scaling``'s step from the record's N = 1 step and its fitted
   links, its error, and both efficiencies. The record's volumes must equal
   ``sent_volume``'s.
4. Across hosts: one box cannot measure a link between hosts, so no rate
   is assumed. For each recipe at 2 hosts x 4 GPUs: a host's bytes a step
   over that link, and the rate a host needs for
   ``efficiency_no_overlap`` to reach BASELINE.json:5's 85%, solved from
   the record's N = 1 step and the fitted links.

Every time stands beside the cards' name and power limit (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``), and the file ends
with the tool's stamp (``utils/artifacts.py::protocol_stamp``).

Usage:
  python -m deepctr_torch.tools.scaling_report                  # four cards
  python -m deepctr_torch.tools.scaling_report --ranks 1 --out S.md  # one card
  python -m deepctr_torch.tools.scaling_report --small --device cpu --out S.md
``--fast`` skips section 2; ``--small`` is the tool's own test (a tiny
schema and tower, 64 rows a rank, on ranks 1 and 2); ``--device cpu`` runs
gloo ranks on the CPU, where no number is a device's; ``--device cuda``
(the default) needs a GPU a rank and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch

from ..utils.artifacts import REPO_ROOT, protocol_stamp

TOOL = "deepctr_torch/tools/scaling_report.py"
INVENTORY_RANKS = 4
HOSTS, GPUS_PER_HOST = 2, 4
TARGET_EFFICIENCY = 0.85          # BASELINE.json:5, 1 -> 2 hosts
# the scalar all-reduces of a train step, in order: weight sum (f32), loss
# (f32), dropped count (int64)
SCALAR_BYTES = [4, 4, 8]
EXECUTED_MODELS = {"fm": ("configs/fm_k10.json", []),
                   "fnn": ("configs/fnn_full_ipinyou.json", ["model.init_from=none"])}
CAPACITY_FACTORS = (1.0, 1.25, 2.0)
DTYPES = ("f32", "bf16")
SEED = 0
LAUNCH_LIMIT_S = 1800


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------


def case_config(model: str, capacity_factor: float, exchange_dtype: str,
                table_dtype: str, small: bool):
    """(cfg, schema) of one executed-bytes case: FM or FNN at full iPinYou
    width, or on the scaling tool's tiny schema and tower."""
    from ..config import RunConfig
    from ..data import ipinyou_full_schema
    from ..parallel import scaling

    path, overrides = EXECUTED_MODELS[model]
    cfg = RunConfig.load(os.path.join(REPO_ROOT, path)).apply_overrides(
        overrides + [f"train.capacity_factor={capacity_factor}",
                     f"train.exchange_dtype={exchange_dtype}",
                     f"train.table_dtype={table_dtype}"]
        + (scaling.SMALL if small else []))
    return cfg, (scaling._small_schema() if small else ipinyou_full_schema())


def volume(cfg, schema, rows: int, n: int):
    """``sent_volume`` of a configuration's step at ``rows`` a rank over
    ``n`` ranks; the dense bytes and row width from its model built on the
    meta device (no memory)."""
    from .. import cli
    from ..parallel.comm import DTYPE_BYTES, dense_param_bytes, sent_volume

    model = cli.build_model(cfg, schema, "meta")
    return sent_volume(schema, rows, n, cfg.train.capacity_factor,
                       dense_param_bytes(model), row_dim=model.table.shape[1],
                       exchange_bytes=DTYPE_BYTES[cfg.train.exchange_dtype],
                       table_bytes=DTYPE_BYTES[cfg.train.table_dtype])


def _kind(c) -> str:
    """A recorded collective's row: the all-to-alls, the dense all-reduce,
    or the scalar all-reduces."""
    if c[0] == "all_to_all":
        return "all_to_all"
    return "scalar all_reduce" if not c[3] else "all_reduce"


def _step_bytes(vol, step: str) -> dict:
    """The bytes a step's collectives carry, call by call, by row."""
    if step == "eval":
        return {"all_to_all": [vol.ids_a2a, vol.rows_a2a_fwd], "all_reduce": [],
                "scalar all_reduce": []}
    return {"all_to_all": [vol.ids_a2a, vol.rows_a2a_fwd, vol.rows_a2a_bwd],
            "all_reduce": [vol.dense_psum], "scalar all_reduce": list(SCALAR_BYTES)}


def _by_kind(records) -> dict:
    out = {"all_to_all": [], "all_reduce": [], "scalar all_reduce": []}
    for c in records:
        out[_kind(c)].append(c[1])
    return out


def case_rows(case: dict) -> list[dict]:
    """The table rows of one case: for each step and row of collectives,
    the calls, the accounted bytes (``sent_volume``) and rank 0's executed
    bytes a rank, and ``match``: every rank issued exactly the accounted
    calls, each of the accounted bytes. A scan step's row is its K steps';
    where its first call captured a graph, the row reads the captured
    collectives, and its warm-up step's must be one step's too."""
    from ..parallel.comm import CommVolume

    vol = CommVolume(**case["volume"])
    label = (f"{case['model']} cf={case['capacity_factor']} wire={case['exchange_dtype']} "
             f"table={case['table_dtype']} N={case['ranks']}")
    k = case["scan_steps"]
    rows = []
    for step in ("train", "eval", "scan"):
        want = _step_bytes(vol, step)
        per_rank, warm_ok = [], True
        for records in case["records"][step]:
            if step == "scan":
                captured = [c for c in records if c[4]]
                if captured:   # a graph's capture, after one eager warm-up step
                    warm_ok &= _by_kind([c for c in records if not c[4]]) == want
                    records = captured
            per_rank.append(_by_kind(records))
        if step == "scan":
            want = {kind: b * k for kind, b in want.items()}
            how = "captured" if any(c[4] for r in case["records"]["scan"] for c in r) \
                else "eager"
            name = f"scan K={k} ({how})"
        else:
            name = step
        for kind in want:
            got = per_rank[0][kind]
            rows.append({"label": f"{name} {label}", "collective": kind,
                         "calls": len(got), "accounted": sum(want[kind]),
                         "executed": sum(got),
                         "match": warm_ok and all(r[kind] == want[kind] for r in per_rank)})
    return rows


def run_case(group, model: str, capacity_factor: float, exchange_dtype: str,
             table_dtype: str, small: bool, rows: int, data) -> dict:
    """One executed-bytes case in this world: a sharded train step, an eval
    step and a scan step's first call (a capture on the card) from a seeded
    state, each under ``record_collectives``; every rank's records gathered.
    ``data`` is this rank's ``(ids [K+1, rows, S], labels, weights)`` on the
    device. Releases the graph before it returns."""
    import torch.distributed as dist

    from .. import cli
    from ..parallel.sharded import (
        init_sharded_state,
        make_sharded_eval_step,
        make_sharded_scan_train_step,
        make_sharded_train_step,
        record_collectives,
    )

    cfg, schema = case_config(model, capacity_factor, exchange_dtype, table_dtype, small)
    sopt, dopt = cli.build_optimizers(cfg)
    sst = init_sharded_state(cli.build_model(cfg, schema, group.device), schema, sopt,
                             dopt, group, seed=SEED, table_dtype=table_dtype)
    kw = dict(l2=cfg.optim.l2, capacity_factor=capacity_factor,
              exchange_dtype=exchange_dtype)
    step = make_sharded_train_step(schema, sopt, dopt, group, **kw)
    eval_step = make_sharded_eval_step(schema, group, capacity_factor, exchange_dtype)
    scan = make_sharded_scan_train_step(schema, sopt, dopt, group, **kw)
    ids, labels, weights = data
    records = {}
    try:
        with record_collectives() as records["train"]:
            step(sst, ids[0], labels[0], weights[0])
        with record_collectives() as records["eval"]:
            eval_step(sst.model, ids[0])
        with record_collectives() as records["scan"]:
            scan(sst, ids[1:], labels[1:], weights[1:])
        if group.device.type == "cuda":
            torch.cuda.synchronize()
    finally:
        scan.graph.clear()   # before the group ends
    mine = {s: [(c.op, c.nbytes, str(c.dtype), list(c.shape), c.captured) for c in r]
            for s, r in records.items()}
    every = [None] * group.world
    dist.all_gather_object(every, mine)
    vol = volume(cfg, schema, rows, group.world)
    return {"model": model, "capacity_factor": capacity_factor,
            "exchange_dtype": exchange_dtype, "table_dtype": table_dtype,
            "ranks": group.world, "rows_per_rank": rows, "scan_steps": ids.shape[0] - 1,
            "volume": dataclasses.asdict(vol),
            "records": {s: [e[s] for e in every] for s in mine}}


def _rank_data(schema, cfg, rows: int, k: int, seed: int, device):
    """This rank's ``K + 1`` batches of ``rows``: the train and eval steps
    take the first, the scan step the other K."""
    from ..data import synthetic

    ds = synthetic.generate(schema, num_examples=(k + 1) * rows, k=cfg.model.k, seed=seed)
    ids = torch.from_numpy(ds.ids).to(device).long().view(k + 1, rows, -1)
    labels = torch.from_numpy(ds.labels).to(device).view(k + 1, rows)
    return ids, labels, torch.ones(k + 1, rows, device=device)


def executed_cases(group, small: bool, grid=None) -> list[dict]:
    """Every case of ``grid`` (default: FM and FNN x capacity factors x wire
    x table dtypes) in this world."""
    from ..parallel import scaling

    rows = scaling.SMALL_ROWS_PER_RANK if small else scaling.ROWS_PER_RANK
    grid = grid or [(m, cf, w, t) for m in EXECUTED_MODELS for cf in CAPACITY_FACTORS
                    for w in DTYPES for t in DTYPES]
    cfg, schema = case_config("fnn", 2.0, "f32", "f32", small)
    data = _rank_data(schema, cfg, rows, cfg.train.scan_steps, SEED + 100 + group.rank,
                      group.device)
    out = []
    for model, cf, wire, table in grid:
        out.append(run_case(group, model, cf, wire, table, small, rows, data))
        if group.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _executed_worker(workdir: str, device: str, small: bool) -> None:
    from ..parallel.group import process_group

    with process_group(device) as group:
        cases = executed_cases(group, small)
        if group.rank == 0:
            with open(os.path.join(workdir, f"executed{group.world}.json"), "w") as f:
                json.dump(cases, f)


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------


def inventory_section(small: bool) -> list[str]:
    from ..parallel import scaling

    rows = scaling.SMALL_ROWS_PER_RANK if small else scaling.ROWS_PER_RANK
    out = ["## Per-step exchange inventory\n"]
    for name, title in (("fnn", "headline: iPinYou FNN, bf16 table, dense mode, "
                         "capacity 2.0, f32 wire"),
                        ("criteo", "Criteo, f32 table, capacity 2.0, f32 wire"),
                        ("criteo-2host", "Criteo two-host recipe: capacity 1.25, "
                         "bf16 wire")):
        cfg, schema = scaling._case(name, small)
        vol = volume(cfg, schema, rows, INVENTORY_RANKS)
        out.append(f"### `{name}` ({title}; {schema.padded_vocab_size:,} x "
                   f"{vol.row_dim} table, {schema.num_slots} slots, {rows} rows a "
                   f"rank, N = {INVENTORY_RANKS}, capacity C = {vol.capacity:,})\n")
        out.append(vol.table())
        out.append(f"\nWire traffic a rank: {vol.bytes_per_example:.1f} bytes an "
                   f"example. Not counted above: 3 scalar all-reduces a train step "
                   f"({sum(SCALAR_BYTES)} bytes: weight sum, loss, dropped count).\n")
    return out


def executed_section(cases: list[dict]) -> tuple[list[str], list[dict]]:
    n = cases[0]["ranks"]
    out = [f"## Accounted against executed ({n} rank(s))\n",
           "Every collective the sharded steps issued under "
           "`parallel/sharded.py::record_collectives`, bytes a rank, against "
           "`parallel/comm.py::sent_volume`'s closed forms. `match` is `yes` only "
           "where every rank issued exactly the accounted calls, each of the "
           "accounted bytes (ids as int64, forward rows in the narrower of the "
           "table's and the wire's dtype, gradients at the wire's width). A scan "
           "row is its K steps'; `captured` means the collectives recorded inside "
           "a CUDA graph's capture (its warm-up step's, one step's, are checked "
           "too), `eager` K eager steps on the CPU.\n",
           "| step / config | collective | calls | accounted bytes/rank | "
           "executed bytes/rank | match |",
           "|---|---|---|---|---|---|"]
    rows = [r for case in cases for r in case_rows(case)]
    for r in rows:
        out.append(f"| {r['label']} | {r['collective']} | {r['calls']} | "
                   f"{r['accounted']:,} | {r['executed']:,} | "
                   f"{'yes' if r['match'] else 'NO'} |")
    out.append("")
    return out, rows


def _check_record_volumes(record: dict, small: bool) -> None:
    """The record's volume of each step equals ``sent_volume``'s."""
    from ..parallel import scaling

    for s in record["steps"]:
        cfg, schema = scaling._case(s["config"], small)
        want = dataclasses.asdict(volume(cfg, schema, s["rows_per_rank"], s["ranks"]))
        if s["volume"] != want:
            raise AssertionError(f"{s['config']} at N = {s['ranks']}: the record's "
                                 f"volume {s['volume']} is not sent_volume's {want}")


def measured_section(record: dict, where: str) -> list[str]:
    cuda = record["device"]["platform"] == "gpu"
    clock = ("device ms a step (CUDA events over the graph route's replays, the "
             "slowest rank)" if cuda else
             "wall ms a step on the host clock (gloo ranks on the CPU: no device time)")
    pred = {(p["config"], p["ranks"]): p for p in record["predictions"]}
    out = ["## Within one host, measured beside predicted\n",
           f"{where}. Weak scaling at {record['rows_per_rank']} rows a rank; measured: "
           f"{clock}. Predicted: `predict_scaling` with `t_comp` the record's own "
           f"N = 1 step and the links fitted to the record's collective sweep, no "
           f"overlap.\n",
           "| config | N | wire MB/rank/step | measured ms | predicted ms (error) | "
           "efficiency measured | efficiency predicted |",
           "|---|---|---|---|---|---|---|"]
    for s in sorted(record["steps"], key=lambda s: (s["config"], s["ranks"])):
        p = pred.get((s["config"], s["ranks"]))
        out.append(
            f"| {s['config']} | {s['ranks']} | {s['wire_bytes'] / 1e6:.3f} | "
            f"{s['step_ms']:.4f} | "
            + (f"{p['predicted_ms']:.4f} ({100 * p['error']:+.1f}%) | "
               f"{p['efficiency_measured']:.4f} | "
               f"{p['efficiency_predicted_no_overlap']:.4f} |" if p else
               "- | 1 | 1 |"))
    if record["links"]:
        lk = record["links"]
        out.append(f"\nFitted links: all-to-all {lk['a2a_bytes_per_s'] / 1e9:.1f} GB/s "
                   f"a rank and {lk['a2a_latency_s'] * 1e6:.1f} us a call; ring "
                   f"all-reduce {lk['allreduce_bytes_per_s'] / 1e9:.1f} GB/s and "
                   f"{lk['allreduce_latency_s'] * 1e6:.1f} us a call.\n")
    else:
        out.append("\nOne rank only: no sweep between cards, so no fit and no "
                   "prediction.\n")
    return out


def hosts_section(record: dict, small: bool, where: str) -> list[str]:
    from ..parallel import scaling
    from ..parallel.comm import DEFAULT_LINKS, LinkModel, inter_host_bytes, predict_scaling

    links = LinkModel(**record["links"]) if record["links"] else DEFAULT_LINKS
    source = ("the record's fitted links" if record["links"] else
              "`parallel/comm.py::DEFAULT_LINKS` (the record has no sweep between cards)")
    rows = record["rows_per_rank"]
    n = HOSTS * GPUS_PER_HOST
    out = ["## Across hosts\n",
           f"One box cannot measure a link between hosts, and `predict_scaling` "
           f"takes no default rate for one, so none is assumed here (the "
           f"reference's assumed link rates were not measured on these cards and "
           f"do not carry over). At {HOSTS} hosts x {GPUS_PER_HOST} GPUs, "
           f"{rows} rows a GPU: a host's bytes a step over the link between hosts "
           f"(`parallel/comm.py::inter_host_bytes`, the reference's per-host "
           f"accounting), and the rate a host needs for the no-overlap efficiency "
           f"to reach {TARGET_EFFICIENCY:.0%} (BASELINE.json:5), solved from "
           f"`t_comp` = the record's N = 1 step ({where}) and {source} within a "
           f"host.\n",
           "| config | t_comp ms | intra-host ms | inter-host bytes/host/step | "
           f"rate needed for {TARGET_EFFICIENCY:.0%} |",
           "|---|---|---|---|---|"]
    t1 = {s["config"]: s["step_ms"] for s in record["steps"] if s["ranks"] == 1}
    for name in scaling.CONFIGS:
        if name not in t1:
            continue
        cfg, schema = scaling._case(name, small)
        vol = volume(cfg, schema, rows, n)
        t_comp = t1[name]
        inter = inter_host_bytes(vol, HOSTS, GPUS_PER_HOST)
        intra = predict_scaling(vol, t_comp, links=links).t_intra_ms
        budget_s = (t_comp / TARGET_EFFICIENCY - t_comp - intra) / 1e3
        if budget_s > 0:
            rate = inter / budget_s
            pt = predict_scaling(vol, t_comp, HOSTS, GPUS_PER_HOST, links, rate)
            if abs(pt.efficiency_no_overlap - TARGET_EFFICIENCY) > 1e-9:
                raise AssertionError(f"{name}: {rate} B/s gives {pt}")
            need = f"{rate / 1e9:.2f} GB/s ({8 * rate / 1e9:.1f} Gbit/s)"
        else:
            need = (f"none: the exchange within a host alone holds it below "
                    f"{TARGET_EFFICIENCY:.0%}")
        out.append(f"| {name} | {t_comp:.4f} | {intra:.4f} | {inter:,} | {need} |")
    out.append("")
    return out


def write_report(out_path: str, record: dict, cases: list[dict] | None,
                 small: bool) -> list[dict]:
    """Write the report; returns the executed rows (empty under ``--fast``)."""
    cuda = record["device"]["platform"] == "gpu"
    if cuda:
        cards = record["device"]["cards"] or ["nvidia-smi not available"]
        where = (f"{record['device']['count']} x {cards[0]} (nvidia-smi name, power "
                 f"limit), NCCL {record['device']['nccl']}, torch {record['device']['torch']}")
    else:
        where = f"CPU, gloo ranks, no card; torch {record['device']['torch']}"
    lines = ["# SCALING_TORCH — the sharded step's exchange, accounted, executed and "
             "measured (deepctr_torch)\n",
             f"Cards: {where}. Generated by `python -m deepctr_torch.tools."
             f"scaling_report` on {time.strftime('%Y-%m-%d %H:%M')}"
             + (" (`--small`: a tiny schema and tower)" if small else "") + ".\n",
             "BASELINE.json:5 targets at least 85% examples/s weak-scaling efficiency "
             "from 1 to 2 hosts. The port's account of what its sharded step sends "
             "is `parallel/comm.py::sent_volume`; section 2 holds it to the bytes "
             "the step issues, section 3 sets `predict_scaling` beside the step "
             "measured on the cards, section 4 states what a second host would "
             "need.\n"]
    lines += inventory_section(small)
    rows = []
    if cases is not None:
        section, rows = executed_section(cases)
        lines += section
    lines += measured_section(record, where)
    lines += hosts_section(record, small, where)
    lines.append(f"Generated by {TOOL}. {protocol_stamp(TOOL)}\n")
    with open(out_path, "w") as f:
        f.write("\n".join(lines))
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m deepctr_torch.tools.scaling_report",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: one NCCL rank a GPU (default); cpu: gloo ranks")
    ap.add_argument("--ranks", help="world sizes of the measured sweep (default "
                    "1,2,4; with --small 1,2); section 2 runs at the largest")
    ap.add_argument("--record", help="a record of python -m "
                    "deepctr_torch.parallel.scaling to report, in place of running it")
    ap.add_argument("--fast", action="store_true", help="skip the executed bytes")
    ap.add_argument("--small", action="store_true",
                    help="a tiny schema, tower and batch: the tool's own test")
    ap.add_argument("--out", default=os.path.join(REPO_ROOT, "SCALING_TORCH.md"))
    ap.add_argument("--json", help="also write the record and the executed "
                    "collectives here")
    ap.add_argument("--workdir", help=argparse.SUPPRESS)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        _executed_worker(args.workdir, args.device, args.small)
        return {}
    from ..parallel import scaling
    from ..parallel.group import torchrun

    ranks = sorted({int(r) for r in (args.ranks or ("1,2" if args.small else "1,2,4"))
                    .split(",") if r})
    if args.device == "cuda" and torch.cuda.device_count() < max(ranks):
        raise SystemExit(f"--ranks {','.join(map(str, ranks))} needs {max(ranks)} GPUs, "
                         f"one a rank; {torch.cuda.device_count()} here. Use --device "
                         f"cpu for gloo ranks")
    if args.device == "cuda":
        from ..ops.kernels import _build

        _build.compile_library()   # once, before the ranks load it
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="deepctr_scaling_report_") as workdir:
        if args.record:
            with open(args.record) as f:
                record = json.load(f)
        else:
            path = os.path.join(workdir, "scaling.json")
            scaling.main(["--device", args.device, "--ranks", ",".join(map(str, ranks)),
                          "--out", path] + (["--small"] if args.small else []))
            with open(path) as f:
                record = json.load(f)
        _check_record_volumes(record, args.small)
        cases = None
        if not args.fast:
            n = max(ranks)
            wargs = ["-m", "deepctr_torch.tools.scaling_report", "--worker",
                     "--workdir", workdir, "--device", args.device] + (
                         ["--small"] if args.small else [])
            _, _, _, seconds = torchrun(wargs, n, LAUNCH_LIMIT_S)
            with open(os.path.join(workdir, f"executed{n}.json")) as f:
                cases = json.load(f)
            print(f"scaling_report: executed bytes of {len(cases)} cases on {n} rank(s) "
                  f"in {seconds:.1f} s", flush=True)
    rows = write_report(args.out, record, cases, args.small)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"record": record, "executed": cases}, f)
    bad = [r for r in rows if not r["match"]]
    for r in bad:
        print(f"MISMATCH {r}")
    print(f"scaling_report: wrote {args.out} in {time.perf_counter() - t0:.1f} s; "
          f"{len(rows) - len(bad)} of {len(rows)} executed rows match")
    if bad:
        raise AssertionError(f"{len(bad)} executed rows differ from sent_volume: {bad[:3]}")
    return {"record": record, "rows": rows}


if __name__ == "__main__":
    main()
