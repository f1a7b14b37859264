"""Fault drill of multi-process training: ``python -m deepctr_torch.parallel.drill``.

The port's analogue of ``tools/multihost_sim.py`` phases 3-5, under
``torchrun`` with one process per device (``--device cuda``, the default:
one rank per GPU, at least two; ``--device cpu``: two gloo ranks). Four
legs, each a set of ``torchrun`` launches in a work directory:

- ``kill``: two ranks train a tiny FM (row-sharded, Adagrad); host shards
  are saved after step 2 (``parallel/hostckpt.py``); rank 1 dies
  (``os._exit(13)``) and rank 0 attempts step 3, whose collective cannot
  complete. The launcher must exit non-zero within ``KILL_LIMIT_S`` with no
  ``done`` line printed. A fresh pair restores from the shard files, and its
  steps 3-4 must equal an uninterrupted 4-step run: losses and each rank's
  table shard, bit for bit.
- ``resume``: the CLI (``train.sharded=true train.distributed=true``, FNN
  with dropout 0.5) takes one epoch, then resumes from its host shards to
  two; its shard files must equal those of two epochs run straight through,
  key for key and bit for bit.
- ``stream``: the production shape in one run: a rank-local stream over
  three shards of unequal lengths, the bf16 wire, ``capacity_factor=1.25``
  and host shards, once with the prefetcher and once without. The two
  histories and shard files must be identical, and every epoch's
  ``epoch_steps`` event must give the step count and ``rows_skipped`` the
  shards' row counts give.
- ``scan``: the sharded scan route. From one state (FNN with dropout 0.5,
  Adam, ``capacity_factor=1.0``), two chunks of 8 steps, the second with 3
  weight-0 pad steps, through ``make_sharded_scan_train_step`` and the
  same 16 steps eagerly on a clone, on every rank: losses, dropped counts,
  the state and the generator bit for bit, the drops (pads included) the
  same on every rank. On the card the chunks are a captured graph's
  replays, with NCCL's collectives across the ranks inside; on the CPU
  both sides are eager steps.
The CLI legs take the configs' default ``train.scan_steps=8``, the
sharded scan route, too.

Any failure raises. ``--legs`` picks legs (default: all four).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LEGS = ("kill", "resume", "stream", "scan")
KILL_LIMIT_S = 60         # the launcher must give up on the dead rank by then
RUN_LIMIT_S = 300         # any other launch
SEED = 0
BATCH = 128               # the global batch; each of N ranks takes BATCH / N rows
STREAM_ROWS = (1100, 700, 500)   # the stream leg's shards, of unequal lengths


def _schema():
    from ..data import make_schema

    return make_schema([("a", 16), ("b", 48), ("c", 96), ("tags", 24, 2)])


# ---------------------------------------------------------------------------
# The kill leg's rank program
# ---------------------------------------------------------------------------


def _fm_worker(mode: str, workdir: str, device: str) -> None:
    """One rank of the kill leg: ``full`` (4 steps), ``crash`` (2 steps,
    save, rank 1 dies, rank 0 attempts step 3) or ``restore`` (load, steps
    3-4). Results go to ``<workdir>/<mode>_rank<r>.json``."""
    from ..data import Batch, synthetic
    from ..models import make_fm
    from ..optim import SparseAdagrad, make_dense_optimizer
    from . import (
        init_sharded_state,
        load_host_shards,
        local_batch,
        make_sharded_train_step,
        process_group,
        save_host_shards,
    )

    schema = _schema()
    ds = synthetic.generate(schema, num_examples=4 * BATCH, k=3, seed=SEED + 7)
    ckpt = os.path.join(workdir, "kill.hostshards")
    with process_group(device) as group:
        sopt, dopt = SparseAdagrad(0.1), make_dense_optimizer("sgd", 0.05)
        model = make_fm(schema, k=3, device=group.device)
        # the restored pair starts from other values, which the files replace
        seed = SEED + 1 if mode == "restore" else SEED
        state = init_sharded_state(model, schema, sopt, dopt, group, seed=seed)
        step = make_sharded_train_step(schema, sopt, dopt, group, capacity_factor=8.0)

        def run(lo, hi):
            losses = []
            for i in range(lo, hi):
                rows = slice(i * BATCH, (i + 1) * BATCH)
                b = local_batch(Batch(ds.ids[rows], ds.labels[rows],
                                      np.ones(BATCH, np.float32)), group, BATCH)
                _, m = step(state, b.ids, b.labels, b.weights)
                losses.append(float(m.loss))
            return losses

        if mode == "crash":
            run(0, 2)
            save_host_shards(ckpt, state, group, epoch=2)
            print(f"rank {group.rank}: host shards saved after step 2", flush=True)
            if group.rank == 1:
                os._exit(13)   # a rank's death, without cleanup
            run(2, 3)          # its collective cannot complete
            print("done", flush=True)   # must not happen
            return
        if mode == "restore":
            state, epoch = load_host_shards(ckpt, state, group)
            if epoch != 2 or state.step != 2:
                raise RuntimeError(f"restored epoch {epoch}, step {state.step}")
            losses = run(2, 4)
        else:
            losses = run(0, 4)
        shard = state.model.table.detach().cpu().numpy()
        out = {"losses": losses, "step": state.step,
               "table_sha256": hashlib.sha256(shard.tobytes()).hexdigest(),
               "table_sum": float(np.abs(shard).astype(np.float64).sum())}
        with open(os.path.join(workdir, f"{mode}_rank{group.rank}.json"), "w") as f:
            json.dump(out, f)


def _scan_worker(workdir: str, device: str) -> None:
    """One rank of the scan leg; results go to ``<workdir>/scan_rank<r>.json``."""
    from ..data import synthetic
    from ..models import MlpSpec, make_fnn
    from ..optim import SparseAdagrad, make_dense_optimizer
    from . import (
        init_sharded_state,
        local_chunk,
        make_sharded_scan_train_step,
        make_sharded_train_step,
        process_group,
    )
    from .sharded import state_tensors

    schema, k = _schema(), 8
    ds = synthetic.generate(schema, num_examples=2 * k * BATCH, k=3, seed=SEED + 9)
    ids = ds.ids.reshape(2, k, BATCH, -1)
    labels = ds.labels.reshape(2, k, BATCH)
    weights = np.ones((2, k, BATCH), np.float32)
    ids[1, 5:], labels[1, 5:], weights[1, 5:] = schema.pad_id, 0.0, 0.0
    with process_group(device) as group:
        sopt, dopt = SparseAdagrad(0.1), make_dense_optimizer("adam", 0.01)
        model = make_fnn(schema, k=3, mlp=MlpSpec(hidden=(16, 8), dropout=0.5),
                         device=group.device)
        state = init_sharded_state(model, schema, sopt, dopt, group, seed=SEED)
        scan = make_sharded_scan_train_step(schema, sopt, dopt, group,
                                            capacity_factor=1.0)
        step = make_sharded_train_step(schema, sopt, dopt, group, capacity_factor=1.0)
        g, e = state.clone(), state.clone()
        g_losses, g_drops, e_losses, e_drops = [], [], [], []
        for c in range(2):
            _, chunk = local_chunk((k, (ids[c], labels[c], weights[c])), group, BATCH)
            g, m = scan(g, *chunk)
            g_losses += m.losses.tolist()
            g_drops += m.dropped.tolist()
            for i in range(k):
                _, m = step(e, *(t[i] for t in chunk))
                e_losses.append(float(m.loss))
                e_drops.append(int(m.dropped))
        same = (g_losses == e_losses and g_drops == e_drops and g.step == e.step
                and all(torch.equal(a, b) for a, b in zip(state_tensors(g),
                                                           state_tensors(e)))
                and torch.equal(g.generator.get_state(), e.generator.get_state()))
        out = {"same": same, "graph": bool(scan.graph), "losses": g_losses,
               "dropped": g_drops, "step": g.step}
        scan.graph.clear()   # before the group ends (make_sharded_scan_train_step)
        with open(os.path.join(workdir, f"scan_rank{group.rank}.json"), "w") as f:
            json.dump(out, f)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def _torchrun(args: list[str], nproc: int, timeout: float, check: bool = True):
    """``torchrun --standalone --nproc_per_node=nproc ARGS`` from the
    repository's root; returns ``(exit code, stdout, stderr, seconds)``. Past
    ``timeout`` the launcher is sent SIGTERM, on which it stops its ranks,
    and ``RuntimeError`` raises with the end of their output."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={nproc}", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired as e:
        proc.terminate()
        try:
            out, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        raise RuntimeError(f"torchrun {' '.join(args)} did not end within {timeout} "
                           f"s:\n{out[-2000:]}\n{err[-4000:]}") from e
    seconds = time.perf_counter() - t0
    if check and proc.returncode != 0:
        raise RuntimeError(f"torchrun {' '.join(args)} exited {proc.returncode}:\n"
                           f"{out[-2000:]}\n{err[-4000:]}")
    return proc.returncode, out, err, seconds


def _worker_args(mode: str, workdir: str, device: str) -> list[str]:
    return ["-m", "deepctr_torch.parallel.drill", "--worker", mode,
            "--workdir", workdir, "--device", device]


def _read(workdir: str, mode: str, nproc: int) -> list[dict]:
    out = []
    for r in range(nproc):
        with open(os.path.join(workdir, f"{mode}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def leg_kill(workdir: str, device: str, nproc: int) -> None:
    _torchrun(_worker_args("full", workdir, device), nproc, RUN_LIMIT_S)
    rc, out, _, seconds = _torchrun(_worker_args("crash", workdir, device), nproc,
                                    KILL_LIMIT_S, check=False)
    print(f"drill kill: rank 1 died after step 2; the launcher exited {rc} in "
          f"{seconds:.1f} s (limit {KILL_LIMIT_S} s)")
    if rc == 0 or "done" in out.split():
        raise RuntimeError(f"the run with a dead rank did not fail (exit {rc}):\n"
                           f"{out[-2000:]}")
    shards = sorted(os.listdir(os.path.join(workdir, "kill.hostshards")))
    if shards != [f"proc{r}.npz" for r in range(nproc)]:
        raise RuntimeError(f"host shard files {shards}")
    _torchrun(_worker_args("restore", workdir, device), nproc, RUN_LIMIT_S)
    full, restored = _read(workdir, "full", nproc), _read(workdir, "restore", nproc)
    for r, (a, b) in enumerate(zip(full, restored)):
        same = (a["losses"][2:] == b["losses"] and a["step"] == b["step"] == 4
                and a["table_sha256"] == b["table_sha256"])
        print(f"drill kill: rank {r} restored from {shards[r]}: steps 3-4 losses "
              f"{b['losses']} vs uninterrupted {a['losses'][2:]}, table shard "
              f"sum|x| {b['table_sum']!r} vs {a['table_sum']!r}: equal {same}")
        if not same:
            raise RuntimeError(f"rank {r}: the restored run differs from the "
                               f"uninterrupted one")


def _cli_base(workdir: str, device: str) -> list[str]:
    schema_path = os.path.join(workdir, "schema.json")
    with open(schema_path, "w") as f:
        f.write(_schema().to_json())
    return ["-m", "deepctr_torch.cli", "model.name=fnn", "model.k=3",
            "model.hidden=16,8", "model.dropout=0.5", f"data.schema_path={schema_path}",
            f"train.batch_size={BATCH}", "train.sharded=true",
            "train.distributed=true", "train.early_stop_patience=99",
            "train.checkpoint_every=1"]


def _events(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _same_files(dir_a: str, dir_b: str, nproc: int) -> bool:
    for r in range(nproc):
        with np.load(os.path.join(dir_a, f"proc{r}.npz")) as a, \
                np.load(os.path.join(dir_b, f"proc{r}.npz")) as b:
            if sorted(a.files) != sorted(b.files):
                return False
            for key in a.files:
                x, y = a[key], b[key]
                if x.dtype != y.dtype or not np.array_equal(x, y):
                    return False
    return True


def leg_resume(workdir: str, device: str, nproc: int) -> None:
    base = _cli_base(workdir, device) + ["data.synthetic_examples=3000"]
    a, b = os.path.join(workdir, "a.ckpt"), os.path.join(workdir, "b.ckpt")
    b_metrics = os.path.join(workdir, "b.jsonl")
    _torchrun(base + ["train.epochs=2", f"train.checkpoint_path={a}",
                      "--device", device], nproc, RUN_LIMIT_S)
    _torchrun(base + ["train.epochs=1", f"train.checkpoint_path={b}",
                      f"train.metrics_path={b_metrics}", "--device", device],
              nproc, RUN_LIMIT_S)
    _torchrun(base + ["train.epochs=2", f"train.checkpoint_path={b}",
                      f"train.metrics_path={b_metrics}", "--device", device],
              nproc, RUN_LIMIT_S)
    resumed = [e for e in _events(b_metrics) if e.get("event") == "resumed_hostshards"]
    same = _same_files(a + ".hostshards", b + ".hostshards", nproc)
    written = [p for p in (a, b, a + ".fm_table") if os.path.exists(p)]
    print(f"drill resume: 1 epoch, then resumed from the host shards "
          f"({[(e['step'], e['epoch']) for e in resumed]} as (step, epoch)) to 2: "
          f"shard files equal 2 straight epochs' bit for bit: {same}; portable "
          f"files written: {written}")
    if [e["epoch"] for e in resumed] != [1] or not same or written:
        raise RuntimeError("the resumed CLI run differs from the straight one")


def leg_stream(workdir: str, device: str, nproc: int) -> None:
    from ..data import synthetic

    schema = _schema()
    paths = []
    for i, n in enumerate(STREAM_ROWS + (400,)):
        path = os.path.join(workdir, f"shard_{i}.yx" if i < len(STREAM_ROWS)
                            else "test.yx")
        synthetic.write_yx_file(synthetic.generate(schema, num_examples=n, k=3,
                                                   seed=SEED + 20 + i), path)
        paths.append(path)
    test = paths.pop()
    base = _cli_base(workdir, device) + [
        "data.stream=true", f"data.train_path={','.join(paths)}",
        f"data.test_path={test}", "data.stream_buffer_rows=512",
        "train.exchange_dtype=bf16", "train.capacity_factor=1.25", "train.epochs=2"]
    records = {}
    for prefetch in ("true", "false"):
        ckpt = os.path.join(workdir, f"stream_{prefetch}.ckpt")
        metrics = os.path.join(workdir, f"stream_{prefetch}.jsonl")
        _torchrun(base + [f"train.prefetch={prefetch}", f"train.checkpoint_path={ckpt}",
                          f"train.metrics_path={metrics}", "--device", device],
                  nproc, RUN_LIMIT_S)
        records[prefetch] = [{k: v for k, v in e.items()
                              if k not in ("ts", "examples_per_s", "path")}
                             for e in _events(metrics)]
    steps = [e for e in records["true"] if e.get("event") == "epoch_steps"]
    want = []
    for epoch in range(2):
        rng = np.random.default_rng(SEED + epoch)   # StreamSource.epoch_order
        rows = [STREAM_ROWS[i] for i in rng.permutation(len(STREAM_ROWS))]
        full = [sum(rows[r::nproc]) // (BATCH // nproc) for r in range(nproc)]
        want.append((min(full), (sum(full) - nproc * min(full)) * (BATCH // nproc)))
    same = _same_files(*(os.path.join(workdir, f"stream_{p}.ckpt.hostshards")
                         for p in ("true", "false")), nproc)
    print(f"drill stream: shards of {STREAM_ROWS} rows over {nproc} ranks, bf16 "
          f"wire, capacity 1.25: (steps, rows_skipped) by epoch "
          f"{[(e['steps'], e['rows_skipped']) for e in steps]} (from the row counts: "
          f"{want}); prefetch on and off: histories equal "
          f"{records['true'] == records['false']}, shard files equal {same}")
    if [(e["steps"], e["rows_skipped"]) for e in steps] != want:
        raise RuntimeError("the agreed step counts are not the row counts'")
    if records["true"] != records["false"] or not same:
        raise RuntimeError("prefetch on and off give other histories or shards")


def leg_scan(workdir: str, device: str, nproc: int) -> None:
    _torchrun(_worker_args("scan", workdir, device), nproc, RUN_LIMIT_S)
    ranks = _read(workdir, "scan", nproc)
    print(f"drill scan: two chunks of 8 sharded steps (3 pad steps) on {nproc} "
          f"ranks, {'a captured graph' if ranks[0]['graph'] else 'eager'} vs eager "
          f"steps, bit for bit on each rank: {[r['same'] for r in ranks]}; dropped "
          f"by step {ranks[0]['dropped']}; step {ranks[0]['step']}")
    if not all(r["same"] for r in ranks):
        raise RuntimeError("the sharded scan route differs from eager sharded steps")
    if any((r["losses"], r["dropped"]) != (ranks[0]["losses"], ranks[0]["dropped"])
           for r in ranks) or not ranks[0]["dropped"][-1]:
        raise RuntimeError("the ranks disagree on the global losses or drops, or "
                           "the pad step dropped nothing")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m deepctr_torch.parallel.drill",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: one rank per GPU (two or more); cpu: two gloo ranks")
    ap.add_argument("--legs", default=",".join(LEGS),
                    help=f"comma list of legs to run, of {','.join(LEGS)}")
    ap.add_argument("--workdir", help="where the legs write (default: a "
                    "temporary directory, removed after)")
    ap.add_argument("--worker", choices=("full", "crash", "restore", "scan"),
                    help=argparse.SUPPRESS)   # the kill and scan legs' rank programs
    args = ap.parse_args(argv)
    if args.worker == "scan":
        _scan_worker(args.workdir, args.device)
        return 0
    if args.worker:
        _fm_worker(args.worker, args.workdir, args.device)
        return 0
    legs = [leg for leg in args.legs.split(",") if leg]
    unknown = sorted(set(legs) - set(LEGS))
    if unknown:
        raise SystemExit(f"unknown legs {unknown}; the legs are {', '.join(LEGS)}")
    if args.device == "cuda":
        nproc = torch.cuda.device_count()
        if nproc < 2:
            raise SystemExit(f"the drill needs two ranks, one a GPU; {nproc} GPU(s) "
                             f"here. Use --device cpu for two gloo ranks")
    else:
        nproc = 2
    with (contextlib.nullcontext(args.workdir) if args.workdir
          else tempfile.TemporaryDirectory(prefix="deepctr_drill_")) as workdir:
        for leg in legs:
            legdir = os.path.join(workdir, leg)
            os.makedirs(legdir, exist_ok=True)
            {"kill": leg_kill, "resume": leg_resume, "stream": leg_stream,
             "scan": leg_scan}[leg](
                legdir, args.device, nproc)
    print(f"drill: {', '.join(legs)} passed on {nproc} {args.device} ranks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
