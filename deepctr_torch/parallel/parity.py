"""The sharded step held against the single-device step on N ranks: the
port's counterpart of ``__graft_entry__.py::dryrun_multichip``.

:func:`run_parity` runs on every rank of a process group (one NCCL rank a
GPU under ``torchrun``, gloo ranks on the CPU, or a world of one). Each
rank runs the row-sharded step on its rows of each global batch, and the
single-device step on the whole global batch on its own device, from the
same seed. The reference's seven checks, one for one, with its
tolerances:

1. five sharded SGD steps (``SparseSgd(0.1)``, dense SGD 0.05, dropout 0,
   ``capacity_factor`` = N) against five single-device steps on the same
   batches: the global losses rtol 1e-4 / atol 1e-5; this rank's table
   shard and every dense leaf rtol 2e-4 / atol 1e-4; no dropped ids;
2. five sharded Adagrad steps (``SparseAdagrad(0.05)``, dense Adagrad
   0.02): every loss finite, no dropped ids, the last loss below the
   first. The difference from the single-device Adagrad trajectory is
   reported, not gated: Adagrad's first update, lr·g/|g|, turns
   reduction-order noise in near-zero gradients into whole steps (the
   reference's own reason);
3. the sharded eval step on check 1's final state against the
   single-device eval step on its state: rtol 2e-4 / atol 2e-3;
4. capacity starved (``capacity_factor=1e-9``: one row an owner) on the
   first example repeated B times: dropped ids above 0, the same global
   count on every rank;
5. the tower with dropout 0.5, two sharded steps twice from one init:
   losses finite, no drops, losses and the table shard bit for bit;
6. a bf16 table and the bf16 wire: the table stays bf16, the Adagrad
   accumulator f32, the loss finite, no drops;
7. a stream-fed sharded scan epoch: two yx shard files of 4·B rows, the
   global batches of ``StreamSource.scan_chunks(0, 2)``, this rank's rows
   (``group.py::local_chunk``), ``DevicePrefetcher``, then
   ``make_sharded_scan_train_step`` (on the card a CUDA graph with the NCCL
   collectives inside): losses finite, no drops, every row trained once.

Two sizes (:data:`SIZES`). ``dryrun`` is the reference's:
``ipinyou_like_schema()``, FNN k=10 with a 200-300-100 tanh tower, 16
rows a rank, ``synthetic.generate(k=4, seed=0)``; all seven checks.
``full`` is ``ipinyou_full_schema()`` (927,658 x 11) with the same FNN at
8192 rows a rank: checks 1 and 3, and checks 5 and 6 at ``bench.py``'s
configuration (bf16 table, ``SparseAdagrad(0.05)``, dense Adagrad 0.02,
dropout 0.5).

The port has no split plan (ROADMAP item 4), so check 1 compares the
gathered lookup with itself sharded; it has no ``scratch_dtype``. A
check's misses are returned, not raised: :func:`raise_misses` raises on
them, after every rank has written what it measured.
"""

from __future__ import annotations

import dataclasses
import math
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..data import Batch, Schema, ipinyou_full_schema, ipinyou_like_schema
from .group import Group, local_batch, local_chunk, rank_rows
from .sharded import local_shard

STEPS = 5                      # checks 1 and 2
LOSS_TOL = (1e-4, 1e-5)        # rtol, atol: the reference's, for the losses
STATE_TOL = (2e-4, 1e-4)       # the table and every dense leaf
EVAL_TOL = (2e-4, 2e-3)        # logits: rows summed over ~18 slots
STARVED_CAPACITY = 1e-9
SCAN_T = 2                     # check 7: steps a chunk
K, HIDDEN = 10, (200, 300, 100)


@dataclasses.dataclass(frozen=True)
class Size:
    schema: Callable[[], Schema]
    rows: int                  # rows a rank; the global batch is rows·N
    checks: tuple[int, ...]
    bench: bool                # checks 5 and 6 at bench.py's configuration


SIZES = {
    "dryrun": Size(ipinyou_like_schema, 16, (1, 2, 3, 4, 5, 6, 7), bench=False),
    "full": Size(ipinyou_full_schema, 8192, (1, 3, 5, 6), bench=True),
}


# ---------------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------------


def compare(leaf: str, got: torch.Tensor, want: torch.Tensor, rtol: float,
            atol: float) -> dict:
    """``|got - want| <= atol + rtol·|want|`` elementwise (numpy's
    ``allclose``; a NaN is a miss), in float64: the largest difference, the
    tolerance, whether it holds and whether the two are equal bit for
    bit."""
    got, want = got.detach(), want.detach()
    rec = {"leaf": leaf, "rtol": rtol, "atol": atol,
           "bitwise": got.dtype == want.dtype and torch.equal(got, want)}
    if got.shape != want.shape:
        return dict(rec, max_abs=math.inf, ok=False)
    diff = (got.double() - want.double()).abs()
    ok = bool((diff <= atol + rtol * want.double().abs()).all())
    return dict(rec, max_abs=float(diff.max()) if diff.numel() else 0.0, ok=ok)


def compare_states(one, shd, group: Group, rtol: float, atol: float) -> list[dict]:
    """This rank's shard of the table and of each table-shaped sparse-state
    leaf against the same rows of the single-device state's, and every
    dense parameter against its single-device value."""
    n, r = group.world, group.rank
    logical = tuple(one.model.table.shape)

    def shard(t):
        return local_shard(t.detach(), n, r) if tuple(t.shape) == logical else t

    leaves = [compare("table", shd.model.table, shard(one.model.table), rtol, atol)]
    leaves += [compare(f"sparse_state.{i}", a, shard(b), rtol, atol)
               for i, (a, b) in enumerate(zip(shd.sparse_state, one.sparse_state,
                                              strict=True))]
    mine = [(name, p) for name, p in shd.model.named_parameters() if name != "table"]
    theirs = [p for name, p in one.model.named_parameters() if name != "table"]
    leaves += [compare(name, p, q, rtol, atol)
               for (name, p), q in zip(mine, theirs, strict=True)]
    return leaves


def record(check: int, name: str, leaves: list[dict], gates: dict[str, bool],
           **extra) -> dict:
    """One check's result: its compared leaves, its other gates by name,
    and the misses among them."""
    misses = [f"{x['leaf']}: max |diff| {x['max_abs']:.3g} outside rtol {x['rtol']} / "
              f"atol {x['atol']}" for x in leaves if not x["ok"]]
    misses += [gate for gate, ok in gates.items() if not ok]
    return {"check": check, "name": name, "ok": not misses, "misses": misses,
            "leaves": leaves, "gates": gates, **extra}


def trajectory_record(losses_one: torch.Tensor, losses_shd: torch.Tensor,
                      dropped: list[int], one, shd, group: Group) -> dict:
    """Check 1's gates on its end states: the global losses, this rank's
    shard and the dense leaves against the single-device run, no drops."""
    leaves = [compare("losses", losses_shd, losses_one, *LOSS_TOL)]
    leaves += compare_states(one, shd, group, *STATE_TOL)
    return record(1, "sgd trajectory", leaves, {"no dropped ids": not any(dropped)},
                  dropped=dropped, losses=losses_shd.tolist())


def raise_misses(results: list[dict]) -> None:
    """Raise ``AssertionError`` naming every miss of every check in
    ``results`` (:func:`run_parity`'s, one a rank and size) by size, world,
    rank and check."""
    found = [f"{res['size']} N={res['world']} rank {res['rank']} check {c['check']} "
             f"({c['name']}): {m}"
             for res in results for c in res["checks"] for m in c["misses"]]
    if found:
        raise AssertionError("the sharded step differs from the single-device "
                             "step:\n" + "\n".join(found))


def report_lines(res: dict) -> list[str]:
    """A line a check: each compared leaf's largest difference beside its
    tolerance (``=`` where bit for bit), the gates, launches and seconds."""
    out = []
    for c in res["checks"]:
        leaves = ", ".join(
            f"{x['leaf']} {'=' if x['bitwise'] else format(x['max_abs'], '.3g')}"
            f"/{x['atol']:g}+{x['rtol']:g}" for x in c["leaves"])
        gates = ", ".join(f"{g} {ok}" for g, ok in c["gates"].items())
        out.append(f"parity {res['size']} N={res['world']} rank {res['rank']} check "
                   f"{c['check']} ({c['name']}): {'ok' if c['ok'] else 'MISS'}"
                   + (f"; max |diff|/atol+rtol: {leaves}" if leaves else "")
                   + (f"; {gates}" if gates else "")
                   + "".join(f"; {k} {c[k]}"
                             for k in ("dropped", "reported", "rows", "graph") if k in c)
                   + f"; tower launches {c['launches']}; {c['seconds']:.2f} s")
    return out


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------


def _launches() -> dict:
    from ..ops.kernels import mlp as mlp_k

    return {"fwd_eval": mlp_k.LAUNCHES - mlp_k.DROPOUT_LAUNCHES,
            "fwd_dropout": mlp_k.DROPOUT_LAUNCHES, "bwd": mlp_k.BWD_LAUNCHES}


class _Run:
    """One size's data, model maker and optimizers on one rank."""

    def __init__(self, group: Group, size: str):
        from ..data import synthetic

        self.group, self.size = group, SIZES[size]
        self.schema = self.size.schema()
        self.batch = self.size.rows * group.world
        ds = synthetic.generate(self.schema, num_examples=self.batch * STEPS, k=4,
                                seed=0)
        ones = np.ones(self.batch, np.float32)
        self.batches = [Batch(ds.ids[i * self.batch:(i + 1) * self.batch],
                              ds.labels[i * self.batch:(i + 1) * self.batch], ones)
                        for i in range(STEPS)]
        self.one = self.shd = None   # check 1's end states, for check 3

    def model(self, dropout: float):
        from ..models import MlpSpec, make_fnn

        return make_fnn(self.schema, k=K, device=self.group.device, mlp=MlpSpec(
            hidden=HIDDEN, activation="tanh", dropout=dropout))

    def local(self, b: Batch) -> tuple:
        b = local_batch(b, self.group, self.batch)
        return b.ids, b.labels, b.weights

    def capacity(self) -> float:
        return float(self.group.world)


def _sgd():
    from ..optim import SparseSgd, make_dense_optimizer

    return SparseSgd(0.1), make_dense_optimizer("sgd", 0.05)


def _adagrad():
    from ..optim import SparseAdagrad, make_dense_optimizer

    return SparseAdagrad(0.05), make_dense_optimizer("adagrad", 0.02)


def _check_sgd(run: _Run) -> dict:
    from ..train import init_state, make_train_step
    from .sharded import init_sharded_state, make_sharded_train_step

    sopt, dopt = _sgd()
    one = init_state(run.model(0.0), run.schema, sopt, dopt, seed=0)
    shd = init_sharded_state(run.model(0.0), run.schema, sopt, dopt, run.group, seed=0)
    step1 = make_train_step(run.schema, sopt, dopt)
    step_n = make_sharded_train_step(run.schema, sopt, dopt, run.group,
                                     capacity_factor=run.capacity())
    losses1, losses_n, dropped = [], [], []
    for b in run.batches:
        one, m = step1(one, b.ids, b.labels, b.weights)
        losses1.append(m.loss)
        shd, m = step_n(shd, *run.local(b))
        losses_n.append(m.loss)
        dropped.append(int(m.dropped))
    run.one, run.shd = one, shd
    return trajectory_record(torch.stack(losses1), torch.stack(losses_n), dropped,
                             one, shd, run.group)


def _check_adagrad(run: _Run) -> dict:
    from ..train import init_state, make_train_step
    from .sharded import init_sharded_state, make_sharded_train_step

    sopt, dopt = _adagrad()
    one = init_state(run.model(0.0), run.schema, sopt, dopt, seed=0)
    shd = init_sharded_state(run.model(0.0), run.schema, sopt, dopt, run.group, seed=0)
    step1 = make_train_step(run.schema, sopt, dopt)
    step_n = make_sharded_train_step(run.schema, sopt, dopt, run.group,
                                     capacity_factor=run.capacity())
    losses, dropped = [], []
    for b in run.batches:
        one, _ = step1(one, b.ids, b.labels, b.weights)
        shd, m = step_n(shd, *run.local(b))
        losses.append(float(m.loss))
        dropped.append(int(m.dropped))
    reported = {x["leaf"]: x["max_abs"] for x in compare_states(one, shd, run.group,
                                                                *STATE_TOL)}
    return record(2, "adagrad steps", [], {
        "losses finite": bool(np.all(np.isfinite(losses))),
        "no dropped ids": not any(dropped),
        "last loss below the first": losses[-1] < losses[0]},
        dropped=dropped, losses=losses,
        reported={"max |diff| from the single-device run": reported})


def _check_eval(run: _Run) -> dict:
    from ..train import make_eval_step
    from .sharded import make_sharded_eval_step

    if run.shd is None:
        raise RuntimeError("check 3 evaluates check 1's end state: run check 1 first")
    b = run.batches[0]
    got = make_sharded_eval_step(run.schema, run.group, capacity_factor=run.capacity())(
        run.shd.model, run.local(b)[0])
    want = make_eval_step(run.schema)(run.one.model, b.ids)[rank_rows(run.batch,
                                                                     run.group)]
    return record(3, "eval", [compare("logits", got, want, *EVAL_TOL)], {})


def _check_starved(run: _Run) -> dict:
    from .sharded import init_sharded_state, make_sharded_train_step

    sopt, dopt = _sgd()
    state = init_sharded_state(run.model(0.0), run.schema, sopt, dopt, run.group, seed=1)
    step = make_sharded_train_step(run.schema, sopt, dopt, run.group,
                                   capacity_factor=STARVED_CAPACITY)
    b = run.batches[0]
    skew = Batch(np.repeat(b.ids[:1], run.batch, axis=0), b.labels, b.weights)
    _, m = step(state, *run.local(skew))
    dropped = int(m.dropped)
    every = [dropped]
    if run.group.world > 1:
        every = [None] * run.group.world
        dist.all_gather_object(every, dropped)
    return record(4, "starved capacity", [], {
        "dropped ids > 0": dropped > 0,
        "the same count on every rank": len(set(every)) == 1}, dropped=every)


def _check_dropout_repeat(run: _Run) -> dict:
    from .sharded import init_sharded_state, make_sharded_train_step

    sopt, dopt = _adagrad() if run.size.bench else _sgd()
    table_dtype = "bf16" if run.size.bench else "f32"
    step = make_sharded_train_step(run.schema, sopt, dopt, run.group,
                                   capacity_factor=run.capacity())
    tables, losses, dropped = [], [], []
    for _ in range(2):
        state = init_sharded_state(run.model(0.5), run.schema, sopt, dopt, run.group,
                                   seed=2, table_dtype=table_dtype)
        run_losses = []
        for b in run.batches[:2]:
            state, m = step(state, *run.local(b))
            run_losses.append(float(m.loss))
            dropped.append(int(m.dropped))
        tables.append(state.model.table.detach().clone())
        losses.append(run_losses)
    return record(5, "dropout 0.5, twice from one init", [], {
        "losses finite": bool(np.all(np.isfinite(losses))),
        "no dropped ids": not any(dropped),
        "losses bit for bit": losses[0] == losses[1],
        "table shard bit for bit": torch.equal(tables[0], tables[1])},
        losses=losses[0], table_dtype=table_dtype)


def _check_bf16(run: _Run) -> dict:
    from ..optim import SparseAdagrad, make_dense_optimizer
    from .sharded import init_sharded_state, make_sharded_train_step

    if run.size.bench:
        (sopt, dopt), dropout = _adagrad(), 0.5
    else:   # the reference's: its check 1's dense SGD, dropout 0
        sopt, dopt, dropout = SparseAdagrad(0.05), make_dense_optimizer("sgd", 0.05), 0.0
    state = init_sharded_state(run.model(dropout), run.schema, sopt, dopt, run.group,
                               seed=4, table_dtype="bf16")
    step = make_sharded_train_step(run.schema, sopt, dopt, run.group,
                                   capacity_factor=run.capacity(), exchange_dtype="bf16")
    state, m = step(state, *run.local(run.batches[0]))
    return record(6, "bf16 table and wire", [], {
        "table bf16": state.model.table.dtype == torch.bfloat16,
        "accumulator f32": state.sparse_state.acc.dtype == torch.float32,
        "loss finite": bool(torch.isfinite(m.loss)),
        "no dropped ids": int(m.dropped) == 0})


def _check_stream_scan(run: _Run) -> dict:
    from ..data import StreamSource, synthetic
    from ..data.pipeline import DevicePrefetcher
    from ..optim import SparseAdagrad, make_dense_optimizer
    from .sharded import init_sharded_state, make_sharded_scan_train_step

    schema, group = run.schema, run.group
    n_rows = 4 * run.batch
    ds = synthetic.generate(schema, num_examples=n_rows, k=3, seed=11)
    sopt, dopt = SparseAdagrad(0.1), make_dense_optimizer("adagrad", 0.05)
    state = init_sharded_state(run.model(0.0), schema, sopt, dopt, group, seed=6)
    scan = make_sharded_scan_train_step(schema, sopt, dopt, group,
                                        capacity_factor=run.capacity())
    losses, dropped, rows = [], [], 0
    with tempfile.TemporaryDirectory(prefix="deepctr_parity_") as tmp:
        paths = []
        for i in range(2):   # each rank writes its own copy of the two shards
            part = slice(i * n_rows // 2, (i + 1) * n_rows // 2)
            paths.append(os.path.join(tmp, f"shard_{i}.yx"))
            synthetic.write_yx_file(synthetic.SyntheticDataset(
                schema, ds.ids[part], ds.labels[part], ds.bayes_logits[part]), paths[-1])
        source = StreamSource(paths=paths, schema=schema, batch_size=run.batch,
                              buffer_rows=2 * run.batch, seed=0)
        chunks = (local_chunk(c, group, run.batch) for c in source.scan_chunks(0, SCAN_T))
        feed = DevicePrefetcher(chunks, group.device, depth=2)
        try:
            for nb, chunk in feed:
                state, m = scan(state, *chunk)
                losses += m.losses[:nb].tolist()
                dropped += m.dropped.tolist()
                rows += nb * run.batch
        finally:
            feed.close()
            graph = bool(scan.graph)
            scan.graph.clear()   # before the group ends (make_sharded_scan_train_step)
    return record(7, "stream-fed sharded scan epoch", [], {
        "losses finite": bool(np.all(np.isfinite(losses))),
        "no dropped ids": not any(dropped),
        "every row once": rows == n_rows}, rows=f"{rows} of {n_rows}",
        graph=graph, dropped=dropped)


CHECKS = {1: _check_sgd, 2: _check_adagrad, 3: _check_eval, 4: _check_starved,
          5: _check_dropout_repeat, 6: _check_bf16, 7: _check_stream_scan}


def run_parity(group: Group, size: str) -> dict:
    """Every check of ``size`` on this rank: ``{"size", "world", "rank",
    "device", "seconds", "checks": [record, ...]}``. Every rank of the group
    must call it; nothing is raised for a miss (:func:`raise_misses`)."""
    t_run = time.perf_counter()
    run = _Run(group, size)
    checks = []
    for number in run.size.checks:
        t0, before = time.perf_counter(), _launches()
        rec = CHECKS[number](run)
        if group.device.type == "cuda":
            torch.cuda.synchronize(group.device)
        after = _launches()
        rec["launches"] = {k: after[k] - before[k] for k in after}
        rec["seconds"] = time.perf_counter() - t0
        checks.append(rec)
    return {"size": size, "world": group.world, "rank": group.rank,
            "device": (torch.cuda.get_device_name(group.device)
                       if group.device.type == "cuda" else "cpu"),
            "seconds": time.perf_counter() - t_run, "checks": checks}
