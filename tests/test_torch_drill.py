"""The multi-process fault drill (``python -m deepctr_torch.parallel.drill``)
on two gloo ranks: each leg is one test, so that a failing leg names
itself. The legs and their gates are in the drill's docstring: a killed
rank's run fails within its limit and a fresh pair restores from the shard
files to the uninterrupted bits; the CLI's host-shard resume equals the
straight run, shard file for shard file; the rank-local stream over unequal
shards with the bf16 wire gives one history with and without the
prefetcher; the sharded step agrees with the single-device step within the
reference's tolerances (``parity``). The parity gate is shown to fail on a
dropped gradient and on a moved dense leaf."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from deepctr_torch import parallel as par
from deepctr_torch.parallel import drill, parity
from deepctr_torch.train import init_state, make_train_step


@pytest.mark.parametrize("leg", drill.LEGS)
def test_drill_leg_on_two_cpu_ranks(leg, tmp_path, capsys):
    assert drill.main(["--device", "cpu", "--legs", leg,
                       "--workdir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"drill: {leg} passed on 2 cpu ranks" in out


@pytest.mark.parametrize("args,reason", [
    ([], "needs two ranks, one a GPU; 0 GPU(s) here"),
    (["--nproc", "1"], "--nproc 1: the drill needs two ranks or more"),
    (["--nproc", "2", "--legs", "parity"], "--nproc 2: one rank a GPU, and 0 GPU(s) here"),
], ids=["every-gpu", "nproc-1", "nproc-above-the-gpus"])
def test_drill_refuses_cuda_without_two_gpus(args, reason):
    """The drill never falls back to the CPU: asked for CUDA where there
    are fewer than two GPUs, for one rank, or for more ranks than GPUs, it
    exits non-zero and says why."""
    res = subprocess.run([sys.executable, "-m", "deepctr_torch.parallel.drill", *args],
                         cwd=drill.ROOT, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=drill.ROOT,
                                  CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert reason in res.stderr


def _world_one_sgd(group):
    """Check 1's five steps in a world of one, where the sharded step is
    the single-device step bit for bit; also the sharded table before the
    fifth step."""
    run = parity._Run(group, "dryrun")
    sopt, dopt = parity._sgd()
    one = init_state(run.model(0.0), run.schema, sopt, dopt, seed=0)
    shd = par.init_sharded_state(run.model(0.0), run.schema, sopt, dopt, group, seed=0)
    step1 = make_train_step(run.schema, sopt, dopt)
    step_n = par.make_sharded_train_step(run.schema, sopt, dopt, group,
                                         capacity_factor=run.capacity())
    losses1, losses_n = [], []
    for b in run.batches:
        before = shd.model.table.detach().clone()
        one, m = step1(one, b.ids, b.labels, b.weights)
        losses1.append(m.loss)
        shd, m = step_n(shd, *run.local(b))
        losses_n.append(m.loss)
    return torch.stack(losses1), torch.stack(losses_n), one, shd, before


@pytest.mark.parametrize("fault", ["dropped-gradient", "dense-leaf"])
def test_parity_gate_catches_a_fault(fault):
    """The parity leg's check 1 gate fails on a fault of the size the
    reference's tolerances are there to catch: one table row of the
    sharded result moved back by its last update, lr·|g| (the row of the
    median update: a dropped gradient), or one dense leaf moved by 1e-3.
    Untouched, the same states pass it."""
    with par.process_group("cpu") as group:
        losses1, losses_n, one, shd, before = _world_one_sgd(group)
        results = lambda: [{"size": "dryrun", "world": 1, "rank": 0, "checks": [
            parity.trajectory_record(losses1, losses_n, [0] * parity.STEPS, one, shd,
                                     group)]}]
        parity.raise_misses(results())
        with torch.no_grad():
            if fault == "dropped-gradient":
                moved = (shd.model.table - before).abs().amax(1)
                rows = torch.nonzero(moved).flatten()
                row = rows[moved[rows].argsort()[len(rows) // 2]]
                assert float(moved[row]) > parity.STATE_TOL[1]
                shd.model.table[row] = before[row]
                leaf = "table"
            else:
                shd.model.mlp.layers[0].b[0] += 1e-3
                leaf = "mlp.layers.0.b"
        with pytest.raises(AssertionError, match=f"check 1 .*{leaf}: max"):
            parity.raise_misses(results())


def test_parity_at_the_full_branch_in_a_world_of_one(monkeypatch):
    """The ``full`` size's checks (1, 3, and 5 and 6 at ``bench.py``'s
    configuration: bf16 table, Adagrad, dropout 0.5) at a cut width, in a
    world of one: every check passes, and checks 1 and 3 are the
    single-device step's bits."""
    monkeypatch.setitem(parity.SIZES, "full", dataclasses.replace(
        parity.SIZES["full"], schema=drill._schema, rows=64))
    with par.process_group("cpu") as group:
        res = parity.run_parity(group, "full")
    parity.raise_misses([res])
    checks = {c["check"]: c for c in res["checks"]}
    assert sorted(checks) == [1, 3, 5, 6]
    assert all(x["bitwise"] for n in (1, 3) for x in checks[n]["leaves"])
    assert checks[5]["table_dtype"] == "bf16"
