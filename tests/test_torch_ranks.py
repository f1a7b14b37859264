"""The rank program of the port's multi-rank CPU tests, and the tests of
the group helpers that need no second process.

``tests/test_torch_parallel.py`` and ``tests/test_torch_sharded_cli.py``
start this file as a script, once per rank:

    python tests/test_torch_ranks.py RANK WORLD STORE_FILE INPUTS.npz OUT_DIR

Each rank joins a gloo group through the ``file://`` store, runs every case
that ``INPUTS.npz`` names (``<case>/config`` is a JSON object; its arrays
are ``<case>/<name>``) and writes ``OUT_DIR/rank<RANK>.npz`` with the
results under ``<case>/<name>``. The program imports nothing of JAX and
nothing of ``deepctr_tpu``, and records what its ``sys.modules`` hold of
them (case ``modules``).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from deepctr_torch import parallel as par  # noqa: E402
from deepctr_torch.data import Batch, Schema  # noqa: E402
from deepctr_torch.models import MlpSpec, make_fm, make_fnn, make_lr  # noqa: E402
from deepctr_torch.optim import make_dense_optimizer, make_sparse_optimizer  # noqa: E402
from deepctr_torch.train import init_state  # noqa: E402


def build_state(cfg: dict, arrays: dict, prefix: str):
    """A port ``TrainState`` with the initial parameters the case gives
    (the JAX package's, as ``params_from_jax`` names them)."""
    schema = Schema.from_json(cfg["schema"])
    if cfg["model"] == "fm":
        model = make_fm(schema, k=cfg["k"], device="cpu")
    elif cfg["model"] == "lr":
        model = make_lr(schema, device="cpu")
    else:
        model = make_fnn(schema, k=cfg["k"], device="cpu", mlp=MlpSpec(
            hidden=tuple(cfg["hidden"]), dropout=cfg.get("dropout", 0.0)))
    sopt = make_sparse_optimizer(cfg["sparse"], cfg["sparse_lr"], **(
        {"mode": cfg["sparse_mode"]} if "sparse_mode" in cfg else {}))
    dopt = make_dense_optimizer(cfg["dense"], cfg["dense_lr"])
    state = init_state(model, schema, sopt, dopt, seed=cfg.get("seed", 0),
                       table_dtype=cfg.get("table_dtype", "f32"))
    init = {key[len(prefix):]: torch.from_numpy(a) for key, a in arrays.items()
            if key.startswith(prefix)}
    if init:
        model.load_state_dict(init)
    return schema, sopt, dopt, state


def _batches(cfg, arrays, name):
    ids, labels = arrays[f"{name}/ids"], arrays[f"{name}/labels"]
    return [Batch(ids=ids[i], labels=labels[i],
                  weights=np.ones(labels.shape[1], np.float32))
            for i in range(ids.shape[0])]


def _host(out, name, sst, group):
    """Rank 0 writes the gathered state's table, sparse state and dense
    parameters."""
    host = par.host_state_from_sharded(sst, group)
    if host is None:
        return
    out[f"{name}/table"] = host.table.float().numpy()
    for i, t in enumerate(host.sparse_state):
        out[f"{name}/sparse_{i}"] = t.numpy()
    for key, t in host.model.state_dict().items():
        if key != "table":
            out[f"{name}/dense/{key}"] = t.float().numpy()


def run_trajectory(name, cfg, arrays, group, out):
    """Steps of the sharded (or, ``"dp": true``, data-parallel) step on
    this rank's share of each batch; losses, drops and the final state,
    which it returns."""
    schema, sopt, dopt, state = build_state(cfg, arrays, f"{name}/init/")
    if cfg.get("dp"):
        state = par.replicate_state(state)
        step = par.make_dp_train_step(schema, sopt, dopt, group, l2=cfg.get("l2", 0.0))
    else:
        state = par.sharded_state_from_state(state, group)
        step = par.make_sharded_train_step(
            schema, sopt, dopt, group, l2=cfg.get("l2", 0.0),
            capacity_factor=cfg["capacity_factor"],
            exchange_dtype=cfg.get("exchange_dtype", "f32"))
    scales = cfg.get("lr_scales") or [1.0] * len(arrays[f"{name}/ids"])
    losses, drops = [], []
    for b, scale in zip(_batches(cfg, arrays, name), scales):
        b = par.local_batch(b, group)
        state, (loss, dropped) = step(state, b.ids, b.labels, b.weights, scale)
        losses.append(float(loss))
        drops.append(int(dropped))
    out[f"{name}/losses"] = np.array(losses)
    out[f"{name}/dropped"] = np.array(drops)
    if cfg.get("dp"):
        out[f"{name}/table"] = state.table.float().numpy()
        for key, t in state.model.state_dict().items():
            if key != "table":
                out[f"{name}/dense/{key}"] = t.float().numpy()
    else:
        _host(out, name, state, group)
    return state


def run_dryrun(name, cfg, arrays, group, out):
    """``__graft_entry__.py::dryrun_multichip``'s checks 1 and 3 on this
    rank: the sharded trajectory, then the sharded eval step of the first
    batch on its end state (this rank's logits)."""
    state = run_trajectory(name, cfg, arrays, group, out)
    ev = par.make_sharded_eval_step(Schema.from_json(cfg["schema"]), group,
                                    capacity_factor=cfg["capacity_factor"])
    ids = arrays[f"{name}/ids"][0]
    out[f"{name}/logits"] = ev(state.model, ids[par.rank_rows(len(ids), group)]).numpy()


def run_scan(name, cfg, arrays, group, out):
    """Chunks ``[C, K, B, S]`` through the sharded scan step on this rank's
    rows of each step; every step's loss and drop count, the step count and
    the final state."""
    schema, sopt, dopt, state = build_state(cfg, arrays, f"{name}/init/")
    state = par.sharded_state_from_state(state, group)
    scan = par.make_sharded_scan_train_step(
        schema, sopt, dopt, group, l2=cfg.get("l2", 0.0),
        capacity_factor=cfg["capacity_factor"])
    ids, labels, weights = (arrays[f"{name}/{k}"] for k in ("ids", "labels", "weights"))
    losses, drops = [], []
    for c in range(ids.shape[0]):
        nb, chunk = par.local_chunk((ids.shape[1], (ids[c], labels[c], weights[c])),
                                    group, global_rows=ids.shape[2])
        state, m = scan(state, *chunk)
        losses += m.losses.tolist()
        drops += m.dropped.tolist()
    out[f"{name}/losses"] = np.array(losses)
    out[f"{name}/dropped"] = np.array(drops)
    out[f"{name}/step"] = np.array(state.step)
    _host(out, name, state, group)


def run_eval(name, cfg, arrays, group, out):
    schema, _, _, state = build_state(cfg, arrays, f"{name}/init/")
    sst = par.sharded_state_from_state(state, group)
    ev = par.make_sharded_eval_step(schema, group, capacity_factor=cfg["capacity_factor"])
    ids = arrays[f"{name}/ids"]
    out[f"{name}/logits"] = ev(sst.model, ids[par.rank_rows(len(ids), group)]).numpy()


def run_roundtrip(name, cfg, arrays, group, out):
    """A distinctive prepared state into the sharded layout and back."""
    _, _, _, state = build_state(cfg, arrays, f"{name}/init/")
    with torch.no_grad():
        state.model.table.add_(7.0)
        state.sparse_state.acc.add_(3.0)
    state.step = 42
    want = state.clone()
    sst = par.sharded_state_from_state(state, group)
    out[f"{name}/shard"] = sst.model.table.numpy()
    out[f"{name}/acc_shard"] = sst.sparse_state.acc.numpy()
    host = par.host_state_from_sharded(sst, group)
    if host is not None:
        same = (host.step == 42 and torch.equal(host.table, want.table)
                and torch.equal(host.sparse_state.acc, want.sparse_state.acc)
                and all(torch.equal(p, q) for p, q in zip(host.model.parameters(),
                                                          want.model.parameters()))
                and torch.equal(host.generator.get_state(), want.generator.get_state()))
        out[f"{name}/same"] = np.array(same)


def run_repeat(name, cfg, arrays, group, out):
    """FNN with dropout: the same steps twice from one state, and once
    without dropout."""
    tables = []
    for dropout in (cfg["dropout"], cfg["dropout"], 0.0):
        schema, sopt, dopt, state = build_state(dict(cfg, dropout=dropout), arrays,
                                                f"{name}/init/")
        sst = par.sharded_state_from_state(state, group)
        step = par.make_sharded_train_step(schema, sopt, dopt, group,
                                           capacity_factor=cfg["capacity_factor"])
        losses = []
        for b in _batches(cfg, arrays, name):
            b = par.local_batch(b, group)
            sst, (loss, _) = step(sst, b.ids, b.labels, b.weights)
            losses.append(float(loss))
        tables.append((sst.model.table.clone(), losses))
    out[f"{name}/repeat_equal"] = np.array(torch.equal(tables[0][0], tables[1][0])
                                           and tables[0][1] == tables[1][1])
    out[f"{name}/differs_from_no_dropout"] = np.array(
        not torch.equal(tables[0][0], tables[2][0]))
    out[f"{name}/finite"] = np.array(bool(np.all(np.isfinite(tables[0][1]))))


def run_cli(name, cfg, arrays, group, out):
    """``cli.run`` on this rank, with the prepared state's hand-off to the
    sharded layout recorded: the logical table before packing and this
    rank's shard after."""
    from deepctr_torch import cli
    from deepctr_torch.config import RunConfig

    seen = {}
    pack = par.sharded_state_from_state

    def spy(state, group_):
        seen["table"] = state.table.detach().float().clone()
        sst = pack(state, group_)
        seen["shard"] = sst.model.table.detach().float().clone()
        return sst

    par.sharded_state_from_state = spy
    try:
        res = cli.run(RunConfig().apply_overrides(cfg["overrides"]), torch.device("cpu"))
    finally:
        par.sharded_state_from_state = pack
    out[f"{name}/table"] = seen["table"].numpy()
    out[f"{name}/shard"] = seen["shard"].numpy()
    out[f"{name}/best_auc"] = np.array(res["best_auc"])


def run_warmup(name, cfg, arrays, group, out):
    """One sharded step, then the sharded body through the scan route's
    warm-up (``train/step.py::_warm_up``) on the second batch, with the
    rows ``touched_shard_rows`` gathers, under ``record_collectives``:
    whether the warm-up step changed the shard, whether the state equals a
    clone taken before it, the touched and shard rows, and each recorded
    collective's op and bytes."""
    from deepctr_torch.parallel import sharded
    from deepctr_torch.train import step as t_step

    schema, sopt, dopt, state = build_state(cfg, arrays, f"{name}/init/")
    sst = par.sharded_state_from_state(state, group)
    cf = cfg["capacity_factor"]
    step = par.make_sharded_train_step(schema, sopt, dopt, group, capacity_factor=cf)
    first, second = (par.local_batch(b, group) for b in _batches(cfg, arrays, name))
    sst, _ = step(sst, first.ids, first.labels, first.weights)
    body = sharded._sharded_step_body(schema, sopt, dopt, group, 0.0, cf, "f32", False)
    want = sst.clone()
    seen = {}

    def spy(st, *args):
        res = body(st, *args)
        seen["changed"] = not torch.equal(st.model.table, want.model.table)
        return res

    ids = torch.from_numpy(second.ids).long()
    sentinel = par.shard_rows(schema.padded_vocab_size, group.world)
    with par.record_collectives() as records:
        touched = sharded.touched_shard_rows(ids, group, sentinel)
        t_step._warm_up(spy, sst, ids, torch.from_numpy(second.labels),
                        torch.from_numpy(second.weights), 1.0,
                        sharded.rank_seed(77, group.rank), touched)
    leaves = zip(t_step._state_tensors(sst), t_step._state_tensors(want), strict=True)
    out[f"{name}/changed"] = np.array(seen["changed"])
    out[f"{name}/same"] = np.array(
        sst.step == want.step
        and torch.equal(sst.generator.get_state(), want.generator.get_state())
        and all(torch.equal(a.detach(), b.detach()) for a, b in leaves))
    out[f"{name}/touched"] = np.array(touched.numel())
    out[f"{name}/shard_rows"] = np.array(sst.model.table.shape[0])
    out[f"{name}/ops"] = np.array([c.op for c in records], dtype=str)
    out[f"{name}/nbytes"] = np.array([c.nbytes for c in records])


CASES = {"trajectory": run_trajectory, "dryrun": run_dryrun, "scan": run_scan,
         "eval": run_eval,
         "roundtrip": run_roundtrip, "repeat": run_repeat, "cli": run_cli,
         "warmup": run_warmup}


def main(argv) -> int:
    rank, world, store, inputs, out_dir = argv
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=int(rank), world_size=int(world))
    out = {}
    with np.load(inputs) as z:
        arrays = {key: z[key] for key in z.files}
    with par.process_group("cpu") as group:
        for key in sorted(k for k in arrays if k.endswith("/config")):
            name = key[:-len("/config")]
            cfg = json.loads(str(arrays[key]))
            CASES[cfg["case"]](name, cfg, arrays, group, out)
    dist.destroy_process_group()
    out["modules/loaded"] = np.array(sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "deepctr_tpu")),
        dtype=str)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    return 0


def launch(inputs: dict, tmp: str, world: int = 2, timeout: float = 300) -> list[dict]:
    """Run this program on ``world`` gloo ranks with ``inputs``; returns
    each rank's results."""
    import subprocess

    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, "inputs.npz")
    np.savez(path, **inputs)
    store = os.path.join(tmp, "store")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world), store, path, tmp],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:  # a rank left waiting on a failed peer would hang in a collective
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
    results = []
    for r in range(world):
        with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
            results.append({key: z[key] for key in z.files})
    return results


def torchrun(args: list[str], nproc: int = 2, timeout: float = 300) -> str:
    """``torchrun --standalone --nproc_per_node=nproc -m deepctr_torch.cli
    ARGS`` from the repository's root; returns its output. Past ``timeout``
    the launcher is sent SIGTERM, on which it stops its ranks (a SIGKILL
    would leave ranks that hang in a collective running), and
    ``subprocess.TimeoutExpired`` raises."""
    import subprocess

    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={nproc}", "-m", "deepctr_torch.cli", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
        raise
    assert proc.returncode == 0, (out[-2000:], err[-3000:])
    return out


def test_rank_rows_split_a_batch_in_rank_order():
    batch = Batch(ids=np.arange(12, dtype=np.int32).reshape(6, 2),
                  labels=np.arange(6, dtype=np.float32),
                  weights=np.ones(6, np.float32))
    parts = [par.local_batch(batch, par.Group(rank=r, world=3, device=torch.device("cpu")))
             for r in range(3)]
    np.testing.assert_array_equal(np.concatenate([p.ids for p in parts]), batch.ids)
    np.testing.assert_array_equal(np.concatenate([p.labels for p in parts]), batch.labels)


def test_rank_rows_refuse_a_batch_that_does_not_split():
    import pytest

    with pytest.raises(ValueError, match="does not split"):
        par.rank_rows(7, par.Group(rank=0, world=2, device=torch.device("cpu")))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
