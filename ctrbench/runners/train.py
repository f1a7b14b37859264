"""Runner of the ``train`` kind: the port's scan route on one device
(``deepctr_torch.train.step.make_scan_train_step``, on the card one CUDA
graph replay of K steps a chunk), fed from chunks staged on the device.

Set-up: the inputs and weights from the seed (``traffic.py``,
``weights.py``); the port's train state built from the configuration and
the weights loaded into it; then the first three steps of the pool, through
the window's own call on the same state: one chunk whose first step is
live and whose other K - 1 are weight-0 pad steps (the port's own way to
run a short chunk, which leaves Adagrad's state as it was), then one with
the next two steps live. That captures the graph. What ``correct`` compares
is read from the state after the first step and after the third. Then
``warmup_chunks`` chunks of the window's loop run untimed, so that the
window starts in the steady state.

Window: the pool's ``pool_chunks`` chunks replayed in order, in a cycle, for
``--seconds`` on the host clock; it ends in a synchronize, and every chunk
issued in it is counted. ``train_examples_per_s`` is the examples of those
chunks over the window's seconds (on every rank, where there are several).

After the window the program's state is freed and the reference follows the
three steps from the same weights, inputs and dropout seeds.
"""

from __future__ import annotations

import time

import torch

from .. import checks, port
from ..reference import fnn as reference
from ..trace import Pace, Slice
from ..traffic import Fields, IdSampler, dropout_seeds, train_pool
from ..weights import initial_table, initial_tower


def _losses(out) -> torch.Tensor:
    """The K losses of a chunk, single-device or sharded."""
    return out[1] if isinstance(out[1], torch.Tensor) else out[1].losses


def train_rank(ctx, rank: int = 0, world: int = 1, store=None) -> dict:
    """One rank of a training run. With ``world`` > 1 it joins the process
    group through ``store`` and drives the port's sharded scan route. Every
    rank returns its own part of the result; rank 0's holds the window."""
    import torch.distributed as dist

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.dev
    fields = Fields(cfg)
    sch = port.schema(cfg)
    b, k = int(cfg["batch"]), int(cfg["scan_steps"])
    group = None
    if world > 1:
        from datetime import timedelta

        from deepctr_torch.parallel.group import Group

        kw = {"device_id": dev} if dev.type == "cuda" else {}
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=store,
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=120), **kw)
        group = Group(rank=rank, world=world, device=dev)

    sampler = IdSampler(fields, float(tr["zipf_alpha"]), ctx.seed, dev)
    pool_ids, pool_labels = train_pool(sampler, cfg, tr, ctx.seed, rank, b)
    del sampler
    chunks = pool_ids.shape[0]
    flat = dropout_seeds(ctx.seed, chunks * k)
    seeds = [flat[c * k:(c + 1) * k] for c in range(chunks)]
    ones = torch.ones(k, b, device=dev)
    table0 = initial_table(cfg, ctx.seed, dev)
    tower0 = initial_tower(cfg, ctx.seed, dev)
    state, sparse_opt, dense_opt = port.train_state(cfg, sch, table0, tower0, dev)
    if group is None:
        from deepctr_torch.train.step import make_scan_train_step

        scan = make_scan_train_step(sch, sparse_opt, dense_opt)
    else:
        from deepctr_torch.parallel.sharded import (make_sharded_scan_train_step,
                                                    sharded_state_from_state)

        state = sharded_state_from_state(state, group)
        scan = make_sharded_scan_train_step(
            sch, sparse_opt, dense_opt, group,
            capacity_factor=float(cfg["capacity_factor"]),
            exchange_dtype=cfg["exchange_dtype"])
    share = table0 if group is None else port.table_share(table0, world, rank)
    del table0

    # the first three steps of the pool, through the window's own call
    ids_a, labels_a, w_a = port.pad_steps(pool_ids[0], pool_labels[0], 1, fields.pad_id)
    losses_a = _losses(scan(state, ids_a, labels_a, w_a, seeds=seeds[0]))
    grad_sq = port.first_grad_sq(state, cfg, tower0)
    order = list(range(1, k)) + [0]
    ids_b, labels_b, w_b = port.pad_steps(pool_ids[0][order], pool_labels[0][order], 2,
                                          fields.pad_id)
    losses_b = _losses(scan(state, ids_b, labels_b, w_b, seeds=[seeds[0][i] for i in order]))
    sq = torch.stack(grad_sq + port.change_sq(state, share, tower0))
    if group is not None:   # the table's shares add up; the tower is replicated
        table_sq = sq[[0, len(grad_sq)]].clone()
        dist.all_reduce(table_sq)
        sq[[0, len(grad_sq)]] = table_sq
    norms = sq.sqrt().tolist()
    names = reference.leaf_names(len(tower0))
    prog = {"losses": [float(losses_a[0]), float(losses_b[0]), float(losses_b[1])],
            "grad_norms": dict(zip(names, norms[:len(names)])),
            "change_norms": dict(zip(names, norms[len(names):]))}
    del share, ids_a, labels_a, w_a, ids_b, labels_b, w_b
    check_inputs = (pool_ids[0][:3].cpu(), pool_labels[0][:3].cpu())

    for c in range(int(tr["warmup_chunks"])):   # the window's loop, untimed
        scan(state, pool_ids[c % chunks], pool_labels[c % chunks], ones,
             seeds=seeds[c % chunks])
    sl = Slice(dev, ctx.trace)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    if group is not None:
        dist.barrier()
    setup_s = time.perf_counter() - ctx.t_start
    pace = Pace(ctx.seconds, ctx.trace, int(tr["profile_chunks"]), rank, store)
    window_losses = []
    n = 0
    pace.begin()
    while pace.apply(pace.step(n), n, sl):
        c = n % chunks
        window_losses.append(_losses(scan(state, pool_ids[c], pool_labels[c], ones,
                                          seeds=seeds[c])))
        n += 1
    if cuda:
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - pace.t0
    sl.close()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    failed = int((~torch.isfinite(torch.cat(window_losses))).sum()) if window_losses else 0
    reading = sl.reading()
    if reading is not None:
        reading["steps"] = reading["units"] * k

    scan.graph.clear()   # a graph that holds NCCL collectives goes before the group
    del state, scan, window_losses, pool_ids, pool_labels, ones
    out = {"window_s": window_s, "setup_s": setup_s, "steps": n * k,
           "examples": n * k * b * world, "failed": failed, "peak": peak,
           "reading": reading, "prog": prog, "check_inputs": check_inputs,
           "seeds": seeds[0][:3]}
    if group is not None:
        parts = [None] * world if rank == 0 else None
        dist.gather_object({key: out[key] for key in ("peak", "reading", "check_inputs")},
                           parts, dst=0)
        dist.barrier()
        dist.destroy_process_group()
        if rank == 0:
            out["ranks"] = parts
    if cuda:
        torch.cuda.empty_cache()
    return out


def finish(ctx, out: dict, world: int) -> dict:
    """Rank 0's result: the window's metrics, and the reference's three steps
    from the same weights, inputs and seeds against the program's."""
    ranks = out.get("ranks", [out])
    dev = ctx.dev
    batches = [(torch.cat([r["check_inputs"][0][t] for r in ranks]).to(dev),
                torch.cat([r["check_inputs"][1][t] for r in ranks]).to(dev))
               for t in range(3)]
    table0 = initial_table(ctx.config, ctx.seed, dev)
    tower0 = initial_tower(ctx.config, ctx.seed, dev)
    ref = reference.train_reading(ctx.config, table0, tower0, batches, out["seeds"],
                                  ranks=world)
    readings = [r["reading"] for r in ranks if r["reading"] is not None]
    return {
        "e2e": {"train_examples_per_s": out["examples"] / out["window_s"],
                "setup_s": out["setup_s"]},
        "attempted": out["steps"], "failed": out["failed"],
        "memory_peak_bytes": max(r["peak"] for r in ranks),
        "readings": readings if len(readings) == len(ranks) else [],
        "numbers": checks.train_numbers(out["prog"], ref),
        "detail": checks.train_detail(out["prog"], ref),
    }


def run(ctx) -> dict:
    out = train_rank(ctx)
    return finish(ctx, out, 1)

