"""Runner of the ``train_sharded`` kind: the port's row-sharded scan route
(``deepctr_torch.parallel.sharded.make_sharded_scan_train_step``: the table
and its accumulator row-sharded over the ranks, the id and row all-to-alls
and the dense all-reduce captured in one CUDA graph a chunk), one process a
device.

This process is rank 0: it builds the kernels once, starts ranks 1..N-1 as
spawned processes, and runs :func:`ctrbench.runners.train.train_rank` with
them. The ranks meet through a ``torch.distributed.TCPStore`` on
``localhost`` that rank 0 holds; rank 0's clock decides, chunk by chunk,
when the window ends, and the store tells the others, so every rank runs the
same chunks. Each rank stages its own rows of every global batch (its own
pool, drawn from the seed and its rank); the dropout seeds are the same on
every rank and the port mixes in the rank. ``train_examples_per_s`` counts
the examples of every rank. After the window rank 0 gathers the first three
steps' inputs of every rank and the reference follows the global steps.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import socket

import torch

from .train import finish, train_rank


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _store(port: int, world: int, rank: int):
    from datetime import timedelta

    import torch.distributed as dist

    return dist.TCPStore("127.0.0.1", port, world, is_master=rank == 0,
                         timeout=timedelta(seconds=120), wait_for_workers=False)


def _rank_main(ctx, rank: int, world: int, port: int) -> None:
    torch.set_num_threads(1)
    if ctx.dev.type == "cuda":
        torch.cuda.set_device(ctx.dev)
    train_rank(ctx, rank, world, _store(port, world, rank))


def _on(ctx, rank: int):
    dev = ctx.dev
    device = f"cuda:{rank}" if dev.type == "cuda" else "cpu"
    return dataclasses.replace(ctx, device=device)


def run(ctx) -> dict:
    world = int(ctx.traffic["ranks"])
    if ctx.dev.type == "cuda":
        from deepctr_torch.ops.kernels._build import compile_library

        compile_library()   # once, before the ranks load it
    port = _free_port()
    store = _store(port, world, 0)
    mp = multiprocessing.get_context("spawn")
    procs = [mp.Process(target=_rank_main, args=(_on(ctx, r), r, world, port))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        ctx0 = _on(ctx, 0)
        out = train_rank(ctx0, 0, world, store)
    finally:
        for p in procs:
            p.join(timeout=240)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return finish(ctx0, out, world)
