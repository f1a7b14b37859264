"""Runner of the ``train_hstu`` kind: HSTU on the port's scan route on one
device (``deepctr_torch.train.step.make_scan_train_step``; on the card one
CUDA graph replay of K steps a chunk), fed from chunks of padded histories
staged on the device (``traffic_hstu.py``).

Set-up: the program's HSTU imported first (a program without it fails here,
at once); the pool of histories and the weights from the seed
(``traffic_hstu.py``, ``weights_hstu.py``); the port's train state built
from the configuration and the weights loaded into it; then the first three
steps of the pool through the window's own call on the same state, as the
``train_xdeepfm`` runner takes them (a chunk whose first step is live and
whose other K - 1 are weight-0 pad steps, then one with the next two live),
with dropout seeds of the run's seed (``traffic.dropout_seeds``), which
captures the graph. Then ``warmup_chunks`` chunks run untimed.

Window: the pool's ``pool_chunks`` chunks replayed in order, in a cycle, for
``--seconds`` on the host clock, ending in a synchronize (the dropout seeds
drawn from the state's generator); ``train_examples_per_s`` is the
histories of every chunk issued in it over its seconds.

Traced (``--trace 1``), the program's own tracing is on from the start
(``deepctr_torch.utils.prof``), so the captured graph stamps the device's
clock at each phase of each step (``lookup``, ``hstu_proj``, ``hstu_attn``,
``loss``, ``backward``, ``hstu_attn_bwd``, ``dense``; a phase of one name
summed over the blocks). The stamps are drained as the profiled slice
starts and once it has stopped, and the slice's reading gets each phase's
device seconds over its replays (``phase_s``, also printed to standard
error as ms a step), the work of its steps counted from the pool (``tokens``
valid positions, ``pairs`` causal pairs of valid positions, ``supervised``
positions; ``arith_hstu.work``) and the program's counters over the slice
(``counters``: ``hstu.TOKENS``, ``hstu.PADDED``, ``hstu.NEGATIVES``, read
at its two ends). A program whose graph stamps nothing gives no
``phase_s``, and the readers of the phases give nothing.

After the window the program's state is freed, and the reference follows
the two chunks (three live steps, thirteen pad steps, which move Adam's
leaves) from the same weights, inputs and seeds.
"""

from __future__ import annotations

import sys
import time

import torch

from .. import arith_hstu, checks, port_hstu, traffic_hstu
from ..reference import hstu as reference
from ..trace import Pace, Slice
from ..traffic import dropout_seeds
from ..weights_hstu import initial_leaves
from .train_dlrm import _phase_seconds


def pad_steps(chunk: torch.Tensor, live: int, pad_id: int):
    """A chunk whose first ``live`` steps are ``chunk[:live]`` and whose other
    steps are weight-0 histories of padding: ``(ids, labels, weights)``."""
    ids = chunk.clone()
    ids[live:, :, 0] = pad_id
    ids[live:, :, 1] = 0
    weights = torch.ones(ids.shape[:2], device=ids.device)
    weights[live:] = 0.0
    return ids, torch.zeros_like(weights), weights


def reference_steps(ids: torch.Tensor, seeds: list[int], k: int):
    """The reference's steps for the pool's first three steps ``ids [3, B, 2,
    N]`` and their seeds, as the runner's two calls take them: the first
    step, K - 1 pad steps (None), the next two and K - 2 pad steps."""
    ones = torch.ones(ids.shape[1], device=ids.device)
    live = [(ids[t], ones, seeds[t]) for t in range(3)]
    return [live[0]] + [None] * (k - 1) + live[1:] + [None] * (k - 2)


def chunk_work(pool: torch.Tensor, pad_id: int) -> list[tuple[int, int, int]]:
    """Each chunk's ``(T, P, S)``, summed over its steps."""
    out = []
    for chunk in pool:
        lens = (chunk[:, :, 0] != pad_id).sum(-1)
        out.append(tuple(map(sum, zip(*(arith_hstu.work(s) for s in lens)))))
    return out


def run(ctx) -> dict:
    port_hstu.check()
    from deepctr_torch.ops import hstu as hstu_op
    from deepctr_torch.train.step import make_scan_train_step
    from deepctr_torch.utils import prof

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.dev
    k, b = int(cfg["scan_steps"]), int(cfg["batch"])
    pad_id = int(cfg["items"])
    prof.enable(ctx.trace)
    try:
        pool = traffic_hstu.train_pool(traffic_hstu.sampler(cfg, tr, ctx.seed, dev), cfg, tr,
                                       ctx.seed)
        chunks = pool.shape[0]
        work = chunk_work(pool, pad_id)
        ones = torch.ones((k, b), device=dev)
        zeros = torch.zeros((k, b), device=dev)
        leaves0 = initial_leaves(cfg, ctx.seed, dev)
        state, sch, opt = port_hstu.train_state(cfg, ctx.seed, dev)
        scan = make_scan_train_step(sch, None, opt)
        seeds = dropout_seeds(ctx.seed, 3)

        # the first three steps of the pool, through the window's own call
        ids_a, labels_a, w_a = pad_steps(pool[0], 1, pad_id)
        losses_a = scan(state, ids_a, labels_a, w_a, seeds=seeds[:1] * k)[1]
        grad_sq = port_hstu.first_grad_sq(state, cfg)
        order = list(range(1, k)) + [0]
        ids_b, labels_b, w_b = pad_steps(pool[0][order], 2, pad_id)
        losses_b = scan(state, ids_b, labels_b, w_b, seeds=seeds[1:3] + seeds[:1] * (k - 2))[1]
        norms = torch.stack(grad_sq + port_hstu.change_sq(state, leaves0)).sqrt().tolist()
        names = reference.leaf_names(cfg)
        prog = {"losses": [float(losses_a[0]), float(losses_b[0]), float(losses_b[1])],
                "grad_norms": dict(zip(names, norms[:len(names)])),
                "change_norms": dict(zip(names, norms[len(names):]))}
        del ids_a, labels_a, w_a, ids_b, labels_b, w_b
        check_inputs = pool[0][:3].cpu()

        for c in range(int(tr["warmup_chunks"])):   # the window's loop, untimed
            scan(state, pool[c % chunks], zeros, ones)
        sl = Slice(dev, ctx.trace)
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - ctx.t_start
        pace = Pace(ctx.seconds, ctx.trace, int(tr["profile_chunks"]))
        window_losses, in_slice, phase_s, counted = [], [], None, None
        n = 0
        pace.begin()
        while True:
            act = pace.step(n)
            if act == "start":
                prof.drain()   # the stamps before the slice
                counted = hstu_op.counts()
            go = pace.apply(act, n, sl)
            if pace.ended and phase_s is None and ctx.trace:
                phase_s = _phase_seconds(prof.drain(), len(in_slice)) or {}
                after = hstu_op.counts()
                counted = {name: after[name] - counted[name] for name in after}
            if not go:
                break
            c = n % chunks
            if pace.started_at is not None and not pace.ended:
                in_slice.append(c)
            window_losses.append(scan(state, pool[c], zeros, ones)[1])
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
            reading["tokens"], reading["pairs"], reading["supervised"] = (
                sum(work[c][i] for c in in_slice) for i in range(3))
            reading["counters"] = counted
            print(f"train_hstu: the program's counters over the slice {counted}; "
                  f"the pool's valid positions {reading['tokens']}", file=sys.stderr)
            if phase_s:
                reading["phase_s"] = phase_s
                print("train_hstu: device ms a step by phase: " + ", ".join(
                    f"{name} {1e3 * sec / reading['steps']:.4f}"
                    for name, sec in phase_s.items()), file=sys.stderr)
        scan.graph.clear()
        del state, scan, window_losses, pool, ones, zeros
    finally:
        prof.enable(False)
        prof.drain()
    if cuda:
        torch.cuda.empty_cache()

    # the reference's two chunks from the same weights, inputs and seeds
    steps = reference_steps(check_inputs.to(dev), seeds, k)
    ref = reference.train_reading(cfg, leaves0, steps)
    return {
        "e2e": {"train_examples_per_s": n * k * b / window_s, "setup_s": setup_s},
        "attempted": n * k, "failed": failed, "memory_peak_bytes": peak,
        "readings": [reading] if reading is not None else [],
        "numbers": checks.train_numbers(prog, ref),
        "detail": checks.train_detail(prog, ref),
    }
