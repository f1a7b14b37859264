"""Runner of the ``train_xdeepfm`` kind: xDeepFM on the port's scan route on
one device (``deepctr_torch.train.step.make_scan_train_step``; on the card
one CUDA graph replay of K steps a chunk), fed from one-hot chunks staged on
the device (``traffic.py``, as the ``train`` runner draws them).

Set-up: the program's xDeepFM imported first (a program without it fails
here, at once); the pool of inputs and the weights from the seed
(``traffic.py``, ``weights_xdeepfm.py``); the port's train state built from
the configuration and the weights loaded into it; then the first three
steps of the pool through the window's own call on the same state, as the
``train_dlrm`` runner takes them (a chunk whose first step is live and whose
other K - 1 are weight-0 pad steps, then one with the next two live), which
captures the graph. Then ``warmup_chunks`` chunks run untimed.

Window: the pool's ``pool_chunks`` chunks replayed in order, in a cycle, for
``--seconds`` on the host clock, ending in a synchronize;
``train_examples_per_s`` is the examples of every chunk issued in it over
its seconds.

Traced (``--trace 1``), the program's own tracing is on from the start
(``deepctr_torch.utils.prof``), so the captured graph stamps the device's
clock at each phase of each step (``lookup``, ``cin``, ``dnn``,
``backward``, ``cin_bwd``, ``sparse``, ``dense``). The stamps are drained as
the profiled slice starts and once it has stopped, and the slice's reading
gets each phase's device seconds over its replays (``phase_s``, also
printed to standard error as ms a step), beside the distinct rows of its
steps (``distinct_rows``). A program whose graph stamps nothing gives no
``phase_s``, and the readers of the phases give nothing.

After the window the program's state is freed, and the reference follows
the two chunks (three live steps, thirteen pad steps, which move Adam's
leaves) from the same weights and inputs on the rows they touch.
"""

from __future__ import annotations

import sys
import time

import torch

from .. import checks, port, port_xdeepfm
from ..port import pad_steps
from ..reference import xdeepfm as reference
from ..trace import Pace, Slice
from ..traffic import Fields, IdSampler, train_pool
from ..weights_xdeepfm import initial_dense, table_rows
from .train_dlrm import _distinct, _phase_seconds


def reference_steps(ids: torch.Tensor, labels: torch.Tensor, k: int, pad_id: int):
    """The reference's steps for the pool's first three ``ids [3, B, S]``
    and ``labels [3, B]``, as the runner's two calls take them: ``(uniq,
    steps)``, ``steps`` the first step, K - 1 pad steps (None), the next two
    and K - 2 pad steps, each live one ``(local_ids, mask, labels)``."""
    uniq = torch.unique(ids.reshape(-1))
    live = [(torch.searchsorted(uniq, ids[t]), (ids[t] != pad_id).float(), labels[t])
            for t in range(3)]
    return uniq, [live[0]] + [None] * (k - 1) + live[1:] + [None] * (k - 2)


def run(ctx) -> dict:
    port_xdeepfm.check()
    from deepctr_torch.train.step import make_scan_train_step
    from deepctr_torch.utils import prof

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.dev
    f = Fields(cfg)
    sch = port.schema(cfg)
    k, b = int(cfg["scan_steps"]), int(cfg["batch"])
    prof.enable(ctx.trace)
    try:
        sampler = IdSampler(f, float(tr["zipf_alpha"]), ctx.seed, dev)
        pool_ids, pool_labels = train_pool(sampler, cfg, tr, ctx.seed, 0, b)
        del sampler
        chunks = pool_ids.shape[0]
        distinct = _distinct(pool_ids) if ctx.trace else None
        ones = torch.ones(pool_labels.shape[1:], device=dev)
        dense0 = initial_dense(cfg, ctx.seed, dev)
        state, sparse_opt, dense_opt = port_xdeepfm.train_state(cfg, sch, ctx.seed, dev)
        scan = make_scan_train_step(sch, sparse_opt, dense_opt)

        # the first three steps of the pool, through the window's own call
        ids_a, labels_a, w_a = pad_steps(pool_ids[0], pool_labels[0], 1, f.pad_id)
        losses_a = scan(state, ids_a, labels_a, w_a)[1]
        grad_sq = port_xdeepfm.first_grad_sq(state, cfg)
        order = list(range(1, k)) + [0]
        ids_b, labels_b, w_b = pad_steps(pool_ids[0][order], pool_labels[0][order], 2,
                                         f.pad_id)
        losses_b = scan(state, ids_b, labels_b, w_b)[1]
        norms = torch.stack(grad_sq + port_xdeepfm.change_sq(state, cfg, ctx.seed, dense0))
        norms = norms.sqrt().tolist()
        names = reference.leaf_names(cfg)
        prog = {"losses": [float(losses_a[0]), float(losses_b[0]), float(losses_b[1])],
                "grad_norms": dict(zip(names, norms[:len(names)])),
                "change_norms": dict(zip(names, norms[len(names):]))}
        del ids_a, labels_a, w_a, ids_b, labels_b, w_b
        check_inputs = (pool_ids[0][:3].cpu(), pool_labels[0][:3].cpu())

        for c in range(int(tr["warmup_chunks"])):   # the window's loop, untimed
            scan(state, pool_ids[c % chunks], pool_labels[c % chunks], ones)
        sl = Slice(dev, ctx.trace)
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - ctx.t_start
        pace = Pace(ctx.seconds, ctx.trace, int(tr["profile_chunks"]))
        window_losses, in_slice, phase_s = [], [], None
        n = 0
        pace.begin()
        while True:
            act = pace.step(n)
            if act == "start":
                prof.drain()   # the stamps before the slice
            go = pace.apply(act, n, sl)
            if pace.ended and phase_s is None and ctx.trace:
                phase_s = _phase_seconds(prof.drain(), len(in_slice)) or {}
            if not go:
                break
            c = n % chunks
            if pace.started_at is not None and not pace.ended:
                in_slice.append(c)
            window_losses.append(scan(state, pool_ids[c], pool_labels[c], ones)[1])
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
            if distinct is not None:
                reading["distinct_rows"] = sum(distinct[c] for c in in_slice)
            if phase_s:
                reading["phase_s"] = phase_s
                print("train_xdeepfm: device ms a step by phase: " + ", ".join(
                    f"{name} {1e3 * sec / reading['steps']:.4f}"
                    for name, sec in phase_s.items()), file=sys.stderr)
        scan.graph.clear()
        del state, scan, window_losses, pool_ids, pool_labels, ones
    finally:
        prof.enable(False)
        prof.drain()
    if cuda:
        torch.cuda.empty_cache()

    # the reference's two chunks on the rows they touch
    uniq, steps = reference_steps(*(t.to(dev) for t in check_inputs), k, f.pad_id)
    ref = reference.train_reading(cfg, table_rows(cfg, ctx.seed, dev, uniq), dense0, steps)
    return {
        "e2e": {"train_examples_per_s": n * k * b / window_s, "setup_s": setup_s},
        "attempted": n * k, "failed": failed, "memory_peak_bytes": peak,
        "readings": [reading] if reading is not None else [],
        "numbers": checks.train_numbers(prog, ref),
        "detail": checks.train_detail(prog, ref),
    }
