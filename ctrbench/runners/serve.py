"""Runner of the ``serve`` kind: the port's scorer
(``deepctr_torch.serving.Scorer.predict``) on the configuration's weights,
in a closed loop of one caller.

Set-up: the pool of requests from the seed, as host arrays of packed ids
(``traffic.serve_requests``: a fixed set of lognormal sizes in the seed's
order); the weights from the seed, the table at a trained model's scale
(``weights.served_table``), loaded into the port's model; the scorer
built and called ``warmup_requests`` times (every request is padded to the
scorer's one batch shape).

Window: the caller sends the pool's requests in order, in a cycle, each as
soon as the last one's probabilities are in host memory, for ``--seconds``.
A request's latency runs from the call to its return; ``score_p95_ms`` is
the 95th percentile of every request of the window and ``score_rows_per_s``
their rows (padding not counted) over the window's seconds.

After the window the scorer is freed, and the reference scores a sample of
the served requests (drawn from the seed, with the longest among them) from
the same weights; their probabilities are compared.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import checks, port
from ..reference import fnn as reference
from ..trace import Pace, Slice
from ..traffic import Fields, IdSampler, sample_requests, serve_requests
from ..weights import initial_tower, served_table


def run(ctx) -> dict:
    from deepctr_torch.serving import Scorer

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.dev
    fields = Fields(cfg)
    sampler = IdSampler(fields, float(tr["zipf_alpha"]), ctx.seed, dev)
    requests = serve_requests(sampler, tr, ctx.seed)
    del sampler
    sizes = [len(r) for r in requests]
    sch = port.schema(cfg)
    model = port.model(cfg, sch, dev)
    port.load_weights(model, served_table(cfg, ctx.seed, dev),
                      initial_tower(cfg, ctx.seed, dev))
    scorer = Scorer(model, sch, batch_size=int(cfg["batch"]), quantize=tr["quantize"])
    for i in range(int(tr["warmup_requests"])):
        scorer.predict(requests[i % len(requests)])

    sl = Slice(dev, ctx.trace)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - ctx.t_start
    pace = Pace(ctx.seconds, ctx.trace, int(tr["profile_requests"]))
    latencies, answers = [], {}
    rows = failed = n = 0
    pace.begin()
    while pace.apply(pace.step(n), n, sl):
        i = n % len(requests)
        t = time.perf_counter()
        p = scorer.predict(requests[i])
        latencies.append(time.perf_counter() - t)
        rows += sizes[i]
        failed += p.shape != (sizes[i],)
        answers[i] = p
        n += 1
    window_s = time.perf_counter() - pace.t0
    sl.close()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    reading = sl.reading()
    if reading is not None:
        reading["requests"] = reading["units"]
    del scorer, model
    if cuda:
        torch.cuda.empty_cache()

    picked = sample_requests(n, sizes, int(tr["sample_requests"]), ctx.seed)
    ref = probabilities(cfg, ctx.seed, dev, [requests[i] for i in picked])
    return {
        "e2e": {"score_p95_ms": float(np.percentile(latencies, 95)) * 1e3,
                "score_rows_per_s": rows / window_s, "setup_s": setup_s},
        "attempted": n, "failed": int(failed), "memory_peak_bytes": peak,
        "readings": [reading] if reading is not None else [],
        "numbers": {"score_gap": checks.serve_number([answers.get(i) for i in picked], ref)},
    }


def probabilities(cfg: dict, seed: int, dev, reqs: list, precision: str = "f32",
                  fault: str | None = None) -> list:
    """The reference's click probabilities (float64) of each request, from
    the run's weights."""
    table, tower = served_table(cfg, seed, dev), initial_tower(cfg, seed, dev)
    sizes = [len(r) for r in reqs]
    ids = torch.from_numpy(np.concatenate(reqs)).to(dev).long()
    logits = reference.serve_logits(cfg, table, tower, ids, precision, fault)
    probs = torch.sigmoid(logits.double()).cpu().numpy()
    return np.split(probs, np.cumsum(sizes)[:-1])
