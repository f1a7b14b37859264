"""Extended benchmark suite of the port -> ``BENCH_TORCH.md`` and ``BENCH_TORCH.json``.

The counterpart of ``tools/bench_suite.py`` (which writes ``BENCH.md`` for the
JAX package), with its section names, its ``--sections`` default and its
result keys wherever they mean the same thing. Every number comes from the
port's modules on ``--device`` (the card unless ``--device cpu``; ``cuda``
without a card raises). The headline configuration is ``bench.py``'s, built
here (:func:`build`, staged by :func:`stage`, timed by :func:`measure`); the
``full*``, ``batch*``, ``streamtrain`` and ``servingquality`` sections and
``step_breakdown.py`` reuse it.

Sections (``--sections``, a comma list; results accumulate in
``BENCH_TORCH.json`` of the working directory across invocations):

  parser        native yx parser against the Python one, 100,000 rows (host)
  parserscale   two shards of 300,000 rows, serial against two threads (host)
  stream        ``StreamSource`` over 8 yx shards of 150,000 rows, then their
                npz caches (host)
  criteostream  the same over 8 Criteo TSV shards of 100,000 rows (host)
  models        LR, FM, FNN and DeepFM on ``ipinyou_like_schema()``, batch 8192,
                the scan route's graph of 8 steps
  full, batch, batchbf16, batchbf16med
                the headline FNN on ``ipinyou_full_schema()`` at batch 8192
                (f32 table), 16384 and 32768 (f32 and bf16 tables;
                ``batchbf16med``: the median of 5 at 32768, bf16)
  lookup        the step's row gather, chained, and ``scatter_add_dedup``
  serving       ``Scorer`` with f32, bf16 and int8 tables, batch 8192
  servingquality  the three scorers' AUC after 2 epochs of the headline FNN
  streamtrain   ``train/loop.py::fit`` on the npz shards' ``scan_chunks`` with
                the device prefetcher, headline configuration
  h2d           ``DevicePrefetcher``'s copies of ``[8, 8192, 18]`` chunks

Timing protocol: device times from CUDA events around many calls after a
warm-up, with a sleep kernel holding the stream while the host enqueues
them (a graph replay's events bracket the replays alone); wall times from the host clock around work that ends in
``torch.cuda.synchronize()``; medians of 5, with ``_sigma`` keys, where the
reference took medians; a graph's capture is never inside a timed window.
Each section prints and records the peak device memory it reached
(``device_peak_mib/<section>``). The port's ids are int64 on the card and
int32 on the host, so lookup and H2D bytes are not the reference's: each
byte count is written beside its rate.

Not ported, and why:
- the reference's timing protocol, the marginal cost of T against 2T steps
  in one ``lax.scan``: it served a tunneled runtime whose barriers were not
  trustworthy; on the card a synchronize and CUDA events are;
- ``models``' pairs of a jnp path and a Pallas path (``fm``/``fm_pallas``,
  ``fnn``/``fnn_pallas``): the port's device picks its path, so the card has
  one, the hand-written kernels, under the keys ``fm`` and ``fnn``;
- ``fullbf16`` and ``dispatch``, the headline at batch 8192 with its bf16
  table and 8 replays of its graph on pre-staged chunks: the benchmark's
  cell ``fnn_ipinyou.train`` measures that configuration and that traffic,
  with a bound and a correctness check;
- ``headline``, the f32 and bf16 tables in turns with a verdict:
  ``step_breakdown.full_in_turns`` makes that comparison;
- the ``_bf16scratch`` variants (``SparseAdagrad.scratch_dtype``): declared
  not to port, its measured win was noise (``BENCH.md``, round 4);
  ``batchbf16`` runs the bf16 table alone;
- the split plan of ``ops/split_embed.py``, a TPU gather mechanism: the
  port gathers every slot, so ``lookup`` times one gather of all rows;
- the hand-written roofline section that ``BENCH.md`` keeps across runs.

Usage:
  python -m deepctr_torch.tools.bench_suite --sections parser,models,full,lookup,serving,stream
  python -m deepctr_torch.tools.bench_suite --sections parser,stream --device cpu --small
``--small`` cuts every size, for the tests; a run with ``--device cpu``
writes no file.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import json
import os
import tempfile
import threading
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils.artifacts import protocol_stamp

TOOL = "deepctr_torch/tools/bench_suite.py"
DEFAULT_SECTIONS = "parser,models,full,lookup,serving,stream"
OUT_JSON, OUT_MD = "BENCH_TORCH.json", "BENCH_TORCH.md"
SCAN_K = 8          # the configs' train.scan_steps
REPEATS = 5         # the reference's median protocol
CALLS, WARMUP = 50, 5   # timed calls of a device section, after the warm-up
EPOCHS = 5          # timed stream epochs, after one that warms the page cache
# the headline configuration, bench.py's
BATCH = 8192
K = 10
HIDDEN = (200, 300, 100)
DROPOUT = 0.5
MEASURE_STEPS = 40
SPARSE_LR, DENSE_LR = 0.05, 0.02
TABLE_DTYPE = "bf16"
DATA_SEED, INIT_SEED = 3, 0


class Headline(NamedTuple):
    """The headline configuration, built: its state and its scan step."""

    state: object            # train.step.TrainState
    scan_step: Callable      # make_scan_train_step: a CUDA graph of K steps
    sparse_opt: object
    dense_opt: object


def build(schema, device, *, table_dtype: str = TABLE_DTYPE, k: int = K,
          hidden: tuple = HIDDEN, dropout: float = DROPOUT,
          seed: int = INIT_SEED) -> Headline:
    """``bench.py``'s model, optimizers and state on ``device``: FNN with a
    tanh tower and dropout, ``SparseAdagrad(0.05)`` on the table, Adagrad
    0.02 on the tower, initialised from ``seed``."""
    from ..models import MlpSpec, make_fnn
    from ..optim import SparseAdagrad, make_dense_optimizer
    from ..train import init_state, make_scan_train_step

    model = make_fnn(schema, k=k, mlp=MlpSpec(hidden=hidden, activation="tanh",
                                              dropout=dropout), device=device)
    sopt = SparseAdagrad(SPARSE_LR)
    dopt = make_dense_optimizer("adagrad", DENSE_LR)
    state = init_state(model, schema, sopt, dopt, seed=seed, table_dtype=table_dtype)
    return Headline(state, make_scan_train_step(schema, sopt, dopt), sopt, dopt)


def stage(ids: np.ndarray, labels: np.ndarray, batch: int, steps: int, device,
          scan_k: int = SCAN_K) -> list:
    """The first ``steps`` batches on ``device`` as chunks ``(ids [K, B, S]
    int64, labels [K, B], weights [K, B])`` of ``scan_k`` steps."""
    chunks, n = steps // scan_k, steps * batch
    ids_t = torch.from_numpy(ids[:n]).to(device).long().reshape(chunks, scan_k, batch, -1)
    y_t = torch.from_numpy(labels[:n]).to(device).reshape(chunks, scan_k, batch)
    w_t = torch.ones(chunks, scan_k, batch, device=device)
    return [(ids_t[c], y_t[c], w_t[c]) for c in range(chunks)]


def time_pass(run: Callable, chunks: list, device) -> tuple[float, float | None]:
    """``(wall s, device ms)`` of ``run(chunk)`` over ``chunks``: the host
    clock around the calls and a ``synchronize()``, and CUDA events around
    the same calls (None on the CPU)."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for chunk in chunks:
        run(chunk)
    if cuda:
        end.record()
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    return wall, start.elapsed_time(end) if cuda else None


def measure(run: Callable, chunks: list, device, batch: int,
            repeats: int = REPEATS) -> dict:
    """``repeats`` timed passes of ``run`` over ``chunks`` after one untimed
    pass over the first chunk (a graph's capture and first replay):
    examples/s of each pass on the host clock, their median and standard
    deviation, wall and device ms a step (medians), and the kernels'
    launches over the last pass."""
    from ..ops.kernels import count_difference, launch_counts, tower_launches

    run(chunks[0])
    steps = sum(c[0].shape[0] for c in chunks)
    walls, devices = [], []
    for _ in range(repeats):
        before = launch_counts()
        wall, device_ms = time_pass(run, chunks, device)
        walls.append(wall)
        devices.append(device_ms)
    launches = tower_launches(count_difference(launch_counts(), before))
    rates = [steps * batch / w for w in walls]
    return {"rates": rates, "median": float(np.median(rates)),
            "sigma": float(np.std(rates)),
            "wall_ms": float(np.median(walls)) * 1e3 / steps,
            "device_ms": (float(np.median(devices)) / steps
                          if devices[0] is not None else None),
            "launches": launches}


@dataclasses.dataclass
class Bench:
    """One run of the suite: its device, its sizes, its scratch directory
    (data files are written there once a run) and its results."""

    device: torch.device
    small: bool
    tmp: str
    results: dict

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def size(self, full: int, small: int) -> int:
        return small if self.small else full

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def call_ms(self, fn: Callable) -> float:
        """ms a call of ``fn``: CUDA events around ``CALLS`` calls after
        ``WARMUP`` (on the CPU the host clock). A sleep kernel holds the
        stream while the host enqueues the calls, so the events bracket the
        device's work and not the host's launch overhead."""
        t0 = time.perf_counter()
        for _ in range(WARMUP):
            fn()
        host_s = (time.perf_counter() - t0) / WARMUP
        self.sync()
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            return (time.perf_counter() - t0) * 1e3 / CALLS
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # twice the host's time for the calls, at 2 GHz; at most 0.2 s
        torch.cuda._sleep(int(min(2 * CALLS * host_s, 0.2) * 2e9))
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / CALLS

    def wall_s(self, fn: Callable) -> float:
        """Host seconds of ``fn`` and a synchronize after it."""
        self.sync()
        t0 = time.perf_counter()
        fn()
        self.sync()
        return time.perf_counter() - t0


def _yx_shards(b: Bench, tag: str, schema, n_shards: int, per: int, seeds) -> list[str]:
    """``n_shards`` yx files of ``per`` rows in the run's directory, shard i
    from ``synthetic.generate(k=2, seed=seeds[i])``; one ``seeds`` entry
    draws all shards at once and cuts them."""
    from ..data import synthetic

    paths = [os.path.join(b.tmp, f"{tag}_{i}.yx") for i in range(n_shards)]
    if len(seeds) == 1:
        ds = synthetic.generate(schema, num_examples=n_shards * per, k=2, seed=seeds[0])
        parts = [synthetic.SyntheticDataset(schema, ds.ids[i * per:(i + 1) * per],
                                            ds.labels[i * per:(i + 1) * per],
                                            ds.bayes_logits[i * per:(i + 1) * per])
                 for i in range(n_shards)]
    else:
        parts = [synthetic.generate(schema, num_examples=per, k=2, seed=s) for s in seeds]
    for path, part in zip(paths, parts):
        synthetic.write_yx_file(part, path)
    return paths


def _median(values) -> tuple[float, float]:
    return float(np.median(values)), float(np.std(values))


# ---- host sections ----------------------------------------------------------


def bench_parser(b: Bench) -> None:
    from ..data import ipinyou_like_schema, native, parser

    schema = ipinyou_like_schema()
    path, = _yx_shards(b, "parse", schema, 1, b.size(100_000, 5_000), [9])
    size_mb = os.path.getsize(path) / 1e6
    with open(path, "rb") as f:
        data = f.read()
    native.parse_yx_bytes(data[:data.index(b"\n") + 1], schema)   # build and load it
    t0 = time.perf_counter()
    native.parse_yx_bytes(data, schema)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    parser.parse_yx_lines(data.splitlines(), schema)
    t_py = time.perf_counter() - t0
    b.results["parser_native_mb_per_s"] = size_mb / t_native
    b.results["parser_python_mb_per_s"] = size_mb / t_py
    print(f"parser: {size_mb:.1f} MB, native {size_mb / t_native:.0f} MB/s, python "
          f"{size_mb / t_py:.1f} MB/s ({t_py / t_native:.0f}x)")


def _stream_rates(paths, schema, batch: int, fmt: str) -> tuple[float, float]:
    """Median rows/s (and sigma) of ``EPOCHS`` epochs of ``StreamSource``
    after one that warms the page cache."""
    from ..data import StreamSource

    def epoch_rate(epoch):
        src = StreamSource(paths=paths, schema=schema, batch_size=batch, fmt=fmt,
                           buffer_rows=1 << 18, seed=0)
        t0 = time.perf_counter()
        rows = sum(x.ids.shape[0] for x in src.batches(epoch))
        return rows / (time.perf_counter() - t0)

    epoch_rate(0)
    return _median([epoch_rate(e) for e in range(1, EPOCHS + 1)])


def _bench_stream_lanes(b: Bench, prefix: str, paths, n_rows: int, schema,
                        fmt: str) -> None:
    """Text shards of ``n_rows`` rows in all, then their npz caches, through
    ``StreamSource``."""
    from ..data.cache import cache_text_file

    batch = b.size(8192, 256)
    size_mb = sum(os.path.getsize(p) for p in paths) / 1e6
    rate, sigma = _stream_rates(paths, schema, batch, fmt)
    b.results[f"{prefix}_rows_per_s"] = rate
    b.results[f"{prefix}_rows_per_s_sigma"] = sigma
    b.results[f"{prefix}_mb_per_s"] = rate * size_mb / n_rows
    print(f"{prefix}: {len(paths)} shards, {n_rows} rows, {size_mb:.1f} MB of text; "
          f"median {rate:,.0f} rows/s, sigma {sigma:,.0f} "
          f"({b.results[f'{prefix}_mb_per_s']:.0f} MB/s of text)")
    npz = [cache_text_file(p, schema, fmt=fmt) for p in paths]
    rate, sigma = _stream_rates(npz, schema, batch, fmt)
    b.results[f"{prefix}_npz_rows_per_s"] = rate
    b.results[f"{prefix}_npz_rows_per_s_sigma"] = sigma
    print(f"{prefix} npz: median {rate:,.0f} rows/s, sigma {sigma:,.0f}")


def bench_stream(b: Bench) -> None:
    from ..data import ipinyou_like_schema

    schema = ipinyou_like_schema()
    n_shards, per = b.size(8, 2), b.size(150_000, 5_000)
    paths = _yx_shards(b, "stream", schema, n_shards, per, [9])
    _bench_stream_lanes(b, "stream", paths, n_shards * per, schema, "yx")


def bench_criteo_stream(b: Bench) -> None:
    from ..data.criteo import criteo_schema, write_synth_criteo_file

    schema = criteo_schema()
    n_shards, per = b.size(8, 2), b.size(100_000, 2_000)
    paths = [os.path.join(b.tmp, f"criteo_{i}.tsv") for i in range(n_shards)]
    for i, path in enumerate(paths):
        write_synth_criteo_file(path, per, schema=schema, seed=100 + i)
    _bench_stream_lanes(b, "criteo_stream", paths, n_shards * per, schema, "criteo")


def bench_parser_scaling(b: Bench) -> None:
    from ..data import ipinyou_like_schema, native

    schema = ipinyou_like_schema()
    paths = _yx_shards(b, "pscale", schema, 2, b.size(300_000, 5_000), [40, 41])
    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    native.parse_yx_bytes(blobs[0], schema)   # build and warm the library

    def serial():
        t0 = time.perf_counter()
        for blob in blobs:
            native.parse_yx_bytes(blob, schema)
        return time.perf_counter() - t0

    def two_threads():
        ts = [threading.Thread(target=native.parse_yx_bytes, args=(blob, schema))
              for blob in blobs]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return time.perf_counter() - t0

    s = [serial() for _ in range(REPEATS)]
    p2 = [two_threads() for _ in range(REPEATS)]
    b.results["parser_2thread_speedup"] = float(np.median(s) / np.median(p2))
    print(f"parser thread scaling: serial {np.median(s):.3f} s, two threads "
          f"{np.median(p2):.3f} s -> {b.results['parser_2thread_speedup']:.2f}x "
          f"({os.cpu_count()} CPUs; ideal 2.0)")


# ---- training sections ------------------------------------------------------


def bench_models(b: Bench) -> None:
    from ..data import ipinyou_like_schema, synthetic
    from ..models import MlpSpec, make_deepfm, make_fm, make_fnn, make_lr
    from ..optim import SparseAdagrad, make_dense_optimizer
    from ..train import init_state, make_scan_train_step

    schema = ipinyou_like_schema()
    batch = b.size(8192, 256)
    ds = synthetic.generate(schema, num_examples=2 * SCAN_K * batch, k=4, seed=3)
    chunks = stage(ds.ids, ds.labels, batch, 2 * SCAN_K, b.device)
    makers = {
        "lr": lambda: make_lr(schema, device=b.device),
        "fm": lambda: make_fm(schema, k=10, device=b.device),
        "fnn": lambda: make_fnn(schema, k=10, mlp=MlpSpec(hidden=(200, 300, 100),
                                                         dropout=0.5), device=b.device),
        "deepfm": lambda: make_deepfm(schema, k=10, device=b.device),
    }
    for name, make in makers.items():
        sopt, dopt = SparseAdagrad(0.05), make_dense_optimizer("adagrad", 0.02)
        state = init_state(make(), schema, sopt, dopt, seed=0)
        scan = make_scan_train_step(schema, sopt, dopt)
        out = measure(lambda c: scan(state, *c), chunks, b.device, batch)
        launches = {n: c / len(chunks) for n, c in out["launches"].items()}
        b.results[f"train_examples_per_s/{name}"] = out["median"]
        b.results[f"device_ms_per_step/{name}"] = out["device_ms"]
        b.results[f"launches_per_replay/{name}"] = launches
        print(f"{name}: wall {out['wall_ms']:.4f} ms a step, device "
              f"{_ms(out['device_ms'])} a step -> {out['median']:,.0f} examples/s "
              f"(sigma {out['sigma']:,.0f}); launches a replay of {SCAN_K} steps {launches}")
        del scan, state
        gc.collect()


def _ms(value) -> str:
    return "not measured" if value is None else f"{value:.4f} ms"


def _fnn_full(b: Bench, key: str, batch: int, table_dtype: str, repeats: int) -> list:
    """The headline FNN on the full vocabulary at ``batch``: examples/s of
    ``repeats`` timed passes of 2 replays (16 steps) after the capture."""
    from ..data import ipinyou_full_schema, synthetic

    schema = ipinyou_full_schema()
    batch = b.size(batch, batch // 32)
    ds = synthetic.generate(schema, num_examples=2 * SCAN_K * batch, k=2, seed=5)
    h = build(schema, b.device, table_dtype=table_dtype)
    chunks = stage(ds.ids, ds.labels, batch, 2 * SCAN_K, b.device)
    out = measure(lambda c: h.scan_step(h.state, *c), chunks, b.device, batch,
                     repeats=repeats)
    table = h.state.table
    elem = table.element_size()
    gather = batch * schema.num_slots * (table.shape[1] * elem + 8)
    state_bytes = table.numel() * (elem + 4)   # the table and its f32 accumulator
    name = key.split("/", 1)[1]
    b.results[key] = out["median"]
    b.results[f"device_ms_per_step/{name}"] = out["device_ms"]
    # the rows and int64 ids gathered, and dense-mode Adagrad's floor: the
    # table and its accumulator read and written once
    b.results[f"bytes_per_step/{name}"] = gather + 2 * state_bytes
    print(f"{key}: batch {batch}, {table_dtype} table: wall {out['wall_ms']:.4f} ms a "
          f"step, device {_ms(out['device_ms'])} -> {out['median']:,.0f} examples/s; a "
          f"step gathers {gather / 1e6:.2f} MB (rows and int64 ids) and dense-mode "
          f"Adagrad reads and writes the {state_bytes / 1e6:.1f} MB of table and "
          f"accumulator: {(gather + 2 * state_bytes) / 1e6:.1f} MB a step")
    return out["rates"]


def bench_full(b: Bench) -> None:
    _fnn_full(b, "train_examples_per_s/fnn_full_vocab", 8192, "f32", 1)


def bench_batch(b: Bench) -> None:
    for batch in (16384, 32768):
        _fnn_full(b, f"train_examples_per_s/fnn_full_vocab_b{batch}", batch, "f32", 1)


def bench_batch_bf16(b: Bench) -> None:
    _fnn_full(b, "train_examples_per_s/fnn_full_vocab_b32768_bf16table", 32768, "bf16", 1)


def bench_batch_bf16_median(b: Bench) -> None:
    rates = _fnn_full(b, "peak_median/fnn_full_vocab_b32768_bf16", 32768, "bf16", REPEATS)
    b.results["peak_sigma/fnn_full_vocab_b32768_bf16"] = float(np.std(rates))


def bench_lookup(b: Bench) -> None:
    from ..data import ipinyou_like_schema
    from ..ops.scatter import scatter_add_dedup

    schema = ipinyou_like_schema()
    v, d = schema.padded_vocab_size, 11
    m = b.size(8192, 256) * schema.num_slots
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)).to(b.device)
    ids = torch.from_numpy(rng.integers(0, v, size=m)).to(b.device)   # int64
    cur = {"ids": ids}

    def lookup():
        rows = table[cur["ids"]]
        cur["ids"] = (cur["ids"] + rows[:, 0].long() * 0) % v

    ms = b.call_ms(lookup)
    gathered = m * d * 4
    b.results["embedding_lookups_per_s"] = m / (ms / 1e3)
    b.results["lookup_bytes_per_call"] = 2 * gathered + m * 8
    print(f"lookup: {ms:.4f} ms a call of {m} rows of {d} f32 from [{v}, {d}] "
          f"(reads {gathered / 1e6:.2f} MB of rows and {m * 8 / 1e6:.2f} MB of int64 "
          f"ids, writes {gathered / 1e6:.2f} MB; the chain adds 4 elementwise ops on "
          f"the ids) -> {m / (ms / 1e3):,.0f} lookups/s")

    grads = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(b.device)
    tbl = {"t": table.clone()}

    def scatter():
        tbl["t"] = scatter_add_dedup(tbl["t"], ids, grads) * 0.999

    ms = b.call_ms(scatter)
    b.results["scatter_add_rows_per_s"] = m / (ms / 1e3)
    b.results["scatter_add_bytes_per_call"] = gathered + m * 8 + 4 * v * d * 4
    print(f"scatter-add (ops/scatter.py::scatter_add_dedup, then a decay): {ms:.4f} ms "
          f"a call of {m} rows into [{v}, {d}] (reads {gathered / 1e6:.2f} MB of rows "
          f"and {m * 8 / 1e6:.2f} MB of ids, reads and writes the {v * d * 4 / 1e6:.2f} "
          f"MB table twice) -> {m / (ms / 1e3):,.0f} rows/s")


# ---- serving sections -------------------------------------------------------


def _serving_model(b: Bench, schema):
    from ..models import MlpSpec, make_fnn

    model = make_fnn(schema, k=10, mlp=MlpSpec(hidden=(200, 300, 100), dropout=0.5),
                     device=b.device)
    model.init_parameters(torch.Generator(device=b.device).manual_seed(0), schema.pad_id)
    return model


def bench_serving(b: Bench) -> None:
    from ..data import ipinyou_full_schema, synthetic
    from ..ops.kernels import launch_counts
    from ..serving import Scorer

    schema = ipinyou_full_schema()
    batch = b.size(8192, 256)
    ds = synthetic.generate(schema, num_examples=batch, k=2, seed=11)
    ids = torch.from_numpy(ds.ids).to(b.device).long()
    mask = (ids != schema.pad_id).float()
    for mode in (None, "bf16", "int8"):
        name = mode or "f32"
        scorer = Scorer(_serving_model(b, schema), schema, batch_size=batch, quantize=mode)

        @torch.inference_mode()
        def forward():
            scorer.model.apply_rows(scorer.rows(ids), mask)

        before = launch_counts()
        ms = b.call_ms(forward)
        launches = (launch_counts()["mlp.LAUNCHES"] - before["mlp.LAUNCHES"]) / (WARMUP + CALLS)
        host = [b.wall_s(lambda: scorer.logits(ds.ids)) * 1e3 for _ in range(REPEATS)]
        b.results[f"serving_examples_per_s/{name}"] = batch / (ms / 1e3)
        b.results[f"serving_host_ms_per_batch/{name}"] = float(np.median(host))
        print(f"serving {name}: {ms:.4f} ms a batch of {batch} on {b.device} (gather, "
              f"pool, tower; {'CUDA events' if b.cuda else 'host clock'}) -> "
              f"{batch / (ms / 1e3):,.0f} examples/s; "
              f"{np.median(host):.3f} ms a batch on the host clock (batching, H2D, "
              f"forward, D2H); table {scorer.table_bytes / 1e6:.1f} MB; tower "
              f"launches a forward {launches:g}")
        b.results[f"launches_per_batch/{name}"] = launches
        del scorer
        gc.collect()


def bench_serving_quality(b: Bench) -> None:
    from ..data import ipinyou_full_schema, synthetic
    from ..serving import Scorer
    from ..train import fit
    from ..utils.metrics import exact_auc

    schema = ipinyou_full_schema()
    n, n_test = b.size(600_000, 20_000), b.size(100_000, 4_000)
    ds = synthetic.generate(schema, num_examples=n, k=4, seed=21)
    tr, te = slice(0, n - n_test), slice(n - n_test, n)
    h = build(schema, b.device, table_dtype="f32")
    res = fit(h.state.model, schema, ds.ids[tr], ds.labels[tr], ds.ids[te],
              ds.labels[te], sparse_opt=h.sparse_opt, dense_opt=h.dense_opt,
              batch_size=b.size(8192, 256), epochs=2, seed=0, early_stop_patience=99,
              state=h.state)
    for mode in (None, "bf16", "int8"):
        scorer = Scorer(copy.deepcopy(res.state.model), schema,
                        batch_size=b.size(8192, 256), quantize=mode)
        auc = exact_auc(ds.labels[te], scorer.logits(ds.ids[te]))
        b.results[f"serving_auc/{mode or 'f32'}"] = float(auc)
        print(f"serving quality {mode or 'f32'}: AUC {auc:.4f} (train best "
              f"{res.best_auc:.4f})")
    for mode in ("bf16", "int8"):
        delta = b.results[f"serving_auc/{mode}"] - b.results["serving_auc/f32"]
        b.results[f"serving_auc_delta/{mode}"] = float(delta)
        print(f"  delta {mode} = {delta:+.4f} (band 0.002)")


# ---- the input path's sections ---------------------------------------------


def bench_stream_train(b: Bench) -> None:
    from ..data import StreamSource, ipinyou_full_schema, synthetic
    from ..data.cache import write_cache
    from ..train import fit

    schema = ipinyou_full_schema()
    batch, per = b.size(8192, 256), b.size(131_072, 2_048)
    paths = []
    for i in range(8):
        ds = synthetic.generate(schema, num_examples=per, k=2, seed=100 + i)
        paths.append(os.path.join(b.tmp, f"streamtrain_{i}.npz"))
        write_cache(paths[-1], ds.ids, ds.labels, schema)
    test = synthetic.generate(schema, num_examples=b.size(16_384, 512), k=2, seed=99)
    h = build(schema, b.device)
    src = StreamSource(paths=paths, schema=schema, batch_size=batch, buffer_rows=1 << 18,
                       seed=0)
    res = fit(h.state.model, schema, None, None, test.ids, test.labels,
              sparse_opt=h.sparse_opt, dense_opt=h.dense_opt, batch_size=batch,
              epochs=2, early_stop_patience=99, state=h.state, train_source=src,
              scan_steps=SCAN_K, scan_step=h.scan_step, prefetch=True)
    rate = res.history[1]["examples_per_s"]
    b.results["train_stream_examples_per_s"] = rate
    print(f"train while streaming: {8 * per} rows an epoch of npz shards, epoch 0 "
          f"(capture, page cache) {res.history[0]['examples_per_s']:,.0f} examples/s, "
          f"epoch 1 {rate:,.0f} examples/s (fit's host clock: stream, prefetcher, "
          f"replays)")


def bench_h2d(b: Bench) -> None:
    from ..data import DevicePrefetcher, ipinyou_full_schema

    schema = ipinyou_full_schema()
    batch, steps, slots = b.size(8192, 256), SCAN_K, schema.num_slots
    rng = np.random.default_rng(0)
    bufs = [(rng.integers(0, schema.padded_vocab_size, size=(steps, batch, slots))
             .astype(np.int32),
             rng.random((steps, batch), dtype=np.float32),
             np.ones((steps, batch), np.float32)) for _ in range(8)]
    chunk_bytes = sum(a.nbytes for a in bufs[0])
    count = 64

    def run(n):
        for _ in DevicePrefetcher(((steps, bufs[i % 8]) for i in range(n)), b.device):
            pass

    run(4)
    per = float(np.median([b.wall_s(lambda: run(count)) for _ in range(REPEATS)])) / count
    b.results["h2d_mb_per_s"] = chunk_bytes / per / 1e6
    b.results["h2d_examples_per_s_ceiling"] = steps * batch / per
    print(f"h2d: {chunk_bytes / 1e6:.2f} MB a chunk (int32 ids [{steps}, {batch}, "
          f"{slots}] as the stream gives them, f32 labels and weights; the step "
          f"widens the ids to int64 on the card), {per * 1e3:.3f} ms a chunk through "
          f"DevicePrefetcher's pinned ring and side stream -> "
          f"{b.results['h2d_mb_per_s']:,.0f} MB/s, ceiling "
          f"{b.results['h2d_examples_per_s_ceiling']:,.0f} examples/s")


SECTIONS = {
    "parser": bench_parser,
    "models": bench_models,
    "full": bench_full,
    "batch": bench_batch,
    "batchbf16": bench_batch_bf16,
    "batchbf16med": bench_batch_bf16_median,
    "lookup": bench_lookup,
    "serving": bench_serving,
    "stream": bench_stream,
    "criteostream": bench_criteo_stream,
    "parserscale": bench_parser_scaling,
    "servingquality": bench_serving_quality,
    "streamtrain": bench_stream_train,
    "h2d": bench_h2d,
}


def _fmt(value) -> str:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return str(value)
    return f"{value:,.0f}" if abs(value) >= 100 else f"{value:.4g}"


def write_markdown(path: str, results: dict, where: str) -> None:
    with open(path, "w") as f:
        f.write("# BENCH_TORCH — measured performance of the port (deepctr_torch)\n\n")
        f.write(f"Device: {where}.\n\n")
        f.write(
            "Protocol: device times from CUDA events around many calls after a "
            "warm-up, a sleep kernel holding the stream while the host enqueues "
            "them; wall times from the host clock around work that ends in "
            "`torch.cuda.synchronize()`; medians of 5 with `_sigma` keys where "
            "`tools/bench_suite.py` took medians; a CUDA graph's capture is never "
            "timed. Training runs the scan route, one CUDA graph of 8 steps a "
            "replay, through the hand-written tower and FM scorer kernels. "
            "`device_ms_per_step/*` is device time; `train_examples_per_s/*`, "
            "`peak_*` and `train_stream_*` are the host clock's; "
            "`device_peak_mib/*` is `torch.cuda.max_memory_allocated` over a "
            "section. Host sections (`parser*`, `stream*`, `criteo_stream*`) time "
            "the host alone. Byte counts: the port's ids are int64 on the card, "
            "int32 on the host. The module's docstring lists what is not ported "
            "and why.\n\n")
        f.write("| metric | value |\n|---|---|\n")
        for key, value in results.items():
            f.write(f"| {key} | {_fmt(value)} |\n")
        f.write(f"\nGenerated by `python -m deepctr_torch.tools.bench_suite` at "
                f"{time.ctime()}. {protocol_stamp(TOOL)}\n")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--sections", default=DEFAULT_SECTIONS,
                   help="comma list out of: " + ",".join(SECTIONS))
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    p.add_argument("--small", action="store_true", help="cut every size (the tests)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the sections; on the card accumulate ``BENCH_TORCH.json`` and
    write ``BENCH_TORCH.md`` in the working directory. Returns this run's
    results."""
    from ..cli import resolve_device
    from .reproduce import card_line

    args = parse_args(argv)
    sections = [s for s in args.sections.split(",") if s]
    unknown = sorted(set(sections) - set(SECTIONS))
    if unknown:
        raise ValueError(f"unknown sections {unknown} (known: {', '.join(SECTIONS)})")
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    card = card_line() if cuda else None
    if cuda and card is None:
        raise RuntimeError("nvidia-smi gave no card name and power limit")
    print(card or "cpu (the kernels' plain versions; no file is written)")
    results: dict = {}
    with tempfile.TemporaryDirectory(prefix="deepctr_torch_bench_") as tmp:
        bench = Bench(device, args.small, tmp, results)
        for name in SECTIONS:   # the reference's order
            if name not in sections:
                continue
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            SECTIONS[name](bench)
            bench.sync()
            seconds = time.perf_counter() - t0
            gc.collect()
            if cuda:
                peak = torch.cuda.max_memory_allocated(device) / 2**20
                results[f"device_peak_mib/{name}"] = peak
                torch.cuda.empty_cache()
            print(f"== {name}: {seconds:.1f} s"
                  + (f", peak device memory {peak:.1f} MiB" if cuda else ""), flush=True)
    if cuda:
        acc = {}
        if os.path.exists(OUT_JSON):
            with open(OUT_JSON) as f:
                acc = json.load(f)
        acc.update(results)
        with open(OUT_JSON, "w") as f:
            json.dump(acc, f, indent=2)
        where = (f"{torch.cuda.get_device_name(device)}; nvidia-smi: {card}; torch "
                 f"{torch.__version__}, CUDA {torch.version.cuda}")
        write_markdown(OUT_MD, acc, where)
        print(f"wrote {OUT_MD} and {OUT_JSON}")
    print(json.dumps(results, default=str))
    return results


if __name__ == "__main__":
    main()
