"""The CLI's ``train.sharded`` on two gloo ranks, against the port's own
unsharded run and the JAX package's sharded CLI.

Each run is ``torchrun --standalone --nproc_per_node=2 -m deepctr_torch.cli
... --device cpu`` (``tests/test_torch_ranks.py::torchrun``), the command a
user gives on N GPUs with ``--device cuda``. The analogues of the JAX
package's ``tests/test_cli.py`` sharded tests, with their tolerances.
"""

import json
import os

import numpy as np
import pytest
import torch

from deepctr_torch import cli as t_cli
from deepctr_torch.config import RunConfig as TRunConfig
from deepctr_torch.models import MlpSpec as TMlpSpec
from deepctr_torch.models import make_snn as t_make_snn
from deepctr_torch.optim import make_dense_optimizer, make_sparse_optimizer
from deepctr_torch.parallel.sharded import local_shard
from deepctr_torch.train import init_state as t_init_state
from deepctr_tpu import cli as j_cli
from deepctr_tpu.config import RunConfig
from deepctr_tpu.data import ipinyou_like_schema, synthetic
from deepctr_tpu.train import init_state as j_init_state
from deepctr_tpu.utils.checkpoint import save_train_state as j_save_train_state
from test_torch_ranks import launch, torchrun

# tests/test_cli.py's: the sharded and unsharded trajectories sum in other
# orders; --score prints 6 decimals
RTOL, ATOL = 1e-4, 1e-5
PRINT_ATOL = 1.01e-6
# against the JAX package over 12 Adagrad steps: an update g / (sqrt(acc) +
# 1e-6) on a row whose summed gradients are far below 1e-6 turns the two
# packages' f32 rounding of g into a visible step (3 of 183,120 elements
# moved 5.3e-5, each with an accumulator below 5e-7); tests/test_parallel.py
# meets the same amplification for its bf16 wire. The epoch records are held
# to 1e-4, as tests/test_torch_train.py::test_fit_matches_jax holds them.
JAX_ATOL = 1e-4
RECORD_TOL = 1e-4


def _ckpt_table(path):
    with np.load(path, allow_pickle=False) as z:
        m = json.loads(str(z["manifest"]))
        return np.asarray(z[f"leaf_{m['scoring']['table_leaf']}"])


def _ckpt_step(path):
    with np.load(path, allow_pickle=False) as z:
        return int(z["leaf_0"])


def _records(path):
    """The epoch records of a metrics file."""
    return [r for r in map(json.loads, open(path)) if "auc" in r]


def test_sharded_fm_matches_unsharded_and_jax(tmp_path, capsys):
    """FM, 2 epochs, ``lr_decay=0.5``: the two-rank sharded run (with the
    prefetcher) against the port's unsharded run and the JAX CLI's sharded
    run on two devices, by checkpoint table (``test_cli.py:153``); then the
    sharded checkpoint through both packages' ``--score``. The port's
    initial values come from a ``torch.Generator``, the JAX package's from
    its PRNG, so all three runs resume one JAX-written initial state."""
    base = ["model.name=fm", "model.k=3", "data.synthetic_examples=4000",
            "train.batch_size=512", "train.epochs=2", "train.lr_decay=0.5",
            "train.capacity_factor=8.0", "train.resume=true"]
    single, sharded, jax_ck = (str(tmp_path / f"{n}.npz")
                               for n in ("single", "sharded", "jax"))
    cfg = RunConfig().apply_overrides(base)
    schema, *_ = j_cli.load_data(cfg)
    state = j_init_state(j_cli.build_model(cfg, schema), schema,
                         *j_cli.build_optimizers(cfg), seed=cfg.train.seed)
    for path in (single, sharded, jax_ck):
        j_save_train_state(path, state, epoch=0, meta={"model": "fm"}, schema=schema)
    metrics, jax_metrics = str(tmp_path / "sharded.jsonl"), str(tmp_path / "jax.jsonl")
    t_cli.run(TRunConfig().apply_overrides(
        base + ["train.prefetch=false", f"train.checkpoint_path={single}"]),
        torch.device("cpu"))
    torchrun(base + ["train.sharded=true", "train.prefetch=true",
                     f"train.checkpoint_path={sharded}", f"train.metrics_path={metrics}",
                     "--device", "cpu"])
    j_cli.run(RunConfig().apply_overrides(
        base + ["train.sharded=true", "train.num_devices=2", "train.prefetch=false",
                f"train.checkpoint_path={jax_ck}", f"train.metrics_path={jax_metrics}"]))
    got = _ckpt_table(sharded)
    np.testing.assert_allclose(got, _ckpt_table(single), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _ckpt_table(jax_ck), rtol=RTOL, atol=JAX_ATOL)
    recs = _records(metrics)
    assert [r["epoch"] for r in recs] == [0, 1]   # rank 0 alone writes
    assert all(r["dropped_ids"] == 0 and np.isfinite(r["auc"]) for r in recs)
    for r, w in zip(recs, _records(jax_metrics), strict=True):
        assert r["dropped_ids"] == w["dropped_ids"]
        for key in ("auc", "logloss", "train_loss"):
            assert abs(r[key] - w[key]) < RECORD_TOL, (key, r[key], w[key])
    np.testing.assert_array_equal(np.load(sharded + ".fm_table")["leaf_0"], got)

    yx = str(tmp_path / "requests.yx")
    synthetic.write_yx_file(synthetic.generate(
        ipinyou_like_schema(), num_examples=300, k=3, seed=9), yx)
    argv = ["--score", yx, f"train.checkpoint_path={sharded}", "model.name=fm",
            "model.k=3", "train.batch_size=512"]
    capsys.readouterr()
    assert j_cli.main(argv) == 0
    want = np.array(capsys.readouterr().out.split(), np.float64)
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    got_p = np.array(capsys.readouterr().out.split(), np.float64)
    assert got_p.shape == want.shape == (300,)
    np.testing.assert_allclose(got_p, want, rtol=0, atol=PRINT_ATOL)


def test_sharded_scan_route_with_adam_matches_jax(tmp_path):
    """``train.sharded=true train.scan_steps=8 optim.dense=adam`` on two
    ranks against the JAX CLI's sharded run on two devices: 13 batches an
    epoch, so each epoch's second chunk has 5 steps and 3 weight-0 pad
    steps, which are real steps (the checkpoint's step is 2 · 16) and move
    Adam's moments. Under a starved cap (``train.capacity_factor=1.0``,
    no split plan on either side) every step drops occurrences, an all-pad
    step most: the epochs' ``dropped_ids`` must be the reference's
    exactly, the table and the records within the tolerances above."""
    base = ["model.name=fm", "model.k=3", "data.synthetic_examples=4000",
            "train.batch_size=256", "train.epochs=2", "train.scan_steps=8",
            "optim.dense=adam", "train.capacity_factor=1.0", "train.split_threshold=0",
            "train.early_stop_patience=5", "train.resume=true", "train.sharded=true"]
    port, jax_ck = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    metrics, jax_metrics = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    cfg = RunConfig().apply_overrides(base)
    schema, *_ = j_cli.load_data(cfg)
    state = j_init_state(j_cli.build_model(cfg, schema), schema,
                         *j_cli.build_optimizers(cfg), seed=cfg.train.seed)
    for path in (port, jax_ck):
        j_save_train_state(path, state, epoch=0, meta={"model": "fm"}, schema=schema)
    torchrun(base + [f"train.checkpoint_path={port}", f"train.metrics_path={metrics}",
                     "--device", "cpu"])
    j_cli.run(RunConfig().apply_overrides(
        base + ["train.num_devices=2", "train.prefetch=false",
                f"train.checkpoint_path={jax_ck}", f"train.metrics_path={jax_metrics}"]))
    assert _ckpt_step(port) == _ckpt_step(jax_ck) == 2 * 16
    np.testing.assert_allclose(_ckpt_table(port), _ckpt_table(jax_ck), rtol=RTOL,
                               atol=JAX_ATOL)
    recs, want = _records(metrics), _records(jax_metrics)
    assert [r["epoch"] for r in recs] == [0, 1]
    for r, w in zip(recs, want, strict=True):
        assert r["dropped_ids"] == w["dropped_ids"] > 0
        for key in ("auc", "logloss", "train_loss"):
            assert abs(r[key] - w[key]) < RECORD_TOL, (key, r[key], w[key])


def test_sharded_snn_consumes_the_pretrained_table_on_every_rank(tmp_path):
    """SNN with DAE pretraining on two ranks (``test_cli.py:83``): each
    rank's state handed to the sharded layout is the pretrained table, the
    same on both ranks and not a fresh one, and each rank's shard is its
    rows of it."""
    overrides = ["model.name=snn", "model.hidden1=16", "model.hidden=16",
                 "model.dropout=0.0", "data.synthetic_examples=4000",
                 "train.batch_size=512", "train.epochs=1", "train.pretrain=dae",
                 "train.pretrain_epochs=1", "train.sharded=true",
                 "train.capacity_factor=8.0", "train.prefetch=false"]
    out = launch({"snn/config": np.array(json.dumps(
        {"case": "cli", "overrides": overrides}))}, str(tmp_path))
    tables = [o["snn/table"] for o in out]
    np.testing.assert_array_equal(tables[0], tables[1])
    for r, o in enumerate(out):
        np.testing.assert_array_equal(
            o["snn/shard"], local_shard(torch.from_numpy(tables[r]), 2, r).numpy())
        assert np.isfinite(o["snn/best_auc"])
        assert list(o["modules/loaded"]) == []
    cfg = TRunConfig().apply_overrides(overrides)
    schema, *_ = t_cli.load_data(cfg)
    model = t_make_snn(schema, hidden1=16, mlp=TMlpSpec(hidden=(16,)), device="cpu")
    fresh = t_init_state(model, schema, make_sparse_optimizer("adagrad", 0.05),
                         make_dense_optimizer("adagrad", 0.02), seed=cfg.train.seed)
    assert not np.allclose(tables[0], fresh.table.numpy())


def _write_criteo(path, rows, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            ints = [str(int(rng.integers(0, 1000))) if rng.random() > 0.1 else ""
                    for _ in range(13)]
            cats = [f"{int(rng.integers(0, 500)):08x}" if rng.random() > 0.1 else ""
                    for _ in range(26)]
            f.write("\t".join([str(int(rng.random() < 0.25))] + ints + cats) + "\n")


def test_sharded_criteo_sorted_mode_matches_unsharded(tmp_path):
    """Raw Criteo TSV -> hash-trick schema -> two-rank sharded training with
    the sorted Adagrad (``test_cli.py:208``): it runs, drops nothing, and
    gives the unsharded sorted run's table."""
    path = str(tmp_path / "day0.tsv")
    _write_criteo(path, 3000)
    base = ["model.name=fnn", "model.k=3", "model.hidden=16", "model.dropout=0.0",
            "data.format=criteo", "data.criteo_cat_buckets=2000",
            f"data.train_path={path}", "train.batch_size=256", "train.epochs=2",
            "optim.sparse_mode=sorted", "train.prefetch=false"]
    sharded, single = str(tmp_path / "sharded.npz"), str(tmp_path / "single.npz")
    metrics = str(tmp_path / "m.jsonl")
    torchrun(base + ["train.sharded=true", "train.capacity_factor=8.0",
                     f"train.checkpoint_path={sharded}", f"train.metrics_path={metrics}",
                     "--device", "cpu"])
    t_cli.run(TRunConfig().apply_overrides(base + [f"train.checkpoint_path={single}"]),
              torch.device("cpu"))
    np.testing.assert_allclose(_ckpt_table(sharded), _ckpt_table(single),
                               rtol=RTOL, atol=ATOL)
    recs = _records(metrics)
    assert len(recs) == 2 and all(r["dropped_ids"] == 0 for r in recs)
    assert all(np.isfinite(r["auc"]) for r in recs)


def _write_days(tmp_path, rows):
    """Criteo day files of the given lengths and an eval day; the comma list
    of the training days."""
    days = [str(tmp_path / f"day_{i}.tsv") for i in range(len(rows))]
    for i, (day, n) in enumerate(zip(days, rows)):
        _write_criteo(day, n, seed=1 + i)
    _write_criteo(str(tmp_path / "day_eval.tsv"), 400, seed=9)
    return ",".join(days)


def _stream_config(tmp_path, days):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return ["--config", os.path.join(root, "configs", "criteo_stream_stretch.json"),
            "model.k=3", "model.hidden=16", "model.dropout=0.0",
            "data.criteo_cat_buckets=500", f"data.train_path={days}",
            f"data.test_path={tmp_path}/day_eval.tsv", "data.stream_buffer_rows=1024",
            "train.batch_size=256", "train.epochs=1", "train.capacity_factor=8.0"]


# a run whose ranks disagree on the number of steps hangs in a collective;
# two ranks on these few rows end in seconds
STREAM_TIMEOUT = 150


def test_sharded_criteo_stream_config_runs_shrunk(tmp_path):
    """``configs/criteo_stream_stretch.json`` shrunk (``test_cli.py:281``):
    Criteo shards of unequal lengths (three files over two ranks) streamed
    through the native parser into the two-rank sharded loop with the bf16
    wire. It ends, drops nothing, and takes the config's scan route: a
    step for every global batch the stream makes of the 3,000 rows, the
    last chunk padded to 8 steps."""
    days = _write_days(tmp_path, [1200, 1000, 800])
    args = _stream_config(tmp_path, days)
    metrics, ckpt = str(tmp_path / "m.jsonl"), str(tmp_path / "s.npz")
    torchrun(args + ["train.num_devices=2", f"train.metrics_path={metrics}",
                     f"train.checkpoint_path={ckpt}", "--device", "cpu"],
             timeout=STREAM_TIMEOUT)
    (rec,) = _records(metrics)
    assert rec["dropped_ids"] == 0 and np.isfinite(rec["auc"])
    assert np.isfinite(rec["train_loss"])
    _, source, *_ = t_cli.load_data(TRunConfig.load(args[1]).apply_overrides(args[2:]))
    batches = sum(1 for _ in source.batches(0))
    assert _ckpt_step(ckpt) == 8 * -(-batches // 8) > 0


def test_sharded_stream_of_unequal_shards_matches_unsharded(tmp_path):
    """Every rank streams the same global batches and trains on its rows,
    so the two-rank sharded run over unequal shards (f32 wire) gives the
    unsharded streamed run's table and step count, both on the config's
    scan route."""
    days = _write_days(tmp_path, [1300, 700])
    base = _stream_config(tmp_path, days) + ["train.exchange_dtype=f32"]
    sharded, single = str(tmp_path / "sharded.npz"), str(tmp_path / "single.npz")
    torchrun(base + ["train.num_devices=2", f"train.checkpoint_path={sharded}",
                     "--device", "cpu"], timeout=STREAM_TIMEOUT)
    cfg = TRunConfig.load(base[1]).apply_overrides(
        base[2:] + ["train.sharded=false", f"train.checkpoint_path={single}"])
    t_cli.run(cfg, torch.device("cpu"))
    assert _ckpt_step(sharded) == _ckpt_step(single) > 0
    np.testing.assert_allclose(_ckpt_table(sharded), _ckpt_table(single),
                               rtol=RTOL, atol=ATOL)
