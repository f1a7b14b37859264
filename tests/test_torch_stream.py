"""The port's streaming ingestion (``deepctr_torch/data/stream.py``, a copy
of ``deepctr_tpu/data/stream.py``) against its original, and the streamed
training path of the port's ``fit`` and CLI.

The same seeded shards go through both copies: their batches, scan chunks,
shard expansion and per-process partitions must be equal, array for array.
The gates of ``tests/test_stream.py`` are mirrored on the port (exact epoch
coverage, shuffling, bounded residency, Criteo, npz-cache and featindex
shards, streamed training against in-RAM training, the CLI).
"""

import math

import numpy as np
import pytest
import torch

from deepctr_torch.data import StreamSource, make_schema, synthetic
from deepctr_torch.data.stream import expand_shards
from deepctr_tpu.data import stream as j_stream
from deepctr_tpu.data import make_schema as j_make_schema


def _write_shards(tmp_path, ds, n_shards):
    rows = ds.ids.shape[0]
    per = rows // n_shards
    paths = []
    for i in range(n_shards):
        sl = slice(i * per, rows if i == n_shards - 1 else (i + 1) * per)
        p = str(tmp_path / f"shard_{i:02d}.yx")
        synthetic.write_yx_file(
            synthetic.SyntheticDataset(ds.schema, ds.ids[sl], ds.labels[sl],
                                       ds.bayes_logits[sl]), p)
        paths.append(p)
    return paths


def _row_multiset(ids, labels):
    return sorted(tuple(r) + (float(y),) for r, y in zip(ids.tolist(), labels.tolist()))


SPECS = [("a", 6), ("b", 12), ("c", 300), ("d", 40), ("tags", 20, 3)]


@pytest.fixture(scope="module")
def small_ds():
    return synthetic.generate(make_schema(SPECS), num_examples=9_000, k=3, seed=11)


@pytest.fixture(scope="module")
def shards(tmp_path_factory, small_ds):
    return _write_shards(tmp_path_factory.mktemp("shards"), small_ds, n_shards=5)


def _both(paths, **kw):
    """The port's StreamSource and the original's on the same shards."""
    return (StreamSource(paths=paths, schema=make_schema(SPECS), **kw),
            j_stream.StreamSource(paths=paths, schema=j_make_schema(SPECS), **kw))


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in ((g.ids, w.ids), (g.labels, w.labels), (g.weights, w.weights)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("prefetch_files", [0, 2])
@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("use_native", [True, False])
def test_batches_equal_original(shards, use_native, drop_remainder, prefetch_files):
    """Epochs 0 and 1 of one source each: the same batches, in order, and
    the same counters (the residency high-water mark only with inline
    parsing: with parser threads it depends on their timing)."""
    t, j = _both(shards, batch_size=128, buffer_rows=700, chunk_bytes=8192, seed=3,
                 use_native=use_native, drop_remainder=drop_remainder,
                 prefetch_files=prefetch_files)
    for epoch in (0, 1):
        _assert_batches_equal(list(t.batches(epoch)), list(j.batches(epoch)))
    if prefetch_files:
        t.stats.peak_resident_rows = j.stats.peak_resident_rows = 0
    assert vars(t.stats) == vars(j.stats)


@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("scan_steps", [3, 4])
def test_scan_chunks_equal_original(shards, scan_steps, drop_remainder):
    t, j = _both(shards, batch_size=256, buffer_rows=1024, seed=0,
                 drop_remainder=drop_remainder, prefetch_files=0)
    got, want = list(t.scan_chunks(1, scan_steps)), list(j.scan_chunks(1, scan_steps))
    assert len(got) == len(want) > 0
    for (gn, garr), (wn, warr) in zip(got, want):
        assert gn == wn
        for a, b in zip(garr, warr, strict=True):
            np.testing.assert_array_equal(a, b)
    assert vars(t.stats) == vars(j.stats)


def test_expand_shards_equal_original(shards, tmp_path):
    root = shards[0].rsplit("/", 1)[0]
    for spec in (f"{root}/shard_*.yx", ",".join(shards[:2]), shards[::-1],
                 f"{root}/shard_0[13].yx,{tmp_path}/missing.yx"):
        assert expand_shards(spec) == j_stream.expand_shards(spec)


@pytest.mark.parametrize("process_count", [2, 3])
def test_process_partitions_equal_original(shards, process_count):
    for pid in range(process_count):
        t, j = _both(shards, batch_size=64, buffer_rows=256, seed=4,
                     drop_remainder=False, process_index=pid,
                     process_count=process_count)
        _assert_batches_equal(list(t.batches(2)), list(j.batches(2)))


def test_stream_epoch_covers_every_row_exactly_once(shards, small_ds):
    src = StreamSource(paths=shards, schema=small_ds.schema, batch_size=128,
                       buffer_rows=512, chunk_bytes=8192, seed=0,
                       drop_remainder=False)
    got = [(b.ids[b.weights > 0], b.labels[b.weights > 0]) for b in src.batches(0)]
    ids = np.concatenate([g[0] for g in got])
    y = np.concatenate([g[1] for g in got])
    assert ids.shape[0] == small_ds.ids.shape[0]
    assert _row_multiset(ids, y) == _row_multiset(small_ds.ids, small_ds.labels)


def test_stream_shuffles_across_epochs_and_vs_file_order(shards, small_ds):
    def first_batch(epoch):
        src = StreamSource(paths=shards, schema=small_ds.schema, batch_size=256,
                           buffer_rows=2048, seed=5)
        return next(iter(src.batches(epoch))).ids

    b0, b1 = first_batch(0), first_batch(1)
    assert not np.array_equal(b0, b1)
    assert not np.array_equal(b0, small_ds.ids[:256])
    assert np.array_equal(b0, first_batch(0))


def test_stream_residency_is_bounded(shards, small_ds):
    src = StreamSource(paths=shards, schema=small_ds.schema, batch_size=64,
                       buffer_rows=256, chunk_bytes=4096, seed=0,
                       drop_remainder=False, prefetch_files=0)
    n = sum(int((b.weights > 0).sum()) for b in src.batches(0))
    assert n == small_ds.ids.shape[0]
    chunk_rows = 4096 // 24 + 64
    assert src.stats.peak_resident_rows <= 256 + chunk_rows
    assert src.stats.peak_resident_rows < small_ds.ids.shape[0] // 10


def test_process_partition_union_is_exactly_once(shards, small_ds):
    got = []
    for pid in range(3):
        src = StreamSource(paths=shards, schema=small_ds.schema, batch_size=128,
                           buffer_rows=512, seed=4, drop_remainder=False,
                           process_index=pid, process_count=3)
        got += [(b.ids[b.weights > 0], b.labels[b.weights > 0])
                for b in src.batches(epoch=2)]
    ids = np.concatenate([g[0] for g in got])
    y = np.concatenate([g[1] for g in got])
    assert _row_multiset(ids, y) == _row_multiset(small_ds.ids, small_ds.labels)


def test_stream_criteo_format(tmp_path):
    from deepctr_torch.data.criteo import criteo_schema, parse_criteo_file
    from deepctr_tpu.data.criteo import criteo_schema as j_criteo_schema

    rng = np.random.default_rng(0)
    p = str(tmp_path / "day0.tsv")
    with open(p, "w") as f:
        for i in range(500):
            ints = [str(rng.integers(0, 100)) if rng.random() > 0.2 else ""
                    for _ in range(13)]
            cats = [f"{rng.integers(0, 50):08x}" if rng.random() > 0.2 else ""
                    for _ in range(26)]
            f.write("\t".join([str(i % 2)] + ints + cats) + "\n")
    schema = criteo_schema(cat_buckets=1000)
    labels, ids = parse_criteo_file(p, schema)
    kw = dict(paths=[p], batch_size=64, fmt="criteo", buffer_rows=128,
              chunk_bytes=4096, drop_remainder=False)
    src = StreamSource(schema=schema, **kw)
    got = list(src.batches(0))
    got_ids = np.concatenate([b.ids[b.weights > 0] for b in got])
    got_y = np.concatenate([b.labels[b.weights > 0] for b in got])
    assert _row_multiset(got_ids, got_y) == _row_multiset(ids, labels)
    _assert_batches_equal(
        got, list(j_stream.StreamSource(schema=j_criteo_schema(1000), **kw).batches(0)))


def test_stream_npz_cache_shards(tmp_path, small_ds):
    from deepctr_torch.data.cache import write_cache

    paths = []
    for i in range(3):
        sl = slice(i * 3000, (i + 1) * 3000)
        p = str(tmp_path / f"shard_{i}.cache.npz")
        write_cache(p, small_ds.ids[sl], small_ds.labels[sl], small_ds.schema)
        paths.append(p)
    src = StreamSource(paths=paths, schema=small_ds.schema, batch_size=128,
                       buffer_rows=512, chunk_bytes=8192, drop_remainder=False)
    got = [(b.ids[b.weights > 0], b.labels[b.weights > 0]) for b in src.batches(0)]
    assert _row_multiset(np.concatenate([g[0] for g in got]),
                         np.concatenate([g[1] for g in got])) == \
        _row_multiset(small_ds.ids, small_ds.labels)
    bad = StreamSource(paths=paths, schema=make_schema([("z", 5)]), batch_size=128)
    with pytest.raises(ValueError, match="different"):
        next(iter(bad.batches(0)))


def test_stream_featindex_format(tmp_path):
    from deepctr_torch.data import featindex as fidx

    fp = tmp_path / "featindex.txt"
    lines = ["truncate\t0"]
    old = 1
    for val in range(5):
        for field in ("weekday", "hour", "region"):
            lines.append(f"{field}:{val}\t{old}")
            old += 1
    fp.write_text("\n".join(lines) + "\n")
    fi = fidx.load_featindex(str(fp))
    rng = np.random.default_rng(7)
    yx = tmp_path / "train.yx"
    with open(yx, "w") as f:
        for _ in range(300):
            picks = [1 + 3 * rng.integers(0, 5) + k for k in range(3)]
            f.write(f"{int(rng.random() < 0.4)} " + " ".join(f"{p}:1" for p in picks)
                    + "\n")
    want_labels, want_ids = fidx.parse_yx_file(str(yx), fi)
    src = StreamSource(paths=[str(yx)], schema=fi.schema, batch_size=64,
                       fmt="yx-featindex", featindex=fi, buffer_rows=128,
                       chunk_bytes=2048, drop_remainder=False)
    got = list(src.batches(0))
    assert _row_multiset(np.concatenate([b.ids[b.weights > 0] for b in got]),
                         np.concatenate([b.labels[b.weights > 0] for b in got])) == \
        _row_multiset(want_ids, want_labels)


def test_stream_matches_in_ram_training(tmp_path):
    """Streamed ``fit`` of FM lands within 0.01 AUC of in-RAM ``fit`` on the
    same rows, with the buffer and the parse window bounding residency."""
    from deepctr_torch.models import make_fm
    from deepctr_torch.optim import SparseAdagrad, make_dense_optimizer
    from deepctr_torch.train import fit

    schema = make_schema([("a", 6), ("b", 12), ("c", 300), ("d", 40)])
    ds = synthetic.generate(schema, num_examples=24_000, k=3, seed=3)
    cut = int(ds.ids.shape[0] * 0.85)
    paths = _write_shards(tmp_path, synthetic.SyntheticDataset(
        schema, ds.ids[:cut], ds.labels[:cut], ds.bayes_logits[:cut]), n_shards=4)

    def train(source=None, ids=None, y=None):
        return fit(make_fm(schema, k=4, device="cpu"), schema, ids, y, ds.ids[cut:],
                   ds.labels[cut:], sparse_opt=SparseAdagrad(0.05),
                   dense_opt=make_dense_optimizer("adagrad", 0.05), batch_size=256,
                   epochs=3, seed=0, early_stop_patience=99, train_source=source)

    res_ram = train(ids=ds.ids[:cut], y=ds.labels[:cut])
    src = StreamSource(paths=paths, schema=schema, batch_size=256, buffer_rows=2048,
                       chunk_bytes=32768, seed=0)
    res_stream = train(source=src)
    window = (src.prefetch_files * (src.prefetch_chunks + 1) + 2) * (32768 // 20)
    assert src.stats.peak_resident_rows <= 2048 + window
    assert res_stream.best_auc > 0.70
    assert abs(res_stream.best_auc - res_ram.best_auc) < 0.01
    assert len(res_stream.history) == 3


def test_cli_stream_end_to_end(tmp_path):
    """``data.stream=true`` through the port's CLI trains and evaluates, and
    takes every shard row once per epoch."""
    from deepctr_torch.cli import run
    from deepctr_torch.config import RunConfig

    schema = make_schema([("a", 6), ("b", 12), ("c", 300), ("d", 40)])
    sp = str(tmp_path / "schema.json")
    open(sp, "w").write(schema.to_json())
    ds = synthetic.generate(schema, num_examples=12_000, k=3, seed=5)
    cut = 10_000
    _write_shards(tmp_path, synthetic.SyntheticDataset(
        schema, ds.ids[:cut], ds.labels[:cut], ds.bayes_logits[:cut]), n_shards=3)
    te = str(tmp_path / "test.yx")
    synthetic.write_yx_file(synthetic.SyntheticDataset(
        schema, ds.ids[cut:], ds.labels[cut:], ds.bayes_logits[cut:]), te)
    res = run(RunConfig().apply_overrides([
        "model.name=fm", "model.k=3", f"data.schema_path={sp}", "data.stream=true",
        "data.stream_buffer_rows=2048", f"data.train_path={tmp_path}/shard_*.yx",
        f"data.test_path={te}", "data.use_cache=false", "train.batch_size=256",
        "train.epochs=2", "train.scan_steps=4", "train.prefetch=true"]),
        torch.device("cpu"))
    assert res["best_auc"] > 0.65
    # the reference's scan route: each epoch's last chunk is padded to 4
    # steps of weight 0, which count as steps (the JAX CLI's run says 80)
    assert res["state"].step == 2 * math.ceil((cut // 256) / 4) * 4


@pytest.mark.parametrize("overrides,match", [
    (["data.stream=true"], "requires data.train_path"),
    (["data.stream=true", "data.train_path=x.yx"], "requires data.test_path"),
    (["data.stream=true", "data.train_path=x.yx", "data.test_path=y.yx",
      "model.name=snn", "model.hidden1=4", "model.hidden=4", "train.pretrain=rbm"],
     "SNN pretraining"),
])
def test_cli_stream_refusals(tmp_path, overrides, match):
    """The reference's errors: no shards, no test file, SNN pretraining on a
    stream (the test file is read before the refusal, so it exists here)."""
    from deepctr_torch.cli import run
    from deepctr_torch.config import RunConfig

    schema = make_schema([("a", 6), ("b", 12)])
    ds = synthetic.generate(schema, num_examples=300, k=2, seed=1)
    for name in ("x.yx", "y.yx"):
        synthetic.write_yx_file(ds, str(tmp_path / name))
    sp = str(tmp_path / "schema.json")
    open(sp, "w").write(schema.to_json())
    overrides = [o.replace("=x.yx", f"={tmp_path}/x.yx").replace(
        "=y.yx", f"={tmp_path}/y.yx") for o in overrides]
    with pytest.raises(ValueError, match=match):
        run(RunConfig().apply_overrides([f"data.schema_path={sp}"] + overrides),
            torch.device("cpu"))
