"""The port's copies of the data layer and run config against their
originals in ``deepctr_tpu``: the same seeded inputs through both give the
same schemas, arrays, batches and configs."""

import dataclasses
import os

import numpy as np
import pytest

from deepctr_torch import config as t_config
from deepctr_torch import data as t_data
from deepctr_torch.data import cache as t_cache
from deepctr_torch.data import criteo as t_criteo
from deepctr_torch.data import featindex as t_featindex
from deepctr_torch.data import native as t_native
from deepctr_torch.data import parser as t_parser
from deepctr_torch.data import pipeline as t_pipeline
from deepctr_torch.data import synthetic as t_synthetic
from deepctr_tpu import config as j_config
from deepctr_tpu import data as j_data
from deepctr_tpu.data import cache as j_cache
from deepctr_tpu.data import criteo as j_criteo
from deepctr_tpu.data import featindex as j_featindex
from deepctr_tpu.data import native as j_native
from deepctr_tpu.data import parser as j_parser
from deepctr_tpu.data import pipeline as j_pipeline
from deepctr_tpu.data import synthetic as j_synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = [("weekday", 7), ("hour", 24), ("region", 40), ("tags", 30, 3)]


def _schemas():
    return t_data.make_schema(SPECS), j_data.make_schema(SPECS)


def _assert_arrays_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.fixture
def yx_file(tmp_path):
    """A seeded yx file written by the reference's writer, with its schema."""
    _, j_schema = _schemas()
    ds = j_synthetic.generate(j_schema, num_examples=600, k=3, seed=11)
    path = str(tmp_path / "rows.yx")
    j_synthetic.write_yx_file(ds, path)
    return path, ds


@pytest.mark.parametrize("name", ["ipinyou_full_schema", "ipinyou_like_schema",
                                  "criteo_schema"])
def test_schemas_equal_with_json_round_trip(name):
    mod_t = t_criteo if name == "criteo_schema" else t_data
    mod_j = j_criteo if name == "criteo_schema" else j_data
    ts, js = getattr(mod_t, name)(), getattr(mod_j, name)()
    assert ts.to_json() == js.to_json()
    back = t_data.Schema.from_json(js.to_json())
    assert back == ts and back.to_json() == ts.to_json()
    for attr in ("offsets", "slot_field", "slot_offsets"):
        _assert_arrays_equal(getattr(ts, attr), getattr(js, attr))
    assert (ts.pad_id, ts.padded_vocab_size, ts.num_slots) == (
        js.pad_id, js.padded_vocab_size, js.num_slots)


@pytest.mark.parametrize("teacher", ["fm", "mlp", "ortho"])
def test_synthetic_generate_equal(teacher):
    ts, js = _schemas()
    a = t_synthetic.generate(ts, num_examples=500, k=3, seed=5, teacher=teacher)
    b = j_synthetic.generate(js, num_examples=500, k=3, seed=5, teacher=teacher)
    for field in ("ids", "labels", "bayes_logits"):
        _assert_arrays_equal(getattr(a, field), getattr(b, field))


def test_write_yx_file_equal(tmp_path):
    ts, js = _schemas()
    a = t_synthetic.generate(ts, num_examples=200, k=3, seed=2)
    b = j_synthetic.generate(js, num_examples=200, k=3, seed=2)
    t_synthetic.write_yx_file(a, str(tmp_path / "t.yx"))
    j_synthetic.write_yx_file(b, str(tmp_path / "j.yx"))
    assert (tmp_path / "t.yx").read_bytes() == (tmp_path / "j.yx").read_bytes()


def test_numpy_and_native_parsers_equal(yx_file):
    path, ds = yx_file
    ts, js = _schemas()
    got = {
        "port numpy": t_parser.parse_yx_file(path, ts),
        "port native": t_native.parse_yx_file(path, ts),
        "ref numpy": j_parser.parse_yx_file(path, js),
        "ref native": j_native.parse_yx_file(path, js),
    }
    for name, (labels, ids) in got.items():
        _assert_arrays_equal(labels, got["ref numpy"][0])
        _assert_arrays_equal(ids, got["ref numpy"][1])
    _assert_arrays_equal(got["port numpy"][1], ds.ids)


def test_native_parser_builds_under_build_dir():
    lib = t_native._build()
    assert os.path.dirname(lib) == os.path.join(ROOT, "build", "native")


def test_featindex_equal(tmp_path, yx_file):
    """A featindex whose indices interleave the fields, loaded by both, and
    the yx file parsed through it."""
    path, _ = yx_file
    ts, _ = _schemas()
    rng = np.random.default_rng(3)
    feats = [f"{f.name}:{v}" for f in ts.fields for v in range(f.vocab_size)]
    order = rng.permutation(len(feats))
    fi_path = tmp_path / "featindex.txt"
    fi_path.write_text("".join(f"{feats[i]}\t{j}\n" for j, i in enumerate(order)))
    tf = t_featindex.load_featindex(str(fi_path), max_len="tags=3")
    jf = j_featindex.load_featindex(str(fi_path), max_len="tags=3")
    assert tf.schema.to_json() == jf.schema.to_json()
    _assert_arrays_equal(tf.remap, jf.remap)
    for a, b in zip(t_featindex.parse_yx_file(path, tf),
                    j_featindex.parse_yx_file(path, jf)):
        _assert_arrays_equal(a, b)


@pytest.mark.parametrize("use_native", [True, False])
def test_cache_round_trip_equal(tmp_path, yx_file, use_native):
    path, _ = yx_file
    ts, js = _schemas()
    tc = t_cache.cache_text_file(path, ts, str(tmp_path / "t.npz"),
                                 use_native=use_native)
    jc = j_cache.cache_text_file(path, js, str(tmp_path / "j.npz"),
                                 use_native=use_native)
    t_ids, t_labels, t_schema = t_cache.read_cache(tc)
    j_ids, j_labels, j_schema = j_cache.read_cache(jc)
    _assert_arrays_equal(t_ids, j_ids)
    _assert_arrays_equal(t_labels, j_labels)
    assert t_schema.to_json() == j_schema.to_json() == ts.to_json()
    # each package reads the other's file
    _assert_arrays_equal(t_cache.read_cache(jc)[0], j_ids)
    _assert_arrays_equal(j_cache.read_cache(tc)[0], t_ids)


@pytest.mark.parametrize("use_native", [True, False])
def test_criteo_parse_equal(tmp_path, use_native):
    path = str(tmp_path / "day.tsv")
    j_schema = j_criteo.write_synth_criteo_file(path, 300, seed=4, tokens_per_cat=50)
    t_path = str(tmp_path / "day_t.tsv")
    t_schema = t_criteo.write_synth_criteo_file(t_path, 300, seed=4, tokens_per_cat=50)
    with open(path, "rb") as f, open(t_path, "rb") as g:
        assert f.read() == g.read()
    assert t_schema.to_json() == j_schema.to_json()
    a = t_criteo.parse_criteo_file(path, t_schema, use_native=use_native)
    b = j_criteo.parse_criteo_file(path, j_schema, use_native=use_native)
    for x, y in zip(a, b):
        _assert_arrays_equal(x, y)


@pytest.mark.parametrize("shuffle,drop", [(True, False), (False, True)])
def test_minibatches_equal(shuffle, drop):
    ts, js = _schemas()
    ds = j_synthetic.generate(js, num_examples=333, k=2, seed=9)
    a = list(t_pipeline.minibatches(ds.ids, ds.labels, 64, schema=ts,
                                    shuffle=shuffle, seed=3, drop_remainder=drop))
    b = list(j_pipeline.minibatches(ds.ids, ds.labels, 64, schema=js,
                                    shuffle=shuffle, seed=3, drop_remainder=drop))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        for field in ("ids", "labels", "weights"):
            _assert_arrays_equal(getattr(x, field), getattr(y, field))
    ea = list(t_pipeline.epoch_iterator(ds.ids, ds.labels, 100, schema=ts, num_epochs=2))
    eb = list(j_pipeline.epoch_iterator(ds.ids, ds.labels, 100, schema=js, num_epochs=2))
    assert [e for e, _ in ea] == [e for e, _ in eb]
    for (_, x), (_, y) in zip(ea, eb):
        _assert_arrays_equal(x.ids, y.ids)


@pytest.mark.parametrize("use_native", [True, False])
def test_stream_yx_batches_equal(yx_file, use_native):
    path, _ = yx_file
    ts, js = _schemas()
    kw = dict(chunk_lines=50, use_native=use_native)
    a = list(t_pipeline.stream_yx_batches([path, path], ts, 128, **kw))
    b = list(j_pipeline.stream_yx_batches([path, path], js, 128, **kw))
    assert len(a) == len(b) == 10
    for x, y in zip(a, b):
        for field in ("ids", "labels", "weights"):
            _assert_arrays_equal(getattr(x, field), getattr(y, field))


@pytest.mark.parametrize("overrides", [
    [],
    ["model.name=deepfm", "model.hidden=200,200", "model.dropout=0.5",
     "train.batch_size=8192", "data.format=criteo", "optim.sparse_lr=0.02",
     "train.table_dtype=bf16"],
])
def test_run_config_equal(overrides):
    path = os.path.join(ROOT, "configs", "fnn_full_ipinyou.json")
    a = t_config.RunConfig.load(path).apply_overrides(overrides)
    b = j_config.RunConfig.load(path).apply_overrides(overrides)
    assert a.to_json() == b.to_json()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert t_config.RunConfig.from_json(b.to_json()) == a
