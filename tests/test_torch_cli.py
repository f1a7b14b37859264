"""The CLI's remaining single-device keys on the port, against the JAX
package where it has the same surface: ``--print-config``,
``train.debug_nans``, ``train.profile_dir``, ``optim.dense`` (``adam`` and an
unknown name), and ``train.prefetch`` with ``data.DevicePrefetcher``.

On the CPU the prefetcher hands the batches over unchanged from its worker
thread, so ``fit(prefetch=True)`` must give ``fit(prefetch=False)``'s bits.
"""

import json
import math
import os
import threading

import numpy as np
import pytest
import torch

from deepctr_torch import cli as t_cli
from deepctr_torch.data import DevicePrefetcher, minibatches
from deepctr_torch.models import MlpSpec, make_fnn
from deepctr_torch.optim import SparseAdagrad, make_dense_optimizer
from deepctr_torch.train import fit, init_state
from deepctr_torch.utils import checkpoint as t_ckpt
from deepctr_tpu import cli as j_cli
from deepctr_tpu.data import make_schema, synthetic

K = 3
BATCH = 64


@pytest.fixture(scope="module")
def schema():
    return make_schema([("a", 4), ("b", 8), ("c", 16), ("tags", 10, 3)])


@pytest.fixture()
def argv(schema, tmp_path):
    sp = tmp_path / "schema.json"
    sp.write_text(schema.to_json())
    return [f"data.schema_path={sp}", "data.synthetic_examples=400", f"model.k={K}",
            "model.hidden=8", "model.dropout=0.5", f"train.batch_size={BATCH}",
            "train.epochs=1", "train.table_dtype=bf16"]


def _run(args):
    return t_cli.run(t_cli.RunConfig().apply_overrides(args), torch.device("cpu"))


def test_cli_print_config(capsys):
    """Both packages print the same resolved config, and the port does so
    before any device is resolved (``--device`` defaults to cuda; there is
    no card here)."""
    args = ["--print-config", "model.name=lr", "train.resume=true",
            "optim.dense=adam"]
    assert t_cli.main(args) == 0
    got = capsys.readouterr().out
    assert j_cli.main(args) == 0
    want = capsys.readouterr().out
    assert json.loads(got)["model"]["name"] == "lr"
    assert json.loads(got) == json.loads(want)


def test_unported_keys_are_only_the_multi_gpu_ones(argv, tmp_path):
    """No key is left unported: ``train.distributed`` without
    ``train.sharded`` runs the single-device route, as in the reference's
    single process, and logs one event saying the key has no effect. That
    route is the default scan route: 5 batches are one chunk of 8 steps,
    3 of them weight-0 pad steps that count, as the reference's do."""
    assert not hasattr(t_cli, "UNPORTED_KEYS") and not hasattr(t_cli, "check_ported")
    metrics = tmp_path / "m.jsonl"
    res = _run(argv + ["train.distributed=true", f"train.metrics_path={metrics}"])
    scan = t_cli.RunConfig().train.scan_steps
    assert res["state"].step == scan * math.ceil(400 * 85 // 100 // BATCH / scan)
    assert not hasattr(res["state"], "num_shards")
    events = [json.loads(line) for line in metrics.read_text().splitlines()]
    ignored = [e for e in events if e.get("event") == "distributed_ignored"]
    assert len(ignored) == 1 and "train.sharded" in ignored[0]["reason"]


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs"))))
def test_every_bundled_config_starts_on_the_port(name, schema):
    """Each bundled config resolves, and its model and optimizers build on
    a tiny schema (its widths, any model of the family)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = t_cli.RunConfig.load(os.path.join(root, "configs", name))
    hstu = cfg.model.name == "hstu"
    if hstu:   # one field of item ids, and every leaf under the dense optimizer
        schema = make_schema([("item", 40, 6)])
    model = t_cli.build_model(cfg, schema, "cpu")
    sparse, dense = t_cli.build_optimizers(cfg)
    state = init_state(model, schema, None if hstu else sparse, dense, seed=0,
                       table_dtype=cfg.train.table_dtype)
    assert state.table.shape[0] == schema.padded_vocab_size
    assert all(torch.isfinite(p).all() for p in model.parameters())


@pytest.mark.parametrize("name", ["rmsprop", "Adam", "sgdd"])
def test_cli_unknown_dense_optimizer_raises_value_error(argv, name):
    """The reference's error type; the message names the port's three."""
    with pytest.raises(ValueError, match="sgd | adagrad | adam"):
        _run(argv + [f"optim.dense={name}"])


def test_cli_trains_with_adam(argv, tmp_path, capsys):
    """``optim.dense=adam``: a finite loss, and a checkpoint whose dense
    state is optax's ``ScaleByAdamState`` layout (count, then mu, then nu),
    which resumes."""
    ckpt = str(tmp_path / "adam.ckpt")
    res = _run(argv + ["optim.dense=adam", f"train.checkpoint_path={ckpt}"])
    assert np.isfinite(res["history"][0]["train_loss"])
    state = res["state"]
    n_dense = len(list(state.model.parameters())) - 1
    manifest = t_ckpt.read_manifest(ckpt)
    sc = manifest["scoring"]
    assert manifest["n"] == sc["dense_start"] + n_dense + 1 + 2 * n_dense + 1
    with np.load(ckpt) as z:
        count = z[f"leaf_{sc['dense_start'] + n_dense}"]
    assert count.dtype == np.int32 and int(count) == state.step
    _run(argv + ["optim.dense=adam", f"train.checkpoint_path={ckpt}",
                 "train.resume=true", "train.epochs=2"])
    capsys.readouterr()
    assert t_ckpt.read_manifest(ckpt)["epoch"] == 2


def test_cli_debug_nans_raises_at_the_first_bad_step(argv, schema, tmp_path, capsys):
    """An FM table with NaN in every row seeds FNN: with ``debug_nans`` the
    first step raises, before anything is updated; without it the run
    trains on to a NaN loss."""
    table = np.full((schema.padded_vocab_size, 1 + K), np.nan, np.float32)
    path = str(tmp_path / "nan.fm_table")
    t_ckpt.save_fm_embeddings(path, table)
    args = argv + ["model.name=fnn", f"model.init_from={path}"]
    with pytest.raises(FloatingPointError, match="train step 1: loss nan"):
        _run(args + ["train.debug_nans=true"])
    assert not torch.is_anomaly_enabled()
    res = _run(args)
    capsys.readouterr()
    assert np.isnan(res["history"][0]["train_loss"])


def test_cli_debug_nans_changes_nothing_on_a_healthy_run(argv, capsys):
    a = _run(argv)
    b = _run(argv + ["train.debug_nans=true"])
    capsys.readouterr()
    assert torch.equal(a["state"].table, b["state"].table)
    for key in ("auc", "logloss", "train_loss"):
        assert a["history"][0][key] == b["history"][0][key]


def test_cli_profile_dir_writes_a_trace(argv, tmp_path, capsys):
    """The training phase under ``torch.profiler``: a Chrome trace in the
    directory, holding the step's ops, and beside it the program's spans
    and phases (on the CPU the eager steps' host marks, a phase a step)."""
    out = tmp_path / "prof"
    _run(argv + [f"train.profile_dir={out}"])
    capsys.readouterr()
    traces = [f for f in os.listdir(out) if f.startswith("trace_")]
    spans = [f for f in os.listdir(out) if f.startswith("spans_")]
    assert len(traces) == len(spans) == 1 and len(os.listdir(out)) == 2
    names = {e.get("name") for e in json.loads((out / traces[0]).read_text())["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)
    host = json.loads((out / spans[0]).read_text())["host_phases"]
    assert host["steps"] > 0
    assert set(host["ms_a_step"]) == {"lookup", "tower", "sparse", "dense"}


def test_cli_score_under_profile_dir_writes_the_scorers_spans(argv, schema, tmp_path,
                                                             capsys):
    """``--score`` with ``train.profile_dir``: the same probabilities, and
    beside the trace the scorer's spans, a ``score.request`` a batch of the
    file holding its ``h2d``, ``forward``, ``fetch`` and ``sigmoid``, and its
    counters, the rows asked and the rows computed."""
    ckpt = str(tmp_path / "fnn.ckpt")
    _run(argv + [f"train.checkpoint_path={ckpt}"])
    yx = str(tmp_path / "requests.yx")
    synthetic.write_yx_file(synthetic.generate(schema, num_examples=150, k=K, seed=6), yx)
    score = ["--device", "cpu", "--score", yx] + argv + [f"train.checkpoint_path={ckpt}"]
    capsys.readouterr()
    assert t_cli.main(score) == 0
    plain = capsys.readouterr().out.split()
    out = tmp_path / "prof"
    assert t_cli.main(score + [f"train.profile_dir={out}"]) == 0
    assert capsys.readouterr().out.split() == plain and len(plain) == 150
    (spans,) = [f for f in os.listdir(out) if f.startswith("spans_")]
    assert len(os.listdir(out)) == 2
    got = json.loads((out / spans).read_text())
    assert got["counters"] == {"score.rows": 150, "score.padded_rows": 3 * BATCH}
    requests = [s for s in got["spans"] if s[3] == "score.request"]
    assert [s[6]["rows"] for s in requests] == [BATCH, BATCH, 150 - 2 * BATCH]
    for request in requests:
        inside = [s[3] for s in got["spans"] if s[2] == request[0] and s is not request]
        assert inside == ["score.h2d", "score.forward", "score.fetch", "score.sigmoid"]


def test_prefetcher_passes_batches_through_on_the_cpu(schema):
    ds = synthetic.generate(schema, num_examples=300, k=K, seed=2)

    def batches():
        return minibatches(ds.ids, ds.labels, BATCH, schema=schema, seed=4)

    got = list(DevicePrefetcher(batches(), "cpu"))
    want = list(batches())
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for a, b in ((g.ids, w.ids), (g.labels, w.labels), (g.weights, w.weights)):
            assert isinstance(a, np.ndarray)
            np.testing.assert_array_equal(a, b)


def test_prefetcher_raises_the_workers_error():
    def items():
        yield 1
        yield 2
        raise OSError("shard unreadable")

    it = DevicePrefetcher(items(), "cpu")
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(OSError, match="shard unreadable"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_prefetcher_stops_when_its_consumer_does():
    """A consumer that stops early (as early stopping does) closes it; the
    worker, blocked on a full queue of an endless source, ends."""
    def endless():
        n = 0
        while True:
            n += 1
            yield n

    before = threading.active_count()
    it = DevicePrefetcher(endless(), "cpu", depth=2)
    assert next(it) == 1
    closer = threading.Thread(target=it.close)
    closer.start()
    closer.join(timeout=10)
    assert not closer.is_alive() and not it._t.is_alive()
    assert threading.active_count() == before


@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
def test_fit_prefetch_gives_the_same_bits(schema, table_dtype):
    ds = synthetic.generate(schema, num_examples=700, k=K, seed=3)

    def run(prefetch):
        model = make_fnn(schema, k=K, mlp=MlpSpec(hidden=(16, 8), dropout=0.5),
                         device="cpu")
        sopt, dopt = SparseAdagrad(0.1), make_dense_optimizer("adagrad", 0.05)
        state = init_state(model, schema, sopt, dopt, seed=1, table_dtype=table_dtype)
        return fit(model, schema, ds.ids[:600], ds.labels[:600], ds.ids[600:],
                   ds.labels[600:], sparse_opt=sopt, dense_opt=dopt, batch_size=BATCH,
                   epochs=2, state=state, prefetch=prefetch)

    a, b = run(True), run(False)
    assert a.state.step == b.state.step == 2 * (600 // BATCH)
    for p, q in zip(a.state.model.state_dict().values(),
                    b.state.model.state_dict().values()):
        assert torch.equal(p, q)
    assert torch.equal(a.state.sparse_state.acc, b.state.sparse_state.acc)
    for p, q in zip(a.state.dense_state, b.state.dense_state):
        assert torch.equal(p, q)
    assert [r["auc"] for r in a.history] == [r["auc"] for r in b.history]
