"""Train-state resume on the port (``utils/checkpoint.py::load_train_state``
and the CLI's ``train.resume``).

A killed and resumed run must give the uninterrupted run's bits: the table
(bf16 too), both optimizers' states, the dense parameters, the step count
and the dropout generator, whose state decides every later step's dropout
seed. And a train state written by the JAX package (adagrad and adam, f32
and bf16 tables) loads into the port, leaf for leaf, and one port step from
it matches the JAX step from it, given that step's dropout seed, within
``tests/test_torch_train.py``'s tolerance.
"""

import json
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from deepctr_torch import cli as t_cli
from deepctr_torch.models import MlpSpec as TMlpSpec
from deepctr_torch.models import make_fm as t_make_fm
from deepctr_torch.models import make_fnn as t_make_fnn
from deepctr_torch.optim import make_dense_optimizer
from deepctr_torch.optim import sparse as t_sparse
from deepctr_torch.train import fit as t_fit
from deepctr_torch.train import init_state as t_init_state
from deepctr_torch.train import make_train_step as t_make_train_step
from deepctr_torch.utils import checkpoint as t_ckpt
from deepctr_tpu.data import make_schema, synthetic
from deepctr_tpu.models import MlpSpec, make_fnn
from deepctr_tpu.optim import sparse as j_sparse
from deepctr_tpu.train import init_state as j_init_state
from deepctr_tpu.train import make_train_step as j_make_train_step
from deepctr_tpu.utils import checkpoint as j_ckpt
from test_torch_ranks import torchrun

# tests/test_torch_train.py's: f32 on both sides, sums in other orders
RTOL, ATOL = 1e-4, 1e-5
K = 3
HIDDEN = (16, 8)
BATCH = 64


@pytest.fixture(scope="module")
def schema():
    return make_schema([("a", 4), ("b", 8), ("c", 16), ("tags", 10, 3)])


@pytest.fixture(scope="module")
def data(schema):
    return synthetic.generate(schema, num_examples=6 * BATCH, k=K, seed=7)


def _model(schema, name, dropout=0.5):
    if name == "fm":
        return t_make_fm(schema, k=K, device="cpu")
    return t_make_fnn(schema, k=K, mlp=TMlpSpec(hidden=HIDDEN, dropout=dropout),
                      device="cpu")


def _state(schema, name, dense="adagrad", table_dtype="bf16", seed=0):
    sopt, dopt = t_sparse.SparseAdagrad(0.1), make_dense_optimizer(dense, 0.05)
    return t_init_state(_model(schema, name), schema, sopt, dopt, seed=seed,
                        table_dtype=table_dtype), sopt, dopt


def _leaves(state) -> list[torch.Tensor]:
    table, sparse, dense, dense_state = t_ckpt._state_leaves(state)
    return [torch.tensor(state.step), table, *sparse, *dense, *dense_state,
            state.generator.get_state()]


def _assert_same_bits(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"leaf {i} differs"


def _batches(data, lo, hi):
    return [(data.ids[i * BATCH:(i + 1) * BATCH], data.labels[i * BATCH:(i + 1) * BATCH],
             np.ones(BATCH, np.float32)) for i in range(lo, hi)]


@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dense", ["sgd", "adagrad", "adam"])
def test_train_state_roundtrip(schema, data, tmp_path, dense, table_dtype):
    """Save after two steps, load into a state initialised from another
    seed: every leaf comes back with its dtype and bits."""
    state, sopt, dopt = _state(schema, "fnn", dense, table_dtype, seed=4)
    step = t_make_train_step(schema, sopt, dopt)
    for b in _batches(data, 0, 2):
        state, _ = step(state, *b)
    path = str(tmp_path / "st.npz")
    t_ckpt.save_train_state(path, state, epoch=3)
    other, _, _ = _state(schema, "fnn", dense, table_dtype, seed=9)
    loaded = t_ckpt.load_train_state(path, other)
    assert loaded is other
    _assert_same_bits(loaded, state)
    assert t_ckpt.read_manifest(path)["epoch"] == 3


@pytest.mark.parametrize("name", ["fm", "fnn"])
def test_resume_is_deterministic(schema, data, tmp_path, name):
    """Save mid-training, resume, and get the in-process continuation's
    bits, the generator's too (FNN: dropout 0.5, bf16 table)."""
    state, sopt, dopt = _state(schema, name)
    step = t_make_train_step(schema, sopt, dopt, l2=1e-6)
    for b in _batches(data, 0, 3):
        state, _ = step(state, *b)
    path = str(tmp_path / "mid.npz")
    t_ckpt.save_train_state(path, state)
    a = state.clone()
    b = t_ckpt.load_train_state(path, _state(schema, name, seed=5)[0])
    for batch in _batches(data, 3, 6):
        a, _ = step(a, *batch)
        b, _ = step(b, *batch)
    assert a.step == b.step == 6
    _assert_same_bits(a, b)


def test_resume_without_the_generator_gives_other_bits(schema, data, tmp_path):
    """The check above can fail: a resume that restores everything but the
    dropout generator draws other dropout seeds, and other bits."""
    state, sopt, dopt = _state(schema, "fnn")
    step = t_make_train_step(schema, sopt, dopt)
    state, _ = step(state, *_batches(data, 0, 1)[0])
    path = str(tmp_path / "mid.npz")
    t_ckpt.save_train_state(path, state)
    a = state.clone()
    b = t_ckpt.load_train_state(path, _state(schema, "fnn", seed=5)[0])
    b.generator.manual_seed(5)
    a, _ = step(a, *_batches(data, 1, 2)[0])
    b, _ = step(b, *_batches(data, 1, 2)[0])
    assert not torch.equal(a.table, b.table)


@pytest.mark.parametrize("name", ["fm", "fnn"])
def test_fit_kill_and_resume_matches_uninterrupted(schema, tmp_path, name):
    """``fit`` for 2 epochs against 1 epoch, a checkpoint, a fresh state
    loaded from it, and ``fit`` from ``start_epoch=1``: the same bits, and
    the second epoch's record."""
    ds = synthetic.generate(schema, num_examples=600, k=K, seed=3)
    tr, te = slice(0, 500), slice(500, 600)
    kw = dict(batch_size=BATCH, seed=2, lr_decay=0.9, early_stop_patience=9)

    def run(state, sopt, dopt, **extra):
        return t_fit(state.model, schema, ds.ids[tr], ds.labels[tr], ds.ids[te],
                     ds.labels[te], sparse_opt=sopt, dense_opt=dopt, state=state,
                     **kw, **extra)

    whole = run(*_state(schema, name), epochs=2)
    half = run(*_state(schema, name), epochs=1)
    path = str(tmp_path / "e1.npz")
    t_ckpt.save_train_state(path, half.state, epoch=1)
    state, sopt, dopt = _state(schema, name, seed=11)
    rest = run(t_ckpt.load_train_state(path, state), sopt, dopt, epochs=2,
               start_epoch=1)
    _assert_same_bits(rest.state, whole.state)
    assert len(rest.history) == 1
    for key in ("epoch", "train_loss", "auc", "logloss"):
        assert rest.history[0][key] == whole.history[1][key]


def _cli_argv(schema_path, ckpt, metrics, extra):
    return [f"data.schema_path={schema_path}", "data.synthetic_examples=700",
            f"model.k={K}", "model.hidden=" + ",".join(map(str, HIDDEN)),
            f"train.batch_size={BATCH}", f"train.checkpoint_path={ckpt}",
            f"train.metrics_path={metrics}", "train.early_stop_patience=9",
            "train.table_dtype=bf16", "train.lr_decay=0.9", *extra]


def _checkpoint_leaves(path) -> list[np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        n = json.loads(str(z["manifest"]))["n"]
        return [z[f"leaf_{i}"] for i in range(n)]


@pytest.mark.parametrize("model", ["fnn", "fm"])
def test_cli_kill_and_resume_matches_uninterrupted(schema, tmp_path, capsys, model):
    """Through ``cli.run``: run A trains 2 epochs; run B trains 1, and B'
    resumes it to 2. B''s final checkpoint equals A's leaf for leaf, bit for
    bit; its ``resumed`` event names step and epoch; a third run resumed
    past the target only evaluates, and its checkpoint still says epoch 2.
    The runs take the CLI's default scan route: an epoch of 9 batches is
    two chunks of 8 steps, the last padded with 7 weight-0 steps, which
    count as steps as the reference's do."""
    sp = tmp_path / "schema.json"
    sp.write_text(schema.to_json())
    a_ckpt, b_ckpt = str(tmp_path / "a.ckpt"), str(tmp_path / "b.ckpt")
    b_metrics = tmp_path / "b.jsonl"
    extra = [f"model.name={model}", "model.dropout=0.5"]

    def run(ckpt, metrics, more):
        cfg = t_cli.RunConfig().apply_overrides(_cli_argv(sp, ckpt, metrics,
                                                          extra + more))
        return t_cli.run(cfg, torch.device("cpu"))

    a = run(a_ckpt, tmp_path / "a.jsonl", ["train.epochs=2"])
    run(b_ckpt, b_metrics, ["train.epochs=1"])
    b = run(b_ckpt, b_metrics, ["train.epochs=2", "train.resume=true"])
    capsys.readouterr()
    scan = t_cli.RunConfig().train.scan_steps
    steps_per_epoch = scan * math.ceil(int(700 * 0.85) // BATCH / scan)
    assert a["state"].step == b["state"].step == 2 * steps_per_epoch
    got, want = _checkpoint_leaves(b_ckpt), _checkpoint_leaves(a_ckpt)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert t_ckpt.read_manifest(b_ckpt)["epoch"] == 2
    events = [json.loads(line) for line in b_metrics.read_text().splitlines()]
    resumed = [e for e in events if e.get("event") == "resumed"]
    assert [(e["path"], e["step"], e["epoch"]) for e in resumed] == [
        (b_ckpt, steps_per_epoch, 1)]
    assert b["history"][0]["epoch"] == 1 and len(b["history"]) == 1

    c = run(b_ckpt, b_metrics, ["train.epochs=2", "train.resume=true"])
    capsys.readouterr()
    assert c["history"][0].get("eval_only") and c["state"].step == 2 * steps_per_epoch
    assert t_ckpt.read_manifest(b_ckpt)["epoch"] == 2


def test_sharded_cli_kill_and_resume_matches_uninterrupted(schema, tmp_path):
    """Two gloo ranks under ``torchrun`` (``train.sharded``, FNN with
    dropout 0.5, bf16 table): run A trains 3 epochs; run B trains 2, and B'
    resumes it to 3. B''s final checkpoint equals A's leaf for leaf, bit for
    bit, and rank 0 alone writes the metrics, with the ``resumed`` event."""
    sp = tmp_path / "schema.json"
    sp.write_text(schema.to_json())
    a_ckpt, b_ckpt = str(tmp_path / "a.ckpt"), str(tmp_path / "b.ckpt")
    b_metrics = tmp_path / "b.jsonl"
    extra = ["model.name=fnn", "model.dropout=0.5", "train.sharded=true",
             "train.capacity_factor=8.0", "train.lr_decay=0.7"]

    def run(ckpt, metrics, more):
        torchrun(_cli_argv(sp, ckpt, metrics, extra + more) + ["--device", "cpu"])

    run(a_ckpt, tmp_path / "a.jsonl", ["train.epochs=3", "train.num_devices=2"])
    run(b_ckpt, b_metrics, ["train.epochs=2", "train.prefetch=false"])
    run(b_ckpt, b_metrics, ["train.epochs=3", "train.resume=true"])
    got, want = _checkpoint_leaves(b_ckpt), _checkpoint_leaves(a_ckpt)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    scan = t_cli.RunConfig().train.scan_steps   # the sharded scan route's chunks
    steps_per_epoch = scan * math.ceil(int(700 * 0.85) // BATCH / scan)
    assert int(got[0]) == 3 * steps_per_epoch
    assert t_ckpt.read_manifest(b_ckpt)["epoch"] == 3
    events = [json.loads(line) for line in b_metrics.read_text().splitlines()]
    assert [e["epoch"] for e in events if "auc" in e] == [0, 1, 2]
    assert [(e["step"], e["epoch"]) for e in events if e.get("event") == "resumed"] == [
        (2 * steps_per_epoch, 2)]
    assert all(e["dropped_ids"] == 0 for e in events if "auc" in e)


@pytest.mark.parametrize("first,then", [("sharded", "unsharded"),
                                        ("unsharded", "sharded")])
def test_checkpoints_move_between_sharded_and_unsharded(schema, tmp_path, capsys,
                                                        first, then):
    """A world of one gives the single-device step's bits on the scan route
    (the configs' default of 8), so a checkpoint written by one route and
    resumed by the other ends bit-identical to an uninterrupted unsharded
    run."""
    sp = tmp_path / "schema.json"
    sp.write_text(schema.to_json())
    a_ckpt, b_ckpt = str(tmp_path / "a.ckpt"), str(tmp_path / "b.ckpt")
    extra = ["model.name=fnn", "model.dropout=0.5"]

    def run(ckpt, route, more):
        sharded = ["train.sharded=true"] if route == "sharded" else []
        cfg = t_cli.RunConfig().apply_overrides(
            _cli_argv(sp, ckpt, tmp_path / "m.jsonl", extra + sharded + more))
        return t_cli.run(cfg, torch.device("cpu"))

    run(a_ckpt, "unsharded", ["train.epochs=2"])
    run(b_ckpt, first, ["train.epochs=1"])
    run(b_ckpt, then, ["train.epochs=2", "train.resume=true"])
    capsys.readouterr()
    for g, w in zip(_checkpoint_leaves(b_ckpt), _checkpoint_leaves(a_ckpt), strict=True):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_cli_resume_from_checkpoint(tmp_path, capsys):
    """``tests/test_cli.py``'s gate on the port: resume picks up the saved
    step; the FM -> FNN hand-off is skipped when resuming."""
    ckpt = str(tmp_path / "resume.ckpt")
    base = ["model.name=fm", "model.k=3", "data.synthetic_examples=4000",
            "train.batch_size=512", "train.prefetch=false",
            f"train.checkpoint_path={ckpt}", f"train.metrics_path={tmp_path}/m.jsonl"]
    t_cli.run(t_cli.RunConfig().apply_overrides(base + ["train.epochs=2"]),
              torch.device("cpu"))
    res = t_cli.run(t_cli.RunConfig().apply_overrides(
        base + ["train.epochs=1", "train.resume=true"]), torch.device("cpu"))
    lines = [json.loads(ln) for ln in open(f"{tmp_path}/m.jsonl")]
    resumed = [ln for ln in lines if ln.get("event") == "resumed"]
    assert resumed and resumed[0]["step"] > 0
    assert np.isfinite(res["best_auc"])

    fnn = [f"model.init_from={tmp_path}/missing.fm_table", "model.name=fnn",
           "model.k=3", "model.hidden=8", "data.synthetic_examples=1000",
           "train.batch_size=256", f"train.checkpoint_path={tmp_path}/fnn.ckpt",
           "train.epochs=1"]
    with pytest.raises(FileNotFoundError):
        t_cli.run(t_cli.RunConfig().apply_overrides(fnn), torch.device("cpu"))
    t_cli.run(t_cli.RunConfig().apply_overrides(fnn + ["model.init_from=none"]),
              torch.device("cpu"))
    t_cli.run(t_cli.RunConfig().apply_overrides(fnn + ["train.resume=true"]),
              torch.device("cpu"))
    capsys.readouterr()


def _bf16_bits(a) -> np.ndarray:
    return np.asarray(a, ml_dtypes.bfloat16).view(np.uint16).astype(np.int32)


@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dense", ["adagrad", "adam"])
def test_jax_written_state_resumes_on_the_port(schema, data, tmp_path, dense,
                                               table_dtype):
    """A JAX train state after one step (FNN, dropout 0.5) saved by the JAX
    package loads into the port leaf for leaf; the generator is seeded from
    the key's words; then one step on each side, the port given the JAX
    step's dropout seed, agrees within the tolerance (a bf16 table within
    one bf16 ulp on at most 2% of its elements)."""
    jsopt = j_sparse.SparseAdagrad(0.1)
    jdopt = {"adagrad": optax.adagrad, "adam": optax.adam}[dense](0.05)
    jmodel = make_fnn(schema, k=K, mlp=MlpSpec(hidden=HIDDEN, dropout=0.5),
                      use_pallas=True)
    jstate = j_init_state(jmodel, schema, jsopt, jdopt, seed=0, table_dtype=table_dtype)
    jstep = j_make_train_step(jmodel, schema, jsopt, jdopt)
    batches = [tuple(jnp.asarray(x) for x in b) for b in _batches(data, 0, 2)]
    jstate, _ = jstep(jstate, *batches[0], 0.9)
    path = str(tmp_path / "jax.ckpt")
    j_ckpt.save_train_state(path, jstate, epoch=1)

    state, sopt, dopt = _state(schema, "fnn", dense, table_dtype, seed=3)
    state = t_ckpt.load_train_state(path, state)
    assert state.step == 1
    for got, want in zip(_leaves(state)[1:-1], jax.tree_util.tree_leaves(jstate)[1:-1],
                         strict=True):
        want = np.asarray(want)
        if want.dtype == ml_dtypes.bfloat16:
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.detach().numpy(), want)
    key = np.asarray(jstate.rng)
    want_gen = torch.Generator().manual_seed((int(key[0]) << 32) | int(key[1]))
    assert torch.equal(state.generator.get_state(), want_gen.get_state())

    _, step_rng = jax.random.split(jstate.rng)
    seed = int(jax.random.randint(step_rng, (), 0, 1 << 24))
    jstate, jm = jstep(jstate, *batches[1], 0.9)
    state, tm = t_make_train_step(schema, sopt, dopt)(
        state, *(np.array(x) for x in batches[1]), 0.9, seed=seed)
    np.testing.assert_allclose(tm.logits.numpy(), np.asarray(jm.logits),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=RTOL, atol=ATOL)
    got_table = state.table.detach().float().numpy()
    want_table = np.asarray(jstate.table).astype(np.float32)
    if table_dtype == "f32":
        np.testing.assert_allclose(got_table, want_table, rtol=RTOL, atol=ATOL)
    else:
        ulps = np.abs(_bf16_bits(got_table) - _bf16_bits(want_table))
        assert ulps.max() <= 1 and (ulps > 0).mean() <= 0.02
    want_rest = jax.tree_util.tree_leaves((jstate.sparse_state, jstate.dense,
                                           jstate.dense_state))
    _, sparse, dense_p, dense_s = t_ckpt._state_leaves(state)
    got_rest = [*sparse, *dense_p, *dense_s]
    assert len(got_rest) == len(want_rest)
    for g, w in zip(got_rest, want_rest):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("change,match", [
    ({"dense": "adam"}, "leaves"),
    ({"table_dtype": "f32"}, "table_dtype"),
    ({"name": "fm"}, "leaves|mismatch"),
])
def test_load_train_state_refuses_a_mismatch(schema, tmp_path, change, match):
    """A checkpoint of another optimizer, table dtype or model raises."""
    state, _, _ = _state(schema, "fnn")
    path = str(tmp_path / "st.npz")
    t_ckpt.save_train_state(path, state)
    kw = {"name": "fnn", "dense": "adagrad", "table_dtype": "bf16", **change}
    other, _, _ = _state(schema, kw["name"], kw["dense"], kw["table_dtype"])
    with pytest.raises(ValueError, match=match):
        t_ckpt.load_train_state(path, other)
