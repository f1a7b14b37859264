"""The training slice as a whole: the port's train step, ``fit``, the CLI's
training run and the FM -> FNN hand-off against the JAX package.

Both sides start from the same parameters (JAX ``init_state`` loaded into
the port with ``params_from_jax``), take the same batches and the same
per-step dropout seeds (drawn from the JAX state's rng as its step does),
and the JAX tower runs through its Pallas kernels in interpret mode
(``use_pallas=True``), whose dropout is the counter hash the port has.
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from deepctr_torch import cli as t_cli
from deepctr_torch.models import MlpSpec as TMlpSpec
from deepctr_torch.models import make_fnn as t_make_fnn
from deepctr_torch.optim import make_dense_optimizer
from deepctr_torch.optim import sparse as t_sparse
from deepctr_torch.train import fit as t_fit
from deepctr_torch.train import init_state as t_init_state
from deepctr_torch.train import make_train_step as t_make_train_step
from deepctr_torch.utils import checkpoint as t_ckpt
from deepctr_tpu import cli as j_cli
from deepctr_tpu.data import make_schema, synthetic
from deepctr_tpu.models import MlpSpec, make_fnn
from deepctr_tpu.ops.split_embed import make_split_plan
from deepctr_tpu.optim import sparse as j_sparse
from deepctr_tpu.train import fit as j_fit
from deepctr_tpu.train import init_state as j_init_state
from deepctr_tpu.train import make_train_step as j_make_train_step
from deepctr_tpu.utils import checkpoint as j_ckpt

# f32 on both sides; sums are taken in other orders (and the JAX split plan
# sums its small fields' gradients as one-hot matmuls)
RTOL, ATOL = 1e-4, 1e-5
K = 3
HIDDEN = (16, 8)
BATCH = 64
SPLIT_THRESHOLD = 9   # fields a (4) and b (8) one-hot; c (16) and tags gathered
PRINT_ATOL = 1.01e-6  # --score prints 6 decimals (test_torch_serving.py)


@pytest.fixture(scope="module")
def schema():
    return make_schema([("a", 4), ("b", 8), ("c", 16), ("tags", 10, 3)])


@pytest.fixture(scope="module")
def data(schema):
    return synthetic.generate(schema, num_examples=3 * BATCH, k=K, seed=7)


def _optimizers(name):
    if name == "sgd":
        return (j_sparse.SparseSgd(0.1), optax.sgd(0.05),
                t_sparse.SparseSgd(0.1), make_dense_optimizer("sgd", 0.05))
    return (j_sparse.SparseAdagrad(0.1), optax.adagrad(0.05),
            t_sparse.SparseAdagrad(0.1), make_dense_optimizer("adagrad", 0.05))


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def _port_state_from_jax(schema, jstate, dropout, sopt, dopt, table_dtype):
    model = t_make_fnn(schema, k=K, mlp=TMlpSpec(hidden=HIDDEN, dropout=dropout),
                       device="cpu")
    state = t_init_state(model, schema, sopt, dopt, seed=0, table_dtype=table_dtype)
    model.load_state_dict(t_ckpt.params_from_jax(_f32(jstate.table), jstate.dense))
    return state


def _jax_seeds(rng, n):
    """The dropout seeds of n JAX steps: split as step.py:104, draw as
    fnn.py:64-66."""
    seeds = []
    for _ in range(n):
        rng, step_rng = jax.random.split(rng)
        seeds.append(int(jax.random.randint(step_rng, (), 0, 1 << 24)))
    return seeds


def _round_bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)


def _bf16_bits(a) -> np.ndarray:
    return np.asarray(a, ml_dtypes.bfloat16).view(np.uint16).astype(np.int32)


@pytest.mark.parametrize("split", [False, True], ids=["gather", "split"])
@pytest.mark.parametrize("dropout", [0.0, 0.5])
@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_train_trajectory_matches_jax(schema, data, opt, table_dtype, dropout, split):
    """Three steps: loss and logits per step, then the table, the
    accumulator and the dense parameters. A bf16 table may differ by one
    bf16 ulp where f32 sums taken in another order round to the other
    neighbour: at most 2% of the elements.

    SGD on a bf16 table: the port sums a row's duplicates in f32 and rounds
    once, on write, as the reference's split path does for its one-hot
    fields; the reference's gathered fields instead add each occurrence in
    bf16, one rounding per duplicate, in an order its scatter picks. So for
    that case the JAX side runs its f32 step on the bf16-rounded table and
    rounds the table to bf16 after each step."""
    jsopt, jdopt, tsopt, tdopt = _optimizers(opt)
    jmodel = make_fnn(schema, k=K, mlp=MlpSpec(hidden=HIDDEN, dropout=dropout),
                      use_pallas=True)
    round_after_step = opt == "sgd" and table_dtype == "bf16"
    jstate = j_init_state(jmodel, schema, jsopt, jdopt, seed=0,
                          table_dtype="f32" if round_after_step else table_dtype)
    if round_after_step:
        jstate = jstate._replace(table=_round_bf16(jstate.table))
    plan = make_split_plan(schema, SPLIT_THRESHOLD) if split else None
    if split:
        assert plan.small and plan.big_slots
    jstep = j_make_train_step(jmodel, schema, jsopt, jdopt, split=plan)
    state = _port_state_from_jax(schema, jstate, dropout, tsopt, tdopt, table_dtype)
    tstep = t_make_train_step(schema, tsopt, tdopt)
    seeds = _jax_seeds(jstate.rng, 3)

    for i, seed in enumerate(seeds):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        ids, labels = data.ids[sl], data.labels[sl]
        weights = np.ones(BATCH, np.float32)
        jstate, jm = jstep(jstate, jnp.asarray(ids), jnp.asarray(labels),
                           jnp.asarray(weights), 0.9)
        if round_after_step:
            jstate = jstate._replace(table=_round_bf16(jstate.table))
        state, tm = tstep(state, ids, labels, weights, 0.9, seed=seed)
        np.testing.assert_allclose(tm.logits.numpy(), np.asarray(jm.logits),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=RTOL, atol=ATOL)

    assert state.step == 3
    got_table = state.table.detach().float().numpy()
    want_table = _f32(jstate.table)
    assert np.all(got_table[schema.pad_id] == 0.0)
    if table_dtype == "f32":
        np.testing.assert_allclose(got_table, want_table, rtol=RTOL, atol=ATOL)
    else:
        assert state.table.dtype == torch.bfloat16
        assert np.array_equal(_f32(_round_bf16(want_table)), want_table)
        ulps = np.abs(_bf16_bits(got_table) - _bf16_bits(want_table))
        assert ulps.max() <= 1 and (ulps > 0).mean() <= 0.02
    if opt == "adagrad":
        np.testing.assert_allclose(state.sparse_state.acc.numpy(),
                                   np.asarray(jstate.sparse_state.acc),
                                   rtol=RTOL, atol=ATOL)
    _, got_dense = t_ckpt.params_to_jax(state.model)
    for a, b in zip(t_ckpt.jax_leaves(got_dense),
                    jax.tree_util.tree_leaves(jstate.dense), strict=True):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
def test_train_step_is_bitwise_repeatable(schema, data, table_dtype):
    """Three steps twice from one state, seeds from the state's generator:
    the same bits in the table, the accumulator and the tower."""
    _, _, tsopt, tdopt = _optimizers("adagrad")
    model = t_make_fnn(schema, k=K, mlp=TMlpSpec(hidden=HIDDEN, dropout=0.5),
                       device="cpu")
    start = t_init_state(model, schema, tsopt, tdopt, seed=3, table_dtype=table_dtype)
    step = t_make_train_step(schema, tsopt, tdopt)
    runs = []
    for _ in range(2):
        state = start.clone()
        for i in range(3):
            sl = slice(i * BATCH, (i + 1) * BATCH)
            state, _ = step(state, data.ids[sl], data.labels[sl],
                            np.ones(BATCH, np.float32))
        runs.append(state)
    a, b = runs
    assert torch.equal(a.table, b.table)
    assert torch.equal(a.sparse_state.acc, b.sparse_state.acc)
    for p, q in zip(a.model.parameters(), b.model.parameters(), strict=True):
        assert torch.equal(p, q)
    assert not torch.equal(a.table, start.table)


def test_fit_matches_jax(schema):
    """Two epochs of ``fit`` with dropout 0 from the same state: the
    history's AUC, logloss and train loss agree within 1e-4."""
    ds = synthetic.generate(schema, num_examples=1200, k=K, seed=9)
    tr, te = slice(0, 1000), slice(1000, 1200)
    jsopt, jdopt, tsopt, tdopt = _optimizers("adagrad")
    jmodel = make_fnn(schema, k=K, mlp=MlpSpec(hidden=HIDDEN, dropout=0.0),
                      use_pallas=True)
    jstate = j_init_state(jmodel, schema, jsopt, jdopt, seed=0)
    state = _port_state_from_jax(schema, jstate, 0.0, tsopt, tdopt, "f32")
    kw = dict(batch_size=BATCH, epochs=2, seed=5, lr_decay=0.8,
              early_stop_patience=5)
    want = j_fit(jmodel, schema, ds.ids[tr], ds.labels[tr], ds.ids[te],
                 ds.labels[te], sparse_opt=jsopt, dense_opt=jdopt, scan_steps=0,
                 state=jstate, prefetch=False, **kw)
    got = t_fit(state.model, schema, ds.ids[tr], ds.labels[tr], ds.ids[te],
                ds.labels[te], sparse_opt=tsopt, dense_opt=tdopt, state=state, **kw)
    assert len(got.history) == len(want.history) == 2
    for g, w in zip(got.history, want.history):
        for key in ("auc", "logloss", "train_loss"):
            assert abs(g[key] - w[key]) < 1e-4, (key, g[key], w[key])
    assert got.best_epoch == want.best_epoch


@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
def test_cli_trains_and_both_packages_score_its_checkpoint(schema, tmp_path,
                                                           capsys, table_dtype):
    schema_path = tmp_path / "schema.json"
    schema_path.write_text(schema.to_json())
    ckpt = str(tmp_path / "fnn.ckpt")
    common = [f"model.k={K}", "model.hidden=" + ",".join(map(str, HIDDEN)),
              f"train.checkpoint_path={ckpt}", f"train.batch_size={BATCH}"]
    train = common + [f"data.schema_path={schema_path}", "data.synthetic_examples=800",
                      "train.epochs=1", f"train.table_dtype={table_dtype}",
                      f"train.metrics_path={tmp_path / 'metrics.jsonl'}"]
    assert t_cli.main(train + ["--device", "cpu"]) == 0
    records = [r for r in capsys.readouterr().out.splitlines() if '"auc"' in r]
    assert len(records) == 1
    manifest = t_ckpt.read_manifest(ckpt)
    assert manifest["epoch"] == 1 and manifest["model"] == "fnn"
    assert manifest["bf16_leaves"] == ([1] if table_dtype == "bf16" else [])

    yx = str(tmp_path / "requests.yx")
    synthetic.write_yx_file(synthetic.generate(schema, num_examples=150, k=K, seed=6), yx)
    score = ["--score", yx] + common + ["model.use_pallas=true"]
    assert j_cli.main(score) == 0
    want = capsys.readouterr().out.split()
    assert t_cli.main(score + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.split()
    assert len(got) == len(want) == 150
    np.testing.assert_allclose(np.array(got, np.float64), np.array(want, np.float64),
                               rtol=0, atol=PRINT_ATOL)


@pytest.mark.parametrize("override", [
    "train.sharded=true", "train.distributed=true", "data.stream=true",
    "train.profile_dir=/nonexistent",
    "train.resume=true", "train.debug_nans=true",
])
def test_cli_raises_for_keys_not_ported(override, tmp_path, capsys):
    """No key raises now: each resolves to its value (``tests/
    test_torch_cli.py``, ``test_torch_resume.py``, ``test_torch_stream.py``,
    ``test_torch_parallel.py``, ``test_torch_sharded_cli.py`` and
    ``test_torch_distributed.py`` test what they do), and
    ``train.distributed`` passes through the CLI: with ``train.sharded``, a
    world of one that writes its rank's shard file."""
    key, value = override.split("=")
    section, name = key.split(".")
    cfg = t_cli.RunConfig().apply_overrides([override])
    assert str(getattr(getattr(cfg, section), name)).lower() == value.lower()
    if key == "train.distributed":
        ckpt = str(tmp_path / "ck.npz")
        assert t_cli.main([override, "train.sharded=true", "model.name=fm",
                           "model.k=3", "data.synthetic_examples=600",
                           "train.batch_size=128", "train.epochs=1",
                           f"train.checkpoint_path={ckpt}", "--device", "cpu"]) == 0
        capsys.readouterr()
        assert os.listdir(ckpt + ".hostshards") == ["proc0.npz"]


def test_cli_reads_tpu_mechanism_keys_without_effect(schema, tmp_path, capsys):
    """model.use_pallas and train.split_threshold change nothing in the
    port, nor does train.prefetch on the CPU (its batches pass through):
    the same seed gives the same history. (train.scan_steps is the
    reference's chunked route: tests/test_torch_scan.py.)"""
    schema_path = tmp_path / "schema.json"
    schema_path.write_text(schema.to_json())
    base = [f"data.schema_path={schema_path}", "data.synthetic_examples=400",
            f"model.k={K}", "model.hidden=8", "train.epochs=1",
            f"train.batch_size={BATCH}"]
    cfg = t_cli.RunConfig().apply_overrides(base)
    a = t_cli.run(cfg, torch.device("cpu"))
    cfg = cfg.apply_overrides(["model.use_pallas=true",
                               "train.split_threshold=0", "train.prefetch=false"])
    b = t_cli.run(cfg, torch.device("cpu"))
    capsys.readouterr()
    for key in ("auc", "logloss", "train_loss"):
        assert a["history"][0][key] == b["history"][0][key]


def test_fm_handoff_decodes_a_bf16_fm_table(tmp_path):
    """The reference's load_fm_embeddings hands back the uint16 bits of a
    bf16 FM table (0.5 comes back as 16128); the port's decodes it."""
    table = np.array([[0.5, -1.25], [3.0, 0.0]], np.float32)
    path = str(tmp_path / "fm.fm_table")
    j_ckpt.save_fm_embeddings(path, jnp.asarray(table).astype(jnp.bfloat16))
    raw = j_ckpt.load_fm_embeddings(path)
    assert raw.dtype == np.uint16 and raw[0, 0] == 16128
    got = t_ckpt.load_fm_embeddings(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, table)


@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
def test_fnn_init_from_fm_matches_jax(schema, tmp_path, table_dtype):
    """An f32 FM table lands in the port's FNN as in the reference's run();
    with a bf16 table the port casts it to the configured dtype."""
    fm = np.random.default_rng(2).normal(0.0, 0.3, (schema.padded_vocab_size, 1 + K))
    fm = fm.astype(np.float32)
    path = str(tmp_path / "fm.fm_table")
    j_ckpt.save_fm_embeddings(path, jnp.asarray(fm))
    jmodel = make_fnn(schema, k=K, mlp=MlpSpec(hidden=HIDDEN))
    jstate = j_init_state(jmodel, schema, j_sparse.SparseAdagrad(0.1),
                          optax.adagrad(0.05))
    want = j_ckpt.init_fnn_from_fm({"table": jstate.table, "dense": jstate.dense},
                                   j_ckpt.load_fm_embeddings(path))["table"]
    model = t_make_fnn(schema, k=K, mlp=TMlpSpec(hidden=HIDDEN), device="cpu")
    t_init_state(model, schema, t_sparse.SparseAdagrad(0.1),
                 make_dense_optimizer("adagrad", 0.05), table_dtype=table_dtype)
    t_ckpt.init_fnn_from_fm(model, t_ckpt.load_fm_embeddings(path))
    if table_dtype == "f32":
        np.testing.assert_array_equal(model.table.detach().numpy(), np.asarray(want))
    else:
        assert model.table.dtype == torch.bfloat16
        np.testing.assert_array_equal(model.table.detach().float().numpy(),
                                      fm.astype(ml_dtypes.bfloat16).astype(np.float32))
    with pytest.raises(ValueError, match="does not match"):
        t_ckpt.init_fnn_from_fm(model, fm[:-1])


def test_init_state_draws_from_the_seed(schema):
    """The table is normal with init_sigma and a zero pad row, the tower
    Glorot-uniform with zero biases; the seed alone decides the draws."""
    def init(seed):
        model = t_make_fnn(schema, k=K, mlp=TMlpSpec(hidden=HIDDEN), init_sigma=0.01,
                           device="cpu")
        t_init_state(model, schema, t_sparse.SparseSgd(0.1),
                     make_dense_optimizer("sgd", 0.1), seed=seed)
        return model

    a, b, c = init(1), init(1), init(2)
    for p, q in zip(a.parameters(), b.parameters(), strict=True):
        assert torch.equal(p, q)
    assert not torch.equal(a.table, c.table)
    table = a.table.detach().numpy()
    assert np.all(table[schema.pad_id] == 0.0)
    assert 0.005 < table.std() < 0.02
    dims = (schema.num_fields * (1 + K),) + HIDDEN + (1,)
    for layer, d_in, d_out in zip(a.mlp.layers, dims[:-1], dims[1:]):
        assert layer.w.abs().max() <= np.sqrt(6.0 / (d_in + d_out))
        assert torch.all(layer.b == 0)
