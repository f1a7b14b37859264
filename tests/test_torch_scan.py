"""The port's scan route (``train.scan_steps``, the reference's default
training route) against the JAX package's on the CPU, and the pieces that
the route's CUDA graph rests on.

- ``make_scan_train_step``: one chunk of K = 3 steps from one state, its
  last step a weight-0 pad step, the port given the JAX steps' dropout
  seeds: losses, table, Adagrad accumulator, dense parameters and the dense
  optimizer's state (Adam's moments and count move on the pad step);
- ``fit(scan_steps=7)`` over 30 batches (so each epoch's last chunk is
  padded) against the reference's ``fit(scan_steps=7)``; the port's
  ``fit(scan_steps=K)`` against its own per-step ``fit``, bit for bit;
- the CLI's streamed run with ``train.scan_steps=4`` against the JAX CLI's;
- the static-shape sparse update against the boolean-mask form it
  replaced, bit for bit; a 0-d tensor seed against the same int seed;
  ``DevicePrefetcher`` passing chunks through.

The JAX towers and FM scorer run their Pallas kernels in interpret mode
(``use_pallas=True``). On the CPU a chunk is K eager steps; the card's
graph replay is held against eager steps by ``chip_smoke.py`` phase 17.
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
from deepctr_torch import models as t_models
from deepctr_torch.config import RunConfig as TRunConfig
from deepctr_torch.data import DevicePrefetcher
from deepctr_torch.models import MlpSpec as TMlpSpec
from deepctr_torch.ops.kernels import mlp as mlp_k
from deepctr_torch.ops.scatter import dedupe_grads
from deepctr_torch.optim import make_dense_optimizer
from deepctr_torch.optim import sparse as t_sparse
from deepctr_torch.train import fit as t_fit
from deepctr_torch.train import init_state as t_init_state
from deepctr_torch.train import make_scan_train_step as t_make_scan_train_step
from deepctr_torch.utils import checkpoint as t_ckpt
from deepctr_tpu import cli as j_cli
from deepctr_tpu.config import RunConfig
from deepctr_tpu.data import make_schema, synthetic
from deepctr_tpu.models import FMModel, MlpSpec, make_deepfm, make_fnn
from deepctr_tpu.optim import sparse as j_sparse
from deepctr_tpu.train import fit as j_fit
from deepctr_tpu.train import init_state as j_init_state
from deepctr_tpu.train.step import make_scan_train_step as j_make_scan_train_step
from deepctr_tpu.utils.checkpoint import save_train_state as j_save_train_state

# f32 on both sides; sums are taken in other orders
RTOL, ATOL = 1e-4, 1e-5
K = 3            # embedding width of the small models
HIDDEN = (16, 8)
BATCH = 64
SPARSE_LR = 0.1
ADAGRAD_EPS = 1e-6   # SparseAdagrad's default, both packages
STEPS = 3            # steps of the chunk in the step test: 2 real, 1 pad
# the CLI's epoch records: losses of 40 steps each, f32 sums in other
# orders; the reference's scan and per-step routes differ by 5e-5 in
# epoch 0's logloss on this run, which this bound tells apart
RECORD_TOL = 1e-5
# test_torch_train.py's bound for fit's records: the AUC of 1,096 held-out
# rows moves by about 5e-6 for each pair of near-equal logits that swap
FIT_TOL = 1e-4


@pytest.fixture(scope="module")
def schema():
    return make_schema([("a", 4), ("b", 8), ("c", 16), ("tags", 10, 3)])


@pytest.fixture(scope="module")
def data(schema):
    return synthetic.generate(schema, num_examples=STEPS * BATCH, k=K, seed=7)


def _models(schema, name, dropout):
    """(JAX model, port model) at the test's widths."""
    if name == "fm":
        return FMModel(k=K, use_pallas=True), t_models.make_fm(schema, k=K, device="cpu")
    act = "tanh" if name == "fnn" else "relu"
    jmlp = MlpSpec(hidden=HIDDEN, activation=act, dropout=dropout)
    tmlp = TMlpSpec(hidden=HIDDEN, activation=act, dropout=dropout)
    if name == "fnn":
        return (make_fnn(schema, k=K, mlp=jmlp, use_pallas=True),
                t_models.make_fnn(schema, k=K, mlp=tmlp, device="cpu"))
    return (make_deepfm(schema, k=K, mlp=jmlp, use_pallas=True),
            t_models.make_deepfm(schema, k=K, mlp=tmlp, device="cpu"))


def _optimizers(sparse, mode, dense):
    if sparse == "sgd":
        jsopt, tsopt = j_sparse.SparseSgd(SPARSE_LR), t_sparse.SparseSgd(SPARSE_LR)
    else:
        jsopt = j_sparse.SparseAdagrad(SPARSE_LR, eps=ADAGRAD_EPS, mode=mode)
        tsopt = t_sparse.SparseAdagrad(SPARSE_LR, eps=ADAGRAD_EPS, mode=mode)
    jdopt = {"sgd": optax.sgd, "adagrad": optax.adagrad, "adam": optax.adam}[dense](0.05)
    return jsopt, jdopt, tsopt, make_dense_optimizer(dense, 0.05)


def _jax_seeds(rng, n):
    """The dropout seeds of n JAX steps: split as step.py:104, draw as
    fnn.py:64-66 (the scan's body is the same step)."""
    seeds = []
    for _ in range(n):
        rng, step_rng = jax.random.split(rng)
        seeds.append(int(jax.random.randint(step_rng, (), 0, 1 << 24)))
    return seeds


def _bf16_bits(a) -> np.ndarray:
    return np.asarray(a, ml_dtypes.bfloat16).view(np.uint16).astype(np.int32)


def _port_state(schema, jstate, model, tsopt, tdopt, table_dtype):
    state = t_init_state(model, schema, tsopt, tdopt, seed=0, table_dtype=table_dtype)
    model.load_state_dict(t_ckpt.params_from_jax(
        np.asarray(jstate.table).astype(np.float32), jstate.dense))
    return state


def _padded_chunk(schema, data):
    """ids [3, B, S], labels, weights: two batches of data and a pad step."""
    ids = data.ids.reshape(STEPS, BATCH, -1).copy()
    labels = data.labels.reshape(STEPS, BATCH).copy()
    weights = np.ones((STEPS, BATCH), np.float32)
    ids[-1], labels[-1], weights[-1] = schema.pad_id, 0.0, 0.0
    return ids, labels, weights


# (model, dropout, table dtype, sparse optimizer, sparse mode, dense optimizer)
STEP_CASES = [
    ("fnn", 0.5, "f32", "adagrad", "dense", "sgd"),
    ("fnn", 0.5, "bf16", "adagrad", "sorted", "adagrad"),
    ("fnn", 0.5, "f32", "sgd", "sorted", "adam"),
    ("fm", 0.0, "f32", "adagrad", "sorted", "adagrad"),
    ("fm", 0.0, "bf16", "adagrad", "dense", "sgd"),
    ("deepfm", 0.5, "f32", "sgd", "sorted", "adam"),
    ("deepfm", 0.5, "bf16", "adagrad", "sorted", "adam"),
]


@pytest.mark.parametrize("case", STEP_CASES, ids=["-".join(map(str, c)) for c in STEP_CASES])
def test_scan_step_matches_jax(schema, data, case):
    """One chunk of 3 steps, the last a weight-0 pad step, through both
    packages' ``make_scan_train_step``: the per-step losses (the pad
    step's is 0), ``state.step`` 3, the table (a bf16 table within one
    bf16 ulp on at most 2% of its elements, where f32 sums taken in
    another order round to the other neighbour), the accumulator, the
    dense parameters and the dense optimizer's state. An f32 Adagrad
    element whose summed gradient came within 10 eps of 0 (FM's linear
    weights start at 0) carries that sum's relative error times
    ``eps / (|g| + eps)``: such elements are held to ``lr x 1e-3``
    (tests/test_torch_models.py says more). SGD on a bf16 table is left
    out: the reference rounds each gathered occurrence there, the port
    each row once (ROADMAP.md section 3)."""
    name, dropout, table_dtype, sparse, mode, dense = case
    jsopt, jdopt, tsopt, tdopt = _optimizers(sparse, mode, dense)
    jmodel, model = _models(schema, name, dropout)
    jstate = j_init_state(jmodel, schema, jsopt, jdopt, seed=0, table_dtype=table_dtype)
    state = _port_state(schema, jstate, model, tsopt, tdopt, table_dtype)
    seeds = _jax_seeds(jstate.rng, STEPS)
    acc0 = state.sparse_state.acc.clone() if sparse == "adagrad" else None
    chunk = _padded_chunk(schema, data)

    jstate, jlosses = j_make_scan_train_step(jmodel, schema, jsopt, jdopt)(
        jstate, *(jnp.asarray(a) for a in chunk), 0.9)
    state, losses = t_make_scan_train_step(schema, tsopt, tdopt)(
        state, *chunk, 0.9, seeds=seeds)

    assert state.step == int(jstate.step) == STEPS
    assert losses.shape == (STEPS,) and float(losses[-1]) == 0.0
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=RTOL, atol=ATOL)
    got_table = state.table.detach().float().numpy()
    want_table = np.asarray(jstate.table).astype(np.float32)
    assert np.all(got_table[schema.pad_id] == 0.0)
    if table_dtype == "f32":
        near = np.zeros(got_table.shape, bool)
        if acc0 is not None:
            g2 = (state.sparse_state.acc - acc0).numpy()
            near = (g2 > 0) & (g2 < (10 * ADAGRAD_EPS) ** 2)
        np.testing.assert_allclose(got_table[~near], want_table[~near], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got_table[near], want_table[near], rtol=0,
                                   atol=SPARSE_LR * 1e-3)
    else:
        ulps = np.abs(_bf16_bits(got_table) - _bf16_bits(want_table))
        assert ulps.max() <= 1 and (ulps > 0).mean() <= 0.02
    want_rest = jax.tree_util.tree_leaves((jstate.sparse_state, jstate.dense,
                                           jstate.dense_state))
    _, sparse_leaves, dense_p, dense_s = t_ckpt._state_leaves(state)
    got_rest = [*sparse_leaves, *dense_p, *dense_s]
    assert len(got_rest) == len(want_rest)
    for g, w in zip(got_rest, want_rest):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    if dense == "adam":
        assert int(state.dense_state.count) == STEPS   # the pad step counts


def _fm_states(tiny_schema, dense):
    jsopt, jdopt, tsopt, tdopt = _optimizers("adagrad", "auto", dense)
    jmodel = FMModel(k=3)
    jstate = j_init_state(jmodel, tiny_schema, jsopt, jdopt, seed=0)
    model = t_models.make_fm(tiny_schema, k=3, device="cpu")
    state = _port_state(tiny_schema, jstate, model, tsopt, tdopt, "f32")
    return jmodel, jstate, jsopt, jdopt, model, state, tsopt, tdopt


@pytest.mark.parametrize("dense", ["sgd", "adam"])
def test_fit_scan_matches_jax(tiny_schema, tiny_dataset, dense):
    """``fit(scan_steps=7)`` on both packages, the shape of
    tests/test_train.py:73-101 (FM k=3, 3000 rows in batches of 100: 30
    batches, so each epoch's last chunk is 2 steps and 5 pad steps), sparse
    Adagrad with SGD or Adam on the dense side, 2 epochs from one state:
    ``state.step`` 70 on both (35 a epoch, pad steps included), the table,
    the dense leaves and the epoch records."""
    ds = tiny_dataset
    jmodel, jstate, jsopt, jdopt, model, state, tsopt, tdopt = _fm_states(
        tiny_schema, dense)
    kw = dict(batch_size=100, epochs=2, early_stop_patience=5, seed=4,
              scan_steps=7, prefetch=False)
    data = (ds.ids[:3000], ds.labels[:3000], ds.ids[3000:], ds.labels[3000:])
    want = j_fit(jmodel, tiny_schema, *data, sparse_opt=jsopt, dense_opt=jdopt,
                 state=jstate, **kw)
    got = t_fit(model, tiny_schema, *data, sparse_opt=tsopt, dense_opt=tdopt,
                state=state, **kw)
    assert got.state.step == int(want.state.step) == 2 * 35
    np.testing.assert_allclose(got.state.table.numpy(), np.asarray(want.state.table),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.state.sparse_state.acc.numpy(),
                               np.asarray(want.state.sparse_state.acc), rtol=RTOL,
                               atol=ATOL)
    _, _, dense_p, dense_s = t_ckpt._state_leaves(got.state)
    want_rest = jax.tree_util.tree_leaves((want.state.dense, want.state.dense_state))
    for g, w in zip([*dense_p, *dense_s], want_rest, strict=True):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    for g, w in zip(got.history, want.history, strict=True):
        for key in ("auc", "logloss", "train_loss"):
            assert abs(g[key] - w[key]) < FIT_TOL, (key, g[key], w[key])


@pytest.mark.parametrize("scan_steps", [4, 6])
def test_fit_scan_equals_per_step_bit_for_bit(schema, scan_steps):
    """Where K divides an epoch's batches no step is padded, so the port's
    ``fit(scan_steps=K)`` takes the per-step route's steps: FNN with
    dropout 0.5 on a bf16 table, 2 epochs of 24 batches with ``lr_decay``,
    the same bits in the table, the accumulator, the tower, the
    generator, ``state.step`` and the eval records."""
    ds = synthetic.generate(schema, num_examples=24 * 32 + 200, k=K, seed=11)
    runs = []
    for k in (0, scan_steps):
        model = t_models.make_fnn(schema, k=K, mlp=TMlpSpec(hidden=HIDDEN, dropout=0.5),
                                  device="cpu")
        runs.append(t_fit(model, schema, ds.ids[:768], ds.labels[:768], ds.ids[768:],
                          ds.labels[768:], sparse_opt=t_sparse.SparseAdagrad(0.1),
                          dense_opt=make_dense_optimizer("adagrad", 0.05),
                          batch_size=32, epochs=2, seed=3, lr_decay=0.8,
                          table_dtype="bf16", early_stop_patience=5,
                          scan_steps=k))
    a, b = (r.state for r in runs)
    assert a.step == b.step == 48
    assert torch.equal(a.table, b.table)
    assert torch.equal(a.sparse_state.acc, b.sparse_state.acc)
    for p, q in zip(a.model.parameters(), b.model.parameters(), strict=True):
        assert torch.equal(p, q)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    for ra, rb in zip(*(r.history for r in runs), strict=True):
        assert (ra["auc"], ra["logloss"]) == (rb["auc"], rb["logloss"])
        assert abs(ra["train_loss"] - rb["train_loss"]) < 1e-6   # summed in chunks


def _write_shards(tmp_path, ds, n_shards):
    rows = len(ds.labels)
    for i in range(n_shards):
        sl = slice(i * rows // n_shards, (i + 1) * rows // n_shards)
        synthetic.write_yx_file(synthetic.SyntheticDataset(
            ds.schema, ds.ids[sl], ds.labels[sl], ds.bayes_logits[sl]),
            str(tmp_path / f"shard_{i}.yx"))


def _records(path):
    with open(path) as f:
        events = [json.loads(line) for line in f]
    return ([e for e in events if "auc" in e],
            [e["step"] for e in events if e.get("event") == "heartbeat"])


def test_cli_stream_scan_matches_jax_cli(tmp_path):
    """The streamed run of tests/test_torch_stream.py::
    test_cli_stream_end_to_end (FM k=3, 3 shards of 10,000 rows, batch 256,
    2 epochs) with ``optim.dense=adam train.scan_steps=4`` through both
    CLIs, both resuming one JAX-written epoch-0 state (the port draws its
    initial values from a ``torch.Generator``): the heartbeats' steps are
    the reference's 40 and 80 (39 batches an epoch, the last chunk padded
    by one step), and each epoch's record agrees within RECORD_TOL."""
    schema = make_schema([("a", 6), ("b", 12), ("c", 300), ("d", 40)])
    sp = str(tmp_path / "schema.json")
    open(sp, "w").write(schema.to_json())
    ds = synthetic.generate(schema, num_examples=12_000, k=3, seed=5)
    cut = 10_000
    _write_shards(tmp_path, synthetic.SyntheticDataset(
        schema, ds.ids[:cut], ds.labels[:cut], ds.bayes_logits[:cut]), 3)
    te = str(tmp_path / "test.yx")
    synthetic.write_yx_file(synthetic.SyntheticDataset(
        schema, ds.ids[cut:], ds.labels[cut:], ds.bayes_logits[cut:]), te)
    base = ["model.name=fm", "model.k=3", f"data.schema_path={sp}", "data.stream=true",
            "data.stream_buffer_rows=2048", f"data.train_path={tmp_path}/shard_*.yx",
            f"data.test_path={te}", "data.use_cache=false", "train.batch_size=256",
            "train.epochs=2", "train.scan_steps=4", "optim.dense=adam",
            "train.resume=true", "train.early_stop_patience=5"]
    cfg = RunConfig().apply_overrides(base)
    state = j_init_state(j_cli.build_model(cfg, schema), schema,
                         *j_cli.build_optimizers(cfg), seed=cfg.train.seed)
    runs = {}
    for who in ("port", "jax"):
        ckpt, metrics = str(tmp_path / f"{who}.npz"), str(tmp_path / f"{who}.jsonl")
        j_save_train_state(ckpt, state, epoch=0, meta={"model": "fm"}, schema=schema)
        args = base + [f"train.checkpoint_path={ckpt}", f"train.metrics_path={metrics}"]
        if who == "port":
            res = t_cli.run(TRunConfig().apply_overrides(args + ["train.prefetch=true"]),
                            torch.device("cpu"))
            assert res["state"].step == 2 * math.ceil((cut // 256) / 4) * 4
        else:
            j_cli.run(RunConfig().apply_overrides(args + ["train.prefetch=false"]))
        runs[who] = _records(metrics)
    (got, got_steps), (want, want_steps) = runs["port"], runs["jax"]
    assert got_steps == want_steps == [40, 80]
    for g, w in zip(got, want, strict=True):
        for key in ("auc", "logloss", "train_loss"):
            assert abs(g[key] - w[key]) < RECORD_TOL, (key, g[key], w[key])


def test_sharded_run_takes_the_scan_route(tmp_path):
    """``train.sharded`` with ``train.scan_steps=8`` (a world of one on the
    CPU) trains on the sharded scan route: its 5 batches are one chunk
    padded to 8 steps, and no event says the route was changed."""
    metrics = tmp_path / "m.jsonl"
    batches = 1000 * 85 // 100 // 128
    res = t_cli.run(TRunConfig().apply_overrides([
        "model.name=fm", "model.k=3", "data.synthetic_examples=1000",
        "train.batch_size=128", "train.epochs=1", "train.sharded=true",
        "train.scan_steps=8", f"train.metrics_path={metrics}"]), torch.device("cpu"))
    assert res["state"].step == 8 * math.ceil(batches / 8) == 8
    events = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert not [e for e in events if e.get("event") == "scan_steps_per_step"]
    (rec,) = [e for e in events if "auc" in e]
    assert rec["dropped_ids"] == 0 and np.isfinite(rec["train_loss"])


def _old_sparse_update(opt, table, acc, ids, rows, lr_scale=1.0):
    """The boolean-mask form the static-shape update replaced, kept here as
    its reference: ``ids[is_last]`` selects the unique rows."""
    lr = opt.learning_rate * lr_scale
    d = dedupe_grads(ids, rows.float())
    uids = d.ids[d.is_last]
    g = d.rows[d.is_last]
    if acc is None:
        table[uids] = (table[uids].float() - lr * g).to(table.dtype)
        return
    acc[uids] += g * g
    delta = -lr * g / (acc[uids].sqrt() + opt.eps)
    table[uids] = (table[uids].float() + delta.to(table.dtype).float()).to(table.dtype)


@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_static_sparse_update_equals_the_mask_form(opt, table_dtype):
    """The sorted-mode update with static shapes (every occurrence writes
    its id's new row) against the boolean-mask form, bit for bit: ids with
    many duplicates and pad slots (zero gradients), two updates so that
    Adagrad's accumulator is read back."""
    rng = np.random.default_rng(5)
    vocab, d, pad = 50, 7, 49
    table = torch.from_numpy(rng.normal(0, 0.1, (vocab, d)).astype(np.float32))
    table[pad] = 0.0
    table = table.to(table_dtype)
    new = (t_sparse.SparseSgd(0.3) if opt == "sgd"
           else t_sparse.SparseAdagrad(0.3, mode="sorted"))
    state = new.init(table)
    want_table = table.clone()
    want_acc = state.acc.clone() if opt == "adagrad" else None
    for _ in range(2):
        ids = torch.from_numpy(rng.integers(0, vocab, 600))
        ids[rng.random(600) < 0.2] = pad
        rows = torch.from_numpy(rng.normal(0, 1.0, (600, d)).astype(np.float32))
        rows[ids == pad] = 0.0
        new.update(table, state, ids, rows, lr_scale=0.7)
        _old_sparse_update(new, want_table, want_acc, ids, rows, lr_scale=0.7)
    assert table.dtype == table_dtype
    assert torch.equal(table.view(torch.int16) if table_dtype == torch.bfloat16
                       else table.view(torch.int32),
                       want_table.view(torch.int16) if table_dtype == torch.bfloat16
                       else want_table.view(torch.int32))
    if opt == "adagrad":
        assert torch.equal(state.acc, want_acc)


@pytest.mark.parametrize("seed", [0, 12345, (1 << 24) - 1])
def test_tensor_seed_equals_int_seed(seed):
    """A seed given as a 0-d int32 tensor (as the graph's seed buffer
    hands it to the tower) gives the int seed's mask, forward and
    gradients, bit for bit, through the plain versions on the CPU."""
    rng = np.random.default_rng(seed % 1000)
    dims = (12, 16, 8, 1)
    layers = [(torch.from_numpy(rng.normal(0, 0.3, (a, b)).astype(np.float32)),
               torch.from_numpy(rng.normal(0, 0.1, b).astype(np.float32)))
              for a, b in zip(dims[:-1], dims[1:])]
    x = torch.from_numpy(rng.normal(0, 1, (40, dims[0])).astype(np.float32))
    t_seed = torch.tensor(seed, dtype=torch.int32)
    assert torch.equal(mlp_k.dropout_mask_plain((40, 16), 0.5, t_seed, 1),
                       mlp_k.dropout_mask_plain((40, 16), 0.5, seed, 1))
    assert torch.equal(mlp_k.mlp_tower_plain(x, layers, "tanh", 0.5, t_seed),
                       mlp_k.mlp_tower_plain(x, layers, "tanh", 0.5, seed))
    grads = []
    for s in (t_seed, seed):
        xs = x.clone().requires_grad_(True)
        params = [t.clone().requires_grad_(True) for layer in layers for t in layer]
        out = mlp_k.mlp_tower(xs, list(zip(params[0::2], params[1::2])), "tanh", 0.5, s)
        grads.append(torch.autograd.grad(out.square().sum(), [xs] + params))
    for a, b in zip(*grads, strict=True):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="0-d int32"):
        mlp_k._check_args(x, layers, "tanh", 0.5, t_seed.long())


def test_prefetcher_passes_chunks_through():
    """On the CPU ``DevicePrefetcher`` hands the scan route's chunks
    ``(nb, (ids, labels, weights))`` on unchanged, in order."""
    rng = np.random.default_rng(0)
    chunks = [(n, (rng.integers(0, 9, (4, 8, 3)).astype(np.int32),
                   rng.random((4, 8)).astype(np.float32),
                   np.ones((4, 8), np.float32))) for n in (4, 4, 2)]
    pf = DevicePrefetcher(iter(chunks), "cpu")
    got = list(pf)
    pf.close()
    assert [n for n, _ in got] == [4, 4, 2]
    for (_, g), (_, w) in zip(got, chunks, strict=True):
        for a, b in zip(g, w, strict=True):
            np.testing.assert_array_equal(a, b)
