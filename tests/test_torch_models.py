"""The port's LR, FM, DeepFM and PNN against the JAX package: forwards, 3-step
train trajectories, the CLI (build_model, the FM -> FNN pipeline, --score
by both packages) and the ``model.init_from`` gate.

Both sides start from the same parameters (JAX ``init_state`` loaded into
the port with ``params_from_jax``) and take the same batches; DeepFM also
takes the per-step dropout seeds drawn from the JAX state's rng as its step
does. The JAX FM scorer and tower run through their Pallas kernels in
interpret mode (``use_pallas=True``) where the model has the switch; PNN's
JAX tower is ``apply_mlp``, whose dropout is ``jax.random.bernoulli``, so
PNN is compared at dropout 0.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from deepctr_torch import cli as t_cli
from deepctr_torch import models as t_models
from deepctr_torch.models import MlpSpec as TMlpSpec
from deepctr_torch.optim import make_dense_optimizer
from deepctr_torch.optim import sparse as t_sparse
from deepctr_torch.train import init_state as t_init_state
from deepctr_torch.train import make_train_step as t_make_train_step
from deepctr_torch.utils import checkpoint as t_ckpt
from deepctr_tpu import cli as j_cli
from deepctr_tpu.data import make_schema, synthetic
from deepctr_tpu.models import FMModel, LRModel, MlpSpec, apply_model, make_deepfm, make_pnn
from deepctr_tpu.optim import sparse as j_sparse
from deepctr_tpu.train import init_state as j_init_state
from deepctr_tpu.train import make_train_step as j_make_train_step
from deepctr_tpu.utils import checkpoint as j_ckpt

# f32 on both sides; sums are taken in other orders
RTOL, ATOL = 1e-4, 1e-5
K = 3
HIDDEN = (16, 8)
BATCH = 64
L2 = 1e-3
SPARSE_LR = 0.1
ADAGRAD_EPS = 1e-6    # SparseAdagrad's default, both packages
PRINT_ATOL = 1.01e-6  # --score prints 6 decimals (test_torch_serving.py)


@pytest.fixture(scope="module")
def schema():
    return make_schema([("a", 4), ("b", 8), ("c", 16), ("tags", 10, 3)])


@pytest.fixture(scope="module")
def data(schema):
    return synthetic.generate(schema, num_examples=3 * BATCH, k=K, seed=7)


def _models(schema, name, dropout=0.0):
    """(JAX model, port model) of one name, at the test's widths."""
    jmlp = MlpSpec(hidden=HIDDEN, activation="relu", dropout=dropout)
    tmlp = TMlpSpec(hidden=HIDDEN, activation="relu", dropout=dropout)
    if name == "lr":
        return LRModel(), t_models.make_lr(schema, device="cpu")
    if name == "fm":
        return (FMModel(k=K, use_pallas=True),
                t_models.make_fm(schema, k=K, device="cpu"))
    if name == "deepfm":
        return (make_deepfm(schema, k=K, mlp=jmlp, use_pallas=True),
                t_models.make_deepfm(schema, k=K, mlp=tmlp, device="cpu"))
    product = {"ipnn": "inner", "opnn": "outer"}[name]
    return (make_pnn(schema, k=K, product=product, mlp=jmlp),
            t_models.make_pnn(schema, k=K, product=product, mlp=tmlp, device="cpu"))


def _optimizers(name):
    if name == "sgd":
        return (j_sparse.SparseSgd(SPARSE_LR), optax.sgd(0.05),
                t_sparse.SparseSgd(SPARSE_LR), make_dense_optimizer("sgd", 0.05))
    return (j_sparse.SparseAdagrad(SPARSE_LR, eps=ADAGRAD_EPS), optax.adagrad(0.05),
            t_sparse.SparseAdagrad(SPARSE_LR, eps=ADAGRAD_EPS),
            make_dense_optimizer("adagrad", 0.05))


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def _jax_seeds(rng, n):
    """The dropout seeds of n JAX steps: split as step.py:104, draw as
    deepfm.py:76-78."""
    seeds = []
    for _ in range(n):
        rng, step_rng = jax.random.split(rng)
        seeds.append(int(jax.random.randint(step_rng, (), 0, 1 << 24)))
    return seeds


def _round_bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)


def _bf16_bits(a) -> np.ndarray:
    return np.asarray(a, ml_dtypes.bfloat16).view(np.uint16).astype(np.int32)


@pytest.mark.parametrize("name", ["lr", "deepfm", "ipnn", "opnn"])
def test_forward_matches_jax(schema, name):
    """From JAX's initial parameters, perturbed so that no leaf is zero
    (LR starts at zero; FM's linear column and the biases too), with a
    nonzero pad row: only the mask keeps pad slots out."""
    jmodel, model = _models(schema, name, dropout=0.5)
    params = jmodel.init_params(jax.random.PRNGKey(1), schema)
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0.0, 0.1, np.shape(a)).astype(np.float32),
        params)
    ids = synthetic.generate(schema, num_examples=100, k=K, seed=4).ids
    assert (ids == schema.pad_id).any()
    want = np.asarray(apply_model(jmodel, jax.tree_util.tree_map(jnp.asarray, params),
                                  jnp.asarray(ids), schema.pad_id))
    model.load_state_dict(t_ckpt.params_from_jax(params["table"], params["dense"]))
    with torch.no_grad():
        got = t_models.apply_model(model, torch.from_numpy(ids).long(), schema.pad_id)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def _trajectory(schema, data, name, opt, table_dtype, dropout=0.0):
    """Three steps: loss and logits per step, then the table, the
    accumulator and the dense parameters. A bf16 table may differ by one
    bf16 ulp where f32 sums taken in another order round to the other
    neighbour: at most 2% of the elements.

    Adagrad's step ``-lr g / (|g| + eps)`` on an element whose summed
    gradient came within 10 eps of zero (a nearly cancelling f32 sum, as
    FM's linear weights, which start at zero, can get) carries that sum's
    relative error, about 1e-3 there, times ``eps / (|g| + eps)``: those
    elements of an f32 table are held to ``lr x 1e-3``.

    SGD on a bf16 table: the port sums a row's duplicates in f32 and rounds
    once, on write; the reference adds each gathered occurrence in bf16
    (ROADMAP.md section 3). So for that case the JAX side runs its f32 step
    on the bf16-rounded table and rounds the table after each step, as
    tests/test_torch_train.py does."""
    jsopt, jdopt, tsopt, tdopt = _optimizers(opt)
    jmodel, model = _models(schema, name, dropout)
    round_after_step = opt == "sgd" and table_dtype == "bf16"
    jstate = j_init_state(jmodel, schema, jsopt, jdopt, seed=0,
                          table_dtype="f32" if round_after_step else table_dtype)
    if round_after_step:
        jstate = jstate._replace(table=_round_bf16(jstate.table))
    jstep = j_make_train_step(jmodel, schema, jsopt, jdopt, l2=L2)
    state = t_init_state(model, schema, tsopt, tdopt, seed=0, table_dtype=table_dtype)
    model.load_state_dict(t_ckpt.params_from_jax(_f32(jstate.table), jstate.dense))
    tstep = t_make_train_step(schema, tsopt, tdopt, l2=L2)
    seeds = _jax_seeds(jstate.rng, 3)
    near_eps = np.zeros(model.table.shape, bool)

    for i, seed in enumerate(seeds):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        ids, labels = data.ids[sl], data.labels[sl]
        weights = np.ones(BATCH, np.float32)
        jstate, jm = jstep(jstate, jnp.asarray(ids), jnp.asarray(labels),
                           jnp.asarray(weights), 0.9)
        if round_after_step:
            jstate = jstate._replace(table=_round_bf16(jstate.table))
        acc = state.sparse_state.acc.clone() if opt == "adagrad" else None
        state, tm = tstep(state, ids, labels, weights, 0.9, seed=seed)
        np.testing.assert_allclose(tm.logits.numpy(), np.asarray(jm.logits),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=RTOL, atol=ATOL)
        if acc is not None:
            g2 = (state.sparse_state.acc - acc).numpy()   # squared summed gradient
            near_eps |= (g2 > 0) & (g2 < (10 * ADAGRAD_EPS) ** 2)

    got_table = state.table.detach().float().numpy()
    want_table = _f32(jstate.table)
    assert np.all(got_table[schema.pad_id] == 0.0)
    if table_dtype == "f32":
        far = ~near_eps
        np.testing.assert_allclose(got_table[far], want_table[far], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got_table[near_eps], want_table[near_eps], rtol=0,
                                   atol=SPARSE_LR * 1e-3)
    else:
        assert state.table.dtype == torch.bfloat16
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
@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_fm_trajectory_matches_jax(schema, data, opt, table_dtype):
    _trajectory(schema, data, "fm", opt, table_dtype)


@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
def test_deepfm_trajectory_matches_jax(schema, data, table_dtype):
    """At dropout 0.5: the JAX step's seeds go to the port's step."""
    _trajectory(schema, data, "deepfm", "adagrad", table_dtype, dropout=0.5)


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_lr_trajectory_matches_jax(schema, data, opt):
    _trajectory(schema, data, "lr", opt, "f32")


@pytest.mark.parametrize("name", ["ipnn", "opnn"])
def test_pnn_trajectory_matches_jax(schema, data, name):
    _trajectory(schema, data, name, "adagrad", "f32")


@pytest.mark.parametrize("name,cls,in_dim", [
    ("lr", "LRModel", None), ("fm", "FMModel", None), ("fnn", "FNNModel", 16),
    ("deepfm", "DeepFMModel", 16), ("pnn", "PNNModel", 16 + 6),
    ("ipnn", "PNNModel", 16 + 6), ("opnn", "PNNModel", 16 + 4),
    ("snn", "SNNModel", 200),
])
def test_build_model_builds_the_family(schema, name, cls, in_dim):
    """The reference's names; the towers' input widths at F = 4 fields of
    1 + k = 4 (IPNN adds F(F-1)/2 = 6 inner products, OPNN one D-vector);
    SNN's table and tower input are ``model.hidden1`` wide."""
    cfg = t_cli.RunConfig().apply_overrides([f"model.name={name}", f"model.k={K}"])
    model = t_cli.build_model(cfg, schema, "cpu")
    assert type(model).__name__ == cls
    width = {"lr": 1, "snn": cfg.model.hidden1}.get(name, 1 + K)
    assert model.table.shape == (schema.padded_vocab_size, width)
    if in_dim is not None:
        assert model.mlp.layers[0].w.shape[0] == in_dim
    if cls == "PNNModel":
        assert model.name == ("pnn_outer" if name == "opnn" else "pnn_inner")


@pytest.mark.parametrize("name,error", [("dcn", ValueError),
                                        ("xgboost", ValueError)])
def test_build_model_raises(schema, name, error):
    """Every model of the reference's family is built; any other name is
    the reference's error."""
    cfg = t_cli.RunConfig().apply_overrides([f"model.name={name}"])
    with pytest.raises(error, match="unknown model"):
        t_cli.build_model(cfg, schema, "cpu")


def _write_schema(schema, tmp_path):
    path = tmp_path / "schema.json"
    path.write_text(schema.to_json())
    return str(path)


@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
def test_fm_then_fnn_pipeline(schema, tmp_path, capsys, table_dtype):
    """The CLI's FM run writes ``<checkpoint>.fm_table`` (its trained table),
    and an FNN run with ``model.init_from`` starts from it: the same table
    the reference's ``init_fnn_from_fm`` gives for an f32 file, cast to the
    configured dtype."""
    schema_path = _write_schema(schema, tmp_path)
    ckpt = str(tmp_path / "fm.ckpt")
    common = [f"data.schema_path={schema_path}", "data.synthetic_examples=600",
              f"model.k={K}", f"train.batch_size={BATCH}",
              f"train.table_dtype={table_dtype}"]
    fm = t_cli.run(t_cli.RunConfig().apply_overrides(
        common + ["model.name=fm", "train.epochs=1", f"train.checkpoint_path={ckpt}"]),
        torch.device("cpu"))
    assert t_ckpt.read_manifest(ckpt)["model"] == "fm"
    fm_table = t_ckpt.load_fm_embeddings(ckpt + ".fm_table")
    np.testing.assert_array_equal(fm_table, fm["state"].table.float().numpy())
    assert t_ckpt.read_manifest(ckpt + ".fm_table")["bf16_leaves"] == (
        [0] if table_dtype == "bf16" else [])

    fnn = t_cli.run(t_cli.RunConfig().apply_overrides(
        common + ["model.name=fnn", "model.hidden=8", "train.epochs=0",
                  f"model.init_from={ckpt}.fm_table"]), torch.device("cpu"))
    capsys.readouterr()
    got = fnn["state"].table
    assert got.dtype == (torch.bfloat16 if table_dtype == "bf16" else torch.float32)
    np.testing.assert_array_equal(got.float().numpy(), fm_table)
    if table_dtype == "f32":
        jstate = j_init_state(j_cli.build_model(
            t_cli.RunConfig().apply_overrides(["model.name=fnn", f"model.k={K}",
                                               "model.hidden=8"]), schema),
            schema, j_sparse.SparseAdagrad(0.05), optax.adagrad(0.02))
        want = j_ckpt.init_fnn_from_fm({"table": jstate.table, "dense": jstate.dense},
                                       j_ckpt.load_fm_embeddings(ckpt + ".fm_table"))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want["table"]))


@pytest.mark.parametrize("name", ["fm", "deepfm"])
def test_init_from_is_for_fnn_only(schema, tmp_path, capsys, name):
    """A config that carries ``model.init_from`` leaves any model but FNN as
    ``init_state`` drew it (the reference's cli.py:275), even where an FM
    table of the same shape is at hand."""
    path = str(tmp_path / "fm.fm_table")
    t_ckpt.save_fm_embeddings(path, np.full((schema.padded_vocab_size, 1 + K), 0.5,
                                            np.float32))
    cfg = t_cli.RunConfig().apply_overrides([
        f"data.schema_path={_write_schema(schema, tmp_path)}",
        "data.synthetic_examples=300", f"model.name={name}", f"model.k={K}",
        "model.hidden=8", "train.epochs=0", f"model.init_from={path}"])
    state = t_cli.run(cfg, torch.device("cpu"))["state"]
    capsys.readouterr()
    fresh = t_cli.build_model(cfg, schema, "cpu")
    fresh.init_parameters(torch.Generator().manual_seed(cfg.train.seed), schema.pad_id)
    assert torch.equal(state.table, fresh.table)


@pytest.mark.parametrize("name", ["lr", "fm", "deepfm", "ipnn", "opnn"])
def test_both_packages_score_a_port_checkpoint(schema, tmp_path, capsys, name):
    """A port training run's checkpoint (bf16 table) through both packages'
    ``--score``: the printed probabilities agree to the printed digits."""
    ckpt = str(tmp_path / f"{name}.ckpt")
    common = [f"model.name={name}", f"model.k={K}", "model.hidden=16,8",
              "model.activation=relu", f"train.checkpoint_path={ckpt}",
              f"train.batch_size={BATCH}"]
    train = common + [f"data.schema_path={_write_schema(schema, tmp_path)}",
                      "data.synthetic_examples=600", "train.epochs=1",
                      "train.table_dtype=bf16"]
    assert t_cli.main(train + ["--device", "cpu"]) == 0
    manifest = t_ckpt.read_manifest(ckpt)
    assert manifest["model"] == name and manifest["bf16_leaves"] == [1]

    yx = str(tmp_path / "requests.yx")
    synthetic.write_yx_file(synthetic.generate(schema, num_examples=150, k=K, seed=6), yx)
    capsys.readouterr()
    score = ["--score", yx] + common + ["model.use_pallas=true"]
    assert j_cli.main(score) == 0
    want = capsys.readouterr().out.split()
    assert t_cli.main(score + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.split()
    assert len(got) == len(want) == 150
    np.testing.assert_allclose(np.array(got, np.float64), np.array(want, np.float64),
                               rtol=0, atol=PRINT_ATOL)
