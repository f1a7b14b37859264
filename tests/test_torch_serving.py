"""The serving slice as a whole: the port's Scorer and ``cli --score``
against the JAX package's, and checkpoints in both directions."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from deepctr_torch import cli as t_cli
from deepctr_torch.models import MlpSpec as TMlpSpec
from deepctr_torch.models import make_fnn as t_make_fnn
from deepctr_torch.serving import Scorer as TScorer
from deepctr_torch.utils.checkpoint import (
    params_from_jax,
    params_to_jax,
    save_scoring_params,
)
from deepctr_tpu import cli as j_cli
from deepctr_tpu.data import make_schema, synthetic
from deepctr_tpu.models import MlpSpec, make_fnn
from deepctr_tpu.optim import SparseAdagrad
from deepctr_tpu.serving import Scorer
from deepctr_tpu.train import init_state
from deepctr_tpu.utils.checkpoint import load_scoring_params, save_train_state

# f32 on both sides; only the summation order differs
RTOL, ATOL = 1e-4, 1e-5
# --score prints 6 decimals; a last-ulp difference in a logit can move a
# probability across a rounding boundary, which is one unit of the last digit
PRINT_ATOL = 1.01e-6
K = 3
HIDDEN = (16, 8)
BATCH = 64
ROWS = 150          # two full batches of 64 and a partial one


@pytest.fixture(scope="module")
def schema():
    return make_schema([("a", 4), ("b", 8), ("c", 16), ("tags", 10, 3)])


@pytest.fixture(scope="module")
def ids(schema):
    return synthetic.generate(schema, num_examples=ROWS, k=K, seed=5).ids


def _params(schema, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(0.0, 0.5, (schema.padded_vocab_size, 1 + K)).astype(np.float32)
    table[schema.pad_id] = 0.0
    dims = (schema.num_fields * (1 + K),) + HIDDEN + (1,)
    layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        lim = np.sqrt(6.0 / (d_in + d_out))
        layers.append({
            "w": rng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32),
            "b": rng.normal(0.0, 0.1, d_out).astype(np.float32),
        })
    return table, {"mlp": {"layers": layers}}


def _jax_model(schema):
    return make_fnn(schema, k=K, mlp=MlpSpec(hidden=HIDDEN, activation="tanh",
                                             dropout=0.5), use_pallas=True)


def _port_model(schema):
    return t_make_fnn(schema, k=K, mlp=TMlpSpec(hidden=HIDDEN, activation="tanh"),
                      device="cpu")


def test_scorer_matches_jax(schema, ids):
    table, dense = _params(schema)
    want = Scorer(model=_jax_model(schema), schema=schema, table=table,
                  dense=dense, batch_size=BATCH)
    model = _port_model(schema)
    model.load_state_dict(params_from_jax(table, dense))
    got = TScorer(model, schema, batch_size=BATCH)
    np.testing.assert_allclose(got.logits(ids), want.logits(ids), rtol=RTOL, atol=ATOL)
    p = got.predict(ids)
    assert p.shape == (ROWS,) and p.dtype == np.float32
    np.testing.assert_allclose(p, want.predict(ids), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
def test_jax_checkpoint_scores_like_jax(schema, ids, table_dtype, tmp_path, capsys):
    jmodel = _jax_model(schema)
    state = init_state(jmodel, schema, SparseAdagrad(0.1), optax.adagrad(0.05),
                       seed=0, table_dtype=table_dtype)
    table, dense = _params(schema)    # larger than init's N(0, 0.01) table
    state = state._replace(
        table=jnp.asarray(table).astype(state.table.dtype),
        dense=jax.tree_util.tree_map(jnp.asarray, dense),
    )
    ckpt = str(tmp_path / "fnn.ckpt")
    save_train_state(ckpt, state, epoch=1, meta={"model": "fnn"}, schema=schema)

    want = Scorer.from_checkpoint(ckpt, jmodel, batch_size=BATCH)
    got = TScorer.from_checkpoint(ckpt, _port_model(schema), batch_size=BATCH)
    np.testing.assert_allclose(got.logits(ids), want.logits(ids), rtol=RTOL, atol=ATOL)

    yx = str(tmp_path / "requests.yx")
    synthetic.write_yx_file(synthetic.generate(schema, num_examples=ROWS, k=K,
                                               seed=6), yx)
    argv = ["--score", yx, f"train.checkpoint_path={ckpt}", "model.name=fnn",
            f"model.k={K}", "model.hidden=" + ",".join(map(str, HIDDEN)),
            "model.use_pallas=true", f"train.batch_size={BATCH}"]
    capsys.readouterr()
    assert j_cli.main(argv) == 0
    want_out = capsys.readouterr().out.split()
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    got_out = capsys.readouterr().out.split()
    assert len(got_out) == len(want_out) == ROWS
    assert all(len(s) == 8 for s in got_out)      # "0.xxxxxx", as JAX prints
    np.testing.assert_allclose(np.array(got_out, np.float64),
                               np.array(want_out, np.float64),
                               rtol=0, atol=PRINT_ATOL)


def test_port_checkpoint_loads_in_jax(schema, ids, tmp_path):
    table, dense = _params(schema, seed=1)
    model = _port_model(schema)
    model.load_state_dict(params_from_jax(table, dense))
    ckpt = str(tmp_path / "port.ckpt")
    save_scoring_params(ckpt, *params_to_jax(model), schema=schema,
                        meta={"model": "fnn"})

    jmodel = _jax_model(schema)
    dense_like = jmodel.init_params(jax.random.PRNGKey(0), schema)["dense"]
    jtable, jdense = load_scoring_params(ckpt, dense_like)
    np.testing.assert_array_equal(np.asarray(jtable), table)
    for a, b in zip(jax.tree_util.tree_leaves(jdense),
                    jax.tree_util.tree_leaves(dense), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)

    want = Scorer.from_checkpoint(ckpt, jmodel, batch_size=BATCH).logits(ids)
    got = TScorer.from_checkpoint(ckpt, _port_model(schema), batch_size=BATCH)
    np.testing.assert_allclose(got.logits(ids), want, rtol=RTOL, atol=ATOL)


def test_from_checkpoint_rejects_other_schema(schema, tmp_path):
    table, dense = _params(schema)
    ckpt = str(tmp_path / "port.ckpt")
    save_scoring_params(ckpt, table, dense, schema=schema)
    other = make_schema([("a", 4), ("b", 8), ("c", 17), ("tags", 10, 3)])
    with pytest.raises(ValueError, match="schema mismatch"):
        TScorer.from_checkpoint(ckpt, _port_model(other), other)
