"""The serving slice as a whole: the port's Scorer and ``cli --score``
against the JAX package's, and checkpoints in both directions."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

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


# ---------------------------------------------------------------------------
# The quantised scorer (bf16, int8) against the JAX package's
# ---------------------------------------------------------------------------

# tests/test_serving.py:73: a quantised table's AUC against f32's
AUC_BAND = 0.01
# the int8 logits: both packages dequantise to the same rows and run the
# tower in f32, summing in other orders
INT8_ATOL = 1e-5


@pytest.fixture(scope="module")
def trained(schema):
    """An FM trained by the JAX package (``tests/test_serving.py``'s
    fixture), its held-out rows and labels."""
    from deepctr_tpu.models import FMModel
    from deepctr_tpu.train import fit

    ds = synthetic.generate(schema, num_examples=4096, k=3, noise=0.3, seed=1)
    res = fit(FMModel(k=4), schema, ds.ids[:3000], ds.labels[:3000], ds.ids[3000:],
              ds.labels[3000:], sparse_opt=SparseAdagrad(0.1),
              dense_opt=optax.adagrad(0.05), batch_size=256, epochs=4, prefetch=False)
    table = np.asarray(res.state.table, np.float32)
    dense = jax.tree_util.tree_map(np.asarray, res.state.dense)
    return table, dense, ds.ids[3000:], ds.labels[3000:]


def _fm_scorers(schema, trained, quantize):
    from deepctr_tpu.models import FMModel

    from deepctr_torch.models import make_fm as t_make_fm

    table, dense, _, _ = trained
    want = Scorer(model=FMModel(k=4), schema=schema, table=table, dense=dense,
                  batch_size=512, quantize=quantize)
    model = t_make_fm(schema, k=4, device="cpu")
    model.load_state_dict(params_from_jax(table, dense))
    return TScorer(model, schema, batch_size=512, quantize=quantize), want


def _jax_int8_rows(scorer, d):
    """The JAX scorer's int8 table unpacked from its 32-bit words: the int8
    payload and the f32 row scale, dequantised."""
    packed = np.asarray(scorer._table).view(np.int8).reshape(scorer._table.shape[0], -1)
    pad = -(d + 4) % 4
    scale = packed[:, d + pad:].copy().view(np.float32)
    return packed[:, :d].astype(np.float32) * scale


@pytest.mark.parametrize("quantize", ["bf16", "int8"])
def test_quantized_scorer_matches_jax(schema, trained, quantize):
    from deepctr_tpu.utils.metrics import exact_auc

    got, want = _fm_scorers(schema, trained, quantize)
    _, _, ids, labels = trained
    rtol, atol = (0.0, INT8_ATOL) if quantize == "int8" else (RTOL, ATOL)
    np.testing.assert_allclose(got.logits(ids), want.logits(ids), rtol=rtol, atol=atol)
    f32, _ = _fm_scorers(schema, trained, None)
    auc, auc_f32 = (exact_auc(labels, s.predict(ids)) for s in (got, f32))
    assert auc > 0.6 and abs(auc - auc_f32) < AUC_BAND, (auc, auc_f32)


def test_int8_rows_are_the_jax_scorers_bit_for_bit(schema, trained):
    got, want = _fm_scorers(schema, trained, "int8")
    table = trained[0]
    rows = got.rows(torch.arange(table.shape[0])).numpy()
    np.testing.assert_array_equal(rows, _jax_int8_rows(want, table.shape[1]))
    scale = np.maximum(np.abs(table).max(axis=1), 1e-12) / 127.0
    np.testing.assert_array_equal(got._scale.numpy(), scale.astype(np.float32))
    assert np.abs(rows - table).max() <= scale.max() * 0.5 + 1e-7


@pytest.mark.parametrize("quantize,row_bytes", [(None, lambda d: 4 * d),
                                                ("bf16", lambda d: 2 * d),
                                                ("int8", lambda d: d + 4)],
                         ids=["f32", "bf16", "int8"])
def test_quantized_table_bytes_and_the_f32_table_released(schema, trained, quantize,
                                                          row_bytes):
    scorer, _ = _fm_scorers(schema, trained, quantize)
    v, d = trained[0].shape
    assert scorer.table_bytes == v * row_bytes(d)
    assert scorer.model.table.numel() == (v * d if quantize is None else 0)


def test_quantized_scorer_from_a_jax_checkpoint(schema, ids, tmp_path):
    """``from_checkpoint(..., quantize="int8")`` on a train state the JAX
    package wrote scores as the JAX scorer does with the same quantisation."""
    jmodel = _jax_model(schema)
    state = init_state(jmodel, schema, SparseAdagrad(0.1), optax.adagrad(0.05), seed=0)
    table, dense = _params(schema)
    state = state._replace(table=jnp.asarray(table),
                           dense=jax.tree_util.tree_map(jnp.asarray, dense))
    ckpt = str(tmp_path / "fnn.ckpt")
    save_train_state(ckpt, state, epoch=1, meta={"model": "fnn"}, schema=schema)
    want = Scorer.from_checkpoint(ckpt, jmodel, batch_size=BATCH, quantize="int8")
    got = TScorer.from_checkpoint(ckpt, _port_model(schema), batch_size=BATCH,
                                  quantize="int8")
    np.testing.assert_allclose(got.logits(ids), want.logits(ids), rtol=0.0,
                               atol=INT8_ATOL)
    with pytest.raises(ValueError, match="quantize"):
        TScorer(_port_model(schema), schema, quantize="int4")
