"""The port's FNN against the JAX FNN, and the JAX <-> port parameter converter.

A tiny schema with a 3-slot field, so the slot->field pooling sums slots
and pad slots are masked. JAX runs its tower both through the fused kernel
in interpret mode (``use_pallas=True``) and as plain jnp; the port, given
CPU tensors, runs the tower's plain version either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepctr_torch.models import MlpSpec as TMlpSpec
from deepctr_torch.models import apply_model as t_apply_model
from deepctr_torch.models import make_fnn as t_make_fnn
from deepctr_torch.models import base as t_base
from deepctr_torch.ops.kernels.mlp import mlp_tower_plain
from deepctr_torch.utils.checkpoint import (
    dense_structure,
    jax_leaves,
    params_from_jax,
    params_to_jax,
)
from deepctr_tpu.data import make_schema, synthetic
from deepctr_tpu.models import MlpSpec, apply_model, make_fnn

# f32 on both sides; only the summation order differs
RTOL, ATOL = 1e-4, 1e-5
K = 3
HIDDEN = (16, 8)


@pytest.fixture(scope="module")
def schema():
    return make_schema([("a", 4), ("b", 8), ("c", 16), ("tags", 10, 3)])


def _jax_params(schema, seed=0):
    rng = np.random.default_rng(seed)
    # the pad row is left nonzero, so only the mask keeps pad slots out
    table = rng.normal(0.0, 0.5, (schema.padded_vocab_size, 1 + K)).astype(np.float32)
    dims = (schema.num_fields * (1 + K),) + HIDDEN + (1,)
    layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        lim = np.sqrt(6.0 / (d_in + d_out))
        layers.append({
            "w": rng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32),
            "b": rng.normal(0.0, 0.1, d_out).astype(np.float32),
        })
    return table, {"mlp": {"layers": layers}}


def _ids(schema, n=100):
    ids = synthetic.generate(schema, num_examples=n, k=K, seed=4).ids
    assert (ids == schema.pad_id).any()   # pad slots in the multi-slot field
    return ids


@pytest.mark.parametrize("use_pallas", [True, False])
def test_fnn_apply_rows_matches_jax(schema, use_pallas):
    table, dense = _jax_params(schema)
    ids = _ids(schema)
    rows = table[ids]
    mask = (ids != schema.pad_id).astype(np.float32)
    jmodel = make_fnn(schema, k=K, mlp=MlpSpec(hidden=HIDDEN, activation="tanh",
                                               dropout=0.5),
                      use_pallas=use_pallas)
    want = np.asarray(jmodel.apply_rows(jax.tree_util.tree_map(jnp.asarray, dense),
                                        jnp.asarray(rows), jnp.asarray(mask),
                                        train=False))

    model = t_make_fnn(schema, k=K, mlp=TMlpSpec(hidden=HIDDEN, activation="tanh"),
                       device="cpu")
    model.load_state_dict(params_from_jax(table, dense))
    with torch.no_grad():
        got = model.apply_rows(torch.from_numpy(rows), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    full = np.asarray(apply_model(jmodel, {"table": jnp.asarray(table),
                                           "dense": dense}, jnp.asarray(ids),
                                  schema.pad_id))
    with torch.no_grad():
        got_full = t_apply_model(model, torch.from_numpy(ids).long(),
                                 schema.pad_id).numpy()
    np.testing.assert_allclose(got_full, full, rtol=RTOL, atol=ATOL)


def test_converter_round_trip_keeps_jax_leaf_order(schema):
    table, dense = _jax_params(schema, seed=1)
    jdense = make_fnn(schema, k=K, mlp=MlpSpec(hidden=HIDDEN)).init_params(
        jax.random.PRNGKey(0), schema)["dense"]
    # the hand-written flatten order is jax.tree_util's: layers[0].b first
    want_order = [np.asarray(a).shape for a in jax.tree_util.tree_leaves(jdense)]
    assert [a.shape for a in jax_leaves(dense)] == want_order
    assert want_order[:2] == [(HIDDEN[0],), (schema.num_fields * (1 + K), HIDDEN[0])]

    model = t_make_fnn(schema, k=K, mlp=TMlpSpec(hidden=HIDDEN), device="cpu")
    model.load_state_dict(params_from_jax(table, dense))
    table2, dense2 = params_to_jax(model)
    np.testing.assert_array_equal(table2, table)
    for a, b in zip(jax_leaves(dense2), jax_leaves(dense), strict=True):
        np.testing.assert_array_equal(a, b)


def test_dense_structure_is_the_jax_dense_tree(schema):
    jdense = make_fnn(schema, k=K, mlp=MlpSpec(hidden=HIDDEN)).init_params(
        jax.random.PRNGKey(0), schema)["dense"]
    model = t_make_fnn(schema, k=K, mlp=TMlpSpec(hidden=HIDDEN), device="cpu")
    structure = dense_structure(model)
    assert (jax.tree_util.tree_structure(structure)
            == jax.tree_util.tree_structure(jdense))
    assert jax_leaves(structure) == [0] * len(jax.tree_util.tree_leaves(jdense))


def test_tower_always_goes_through_the_kernel_wrapper(schema, monkeypatch):
    """No model-level switch picks the plain tower: every forward calls
    ``mlp_tower_fwd`` (through the tower module, ``models/base.py``), which
    alone decides by the tensor's device."""
    calls = []

    def spy(x, layers, activation):
        calls.append((tuple(x.shape), len(layers), activation))
        return mlp_tower_plain(x, layers, activation)

    monkeypatch.setattr(t_base, "mlp_tower_fwd", spy)
    table, dense = _jax_params(schema)
    model = t_make_fnn(schema, k=K, mlp=TMlpSpec(hidden=HIDDEN), device="cpu")
    model.load_state_dict(params_from_jax(table, dense))
    ids = torch.from_numpy(_ids(schema, n=10)).long()
    with torch.no_grad():
        t_apply_model(model, ids, schema.pad_id)
    assert calls == [((10, schema.num_fields * (1 + K)), len(HIDDEN) + 1, "tanh")]
