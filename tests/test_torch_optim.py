"""The port's sparse and dense optimizers against the JAX package and optax.

Same numpy inputs on both sides: occurrence ids with duplicates and pad
ids, gradient rows zero on pad slots (as the models make them), three
updates, f32 and bf16 tables.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from deepctr_torch.ops import scatter as t_scatter
from deepctr_torch.optim import dense as t_dense
from deepctr_torch.optim import sparse as t_sparse
from deepctr_tpu.ops import scatter as j_scatter
from deepctr_tpu.optim import sparse as j_sparse

# f32 on both sides; the duplicate sums are taken in another order
RTOL, ATOL = 1e-5, 1e-6
V, D, PAD = 40, 5, 39


def _bf16_bits(a) -> np.ndarray:
    return np.asarray(a, ml_dtypes.bfloat16).view(np.uint16).astype(np.int32)


def _occurrences(seed, m=120):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 12, m).astype(np.int32)     # many duplicates
    ids[rng.random(m) < 0.2] = PAD
    rows = rng.normal(0.0, 0.3, (m, D)).astype(np.float32)
    rows[ids == PAD] = 0.0
    return ids, rows


def _table(seed):
    table = np.random.default_rng(seed).normal(0.0, 0.1, (V, D)).astype(np.float32)
    table[PAD] = 0.0
    return table


def test_dedupe_grads_matches_jax():
    ids, rows = _occurrences(0)
    want = j_scatter.dedupe_grads(jnp.asarray(ids), jnp.asarray(rows))
    got = t_scatter.dedupe_grads(torch.from_numpy(ids), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.is_last.numpy(), np.asarray(want.is_last))
    np.testing.assert_allclose(got.rows.numpy(), np.asarray(want.rows),
                               rtol=RTOL, atol=ATOL)
    # each distinct id's total sits on its last occurrence
    for i in np.unique(ids):
        np.testing.assert_allclose(got.rows.numpy()[got.ids.numpy() == i].sum(0),
                                   rows[ids == i].sum(0), rtol=RTOL, atol=ATOL)


def test_scatter_totals_matches_jax_scatter_add():
    """The dense-mode scratch: the reference's ``zeros.at[ids].add(rows)``."""
    ids, rows = _occurrences(4)
    want = jnp.zeros((V, D)).at[jnp.asarray(ids)].add(jnp.asarray(rows))
    got = t_scatter.scatter_totals(V, torch.from_numpy(ids), torch.from_numpy(rows))
    assert got.shape == (V, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert not got[torch.from_numpy(np.setdiff1d(np.arange(V), ids))].any()


def test_scatter_totals_is_the_exact_sum_rounded_once():
    """The fixed-point prefix sum is exact: every total is the f64 sum of
    its rows rounded once to f32, so no summation order can change it."""
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 300, (20000,), generator=g)
    ids[::5] = 7                                    # a heavy hitter
    rows = torch.randn(20000, 3, generator=g) * 1e-3
    got = t_scatter.scatter_totals(300, ids, rows)
    want = torch.zeros(300, 3, dtype=torch.float64).index_add_(0, ids, rows.double())
    torch.testing.assert_close(got, want.float(), rtol=1.2e-7, atol=1e-15)
    perm = torch.randperm(20000, generator=g)
    assert torch.equal(t_scatter.scatter_totals(300, ids[perm], rows[perm]), got)


def test_scatter_add_dedup_matches_jax():
    ids, rows = _occurrences(1)
    table = _table(2)
    want = j_scatter.scatter_add_dedup(jnp.asarray(table), jnp.asarray(ids),
                                       jnp.asarray(rows))
    got = t_scatter.scatter_add_dedup(torch.from_numpy(table), torch.from_numpy(ids),
                                      torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("opt", ["sgd", "adagrad-dense", "adagrad-sorted"])
def test_sparse_optimizer_matches_jax(opt, table_dtype):
    """Three updates. f32: within f32 summation-order noise. bf16: the
    tables agree bit for bit except where a duplicate sum taken in another
    order lands the f32 value on the other side of a bf16 rounding
    boundary: at most 2% of the elements, each at most one bf16 ulp away.
    The pad row stays exactly 0.

    SGD on a bf16 table: the port sums a row's duplicates in f32 and rounds
    once, on write; the reference's scatter adds each occurrence in bf16,
    one rounding per duplicate in an order of its choosing. So for that case
    the JAX side updates the f32 copy of the bf16 table and rounds it to
    bf16 after each update."""
    name, _, mode = opt.partition("-")
    round_after_update = name == "sgd" and table_dtype == "bf16"
    lr_scale = 0.8
    if name == "sgd":
        jopt, topt = j_sparse.SparseSgd(0.1), t_sparse.SparseSgd(0.1)
    else:
        jopt = j_sparse.SparseAdagrad(0.1, mode=mode)
        topt = t_sparse.SparseAdagrad(0.1, mode=mode)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if table_dtype == "bf16"
                else (jnp.float32, torch.float32))
    table = _table(3)
    jtable = jnp.asarray(table).astype(jdt)
    if round_after_update:
        jtable = jtable.astype(jnp.float32)
    ttable = torch.from_numpy(table).to(tdt)
    jstate, tstate = jopt.init(jtable), topt.init(ttable)
    for step in range(3):
        ids, rows = _occurrences(10 + step)
        jtable, jstate = jopt.update(jtable, jstate, jnp.asarray(ids),
                                     jnp.asarray(rows), lr_scale=lr_scale)
        if round_after_update:
            jtable = jtable.astype(jnp.bfloat16).astype(jnp.float32)
        ttable, tstate = topt.update(ttable, tstate, torch.from_numpy(ids),
                                     torch.from_numpy(rows), lr_scale=lr_scale)
    got = ttable.float().numpy()
    want = np.asarray(jtable).astype(np.float32)
    assert np.all(got[PAD] == 0.0)
    if table_dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        ulps = np.abs(_bf16_bits(got) - _bf16_bits(want))
        assert ulps.max() <= 1 and (ulps > 0).mean() <= 0.02, (ulps.max(), (ulps > 0).mean())
    if name == "adagrad":
        np.testing.assert_allclose(tstate.acc.numpy(), np.asarray(jstate.acc),
                                   rtol=RTOL, atol=ATOL)
        assert tstate.acc.dtype == torch.float32


def test_sparse_auto_mode_picks_by_table_size(monkeypatch):
    table = torch.zeros(V, D)
    assert t_sparse._pick_dense("auto", table)
    monkeypatch.setattr(t_sparse, "_DENSE_AUTO_LIMIT", V * D - 1)
    assert not t_sparse._pick_dense("auto", table)
    assert t_sparse._pick_dense("dense", table)
    assert not t_sparse._pick_dense("sorted", table)
    with pytest.raises(ValueError):
        t_sparse._pick_dense("fast", table)


@pytest.mark.parametrize("name", ["sgd", "adagrad"])
def test_dense_optimizer_matches_optax(name):
    """Five steps with ``lr_scale``, applied as the JAX train step applies
    optax's updates: scale, then ``x lr_scale``, then add."""
    rng = np.random.default_rng(5)
    shapes = [(6, 4), (4,), (4, 1), (1,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jopt = getattr(optax, name)(0.05)
    topt = t_dense.make_dense_optimizer(name, 0.05)
    jparams = [jnp.asarray(p) for p in params]
    tparams = [torch.from_numpy(p.copy()) for p in params]
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for step in range(5):
        lr_scale = 0.9**step
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        updates, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate, jparams)
        updates = [u * lr_scale for u in updates]
        jparams = optax.apply_updates(jparams, updates)
        tstate = topt.update(tparams, [torch.from_numpy(g) for g in grads], tstate,
                             lr_scale=lr_scale)
    for t, j in zip(tparams, jparams, strict=True):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


def test_dense_adagrad_is_not_torch_adagrad():
    """optax's accumulator starts at 0.1: the first step of lr 1 on g = 1 is
    1/sqrt(1.1 + 1e-7), where torch.optim.Adagrad would take 1."""
    p = torch.zeros(1)
    opt = t_dense.Adagrad(1.0)
    opt.update([p], [torch.ones(1)], opt.init([p]))
    np.testing.assert_allclose(p.numpy(), [-1 / np.sqrt(1.1 + 1e-7)], rtol=1e-6)


def test_unknown_dense_optimizer_raises():
    """The reference's error type for a name optax does not have; the port
    takes three names."""
    with pytest.raises(ValueError, match="sgd | adagrad | adam"):
        t_dense.make_dense_optimizer("rmsprop", 0.1)
    assert isinstance(t_dense.make_dense_optimizer("adam", 0.1), t_dense.Adam)


@pytest.mark.parametrize("lr_scale", [1.0, 0.7])
def test_dense_adam_matches_optax(lr_scale):
    """Five steps of ``Adam`` against ``optax.adam``, the update scaled by
    ``lr_scale`` before it is added, as the train step does; gradients that
    shrink by 10x a step bring ``sqrt(nu_hat)`` down towards ``eps``."""
    rng = np.random.default_rng(5)
    shapes = [(6, 4), (4,), (4, 1), (1,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jopt, topt = optax.adam(0.01), t_dense.Adam(0.01)
    jparams = [jnp.asarray(p) for p in params]
    tparams = [torch.from_numpy(p.copy()) for p in params]
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for i in range(5):
        grads = [(rng.normal(size=s) * 10.0 ** -i).astype(np.float32) for s in shapes]
        updates, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, [u * lr_scale for u in updates])
        tstate = topt.update(tparams, [torch.from_numpy(g) for g in grads], tstate,
                             lr_scale=lr_scale)
    assert tstate.count.dtype == torch.int32 and int(tstate.count) == 5
    assert int(jstate[0].count) == 5
    for t, j in zip(tparams, jparams, strict=True):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
    for t, j in zip(tstate.mu + tstate.nu, jstate[0].mu + jstate[0].nu, strict=True):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-12)
