"""The port's row-sharded training (``deepctr_torch/parallel``) against the
JAX package's ``deepctr_tpu/parallel``.

Pure functions (layout, bucketing, the volume accounting) are held to
their JAX originals on seeded inputs. Then one launch of two gloo ranks
(``tests/test_torch_ranks.py``) runs every multi-rank case from the JAX
package's initial values, and each test below holds its part against the
JAX package's sharded step on a two-device mesh (or its single-device
step), with the tolerances of ``tests/test_parallel.py``. A world of one,
in this process, must give the single-device step's bits.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepctr_torch import parallel as par
from deepctr_torch.data import Schema as TSchema
from deepctr_torch.data import make_schema as t_make_schema
from deepctr_torch.models import MlpSpec as TMlpSpec
from deepctr_torch.models import make_fm as t_make_fm
from deepctr_torch.models import make_fnn as t_make_fnn
from deepctr_torch.optim import SparseAdagrad as TSparseAdagrad
from deepctr_torch.optim import make_dense_optimizer
from deepctr_torch.train import init_state as t_init_state
from deepctr_torch.train import make_eval_step as t_make_eval_step
from deepctr_torch.train import make_scan_train_step as t_make_scan_train_step
from deepctr_torch.train import make_train_step as t_make_train_step
from deepctr_torch.utils.checkpoint import params_from_jax
from deepctr_tpu.data import ipinyou_full_schema, ipinyou_like_schema
from deepctr_tpu.models import FMModel, LRModel, MlpSpec, make_fnn
from deepctr_tpu.optim import SparseAdagrad, SparseSgd
from deepctr_tpu.parallel import comm as j_comm
from deepctr_tpu.parallel import (
    init_sharded_state,
    make_data_mesh,
    make_dp_train_step,
    make_sharded_eval_step,
    make_sharded_scan_train_step,
    make_sharded_train_step,
    replicate_state,
    shard_batch_arrays,
    unpack_table,
)
from deepctr_tpu.parallel import pack_table as j_pack_table
from deepctr_tpu.parallel.sharded import _bucket_by_owner
from deepctr_tpu.train.step import init_state, make_train_step
from test_torch_ranks import launch

# tests/test_parallel.py's tolerances: trajectories, eval, the bf16 table
# (same rounding points, summed in other orders), and the bf16 wire, whose
# per-element rounding Adagrad's first step amplifies on near-zero rows
RTOL, ATOL = 1e-4, 1e-5
EVAL_TOL = 2e-5
SCAN_K = 4          # steps a chunk of the scan cases: 6 real steps, 2 pad
BF16_LOSS = (1e-3, 1e-4)
BF16_TABLE = (1e-2, 1e-3)
WIRE = (0.05, 0.025)
B = 64
N = 2


@pytest.fixture(scope="module")
def schema():
    from deepctr_tpu.data import make_schema

    return make_schema([("a", 4), ("b", 8), ("c", 16), ("tags", 10, 3)])


@pytest.fixture(scope="module")
def data(schema):
    from deepctr_tpu.data import synthetic

    return synthetic.generate(schema, num_examples=4096, k=3, noise=0.3, seed=1)


@pytest.fixture(scope="module")
def mesh():
    return make_data_mesh(N)


# ---------------------------------------------------------------------------
# Pure functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("vp", [7, 8, 16, 33])
def test_pack_unpack_bit_equal_to_jax(n, vp):
    logical = np.random.default_rng(vp * 10 + n).normal(size=(vp, 3)).astype(np.float32)
    want = np.asarray(j_pack_table(jnp.asarray(logical), n))
    got = par.pack_table(torch.from_numpy(logical), n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(par.unpack_table(got, vp, n).numpy(), logical)
    shards = want.reshape(n, -1, 3)
    for r in range(n):
        np.testing.assert_array_equal(
            par.sharded.local_shard(torch.from_numpy(logical), n, r).numpy(), shards[r])


@pytest.mark.parametrize("n,m,cf", [(2, 64, 2.0), (3, 100, 1.25), (8, 192, 2.0),
                                    (4, 96, 0.25), (2, 192, 0.05)],
                         ids=["n2", "n3", "n8", "starved", "all-one-owner"])
def test_bucket_by_owner_equals_jax(n, m, cf):
    rng = np.random.default_rng(m + n)
    ids = rng.integers(0, 40, m).astype(np.int32)
    if cf < 0.1:
        ids[:] = 0      # every occurrence to one owner: most are dropped
    cap = par.exchange_capacity(m, n, cf)
    sentinel = par.shard_rows(40, n)
    want = _bucket_by_owner(jnp.asarray(ids), n, sentinel, cap)
    got = par.bucket_by_owner(torch.from_numpy(ids), n, sentinel, cap)
    for field in ("send", "order", "owner_s", "rank", "dropped"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    if cf < 1.0:
        assert int(got.dropped) > 0


def test_exchange_capacity_and_comm_volume_equal_jax():
    for m in (0, 1, 7, 64, 8192 * 2, 8192 * 18):
        for n in (1, 2, 4, 8):
            for cf in (0.5, 1.0, 2.0, 8.0):
                assert par.exchange_capacity(m, n, cf) == j_comm.exchange_capacity(m, n, cf)
    for schema in (ipinyou_like_schema(), ipinyou_full_schema()):
        for n, batch, cf, d, wire in [(2, 4096, 2.0, 11, 4), (8, 8192, 1.25, 17, 2),
                                      (4, 1024, 4.0, 200, 4), (1, 8192, 2.0, 11, 4)]:
            want = j_comm.comm_volume(schema, batch, n, cf, split=None,
                                      dense_param_bytes=123_456, row_dim=d,
                                      exchange_bytes=wire)
            got = par.comm_volume(schema, batch, n, cf, dense_param_bytes=123_456,
                                  row_dim=d, exchange_bytes=wire)
            for field in ("n_devices", "batch_per_device", "capacity", "ids_a2a",
                          "rows_a2a_fwd", "rows_a2a_bwd", "dense_psum", "a2a_wire",
                          "psum_wire", "total_wire", "bytes_per_example"):
                assert getattr(got, field) == getattr(want, field), field


def test_dense_param_bytes_equals_jax():
    schema = ipinyou_full_schema()
    want = j_comm.dense_param_bytes(
        make_fnn(schema, k=10, mlp=MlpSpec(hidden=(200, 300, 100))), schema)
    got = par.dense_param_bytes(t_make_fnn(
        TSchema.from_json(schema.to_json()), k=10,
        mlp=TMlpSpec(hidden=(200, 300, 100)), device="cpu"))
    assert got == want


# ---------------------------------------------------------------------------
# A world of one in this process: the single-device step's bits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model_name,mode", [("fnn", "dense"), ("fnn", "sorted"),
                                             ("fm", "dense")])
def test_world_one_step_is_the_single_device_step(model_name, mode, data):
    schema = t_make_schema([("a", 4), ("b", 8), ("c", 16), ("tags", 10, 3)])
    if model_name == "fnn":
        model = t_make_fnn(schema, k=3, mlp=TMlpSpec(hidden=(16, 8), dropout=0.5),
                           device="cpu")
    else:
        model = t_make_fm(schema, k=3, device="cpu")
    sopt, dopt = TSparseAdagrad(0.1, mode=mode), make_dense_optimizer("adagrad", 0.05)
    state = t_init_state(model, schema, sopt, dopt, seed=3, table_dtype="bf16")
    w = np.ones(B, np.float32)
    with par.process_group("cpu") as group:
        sst = par.sharded_state_from_state(state.clone(), group)
        step1 = t_make_train_step(schema, sopt, dopt, l2=1e-3)
        step_n = par.make_sharded_train_step(schema, sopt, dopt, group, l2=1e-3)
        for i in range(3):
            ids, y = data.ids[i * B:(i + 1) * B], data.labels[i * B:(i + 1) * B]
            state, m1 = step1(state, ids, y, w)
            sst, (loss, dropped) = step_n(sst, ids, y, w)
            assert torch.equal(m1.loss, loss) and int(dropped) == 0
        host = par.host_state_from_sharded(sst, group)
        eval_n = par.make_sharded_eval_step(schema, group)(sst.model, data.ids[:100])
    assert torch.equal(host.table, state.table)
    assert torch.equal(host.sparse_state.acc, state.sparse_state.acc)
    assert all(torch.equal(p, q) for p, q in zip(host.model.parameters(),
                                                 state.model.parameters()))
    assert torch.equal(eval_n, t_make_eval_step(schema)(state.model, data.ids[:100]))


@pytest.mark.parametrize("model_name,mode,dense", [("fnn", "dense", "adam"),
                                                   ("fm", "sorted", "adagrad")])
def test_world_one_scan_step_is_the_single_device_scan_step(model_name, mode, dense,
                                                            data):
    """In a world of one the sharded scan step gives the single-device
    scan step's bits: two chunks of 4, the second with 2 weight-0 pad
    steps; FNN with dropout 0.5 and Adam (the pad steps draw seeds and move
    Adam's moments), and FM with the sorted-mode Adagrad."""
    schema = t_make_schema([("a", 4), ("b", 8), ("c", 16), ("tags", 10, 3)])
    if model_name == "fnn":
        model = t_make_fnn(schema, k=3, mlp=TMlpSpec(hidden=(16, 8), dropout=0.5),
                           device="cpu")
    else:
        model = t_make_fm(schema, k=3, device="cpu")
    sopt, dopt = TSparseAdagrad(0.1, mode=mode), make_dense_optimizer(dense, 0.05)
    state = t_init_state(model, schema, sopt, dopt, seed=3, table_dtype="bf16")
    chunks = _chunks(data, schema, 6)
    scan1 = t_make_scan_train_step(schema, sopt, dopt, l2=1e-3)
    with par.process_group("cpu") as group:
        sst = par.sharded_state_from_state(state.clone(), group)
        scan_n = par.make_sharded_scan_train_step(schema, sopt, dopt, group, l2=1e-3)
        for chunk in zip(*chunks):
            state, losses1 = scan1(state, *chunk)
            sst, m = scan_n(sst, *chunk)
            assert torch.equal(m.losses, losses1)
            assert m.dropped.tolist() == [0] * SCAN_K
        host = par.host_state_from_sharded(sst, group)
    assert host.step == state.step == 8
    assert torch.equal(host.generator.get_state(), state.generator.get_state())
    # table, accumulator, dense parameters and the dense optimizer's state
    assert all(torch.equal(a, b) for a, b in zip(
        par.sharded.state_tensors(host), par.sharded.state_tensors(state), strict=True))


def test_num_devices_must_equal_the_world_size():
    with pytest.raises(ValueError, match="torchrun --standalone --nproc_per_node=2"):
        with par.process_group("cpu", num_devices=2):
            pass


# ---------------------------------------------------------------------------
# Two gloo ranks against the JAX package
# ---------------------------------------------------------------------------


def _batches(data, steps, start=0):
    ids = np.stack([data.ids[start + i * B:start + (i + 1) * B] for i in range(steps)])
    labels = np.stack([data.labels[start + i * B:start + (i + 1) * B]
                       for i in range(steps)])
    return ids, labels


def _jax_run(model, schema, sopt, dopt, batches, *, mesh=None, seed=3, cf=8.0,
             exchange_dtype="f32", scales=None, table_dtype="f32", dp=False):
    """The JAX package's trajectory: sharded on ``mesh``, data-parallel
    with ``dp``, else single-device. Returns the initial (table, dense) and
    the losses, drops, final table (f32) and dense."""
    ids, labels = batches
    scales = scales or [1.0] * len(ids)
    w = np.ones(ids.shape[1], np.float32)
    if mesh is not None and not dp:
        st = init_sharded_state(model, schema, sopt, dopt, mesh, seed=seed,
                                table_dtype=table_dtype)
        vp = schema.padded_vocab_size
        init = (np.asarray(unpack_table(st.table, vp, N), np.float32),
                jax.tree_util.tree_map(np.asarray, st.dense))
        step = make_sharded_train_step(model, schema, sopt, dopt, mesh,
                                       capacity_factor=cf, exchange_dtype=exchange_dtype)
        losses, drops = [], []
        for i, s in zip(range(len(ids)), scales):
            st, (loss, dropped) = step(st, *shard_batch_arrays(mesh, ids[i], labels[i], w),
                                       s)
            losses.append(float(loss))
            drops.append(int(dropped))
        table = np.asarray(unpack_table(st.table, vp, N), np.float32)
        return init, losses, drops, table, jax.tree_util.tree_map(np.asarray, st.dense)
    st = init_state(model, schema, sopt, dopt, seed=seed, table_dtype=table_dtype)
    init = (np.asarray(st.table, np.float32), jax.tree_util.tree_map(np.asarray, st.dense))
    if dp:
        st = replicate_state(st, mesh)
        step = make_dp_train_step(model, schema, sopt, dopt, mesh)
    else:
        step = make_train_step(model, schema, sopt, dopt, jit=False)
    losses = []
    for i, s in zip(range(len(ids)), scales):
        args = (st, jnp.asarray(ids[i]), jnp.asarray(labels[i]), jnp.asarray(w))
        st, m = step(*args) if dp else step(*args, s)
        losses.append(float(m.loss))
    return (init, losses, [0] * len(ids), np.asarray(st.table, np.float32),
            jax.tree_util.tree_map(np.asarray, st.dense))


def _chunks(data, schema, steps, k=SCAN_K):
    """``steps`` batches cut into chunks of ``k`` steps, the last padded to
    ``k`` with weight-0 steps of pad ids (the reference's scan route):
    ids ``[C, k, B, S]``, labels and weights ``[C, k, B]``."""
    ids, labels = _batches(data, steps)
    pad = -steps % k
    ids = np.concatenate([ids, np.full((pad,) + ids.shape[1:], schema.pad_id, np.int32)])
    labels = np.concatenate([labels, np.zeros((pad, B), np.float32)])
    weights = np.concatenate([np.ones((steps, B), np.float32),
                              np.zeros((pad, B), np.float32)])
    return tuple(a.reshape((-1, k) + a.shape[1:]) for a in (ids, labels, weights))


def _jax_scan_run(model, schema, sopt, dopt, chunks, mesh, seed=3, cf=8.0):
    """The JAX package's sharded scan route over ``chunks``: the initial
    (table, dense), every step's loss and drop count, the final step,
    table and dense."""
    from jax.sharding import NamedSharding, PartitionSpec

    st = init_sharded_state(model, schema, sopt, dopt, mesh, seed=seed)
    vp = schema.padded_vocab_size
    init = (np.asarray(unpack_table(st.table, vp, N), np.float32),
            jax.tree_util.tree_map(np.asarray, st.dense))
    scan = make_sharded_scan_train_step(model, schema, sopt, dopt, mesh,
                                        capacity_factor=cf)
    shd = NamedSharding(mesh, PartitionSpec(None, "data"))
    losses, drops = [], []
    for chunk in zip(*chunks):
        st, (loss, dropped) = scan(st, *(jax.device_put(a, shd) for a in chunk))
        losses += np.asarray(loss).tolist()
        drops += np.asarray(dropped).tolist()
    return (init, losses, drops, int(st.step),
            np.asarray(unpack_table(st.table, vp, N), np.float32),
            jax.tree_util.tree_map(np.asarray, st.dense))


def _case(inputs, name, cfg, init, batches=None, **extra):
    inputs[f"{name}/config"] = np.array(json.dumps(cfg))
    table, dense = init
    for key, t in params_from_jax(table, dense).items():
        inputs[f"{name}/init/{key}"] = t.numpy()
    if batches is not None:
        inputs[f"{name}/ids"], inputs[f"{name}/labels"] = batches
    inputs.update({f"{name}/{k}": v for k, v in extra.items()})


@pytest.fixture(scope="module")
def ranks(schema, data, mesh, tmp_path_factory):
    """Every multi-rank case in one launch of two ranks, and the JAX
    package's results for each."""
    sj = schema.to_json()
    inputs, ref = {}, {}
    fm_cfg = {"case": "trajectory", "schema": sj, "model": "fm", "k": 3,
              "sparse_lr": 0.1, "dense": "sgd", "dense_lr": 0.05, "capacity_factor": 8.0}
    five = _batches(data, 5)
    for opt in ("sgd", "adagrad"):
        sopt = SparseSgd(0.1) if opt == "sgd" else SparseAdagrad(0.1)
        ref[f"fm_{opt}"] = _jax_run(FMModel(k=3), schema, sopt, optax.sgd(0.05), five,
                                    mesh=mesh)
        ref[f"fm_{opt}_single"] = _jax_run(FMModel(k=3), schema, sopt, optax.sgd(0.05),
                                           five)
        _case(inputs, f"fm_{opt}", dict(fm_cfg, sparse=opt), ref[f"fm_{opt}"][0], five)

    zeros = (np.zeros((1, B, schema.num_slots), np.int32), np.ones((1, B), np.float32))
    ref["drops"] = _jax_run(LRModel(), schema, SparseSgd(0.1), optax.sgd(0.05), zeros,
                            mesh=mesh, seed=0, cf=0.05)
    _case(inputs, "drops", dict(fm_cfg, model="lr", sparse="sgd", capacity_factor=0.05),
          ref["drops"][0], zeros)

    model = FMModel(k=3)
    params = model.init_params(jax.random.PRNGKey(0), schema)
    stored = jax.device_put(j_pack_table(params["table"], N),
                            jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data")))
    (ids_d,) = shard_batch_arrays(mesh, data.ids[:B])
    ref["eval"] = np.asarray(make_sharded_eval_step(model, schema, mesh, capacity_factor=8.0)(
        stored, params["dense"], ids_d))
    _case(inputs, "eval", dict(fm_cfg, case="eval", sparse="sgd"),
          (np.asarray(params["table"]), params["dense"]), ids=data.ids[:B])

    three = _batches(data, 3)
    scales = [1.0, 0.5, 0.25]
    ref["lr_scale"] = _jax_run(FMModel(k=3), schema, SparseAdagrad(0.1), optax.sgd(0.05),
                               three, scales=scales)
    _case(inputs, "lr_scale", dict(fm_cfg, sparse="adagrad", lr_scales=scales),
          ref["lr_scale"][0], three)

    four = _batches(data, 4)
    fnn = make_fnn(schema, k=3, mlp=MlpSpec(hidden=(16,), dropout=0.0))
    ref["bf16_table"] = _jax_run(fnn, schema, SparseAdagrad(0.1), optax.sgd(0.05), four,
                                 mesh=mesh, table_dtype="bf16")
    _case(inputs, "bf16_table", dict(fm_cfg, model="fnn", hidden=[16], sparse="adagrad",
                                     table_dtype="bf16"), ref["bf16_table"][0], four)

    for wire in ("f32", "bf16"):
        ref[f"wire_{wire}"] = _jax_run(FMModel(k=3), schema, SparseAdagrad(0.1),
                                       optax.sgd(0.05), four, mesh=mesh,
                                       exchange_dtype=wire)
    _case(inputs, "wire_bf16", dict(fm_cfg, sparse="adagrad", exchange_dtype="bf16"),
          ref["wire_bf16"][0], four)

    ref["dp"] = _jax_run(FMModel(k=3), schema, SparseAdagrad(0.1), optax.sgd(0.05), four,
                         mesh=mesh, dp=True)
    _case(inputs, "dp", dict(fm_cfg, sparse="adagrad", dp=True), ref["dp"][0], four)

    st = init_state(FMModel(k=3), schema, SparseAdagrad(0.1), optax.adagrad(0.05), seed=11)
    ref["roundtrip"] = (np.asarray(st.table), np.asarray(st.sparse_state.acc))
    _case(inputs, "roundtrip", dict(fm_cfg, case="roundtrip", sparse="adagrad",
                                    dense="adagrad"),
          (np.asarray(st.table), jax.tree_util.tree_map(np.asarray, st.dense)))

    fnn_drop = make_fnn(schema, k=3, mlp=MlpSpec(hidden=(32, 16), dropout=0.5))
    p = fnn_drop.init_params(jax.random.PRNGKey(7), schema)
    _case(inputs, "repeat", dict(fm_cfg, case="repeat", model="fnn", hidden=[32, 16],
                                 dropout=0.5, sparse="adagrad"),
          (np.asarray(p["table"]), p["dense"]), _batches(data, 2))

    chunks = _chunks(data, schema, 6)
    scan_cases = {
        "scan_fm": (FMModel(k=3), optax.adagrad(0.05), 8.0,
                    dict(fm_cfg, sparse="adagrad", dense="adagrad")),
        "scan_fnn_adam": (make_fnn(schema, k=3, mlp=MlpSpec(hidden=(16,), dropout=0.0)),
                          optax.adam(0.01), 8.0,
                          dict(fm_cfg, model="fnn", hidden=[16], sparse="adagrad",
                               dense="adam", dense_lr=0.01)),
        "scan_starved": (FMModel(k=3), optax.sgd(0.05), 1.0,
                         dict(fm_cfg, sparse="adagrad", capacity_factor=1.0)),
    }
    for name, (model, dopt, cf, cfg) in scan_cases.items():
        ref[name] = _jax_scan_run(model, schema, SparseAdagrad(0.1), dopt, chunks,
                                  mesh, cf=cf)
        _case(inputs, name, dict(cfg, case="scan"), ref[name][0], ids=chunks[0],
              labels=chunks[1], weights=chunks[2])

    out = launch(inputs, str(tmp_path_factory.mktemp("ranks")))
    return out, ref


def _assert_dense(out, name, dense, rtol=RTOL, atol=ATOL):
    want = {k: v.numpy() for k, v in params_from_jax(np.zeros((1, 1)), dense).items()
            if k != "table"}
    for key, w in want.items():
        np.testing.assert_allclose(out[f"{name}/dense/{key}"], w, rtol=rtol, atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
@pytest.mark.parametrize("against", ["sharded", "single"])
def test_two_ranks_fm_trajectory_matches_jax(ranks, opt, against):
    out, ref = ranks
    name = f"fm_{opt}"
    _, losses, drops, table, dense = ref[name if against == "sharded" else f"{name}_single"]
    r0 = out[0]
    np.testing.assert_allclose(r0[f"{name}/losses"], losses, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(r0[f"{name}/table"], table, rtol=RTOL, atol=ATOL)
    _assert_dense(r0, name, dense)
    np.testing.assert_array_equal(out[1][f"{name}/losses"], r0[f"{name}/losses"])
    assert list(r0[f"{name}/dropped"]) == [0] * len(losses)


def test_two_ranks_count_the_drops_jax_counts(ranks):
    out, ref = ranks
    _, losses, drops, _, _ = ref["drops"]
    assert drops[0] > 0
    assert list(out[0]["drops/dropped"]) == drops == list(out[1]["drops/dropped"])
    assert np.isfinite(out[0]["drops/losses"]).all()


def test_two_ranks_eval_matches_jax(ranks):
    out, ref = ranks
    got = np.concatenate([out[0]["eval/logits"], out[1]["eval/logits"]])
    np.testing.assert_allclose(got, ref["eval"], rtol=EVAL_TOL, atol=EVAL_TOL)


def test_two_ranks_lr_scale_matches_jax(ranks):
    out, ref = ranks
    np.testing.assert_allclose(out[0]["lr_scale/table"], ref["lr_scale"][3],
                               rtol=RTOL, atol=ATOL)


def test_two_ranks_bf16_table_matches_jax(ranks):
    out, ref = ranks
    _, losses, drops, table, dense = ref["bf16_table"]
    np.testing.assert_allclose(out[0]["bf16_table/losses"], losses, rtol=BF16_LOSS[0],
                               atol=BF16_LOSS[1])
    np.testing.assert_allclose(out[0]["bf16_table/table"], table, rtol=BF16_TABLE[0],
                               atol=BF16_TABLE[1])
    assert out[0]["bf16_table/sparse_0"].dtype == np.float32   # the accumulator


def test_two_ranks_bf16_wire_matches_jax(ranks):
    out, ref = ranks
    got = out[0]["wire_bf16/table"]
    np.testing.assert_allclose(got, ref["wire_bf16"][3], rtol=WIRE[0], atol=WIRE[1])
    np.testing.assert_allclose(got, ref["wire_f32"][3], rtol=WIRE[0], atol=WIRE[1])
    assert not np.array_equal(got, ref["wire_f32"][3])
    assert np.isfinite(out[0]["wire_bf16/losses"]).all()


def test_two_ranks_dp_step_matches_jax(ranks):
    out, ref = ranks
    _, losses, _, table, dense = ref["dp"]
    for r in (0, 1):
        np.testing.assert_allclose(out[r]["dp/losses"], losses, rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(out[r]["dp/table"], table, rtol=RTOL, atol=ATOL)
        _assert_dense(out[r], "dp", dense)
    np.testing.assert_array_equal(out[0]["dp/table"], out[1]["dp/table"])


def test_two_ranks_state_round_trip(ranks):
    out, ref = ranks
    table, acc = ref["roundtrip"]
    assert bool(out[0]["roundtrip/same"])
    for name, logical in (("shard", table + 7.0), ("acc_shard", acc + 3.0)):
        stored = np.asarray(j_pack_table(jnp.asarray(logical), N)).reshape(N, -1, logical.shape[1])
        for r in (0, 1):
            np.testing.assert_array_equal(out[r][f"roundtrip/{name}"], stored[r])


def test_two_ranks_fnn_dropout_is_repeatable_and_finite(ranks):
    out, _ = ranks
    for r in (0, 1):
        assert bool(out[r]["repeat/repeat_equal"])
        assert bool(out[r]["repeat/differs_from_no_dropout"])
        assert bool(out[r]["repeat/finite"])


@pytest.mark.parametrize("name", ["scan_fm", "scan_fnn_adam", "scan_starved"])
def test_two_ranks_scan_route_matches_jax(ranks, name):
    """Two chunks of 4 steps, the second padded with 2 weight-0 steps,
    through the sharded scan step on two gloo ranks against the JAX
    package's ``make_sharded_scan_train_step`` on two devices: every
    step's loss, its drop count exactly (pads included: under the starved
    cap an all-pad step sends every occurrence to the pad id's owner), the
    step count, the table and the dense parameters (Adam's pad steps move
    them)."""
    out, ref = ranks
    _, losses, drops, step, table, dense = ref[name]
    r0 = out[0]
    assert int(r0[f"{name}/step"]) == step == 8
    assert list(r0[f"{name}/dropped"]) == drops == list(out[1][f"{name}/dropped"])
    assert (sum(drops) > 0) == (name == "scan_starved")
    if name == "scan_starved":
        assert drops[-1] > 0   # the pad step's drops count
    np.testing.assert_allclose(r0[f"{name}/losses"], losses, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(out[1][f"{name}/losses"], r0[f"{name}/losses"])
    np.testing.assert_allclose(r0[f"{name}/table"], table, rtol=RTOL, atol=ATOL)
    _assert_dense(r0, name, dense)


def test_ranks_load_no_jax(ranks):
    out, _ = ranks
    for r in (0, 1):
        assert list(out[r]["modules/loaded"]) == []
