"""The port's SNN, its DAE and RBM pretrainers, the pretrain step and the
hand-off against the JAX package and the NumPy oracle.

All inputs and all noise are seeded numpy: the pretrainers draw Bernoulli
masks and negative samples, so the two packages are only comparable when both
take the same uniforms (``noise=``, ``u=``). Both run in f32 on the CPU; the
port's CPU tensors take the tower's plain version. The CUDA tower kernels at
SNN's width run only on a card: ``chip_smoke.py`` holds them to their plain
versions there.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepctr_torch import cli as t_cli
from deepctr_torch import models as t_models
from deepctr_torch.models import MlpSpec as TMlpSpec
from deepctr_torch.models import snn as t_snn
from deepctr_torch.optim import make_dense_optimizer
from deepctr_torch.optim import sparse as t_sparse
from deepctr_torch.train import fit as t_fit
from deepctr_torch.train import init_state as t_init_state
from deepctr_torch.train import make_pretrain_step as t_make_pretrain_step
from deepctr_torch.train import pretrain_snn as t_pretrain_snn
from deepctr_torch.utils import checkpoint as t_ckpt
from deepctr_tpu import cli as j_cli
from deepctr_tpu.data import synthetic
from deepctr_tpu.models import (
    DaePretrainer,
    MlpSpec,
    RbmPretrainer,
    SNNModel,
    apply_model,
    field_sampling,
)
from deepctr_tpu.models.snn import sample_negatives
from deepctr_tpu.optim import sparse as j_sparse
from deepctr_tpu.reference_impl import NumpyDae, NumpyRbm
from deepctr_tpu.train import init_state as j_init_state
from deepctr_tpu.train.step import make_pretrain_step as j_make_pretrain_step
from deepctr_tpu.utils import checkpoint as j_ckpt

# f32 on both sides, the same formulas; sums are taken in other orders
RTOL, ATOL = 1e-5, 1e-6
H1 = 8
M = 2
BATCH = 64
PRINT_ATOL = 1.01e-6  # --score prints 6 decimals (test_torch_serving.py)
CPU = torch.device("cpu")


def _pretrainers(kind):
    if kind == "dae":
        return DaePretrainer(m=M, corruption=0.3), t_snn.DaePretrainer(m=M, corruption=0.3)
    return RbmPretrainer(m=M), t_snn.RbmPretrainer(m=M)


def _noise(kind, rng, schema, batch=BATCH, h1=H1):
    u_neg = rng.random((batch, schema.num_fields, M))
    if kind == "dae":
        return {"u_keep": rng.random((batch, schema.num_slots)), "u_neg": u_neg}
    return {"u_neg": u_neg, "u_h0": rng.random((batch, h1))}


def _pretrain_params(schema, seed, scale=0.1):
    """A table (pad row zero), ``b1`` and ``vbias`` with no zero leaf."""
    rng = np.random.default_rng(seed)
    table = rng.normal(0.0, scale, (schema.padded_vocab_size, H1)).astype(np.float32)
    table[schema.pad_id] = 0.0
    b1 = rng.normal(0.0, scale, H1).astype(np.float32)
    vbias = rng.normal(0.0, scale, schema.padded_vocab_size).astype(np.float32)
    return table, b1, vbias


def _jnoise(noise):
    return {k: jnp.asarray(v) for k, v in noise.items()}


def test_sample_negatives_matches_jax(tiny_schema):
    """The same uniforms give the reference's ids exactly, at a field's
    edges too: u = 0, the largest f32 below 1, and f64 uniforms just below
    a multiple of 1/10 that land on it when cast to f32, as the reference
    casts them (in f64 they floor to the id below)."""
    rng = np.random.default_rng(0)
    fields = tiny_schema.num_fields
    u = rng.random((BATCH, fields, M))
    u[0] = 0.0
    u[1] = np.float32(1.0) - np.float32(2.0 ** -24)
    u[2] = (np.arange(1, 1 + fields * M).reshape(fields, M) % 3 + 1) / 10.0 * (1 - 1e-9)
    want = np.asarray(sample_negatives(None, field_sampling(tiny_schema), BATCH, M, u=u))
    fs = t_snn.field_sampling(tiny_schema, CPU)
    got = t_snn.sample_negatives(None, fs, BATCH, M, u=u)
    assert got.dtype == torch.int64 and got.shape == (BATCH, fields * M)
    np.testing.assert_array_equal(got.numpy(), want)
    offsets = np.asarray(tiny_schema.offsets)
    sizes = np.asarray([f.vocab_size for f in tiny_schema.fields])
    local = got.numpy().reshape(BATCH, fields, M) - offsets[None, :, None]
    assert (local >= 0).all() and (local < sizes[None, :, None]).all()


def test_sample_negatives_draws_from_the_generator(tiny_schema):
    fs = t_snn.field_sampling(tiny_schema, CPU)
    a = t_snn.sample_negatives(torch.Generator().manual_seed(5), fs, 512, M)
    b = t_snn.sample_negatives(torch.Generator().manual_seed(5), fs, 512, M)
    c = t_snn.sample_negatives(torch.Generator().manual_seed(6), fs, 512, M)
    assert torch.equal(a, b) and not torch.equal(a, c)
    offsets = np.asarray(tiny_schema.offsets)
    sizes = np.asarray([f.vocab_size for f in tiny_schema.fields])
    local = a.numpy().reshape(512, -1, M) - offsets[None, :, None]
    assert (local >= 0).all() and (local < sizes[None, :, None]).all()
    assert len(np.unique(local[:, 2])) == sizes[2]      # every id of field c drawn


@pytest.mark.parametrize("kind", ["dae", "rbm"])
def test_loss_and_grads_match_jax(tiny_schema, tiny_dataset, kind):
    """One ``loss_and_grads`` under matched noise: the loss, the occurrence
    ids in the reference's order (exactly), the occurrence gradients and the
    dense gradients (rtol 1e-5, atol 1e-6). Example 0's first negative is
    made its active unit, so one row occurs as positive and as candidate."""
    schema = tiny_schema
    jpre, tpre = _pretrainers(kind)
    table, b1, vbias = _pretrain_params(schema, seed=1)
    ids = tiny_dataset.ids[:BATCH]
    noise = _noise(kind, np.random.default_rng(2), schema)
    first = schema.fields[0]
    noise["u_neg"][0, 0, 0] = (ids[0, 0] - schema.offsets[0] + 0.5) / first.vocab_size

    want = jpre.loss_and_grads(
        jnp.asarray(table), {"b1": jnp.asarray(b1), "vbias": jnp.asarray(vbias)},
        jnp.asarray(ids), schema.pad_id, field_sampling(schema), None,
        noise=_jnoise(noise))
    got = tpre.loss_and_grads(
        torch.from_numpy(table), {"b1": torch.from_numpy(b1),
                                  "vbias": torch.from_numpy(vbias)},
        torch.from_numpy(ids).long(), schema.pad_id,
        t_snn.field_sampling(schema, CPU), None, noise=noise)

    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=RTOL, atol=ATOL)
    occ_ids = got[1].numpy()
    np.testing.assert_array_equal(occ_ids, np.asarray(want[1]))
    slots = schema.num_slots
    cand = occ_ids[-BATCH * (slots + schema.num_fields * M):].reshape(BATCH, -1)
    assert cand[0, slots] == ids[0, 0]            # the negative that is active
    assert got[2].shape == (occ_ids.shape[0], H1)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[3]["b1"].numpy(), np.asarray(want[3]["b1"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[3]["vbias_ids"].numpy(),
                                  np.asarray(want[3]["vbias_ids"]))
    np.testing.assert_allclose(got[3]["vbias_grads"].numpy(),
                               np.asarray(want[3]["vbias_grads"]), rtol=RTOL, atol=ATOL)
    # pad slots get no gradient, so the pad row stays frozen
    assert not got[2][got[1] == schema.pad_id].any()


def _sparse_opts(opt, mode="auto"):
    if opt == "sgd":
        return j_sparse.SparseSgd(0.1), t_sparse.SparseSgd(0.1)
    return j_sparse.SparseAdagrad(0.1), t_sparse.SparseAdagrad(0.1, mode=mode)


@pytest.mark.parametrize("opt,mode", [("sgd", "auto"), ("adagrad", "dense"),
                                      ("adagrad", "sorted")],
                         ids=["sgd", "adagrad-dense", "adagrad-sorted"])
@pytest.mark.parametrize("kind", ["dae", "rbm"])
def test_pretrain_step_trajectory_matches_jax(tiny_schema, tiny_dataset, kind, opt, mode):
    """Three ``make_pretrain_step(with_noise=True)`` steps from one state
    under matched noise: the table, Adagrad's accumulator, ``b1`` and
    ``vbias`` (rtol 1e-4, atol 1e-6: Adagrad's first steps divide a gradient
    by its own magnitude, which carries a gradient's last bits into the
    row). The real SNN table takes the sparse optimizer's sorted mode."""
    schema = tiny_schema
    jpre, tpre = _pretrainers(kind)
    jopt, topt = _sparse_opts(opt, mode)
    table, b1, vbias = _pretrain_params(schema, seed=3)
    jtable = jnp.asarray(table)
    jdense = {"b1": jnp.asarray(b1), "vbias": jnp.asarray(vbias)}
    jstate = jopt.init(jtable)
    ttable = torch.from_numpy(table.copy())
    tdense = {"b1": torch.from_numpy(b1.copy()), "vbias": torch.from_numpy(vbias.copy())}
    tstate = topt.init(ttable)
    jstep = j_make_pretrain_step(jpre, schema, jopt, dense_lr=0.1, with_noise=True)
    tstep = t_make_pretrain_step(tpre, schema, topt, dense_lr=0.1, with_noise=True)
    rng = jax.random.PRNGKey(0)   # consumed, overridden by the noise
    noise_rng = np.random.default_rng(4)
    for i in range(3):
        ids = tiny_dataset.ids[i * BATCH:(i + 1) * BATCH]
        noise = _noise(kind, noise_rng, schema)
        jtable, jstate, jdense, rng, jloss = jstep(jtable, jstate, jdense, rng,
                                                   jnp.asarray(ids), _jnoise(noise))
        ttable, tstate, tdense, _, tloss = tstep(ttable, tstate, tdense, None, ids, noise)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ttable.numpy(), np.asarray(jtable), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tdense["b1"].numpy(), np.asarray(jdense["b1"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tdense["vbias"].numpy(), np.asarray(jdense["vbias"]),
                               rtol=1e-4, atol=1e-6)
    if opt == "adagrad":
        np.testing.assert_allclose(tstate.acc.numpy(), np.asarray(jstate.acc),
                                   rtol=1e-4, atol=1e-9)
    assert not ttable[schema.pad_id].any()
    assert not np.array_equal(ttable.numpy(), table)


@pytest.mark.parametrize("kind", ["dae", "rbm"])
def test_matched_noise_matches_numpy_oracle(tiny_schema, tiny_dataset, kind):
    """25 SGD steps from the oracle's initial values under the oracle's
    uniforms: the same trajectory (atol 2e-5, the reference's own bound for
    its pretrainers against this oracle, tests/test_pretrain.py)."""
    schema, ds = tiny_schema, tiny_dataset
    lr = 0.1
    ref = (NumpyDae if kind == "dae" else NumpyRbm)(schema, hidden1=H1, m=M, lr=lr, seed=3)
    pre = t_snn.DaePretrainer(m=M) if kind == "dae" else t_snn.RbmPretrainer(m=M)
    table = torch.from_numpy(ref.table.copy())
    dense = {"b1": torch.from_numpy(ref.b1.copy()),
             "vbias": torch.from_numpy(ref.vbias.copy())}
    opt = t_sparse.SparseSgd(lr)
    state = opt.init(table)
    pstep = t_make_pretrain_step(pre, schema, opt, dense_lr=lr, with_noise=True)
    noise_rng = np.random.default_rng(77)
    for i in range(25):
        ids = ds.ids[np.random.default_rng(i).integers(0, ds.ids.shape[0], BATCH)]
        noise = _noise(kind, noise_rng, schema)
        want_loss = ref.train_batch(ids, noise=noise)
        table, state, dense, _, loss = pstep(table, state, dense, None, ids, noise)
        np.testing.assert_allclose(float(loss), want_loss, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(table.numpy(), ref.table, atol=2e-5)
    np.testing.assert_allclose(dense["b1"].numpy(), ref.b1, atol=2e-5)
    np.testing.assert_allclose(dense["vbias"].numpy(), ref.vbias, atol=2e-5)


def _run_pretrain_steps(pretrainer, schema, ids, steps, lr):
    generator = torch.Generator().manual_seed(0)
    table = torch.zeros(schema.padded_vocab_size, H1)
    t_models.base.init_table(table, generator, 0.01, schema.pad_id)
    dense = t_snn.init_pretrain_dense(schema, H1, CPU)
    opt = t_sparse.SparseSgd(lr)
    state = opt.init(table)
    pstep = t_make_pretrain_step(pretrainer, schema, opt, dense_lr=lr)
    losses = []
    for i in range(steps):
        sel = np.random.default_rng(i).integers(0, ids.shape[0], 128)
        table, state, dense, generator, loss = pstep(table, state, dense, generator,
                                                     ids[sel])
        losses.append(float(loss))
    return table, losses


def test_dae_pretrain_reduces_loss(tiny_schema, tiny_dataset):
    """With the port's own draws (a ``torch.Generator``), as the reference's
    test of the same name."""
    table, losses = _run_pretrain_steps(t_snn.DaePretrainer(m=2, corruption=0.3),
                                        tiny_schema, tiny_dataset.ids, steps=120, lr=0.3)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.95, losses
    assert not table[tiny_schema.pad_id].any()


def test_rbm_pretrain_reduces_reconstruction_error(tiny_schema, tiny_dataset):
    _, losses = _run_pretrain_steps(t_snn.RbmPretrainer(m=2), tiny_schema,
                                    tiny_dataset.ids, steps=40, lr=0.05)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def _snn_pair(schema, dropout=0.0, use_pallas=False):
    jmodel = SNNModel(hidden1=H1, mlp=MlpSpec(hidden=(16, 8), dropout=dropout),
                      use_pallas=use_pallas)
    model = t_models.make_snn(schema, hidden1=H1,
                              mlp=TMlpSpec(hidden=(16, 8), dropout=dropout), device="cpu")
    return jmodel, model


def _perturbed(jmodel, schema, seed):
    """JAX's initial parameters, perturbed so that no leaf is zero, the pad
    row too: only the mask keeps pad slots out."""
    params = jmodel.init_params(jax.random.PRNGKey(seed), schema)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0.0, 0.1, np.shape(a)).astype(np.float32),
        params)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_snn_forward_matches_jax(tiny_schema, use_pallas):
    """``SNNModel`` against the reference's ``apply_rows`` (its tower through
    the Pallas kernel in interpret mode too) from the same parameters,
    loaded with ``params_from_jax`` (rtol 1e-4, atol 1e-5: f32, other
    summation orders); ``params_to_jax`` gives them back exactly."""
    schema = tiny_schema
    jmodel, model = _snn_pair(schema, dropout=0.5, use_pallas=use_pallas)
    params = _perturbed(jmodel, schema, seed=1)
    ids = synthetic.generate(schema, num_examples=100, k=3, seed=4).ids
    assert (ids == schema.pad_id).any()
    want = np.asarray(apply_model(jmodel, jax.tree_util.tree_map(jnp.asarray, params),
                                  jnp.asarray(ids), schema.pad_id))
    model.load_state_dict(t_ckpt.params_from_jax(params["table"], params["dense"]))
    with torch.no_grad():
        got = t_models.apply_model(model, torch.from_numpy(ids).long(), schema.pad_id)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    table, dense = t_ckpt.params_to_jax(model)
    np.testing.assert_array_equal(table, params["table"])
    assert sorted(dense) == ["b1", "mlp"]
    np.testing.assert_array_equal(dense["b1"], params["dense"]["b1"])
    for got_l, want_l in zip(dense["mlp"]["layers"], params["dense"]["mlp"]["layers"]):
        np.testing.assert_array_equal(got_l["w"], want_l["w"])
        np.testing.assert_array_equal(got_l["b"], want_l["b"])


def test_snn_init_parameters(tiny_schema):
    """The reference's ``init_params`` in distribution: a normal table with
    ``init_sigma`` and a zero pad row, ``b1`` zero, a Glorot tower with zero
    biases; the same seed gives the same draws."""
    schema = tiny_schema
    model = t_models.make_snn(schema, hidden1=64, mlp=TMlpSpec(hidden=(16,)),
                              init_sigma=0.05, device="cpu")
    model.init_parameters(torch.Generator().manual_seed(3), schema.pad_id)
    assert model.table.shape == (schema.padded_vocab_size, 64)
    assert not model.table[schema.pad_id].any() and not model.b1.any()
    body = model.table.detach()[:schema.pad_id]
    assert abs(float(body.std()) - 0.05) < 0.005 and abs(float(body.mean())) < 0.005
    w = model.mlp.layers[0].w
    assert float(w.abs().max()) <= np.sqrt(6.0 / (64 + 16)) and not model.mlp.layers[0].b.any()
    again = t_models.make_snn(schema, hidden1=64, mlp=TMlpSpec(hidden=(16,)),
                              init_sigma=0.05, device="cpu")
    again.init_parameters(torch.Generator().manual_seed(3), schema.pad_id)
    assert torch.equal(model.table, again.table) and torch.equal(w, again.mlp.layers[0].w)


def test_snn_train_step_matches_jax(tiny_schema, tiny_dataset):
    """Three supervised steps of SNN (dropout 0.5, the reference's tower
    through its Pallas kernel in interpret mode, both sides fed the seeds
    the JAX step draws) from the same state: the table and ``b1`` (rtol
    1e-4, atol 1e-6)."""
    from deepctr_tpu.train import make_train_step as j_make_train_step
    from deepctr_torch.train import make_train_step as t_make_train_step

    schema = tiny_schema
    jmodel, model = _snn_pair(schema, dropout=0.5, use_pallas=True)
    jopt, topt = j_sparse.SparseSgd(0.1), t_sparse.SparseSgd(0.1)
    jstate = j_init_state(jmodel, schema, jopt, optax.sgd(0.05), seed=0)
    tstate = t_init_state(model, schema, topt, make_dense_optimizer("sgd", 0.05), seed=0)
    model.load_state_dict(t_ckpt.params_from_jax(np.asarray(jstate.table), jstate.dense))
    jstep = j_make_train_step(jmodel, schema, jopt, optax.sgd(0.05), jit=False)
    tstep = t_make_train_step(schema, topt, make_dense_optimizer("sgd", 0.05))
    ones = np.ones(BATCH, np.float32)
    for i in range(3):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        ids, labels = tiny_dataset.ids[sl], tiny_dataset.labels[sl]
        # the seed the JAX step will draw from its rng for the tower's mask
        _, sub = jax.random.split(jstate.rng)
        seed = int(jax.random.randint(sub, (), 0, 1 << 24))
        jstate, jm = jstep(jstate, jnp.asarray(ids), jnp.asarray(labels), jnp.asarray(ones))
        tstate, tm = tstep(tstate, ids, labels, ones, seed=seed)
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tstate.table.detach().numpy(), np.asarray(jstate.table),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(model.b1.detach().numpy(), np.asarray(jstate.dense["b1"]),
                               rtol=1e-4, atol=1e-6)


def test_pretrain_to_snn_handoff_and_finetune(tiny_schema, tiny_dataset):
    """The port's mirror of the reference's test of the same name: DAE
    pretraining, the hand-off, a short supervised run that learns."""
    ds = tiny_dataset
    h1 = 16
    table, b1 = t_pretrain_snn(
        t_snn.DaePretrainer(m=2, corruption=0.3), tiny_schema, h1, ds.ids[:2000],
        sparse_opt=t_sparse.SparseSgd(0.1), batch_size=256, epochs=2, device="cpu")
    assert table.shape == (tiny_schema.padded_vocab_size, h1) and b1.shape == (h1,)
    assert not table[tiny_schema.pad_id].any() and b1.any()
    model = t_models.make_snn(tiny_schema, hidden1=h1,
                              mlp=TMlpSpec(hidden=(16,), dropout=0.0), device="cpu")
    sopt = t_sparse.SparseAdagrad(0.1)
    dopt = make_dense_optimizer("adagrad", 0.05)
    st = t_init_state(model, tiny_schema, sopt, dopt)
    t_ckpt.init_snn_from_pretrain(model, table, b1)
    assert torch.equal(st.table, table) and torch.equal(model.b1, b1)
    res = t_fit(model, tiny_schema, ds.ids[:3000], ds.labels[:3000], ds.ids[3000:],
                ds.labels[3000:], sparse_opt=sopt, dense_opt=dopt, batch_size=256,
                epochs=6, state=st, early_stop_patience=6)
    assert res.best_auc > 0.62, res.history


def test_init_snn_from_pretrain_checks_the_shape(tiny_schema):
    """The reference's error for a table of another shape; a bf16 model
    table takes the pretrained f32 table rounded, as the FM -> FNN hand-off
    does."""
    model = t_models.make_snn(tiny_schema, hidden1=H1, mlp=TMlpSpec(hidden=(8,)),
                              device="cpu")
    with pytest.raises(ValueError, match="pretrained table .* != SNN table"):
        t_ckpt.init_snn_from_pretrain(model, np.zeros((3, H1), np.float32), np.zeros(H1))
    table, b1, _ = _pretrain_params(tiny_schema, seed=5)
    model.table.data = model.table.data.to(torch.bfloat16)
    t_ckpt.init_snn_from_pretrain(model, table, b1)
    assert model.table.dtype == torch.bfloat16
    assert torch.equal(model.table.data, torch.from_numpy(table).to(torch.bfloat16))
    np.testing.assert_array_equal(model.b1.detach().numpy(), b1)


def _write_schema(schema, tmp_path):
    path = tmp_path / "schema.json"
    path.write_text(schema.to_json())
    return str(path)


@pytest.mark.parametrize("pretrain", ["rbm", "dae"])
def test_cli_pretrains_and_both_packages_score_its_checkpoint(tiny_schema, tmp_path,
                                                              capsys, pretrain):
    """``deepctr_torch.cli`` with ``model.name=snn train.pretrain=...`` on
    the CPU: the pretrain record, the hand-off event and an epoch record are
    logged, the run starts from the pretrained table, and its checkpoint
    goes through both packages' ``--score`` to the printed digits."""
    ckpt = str(tmp_path / "snn.ckpt")
    common = ["model.name=snn", f"model.hidden1={H1}", "model.hidden=16,8",
              f"train.checkpoint_path={ckpt}", f"train.batch_size={BATCH}"]
    train = common + [f"data.schema_path={_write_schema(tiny_schema, tmp_path)}",
                      "data.synthetic_examples=800", "train.epochs=1",
                      f"train.pretrain={pretrain}", "train.pretrain_epochs=2",
                      "model.dropout=0.5"]
    assert t_cli.main(train + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    pre = [line for line in out if '"pretrain_loss"' in line]
    assert len(pre) == 2
    assert all(np.isfinite(json.loads(p)["pretrain_loss"]) for p in pre)
    assert sum('"init_from_pretrain"' in line and f'"{pretrain}"' in line
               for line in out) == 1
    assert sum('"auc"' in line for line in out) == 1
    manifest = t_ckpt.read_manifest(ckpt)
    assert manifest["model"] == "snn" and manifest["epoch"] == 1

    yx = str(tmp_path / "requests.yx")
    synthetic.write_yx_file(synthetic.generate(tiny_schema, num_examples=150, k=3,
                                               seed=6), yx)
    for use_pallas in ("true", "false"):
        score = ["--score", yx] + common + [f"model.use_pallas={use_pallas}"]
        assert j_cli.main(score) == 0
        want = capsys.readouterr().out.split()
        assert t_cli.main(score + ["--device", "cpu"]) == 0
        got = capsys.readouterr().out.split()
        assert len(got) == len(want) == 150
        np.testing.assert_allclose(np.array(got, np.float64), np.array(want, np.float64),
                                   rtol=0, atol=PRINT_ATOL)


def test_cli_starts_finetuning_from_the_pretrained_table(tiny_schema, tmp_path, capsys):
    """With ``train.epochs=0`` the state ``run`` returns is the hand-off's:
    the table ``pretrain_snn`` gives for the same seed, not ``init_state``'s
    draw; without ``train.pretrain`` it is that draw."""
    base = [f"data.schema_path={_write_schema(tiny_schema, tmp_path)}",
            "data.synthetic_examples=400", "model.name=snn", f"model.hidden1={H1}",
            "model.hidden=8", "train.epochs=0", f"train.batch_size={BATCH}"]
    cfg = t_cli.RunConfig().apply_overrides(base + ["train.pretrain=rbm"])
    state = t_cli.run(cfg, CPU)["state"]
    _, tr_ids, *_ = t_cli.load_data(cfg)
    sparse_opt, _ = t_cli.build_optimizers(cfg)
    table, b1 = t_pretrain_snn(t_snn.RbmPretrainer(m=cfg.train.pretrain_m), tiny_schema,
                               H1, tr_ids, sparse_opt=sparse_opt,
                               dense_lr=cfg.train.pretrain_lr, batch_size=BATCH,
                               epochs=1, seed=cfg.train.seed, device="cpu")
    assert torch.equal(state.table, table) and torch.equal(state.model.b1, b1)
    plain = t_cli.run(t_cli.RunConfig().apply_overrides(base), CPU)["state"]
    capsys.readouterr()
    fresh = t_cli.build_model(cfg, tiny_schema, "cpu")
    fresh.init_parameters(torch.Generator().manual_seed(cfg.train.seed),
                          tiny_schema.pad_id)
    assert torch.equal(plain.table, fresh.table)
    assert not torch.equal(plain.table, state.table)


@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
def test_jax_snn_checkpoint_scores_in_the_port(tiny_schema, tmp_path, capsys, table_dtype):
    """The reverse way: a train-state checkpoint written by the JAX package
    for its SNN through both packages' ``--score``."""
    schema = tiny_schema
    jmodel, _ = _snn_pair(schema)
    state = j_init_state(jmodel, schema, j_sparse.SparseAdagrad(0.1), optax.adagrad(0.05),
                         seed=0, table_dtype=table_dtype)
    params = _perturbed(jmodel, schema, seed=2)
    state = state._replace(
        table=jnp.asarray(params["table"]).astype(state.table.dtype),
        dense=jax.tree_util.tree_map(jnp.asarray, params["dense"]))
    ckpt = str(tmp_path / "jax_snn.ckpt")
    j_ckpt.save_train_state(ckpt, state, epoch=1, meta={"model": "snn"}, schema=schema)
    yx = str(tmp_path / "requests.yx")
    synthetic.write_yx_file(synthetic.generate(schema, num_examples=150, k=3, seed=6), yx)
    argv = ["--score", yx, f"train.checkpoint_path={ckpt}", "model.name=snn",
            f"model.hidden1={H1}", "model.hidden=16,8", f"train.batch_size={BATCH}"]
    capsys.readouterr()
    assert j_cli.main(argv) == 0
    want = capsys.readouterr().out.split()
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.split()
    assert len(got) == len(want) == 150
    np.testing.assert_allclose(np.array(got, np.float64), np.array(want, np.float64),
                               rtol=0, atol=PRINT_ATOL)


@pytest.mark.parametrize("override,error", [
    ("data.stream=true", ValueError),
    ("train.pretrain=cd2", ValueError),
])
def test_cli_snn_still_refuses(tiny_schema, tmp_path, override, error):
    """What the SNN route does not take: pretraining on streamed input (the
    reference's refusal) and an unknown pretrainer."""
    yx = str(tmp_path / "rows.yx")
    synthetic.write_yx_file(synthetic.generate(tiny_schema, num_examples=200, k=3,
                                               seed=2), yx)
    argv = [f"data.schema_path={_write_schema(tiny_schema, tmp_path)}",
            "data.synthetic_examples=200", "model.name=snn", f"model.hidden1={H1}",
            "model.hidden=8", "train.pretrain=dae", override, "--device", "cpu"]
    if override == "data.stream=true":
        argv[-2:-2] = [f"data.train_path={yx}", f"data.test_path={yx}"]
    with pytest.raises(error, match="SNN pretraining" if error is ValueError
                       and override.startswith("data") else None):
        t_cli.main(argv)


def test_cli_snn_dae_multichip_runs_distributed(tiny_schema, tmp_path, capsys):
    """``configs/snn_dae_multichip.json`` shrunk, with ``train.distributed``:
    DAE pretraining, the hand-off, then the sharded fine-tune in a world of
    one, which writes its shard file in place of a portable checkpoint and
    resumes from it without pretraining again."""
    import os

    ckpt = str(tmp_path / "snn.ckpt")
    metrics = tmp_path / "m.jsonl"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = ["--config", os.path.join(root, "configs", "snn_dae_multichip.json"),
            f"data.schema_path={_write_schema(tiny_schema, tmp_path)}",
            "data.synthetic_examples=600", f"model.hidden1={H1}", "model.hidden=8",
            f"train.batch_size={BATCH}", "train.distributed=true",
            f"train.checkpoint_path={ckpt}", f"train.metrics_path={metrics}"]
    assert t_cli.main(argv + ["train.epochs=1", "--device", "cpu"]) == 0
    assert t_cli.main(argv + ["train.epochs=2", "--device", "cpu"]) == 0
    capsys.readouterr()
    events = [json.loads(line) for line in metrics.read_text().splitlines()]
    kinds = [e.get("event") or ("pretrain" if "pretrain_loss" in e else "epoch")
             for e in events]
    assert kinds.count("init_from_pretrain") == kinds.count("pretrain") == 1
    assert kinds.count("epoch") == 2 and kinds.count("saved_hostshards") == 2
    resumed = [e for e in events if e.get("event") == "resumed_hostshards"]
    assert [e["epoch"] for e in resumed] == [1]
    assert os.listdir(ckpt + ".hostshards") == ["proc0.npz"]
    assert not os.path.exists(ckpt)
    assert all(np.isfinite(e["auc"]) for e in events if "auc" in e)


def test_cli_snn_resumes_without_pretraining_again(tiny_schema, tmp_path, capsys):
    """A resumed SNN run skips pretraining and its hand-off, as the
    reference's does, and continues the saved run."""
    ckpt = str(tmp_path / "snn.ckpt")
    metrics = tmp_path / "m.jsonl"
    argv = [f"data.schema_path={_write_schema(tiny_schema, tmp_path)}",
            "data.synthetic_examples=300", "model.name=snn", f"model.hidden1={H1}",
            "model.hidden=8", "train.pretrain=rbm", f"train.batch_size={BATCH}",
            f"train.checkpoint_path={ckpt}", f"train.metrics_path={metrics}"]
    assert t_cli.main(argv + ["train.epochs=1", "--device", "cpu"]) == 0
    assert t_cli.main(argv + ["train.epochs=2", "train.resume=true",
                              "--device", "cpu"]) == 0
    capsys.readouterr()
    events = [json.loads(line) for line in metrics.read_text().splitlines()]
    kinds = [e.get("event") or ("pretrain" if "pretrain_loss" in e else "epoch")
             for e in events]
    assert kinds.count("init_from_pretrain") == kinds.count("pretrain") == 1
    assert kinds.count("resumed") == 1 and kinds.index("resumed") > kinds.index(
        "init_from_pretrain")
    assert t_ckpt.read_manifest(ckpt)["epoch"] == 2
