"""The port's DLRM-DCNv2 (``models/dlrm.py``, ``ops/layers.py``,
``ops/pool.py``, the dense features of ``train/step.py``, ``train/loop.py``
and ``data/pipeline.py``, and the CLI) against the plain model of ``plain_dlrm_dcnv2.py`` on seeded
weights, at a small size on the CPU: three tables of 1-5 ids an example,
width 8, cross rank 4, small MLPs. Also: the FNN scan step without dense
features is the step it was (the same calls, the same bits as the per-step
route), the tracing's phases and the occurrences counter, and the generated
data."""

import json

import numpy as np
import pytest
import torch

import plain_dlrm_dcnv2 as plain
from deepctr_torch import cli
from deepctr_torch.data import FieldSpec, Schema, synthetic_dlrm
from deepctr_torch.models import MlpSpec, make_dlrm_dcnv2, make_fnn
from deepctr_torch.ops import layers, pool
from deepctr_torch.ops.kernels import count_difference, launch_counts
from deepctr_torch.optim import Adagrad, SparseAdagrad
from deepctr_torch.train import step as t_step
from deepctr_torch.utils import prof

SCHEMA = Schema((FieldSpec("a", 40, 3), FieldSpec("b", 300, 1), FieldSpec("c", 7, 5)))
WIDTHS = dict(embed_dim=8, bottom=(16, 8), cross_layers=2, cross_rank=4, top=(24, 16),
              num_dense=13)
SPARSE = {"lr": 0.05, "eps": 1e-8}
DENSE = {"lr": 0.02, "eps": 1e-8}
B, K = 32, 3


def _model(seed=0):
    model = make_dlrm_dcnv2(SCHEMA, **WIDTHS, init_sigma=0.1, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    model.init_parameters(gen, SCHEMA.pad_id)
    with torch.no_grad():   # non-zero biases, so that their gradients show
        for name, p in model.named_parameters():
            if name.endswith(".b"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def _leaves(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters() if n != "table"}


def _batch(seed, pad_share=0.2):
    """ids ``[B, S]`` (some slots pad), dense counts ``[B, 13]``, labels."""
    rng = np.random.default_rng(seed)
    cols = []
    for f, off in zip(SCHEMA.fields, SCHEMA.offsets):
        col = rng.integers(0, f.vocab_size, (B, f.max_len)) + off
        col[rng.random((B, f.max_len)) < pad_share] = SCHEMA.pad_id
        cols.append(col)
    ids = torch.from_numpy(np.concatenate(cols, 1)).long()
    dense = torch.from_numpy(np.floor(np.exp(rng.normal(1.0, 1.5, (B, 13))))).float()
    labels = torch.from_numpy((rng.random(B) < 0.3).astype(np.float32))
    return ids, dense, labels


def _plain_logits(model, ids, dense):
    mask = (ids != SCHEMA.pad_id).float()
    return plain.logits(_leaves(model), model.table.detach()[ids], mask, dense,
                        SCHEMA.slot_field, SCHEMA.num_fields)


def test_logits_match_the_plain_model():
    model = _model()
    ids, dense, _ = _batch(1)
    rows = model.table.detach()[ids]
    with torch.no_grad():
        got = model.apply_rows(rows, (ids != SCHEMA.pad_id).float(), dense=dense)
    torch.testing.assert_close(got, _plain_logits(model, ids, dense), rtol=1e-5, atol=1e-6)
    eval_step = t_step.make_eval_step(SCHEMA)
    torch.testing.assert_close(eval_step(model, ids, dense), got, rtol=0, atol=0)


def test_every_gradient_matches_the_plain_model():
    model = _model(3)
    ids, dense, labels = _batch(2)
    weights = torch.ones(B)
    mask = (ids != SCHEMA.pad_id).float()
    rows = model.table.detach()[ids].requires_grad_(True)
    params = t_step.dense_params(model)
    z = model.apply_rows(rows, mask, dense=dense, train=True, seed=0)
    loss = plain.loss(z, labels, weights)
    g_rows, *g = torch.autograd.grad(loss, [rows] + params)
    g_table = torch.zeros(model.table.shape).index_add_(
        0, ids.reshape(-1), g_rows.reshape(-1, g_rows.shape[-1]))
    want_loss, want_table, want = plain.loss_and_grads(
        model.table.detach(), _leaves(model), ids, mask, dense, labels, weights,
        SCHEMA.slot_field, SCHEMA.num_fields)
    torch.testing.assert_close(loss.detach(), want_loss, rtol=1e-6, atol=0)
    torch.testing.assert_close(g_table, want_table, rtol=1e-4, atol=1e-8)
    assert float(g_table[SCHEMA.pad_id].abs().max()) == 0.0
    names = [n for n, _ in model.named_parameters() if n != "table"]
    assert list(want) == names
    for name, got in zip(names, g):
        torch.testing.assert_close(got, want[name], rtol=1e-4, atol=1e-7, msg=name)


@pytest.mark.parametrize("mode", ["dense", "sorted"])
def test_three_scan_steps_match_the_plain_model(mode):
    """One chunk of three steps through ``make_scan_train_step`` (eager on
    the CPU), the last a weight-0 pad step, against three plain steps."""
    model = _model(5)
    sopt = SparseAdagrad(SPARSE["lr"], eps=SPARSE["eps"], mode=mode)
    dopt = Adagrad(DENSE["lr"], initial_accumulator_value=0.0, eps=DENSE["eps"])
    state = t_step.init_state(model, SCHEMA, sopt, dopt)
    with torch.no_grad():
        for p, p0 in zip(model.parameters(), _model(5).parameters()):
            p.copy_(p0)
    want = {"table": model.table.detach().clone(), "acc": torch.zeros(model.table.shape),
            "leaves": _leaves(model),
            "acc_d": {k: torch.zeros_like(v) for k, v in _leaves(model).items()}}
    batches = [_batch(10 + i) for i in range(K)]
    ids = torch.stack([b[0] for b in batches])
    dense = torch.stack([b[1] for b in batches])
    labels = torch.stack([b[2] for b in batches])
    weights = torch.ones(K, B)
    weights[-1] = 0.0
    scan = t_step.make_scan_train_step(SCHEMA, sopt, dopt)
    state, losses = scan(state, ids, labels, weights, dense=dense)
    assert state.step == K
    for i in range(K):
        value = plain.step(want, ids[i], (ids[i] != SCHEMA.pad_id).float(), dense[i],
                           labels[i], weights[i], SCHEMA.slot_field, SCHEMA.num_fields,
                           SPARSE, DENSE)
        if i < K - 1:
            torch.testing.assert_close(losses[i], value, rtol=1e-5, atol=0)
    assert float(losses[-1]) == 0.0
    torch.testing.assert_close(model.table.detach(), want["table"], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(state.sparse_state.acc, want["acc"], rtol=1e-4, atol=1e-12)
    assert float(model.table.detach()[SCHEMA.pad_id].abs().max()) == 0.0
    for (name, p), acc in zip([(n, p) for n, p in model.named_parameters() if n != "table"],
                              state.dense_state):
        torch.testing.assert_close(p.detach(), want["leaves"][name], rtol=1e-4, atol=1e-6,
                                   msg=name)
        torch.testing.assert_close(acc, want["acc_d"][name], rtol=1e-3, atol=1e-12,
                                   msg=name)


def test_scan_and_per_step_routes_agree_bit_for_bit():
    sopt = SparseAdagrad(0.05, eps=1e-8, mode="dense")
    dopt = Adagrad(0.02)
    states = [t_step.init_state(_model(7), SCHEMA, sopt, dopt) for _ in range(2)]
    batches = [_batch(20 + i) for i in range(K)]
    weights = torch.ones(K, B)
    scan = t_step.make_scan_train_step(SCHEMA, sopt, dopt)
    _, losses = scan(states[0], torch.stack([b[0] for b in batches]),
                     torch.stack([b[2] for b in batches]), weights,
                     dense=torch.stack([b[1] for b in batches]))
    one = t_step.make_train_step(SCHEMA, sopt, dopt)
    for i, (ids, dense, labels) in enumerate(batches):
        _, m = one(states[1], ids, labels, weights[i], dense=dense)
        assert torch.equal(m.loss, losses[i])
    for a, b in zip(states[0].model.parameters(), states[1].model.parameters()):
        assert torch.equal(a, b)


def _fnn_case():
    schema = Schema((FieldSpec("a", 50, 1), FieldSpec("b", 30, 2)))
    sopt, dopt = SparseAdagrad(0.05, mode="dense"), Adagrad(0.02)
    model = make_fnn(schema, k=4, mlp=MlpSpec(hidden=(8, 6), dropout=0.5), device="cpu")
    state = t_step.init_state(model, schema, sopt, dopt, seed=3)
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(0, 80, (K, 16, 3))).long()
    labels = torch.from_numpy((rng.random((K, 16)) < 0.4).astype(np.float32))
    return schema, sopt, dopt, state, ids, labels, torch.ones(K, 16)


def test_fnn_scan_step_without_dense_features_is_unchanged(monkeypatch):
    """``dense=None`` is the call without it: the model is called with the
    arguments it always had, and the state's bits are the per-step route's."""
    schema, sopt, dopt, state, ids, labels, weights = _fnn_case()
    other = state.clone()
    third = state.clone()
    calls = []
    real = type(state.model).apply_rows

    def spy(self, rows, mask, **kw):
        calls.append(sorted(kw))
        return real(self, rows, mask, **kw)

    monkeypatch.setattr(type(state.model), "apply_rows", spy)
    scan = t_step.make_scan_train_step(schema, sopt, dopt)
    _, with_none = scan(state, ids, labels, weights, seeds=[1, 2, 3], dense=None)
    assert calls == [["seed", "train"]] * K
    _, without = scan(other, ids, labels, weights, seeds=[1, 2, 3])
    assert torch.equal(with_none, without)
    step = t_step.make_train_step(schema, sopt, dopt)
    for i in range(K):
        _, m = step(third, ids[i], labels[i], weights[i], seed=i + 1)
        assert torch.equal(m.loss, without[i])
    for a, b, c in zip(state.model.parameters(), other.model.parameters(),
                       third.model.parameters()):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(state.sparse_state.acc, other.sparse_state.acc)
    assert t_step._graph_key(state, ids.shape, 1.0)[-1] is None   # no dense buffer


def test_a_chunk_needs_dense_features_for_every_step():
    sopt, dopt = SparseAdagrad(0.05), Adagrad(0.02)
    state = t_step.init_state(_model(), SCHEMA, sopt, dopt)
    ids, dense, labels = _batch(1)
    scan = t_step.make_scan_train_step(SCHEMA, sopt, dopt)
    with pytest.raises(ValueError, match="dense"):
        scan(state, ids[None].repeat(2, 1, 1), labels[None].repeat(2, 1), torch.ones(2, B),
             dense=dense[None])


def test_phases_and_occurrences_of_a_step():
    """On the CPU the step's phase marks take the host's clock: DLRM's
    eight, in order; the counter adds B·S ids a step."""
    sopt, dopt = SparseAdagrad(0.05, mode="dense"), Adagrad(0.02)
    state = t_step.init_state(_model(), SCHEMA, sopt, dopt)
    ids, dense, labels = _batch(1)
    step = t_step.make_train_step(SCHEMA, sopt, dopt)
    before = launch_counts()
    prof.enable(True)
    try:
        prof.drain()
        step(state, ids, labels, torch.ones(B), dense=dense)
        marks = [name for name, _ in prof.drain()["marks"]]
    finally:
        prof.enable(False)
    assert marks == [prof.START, "lookup", "pool", "bottom", "cross", "top", "backward",
                     "sparse", "dense"]
    assert count_difference(launch_counts(), before)["pool.OCCURRENCES"] == B * ids.shape[1]
    assert pool.OCCURRENCES >= B * ids.shape[1]


def test_layers_compute_in_float32_and_restore_the_flags():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(5, 7, generator=gen, requires_grad=True)
    w = torch.randn(7, 3, generator=gen, requires_grad=True)
    b = torch.randn(3, generator=gen, requires_grad=True)
    held = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y = layers.linear(x, w, b, relu=True)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = held
    g = torch.randn(5, 3, generator=gen)
    got = torch.autograd.grad(y, [x, w, b], g)
    ref = torch.relu(x @ w + b)
    want = torch.autograd.grad(ref, [x, w, b], g)
    torch.testing.assert_close(y, ref)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e)
    mask = (torch.rand(5, 4, generator=gen) < 0.7).float()
    rows = torch.randn(5, 4, 3, generator=gen)
    onehot = torch.tensor([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.0, 1.0]])
    from deepctr_torch.models.base import pool_fields

    torch.testing.assert_close(pool.pool_slots(rows, mask, onehot),
                               pool_fields(rows, mask, onehot))


def test_cli_trains_dlrm_on_generated_data(tmp_path, capsys):
    schema_path = tmp_path / "schema.json"
    schema_path.write_text(SCHEMA.to_json())
    args = ["model.name=dlrm_dcnv2", "model.k=8", "model.hidden=16,8",
            "model.activation=relu", "model.dropout=0", f"data.schema_path={schema_path}",
            "data.synthetic_examples=1200", "train.batch_size=128", "train.epochs=2",
            "train.scan_steps=4", "optim.sparse_mode=dense"]
    out = cli.run(cli.RunConfig().apply_overrides(args), torch.device("cpu"))
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    epochs = [r for r in records if "train_loss" in r]
    assert len(epochs) == 2 and len(out["history"]) == 2
    assert all(np.isfinite(r["train_loss"]) and 0.0 <= r["auc"] <= 1.0 for r in epochs)
    assert out["state"].step == 2 * 4 * 2   # 8 batches an epoch, two chunks of 4
    with pytest.raises(ValueError, match="no dropout"):
        cli.build_model(cli.RunConfig().apply_overrides(["model.name=dlrm_dcnv2"]),
                        SCHEMA, "cpu")
    with pytest.raises(ValueError, match="train.checkpoint_path"):
        cli.run(cli.RunConfig().apply_overrides(args + ["train.checkpoint_path=x"]),
                torch.device("cpu"))


def test_fit_passes_dense_features_on_both_routes():
    """``loop.fit`` with ``train_dense`` and ``test_dense``: the scan route's
    chunks and the per-step route's batches carry each example's dense
    features beside its ids (a short last chunk padded with zeros), and
    one chunk of K steps gives the bits of K per-step steps."""
    from deepctr_torch.data import minibatches
    from deepctr_torch.train import loop

    data = synthetic_dlrm.generate(SCHEMA, 5 * B + 7, seed=4)
    (nb, chunk), = loop.ram_chunks(data.ids, data.labels, B, 8, schema=SCHEMA, seed=2,
                                   dense=data.dense)
    first = next(minibatches(data.ids, data.labels, B, schema=SCHEMA, seed=2,
                             dense=data.dense))
    assert nb == 5 and len(chunk) == 4 and chunk[3].shape == (8, B, 13)
    assert np.array_equal(chunk[0][0], first.ids)
    assert np.array_equal(chunk[3][0], first.dense)
    assert not chunk[3][nb:].any() and not chunk[2][nb:].any()
    sopt = SparseAdagrad(0.05, eps=1e-8, mode="dense")
    dopt = Adagrad(0.02)
    results = []
    for scan_steps in (5, 0):
        state = t_step.init_state(_model(9), SCHEMA, sopt, dopt)
        results.append(loop.fit(state.model, SCHEMA, data.ids, data.labels, data.ids[:64],
                                data.labels[:64], sparse_opt=sopt, dense_opt=dopt,
                                batch_size=B, epochs=1, seed=2, state=state,
                                scan_steps=scan_steps, train_dense=data.dense,
                                test_dense=data.dense[:64]))
    scan, per_step = results
    assert scan.state.step == per_step.state.step == 5
    assert scan.history[0]["train_loss"] == per_step.history[0]["train_loss"]
    assert scan.history[0]["auc"] == per_step.history[0]["auc"]
    for a, b in zip(t_step._state_tensors(scan.state), t_step._state_tensors(per_step.state)):
        assert torch.equal(a, b)


def test_generated_data_and_the_mlperf_schema():
    full = synthetic_dlrm.mlperf_dlrm_schema()
    assert full.vocab_size == 204_184_588 and full.num_slots == 214
    capped = synthetic_dlrm.mlperf_dlrm_schema(1_000_000)
    assert capped.vocab_size == 6 * 1_000_000 + 1_116_632
    a = synthetic_dlrm.generate(SCHEMA, 500, seed=3)
    b = synthetic_dlrm.generate(SCHEMA, 500, seed=3)
    assert np.array_equal(a.ids, b.ids) and np.array_equal(a.dense, b.dense)
    assert a.ids.shape == (500, SCHEMA.num_slots) and a.dense.shape == (500, 13)
    assert int(a.ids.min()) >= 0 and int(a.ids.max()) < SCHEMA.vocab_size  # no pad slot
    field = np.searchsorted(np.cumsum([f.vocab_size for f in SCHEMA.fields]), a.ids,
                            side="right")
    assert np.array_equal(field, np.broadcast_to(SCHEMA.slot_field, field.shape))
    assert float(a.dense.min()) >= 0.0 and 0.05 < float(a.labels.mean()) < 0.95
