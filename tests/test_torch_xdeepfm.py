"""The port's xDeepFM (``models/xdeepfm.py``, ``ops/cin.py``, its phases in
``train/step.py`` and the CLI) against the plain model of
``plain_xdeepfm.py`` on seeded weights, at a small size on the CPU: B = 16
examples of m = 5 fields (one of them two slots), D = 4, a CIN of 6-6-6
feature maps and an 8-8 DNN. Also the CIN's equation by hand, the
tracing's phases and the CIN's counters. Tolerances: the port and the
plain model compute in float32 and sum in other orders (the CIN's
products as one matrix product of the outer product against a per-block
einsum; the pooling as a batched product against a float64 sum), which
moves a value by a few units of float32's last place, 1e-6 relative at
these sizes; a wrong term moves it by far more."""

import json
import os

import numpy as np
import pytest
import torch

import plain_xdeepfm as plain
from deepctr_torch import cli
from deepctr_torch.data import FieldSpec, Schema
from deepctr_torch.models import make_xdeepfm
from deepctr_torch.ops import cin as cin_op
from deepctr_torch.ops.kernels import count_difference, launch_counts
from deepctr_torch.optim import Adam, SparseAdagrad
from deepctr_torch.train import step as t_step
from deepctr_torch.utils import prof

SCHEMA = Schema((FieldSpec("a", 40, 1), FieldSpec("b", 300, 1), FieldSpec("c", 7, 2),
                 FieldSpec("d", 50, 1), FieldSpec("e", 9, 1)))
M, D, MAPS, DNN = SCHEMA.num_fields, 4, (6, 6, 6), (8, 8)
SPARSE = {"lr": 0.05, "eps": 1e-8}
DENSE_LR = 0.01
B = 16


def _model(seed=0):
    model = make_xdeepfm(SCHEMA, k=D, cin=MAPS, dnn=DNN, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    model.init_parameters(gen, SCHEMA.pad_id)
    with torch.no_grad():   # rows of a trained scale, and non-zero biases
        model.table.copy_(0.5 * torch.randn(model.table.shape, generator=gen))
        model.table[SCHEMA.pad_id] = 0.0
        for name, p in model.named_parameters():
            if name == "bias" or name.endswith(".b"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def _leaves(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters() if n != "table"}


def _batch(seed, pad_share=0.2):
    """ids ``[B, S]`` (the two-slot field's second slot sometimes pad), labels."""
    rng = np.random.default_rng(seed)
    cols = []
    for f, off in zip(SCHEMA.fields, SCHEMA.offsets):
        col = rng.integers(0, f.vocab_size, (B, f.max_len)) + off
        if f.max_len > 1:
            col[:, 1:][rng.random((B, f.max_len - 1)) < pad_share] = SCHEMA.pad_id
        cols.append(col)
    ids = torch.from_numpy(np.concatenate(cols, 1)).long()
    labels = torch.from_numpy((rng.random(B) < 0.3).astype(np.float32))
    return ids, labels


def _cin_case(seed=1):
    gen = torch.Generator().manual_seed(seed)
    x0 = torch.randn(B, M, D, generator=gen)
    widths = (M,) + MAPS
    weights = [torch.randn(a * M, b, generator=gen) / (a * M) ** 0.5
               for a, b in zip(widths[:-1], widths[1:])]
    return x0, weights


def test_cin_forward_matches_the_einsum():
    x0, weights = _cin_case()
    got = cin_op.cin(x0.transpose(1, 2).contiguous(), weights)
    torch.testing.assert_close(got, plain.cin(x0, weights, block=5), rtol=1e-5, atol=1e-6)


def test_cin_gradients_match_autograd_of_the_einsum():
    x0, weights = _cin_case(2)
    g = torch.randn(B, sum(MAPS), generator=torch.Generator().manual_seed(3))
    leaves = [x0.requires_grad_(True)] + [w.requires_grad_(True) for w in weights]
    got = torch.autograd.grad(cin_op.cin(x0.transpose(1, 2).contiguous(), weights), leaves, g)
    want = torch.autograd.grad(plain.cin(x0, weights, block=5), leaves, g)
    for name, a, e in zip(["x0", "cin.0", "cin.1", "cin.2"], got, want):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("layer", range(len(MAPS)))
def test_each_layers_gradients_of_its_maps_and_x0(layer):
    """``layer_grads`` of ``X^{k-1}``, ``X^0`` and ``W^k`` for one layer,
    at the maps the plain CIN gives that layer as input, against autograd
    of one einsum layer."""
    x0, weights = _cin_case(4)
    x_in = x0 if layer == 0 else plain.cin_maps(x0, weights)[layer - 1]
    x_in = x_in.detach().requires_grad_(True)
    e = x0.detach().requires_grad_(True)
    w = weights[layer].detach().requires_grad_(True)
    out = torch.einsum("bijd,ijh->bhd", torch.einsum("bid,bjd->bijd", x_in, e),
                       w.view(x_in.shape[1], M, -1))
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(5 + layer))
    want = torch.autograd.grad(out, [x_in, e, w], g)
    flat = lambda t: t.transpose(1, 2).reshape(B * D, -1).contiguous()   # noqa: E731
    g_x, g_x0, g_w = cin_op.layer_grads(flat(x_in.detach()), flat(x0), w.detach(), flat(g))
    unflat = lambda t: t.view(B, D, -1).transpose(1, 2)   # noqa: E731
    torch.testing.assert_close(unflat(g_x), want[0], rtol=1e-5, atol=1e-6)
    if layer == 0:   # X^{k-1} is X^0: its gradient is both parts'
        g_x0 = g_x0 + g_x
        want = (want[0], want[0] + want[1], want[2])
    torch.testing.assert_close(unflat(g_x0), want[1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(g_w, want[2], rtol=1e-5, atol=1e-6)


def test_equation_6_by_hand():
    """H = 1 map, m = 2 fields, D = 1: ``X^1 = Σ_ij W^1[0,i,j] x_i x_j`` and
    ``X^2 = X^1 · Σ_j W^2[0,0,j] x_j``, each pooled over its one dimension."""
    a, b = 2.0, -3.0
    w1 = torch.tensor([[0.5], [1.0], [-2.0], [0.25]])   # rows i·m + j
    w2 = torch.tensor([[3.0], [0.5]])
    x0 = torch.tensor([[[a, b]]])                        # [B, D, m]
    x1 = 0.5 * a * a + 1.0 * a * b - 2.0 * b * a + 0.25 * b * b
    x2 = x1 * (3.0 * a + 0.5 * b)
    assert cin_op.cin(x0, [w1, w2]).tolist() == [[x1, x2]]
    assert cin_op.outer_bytes(1, 1, 2, (1, 1)) == 3 * 4 * (2 * 2 + 1 * 2)


def test_logits_loss_and_every_gradient_match_the_plain_model():
    model = _model(3)
    ids, labels = _batch(2)
    weights = torch.ones(B)
    mask = (ids != SCHEMA.pad_id).float()
    rows = model.table.detach()[ids].requires_grad_(True)
    params = t_step.dense_params(model)
    z = model.apply_rows(rows, mask, train=True, seed=0)
    torch.testing.assert_close(
        z.detach(), plain.logits(_leaves(model), rows.detach(), mask, SCHEMA.slot_field, M),
        rtol=1e-5, atol=1e-5)
    loss = plain.loss(z, labels, weights)
    g_rows, *g = torch.autograd.grad(loss, [rows] + params)
    g_table = torch.zeros(model.table.shape).index_add_(
        0, ids.reshape(-1), g_rows.reshape(-1, g_rows.shape[-1]))
    want_loss, want_table, want = plain.loss_and_grads(
        model.table.detach(), _leaves(model), ids, mask, labels, weights,
        SCHEMA.slot_field, M)
    torch.testing.assert_close(loss.detach(), want_loss, rtol=1e-6, atol=0)
    torch.testing.assert_close(g_table, want_table, rtol=1e-4, atol=1e-7)
    assert float(g_table[SCHEMA.pad_id].abs().max()) == 0.0
    names = [n for n, _ in model.named_parameters() if n != "table"]
    assert list(want) == names
    for name, got in zip(names, g):
        torch.testing.assert_close(got, want[name], rtol=1e-4, atol=1e-6, msg=name)
    with pytest.raises(ValueError, match="dense"):
        model.apply_rows(rows, mask, dense=torch.ones(B, 13))


@pytest.mark.parametrize("pads", [0, 1])
def test_three_scan_steps_match_the_plain_model(pads):
    """One chunk of three steps through ``make_scan_train_step`` (eager on
    the CPU), with ``pads`` weight-0 pad steps after them (Adam moves the
    dense leaves on a pad step; Adagrad leaves the table), against the plain
    model's steps. Adam's update divides by the gradient's own size, so a
    gradient element near 0 turns its round-off into a change of up to
    ``lr``: the leaves are held to 1e-4 relative and 2e-6 absolute."""
    model = _model(5)
    sopt = SparseAdagrad(SPARSE["lr"], eps=SPARSE["eps"], mode="dense")
    dopt = Adam(DENSE_LR)
    state = t_step.init_state(model, SCHEMA, sopt, dopt)
    with torch.no_grad():
        for p, p0 in zip(model.parameters(), _model(5).parameters()):
            p.copy_(p0)
    leaves = _leaves(model)
    want = {"table": model.table.detach().clone(), "acc": torch.zeros(model.table.shape),
            "leaves": leaves, "mu": {k: torch.zeros_like(v) for k, v in leaves.items()},
            "nu": {k: torch.zeros_like(v) for k, v in leaves.items()}, "count": 0}
    batches = [_batch(10 + i) for i in range(3)]
    ids = torch.stack([b[0] for b in batches] + [torch.full_like(batches[0][0], SCHEMA.pad_id)]
                      * pads)
    labels = torch.stack([b[1] for b in batches] + [torch.zeros(B)] * pads)
    weights = torch.ones(3 + pads, B)
    weights[3:] = 0.0
    scan = t_step.make_scan_train_step(SCHEMA, sopt, dopt)
    state, losses = scan(state, ids, labels, weights)
    assert state.step == 3 + pads
    for i in range(3):
        value = plain.step(want, ids[i], (ids[i] != SCHEMA.pad_id).float(), labels[i],
                           weights[i], SCHEMA.slot_field, M, SPARSE, DENSE_LR)
        torch.testing.assert_close(losses[i], value, rtol=1e-5, atol=0)
    for _ in range(pads):
        plain.adam(want, {k: torch.zeros_like(v) for k, v in leaves.items()}, DENSE_LR)
        assert float(losses[3]) == 0.0
    touched = torch.unique(ids[:3].reshape(-1))
    torch.testing.assert_close(model.table.detach()[touched], want["table"][touched],
                               rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(state.sparse_state.acc, want["acc"], rtol=1e-4, atol=1e-12)
    untouched = torch.ones(model.table.shape[0], dtype=torch.bool)
    untouched[touched] = False
    assert torch.equal(model.table.detach()[untouched], want["table"][untouched])
    assert float(model.table.detach()[SCHEMA.pad_id].abs().max()) == 0.0
    assert int(state.dense_state.count) == 3 + pads
    names = [n for n, _ in model.named_parameters() if n != "table"]
    for name, p in zip(names, t_step.dense_params(model)):
        torch.testing.assert_close(p.detach(), want["leaves"][name], rtol=1e-4, atol=2e-6,
                                   msg=name)


def test_phases_and_counters_of_a_step():
    """On the CPU the step's phase marks take the host's clock: xDeepFM's,
    in order, the CIN's backward its own phase inside the backward, at most
    ``PHASES_A_STEP`` after the start; the CIN's counters add its formula's
    bytes and nine products a step."""
    sopt, dopt = SparseAdagrad(0.05, mode="dense"), Adam(0.01)
    state = t_step.init_state(_model(), SCHEMA, sopt, dopt)
    ids, labels = _batch(1)
    step = t_step.make_train_step(SCHEMA, sopt, dopt)
    before = launch_counts()
    prof.enable(True)
    try:
        prof.drain()
        step(state, ids, labels, torch.ones(B))
        marks = [name for name, _ in prof.drain()["marks"]]
    finally:
        prof.enable(False)
    assert marks == [prof.START, "lookup", "cin", "dnn", "backward", "cin_bwd", "backward",
                     "sparse", "dense"]
    assert len(marks) - 1 <= prof.PHASES_A_STEP
    delta = count_difference(launch_counts(), before)
    assert delta["cin.OUTER_BYTES"] == cin_op.outer_bytes(B, D, M, MAPS) == \
        3 * 4 * B * D * M * (M + 6 + 6)
    assert delta["cin.PRODUCTS"] == 3 * len(MAPS)
    assert delta["cin_kernel.LAUNCHES"] == 0   # the CPU takes the plain version
    assert delta["pool.OCCURRENCES"] == B * SCHEMA.num_slots


def test_cli_trains_xdeepfm(tmp_path, capsys):
    schema_path = tmp_path / "schema.json"
    schema_path.write_text(SCHEMA.to_json())
    args = ["model.name=xdeepfm", "model.k=4", "model.hidden=8,8", "model.activation=relu",
            "model.dropout=0", f"data.schema_path={schema_path}",
            "data.synthetic_examples=600", "train.batch_size=64", "train.epochs=2",
            "train.scan_steps=4", "optim.sparse_mode=dense", "optim.dense=adam",
            "optim.dense_lr=0.001"]
    out = cli.run(cli.RunConfig().apply_overrides(args), torch.device("cpu"))
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    epochs = [r for r in records if "train_loss" in r]
    assert len(epochs) == 2 and len(out["history"]) == 2
    assert all(np.isfinite(r["train_loss"]) and 0.0 <= r["auc"] <= 1.0 for r in epochs)
    assert out["state"].step == 2 * 4 * 2   # 7 batches an epoch, two chunks of 4
    assert [p.shape[1] for p in out["state"].model.cin] == [200, 200, 200]
    with pytest.raises(ValueError, match="no dropout"):
        cli.build_model(cli.RunConfig().apply_overrides(["model.name=xdeepfm"]), SCHEMA,
                        "cpu")
    for bad in ("train.checkpoint_path=x", "train.sharded=true"):
        with pytest.raises(ValueError, match=bad.split("=")[0]):
            cli.run(cli.RunConfig().apply_overrides(args + [bad]), torch.device("cpu"))


def test_the_repositorys_config_is_the_papers_criteo_one():
    cfg = cli.RunConfig.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "xdeepfm_criteo.json"))
    assert (cfg.model.name, cfg.model.k, cfg.model.hidden) == ("xdeepfm", 10, (400, 400))
    assert (cfg.train.batch_size, cfg.train.scan_steps) == (4096, 8)
    assert (cfg.optim.dense, cfg.optim.dense_lr, cfg.optim.sparse_mode) == ("adam", 0.001,
                                                                             "dense")
    assert cfg.data.format == "criteo" and cfg.data.criteo_cat_buckets == 1_000_000


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tower kernels have no CPU form")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.card
def test_cin_on_the_card_at_criteo_width():
    """The CIN at the paper's widths (m = 39, D = 10, 200-200-200) on 512
    examples on the card, forward and gradients, against the plain einsum
    there in float32, TF32 off."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(7)
    x0 = 0.5 * torch.randn(512, 39, 10, generator=gen, device=dev)
    widths = (39, 200, 200, 200)
    weights = [torch.randn(a * 39, b, generator=gen, device=dev) / (a * 39) ** 0.5
               for a, b in zip(widths[:-1], widths[1:])]
    leaves = [x0.requires_grad_(True)] + [w.requires_grad_(True) for w in weights]
    g = torch.randn(512, 600, generator=gen, device=dev)
    got_y = cin_op.cin(x0.transpose(1, 2).contiguous(), weights)
    got = torch.autograd.grad(got_y, leaves, g)
    with plain.f32_products():
        want_y = plain.cin(x0, weights)
        want = torch.autograd.grad(want_y, leaves, g)
    torch.testing.assert_close(got_y, want_y, rtol=1e-4, atol=1e-4)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-4)


@pytest.mark.card
def test_one_step_on_the_card_runs_the_cin_kernel():
    """One train step on the card: the CIN's nine products on its kernel
    (``kernels/cin.py``), none on cuBLAS, no outer product in memory."""
    dev = _card()
    sopt, dopt = SparseAdagrad(0.05, eps=1e-8, mode="dense"), Adam(0.01)
    state = t_step.init_state(_model(6).to(dev), SCHEMA, sopt, dopt)
    ids, labels = _batch(40)
    step = t_step.make_train_step(SCHEMA, sopt, dopt)
    before = launch_counts()
    step(state, ids.to(dev), labels.to(dev), torch.ones(B, device=dev))
    delta = count_difference(launch_counts(), before)
    assert delta["cin_kernel.LAUNCHES"] == 9 and delta["cin.PRODUCTS"] == 9
    assert delta["cin.OUTER_BYTES"] == 0 and delta["dense.BWD_LIBRARY"] == 0


@pytest.mark.card
def test_a_graph_replay_gives_the_eager_steps_bits():
    """One replay of an 8-step graph against 8 eager steps on the card."""
    dev = _card()
    sopt, dopt = SparseAdagrad(0.05, eps=1e-8, mode="dense"), Adam(0.01)
    states = []
    for _ in range(2):
        model = _model(6).to(dev)
        states.append(t_step.init_state(model, SCHEMA, sopt, dopt))
    batches = [_batch(30 + i) for i in range(8)]
    ids = torch.stack([b[0] for b in batches]).to(dev)
    labels = torch.stack([b[1] for b in batches]).to(dev)
    weights = torch.ones(8, B, device=dev)
    _, losses = t_step.make_scan_train_step(SCHEMA, sopt, dopt)(states[0], ids, labels,
                                                                 weights)
    one = t_step.make_train_step(SCHEMA, sopt, dopt)
    for i in range(8):
        _, m = one(states[1], ids[i], labels[i], weights[i])
        assert torch.equal(m.loss, losses[i])
    for a, b in zip(t_step._state_tensors(states[0]), t_step._state_tensors(states[1])):
        assert torch.equal(a, b)
