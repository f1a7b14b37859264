"""The port's HSTU (``models/hstu.py``, ``ops/hstu.py``, its step in
``train/step.py``, its phases and counters, the CLI) against the plain model
of ``plain_hstu.py`` on seeded weights, at a small size on the CPU: 2
blocks, D = 32, 2 heads of 16, N = 24, 60 items, 16 negatives a position;
histories of lengths 1, 2, N and others.

Tolerances: the port and the plain model compute in float32 and sum in
other orders (the projections as one matrix product of ``[B·N, D]`` rows
against einsums per position; the bias tables through ``F.embedding``
against direct indexing; the negatives' cosines on the normalised table
against rows normalised one by one), so a value moves by a few units of
float32's last place; the cosines over a temperature of 0.05 magnify an
output's rounding twenty times in the loss. So outputs and the loss are
held to 2e-5 relative, gradients to 1e-5 of their leaf's largest entry
(read here: 0 and 7.3e-7); a wrong term (a bias dropped, a mask lost, a softmax) moves them by orders
more. What the design makes exact (causality, the padded tail, the bucket
edges, a replay against eager steps) is held bit for bit."""

import json

import numpy as np
import pytest
import torch

import plain_hstu as plain
from deepctr_torch import cli
from deepctr_torch.data import synthetic_hstu
from deepctr_torch.models import make_dlrm_dcnv2, make_hstu
from deepctr_torch.ops import hstu as hstu_op
from deepctr_torch.optim import Adam
from deepctr_torch.train import step as t_step
from deepctr_torch.utils import prof

ITEMS, N, D, BLOCKS, HEADS, DH, NEG = 60, 24, 32, 2, 2, 16, 16
SCHEMA = synthetic_hstu.ml20m_schema(ITEMS, N)
CFG = {"items": ITEMS, "max_len": N, "k": D, "blocks": BLOCKS, "heads": HEADS,
       "d_qk": DH, "d_v": DH, "dropout": 0.2, "negatives": NEG, "temperature": 0.05}
LENGTHS = (1, 2, N, 7, 13, 20)
LR, B1, B2 = 1e-3, 0.9, 0.98


@pytest.fixture(autouse=True)
def one_thread():
    held = torch.get_num_threads()
    torch.set_num_threads(1)
    prof.enable(False)
    prof.drain()
    yield
    prof.enable(False)
    prof.drain()
    torch.set_num_threads(held)


def _model(seed=0, dropout=0.2):
    model = make_hstu(SCHEMA, k=D, blocks=BLOCKS, heads=HEADS, d_qk=DH, d_v=DH,
                      dropout=dropout, negatives=NEG, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    model.init_parameters(gen, SCHEMA.pad_id)
    with torch.no_grad():   # biases at a scale where a lost term shows
        for blk in model.blocks:
            for p in (blk.w_pos, blk.w_time, blk.b_o):
                p.copy_(0.5 * torch.randn(p.shape, generator=gen))
    return model


def _params(model) -> dict:
    return {n: p.detach().clone().requires_grad_(True) for n, p in model.named_parameters()}


def _batch(seed, lengths=LENGTHS):
    """ids ``[B, 2, N]``: random items, timestamps rising by lognormal gaps
    with a gap of 0 and one of 1 in each history."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    seq = rng.integers(0, ITEMS, (b, N))
    gaps = np.floor(np.exp(4.0 + 3.0 * rng.standard_normal((b, N)))).astype(np.int64)
    gaps[:, 3], gaps[:, 5] = 0, 1
    ts = 1_200_000_000 + np.cumsum(gaps, 1)
    return torch.from_numpy(synthetic_hstu.pack(seq, ts, np.array(lengths), ITEMS))


def _valid(ids):
    return ids[:, 0] != ITEMS


def _close(a, b, rtol):
    scale = max(float(b.abs().max()), 1e-30)
    assert float((a - b).abs().max()) <= rtol * scale, (float((a - b).abs().max()), scale)


@pytest.mark.parametrize("seed", [None, 5])
def test_outputs_match_the_plain_model(seed):
    model, ids = _model(), _batch(1)
    with torch.no_grad():
        got = model.encode(ids, seed)
        want = plain.encode(_params(model), ids, CFG, seed)
    v = _valid(ids)
    _close(got[v], want[v], 2e-5)


def test_loss_and_every_gradient_match_the_plain_model():
    model, ids = _model(), _batch(2)
    weights = torch.tensor([1.0, 1.0, 1.0, 0.0, 1.0, 1.0])
    loss = model.train_loss(ids, weights, 77)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    p = _params(model)
    want = plain.loss(p, ids, weights, CFG, 77)
    wgrads = torch.autograd.grad(want, list(p.values()))
    assert float(loss.detach()) == pytest.approx(float(want.detach()), rel=2e-5)
    for name, g, w in zip(p, grads, wgrads):
        assert float(w.abs().max()) > 0, name
        _close(g, w, 1e-5)


def test_one_adam_step_matches_the_plain_model():
    model, ids = _model(3), _batch(3)
    opt = Adam(LR, b1=B1, b2=B2)
    state = t_step.init_state(model, SCHEMA, None, opt)
    with torch.no_grad():   # the state's own init drew new weights: take them
        p0 = _params(model)
    step = t_step.make_train_step(SCHEMA, None, opt)
    step(state, ids, torch.zeros(len(LENGTHS)), torch.ones(len(LENGTHS)), seed=11)
    p = {n: t.detach().clone().requires_grad_(True) for n, t in p0.items()}
    loss = plain.loss(p, ids, torch.ones(len(LENGTHS)), CFG, 11)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    adam = {"count": 0, "mu": {}, "nu": {}}
    plain.adam_step(p, grads, adam, LR, B1, B2)
    for name, q in model.named_parameters():
        moved = p[name] - p0[name]
        # a step moves an entry by about lr; the two sides agree to 1e-3 of it
        # (Adam's first step divides a gradient by its own magnitude, so an
        # entry whose gradient is a rounding error away from 0 may differ more)
        ok = ((q.detach() - p0[name]) - moved).abs() <= 1e-3 * LR
        share = float(ok.float().mean())
        assert share >= 0.995, (name, share)
    assert int(state.dense_state.count) == 1


@pytest.mark.parametrize("j", [1, 6, 12])
def test_an_item_changes_no_output_before_it(j):
    model, ids = _model(), _batch(4, lengths=(N, N, 18))
    other = ids.clone()
    other[:, 0, j] = (other[:, 0, j] + 1) % ITEMS
    with torch.no_grad():
        a, b = model.encode(ids, 9), model.encode(other, 9)
    assert torch.equal(a[:, :j], b[:, :j])
    assert not torch.equal(a[:, j], b[:, j])


@pytest.mark.parametrize("j", [1, 6, 12])
def test_a_timestamp_changes_no_output_before_the_one_it_is_next_to(j):
    """The query at ``i`` reads ``t[i+1]`` (the time of the next action, the
    source's ``t_{i+1} - t_j``): a change of ``t[j]`` leaves the outputs
    before ``j - 1`` bit for bit, and moves the one at ``j - 1``."""
    model, ids = _model(), _batch(5, lengths=(N, N, 18))
    other = ids.clone()
    other[:, 1, j:] += 10_000_000   # later, still rising
    with torch.no_grad():
        a, b = model.encode(ids), model.encode(other)
    assert torch.equal(a[:, :j - 1], b[:, :j - 1])
    assert not torch.equal(a[:, j - 1], b[:, j - 1])


def test_a_padded_tail_changes_no_valid_output_and_no_gradient():
    """Histories no longer than 16 of N = 24: the pad row of the table and
    the positions 16.. are read only by padded positions. Set to anything,
    the valid outputs, the loss and every other gradient keep their bits,
    and those rows take a zero gradient."""
    ids = _batch(6, lengths=(1, 2, 16, 9, 16, 5))
    results = []
    for scale in (0.0, 3.0):
        model = _model(6)
        with torch.no_grad():
            model.table[ITEMS] = scale
            model.pos_emb[16:] = scale
        loss = model.train_loss(ids, torch.ones(6), 21)
        grads = dict(zip([n for n, _ in model.named_parameters()],
                         torch.autograd.grad(loss, list(model.parameters()))))
        with torch.no_grad():
            out = model.encode(ids, 21)[_valid(ids)]
        results.append((loss.detach(), out, grads))
    (l0, o0, g0), (l1, o1, g1) = results
    assert torch.equal(l0, l1) and torch.equal(o0, o1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    assert float(g0["table"][ITEMS].abs().max()) == 0.0
    assert float(g0["pos_emb"][16:].abs().max()) == 0.0


def test_time_buckets_at_their_edges():
    """``Δ`` = 0 and 1 give bucket 0 (``log 1 = 0``), 2 gives ``floor(0.693 /
    0.301) = 2``, a negative ``Δ`` its absolute value's, a huge one the cap
    128; the last query reads ``t[N-1]`` again (the source's extension)."""
    ts = torch.tensor([[100, 100, 101, 103, 10**18]])
    b = hstu_op.time_buckets(ts)
    assert b.shape == (1, 5, 5)
    # row i reads t[i+1]: row 0 -> t1 - t_j = 0, 0, -1, -3, ...
    assert b[0, 0, :4].tolist() == [0, 0, 0, 3]
    assert int(b[0, 1, 1]) == 0 and int(b[0, 1, 0]) == 0
    assert int(b[0, 2, 0]) == 3          # 103 - 100 = 3: ln 3 / 0.301 = 3.65
    assert int(b[0, 1, 2]) == 0          # 101 - 101
    assert int(b[0, 0, 2]) == 0          # |100 - 101| = 1
    assert int(hstu_op.time_buckets(torch.tensor([[0, 2, 2]]))[0, 0, 0]) == 2
    assert int(b[0, 3, 0]) == 128 and int(b[0, 4, 4]) == 0   # huge, then the extension
    assert torch.equal(b, plain.bucket(torch.cat([ts, ts[:, -1:]], 1)[:, 1:, None]
                                       - ts[:, None, :]))


def test_position_bias_at_both_ends():
    idx = hstu_op.position_index(N, "cpu")
    assert int(idx[0, N - 1]) == 2 * N - 2 and int(idx[N - 1, 0]) == 0
    assert torch.equal(idx.diagonal(), torch.full((N,), N - 1))
    w_pos, w_time = torch.randn(2 * N - 1), torch.randn(129)
    ts = _batch(7)[:, 1]
    got = hstu_op.relative_bias(hstu_op.bias_index(ts), w_pos, w_time)
    assert torch.equal(got, plain.rel_bias(ts, w_pos, w_time))


def test_the_bias_tables_gradients_are_their_entries_sums():
    """The sorted gather's backward: each entry's gradient is the sum of its
    occurrences' (an f64 ``index_add`` here), to float32's rounding."""
    ts = _batch(12)[:, 1]
    idx = hstu_op.bias_index(ts)
    w_pos = torch.randn(2 * N - 1, requires_grad=True)
    w_time = torch.randn(129, requires_grad=True)
    g = torch.randn(len(LENGTHS), N, N)
    gp, gt = torch.autograd.grad((hstu_op.relative_bias(idx, w_pos, w_time) * g).sum(),
                                 [w_pos, w_time])
    want_t = torch.zeros(129, dtype=torch.float64).index_add_(
        0, idx.time.index.reshape(-1), g.double().reshape(-1))
    want_p = torch.zeros(2 * N - 1, dtype=torch.float64).index_add_(
        0, idx.pos.index.reshape(-1), g.double().sum(0).reshape(-1))
    assert torch.allclose(gt.double(), want_t, rtol=1e-6, atol=1e-6)
    assert torch.allclose(gp.double(), want_p, rtol=1e-6, atol=1e-6)
    assert int(idx.time.bounds[-1]) == g.numel() and int(idx.pos.bounds[0]) == 0


def test_a_scan_chunk_gives_the_eager_steps_bits():
    """On the CPU route a chunk of 3 steps (the last a weight-0 pad step) is
    three ``make_train_step`` steps, bit for bit, given the same seeds."""
    opt = Adam(LR, b1=B1, b2=B2)
    chunk = torch.stack([_batch(8), _batch(9), _batch(10)])
    weights = torch.ones(3, len(LENGTHS))
    weights[2] = 0.0
    a = t_step.init_state(_model(), SCHEMA, None, opt, seed=4)
    b = t_step.init_state(_model(), SCHEMA, None, opt, seed=4)
    scan = t_step.make_scan_train_step(SCHEMA, None, opt)
    step = t_step.make_train_step(SCHEMA, None, opt)
    _, losses = scan(a, chunk, torch.zeros(3, 6), weights, seeds=[1, 2, 3])
    eager = [float(step(b, chunk[i], torch.zeros(6), weights[i], seed=i + 1)[1].loss)
             for i in range(3)]
    assert losses.tolist() == eager and eager[2] == 0.0
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    assert all(torch.equal(x, y) for x, y in zip(a.dense_state.nu, b.dense_state.nu))


def test_the_state_has_a_dense_table_and_no_sparse_optimizer():
    model = _model()
    state = t_step.init_state(model, SCHEMA, None, Adam(LR))
    assert state.sparse_state == () and model.table.requires_grad
    assert t_step.dense_params(model)[0] is model.table
    assert len(state.dense_state.mu) == len(list(model.parameters()))
    from deepctr_torch.optim import SparseAdagrad

    with pytest.raises(ValueError, match="dense table"):
        t_step.init_state(_model(), SCHEMA, SparseAdagrad(0.1), Adam(LR))
    with pytest.raises(ValueError, match="dense table"):
        t_step.init_state(_model(), SCHEMA, None, Adam(LR), table_dtype="bf16")


HSTU_PHASES = (["lookup"] + ["hstu_proj", "hstu_attn", "hstu_proj"] * BLOCKS + ["loss"]
               + ["backward", "hstu_attn_bwd"] * BLOCKS + ["backward", "dense"])


def test_phases_and_counters_of_a_step():
    """On the CPU the step's marks take the host's clock, in the order the
    model's ``phases_a_step`` counts; the counters add each step's valid
    and padded positions (B·N together) and its sampled ids."""
    opt = Adam(LR)
    state = t_step.init_state(_model(), SCHEMA, None, opt)
    step = t_step.make_train_step(SCHEMA, None, opt)
    ids = _batch(11)
    hstu_op.reset_counts()
    prof.enable(True)
    step(state, ids, torch.zeros(6), torch.ones(6))
    marks = [name for name, _ in prof.drain()["marks"]]
    prof.enable(False)
    assert marks == [prof.START] + HSTU_PHASES
    assert len(HSTU_PHASES) == state.model.phases_a_step == 5 * BLOCKS + 4
    c = hstu_op.counts()
    assert c["hstu.TOKENS"] == sum(LENGTHS)
    assert c["hstu.TOKENS"] + c["hstu.PADDED"] == len(LENGTHS) * N
    assert c["hstu.NEGATIVES"] == len(LENGTHS) * (N - 1) * NEG
    step(state, ids, torch.zeros(6), torch.ones(6))   # counted with tracing off too
    assert hstu_op.counts()["hstu.TOKENS"] == 2 * sum(LENGTHS)
    # at the configured widths: 8 blocks mark 44 phases a step
    big = make_hstu(synthetic_hstu.ml20m_schema(10, 4), k=8, heads=1, d_qk=8, d_v=8,
                    device="cpu")
    assert big.phases_a_step == 44


def test_the_ring_takes_a_steps_marks_and_raises_past_them():
    class _Graph:
        pass

    owner = _Graph()
    width = _model().phases_a_step
    ring = prof.PhaseRing(steps=2, device="cpu", owner=owner, phases=width, replays=2)
    ring.stamp(prof.START)
    for i in range(2 * width):
        ring.stamp(f"p{i}")
    with pytest.raises(ValueError, match=f"more than {width} phases a step"):
        ring.stamp("one_more")
    default = prof.PhaseRing(steps=1, device="cpu", owner=owner, replays=2)
    assert default.buf.shape[1] == 1 + prof.PHASES_A_STEP == 9


def test_dlrm_phases_are_unchanged():
    """The ring's width is HSTU's alone: DLRM's step marks the eight it did."""
    from deepctr_torch.data import synthetic_dlrm
    from deepctr_torch.optim import Adagrad, SparseAdagrad

    schema = synthetic_dlrm.mlperf_dlrm_schema(50)
    data = synthetic_dlrm.generate(schema, 16, seed=1)
    model = make_dlrm_dcnv2(schema, embed_dim=8, top=(16, 8), device="cpu")
    sopt, dopt = SparseAdagrad(0.1, mode="dense"), Adagrad(0.05)
    state = t_step.init_state(model, schema, sopt, dopt)
    step = t_step.make_train_step(schema, sopt, dopt)
    prof.enable(True)
    step(state, data.ids, data.labels, np.ones(16, np.float32), dense=data.dense)
    marks = [name for name, _ in prof.drain()["marks"]]
    assert marks == [prof.START, "lookup", "pool", "bottom", "cross", "top", "backward",
                     "sparse", "dense"]
    assert not hasattr(model, "phases_a_step")


def test_cli_trains_hstu(tmp_path, capsys):
    schema_path = tmp_path / "schema.json"
    schema_path.write_text(SCHEMA.to_json())
    res = cli.run(cli.RunConfig.load("configs/hstu_ml20m.json").apply_overrides([
        "model.k=32", "model.hidden=2,2,16", "data.synthetic_examples=200",
        "data.test_fraction=0.2", f"data.schema_path={schema_path}",
        "train.batch_size=16", "train.epochs=2"]), torch.device("cpu"))
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    epochs = [r for r in recs if "epoch" in r]
    assert len(epochs) == 2 and epochs[1]["loss"] < epochs[0]["loss"]
    assert all(0.0 <= r["hr@10"] <= 1.0 and r["eval_users"] == 40 for r in epochs)
    # 160 histories, 10 steps of 16 an epoch: two chunks of 8, the second padded
    assert res["state"].step == 2 * 16
    assert isinstance(res["state"].model, type(_model()))


@pytest.mark.parametrize("override", [
    "train.sharded=true", "train.checkpoint_path=x.ckpt", "train.resume=true",
    "train.pretrain=rbm", "model.init_from=fm.ckpt", "data.train_path=train.yx",
    "data.stream=true", "optim.l2=0.1"])
def test_cli_refuses_what_hstu_does_not_take(override):
    cfg = cli.RunConfig.load("configs/hstu_ml20m.json").apply_overrides([override])
    with pytest.raises(ValueError, match="hstu trains on generated data"):
        cli.run(cfg, torch.device("cpu"))


def test_the_repositorys_config_is_the_sources_ml20m_large():
    cfg = cli.RunConfig.load("configs/hstu_ml20m.json")
    assert (cfg.model.name, cfg.model.k, tuple(cfg.model.hidden), cfg.model.dropout) == \
        ("hstu", 256, (8, 4, 64), 0.2)
    assert (cfg.optim.dense, cfg.optim.dense_lr, cfg.train.batch_size) == ("adam", 1e-3, 128)
    model = cli.build_model(cfg, synthetic_hstu.ml20m_schema(), "meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes["table"] == (26_745, 256) and shapes["pos_emb"] == (200, 256)
    assert shapes["blocks.7.uvqk"] == (256, 1024) and shapes["blocks.7.w_o"] == (256, 256)
    assert shapes["blocks.0.w_pos"] == (399,) and shapes["blocks.0.w_time"] == (129,)
    assert (model.negatives, model.temperature, len(model.blocks)) == (128, 0.05, 8)
