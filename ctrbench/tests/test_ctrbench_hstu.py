"""The ``train_hstu`` kind on the CPU: its configuration, arithmetic, traffic,
weights and readers, the reference against the port, a whole run of the
tiny HSTU cell, and ``correct``'s teeth there: the control and the faults
read above the real cell's limits, and a run with the program broken
underneath is not correct."""

from __future__ import annotations

import json
import os

import pytest
import torch

from ctrbench import arith, arith_hstu, cells, port_hstu, traffic_hstu, weights_hstu
from ctrbench.calibrate_hstu import SUBSTITUTES, substitute_readings
from ctrbench.reference import hstu as reference
from ctrbench.run import TraceView, run_cell
from ctrbench.tests import tiny_hstu

CELL = tiny_hstu.CELL


@pytest.fixture(autouse=True)
def one_thread():
    held = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(held)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_hstu.make_root(str(tmp_path_factory.mktemp("tinyhstu")))


def _real_config():
    with open(os.path.join(cells.PKG_DIR, "configs", "hstu_ml20m.json")) as f:
        return json.load(f)


def test_the_configuration_is_the_sources_ml20m_large():
    cfg = _real_config()
    assert (cfg["items"], cfg["max_sequence_length"], cfg["item_embedding_dim"],
            cfg["num_blocks"], cfg["num_heads"], cfg["dqk"], cfg["dv"]) == \
        (26_744, 200, 256, 8, 4, 64, 64)
    assert (cfg["num_negatives"], cfg["temperature"], cfg["batch"]) == (128, 0.05, 128)
    assert cfg["reduced"] == [] and cfg["optimizer"]["lr"] == 0.001
    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    entry = next(c for c in bench["configs"] if c["name"] == "hstu_ml20m")
    assert entry["reduced"] == cfg["reduced"] and entry["source"] == cfg["source"]
    names = reference.leaf_names(cfg)
    assert names == [n for n, _ in weights_hstu.leaf_shapes(cfg)] and len(names) == 42


def test_work_at_the_configured_shapes():
    cfg = _real_config()
    lens = torch.tensor([20, 200, 68])
    t, p, s = arith_hstu.work(lens)
    assert (t, p, s) == (288, 210 + 20_100 + 2_346, 285)
    # a block's projections: 256 x 1024 and 256 x 256 a position
    assert arith_hstu.proj_flop(1, cfg) == 8 * 2 * (256 * 1024 + 256 * 256)
    assert arith_hstu.attn_fwd_flop(1, cfg) == 8 * 2 * 4 * 128
    assert arith_hstu.loss_flop(1, cfg) == 2 * 129 * 256
    assert arith_hstu.train_flop(t, p, s, cfg) == 3 * (
        288 * 5_242_880 + 22_656 * 8_192 + 285 * 66_048)
    # bytes a position and block: Q, K, V, U and the output, float32, and
    # the int64 timestamp; the tables once a block
    assert arith_hstu.attn_fwd_bytes(1, cfg) == 8 * (4 * 5 * 256 + 8 + 4 * (399 + 129))
    assert arith_hstu.attn_bwd_bytes(1, cfg) == 8 * (4 * 9 * 256 + 8 + 8 * (399 + 129))
    pk = arith.peak("NVIDIA H100 80GB HBM3")
    # a padded step of 128 full histories: 25,600 positions, 2,572,800 pairs
    full = arith_hstu.work(torch.full((128,), 200))
    assert arith.bound_s(arith_hstu.attn_fwd_flop(full[1], cfg),
                         arith_hstu.attn_fwd_bytes(full[0], cfg), pk) == \
        pytest.approx(arith_hstu.attn_fwd_bytes(25_600, cfg) / 3.35e12)


def test_traffic_lengths_and_histories():
    cfg, tr = _real_config(), json.load(open(os.path.join(cells.PKG_DIR, "traffic",
                                                          "train_seq.json")))
    g = torch.Generator().manual_seed(3)
    lens = traffic_hstu.lengths(20_000, cfg, tr, g, "cpu")
    assert int(lens.min()) == 20 and int(lens.max()) == 200
    capped = float((lens == 200).float().mean())
    assert 0.17 < capped < 0.21            # about a fifth at the cap
    assert 60 <= float(lens.float().median()) <= 76
    small = dict(cfg, items=300, max_sequence_length=24, batch=8, scan_steps=2)
    sampler = traffic_hstu.sampler(small, dict(tr, length_min=2, length_median=9,
                                               length_mean=14), 5, "cpu")
    tr_small = dict(tr, length_min=2, length_median=9, length_mean=14)
    chunk = traffic_hstu.train_chunk(sampler, small, tr_small, 5, 0)
    assert chunk.shape == (2, 8, 2, 24) and chunk.dtype == torch.int64
    again = traffic_hstu.train_chunk(traffic_hstu.sampler(small, tr_small, 5, "cpu"), small,
                                     tr_small, 5, 0)
    assert torch.equal(chunk, again)
    items, ts = chunk[:, :, 0], chunk[:, :, 1]
    live = items != 300
    assert bool(((ts > 0) == live).all())
    assert bool((live[..., :-1] | ~live[..., 1:]).all())           # left-aligned
    assert bool(((ts[..., 1:] >= ts[..., :-1]) | ~live[..., 1:]).all())   # rising


def test_weights_are_made_again_alike():
    cfg = tiny_hstu.tiny_config()
    a, b = (weights_hstu.initial_leaves(cfg, 4, "cpu") for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    shapes = dict(weights_hstu.leaf_shapes(cfg))
    assert [tuple(t.shape) for t in a] == list(shapes.values())
    assert float(a[0][-1].abs().max()) == 0.0                   # the pad row
    big = weights_hstu.initial_leaves(_real_config(), 4, "cpu")
    assert float(big[0][:-1].std()) == pytest.approx(0.02, rel=0.01)
    assert float(big[6].std()) == pytest.approx(0.2, rel=0.1)    # blocks.0.w_pos


def test_reference_matches_the_port():
    """The reference's loss and every gradient against the port's at the tiny
    size, on the harness's weights, dropout and negatives of one seed."""
    cfg, tr = tiny_hstu.tiny_config(), tiny_hstu.tiny_traffic()
    ids = traffic_hstu.train_chunk(traffic_hstu.sampler(cfg, tr, 9, "cpu"), cfg, tr, 9, 0)[0]
    state, _, _ = port_hstu.train_state(cfg, 9, "cpu")
    weights = torch.ones(ids.shape[0])
    loss = state.model.train_loss(ids, weights, 123)
    grads = torch.autograd.grad(loss, list(state.model.parameters()))
    leaves = [p.detach().clone().requires_grad_(True) for p in state.model.parameters()]
    want, wgrads = reference.loss_and_grads(cfg, leaves, ids, weights, 123, block=5)
    assert float(loss.detach()) == pytest.approx(want, rel=2e-5)
    for name, g, w in zip(reference.leaf_names(cfg), grads, wgrads):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max()), name


def test_a_sound_run_is_correct(root):
    line = run_cell(CELL, tiny_hstu.SEED, 0.5, False, "cpu", root=root)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"train_examples_per_s", "setup_s"}
    json.dumps(line, allow_nan=False)


def test_a_traced_run_reads_what_it_can(root):
    line = run_cell(CELL, tiny_hstu.SEED, 0.5, True, "cpu", root=root)
    assert line["correct"]
    names = {m["name"] for m in cells.load_cell(CELL, root).per_layer}
    assert names == {"device_idle.train", "train_mfu.train_seq",
                     "hstu_attn_fwd_roofline.train_seq", "hstu_attn_bwd_roofline.train_seq"}
    # the CPU has no peak and stamps no device phases: their readers give nothing
    assert not names - {"device_idle.train"} & set(line["metrics"])


def test_readers_on_a_slice():
    cfg = _real_config()
    steps = 40
    reading = {"ops": {}, "busy_s": 0.95, "window_s": 1.0, "steps": steps, "gaps": {},
               "placed": True, "busy_exact": True,
               "tokens": steps * 12_000, "pairs": steps * 900_000, "supervised": steps * 11_872,
               "phase_s": {"hstu_attn": steps * 5e-3, "hstu_attn_bwd": steps * 12e-3}}
    pk = arith.peak("NVIDIA H100 80GB HBM3")
    view = TraceView(cfg, {}, [reading], pk)
    read = {m: cells.metric_reader(m).read(view) for m in (
        "train_mfu.train_seq", "hstu_attn_fwd_roofline.train_seq",
        "hstu_attn_bwd_roofline.train_seq")}
    flop = 3 * (12_000 * 8 * 2 * 327_680 + 900_000 * 8 * 1024 + 11_872 * 2 * 129 * 256)
    assert read["train_mfu.train_seq"] == pytest.approx(100 * steps * flop / 165e12)
    fwd_bytes = 8 * (12_000 * (4 * 5 * 256 + 8) + 4 * 528)
    assert read["hstu_attn_fwd_roofline.train_seq"] == pytest.approx(
        100 * fwd_bytes / 3.35e12 / 5e-3)
    bwd_bytes = 8 * (12_000 * (4 * 9 * 256 + 8) + 8 * 528)
    assert read["hstu_attn_bwd_roofline.train_seq"] == pytest.approx(
        100 * bwd_bytes / 3.35e12 / 12e-3)
    bare = TraceView(cfg, {}, [{k: v for k, v in reading.items() if k != "phase_s"}], pk)
    for m in ("hstu_attn_fwd_roofline.train_seq", "hstu_attn_bwd_roofline.train_seq"):
        assert cells.metric_reader(m).read(bare) is None


@pytest.mark.parametrize("substitute", SUBSTITUTES)
def test_control_and_faults_fail_a_limit(root, substitute):
    cell = cells.load_cell(CELL, root)
    numbers, _ = substitute_readings(cell, tiny_hstu.SEED, torch.device("cpu"), substitute)
    assert any(v > cell.limits[k]["limit"] for k, v in numbers.items()), numbers


def _plant(fault: str, patch) -> None:
    from deepctr_torch.ops import hstu
    from deepctr_torch.optim import dense

    if fault == "unchanged":
        patch(dense.Adam, "update", lambda self, *a, **k: None)
    elif fault == "no_bias":
        patch(hstu, "relative_bias", lambda idx, w_pos, w_time:
              0.0 * w_pos[:1] * w_time[:1] + torch.zeros(idx.time.index.shape))
    elif fault == "no_causal":
        patch(hstu, "attention_mask", lambda valid: valid[:, None, None, :].expand(
            -1, 1, valid.shape[1], -1).float())
    elif fault == "half_batch":
        real = hstu.sampled_softmax

        def half(out, table, next_ids, weights, *a):
            keep = weights.clone()
            keep[keep.shape[0] // 2:] = 0.0
            return real(out, table, next_ids, keep, *a)

        patch(hstu, "sampled_softmax", half)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_bias", "no_causal"])
def test_a_broken_program_is_not_correct(root, monkeypatch, fault):
    _plant(fault, monkeypatch.setattr)
    line = run_cell(CELL, tiny_hstu.SEED, 0.3, False, "cpu", root=root)
    assert not line["correct"], line["checks"]
