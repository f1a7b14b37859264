"""The ``train_xdeepfm`` kind on the CPU: its configuration, arithmetic,
weights and readers, the reference against the port's plain path, a whole
run of the tiny xDeepFM cell, and ``correct``'s teeth there: the control
and the faults read above the real cell's limits, and a run with the
program broken underneath is not correct."""

from __future__ import annotations

import json
import os

import pytest
import torch

from ctrbench import arith, arith_xdeepfm, cells, port, port_xdeepfm, traffic
from ctrbench import weights_xdeepfm
from ctrbench.calibrate_xdeepfm import SUBSTITUTES, substitute_readings
from ctrbench.reference import xdeepfm as reference
from ctrbench.run import TraceView, run_cell
from ctrbench.tests import tiny_xdeepfm
from ctrbench.tests.test_ctrbench_faults import _plant

CELL = tiny_xdeepfm.CELL


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_xdeepfm.make_root(str(tmp_path_factory.mktemp("tinyxdeepfm")))


def _real_config():
    with open(os.path.join(cells.PKG_DIR, "configs", "xdeepfm_criteo.json")) as f:
        return json.load(f)


def test_the_configuration_is_the_papers_criteo_one():
    cfg = _real_config()
    with open(os.path.join(cells.PKG_DIR, "configs", "fnn_criteo.json")) as f:
        assert cfg["fields"] == json.load(f)["fields"]
    f = traffic.Fields(cfg)
    assert f.rows == 26_000_833 and f.num_slots == f.num_fields == 39
    assert (cfg["k"], cfg["cin_layer_sizes"], cfg["dnn_hidden"], cfg["batch"]) == \
        (10, [200, 200, 200], [400, 400], 4096)
    assert cfg["reduced"] == ["sparse_optimizer", "l2"]
    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    entry = next(c for c in bench["configs"] if c["name"] == "xdeepfm_criteo")
    assert entry["reduced"] == cfg["reduced"] and entry["source"] == cfg["source"]


def test_work_at_the_configured_shapes():
    cfg = _real_config()
    assert arith_xdeepfm.cin_macs(cfg) == 10 * (200 * 39 * 39 + 2 * 200 * 200 * 39)
    assert arith_xdeepfm.macs(cfg) == 34_242_000 + 390 * 400 + 400 * 400 + 400 + 600
    assert arith_xdeepfm.train_flop(4096, cfg) == 849_321_984_000          # 849.3 GFLOP
    assert arith_xdeepfm.cin_fwd_flop(4096, cfg) == 280_510_464_000        # 280.5 GFLOP
    assert arith_xdeepfm.cin_bwd_flop(4096, cfg) == 2 * 280_510_464_000
    pk = arith.peak("NVIDIA H100 80GB HBM3")
    assert arith_xdeepfm.cin_fwd_flop(4096, cfg) / pk["tf32x3_flops"] == \
        pytest.approx(1.700e-3, rel=1e-3)
    names = reference.leaf_names(cfg)
    assert names[1:] == [n for n, _ in weights_xdeepfm.leaf_shapes(cfg)]
    assert dict(weights_xdeepfm.leaf_shapes(cfg))["cin.1"] == (200 * 39, 200)


def test_weights_are_made_again_alike():
    cfg = dict(tiny_xdeepfm.tiny_config(),
               fields=[["A", 900_000, 1], ["B", 300_000, 1], ["C", 7, 1]])
    rows = weights_xdeepfm.num_rows(cfg)
    assert len(weights_xdeepfm.blocks(cfg)) == 2
    table = torch.empty(rows, 1 + cfg["k"])
    weights_xdeepfm.fill_table(table, cfg, 3)
    assert float(table[-1].abs().max()) == 0.0                      # the pad row
    assert float(table[:-1, 0].std()) == pytest.approx(cfg["linear_sigma"], rel=0.01)
    assert float(table[:-1, 1:].std()) == pytest.approx(cfg["factor_sigma"], rel=0.01)
    ids = torch.tensor([0, 5, 1_048_575, 1_048_576, rows - 1])
    assert torch.equal(weights_xdeepfm.table_rows(cfg, 3, "cpu", ids), table[ids])
    a, b = (weights_xdeepfm.initial_dense(cfg, 4, "cpu") for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_reference_matches_the_ports_plain_path():
    cfg = tiny_xdeepfm.tiny_config()
    f = traffic.Fields(cfg)
    sampler = traffic.IdSampler(f, 1.05, 9, "cpu")
    ids, _ = traffic.train_chunk(sampler, cfg, 9, 0, 0, cfg["batch"])
    ids = ids[0]
    state, _, _ = port_xdeepfm.train_state(cfg, port.schema(cfg), 9, "cpu")
    with torch.no_grad():
        rows = state.model.table[ids]
        mask = (ids != f.pad_id).float()
        want = state.model.apply_rows(rows, mask)
    got = reference.logits(cfg, rows, mask, weights_xdeepfm.initial_dense(cfg, 9, "cpu"),
                           reference.slot_fields(cfg))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_a_sound_run_is_correct(root):
    line = run_cell(CELL, tiny_xdeepfm.SEED, 0.5, False, "cpu", root=root)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"train_examples_per_s", "setup_s"}
    json.dumps(line, allow_nan=False)


def test_a_traced_run_reads_what_it_can(root):
    line = run_cell(CELL, tiny_xdeepfm.SEED, 0.5, True, "cpu", root=root)
    assert line["correct"]
    names = {m["name"] for m in cells.load_cell(CELL, root).per_layer}
    assert names == {"device_idle.train", "cin_fwd_roofline.train_cin",
                     "cin_bwd_roofline.train_cin", "train_mfu.train_cin",
                     "sparse_roofline.train_cin"}
    # the CPU stamps no device phases: their readers give nothing, never 0
    assert not {"cin_fwd_roofline.train_cin", "cin_bwd_roofline.train_cin",
                "sparse_roofline.train_cin"} & set(line["metrics"])


def test_readers_on_a_slice():
    cfg = _real_config()
    reading = {"ops": {}, "busy_s": 0.95, "window_s": 1.0, "steps": 40, "gaps": {},
               "placed": True, "busy_exact": True, "distinct_rows": 40 * 60_000,
               "phase_s": {"lookup": 40 * 0.2e-3, "cin": 40 * 7e-3, "cin_bwd": 40 * 14e-3,
                           "sparse": 40 * 0.1e-3}}
    view = TraceView(cfg, {}, [reading], arith.peak("NVIDIA H100 80GB HBM3"))
    read = {m: cells.metric_reader(m).read(view) for m in (
        "train_mfu.train_cin", "cin_fwd_roofline.train_cin", "cin_bwd_roofline.train_cin",
        "sparse_roofline.train_cin")}
    assert read["train_mfu.train_cin"] == pytest.approx(100 * 40 * 849_321_984_000 / 165e12)
    assert read["cin_fwd_roofline.train_cin"] == pytest.approx(
        100 * 280_510_464_000 / 165e12 / 7e-3)
    assert read["cin_bwd_roofline.train_cin"] == pytest.approx(
        100 * 561_020_928_000 / 165e12 / 14e-3)
    # 159,744 int64 ids and f32 rows of 11 read; 60,000 rows of table and
    # accumulator read and written
    assert arith_xdeepfm.occurrences(4096, cfg) == 159_744
    assert read["sparse_roofline.train_cin"] == pytest.approx(
        100 * (8 * 159_744 + 44 * 159_744 + 60_000 * 176) / 3.35e12 / 0.1e-3)
    bare = TraceView(cfg, {}, [{k: v for k, v in reading.items() if k != "phase_s"}],
                     view.peak)
    for m in ("cin_fwd_roofline.train_cin", "cin_bwd_roofline.train_cin",
              "sparse_roofline.train_cin"):
        assert cells.metric_reader(m).read(bare) is None


@pytest.mark.parametrize("substitute", SUBSTITUTES)
def test_control_and_faults_fail_a_limit(root, substitute):
    cell = cells.load_cell(CELL, root)
    numbers, _ = substitute_readings(cell, tiny_xdeepfm.SEED, torch.device("cpu"), substitute)
    assert any(v > cell.limits[k]["limit"] for k, v in numbers.items()), numbers


def _plant_xdeepfm(fault: str, patch) -> None:
    from deepctr_torch.ops import cin
    from deepctr_torch.optim import dense, sparse

    if fault == "unchanged":
        patch(sparse.SparseAdagrad, "update", lambda self, *a, **k: None)
        patch(dense.Adam, "update", lambda self, *a, **k: None)
    elif fault == "cin_no_x0":
        real = cin.outer
        patch(cin, "outer", lambda x, x0: real(x, torch.ones_like(x0)))
    else:
        _plant(fault, patch)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "sparse_lr", "sparse_acc",
                                   "cin_no_x0"])
def test_a_broken_program_is_not_correct(root, monkeypatch, fault):
    _plant_xdeepfm(fault, monkeypatch.setattr)
    line = run_cell(CELL, tiny_xdeepfm.SEED, 0.3, False, "cpu", root=root)
    assert not line["correct"], line["checks"]
