"""The ``train_dlrm`` kind on the CPU: its traffic, weights, arithmetic and
readers, the reference against the port's plain path, a whole run of the
tiny DLRM cell, and ``correct``'s teeth there: the control and the faults
read above the real cell's limits, and a run with the program broken
underneath is not correct."""

from __future__ import annotations

import json
import os

import pytest
import torch

from ctrbench import arith, arith_dlrm, cells, traffic, traffic_dlrm
from ctrbench import weights_dlrm
from ctrbench.calibrate_dlrm import SUBSTITUTES, substitute_readings
from ctrbench.reference import dlrm_dcnv2 as reference
from ctrbench.run import TraceView, run_cell
from ctrbench.tests import tiny_dlrm
from ctrbench.tests.test_ctrbench_faults import _plant

CELL = tiny_dlrm.CELL


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_dlrm.make_root(str(tmp_path_factory.mktemp("tinydlrm")))


def _real_config():
    with open(os.path.join(cells.PKG_DIR, "configs", "dlrm_dcnv2_criteo.json")) as f:
        return json.load(f)


def test_the_configuration_is_one_gpus_share_of_mlperfs():
    cfg = _real_config()
    f = traffic_dlrm.fields(cfg)
    assert f.vocab == 26_500_127 and f.num_slots == 214 and f.num_fields == 26
    assert sum(cfg["published_num_embeddings_per_feature"]) == 204_184_588
    for cut, full in zip(cfg["num_embeddings_per_feature"],
                         cfg["published_num_embeddings_per_feature"]):
        assert cut == (full if full <= 1_000_000 else -(-full // 8))
    assert cfg["batch"] * cfg["gpus"] == cfg["global_batch_size"]
    assert cfg["reduced"] == ["num_embeddings_per_feature", "sparse_optimizer",
                             "dense_optimizer"]


def test_work_at_the_configured_shapes():
    cfg = _real_config()
    assert arith_dlrm.macs(cfg) == 16_030_464
    assert arith_dlrm.cross_macs(cfg) == 10_616_832
    assert arith_dlrm.train_flop(8192, cfg) == 787_929_366_528          # 788 GFLOP
    assert arith_dlrm.cross_fwd_flop(8192, cfg) == 173_946_175_488      # 174 GFLOP
    assert arith_dlrm.occurrences(8192, cfg) == 1_753_088
    assert arith_dlrm.pool_bytes(8192, cfg) == (8 * 1_753_088 + 512 * 1_753_088
                                                + 4 * 8192 * 26 * 128)   # 1.02 GB
    pk = arith.peak("NVIDIA H100 80GB HBM3")
    bound = arith.bound_s(arith_dlrm.cross_fwd_flop(8192, cfg),
                          arith_dlrm.cross_fwd_bytes(8192, cfg), pk)
    assert bound == pytest.approx(1.0542e-3, rel=1e-3)
    assert arith_dlrm.sparse_bytes(10, 4, cfg) == 80 + 40 * 128 + 4 * 128 * 16
    names = reference.leaf_names(cfg)
    assert len(names) == 1 + 3 * 2 + 3 * 3 + 5 * 2
    assert [n for n, _ in weights_dlrm.leaf_shapes(cfg)] == names[1:]


def test_traffic_fills_every_slot_and_repeats_for_a_seed(root):
    cfg = tiny_dlrm.tiny_config()
    tr = {"zipf_alpha": 1.05, "dense_log_mean": 1.0, "dense_log_sigma": 1.5}
    f = traffic_dlrm.fields(cfg)

    def draw(seed):
        sampler = traffic.IdSampler(f, 1.05, seed, "cpu")
        return traffic_dlrm.train_chunk(sampler, cfg, tr, seed, 0)

    (a, la, da), (b, lb, db), (c, _, _) = draw(5), draw(5), draw(6)
    assert torch.equal(a, b) and torch.equal(la, lb) and torch.equal(da, db)
    assert not torch.equal(a, c)
    assert a.shape == (cfg["scan_steps"], cfg["batch"], f.num_slots)
    field = torch.searchsorted(torch.tensor(f.offsets[1:]), a, right=True)
    assert torch.equal(field, torch.tensor(f.slot_field).expand_as(field))  # no pad slot
    assert da.shape[-1] == 13 and float(da.min()) >= 0 and bool((da == da.floor()).all())


def test_table_blocks_are_made_again_alike():
    cfg = dict(tiny_dlrm.tiny_config(), num_embeddings_per_feature=[900_000, 300_000, 7],
               published_num_embeddings_per_feature=[7_200_000, 300_000, 7])
    rows = weights_dlrm.num_rows(cfg)
    assert len(weights_dlrm.blocks(cfg)) == 2
    table = torch.empty(rows, cfg["embedding_dim"])
    weights_dlrm.fill_table(table, cfg, 3)
    assert float(table[-1].abs().max()) == 0.0                      # the pad row
    assert float(table[:900_000].abs().max()) <= (1 / 7_200_000) ** 0.5
    assert float(table[900_000:1_200_000].abs().max()) > (1 / 7_200_000) ** 0.5
    ids = torch.tensor([0, 5, 1_048_575, 1_048_576, rows - 1])
    assert torch.equal(weights_dlrm.table_rows(cfg, 3, "cpu", ids), table[ids])


def test_reference_matches_the_ports_plain_path():
    from ctrbench import port_dlrm

    cfg = tiny_dlrm.tiny_config()
    f = traffic_dlrm.fields(cfg)
    sampler = traffic.IdSampler(f, 1.05, 9, "cpu")
    ids, _, dense = traffic_dlrm.train_chunk(sampler, cfg, {"dense_log_mean": 1.0,
                                                            "dense_log_sigma": 1.5}, 9, 0)
    ids, dense = ids[0], dense[0]
    sch = port_dlrm.schema(cfg)
    state, _, _ = port_dlrm.train_state(cfg, sch, 9, "cpu")
    with torch.no_grad():
        rows = state.model.table[ids]
        mask = (ids != f.pad_id).float()
        want = state.model.apply_rows(rows, mask, dense=dense)
    got = reference.logits(cfg, rows, mask, dense, weights_dlrm.initial_dense(cfg, 9, "cpu"),
                           reference.slot_fields(cfg))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_a_sound_run_is_correct(root):
    line = run_cell(CELL, tiny_dlrm.SEED, 0.5, False, "cpu", root=root)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"train_examples_per_s", "setup_s"}
    json.dumps(line, allow_nan=False)


def test_a_traced_run_reads_what_it_can(root):
    line = run_cell(CELL, tiny_dlrm.SEED, 0.5, True, "cpu", root=root)
    assert line["correct"]
    names = {m["name"] for m in cells.load_cell(CELL, root).per_layer}
    assert names == {"device_idle.train", "train_mfu.train_multihot",
                     "cross_fwd_roofline.train_multihot", "pool_roofline.train_multihot",
                     "sparse_roofline.train_multihot"}
    # the CPU stamps no device phases: their readers give nothing, never 0
    assert not {"cross_fwd_roofline.train_multihot", "pool_roofline.train_multihot",
                "sparse_roofline.train_multihot"} & set(line["metrics"])


def test_readers_on_a_slice():
    cfg = _real_config()
    reading = {"ops": {}, "busy_s": 0.95, "window_s": 1.0, "steps": 64, "gaps": {},
               "placed": True, "busy_exact": True, "distinct_rows": 64 * 700_000,
               "phase_s": {"lookup": 64 * 0.5e-3, "pool": 64 * 1.0e-3,
                           "cross": 64 * 3.5e-3, "sparse": 64 * 2e-3}}
    view = TraceView(cfg, {}, [reading], arith.peak("NVIDIA H100 80GB HBM3"))
    read = {m: cells.metric_reader(m).read(view) for m in (
        "train_mfu.train_multihot", "cross_fwd_roofline.train_multihot",
        "pool_roofline.train_multihot", "sparse_roofline.train_multihot")}
    assert read["train_mfu.train_multihot"] == pytest.approx(
        100 * 64 * 787_929_366_528 / 1.0 / 165e12)
    assert read["cross_fwd_roofline.train_multihot"] == pytest.approx(
        100 * 173_946_175_488 / 165e12 / 3.5e-3)
    assert read["pool_roofline.train_multihot"] == pytest.approx(
        100 * arith_dlrm.pool_bytes(8192, cfg) / 3.35e12 / 1.5e-3)
    assert read["sparse_roofline.train_multihot"] == pytest.approx(
        100 * arith_dlrm.sparse_bytes(1_753_088, 700_000, cfg) / 3.35e12 / 2e-3)
    bare = TraceView(cfg, {}, [{k: v for k, v in reading.items() if k != "phase_s"}],
                     view.peak)
    for m in ("cross_fwd_roofline.train_multihot", "pool_roofline.train_multihot",
              "sparse_roofline.train_multihot"):
        assert cells.metric_reader(m).read(bare) is None


@pytest.mark.parametrize("substitute", SUBSTITUTES)
def test_control_and_faults_fail_a_limit(root, substitute):
    cell = cells.load_cell(CELL, root)
    numbers, _ = substitute_readings(cell, tiny_dlrm.SEED, torch.device("cpu"), substitute)
    assert any(v > cell.limits[k]["limit"] for k, v in numbers.items()), numbers


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "sparse_lr", "sparse_acc"])
def test_a_broken_program_is_not_correct(root, monkeypatch, fault):
    _plant(fault, monkeypatch.setattr)
    line = run_cell(CELL, tiny_dlrm.SEED, 0.3, False, "cpu", root=root)
    assert not line["correct"], line["checks"]
