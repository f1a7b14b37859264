"""The harness on the CPU: traffic, arithmetic, the data-driven lookup, the
import rules, and a whole run of each tiny cell on the port's plain path."""

from __future__ import annotations

import ast
import json
import os

import numpy as np
import pytest
import torch

from ctrbench import arith, cells, checks, traffic
from ctrbench.reference import fnn as reference
from ctrbench.run import TraceView, run_cell
from ctrbench.tests import tiny
from ctrbench.weights import initial_table, initial_tower, tower_dims

FORBIDDEN = {"jax", "jaxlib", "flax", "deepctr_tpu"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("tinyroot")))


def _config(root, name):
    with open(os.path.join(root, "ctrbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_traffic_repeats_for_a_seed_and_differs_across_seeds(root):
    cfg = _config(root, "tiny")
    fields = traffic.Fields(cfg)

    def draw(seed):
        sampler = traffic.IdSampler(fields, 1.05, seed, "cpu")
        return traffic.train_chunk(sampler, cfg, seed, 0, 0, 64)

    (a, la), (b, lb), (c, _) = draw(5), draw(5), draw(6)
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert not torch.equal(a, c)
    assert a.shape == (cfg["scan_steps"], 64, fields.num_slots)
    assert int(a.min()) >= 0 and int(a.max()) <= fields.pad_id
    # a field of 3 slots holds 1-3 values packed from its first slot
    usertag = a[..., 2:5].reshape(-1, 3)
    assert bool((usertag[:, 0] != fields.pad_id).all())
    assert traffic.dropout_seeds(5, 8) == traffic.dropout_seeds(5, 8)
    assert traffic.dropout_seeds(5, 8) != traffic.dropout_seeds(6, 8)
    serve = {"pool_requests": 256, "size_median": 512, "size_sigma": 1.0, "size_min": 16,
             "size_max": 8192}
    s5, s6 = traffic.request_sizes(serve, 5), traffic.request_sizes(serve, 6)
    assert s5 == traffic.request_sizes(serve, 5) and s5 != s6
    assert sorted(s5) == sorted(s6)   # every seed serves the same sizes
    assert min(s5) >= 16 and max(s5) <= 8192


def test_zipf_marginal_is_skewed_and_scattered():
    cfg = {"fields": [["f", 1000, 1]]}
    sampler = traffic.IdSampler(traffic.Fields(cfg), 1.05, 3, "cpu")
    ids = sampler.draw(200_000, traffic.generator("cpu", 3, "x"))[:, 0]
    counts = torch.bincount(ids, minlength=1000).double()
    top = counts.argmax()
    assert counts[top] / counts.sum() > 0.1       # rank 1 of Zipf(1.05) over 1000
    assert int(top) == int(sampler.perm[0][0])    # the hot rank, where the permutation put it


def test_flop_arithmetic_at_the_configured_shapes():
    with open(os.path.join(cells.PKG_DIR, "configs", "fnn_ipinyou.json")) as f:
        ip = json.load(f)
    dims = tower_dims(ip)
    assert dims == [176, 200, 300, 100, 1]
    assert arith.tower_fwd_flop(8192, dims) == 2_052_915_200     # 2.053 GFLOP
    assert arith.tower_bwd_flop(8192, dims) == 4_105_830_400     # 4.106 GFLOP
    with open(os.path.join(cells.PKG_DIR, "configs", "fnn_criteo.json")) as f:
        cr = json.load(f)
    dims = tower_dims(cr)
    assert dims == [663, 512, 256, 128, 1]
    # 6 · 8192 · 503,424
    assert arith.tower_fwd_flop(8192, dims) + arith.tower_bwd_flop(8192, dims) == 24_744_296_448
    pk = arith.peak("NVIDIA H100 80GB HBM3")
    assert pk["tf32x3_flops"] == 165e12
    # the forward at iPinYou's shapes is bound by its operations
    nbytes = arith.tower_fwd_bytes(8192, [176, 200, 300, 100, 1])
    bound = arith.bound_s(2_052_915_200, nbytes, pk)
    assert bound == pytest.approx(2_052_915_200 / 165e12)


def test_reference_matches_the_ports_plain_path(root):
    from ctrbench import port

    cfg = _config(root, "tiny")
    fields = traffic.Fields(cfg)
    sampler = traffic.IdSampler(fields, 1.05, 9, "cpu")
    ids = sampler.draw(128, traffic.generator("cpu", 9, "t"))
    table, tower = initial_table(cfg, 9, "cpu"), initial_tower(cfg, 9, "cpu")
    model = port.model(cfg, port.schema(cfg), "cpu")
    port.load_weights(model, table, tower)
    with torch.no_grad():
        rows = model.table[ids].float()
        want = model.apply_rows(rows, (ids != fields.pad_id).float())
    got = reference.serve_logits(cfg, table, tower, ids)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # the reference's dropout mask is the port's, bit for bit
    from deepctr_torch.ops.kernels.mlp import dropout_mask_plain

    for layer in (0, 1):
        assert torch.equal(reference.dropout_mask(64, 24, 0.5, 12345, layer, "cpu"),
                           dropout_mask_plain((64, 24), 0.5, 12345, layer))


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-12, 3.0e38])
    y = reference.tf32_round(x)
    assert y.tolist()[:4] == [1.0, 1.0, 1.0 + 4 * 2**-11, -1.0]
    assert bool((reference.tf32_round(y) == y).all())


@pytest.mark.parametrize("cell", sorted(tiny.TINY))
def test_a_sound_run_is_correct(root, cell):
    line = run_cell(cell, tiny.SEED, 0.5, False, "cpu", root=root)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in cells.load_cell(cell, root).end_to_end}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    json.dumps(line, allow_nan=False)


def test_a_traced_run_reads_what_it_can(root):
    line = run_cell("tiny.train", tiny.SEED, 0.5, True, "cpu", root=root)
    assert line["correct"]
    assert "busy_s" in line["device"] and "window_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU's trace holds no device op: the readers of the kernels find
    # nothing to read and give nothing, never 0
    assert "tower_fwd_roofline.train" not in line["metrics"]


def test_a_cell_added_as_data_is_found(root):
    cell = cells.load_cell("tiny32.train2", root)
    assert cell.chips == 2 and cell.traffic["kind"] == "train_sharded"
    assert [m["name"] for m in cell.end_to_end] == ["train_examples_per_s", "setup_s"]
    assert "train_mfu" in [m["name"] for m in cell.per_layer]
    serve = cells.load_cell("tiny.serve", root)
    assert [m["name"] for m in serve.per_layer] == ["device_idle.serve", "score_device_ms.serve"]


def test_benchmark_json_names_a_file_for_every_piece():
    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"])
        assert cells.runner(cell.traffic["kind"]).run
        assert set(cell.limits) == set(checks.SERVE_NUMBERS if cell.traffic["kind"] == "serve"
                                       else checks.TRAIN_NUMBERS)
    for m in bench["per_layer"]:
        assert cells.metric_reader(m["name"]).read
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(cells.ROOT, c["file"]))


def test_readers_on_a_slice():
    cfg = {"fields": [["a", 10, 1]] * 16, "k": 10, "hidden": [200, 300, 100], "batch": 8192}
    ops = {"void tower_fwd_kernel<64, true>(float const*)": [0.0069 * 8, 8],
           "tower_pack_kernel(Tower, Plan, float*)": [0.0002 * 16, 16],
           "void tower_bwd_rows_kernel<64>(...)": [0.02 * 8, 8],
           "tower_wgrad_kernel(Wgrad)": [0.007 * 8, 8],
           "ncclDevKernel_SendRecv(...)": [0.003, 8]}
    reading = {"ops": ops, "busy_s": 0.09, "window_s": 0.1, "steps": 8, "gaps": {},
               "placed": True, "busy_exact": True}
    view = TraceView(cfg, {}, [reading], arith.peak("NVIDIA H100 80GB HBM3"))
    fwd_ms = 6.9 + 0.2
    bound_ms = 2 * 8192 * 125_300 / 165e12 * 1e3
    got = cells.metric_reader("tower_fwd_roofline.train").read(view)
    assert got == pytest.approx(100 * bound_ms / fwd_ms)
    assert cells.metric_reader("device_idle.train").read(view) == pytest.approx(10.0)
    assert cells.metric_reader("nccl_ms_per_step.train4").read(view) == pytest.approx(0.375)
    mfu = cells.metric_reader("train_mfu").read(view)
    assert mfu == pytest.approx(100 * 8 * 6 * 8192 * 125_300 / 0.1 / 165e12)
    unplaced = TraceView(cfg, {}, [reading, dict(reading, placed=False, busy_exact=False)],
                         view.peak)
    assert cells.metric_reader("device_idle.train").read(unplaced) is None
    empty = TraceView(cfg, {}, [dict(reading, ops={})], view.peak)
    assert cells.metric_reader("tower_bwd_roofline.train").read(empty) is None
    assert cells.metric_reader("train_mfu").read(TraceView(cfg, {}, [reading], None)) is None


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources(top):
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources(cells.PKG_DIR):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(cells.PKG_DIR, "reference")
    # the reference and the harness modules it imports (relatively)
    paths = list(_sources(ref_dir)) + [os.path.join(cells.PKG_DIR, "traffic.py")]
    for path in paths:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN | {"deepctr_torch"}, (path, name)
    with open(os.path.join(ref_dir, "fnn.py")) as f:
        relative = {n.module for n in ast.walk(ast.parse(f.read()))
                    if isinstance(n, ast.ImportFrom) and n.level > 0}
    assert relative == {"traffic"}


def test_serve_number_rejects_a_missing_or_wrong_answer():
    ref = [np.array([0.5, 0.25])]
    assert checks.serve_number([np.array([0.5, 0.25], np.float32)], ref) == 0.0
    assert checks.serve_number([None], ref) == float("inf")
    assert checks.serve_number([np.array([0.5], np.float32)], ref) == float("inf")
    assert checks.serve_number([np.array([0.5, np.nan], np.float32)], ref) == float("inf")


def test_idle_gaps_are_placed_only_where_the_device_times_are():
    from ctrbench import trace

    host = [("cudaGraphLaunch", 0, 100, None), ("cudaEventSynchronize", 100, 1000, None)]
    compute, nccl = (0, 7), (0, 20)
    # a kernel and an NCCL kernel that overlap on two streams count once
    device = [("k1", 0, 400, compute), ("nccl", 200, 500, nccl), ("k2", 600, 1000, compute)]
    r = trace.reduce_events(device, list(host), 1, 1000e-9)
    assert r["placed"] and r["busy_s"] == pytest.approx(900e-9)
    assert r["gaps"] == pytest.approx({"cudaEventSynchronize": 100e-9})
    assert r["ops"]["nccl"] == [pytest.approx(300e-9), 1]
    # one stream's ops squeezed onto each other: not placed; the stream's
    # summed durations are its busy time
    squeezed = [("k1", 0, 400, compute), ("k2", 10, 410, compute), ("k3", 20, 420, compute)]
    r = trace.reduce_events(squeezed, list(host), 1, 2000e-9)
    assert not r["placed"] and r["busy_exact"] and r["busy_s"] == pytest.approx(1200e-9)
    assert r["gaps"] == {trace.NOT_PLACED: pytest.approx(800e-9)}
    # a union longer than the window is not placed either, and a stream
    # busier than the window is a fault
    spread = [("k1", 0, 700, compute), ("k2", 800, 1500, nccl)]
    r = trace.reduce_events(spread, [], 1, 1000e-9)
    assert not r["placed"] and not r["busy_exact"] and r["busy_s"] == pytest.approx(700e-9)
    with pytest.raises(RuntimeError):
        trace.reduce_events(squeezed, [], 1, 1000e-9)
