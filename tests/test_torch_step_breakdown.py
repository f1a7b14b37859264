"""The speed-of-light audit of the full-vocab FNN step,
``deepctr_torch/tools/step_breakdown.py``, on the CPU.

- ``full``, ``no_sparse`` and ``fwd_only`` against the reference's own
  variants, ``tools/bench_step_breakdown.py::build`` run by JAX (with a
  split plan: two fields one-hot, two gathered), from the same initial
  values (``utils/checkpoint.py::params_from_jax``) over K = 3 batches:
  losses, the table, the Adagrad accumulator and every dense leaf, at
  ``tests/test_torch_train.py``'s tolerance;
- the tool's gates pass on its own variants and each fails on a fault made
  for it: a ``fwd_only`` or ``fwd_bwd_no_update`` that writes one table row
  or one dense leaf, a ``no_sparse`` that moves the accumulator, a first
  loss one ulp off, a ``full`` unlike ``make_scan_train_step``, a plain
  tower off its tolerance, launches off the prediction;
- every variant's body goes through the graph route's warm-up
  (``train/step.py::_warm_up``), which must put back every bit, the
  variants that write nothing included: on the card each capture starts so;
- the byte and FLOP counts against a hand count at a small shape, and the
  tower's at [8192, 176] against PERF.md §6's 2.05 and 6.16 GFLOP;
- the composite bound, the attribution, H10's table and the op map on
  given numbers;
- ``main(["--device", "cpu", "--small", ...])`` end to end: the file names
  the CPU and says "not measured (cpu)" under every time; without a card
  ``--device cuda`` raises and writes nothing;
- ``ROOFLINE_TORCH.json``, the tool's run on the card: every gate of both
  tables passed, the launches as predicted, every part and the quality
  check present (its stamp: ``tests/test_torch_artifacts.py``).
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepctr_torch.data import make_schema as t_make_schema
from deepctr_torch.models import MlpSpec as TMlpSpec
from deepctr_torch.models import make_fnn as t_make_fnn
from deepctr_torch.optim import make_dense_optimizer
from deepctr_torch.optim import sparse as t_sparse
from deepctr_torch.tools import step_breakdown as sb
from deepctr_torch.tools import bench_suite
from deepctr_torch.train import init_state as t_init_state
from deepctr_torch.train import step as t_step
from deepctr_torch.utils import checkpoint as t_ckpt
from deepctr_tpu.data import make_schema, synthetic
from deepctr_tpu.models import MlpSpec, make_fnn
from deepctr_tpu.ops.split_embed import make_split_plan
from deepctr_tpu.optim import SparseAdagrad
from deepctr_tpu.train import init_state as j_init_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 on both sides; sums are taken in other orders (tests/test_torch_train.py)
RTOL, ATOL = 1e-4, 1e-5
FIELDS = [("a", 4), ("b", 8), ("c", 16), ("tags", 10, 3)]
SPLIT_THRESHOLD = 9   # a and b one-hot, c and tags gathered (test_torch_train.py)
K, HIDDEN, BATCH, STEPS = 3, (16,), 64, 3


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # the suite's workers share the CPUs
    yield
    torch.set_num_threads(threads)


def _reference_build():
    """``tools/bench_step_breakdown.py::build``, imported from its file."""
    path = os.path.join(ROOT, "tools", "bench_step_breakdown.py")
    spec = importlib.util.spec_from_file_location("bench_step_breakdown", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build


@pytest.mark.parametrize("variant", ["full", "no_sparse", "fwd_only"])
def test_variant_matches_reference_build(variant):
    schema = make_schema(FIELDS)
    data = synthetic.generate(schema, num_examples=STEPS * BATCH, k=K, seed=7)
    ids = data.ids.reshape(STEPS, BATCH, -1)
    labels = data.labels.reshape(STEPS, BATCH)
    weights = np.ones((STEPS, BATCH), np.float32)

    jmodel = make_fnn(schema, k=K, mlp=MlpSpec(hidden=HIDDEN, dropout=0.0))
    jsopt, jdopt = SparseAdagrad(0.05), optax.adagrad(0.02)
    jstate = j_init_state(jmodel, schema, jsopt, jdopt, seed=0)
    fn = _reference_build()(variant, jmodel, schema, jsopt, jdopt,
                            make_split_plan(schema, SPLIT_THRESHOLD))
    jstate2, jlosses = fn(jstate, jnp.asarray(ids), jnp.asarray(labels),
                          jnp.asarray(weights))

    tschema = t_make_schema(FIELDS)
    sopt, dopt = t_sparse.SparseAdagrad(0.05), make_dense_optimizer("adagrad", 0.02)
    model = t_make_fnn(tschema, k=K, mlp=TMlpSpec(hidden=HIDDEN, dropout=0.0),
                       device="cpu")
    state = t_init_state(model, tschema, sopt, dopt, seed=0)
    model.load_state_dict(t_ckpt.params_from_jax(np.asarray(jstate.table),
                                                 jstate.dense))
    route = sb.variant_route(variant, tschema, sopt, dopt)
    state, losses, _ = route(state, torch.from_numpy(ids).long(),
                             torch.from_numpy(labels), torch.from_numpy(weights))

    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(state.table.numpy(), np.asarray(jstate2.table),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(state.sparse_state.acc.numpy(),
                               np.asarray(jstate2.sparse_state.acc), rtol=RTOL, atol=ATOL)
    _, _, dense_p, dense_s = t_ckpt._state_leaves(state)
    import jax

    want = jax.tree_util.tree_leaves((jstate2.dense, jstate2.dense_state))
    got = [*dense_p, *dense_s]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    if variant == "fwd_only":   # nothing moved
        np.testing.assert_array_equal(np.asarray(jstate2.table), np.asarray(jstate.table))


# ---- the gates ---------------------------------------------------------------


def _small_run(monkeypatch=None, broken=None):
    """:func:`run_variants` on a small headline (dropout 0.5, f32 table),
    with ``broken = (variant, fault)`` wrapping that variant's body."""
    if broken is not None:
        real = sb.variant_body
        name, fault = broken

        def patched(variant, schema, sparse_opt, dense_opt):
            body = real(variant, schema, sparse_opt, dense_opt)
            if variant != name:
                return body

            def wrapped(state, ids, labels, weights, lr_scale, seed, dense=None):
                loss, logits = body(state, ids, labels, weights, lr_scale, seed, dense)
                return fault(state, ids, loss), logits

            return wrapped

        monkeypatch.setattr(sb, "variant_body", patched)
    schema = t_make_schema([("a", 40), ("b", 300), ("tags", 200, 3)])
    data = synthetic.generate(make_schema([("a", 40), ("b", 300), ("tags", 200, 3)]),
                              num_examples=sb.CHUNKS * sb.SCAN_K * 32, k=2, seed=5)
    h = bench_suite.build(schema, "cpu", table_dtype="f32", k=3, hidden=(8,))
    chunks = bench_suite.stage(data.ids, data.labels, 32, sb.CHUNKS * sb.SCAN_K, "cpu")
    return sb.run_variants(h, schema, chunks, torch.device("cpu"))


@pytest.fixture(scope="module")
def records():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _small_run()
    finally:
        torch.set_num_threads(threads)


def _failed(gates) -> list[str]:
    return [g["gate"] for g in gates if not g["ok"]]


def test_gates_pass_on_the_variants(records):
    gates = sb.check_gates(records, cuda=False)
    assert len(gates) == 11 and not _failed(gates), gates
    sb.raise_failed(gates)
    assert records["full"]["equals_scan_step"]
    assert all(records["fwd_only"]["kept"].values())
    assert not records["full"]["kept"]["table"]   # full trains


def _write_row(state, ids, loss):
    with torch.no_grad():
        state.model.table.data[ids[0, 0]] += 1e-3
    return loss


def _move_dense(state, ids, loss):
    with torch.no_grad():
        t_step.dense_params(state.model)[0].data.view(-1)[0] += 1e-3
    return loss


def _move_acc(state, ids, loss):
    with torch.no_grad():
        state.sparse_state.acc[ids[0, 0]] += 1e-3
    return loss


@pytest.mark.parametrize("variant,fault,gate", [
    ("fwd_only", _write_row, "fwd_only keeps the bits of table, acc, dense"),
    ("fwd_bwd_no_update", _move_dense,
     "fwd_bwd_no_update keeps the bits of table, acc, dense"),
    ("no_sparse", _move_acc, "no_sparse keeps the bits of table, acc"),
    ("fwd_only", lambda state, ids, loss: loss + 1e-6,
     "first-step loss bit for bit: full, no_sparse, fwd_bwd_no_update, fwd_only"),
], ids=["fwd_only-table", "fwd_bwd_no_update-dense", "no_sparse-acc", "first-loss"])
def test_gate_catches_a_fault(monkeypatch, variant, fault, gate):
    gates = sb.check_gates(_small_run(monkeypatch, (variant, fault)), cuda=False)
    assert _failed(gates) == [gate], gates
    with pytest.raises(sb.GateError, match=gate.split(":")[0]):
        sb.raise_failed(gates)


def test_gate_catches_full_unlike_the_scan_step(monkeypatch):
    """``full`` with a learning rate one ulp over the scan step's."""
    real = sb.variant_body

    def patched(variant, schema, sparse_opt, dense_opt):
        if variant == "full":
            sparse_opt = t_sparse.SparseAdagrad(np.nextafter(np.float32(0.05), 1.0))
        return real(variant, schema, sparse_opt, dense_opt)

    monkeypatch.setattr(sb, "variant_body", patched)
    gates = sb.check_gates(_small_run(), cuda=False)
    assert _failed(gates) == ["full's chunk equals make_scan_train_step's bit for bit"]


def _with(records, name, **changes):
    out = {k: dict(v) for k, v in records.items()}
    out[name].update(changes)
    return out


def test_gate_catches_a_plain_tower_off_its_tolerance(records):
    loss = records["full"]["first_loss"]
    inside = _with(records, "full_plain_tower", first_loss=loss + 0.5 * sb.PLAIN_ATOL)
    assert not _failed(sb.check_gates(inside, cuda=False))
    off = _with(records, "full_plain_tower",
                first_loss=loss + 2 * (sb.PLAIN_ATOL + sb.PLAIN_RTOL * abs(loss)))
    assert [g.split(" within")[0] for g in _failed(sb.check_gates(off, cuda=False))] == [
        "full_plain_tower's first loss"]


@pytest.mark.parametrize("name,launches", [
    ("full", {"fwd_dropout": 8, "fwd": 0, "bwd": 7}),
    ("fwd_only", {"fwd_dropout": 8, "fwd": 0, "bwd": 8}),
    ("full_plain_tower", {"fwd_dropout": 8, "fwd": 0, "bwd": 8}),
])
def test_gate_catches_launches_off_the_prediction(records, name, launches):
    """On the card: 8 forwards with dropout and 8 backwards a replay, none
    backward for ``fwd_only``, nothing for the plain tower."""
    cuda = {n: dict(r, launches=sb.predicted_launches(n, True)) for n, r in records.items()}
    assert not _failed(sb.check_gates(cuda, cuda=True))
    bad = _with(cuda, name, launches=launches)
    assert _failed(sb.check_gates(bad, cuda=True)) == [
        f"{name}: tower launches a replay as predicted"]
    assert sb.predicted_launches("fwd_only", True) == {"fwd_dropout": 8, "fwd": 0, "bwd": 0}


@pytest.mark.parametrize("variant", sb.VARIANTS)
def test_warm_up_puts_back_every_variant(variant):
    """The capture's warm-up step runs each variant's body on the state
    and puts back every bit, for bodies that write nothing as for those
    that write: the state after equals a clone taken before."""
    schema = t_make_schema([("a", 40), ("b", 300), ("tags", 200, 3)])
    data = synthetic.generate(make_schema([("a", 40), ("b", 300), ("tags", 200, 3)]),
                              num_examples=32, k=2, seed=5)
    h = bench_suite.build(schema, "cpu", table_dtype="bf16", k=3, hidden=(8,))
    step = t_step.make_train_step(schema, h.sparse_opt, h.dense_opt)
    step(h.state, data.ids, data.labels, np.ones(32, np.float32))  # not the init
    before = h.state.clone()
    ids = torch.from_numpy(data.ids).long()
    body = sb.variant_body(variant, schema, h.sparse_opt, h.dense_opt)
    kept = t_step._warm_up(body, h.state, ids, torch.from_numpy(data.labels),
                           torch.ones(32), 1.0, 123, t_step.touched_rows(ids, schema.pad_id))
    assert all(sb.kept_parts(h.state, before).values())
    assert h.state.step == before.step
    assert kept > 0


# ---- counts, bounds, attribution ---------------------------------------------


def test_tower_counts_equal_perf_md():
    fwd, bwd = sb.tower_flop(8192, (176, 200, 300, 100, 1))
    assert (fwd, bwd) == (2_052_915_200, 6_157_107_200)
    assert round(fwd / 1e9, 2) == 2.05 and round(bwd / 1e9, 2) == 6.16
    assert sb.tower_params((176, 200, 300, 100, 1)) == 125_901


def test_component_counts_against_a_hand_count():
    """B = 4, S = 3 (M = 12 occurrences), D = 2, V = 10 rows, U = 5
    distinct ids, a bf16 table (2 bytes), tower 6-4-1."""
    shape = dict(batch=4, slots=3, d=2, vocab=10, unique=5, table_bytes=2, dims=(6, 4, 1))
    work = {n: sb.component_work(n, **shape) for n in sb.COMPONENTS}
    # ids 12 x 8 = 96; occurrence rows 12 x 2 x 4 = 96; table rows 5 x 2 x 2 = 20
    assert work["gather"] == {"bytes": 96 + 20 + 96, "flop": 0, "peak_flops": sb.F32_FLOPS}
    # G [10, 2] f32 written: 80
    assert work["scatter_dense"]["bytes"] == 96 + 96 + 80
    assert work["scatter_dense"]["flop"] == 24
    # table 10 x 2 x 2 = 40 and accumulator 80, each read and written
    assert work["adagrad_dense"]["bytes"] == 96 + 96 + 2 * (40 + 80)
    assert work["adagrad_dense"]["flop"] == 24 + 7 * 20
    # five rows of table (20) and accumulator (40), read and written
    assert work["adagrad_sorted"]["bytes"] == 96 + 96 + 2 * (20 + 40)
    assert work["adagrad_sorted"]["flop"] == 24 + 7 * 10
    # on the card the dense-mode kernel touches those five rows alone
    assert sb.component_work("adagrad_dense", **shape, cuda=True) == work["adagrad_sorted"]
    # params 6x4 + 4 + 4x1 + 1 = 33; x 4 x 6, g and logits 4 each
    assert work["tower_fwdbwd"] == {
        "bytes": 4 * (2 * 24 + 2 * 33 + 2 * 4),
        "flop": 2 * 4 * 28 + 2 * 4 * (24 + 2 * 28), "peak_flops": sb.TF32X3_FLOPS}
    assert work["dense_adagrad"] == {"bytes": 4 * 5 * 33, "flop": 8 * 33,
                                     "peak_flops": sb.F32_FLOPS}
    assert work["dropout_mask_plain"]["bytes"] == 4 * 4 * 4
    b = sb.bound({"bytes": 3.35e9, "flop": 67e9, "peak_flops": sb.F32_FLOPS})
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "bytes"
    b = sb.bound({"bytes": 0, "flop": 165e9, "peak_flops": sb.TF32X3_FLOPS})
    assert b == {"bound_ms": pytest.approx(1.0), "bound_by": "operations"}


def _measured(ms: dict) -> dict:
    return {n: {"ms": v, "bound_ms": v / 2} for n, v in ms.items()}


def test_roofline_attribution_on_given_numbers():
    variants = {n: {"device_ms": v} for n, v in (
        ("full", 1.2), ("no_sparse", 0.8), ("fwd_bwd_no_update", 0.7), ("fwd_only", 0.3),
        ("full_plain_tower", 4.0))}
    comps = _measured({"gather": 0.1, "scatter_dense": 0.2, "adagrad_dense": 0.3,
                       "adagrad_sorted": 0.5, "tower_fwdbwd": 0.4, "dense_adagrad": 0.05,
                       "dropout_mask_plain": 1.5})
    r = sb.roofline(variants, comps, cuda=True)
    assert r["composite_bound_ms"] == pytest.approx(0.425)
    assert r["components_ms"] == pytest.approx(0.85)
    assert r["share"] == pytest.approx(0.425 / 1.2)
    assert r["residual_ms"] == pytest.approx(0.35)
    assert list(r["pieces"].values()) == pytest.approx([0.3, 0.4, 0.1, 0.4])
    assert r["kernels_gain_ms"] == pytest.approx(2.8)
    assert r["kernels_gain_without_mask_ms"] == pytest.approx(1.3)
    assert r["plain_tower_without_mask_ms"] == pytest.approx(2.5)


def test_h10_names_the_pieces_and_ops_that_take_the_extra_time():
    f32 = {"full": 1.23, "no_sparse": 0.56, "fwd_bwd_no_update": 0.48, "fwd_only": 0.17,
           "full_plain_tower": 1.9}
    bf16 = {"full": 1.27, "no_sparse": 0.57, "fwd_bwd_no_update": 0.49, "fwd_only": 0.17,
            "full_plain_tower": 1.95}
    res = {"variants": {"f32": {n: {"device_ms": v} for n, v in f32.items()},
                        "bf16": {n: {"device_ms": v} for n, v in bf16.items()}},
           "components": {"f32": _measured({n: 0.1 for n in sb.COMPONENTS}),
                          "bf16": _measured({n: 0.1 for n in sb.COMPONENTS})},
           "roofline": {},
           "turns": {"f32": {"device_ms": [1.22, 1.24, 1.23], "median": 1.23, "min": 1.22,
                             "max": 1.24},
                     "bf16": {"device_ms": [1.26, 1.27, 1.28], "median": 1.27, "min": 1.26,
                              "max": 1.28}},
           "ops_diff": sb.ops_diff({
               "f32": [{"name": "memcpy", "us_per_step": 40.0, "component": "c"},
                       {"name": "add", "us_per_step": 80.0, "component": "a"}],
               "bf16": [{"name": "copy_kernel", "us_per_step": 70.0, "component": "c"},
                        {"name": "add", "us_per_step": 81.0, "component": "a"}]})}
    for d in sb.TABLE_DTYPES:
        res["roofline"][d] = sb.roofline(res["variants"][d], res["components"][d], True)
    rows, text = sb.h10_rows(res)
    assert [r["name"] for r in rows][:5] == ["full step"] + [p[0] for p in sb.PIECES]
    assert len(rows) == 5 + len(sb.COMPONENTS) + 1
    assert rows[0]["delta"] == pytest.approx(0.04)
    assert rows[4]["delta"] == pytest.approx(0.03)   # the sparse update
    assert rows[-1]["name"] == "full step in turns (median)"
    assert text.startswith("In turns (3 passes each), the bf16 step takes +0.0400 ms")
    assert "more than the larger range, 0.0200 ms" in text
    assert "by piece sparse update +0.0300, " in text
    assert [d["name"] for d in res["ops_diff"]] == ["copy_kernel", "memcpy", "add"]
    assert "`copy_kernel` (c) +70.00, `memcpy` (c) -40.00, `add` (a) +1.00" in text
    res["turns"]["bf16"].update(median=1.235, min=1.22, max=1.25)
    assert "within the larger range, 0.0300 ms" in sb.h10_rows(res)[1]
    cpu = {"variants": {d: {n: {"device_ms": None} for n in sb.VARIANTS}
                        for d in ("f32", "bf16")}, "components": {}, "roofline": {},
           "turns": None}
    assert sb.h10_rows(cpu)[1].startswith("Not measured (cpu)")


def test_op_component_maps_by_the_components_own_ops():
    launched = {"gather": {"index_kernel"}, "scatter_dense": {"radix_sort", "fill"},
                "adagrad_dense": {"radix_sort", "fill", "sqrt_kernel"}}
    assert sb.op_component("index_kernel", launched) == "gather"
    assert sb.op_component("sqrt_kernel", launched) == "adagrad_dense"
    assert sb.op_component("radix_sort", launched) == "scatter_dense/adagrad_dense"
    assert sb.op_component("gemm", launched).startswith("other")


# ---- the tool end to end -----------------------------------------------------


TIME_COLUMNS = {"wall ms/step", "device ms/step", "ms", "share of bound", "f32 table",
                "bf16 table", "f32 ms", "bf16 ms", "bf16 - f32 ms", "predicted ms",
                "error"}


def test_main_on_the_cpu_small(tmp_path, capsys):
    out = tmp_path / "R.md"
    res = sb.main(["--device", "cpu", "--small", "--quality", "--out", str(out)])
    text = out.read_text()
    assert text.splitlines()[2].startswith("Device: cpu")
    assert "H100" not in text and "TPU" not in text
    assert (tmp_path / "R.json").exists()
    assert set(res["variants"]) == set(sb.TABLE_DTYPES)
    for dtype in sb.TABLE_DTYPES:
        assert list(res["variants"][dtype]) == list(sb.VARIANTS)
        assert all(g["ok"] for g in res["gates"][dtype])
        assert list(res["components"][dtype]) == list(sb.COMPONENTS)
    assert [r["batch"] for r in res["batch"]] == [64, 128, 256]
    assert 0.5 < res["quality"]["auc_f32"] < 1
    # every cell of a time column says "not measured (cpu)"; the composite
    # bound is computed from shapes, not measured
    seen = 0
    for block in text.split("\n\n"):
        rows = [r for r in block.splitlines() if r.startswith("|")]
        if len(rows) < 3:
            continue
        header = [c.strip() for c in rows[0].strip("|").split("|")]
        for row in rows[2:]:
            cells = [c.strip() for c in row.strip("|").split("|")]
            if cells[0].startswith("composite bound"):
                continue
            for col, cell in zip(header, cells):
                if col in TIME_COLUMNS:
                    assert cell == sb.NOT_MEASURED, (col, row)
                    seen += 1
    # variants 2 x 5, components 2 x 7, a table each; the attribution's 11
    # measured rows in 2; H10's 3 columns of the step, 4 pieces and 7
    # components; the batch rows' 4 of 3
    assert seen == 2 * (2 * 5 + 2 * 7) + 11 * 2 + 3 * (5 + 7) + 4 * 3
    assert "not measured (cpu): no device op to trace." in text


def test_cpu_run_without_out_writes_nothing(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    sb.main(["--device", "cpu", "--small", "--parts", "components"])
    assert os.listdir(tmp_path) == []


def test_raises_without_a_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", "deepctr_torch.tools.step_breakdown"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device is available" in res.stderr
    assert os.listdir(tmp_path) == []


def test_committed_roofline_passed_its_gates():
    with open(os.path.join(ROOT, "ROOFLINE_TORCH.json")) as f:
        res = json.load(f)
    assert res["cuda"] and res["card"].startswith("NVIDIA H100")
    for dtype in sb.TABLE_DTYPES:
        gates = res["gates"][dtype]
        assert len(gates) == 11 and all(g["ok"] for g in gates), gates
        assert list(res["variants"][dtype]) == list(sb.VARIANTS)
        for name, rec in res["variants"][dtype].items():
            assert rec["launches"] == sb.predicted_launches(name, True), name
            assert rec["device_ms"] > 0 and rec["wall_ms"] > 0
        comps = res["components"][dtype]
        assert list(comps) == list(sb.COMPONENTS)
        assert all(c["ms"] > 0 and 0 < c["share"] < 1 for c in comps.values())
        assert comps["tower_fwdbwd"]["flop"] == 2_052_915_200 + 6_157_107_200
        assert len(res["ops"][dtype]) >= sb.TOP_OPS
        assert 0 < res["roofline"][dtype]["share"] < 1
    assert [r["batch"] for r in res["batch"]] == list(sb.BATCHES)
    assert all(len(t["device_ms"]) == 5 for t in res["turns"].values())
    assert res["h10_answer"].startswith("In turns")
    # the reference's serving band for a bf16 table (tests/test_serving.py)
    assert abs(res["quality"]["delta_auc_bf16"]) < 0.01
    assert res["quality"]["examples"] == 60_000
