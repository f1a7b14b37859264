"""The port's account of what its sharded step sends, held to the program.

``parallel/comm.py::sent_volume`` is what ``predict_scaling`` is fed;
``parallel/sharded.py::record_collectives`` records every collective the
train, eval and scan steps issue. One run of ``python -m
deepctr_torch.tools.scaling_report --small --device cpu`` (two gloo ranks,
the tool's own test size) writes the report and the collectives it
recorded; each case of FM and FNN x capacity 1.0, 1.25, 2.0 x f32 and bf16
wire x f32 and bf16 table x train, eval and scan step must have issued,
call by call and on every rank, exactly the bytes and dtypes that
``sent_volume`` accounts, computed here from the case's model. Beside it:
``comm_volume``'s defaults (ids at 4 bytes, rows at the wire's width) are
the reference's ``comm_volume(split=None)``, ``CommVolume.table()`` sums to
``total_wire``, and the report has every executed row matching, its stamp,
and no figure of the reference's hardware.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from deepctr_torch import cli
from deepctr_torch.data import ipinyou_full_schema as t_ipinyou_full_schema
from deepctr_torch.parallel import comm as t_comm
from deepctr_torch.parallel import scaling
from deepctr_torch.tools import scaling_report
from deepctr_torch.utils import artifacts
from deepctr_tpu.data import ipinyou_full_schema as j_ipinyou_full_schema
from deepctr_tpu.parallel import comm as j_comm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("fm", "fnn")
CAPACITY = (1.0, 1.25, 2.0)
DTYPES = ("f32", "bf16")
WIDTH = {"f32": 4, "bf16": 2}
TORCH_DTYPE = {"f32": "torch.float32", "bf16": "torch.bfloat16"}
FORBIDDEN = ("v5e", "ICI", "DCN", "TPU")   # figures of the reference's hardware
CASES = [(m, cf, w, t) for m in MODELS for cf in CAPACITY for w in DTYPES for t in DTYPES]


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    """One run of the tool on two gloo ranks: (the report's text, its JSON)."""
    tmp = tmp_path_factory.mktemp("scaling_report")
    out, raw = tmp / "S.md", tmp / "S.json"
    res = subprocess.run([sys.executable, "-m", "deepctr_torch.tools.scaling_report",
                          "--small", "--device", "cpu", "--out", str(out),
                          "--json", str(raw)],
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=400)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    return out.read_text(), json.loads(raw.read_text())


def _case(data, model, cf, wire, table):
    (case,) = [c for c in data["executed"] if (c["model"], c["capacity_factor"],
                                                c["exchange_dtype"], c["table_dtype"])
               == (model, cf, wire, table)]
    return case


def _expected_step(model, cf, wire, table, n, rows):
    """The collectives of one train step, in the order it issues them, as
    (op, bytes, dtype): computed from the case's model built on the CPU."""
    cfg, schema = scaling_report.case_config(model, cf, wire, table, small=True)
    built = cli.build_model(cfg, schema, "cpu")
    d = built.table.shape[1]
    dense = sum(p.numel() * 4 for name, p in built.named_parameters() if name != "table")
    vol = t_comm.sent_volume(schema, rows, n, cf, dense, row_dim=d,
                             exchange_bytes=WIDTH[wire], table_bytes=WIDTH[table])
    narrow = "bf16" if "bf16" in (wire, table) else "f32"
    ids = ("all_to_all", vol.ids_a2a, "torch.int64")
    fwd = ("all_to_all", vol.rows_a2a_fwd, TORCH_DTYPE[narrow])
    train = [("all_reduce", 4, "torch.float32"), ids, fwd,
             ("all_reduce", 4, "torch.float32"), ("all_reduce", dense, "torch.float32"),
             ("all_to_all", vol.rows_a2a_bwd, TORCH_DTYPE[wire]),
             ("all_reduce", 8, "torch.int64")]
    # the closed forms, by hand: C = int(cf * cdiv(rows * S, n)) ids a peer
    cap = int(cf * -(-rows * schema.num_slots // n))
    assert (vol.ids_a2a, vol.rows_a2a_fwd, vol.rows_a2a_bwd) == (
        n * cap * 8, n * cap * d * WIDTH[narrow], n * cap * d * WIDTH[wire])
    return train, [ids, fwd]


@pytest.mark.parametrize("step", ["train", "eval", "scan"])
@pytest.mark.parametrize("model,cf,wire,table", CASES)
def test_executed_collectives_equal_sent_volume(report, model, cf, wire, table, step):
    """Every rank issued exactly the accounted collectives, call by call:
    the op, the operand's bytes and its dtype; the scan step's K steps on
    the CPU are K eager steps, none captured."""
    _, data = report
    case = _case(data, model, cf, wire, table)
    n, rows, k = case["ranks"], case["rows_per_rank"], case["scan_steps"]
    assert n == 2 and rows == scaling.SMALL_ROWS_PER_RANK and k == 8
    train, evaluate = _expected_step(model, cf, wire, table, n, rows)
    want = {"train": train, "eval": evaluate, "scan": train * k}[step]
    per_rank = case["records"][step]
    assert len(per_rank) == n
    for rank, records in enumerate(per_rank):
        got = [(op, nbytes, dtype) for op, nbytes, dtype, _, _ in records]
        assert got == want, (rank, got, want)
        assert not any(captured for *_, captured in records)
        scalars = [shape for op, _, _, shape, _ in records if op == "all_reduce" and not shape]
        assert len(scalars) == 3 * (k if step == "scan" else step == "train")


@pytest.mark.parametrize("exchange_bytes", [2, 4])
@pytest.mark.parametrize("capacity_factor", [1.0, 1.25, 2.0])
@pytest.mark.parametrize("n_devices", [1, 2, 4, 8, 16])
def test_comm_volume_is_the_reference_without_the_corrections(n_devices, capacity_factor,
                                                                exchange_bytes):
    """``comm_volume``'s defaults are the reference's accounting: ids at 4
    bytes and the rows at the wire's width both ways, field for field
    against ``deepctr_tpu``'s ``comm_volume(split=None)``; ``sent_volume``
    differs from it only in the ids (8 bytes) and the forward rows (the
    narrower of the table and the wire)."""
    kw = dict(batch_per_device=8192, n_devices=n_devices, capacity_factor=capacity_factor,
              dense_param_bytes=503_604, row_dim=11, exchange_bytes=exchange_bytes)
    want = j_comm.comm_volume(j_ipinyou_full_schema(), split=None, **kw)
    got = t_comm.comm_volume(t_ipinyou_full_schema(), **kw)
    for field in ("n_devices", "batch_per_device", "capacity", "ids_a2a", "rows_a2a_fwd",
                  "rows_a2a_bwd", "dense_psum", "a2a_wire", "psum_wire", "total_wire",
                  "bytes_per_example"):
        assert getattr(got, field) == getattr(want, field), field
    sent = t_comm.sent_volume(t_ipinyou_full_schema(), table_bytes=2, **kw)
    assert sent.ids_a2a == 2 * got.ids_a2a
    assert sent.rows_a2a_fwd == got.rows_a2a_fwd * 2 // exchange_bytes
    assert (sent.rows_a2a_bwd, sent.dense_psum, sent.capacity) == (
        got.rows_a2a_bwd, got.dense_psum, got.capacity)


@pytest.mark.parametrize("n,want", [
    (1, (1_179_648, 3_244_032, 6_488_064)),
    (4, (2_359_296, 6_488_064, 12_976_128)),
])
def test_sent_volume_of_the_headline(n, want):
    """Full-width iPinYou FNN, 8192 rows a rank, capacity 2.0, f32 wire, bf16
    table: ids, rows (bf16) and gradients (f32), the dense all-reduce of
    its 503,604 bytes; at N = 4, 16.37 MB of all-to-all wire a rank."""
    vol = t_comm.sent_volume(t_ipinyou_full_schema(), 8192, n, 2.0, 503_604, row_dim=11,
                             exchange_bytes=4, table_bytes=2)
    assert (vol.ids_a2a, vol.rows_a2a_fwd, vol.rows_a2a_bwd, vol.dense_psum) == (
        *want, 503_604)
    if n == 4:
        assert vol.a2a_wire == 16_367_616


def test_sent_volume_of_criteo():
    """``configs/criteo_sharded_stretch.json`` at N = 4, capacity 2.0, f32
    table and wire: 39 slots, rows of 17; its tower's 2,017,284 bytes from
    the model built on the meta device."""
    cfg, schema = scaling._case("criteo", small=False)
    vol = scaling_report.volume(cfg, schema, 8192, 4)
    assert (vol.ids_a2a, vol.rows_a2a_fwd, vol.rows_a2a_bwd, vol.dense_psum) == (
        5_111_808, 43_450_368, 43_450_368, 2_017_284)


@pytest.mark.parametrize("table_bytes,exchange_bytes", [(4, 4), (2, 4), (4, 2), (2, 2)])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_table_sums_to_total_wire(n, table_bytes, exchange_bytes):
    """``CommVolume.table()``: its rows' wire bytes sum to ``total_wire``,
    its total row is ``total_wire``, and each row names the dtype sent."""
    vol = t_comm.sent_volume(t_ipinyou_full_schema(), 8192, n, 2.0, 503_604,
                             exchange_bytes=exchange_bytes, table_bytes=table_bytes)
    rows = artifacts.parse_md_table(vol.table())
    body = [r for r in rows if not r["collective"].startswith("**")]
    assert sum(int(r["wire bytes/rank"].replace(",", "")) for r in body) == vol.total_wire
    assert rows[-1]["wire bytes/rank"] == f"**{vol.total_wire:,}**"
    name = {2: "bf16", 4: "f32"}
    labels = [r["collective"] for r in body]
    assert labels[0].endswith("int64")
    assert labels[1].endswith(name[min(table_bytes, exchange_bytes)])
    assert labels[2].endswith(name[exchange_bytes])
    assert [int(r["payload bytes/rank"].replace(",", "")) for r in body] == [
        vol.ids_a2a, vol.rows_a2a_fwd, vol.rows_a2a_bwd, vol.dense_psum]


def test_report_small_on_two_gloo_ranks(report):
    """The report of the tool's own run: every executed row matches (train,
    eval and scan of the 24 cases), the stamp of the tool at HEAD, the
    measured section from the CPU's host clock, and no figure of the
    reference's hardware."""
    text, data = report
    start = text.index("## Accounted against executed")
    rows = artifacts.parse_md_table(text[start:])
    assert len(rows) == 24 * 3 * 3
    assert {r["match"] for r in rows} == {"yes"}
    assert all(r["accounted bytes/rank"] == r["executed bytes/rank"] for r in rows)
    assert artifacts.protocol_stamp(scaling_report.TOOL) in text
    for word in FORBIDDEN:
        assert word not in text, word
    for title in ("## Per-step exchange inventory", "## Within one host",
                  "## Across hosts"):
        assert title in text, title
    assert "wall ms a step on the host clock" in text
    assert data["record"]["device"]["platform"] == "cpu"


def test_report_from_a_record_without_the_executed_section(report, tmp_path):
    """``--record`` reports a scaling record without running the sweep, and
    ``--fast`` leaves the executed section out; the record's volumes are
    held to ``sent_volume``, and a record that disagrees raises."""
    _, data = report
    record = tmp_path / "scaling.json"
    record.write_text(json.dumps(data["record"]))
    out = tmp_path / "S.md"
    res = scaling_report.main(["--record", str(record), "--fast", "--small", "--device",
                               "cpu", "--out", str(out)])
    text = out.read_text()
    assert res["rows"] == [] and "## Accounted against executed" not in text
    assert "## Within one host" in text and "## Across hosts" in text
    bad = json.loads(json.dumps(data["record"]))
    bad["steps"][0]["volume"]["ids_a2a"] //= 2   # the reference's 4-byte ids
    record.write_text(json.dumps(bad))
    with pytest.raises(AssertionError, match="sent_volume"):
        scaling_report.main(["--record", str(record), "--fast", "--small", "--device",
                             "cpu", "--out", str(out)])


def test_the_report_refuses_cuda_without_the_gpus():
    """Asked for cards that are not there (none here), the tool stops and
    says so: it never falls back to the CPU."""
    with pytest.raises(SystemExit, match="needs 4 GPUs"):
        scaling_report.main([])
    with pytest.raises(SystemExit, match="needs 2 GPUs"):
        scaling_report.main(["--small"])


def test_record_collectives_nests_and_stops():
    """Outside ``record_collectives`` nothing is recorded; an inner block
    gets its own list, and the outer one resumes after it."""
    from deepctr_torch.parallel import sharded

    assert sharded._RECORD is None
    with sharded.record_collectives() as outer:
        sharded._record("all_reduce", torch.zeros(3))
        with sharded.record_collectives() as inner:
            sharded._record("all_to_all", torch.zeros(2, 4, dtype=torch.bfloat16))
        sharded._record("all_reduce", torch.zeros((), dtype=torch.long))
    assert sharded._RECORD is None
    assert [(c.op, c.nbytes, c.dtype, c.shape, c.captured) for c in outer] == [
        ("all_reduce", 12, torch.float32, (3,), False),
        ("all_reduce", 8, torch.int64, (), False)]
    assert [(c.op, c.nbytes, c.shape) for c in inner] == [("all_to_all", 16, (2, 4))]
