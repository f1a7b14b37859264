"""The scaling model of ``deepctr_torch/parallel/comm.py`` against the
reference's, the link fit, and the measurement tool on gloo ranks.

``predict_scaling`` keeps the reference's closed form over ``CommVolume``'s
wire bytes; with zero latencies and the reference's two bandwidths it gives
the reference's point field for field. ``fit_links`` is held to a known
latency and bandwidth behind noisy synthetic sweep points. The tool
(``python -m deepctr_torch.parallel.scaling``) runs once on two gloo ranks
at a tiny size: its record must hold every field, and its numbers are the
CPU's, never a card's.
"""

import dataclasses
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from deepctr_torch.data import ipinyou_full_schema as t_ipinyou_full_schema
from deepctr_torch.parallel import comm as t_comm
from deepctr_tpu.data import ipinyou_full_schema as j_ipinyou_full_schema
from deepctr_tpu.parallel import comm as j_comm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_COMP_MS = 2.84       # the reference's test_comm.py step
DENSE_BYTES = 504_321 * 4


def _reference_links():
    """The reference's default ICI and DCN bandwidths, as a zero-latency
    LinkModel and an inter-host rate."""
    params = inspect.signature(j_comm.predict_scaling).parameters
    ici = params["ici_bytes_per_s"].default
    links = t_comm.LinkModel(a2a_bytes_per_s=ici, a2a_latency_s=0.0,
                             allreduce_bytes_per_s=ici, allreduce_latency_s=0.0)
    return links, params["dcn_bytes_per_s_per_host"].default


@pytest.mark.parametrize("exchange_bytes", [2, 4])
@pytest.mark.parametrize("n_hosts", [1, 2])
@pytest.mark.parametrize("n_devices", [1, 2, 8, 16])
def test_predict_scaling_equals_the_reference(n_devices, n_hosts, exchange_bytes):
    kw = dict(batch_per_device=8192, n_devices=n_devices, capacity_factor=2.0,
              dense_param_bytes=DENSE_BYTES, row_dim=11, exchange_bytes=exchange_bytes)
    want_vol = j_comm.comm_volume(j_ipinyou_full_schema(), split=None, **kw)
    got_vol = t_comm.comm_volume(t_ipinyou_full_schema(), **kw)
    assert got_vol.total_wire == want_vol.total_wire
    links, dcn = _reference_links()
    want = j_comm.predict_scaling(want_vol, T_COMP_MS, n_hosts=n_hosts)
    got = t_comm.predict_scaling(got_vol, T_COMP_MS, n_hosts=n_hosts, links=links,
                                 inter_bytes_per_s_per_host=dcn)
    pairs = {"n_devices": "n_devices", "n_hosts": "n_hosts", "wire_bytes": "wire_bytes",
             "inter_bytes_per_host": "dcn_bytes_per_host", "t_comp_ms": "t_comp_ms",
             "t_intra_ms": "t_ici_ms", "t_inter_ms": "t_dcn_ms",
             "efficiency_no_overlap": "efficiency_no_overlap",
             "efficiency_overlapped": "efficiency_overlapped"}
    assert sorted(pairs) == sorted(f.name for f in dataclasses.fields(got))
    for mine, theirs in pairs.items():
        np.testing.assert_allclose(getattr(got, mine), getattr(want, theirs),
                                   rtol=1e-12, atol=0, err_msg=mine)
    assert got.step_ms == pytest.approx(T_COMP_MS / got.efficiency_no_overlap, rel=1e-12)


def _links():
    return t_comm.LinkModel(a2a_bytes_per_s=300e9, a2a_latency_s=20e-6,
                            allreduce_bytes_per_s=200e9, allreduce_latency_s=15e-6)


def test_scaling_efficiency_monotone_in_bandwidth_and_hosts():
    """As the reference's test_comm.py holds its model: a starved
    inter-host link lowers the efficiency, one host beats two, and perfect
    overlap never loses to none; slower links lower it too."""
    vol = t_comm.comm_volume(t_ipinyou_full_schema(), batch_per_device=8192,
                             n_devices=16, capacity_factor=2.0,
                             dense_param_bytes=500_000)
    a = t_comm.predict_scaling(vol, T_COMP_MS, n_hosts=2, chips_per_host=8,
                               links=_links(), inter_bytes_per_s_per_host=25e9)
    b = t_comm.predict_scaling(vol, T_COMP_MS, n_hosts=2, chips_per_host=8,
                               links=_links(), inter_bytes_per_s_per_host=5e9)
    assert b.efficiency_no_overlap < a.efficiency_no_overlap
    c = t_comm.predict_scaling(vol, T_COMP_MS, n_hosts=1, links=_links())
    assert c.efficiency_no_overlap > a.efficiency_no_overlap
    assert a.efficiency_overlapped >= a.efficiency_no_overlap
    slow = dataclasses.replace(_links(), a2a_bytes_per_s=30e9)
    d = t_comm.predict_scaling(vol, T_COMP_MS, n_hosts=1, links=slow)
    assert d.efficiency_no_overlap < c.efficiency_no_overlap
    one = t_comm.comm_volume(t_ipinyou_full_schema(), batch_per_device=8192, n_devices=1)
    assert t_comm.predict_scaling(one, T_COMP_MS, links=_links()).step_ms == T_COMP_MS
    # without links, the LinkModel fitted on four H100s
    fitted = t_comm.predict_scaling(vol, T_COMP_MS)
    assert fitted == t_comm.predict_scaling(vol, T_COMP_MS, links=t_comm.DEFAULT_LINKS)
    assert 0.0 < fitted.t_intra_ms < T_COMP_MS


def test_predict_scaling_across_hosts_needs_an_inter_host_rate():
    vol = t_comm.comm_volume(t_ipinyou_full_schema(), batch_per_device=8192,
                             n_devices=8)
    with pytest.raises(ValueError, match="inter_bytes_per_s_per_host"):
        t_comm.predict_scaling(vol, T_COMP_MS, n_hosts=2, links=_links())


def _sweep(links, noise, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n in (1, 2, 4):
        for collective in ("all_to_all", "all_reduce"):
            for p in range(16, 27):
                payload = 1 << p
                wire = t_comm.wire_bytes(collective, payload, n)
                s = (links.a2a_latency_s + wire / links.a2a_bytes_per_s
                     if collective == "all_to_all" else
                     links.allreduce_latency_s + wire / links.allreduce_bytes_per_s)
                if n == 1:
                    s = 1e-6 + payload / 2e12   # a copy on the card; left out
                out.append({"collective": collective, "ranks": n, "bytes": payload,
                            "ms": s * 1e3 * (1 + noise * rng.standard_normal())})
    return out


def test_fit_links_recovers_latency_and_bandwidth():
    want = _links()
    got = t_comm.fit_links(_sweep(want, noise=0.02))
    for field in dataclasses.fields(want):
        assert getattr(got, field.name) == pytest.approx(getattr(want, field.name),
                                                         rel=0.05), field.name
    exact = t_comm.fit_links(_sweep(want, noise=0.0))
    for field in dataclasses.fields(want):
        assert getattr(exact, field.name) == pytest.approx(getattr(want, field.name),
                                                           rel=1e-9), field.name


def test_fit_links_needs_two_sizes():
    one_size = [r for r in _sweep(_links(), noise=0.0) if r["bytes"] == 1 << 20]
    with pytest.raises(ValueError, match="two payload sizes"):
        t_comm.fit_links(one_size)
    one_rank = [r for r in _sweep(_links(), noise=0.0) if r["ranks"] == 1]
    with pytest.raises(ValueError, match="two payload sizes"):
        t_comm.fit_links(one_rank)
    flat = [dict(r, ms=0.05) for r in _sweep(_links(), noise=0.0)]
    with pytest.raises(ValueError, match="no bandwidth"):
        t_comm.fit_links(flat)


def test_the_tool_on_two_gloo_ranks(tmp_path):
    """``python -m deepctr_torch.parallel.scaling --device cpu --ranks 1,2``
    at a tiny size writes a record with every field: the device (a CPU,
    with no card, topology or NCCL), the sweep at both world sizes, each
    configuration's step at both, the links fitted to the sweep, and the
    predictions at two ranks; no device time is filled in from the CPU."""
    out = tmp_path / "scaling.json"
    res = subprocess.run([sys.executable, "-m", "deepctr_torch.parallel.scaling",
                          "--device", "cpu", "--ranks", "1,2", "--small", "--out", str(out)],
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert rec["device"] == {"platform": "cpu", "kind": None, "count": None,
                             "cards": None, "topology": None, "nvlink_p2p": None,
                             "peer_access": None, "nccl": None,
                             "torch": rec["device"]["torch"]}
    configs = ["criteo", "criteo-2host", "fnn"]
    assert rec["ranks"] == [1, 2] and rec["configs"] == configs and rec["small"]
    sizes = sorted({p["bytes"] for p in rec["sweep"]})
    assert len(sizes) >= 2 and len(rec["sweep"]) == 2 * 2 * len(sizes)
    for p in rec["sweep"]:
        assert p["collective"] in ("all_to_all", "all_reduce") and p["ms"] > 0
        assert len(p["ms_by_rank"]) == p["ranks"] and p["ms"] == max(p["ms_by_rank"])
    assert sorted((s["config"], s["ranks"]) for s in rec["steps"]) == sorted(
        (c, n) for c in configs for n in (1, 2))
    for s in rec["steps"]:
        assert s["device_ms"] is None and s["nccl_us"] is None and s["peak_gib"] is None
        assert s["replay_us"] is None
        assert s["wall_ms"] > 0 and s["step_ms"] == s["wall_ms"]
        assert s["global_batch"] == s["ranks"] * s["rows_per_rank"]
        assert s["examples_per_s"] == pytest.approx(s["global_batch"] / s["wall_ms"] * 1e3)
        vol = t_comm.CommVolume(**s["volume"])
        assert (s["wire_bytes"], s["a2a_wire_bytes"], s["allreduce_wire_bytes"]) == (
            vol.total_wire, vol.a2a_wire, vol.psum_wire)
        assert (s["wire_bytes"] == 0) == (s["ranks"] == 1)
    assert sorted(rec["links"]) == sorted(f.name for f in dataclasses.fields(t_comm.LinkModel))
    assert sorted((p["config"], p["ranks"]) for p in rec["predictions"]) == [
        (c, 2) for c in configs]
    for p in rec["predictions"]:
        assert p["predicted_ms"] > p["t_comp_ms"] > 0
        assert p["error"] == pytest.approx(p["predicted_ms"] / p["measured_ms"] - 1)
    assert "links fitted to the sweep" in res.stdout


def test_the_tool_refuses_cuda_without_the_gpus():
    """Asked for more GPUs than there are (none here), the tool stops and
    says so: it never falls back to the CPU."""
    from deepctr_torch.parallel import scaling

    with pytest.raises(SystemExit, match="needs 2 GPUs"):
        scaling.main(["--ranks", "1,2"])
