"""The port's utilities against the JAX package's: the streaming histogram
AUC (``utils/metrics.py``) and the profiling helpers (``utils/prof.py``).

Histogram AUC: the same logits go through both packages. Bins follow
``sigmoid``, whose f32 result may differ by an ulp between torch and XLA;
where that falls on a bin edge a count moves to the neighbouring bin. The
test allows one such move per 1000 logits (none happened on these inputs
when it was written) and holds every other count equal.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepctr_torch.utils import metrics as t_metrics
from deepctr_torch.utils import prof
from deepctr_torch.utils.prof import span, trace
from deepctr_tpu.utils import metrics as j_metrics


def _logits(n, seed=1):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.25).astype(np.float32)
    logits = (rng.normal(size=n) * 2.0 + 1.2 * y).astype(np.float32)
    return logits, y


def test_streaming_auc_converges_to_exact():
    logits, y = _logits(20000)
    want = t_metrics.exact_auc(y, 1 / (1 + np.exp(-logits)))
    st = t_metrics.auc_state_init(num_bins=4096)
    for i in range(0, len(y), 2500):
        sl = slice(i, i + 2500)
        st = t_metrics.auc_state_update(st, torch.from_numpy(logits[sl]),
                                        torch.from_numpy(y[sl]),
                                        torch.ones(len(y[sl])))
    got = t_metrics.auc_state_finalize(st)
    assert abs(got - want) < 2e-3, (got, want)


def test_streaming_auc_respects_weights():
    st = t_metrics.auc_state_init(num_bins=64)
    st = t_metrics.auc_state_update(st, torch.tensor([5.0, -5.0, 3.0, -3.0]),
                                    torch.tensor([1.0, 0.0, 0.0, 1.0]),
                                    torch.tensor([1.0, 1.0, 0.0, 0.0]))
    assert t_metrics.auc_state_finalize(st) == 1.0
    assert np.isnan(t_metrics.auc_state_finalize(t_metrics.auc_state_init(8)))


@pytest.mark.parametrize("num_bins", [64, 4096])
def test_histograms_match_jax(num_bins):
    """Batches with weight-0 padding rows: the port's histograms against
    ``deepctr_tpu``'s, and the two finalized AUCs."""
    logits, y = _logits(30000, seed=4)
    w = np.ones_like(y)
    w[-700:] = 0.0
    t_st = t_metrics.auc_state_init(num_bins)
    j_st = j_metrics.auc_state_init(num_bins)
    for i in range(0, len(y), 8192):
        sl = slice(i, i + 8192)
        t_st = t_metrics.auc_state_update(t_st, torch.from_numpy(logits[sl]),
                                          torch.from_numpy(y[sl]), torch.from_numpy(w[sl]))
        j_st = j_metrics.auc_state_update(j_st, jnp.asarray(logits[sl]),
                                          jnp.asarray(y[sl]), jnp.asarray(w[sl]))
    moved = 0
    for got, want in ((t_st.pos, j_st.pos), (t_st.neg, j_st.neg)):
        got, want = got.numpy(), np.asarray(want)
        assert got.dtype == want.dtype == np.float32
        assert got.sum() == want.sum()
        moved += int(np.abs(got - want).sum()) // 2
    assert moved <= len(y) // 1000, moved
    assert t_st.pos.sum() + t_st.neg.sum() == w.sum()
    got, want = t_metrics.auc_state_finalize(t_st), j_metrics.auc_state_finalize(j_st)
    assert abs(got - want) <= 2.0 * moved / (t_st.pos.sum() * t_st.neg.sum()) + 1e-12

def test_trace_noop_and_scope():
    """``trace(None)`` is a no-op and leaves tracing off: a span inside
    records nothing."""
    with trace(None):
        with span("lookup"):
            pass  # no profiler session needed
    assert not prof.enabled() and prof.drain()["spans"] == []


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace(dir)`` turns tracing on for its block and writes the Chrome
    trace, which holds the program's spans and the ops run inside it (on
    the CPU here; on a card the kernels as well), and ``spans_<pid>.json``
    beside it: the spans, the counters and the phases' ms a step (the host
    marks' here; a graph's device stamps on a card)."""
    out = tmp_path / "prof"
    with trace(str(out)):
        with span("tower", rows=64):
            torch.ones(64, 64) @ torch.ones(64, 64)
            prof.count("rows", 64)
            with prof.marking("cpu"):
                prof.phase(prof.START)
                prof.phase("lookup")
    assert not prof.enabled()
    pid = os.getpid()
    assert sorted(os.listdir(out)) == [f"spans_{pid}.json", f"trace_{pid}.json"]
    events = json.loads((out / f"trace_{pid}.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "tower" in names and any("mm" in str(n) for n in names)
    spans = json.loads((out / f"spans_{pid}.json").read_text())
    (tower,) = spans["spans"]
    assert tower[3] == "tower" and tower[6] == {"rows": 64} and tower[4] <= tower[5]
    assert spans["counters"] == {"rows": 64} and spans["dropped"] == 0
    assert spans["phases"] == []
    assert spans["host_phases"]["steps"] == 1
    assert set(spans["host_phases"]["ms_a_step"]) == {"lookup"}
    assert prof.drain()["spans"] == []
