"""The port's tracing (``deepctr_torch/utils/prof.py``) on the CPU: the
switch, the spans and counters, the clock they share with the profiler, the
phase marks of the single-device and sharded step bodies, the ring of device
stamps (its arithmetic on a hand-built buffer, through the stamp kernel's
plain version) and the scorer's spans and counters.

The stamp kernel itself, a graph captured with tracing on and one captured
with it off run only on the card: ``chip_smoke.py`` phase 25.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepctr_torch.data import make_schema, synthetic
from deepctr_torch.models import MlpSpec, make_fnn
from deepctr_torch.ops.kernels import launch_counts
from deepctr_torch.ops.kernels import stamp as stamp_k
from deepctr_torch.optim import make_dense_optimizer, make_sparse_optimizer
from deepctr_torch.serving import Scorer
from deepctr_torch.train import init_state, make_scan_train_step, make_train_step
from deepctr_torch.utils import prof
from test_torch_ranks import launch

K = 3
HIDDEN = (16, 8)
BATCH = 64
STEPS = 3
STEP_PHASES = ["lookup", "tower", "sparse", "dense"]
SHARDED_PHASES = ["lookup", "tower", "dense", "grads", "sparse"]


@pytest.fixture(autouse=True)
def tracing_off():
    """Each test starts and ends with tracing off and nothing recorded."""
    prof.enable(False)
    prof.drain()
    yield
    prof.enable(False)
    prof.drain()


@pytest.fixture(scope="module")
def schema():
    return make_schema([("a", 4), ("b", 8), ("c", 16), ("tags", 10, 3)])


@pytest.fixture(scope="module")
def data(schema):
    return synthetic.generate(schema, num_examples=STEPS * BATCH, k=K, seed=7)


def _state(schema, mode="dense"):
    model = make_fnn(schema, k=K, mlp=MlpSpec(hidden=HIDDEN, dropout=0.5), device="cpu")
    sopt = make_sparse_optimizer("adagrad", 0.1, mode=mode)
    dopt = make_dense_optimizer("adagrad", 0.05)
    return init_state(model, schema, sopt, dopt, seed=3), sopt, dopt


def _annotations(p) -> dict:
    return {e.name(): e for e in p.profiler.kineto_results.events()
            if e.is_user_annotation() and e.device_type() != torch.autograd.DeviceType.CUDA}


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(stamp_k, "phase_stamp", refuse)
    before = launch_counts(), stamp_k.LAUNCHES
    assert prof.span("a") is prof.span("b", rows=3)   # one shared no-op
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with prof.span("outer", rows=5):
            with prof.span("inner"):
                prof.count("rows", 5)
                prof.phase(prof.START)
                prof.phase("lookup")
    out = prof.drain()
    assert out["spans"] == [] and out["counters"] == {} and out["marks"] == []
    assert out["phases"] == [] and out["dropped"] == 0
    assert not {"outer", "inner"} & set(_annotations(p))
    assert (launch_counts(), stamp_k.LAUNCHES) == before


def test_spans_nest_with_parents_and_share_their_unit():
    prof.enable(True)
    for req in range(2):
        with prof.span("score.request", rows=10 + req):
            with prof.span("score.pad"):
                pass
            with prof.span("score.fetch"):
                with prof.span("inner"):
                    pass
    spans = prof.drain()["spans"]
    assert [s.name for s in spans] == ["score.pad", "inner", "score.fetch",
                                       "score.request"] * 2
    by_id = {s.id: s for s in spans}
    for first in (0, 4):
        pad, inner, fetch, request = spans[first:first + 4]
        assert request.parent is None and request.unit == request.id
        assert request.attrs == {"rows": 10 + first // 4}
        assert pad.parent == fetch.parent == request.id
        assert inner.parent == fetch.id
        assert {s.unit for s in (pad, inner, fetch, request)} == {request.id}
        for s in (pad, inner, fetch):
            outer = by_id[s.parent]
            assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    assert spans[3].unit != spans[7].unit


def test_drain_clears_and_the_bounded_buffer_counts_its_drops(monkeypatch):
    monkeypatch.setattr(prof, "MAX_SPANS", 3)
    prof.enable(True)
    for i in range(5):
        with prof.span(f"s{i}"):
            pass
    with prof.marking("cpu"):
        prof.phase(prof.START)
    prof.count("rows", 2)
    prof.count("rows", 3)
    out = prof.drain()
    assert [s.name for s in out["spans"]] == ["s0", "s1", "s2"]
    assert out["dropped"] == 2
    assert out["counters"] == {"rows": 5}
    assert [m for m, _ in out["marks"]] == [prof.START]
    empty = prof.drain()
    assert empty["spans"] == [] and empty["counters"] == {} and empty["dropped"] == 0
    assert empty["marks"] == []


def test_a_span_starts_on_the_profilers_clock():
    """Each span's start, on the profiler's host clock, within 100 µs of its
    ``record_function``'s kineto start; the first span warms the path up."""
    prof.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        for i in range(20):
            with prof.span(f"span{i}"):
                torch.ones(8) + 1
    spans = prof.drain()["spans"]
    events = _annotations(p)
    gaps = [abs(s.start_ns - events[s.name].start_ns()) for s in spans[1:]]
    assert len(gaps) == 19 and max(gaps) < 100_000, gaps


def test_step_body_marks_its_phases_in_order(schema, data):
    """Eager steps on the CPU, the per-step and the scan route: a unit a
    step, its marks in the body's order, each phase's host ms at least 0."""
    state, sopt, dopt = _state(schema)
    step = make_train_step(schema, sopt, dopt)
    scan = make_scan_train_step(schema, sopt, dopt)
    ids = data.ids.reshape(STEPS, BATCH, -1)
    labels = data.labels.reshape(STEPS, BATCH)
    weights = np.ones((STEPS, BATCH), np.float32)
    prof.enable(True)
    step(state, ids[0], labels[0], weights[0])
    scan(state, ids, labels, weights)
    marks = prof.drain()["marks"]
    assert [m for m, _ in marks] == ([prof.START] + STEP_PHASES) * (1 + STEPS)
    ms = prof.phase_ms(marks)
    assert set(ms) == set(STEP_PHASES) and min(ms.values()) >= 0


def test_a_step_on_a_card_takes_no_host_marks(schema, data, monkeypatch):
    """On a card the host's clock times the enqueue, not the work: a step
    whose device is not the CPU (the device check made to say so here)
    records no host marks; nor does ``marking`` of a card's device."""
    state, sopt, dopt = _state(schema)
    step = make_train_step(schema, sopt, dopt)
    prof.enable(True)
    with prof.marking(torch.device("cuda", 0)):
        prof.phase(prof.START)
    monkeypatch.setattr(prof, "_host_does_the_work", lambda device: False)
    step(state, data.ids[:BATCH], data.labels[:BATCH], np.ones(BATCH, np.float32))
    out = prof.drain()
    assert out["marks"] == [] and prof.summary(out)["host_phases"]["steps"] == 0
    monkeypatch.undo()
    step(state, data.ids[:BATCH], data.labels[:BATCH], np.ones(BATCH, np.float32))
    assert [m for m, _ in prof.drain()["marks"]] == [prof.START] + STEP_PHASES


@pytest.fixture(scope="module")
def sharded_marks(schema, data, tmp_path_factory):
    """The sharded scan step's marks on two gloo ranks."""
    cfg = {"case": "phases", "schema": schema.to_json(), "model": "fnn", "k": K,
           "hidden": list(HIDDEN), "sparse": "adagrad", "sparse_lr": 0.1,
           "dense": "sgd", "dense_lr": 0.05, "capacity_factor": 2.0, "seed": 1}
    inputs = {"phases/config": np.array(json.dumps(cfg)),
              "phases/ids": data.ids.reshape(1, STEPS, BATCH, -1),
              "phases/labels": data.labels.reshape(1, STEPS, BATCH),
              "phases/weights": np.ones((1, STEPS, BATCH), np.float32)}
    return launch(inputs, str(tmp_path_factory.mktemp("phases")), world=2)


def test_sharded_body_marks_its_phases_in_order(sharded_marks):
    for out in sharded_marks:
        got = [str(m) for m in out["phases/marks"]]
        assert got == ([prof.START] + SHARDED_PHASES) * STEPS


def test_ring_rows_wrap_and_count_what_they_lose():
    assert prof.ring_rows(begun=3, read=0, replays=4) == ([0, 1, 2], 0, 0)
    assert prof.ring_rows(begun=6, read=3, replays=4) == ([3, 0, 1], 3, 0)
    assert prof.ring_rows(begun=11, read=3, replays=4) == ([3, 0, 1, 2], 7, 4)
    assert prof.ring_rows(begun=5, read=5, replays=4) == ([], 5, 0)


def test_phase_ms_of_hand_built_marks_is_exact():
    marks = [("lookup", 5), (prof.START, 100), ("lookup", 1100), ("tower", 4100),
             ("lookup", 4600), ("tower", 6600), (prof.START, 9000), ("lookup", 9250)]
    assert prof.phase_ms(marks) == {"lookup": (1000 + 500 + 250) / 1e6,
                                    "tower": (3000 + 2000) / 1e6}


class _Graph:
    """What owns a ring: a graph, here a stand-in."""


def _only(phases, ring):
    (reading,) = [r for r in phases if r.graph == ring.id]
    return reading


def test_ring_of_stamps_reads_ms_a_phase_exactly(monkeypatch):
    """A ring of 3 replays on the CPU, stamped through the kernel's plain
    version with a clock the test sets, 1000 ns a stamp: 6 replays of 2
    steps, drained after the second (nothing lost) and after the sixth (the
    third overwritten, unread)."""
    owner = _Graph()
    ring = prof.PhaseRing(steps=2, device="cpu", owner=owner, replays=3)
    clock = iter(range(10**6, 10**9, 1000))
    monkeypatch.setattr(stamp_k.time, "perf_counter_ns", lambda: next(clock))
    names = [prof.START, "lookup", "tower", "lookup", "tower"]
    for name in names:   # the capture names the slots; on the CPU it stamps too
        ring.stamp(name)

    def replay():
        for slot in range(len(names)):
            stamp_k.phase_stamp(ring.buf, slot)

    replay()
    first = _only(prof.drain()["phases"], ring)
    assert first.names == names and first.steps == 2
    assert first.lost == 0 and first.stamps.shape == (2, 5)
    assert prof.reading_ms(first) == {"lookup": 4000 / 1e6, "tower": 4000 / 1e6}
    for _ in range(4):
        replay()
    second = _only(prof.drain()["phases"], ring)
    assert (second.lost, second.stamps.shape) == (1, (3, 5))
    np.testing.assert_array_equal(second.stamps[:, 0], 10**6 + 1000 * np.array([15, 20, 25]))
    np.testing.assert_array_equal(np.diff(second.stamps, axis=1), 1000)
    assert prof.reading_ms(second) == {"lookup": 6000 / 1e6, "tower": 6000 / 1e6}
    assert int(ring.buf[3, 0]) == 6
    del owner   # the graph gone: read one last time, then dropped
    assert _only(prof.drain()["phases"], ring).stamps.shape == (0, 5)
    assert ring.id not in [r.graph for r in prof.drain()["phases"]]


def test_ring_refuses_a_capture_it_cannot_hold():
    owner = _Graph()
    ring = prof.PhaseRing(steps=1, device="cpu", owner=owner, replays=2)
    with pytest.raises(ValueError, match="first phase mark"):
        ring.stamp("lookup")
    ring.stamp(prof.START)
    for i in range(prof.PHASES_A_STEP):
        ring.stamp(f"p{i}")
    with pytest.raises(ValueError, match="phases a step"):
        ring.stamp("one_more")
    with pytest.raises(ValueError, match="int64"):
        stamp_k.phase_stamp(ring.buf.float(), 0)


def test_stamping_sends_phase_marks_to_the_ring():
    owner = _Graph()
    ring = prof.PhaseRing(steps=1, device="cpu", owner=owner, replays=2)
    prof.enable(True)
    with prof.marking("cpu"):
        with prof.stamping(ring):
            prof.phase(prof.START)
            prof.phase("lookup")
        prof.phase("marked")
    prof.phase("outside")
    out = prof.drain()
    assert ring.names == [prof.START, "lookup"]
    assert [m for m, _ in out["marks"]] == ["marked"]
    assert stamp_k.LAUNCHES == 0   # the plain version launches nothing


@pytest.mark.parametrize("sizes", [[10, 64, 150], [1, 128, 65]])
def test_scorer_counts_rows_and_padded_rows(schema, sizes):
    """``predict`` on a tiny FNN: ``score.rows`` the rows asked,
    ``score.padded_rows`` the whole batches computed, and a unit a request
    holding a ``score.pad``, ``h2d``, ``forward`` and ``fetch`` a batch."""
    model = make_fnn(schema, k=K, mlp=MlpSpec(hidden=HIDDEN), device="cpu")
    scorer = Scorer(model, schema, batch_size=BATCH)
    ids = synthetic.generate(schema, num_examples=max(sizes), k=K, seed=5).ids
    prof.enable(True)
    for n in sizes:
        assert scorer.predict(ids[:n]).shape == (n,)
    out = prof.drain()
    batches = [-(-n // BATCH) for n in sizes]
    assert out["counters"] == {"score.rows": sum(sizes),
                               "score.padded_rows": BATCH * sum(batches)}
    requests = [s for s in out["spans"] if s.name == "score.request"]
    assert [s.attrs["rows"] for s in requests] == sizes
    for request, nb in zip(requests, batches):
        inside = [s.name for s in out["spans"] if s.unit == request.id and s is not request]
        assert inside == ["score.pad", "score.h2d", "score.forward",
                          "score.fetch"] * nb + ["score.sigmoid"]


def test_scorer_is_the_same_with_tracing_on(schema):
    model = make_fnn(schema, k=K, mlp=MlpSpec(hidden=HIDDEN), device="cpu")
    scorer = Scorer(model, schema, batch_size=BATCH)
    ids = synthetic.generate(schema, num_examples=150, k=K, seed=6).ids
    off = scorer.predict(ids)
    prof.enable(True)
    np.testing.assert_array_equal(scorer.predict(ids), off)
    np.testing.assert_array_equal(scorer.logits(ids), scorer.logits(ids))
    names = [s.name for s in prof.drain()["spans"] if s.parent is None]
    assert names == ["score.request"] * 3


def test_spans_of_many_threads_are_kept_whole_while_drained():
    """8 threads open nested spans while the main thread drains: no span is
    lost or counted twice, and each child's parent is its own thread's."""
    import sys
    import threading

    prof.enable(True)
    n_threads, n_spans = 8, 400
    got = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work():
            for _ in range(n_spans):
                with prof.span("outer"):
                    with prof.span("inner"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            got += prof.drain()["spans"]
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    got += prof.drain()["spans"]
    assert len(got) == len({s.id for s in got}) == 2 * n_threads * n_spans
    outer = {s.id: s for s in got if s.name == "outer"}
    for s in got:
        if s.name == "inner":
            assert s.parent in outer and s.unit == s.parent
            assert outer[s.parent].start_ns <= s.start_ns
