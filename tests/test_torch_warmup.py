"""The scan route's warm-up step (``train/step.py::_warm_up``): before each
CUDA graph capture one eager step runs on the real state and then puts
back every bit it wrote, so the route holds one copy of the state, as the
reference's donated scan step does (``deepctr_tpu/train/step.py:222``,
``jax.jit(scan_step, donate_argnums=(0,))``).

- For FNN (bf16 table, dense mode), FM (sorted mode), DeepFM with Adam,
  SNN's fine-tune (f32, sorted mode) and LR with SGD, from a state that
  has trained two steps: the warm-up with the eager ``_step_body`` changes
  the state while it runs, and afterwards every tensor (table,
  accumulator, dense parameters, buffers, the dense optimizer's state),
  ``state.step`` and the generator's state equal a test-side clone bit for
  bit; the bytes it kept are the touched rows and the dense leaves, not
  the table.
- ``TrainState.clone`` patched to raise: the warm-up makes no state copy.
- Two gloo ranks run the sharded body through the warm-up, with the rows
  ``parallel/sharded.py::touched_shard_rows`` gathers: each rank's shard is
  restored bit for bit, and ``record_collectives`` shows one step's
  collectives and the one ``all_gather``.

On the CPU a chunk of the scan route runs as eager steps and captures no
graph; ``chip_smoke.py`` phases 17, 18 and 22 drive the warm-up before
real captures on the card.
"""

import json

import numpy as np
import pytest
import torch

from deepctr_torch import models as t_models
from deepctr_torch.data import make_schema, synthetic
from deepctr_torch.models import MlpSpec
from deepctr_torch.optim import make_dense_optimizer
from deepctr_torch.optim import sparse as t_sparse
from deepctr_torch.parallel import comm
from deepctr_torch.train import step as t_step

from test_torch_ranks import launch

K = 3
HIDDEN = (16, 8)
BATCH = 32
SEED = 11


@pytest.fixture(scope="module")
def schema():
    # vocabularies far larger than a batch's ids, so that most rows are
    # untouched and a kept copy of the whole table would show in the bytes
    return make_schema([("a", 40), ("b", 900), ("c", 3000), ("tags", 200, 3)])


def _model(schema, name):
    mlp = MlpSpec(hidden=HIDDEN, activation="relu" if name == "deepfm" else "tanh",
                  dropout=0.5)
    if name == "fnn":
        return t_models.make_fnn(schema, k=K, mlp=mlp, device="cpu")
    if name == "fm":
        return t_models.make_fm(schema, k=K, device="cpu")
    if name == "deepfm":
        return t_models.make_deepfm(schema, k=K, mlp=mlp, device="cpu")
    if name == "snn":
        return t_models.make_snn(schema, hidden1=12, mlp=mlp, device="cpu")
    return t_models.make_lr(schema, device="cpu")


# (model, table dtype, sparse optimizer and mode, dense optimizer)
CASES = {
    "fnn-bf16-dense": ("fnn", "bf16", ("adagrad", "dense"), "adagrad"),
    "fm-sorted": ("fm", "f32", ("adagrad", "sorted"), "adagrad"),
    "deepfm-adam": ("deepfm", "f32", ("adagrad", "auto"), "adam"),
    "snn-f32-sorted": ("snn", "f32", ("adagrad", "sorted"), "adagrad"),
    "lr-sgd": ("lr", "f32", ("sgd", None), "sgd"),
}


def _case(schema, name):
    """(state after two eager steps, body, the warm-up's batch)."""
    model_name, table_dtype, (sparse, mode), dense = CASES[name]
    sopt = (t_sparse.SparseSgd(0.1) if sparse == "sgd"
            else t_sparse.SparseAdagrad(0.1, mode=mode))
    dopt = make_dense_optimizer(dense, 0.05)
    state = t_step.init_state(_model(schema, model_name), schema, sopt, dopt, seed=SEED,
                              table_dtype=table_dtype)
    ds = synthetic.generate(schema, num_examples=3 * BATCH, k=K, seed=SEED)
    ids = torch.from_numpy(ds.ids).long().view(3, BATCH, -1)
    labels = torch.from_numpy(ds.labels).view(3, BATCH)
    weights = torch.ones(3, BATCH)
    step = t_step.make_train_step(schema, sopt, dopt, l2=1e-4)
    for i in range(2):
        state, _ = step(state, ids[i], labels[i], weights[i])
    body = t_step._step_body(schema, sopt, dopt, 1e-4, False)
    return state, body, (ids[2], labels[2], weights[2])


def _leaves(state):
    return [t.detach() for t in t_step._state_tensors(state)]


def _same(a, b) -> bool:
    return (a.step == b.step
            and torch.equal(a.generator.get_state(), b.generator.get_state())
            and all(x.dtype == y.dtype and torch.equal(x, y)
                    for x, y in zip(_leaves(a), _leaves(b), strict=True)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_warm_up_restores_the_state_bit_for_bit(schema, name):
    state, body, (ids, labels, weights) = _case(schema, name)
    want = state.clone()
    seen = {}

    def spy(st, *args):
        out = body(st, *args)
        seen["changed"] = not _same(st, want)
        seen["table_changed"] = not torch.equal(st.table, want.table)
        return out

    touched = t_step.touched_rows(ids, schema.pad_id)
    kept = t_step._warm_up(spy, state, ids, labels, weights, 0.5, 12345, touched)
    assert seen["changed"] and seen["table_changed"], "the warm-up step changed nothing"
    assert _same(state, want)
    # the bytes kept: the touched rows of the table and of the accumulator,
    # and every other tensor whole; never the table
    table = state.table
    rowwise = [table] + [t for t in state.sparse_state if t.shape == table.shape]
    row_bytes = sum(t[0].numel() * t.element_size() for t in rowwise)
    other = sum(t.numel() * t.element_size() for t in _leaves(state)
                if not any(t.data_ptr() == r.data_ptr() for r in rowwise))
    assert kept == touched.numel() * row_bytes + other
    assert touched.numel() < table.shape[0] // 4


@pytest.mark.parametrize("mode", ["dense", "sorted"])
def test_touched_rows_cover_every_row_a_step_writes(schema, mode):
    """A step on the batch writes no row outside ``touched_rows`` (in dense
    mode every other row keeps its bits, its gradient being 0), and the pad
    row is among them."""
    sopt = t_sparse.SparseAdagrad(0.1, mode=mode)
    dopt = make_dense_optimizer("adagrad", 0.05)
    state = t_step.init_state(_model(schema, "fnn"), schema, sopt, dopt, seed=SEED,
                              table_dtype="bf16")
    ds = synthetic.generate(schema, num_examples=BATCH, k=K, seed=SEED + 1)
    ids = torch.from_numpy(ds.ids).long()
    before = state.clone()
    t_step._step_body(schema, sopt, dopt, 0.0, False)(
        state, ids, torch.from_numpy(ds.labels), torch.ones(BATCH), 1.0, 7)
    touched = t_step.touched_rows(ids, schema.pad_id)
    untouched = torch.ones(state.table.shape[0], dtype=torch.bool)
    untouched[touched] = False
    assert schema.pad_id in touched.tolist()
    assert torch.equal(state.table[untouched], before.table[untouched])
    assert torch.equal(state.sparse_state.acc[untouched],
                       before.sparse_state.acc[untouched])
    assert not torch.equal(state.table, before.table)


def test_warm_up_makes_no_state_copy(schema, monkeypatch):
    state, body, (ids, labels, weights) = _case(schema, "deepfm-adam")
    want = state.clone()

    def refuse(self):
        raise AssertionError("TrainState.clone called")

    monkeypatch.setattr(t_step.TrainState, "clone", refuse)
    t_step._warm_up(body, state, ids, labels, weights, 1.0, 99,
                    t_step.touched_rows(ids, schema.pad_id))
    monkeypatch.undo()
    assert _same(state, want)


def test_warm_up_restores_after_a_failing_step(schema):
    """A step that raises after its update still leaves the state as it
    began."""
    state, body, (ids, labels, weights) = _case(schema, "fm-sorted")
    want = state.clone()

    def failing(st, *args):
        body(st, *args)
        raise RuntimeError("after the update")

    with pytest.raises(RuntimeError, match="after the update"):
        t_step._warm_up(failing, state, ids, labels, weights, 1.0, 5,
                        t_step.touched_rows(ids, schema.pad_id))
    assert _same(state, want)


@pytest.fixture(scope="module")
def sharded(schema, tmp_path_factory):
    """Two gloo ranks: the sharded body through the warm-up, for FNN (bf16,
    dense mode, Adam) and FM (sorted mode, capacity 1.0, so some
    occurrences are dropped)."""
    ds = synthetic.generate(schema, num_examples=2 * BATCH, k=K, seed=SEED + 2)
    inputs = {}
    for name, model, table_dtype, mode, dense, cf in (
            ("fnn", "fnn", "bf16", "dense", "adam", 2.0),
            ("fm", "fm", "f32", "sorted", "adagrad", 1.0)):
        cfg = {"case": "warmup", "schema": schema.to_json(), "model": model, "k": K,
               "hidden": list(HIDDEN), "dropout": 0.5, "sparse": "adagrad",
               "sparse_mode": mode, "sparse_lr": 0.1, "dense": dense, "dense_lr": 0.05,
               "table_dtype": table_dtype, "capacity_factor": cf, "seed": SEED}
        inputs[f"{name}/config"] = np.array(json.dumps(cfg))
        inputs[f"{name}/ids"] = ds.ids.reshape(2, BATCH, -1)
        inputs[f"{name}/labels"] = ds.labels.reshape(2, BATCH)
    return launch(inputs, str(tmp_path_factory.mktemp("warmup")), world=2)


@pytest.mark.parametrize("name", ["fnn", "fm"])
def test_sharded_warm_up_restores_each_shard(sharded, name):
    for rank, out in enumerate(sharded):
        assert bool(out[f"{name}/changed"]), f"rank {rank}: the warm-up changed nothing"
        assert bool(out[f"{name}/same"]), f"rank {rank}'s shard was not restored"
        assert int(out[f"{name}/touched"]) < int(out[f"{name}/shard_rows"])


@pytest.mark.parametrize("name", ["fnn", "fm"])
def test_sharded_warm_up_issues_one_step_and_one_all_gather(sharded, schema, name):
    """``record_collectives`` over the gather and the warm-up: one
    ``all_gather`` of the rank's ids (int64 ``[b, S]``), then exactly one
    sharded train step's collectives, as ``sent_volume`` accounts them."""
    for out in sharded:
        ops = [str(o) for o in out[f"{name}/ops"]]
        nbytes = [int(b) for b in out[f"{name}/nbytes"]]
        rows = BATCH // 2
        assert ops[0] == "all_gather"
        assert nbytes[0] == rows * schema.num_slots * comm.ID_BYTES
        assert ops[1:] == ["all_reduce", "all_to_all", "all_to_all", "all_reduce",
                           "all_reduce", "all_to_all", "all_reduce"]
        assert ops.count("all_gather") == 1
