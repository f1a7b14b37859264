"""``correct`` has teeth: the control (the reference with TF32 products in
the program's place) and each fault a cell can have read above the real
cells' limits at a tiny size, and a whole run with the program broken
underneath comes out not correct.

The faults are planted in the program with ``monkeypatch``: among them two
in the sparse update alone (``sparse_lr``, the table's rate halved;
``sparse_acc``, the accumulator's write dropped) and the activation left out
of the scorer's tower (``linear``); the ranks of a
sharded run are spawned processes, so the sharded runner's rank entry is
replaced by one that plants the same fault before it runs."""

from __future__ import annotations

import functools

import pytest
import torch

from ctrbench import cells
from ctrbench.calibrate import substitute_numbers, substitutes
from ctrbench.run import run_cell
from ctrbench.runners import train_sharded
from ctrbench.tests import tiny

_REAL_RANK_MAIN = train_sharded._rank_main


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("tinyroot")))


@pytest.mark.parametrize("cell,substitute", [
    (c, s) for c in sorted(tiny.TINY) for s in tiny.SUBSTITUTES[c]])
def test_control_and_faults_fail_a_limit(root, cell, substitute):
    tc = cells.load_cell(cell, root)
    assert substitute in substitutes(tc)
    numbers = substitute_numbers(tc, tiny.SEED, torch.device("cpu"), substitute)
    assert any(v > tc.limits[k]["limit"] for k, v in numbers.items()), numbers


def _no_update(self, *args, **kwargs):
    return None


def _half_bce(orig, logits, labels, weights, weight_sum=None):
    keep = weights.clone()
    keep[keep.shape[0] // 2:] = 0.0
    return orig(logits, labels, keep, None)


def _local_all_to_all(x):
    return x.clone()


def _sparse_half_lr(self, orig, table, state, ids, rows, lr_scale=1.0, ids_sorted=False):
    return orig(self, table, state, ids, rows, 0.5 * lr_scale, ids_sorted)


def _sparse_no_acc(self, orig, table, state, ids, rows, lr_scale=1.0, ids_sorted=False):
    held = state.acc.clone()
    out = orig(self, table, state, ids, rows, lr_scale, ids_sorted)
    state.acc.copy_(held)
    return out


def _plant(fault: str, patch) -> None:
    """Break the program under ``patch(target, name, value)``."""
    import deepctr_torch.parallel.sharded as sharded
    import deepctr_torch.train.step as step
    from deepctr_torch import serving
    from deepctr_torch.ops.kernels import mlp
    from deepctr_torch.optim import dense, sparse

    if fault == "unchanged":
        patch(sparse.SparseAdagrad, "update", _no_update)
        patch(dense.Adagrad, "update", _no_update)
    elif fault == "half_batch":
        for mod in (step, sharded):
            patch(mod, "weighted_bce_with_logits",
                  functools.partial(_half_bce, mod.weighted_bce_with_logits))
    elif fault in ("sparse_lr", "sparse_acc"):
        wrap = _sparse_half_lr if fault == "sparse_lr" else _sparse_no_acc
        patch(sparse.SparseAdagrad, "update",
              functools.partialmethod(wrap, sparse.SparseAdagrad.update))
    elif fault == "no_exchange":
        patch(sharded, "_all_to_all", _local_all_to_all)
    elif fault == "linear":
        patch(mlp, "_PLAIN_ACTS", dict(mlp._PLAIN_ACTS, tanh=lambda t: t))
    elif fault in ("half_rows", "altered"):
        orig = serving.Scorer._batch_logits

        def broken(self, ids):
            out = orig(self, ids)
            if fault == "altered":
                out[0] = out[1]
            else:
                out[len(out) // 2:] = 0.0
            return out

        patch(serving.Scorer, "_batch_logits", broken)


def _faulty_rank_main(fault, ctx, rank, world, port):
    _plant(fault, setattr)
    _REAL_RANK_MAIN(ctx, rank, world, port)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.train", "unchanged"), ("tiny.train", "half_batch"),
    ("tiny.train", "sparse_lr"), ("tiny.train", "sparse_acc"),
    ("tiny32.train", "unchanged"), ("tiny32.train", "half_batch"),
    ("tiny32.train", "sparse_lr"), ("tiny32.train", "sparse_acc"),
    ("tiny32.train2", "unchanged"), ("tiny32.train2", "half_batch"),
    ("tiny32.train2", "sparse_lr"), ("tiny32.train2", "no_exchange"),
    ("tiny.serve", "half_rows"), ("tiny.serve", "altered"), ("tiny.serve", "linear"),
])
def test_a_broken_program_is_not_correct(root, monkeypatch, cell, fault):
    _plant(fault, monkeypatch.setattr)
    monkeypatch.setattr(train_sharded, "_rank_main",
                        functools.partial(_faulty_rank_main, fault))
    line = run_cell(cell, tiny.SEED, 0.3, False, "cpu", root=root)
    assert not line["correct"], line["checks"]
