"""The harness's bridge to ``deepctr_torch``'s xDeepFM: its schema, model,
optimizers and train state built from a configuration file, the harness's
weights loaded into them, and what ``correct`` compares read out of the
program's state. The table is read in blocks (``weights_xdeepfm.py``).

A checkout whose program has no xDeepFM fails at :func:`check`, before any
set-up.
"""

from __future__ import annotations

import torch

from .weights_xdeepfm import BLOCK_ROWS, blocks, fill_table, initial_dense, table_block


def check() -> None:
    """Import what the cell runs of the program (raises where it has none)."""
    from deepctr_torch.models import make_xdeepfm  # noqa: F401
    from deepctr_torch.train.step import make_scan_train_step  # noqa: F401


def model(config: dict, sch, device):
    from deepctr_torch.models import make_xdeepfm

    if config["model"] != "xdeepfm" or not config["cin_direct"]:
        raise ValueError(f"model {config['model']!r}: this bridge builds xdeepfm with "
                         "direct connections")
    if config["dnn_activation"] != "relu" or float(config["dropout"]) != 0.0 \
            or float(config["l2"]) != 0.0:
        raise ValueError("the port's xDeepFM has a ReLU DNN, no dropout and no L2")
    return make_xdeepfm(sch, k=int(config["k"]),
                        cin=tuple(int(x) for x in config["cin_layer_sizes"]),
                        dnn=tuple(int(x) for x in config["dnn_hidden"]), device=device)


def optimizers(config: dict):
    from deepctr_torch.optim import Adam, SparseAdagrad

    sp, dp = config["sparse_optimizer"], config["dense_optimizer"]
    if sp["name"] != "adagrad" or dp["name"] != "adam":
        raise ValueError("the harness builds Adagrad for the table and Adam for the "
                         "dense leaves")
    return (SparseAdagrad(float(sp["lr"]), eps=float(sp["eps"]),
                          initial_accumulator=float(sp["initial_accumulator"]),
                          mode=sp["mode"]),
            Adam(float(dp["lr"]), b1=float(dp["b1"]), b2=float(dp["b2"]),
                 eps=float(dp["eps"])))


def dense_leaves(state) -> list[torch.Tensor]:
    from deepctr_torch.train.step import dense_params

    return dense_params(state.model)


def train_state(config: dict, sch, seed: int, device):
    """``(state, sparse_opt, dense_opt)``: the port's ``TrainState`` with the
    harness's weights of ``seed`` in it."""
    from deepctr_torch.train.step import init_state

    if config["table_dtype"] != "f32":
        raise ValueError("the harness's xDeepFM table is f32")
    sparse_opt, dense_opt = optimizers(config)
    state = init_state(model(config, sch, device), sch, sparse_opt, dense_opt, seed=0)
    with torch.no_grad():
        fill_table(state.model.table, config, seed)
        for p, p0 in zip(dense_leaves(state), initial_dense(config, seed, device),
                         strict=True):
            p.copy_(p0)
    return state, sparse_opt, dense_opt


def _sq(t: torch.Tensor) -> torch.Tensor:
    return t.detach().double().square().sum()


def first_grad_sq(state, config: dict) -> list[torch.Tensor]:
    """The squared norm of each leaf's first gradient from the state after
    one chunk whose first step alone is live: the table's from the
    accumulator (``acc - initial``, block by block); each dense leaf's from
    Adam's second moment, ``nu = (1 - b2)·g²·b2^(K-1)`` after the K - 1 pad
    steps (``K`` = Adam's count). Device scalars in ``reference.leaf_names``
    order."""
    sp, dp = config["sparse_optimizer"], config["dense_optimizer"]
    acc = state.sparse_state.acc
    out = [sum((acc[i * BLOCK_ROWS:(i + 1) * BLOCK_ROWS].double()
                - float(sp["initial_accumulator"])).sum() for i in blocks(config))]
    b2 = float(dp["b2"])
    decay = (1.0 - b2) * b2 ** (int(state.dense_state.count) - 1)
    out += [nu.double().sum() / decay for nu in state.dense_state.nu]
    return out


def change_sq(state, config: dict, seed: int, dense0) -> list[torch.Tensor]:
    """The squared norm of each leaf's change from its start; the table's
    against its initial blocks made again from ``seed``."""
    table = state.model.table
    out = [sum(_sq(table[i * BLOCK_ROWS:(i + 1) * BLOCK_ROWS]
                   - table_block(config, seed, table.device, i)) for i in blocks(config))]
    out += [_sq(p - p0) for p, p0 in zip(dense_leaves(state), dense0, strict=True)]
    return out
