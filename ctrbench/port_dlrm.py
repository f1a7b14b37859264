"""The harness's bridge to ``deepctr_torch``'s DLRM-DCNv2: its schema, model,
optimizers and train state built from a configuration file, the harness's
weights loaded into them, and what ``correct`` compares read out of the
program's state. The table is read in blocks (``weights_dlrm.py``): at the
cell's size it is 13.6 GB, and a second copy of it would be another.

A checkout whose program has no DLRM-DCNv2 fails at :func:`check`, before
any set-up.
"""

from __future__ import annotations

import torch

from .traffic_dlrm import fields
from .weights_dlrm import BLOCK_ROWS, blocks, fill_table, initial_dense, table_block


def check() -> None:
    """Import what the cell runs of the program (raises where it has none)."""
    from deepctr_torch.models import make_dlrm_dcnv2  # noqa: F401
    from deepctr_torch.train.step import make_scan_train_step  # noqa: F401


def schema(config: dict):
    from deepctr_torch.data import FieldSpec, Schema

    return Schema(tuple(FieldSpec(n, v, m) for n, v, m in fields(config).fields))


def model(config: dict, sch, device):
    from deepctr_torch.models import make_dlrm_dcnv2

    if config["model"] != "dlrm_dcnv2" or config["interaction_type"] != "dcn":
        raise ValueError(f"model {config['model']!r}: this bridge builds dlrm_dcnv2")
    top = [int(x) for x in config["over_arch_layer_sizes"]]
    if top[-1] != 1:
        raise ValueError("the top MLP ends in one logit")
    return make_dlrm_dcnv2(sch, embed_dim=int(config["embedding_dim"]),
                           bottom=tuple(int(x) for x in config["dense_arch_layer_sizes"]),
                           cross_layers=int(config["dcn_num_layers"]),
                           cross_rank=int(config["dcn_low_rank_dim"]), top=tuple(top[:-1]),
                           num_dense=int(config["num_dense"]), device=device)


def optimizers(config: dict):
    from deepctr_torch.optim import Adagrad, SparseAdagrad

    sp, dp = config["sparse_optimizer"], config["dense_optimizer"]
    if sp["name"] != "adagrad" or dp["name"] != "adagrad":
        raise ValueError("the harness builds Adagrad for the table and the dense layers")
    return (SparseAdagrad(float(sp["lr"]), eps=float(sp["eps"]),
                          initial_accumulator=float(sp["initial_accumulator"]),
                          mode=sp["mode"]),
            Adagrad(float(dp["lr"]), initial_accumulator_value=float(dp["initial_accumulator"]),
                    eps=float(dp["eps"])))


def dense_leaves(state) -> list[torch.Tensor]:
    from deepctr_torch.train.step import dense_params

    return dense_params(state.model)


def train_state(config: dict, sch, seed: int, device):
    """``(state, sparse_opt, dense_opt)``: the port's ``TrainState`` with the
    harness's weights of ``seed`` in it."""
    from deepctr_torch.train.step import init_state

    if config["table_dtype"] != "f32":
        raise ValueError("the harness's DLRM table is f32")
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


def first_grad_sq(state, config: dict, dense0) -> list[torch.Tensor]:
    """The squared norm of each leaf's first gradient from the state after
    one step: the table's from the accumulator (``acc - initial``, block by
    block), each dense leaf's from its change, ``g = -Δθ·sqrt(acc + eps) /
    lr``. Device scalars in ``reference.leaf_names`` order."""
    sp, dp = config["sparse_optimizer"], config["dense_optimizer"]
    acc = state.sparse_state.acc
    out = [sum((acc[i * BLOCK_ROWS:(i + 1) * BLOCK_ROWS].double()
                - float(sp["initial_accumulator"])).sum() for i in blocks(config))]
    for p, p0, a in zip(dense_leaves(state), dense0, state.dense_state, strict=True):
        g = -(p.detach().double() - p0.double()) * (a.double() + float(dp["eps"])).sqrt()
        out.append(_sq(g / float(dp["lr"])))
    return out


def change_sq(state, config: dict, seed: int, dense0) -> list[torch.Tensor]:
    """The squared norm of each leaf's change from its start; the table's
    against its initial blocks made again from ``seed``."""
    table = state.model.table
    out = [sum(_sq(table[i * BLOCK_ROWS:(i + 1) * BLOCK_ROWS]
                   - table_block(config, seed, table.device, i)) for i in blocks(config))]
    out += [_sq(p - p0) for p, p0 in zip(dense_leaves(state), dense0, strict=True)]
    return out
