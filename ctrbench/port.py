"""The harness's bridge to the system under test, ``deepctr_torch``: build
its schema, model, optimizers and train state from a configuration file,
load the harness's weights into them, and read what ``correct`` compares
out of the program's state.

The schema is built from the configuration's own fields, so a later change
to the program's schemas cannot move the yardstick.
"""

from __future__ import annotations

import torch


def schema(config: dict):
    from deepctr_torch.data import FieldSpec, Schema

    return Schema(tuple(FieldSpec(n, int(v), int(m)) for n, v, m in config["fields"]))


def model(config: dict, sch, device):
    from deepctr_torch.models import MlpSpec, make_fnn

    if config["model"] != "fnn":
        raise ValueError(f"model {config['model']!r}: the harness builds fnn")
    spec = MlpSpec(hidden=tuple(int(h) for h in config["hidden"]),
                   activation=config["activation"], dropout=float(config["dropout"]))
    return make_fnn(sch, k=int(config["k"]), mlp=spec,
                    init_sigma=float(config["init_sigma"]), device=device)


def optimizers(config: dict):
    from deepctr_torch.optim import Adagrad, SparseAdagrad

    sp, dp = config["sparse_optimizer"], config["dense_optimizer"]
    if sp["name"] != "adagrad" or dp["name"] != "adagrad":
        raise ValueError("the harness builds Adagrad for the table and the tower")
    return (SparseAdagrad(float(sp["lr"]), eps=float(sp["eps"]),
                          initial_accumulator=float(sp["initial_accumulator"]),
                          mode=sp["mode"]),
            Adagrad(float(dp["lr"]), initial_accumulator_value=float(dp["initial_accumulator"]),
                    eps=float(dp["eps"])))


@torch.no_grad()
def load_weights(mdl, table: torch.Tensor, tower) -> None:
    """The harness's weights into the port's model, in place."""
    if mdl.table.dtype != table.dtype:
        mdl.table.data = mdl.table.data.to(table.dtype)
    mdl.table.copy_(table)
    for (w, b), (w0, b0) in zip(mdl.mlp.params(), tower, strict=True):
        w.copy_(w0)
        b.copy_(b0)


def train_state(config: dict, sch, table: torch.Tensor, tower, device):
    """``(state, sparse_opt, dense_opt)``: the port's ``TrainState`` with the
    harness's weights in it."""
    from deepctr_torch.train.step import init_state

    sparse_opt, dense_opt = optimizers(config)
    mdl = model(config, sch, device)
    state = init_state(mdl, sch, sparse_opt, dense_opt, seed=0,
                       table_dtype=config["table_dtype"])
    load_weights(state.model, table, tower)
    return state, sparse_opt, dense_opt


def _sq(t: torch.Tensor) -> torch.Tensor:
    return t.detach().double().square().sum()


def first_grad_sq(state, config: dict, tower0) -> list[torch.Tensor]:
    """The squared norm of each leaf's first gradient, worked out from the
    state after one step: the table's from the sparse accumulator (``acc -
    initial``, the squares of the rows' summed gradients), each tower leaf's
    from its change, ``g = -Δθ·sqrt(acc + eps) / lr``. Device scalars in
    :func:`~ctrbench.reference.fnn.leaf_names` order, for this rank's share."""
    sp, dp = config["sparse_optimizer"], config["dense_optimizer"]
    acc_t = state.sparse_state.acc.double() - float(sp["initial_accumulator"])
    out = [acc_t.sum()]
    params = [t for layer in state.model.mlp.params() for t in layer]
    start = [t for layer in tower0 for t in layer]
    for p, p0, acc in zip(params, start, state.dense_state, strict=True):
        g = -(p.detach().double() - p0.double()) * (acc.double() + float(dp["eps"])).sqrt()
        out.append(_sq(g / float(dp["lr"])))
    return out


def change_sq(state, table0_share: torch.Tensor, tower0) -> list[torch.Tensor]:
    """The squared norm of each leaf's change from its start, this rank's
    share of the table."""
    out = [_sq(state.model.table.float() - table0_share.float())]
    params = [t for layer in state.model.mlp.params() for t in layer]
    start = [t for layer in tower0 for t in layer]
    out += [_sq(p - p0) for p, p0 in zip(params, start, strict=True)]
    return out


def pad_steps(ids: torch.Tensor, labels: torch.Tensor, live: int, pad_id: int):
    """A chunk whose first ``live`` steps are ``ids[:live]`` and whose other
    steps are weight-0 pad steps, as the port's loop pads a short chunk:
    ``(ids, labels, weights)``."""
    ids, labels = ids.clone(), labels.clone()
    weights = torch.ones(labels.shape, device=labels.device)
    ids[live:] = pad_id
    labels[live:] = 0.0
    weights[live:] = 0.0
    return ids, labels, weights


def table_share(table: torch.Tensor, world: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s rows of a row-sharded table (logical row g on rank
    g % world at local row g // world) and a zero sentinel row, the layout of
    the port's sharded state."""
    rows = table[rank::world]
    per = -(-table.shape[0] // world)
    out = table.new_zeros(per + 1, table.shape[1])
    out[:rows.shape[0]] = rows
    return out

