"""The harness's bridge to ``deepctr_torch``'s HSTU: its schema, model,
optimizer and train state built from a configuration file, the harness's
weights loaded into them, and what ``correct`` compares read out of the
program's state.

A checkout whose program has no HSTU fails at :func:`check`, before any
set-up.
"""

from __future__ import annotations

import torch

from .weights_hstu import initial_leaves


def check() -> None:
    """Import what the cell runs of the program (raises where it has none)."""
    from deepctr_torch.models import make_hstu  # noqa: F401
    from deepctr_torch.ops.hstu import counts  # noqa: F401
    from deepctr_torch.train.step import make_scan_train_step  # noqa: F401


def schema(config: dict):
    from deepctr_torch.data import FieldSpec, Schema

    return Schema((FieldSpec("item", int(config["items"]), int(config["max_sequence_length"])),))


def model(config: dict, sch, device):
    from deepctr_torch.models import make_hstu

    if config["model"] != "hstu" or float(config["attn_dropout_rate"]) != 0.0 \
            or float(config["dropout_rate"]) != float(config["linear_dropout_rate"]):
        raise ValueError("the port's HSTU has one dropout rate, the input's and the "
                         "blocks', and no attention dropout")
    if int(config["time_buckets"]) != 128:
        raise ValueError("the port's HSTU has 128 time buckets")
    return make_hstu(sch, k=int(config["item_embedding_dim"]),
                     blocks=int(config["num_blocks"]), heads=int(config["num_heads"]),
                     d_qk=int(config["dqk"]), d_v=int(config["dv"]),
                     dropout=float(config["dropout_rate"]),
                     negatives=int(config["num_negatives"]),
                     temperature=float(config["temperature"]), device=device)


def optimizer(config: dict):
    from deepctr_torch.optim import Adam

    opt = config["optimizer"]
    if opt["name"] != "adam" or float(opt["weight_decay"]) != 0.0:
        raise ValueError("the harness builds Adam without weight decay")
    return Adam(float(opt["lr"]), b1=float(opt["b1"]), b2=float(opt["b2"]),
                eps=float(opt["eps"]))


def train_state(config: dict, seed: int, device):
    """``(state, schema, optimizer)``: the port's ``TrainState`` with the
    harness's weights of ``seed`` in it."""
    from deepctr_torch.train.step import init_state

    sch = schema(config)
    opt = optimizer(config)
    state = init_state(model(config, sch, device), sch, None, opt, seed=0)
    with torch.no_grad():
        for p, p0 in zip(state.model.parameters(), initial_leaves(config, seed, device),
                         strict=True):
            p.copy_(p0)
    return state, sch, opt


def first_grad_sq(state, config: dict) -> list[torch.Tensor]:
    """The squared norm of each leaf's first gradient from the state after
    one chunk whose first step alone is live, from Adam's second moment:
    ``nu = (1 - b2)·g²·b2^(K-1)`` after the K - 1 pad steps (``K`` = Adam's
    count). Device scalars in the reference's ``leaf_names`` order."""
    b2 = float(config["optimizer"]["b2"])
    decay = (1.0 - b2) * b2 ** (int(state.dense_state.count) - 1)
    return [nu.double().sum() / decay for nu in state.dense_state.nu]


def change_sq(state, leaves0) -> list[torch.Tensor]:
    """The squared norm of each leaf's change from its start."""
    return [(p.detach().double() - p0.double()).square().sum()
            for p, p0 in zip(state.model.parameters(), leaves0, strict=True)]
