"""Data-parallel train step with a replicated table.

Port of ``deepctr_tpu/parallel/dp.py``: every rank holds the whole table
and the dense tower, and steps its share of the global batch. There the
XLA partitioner inserts the collectives into the single-device step; here
they are explicit: the loss divides by the global weight sum and the lazy
L2 by the global batch, the occurrence ids and gradient rows are
all-gathered in rank order (the global batch's order), so every rank
applies the same sparse update as the single-device step on the global
batch, and the dense gradients are summed over the ranks. For tables that
fit a device; ``parallel/sharded.py`` is the path when they do not. The
CLI does not use it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..data import Schema
from ..models.base import lazy_l2, weighted_bce_with_logits
from ..ops.kernels.mlp import SEED_LIMIT
from ..train.step import TrainState, _to_device, dense_params
from .group import Group
from .sharded import all_reduce_sum, all_reduce_dense, rank_seed, state_tensors


def _all_gather(x: torch.Tensor, world: int) -> torch.Tensor:
    out = x.new_empty((world * x.shape[0],) + x.shape[1:])
    dist.all_gather_into_tensor(out, x.contiguous())
    return out


def make_dp_train_step(schema: Schema, sparse_opt, dense_opt, group: Group,
                       l2: float = 0.0):
    """Build ``step(state, ids, labels, weights, lr_scale=1.0, seed=None)
    -> (state, (loss, dropped))`` on a rank's local batch, with the state
    replicated (:func:`replicate_state`). ``dropped`` is always 0: nothing
    is bucketed. The dropout seed is drawn and mixed with the rank as in
    the sharded step."""
    pad_id = schema.pad_id
    n = group.world

    def step(state: TrainState, ids, labels, weights, lr_scale: float = 1.0,
             seed: int | None = None):
        model = state.model
        device = model.table.device
        drawn = int(torch.randint(0, SEED_LIMIT, (), generator=state.generator))
        seed = rank_seed(drawn if seed is None else seed, group.rank)
        ids = _to_device(ids, device, torch.long)
        labels = _to_device(labels, device, torch.float32)
        weights = _to_device(weights, device, torch.float32)
        weight_sum = all_reduce_sum(weights.sum())
        mask = (ids != pad_id).float()
        rows = model.table.detach()[ids].float().requires_grad_(True)
        params = dense_params(model)

        logits = model.apply_rows(rows, mask, train=True, seed=seed)
        loss = weighted_bce_with_logits(logits, labels, weights, weight_sum)
        loss = loss + lazy_l2(rows, mask, l2, batch=ids.shape[0] * n)
        g_rows, *g_dense = torch.autograd.grad(loss, [rows] + params)

        dense_opt.update(params, all_reduce_dense(g_dense), state.dense_state,
                         lr_scale=lr_scale)
        sparse_opt.update(model.table.data, state.sparse_state,
                          _all_gather(ids.reshape(-1), n),
                          _all_gather(g_rows.reshape(-1, g_rows.shape[-1]), n),
                          lr_scale=lr_scale)
        state.step += 1
        total = all_reduce_sum(loss.detach().clone())
        return state, (total, torch.zeros((), dtype=torch.long, device=device))

    return step


@torch.no_grad()
def replicate_state(state: TrainState) -> TrainState:
    """Make every rank's state rank 0's, in place: the table, both
    optimizers' states, the dense parameters and the dropout generator."""
    for t in state_tensors(state):
        dist.broadcast(t.data, src=0)
    rng = state.generator.get_state().to(state.model.table.device)
    dist.broadcast(rng, src=0)
    state.generator.set_state(rng.cpu())
    return state
