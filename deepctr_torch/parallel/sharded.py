"""Row-sharded embedding table with all-to-all id and row exchange.

Port of ``deepctr_tpu/parallel/sharded.py``. The table's rows are sharded
over the ranks with ``owner = id % N``, the dense tower runs data-parallel
on the same ranks, and each rank holds only its shard of the table and of
every table-shaped optimizer leaf.

Lookup, in one train or eval step on a rank's local batch:

1. bucket the local occurrence ids by owner (a stable sort and the rank of
   each within its owner's bucket), with a fixed capacity C per owner;
   occurrences ranked C or beyond are dropped and counted;
2. ``all_to_all`` the id buckets;
3. gather the requested rows from the local shard (local row R, the
   sentinel, is a frozen zero row that serves the empty slots);
4. ``all_to_all`` the rows back and unsort them into occurrence order.

The backward pass routes the occurrence gradients the same way in
reverse, and the sparse optimizer applies them to the local shard with the
received local ids, sentinel slots included (their gradients are zero, so
the sentinel keeps its bits): each shard's Adagrad accumulator lives with
its rows and no optimizer state crosses ranks.

Storage: logical row g lives on shard g % N at local row g // N; each
shard is ``[R+1, D]`` with R = cdiv(V_padded, N). :func:`pack_table` and
:func:`unpack_table` convert the logical ``[V_padded, D]`` layout to and
from the stacked ``[N·(R+1), D]`` one.

What differs from the reference, and why:

- One process drives one device (``parallel/group.py``), so a rank holds
  its shard as ``model.table`` and steps it in place, as the single-device
  step does; collectives are ``torch.distributed`` calls.
- The send buffers are built by a gather, not a scatter: below C each
  ``(owner, rank)`` slot has exactly one source occurrence, found from the
  bucket's start, and slots past a bucket's count take the sentinel (and a
  zero gradient). Nothing is accumulated, nothing is written to an overflow
  column, and no shape depends on the data, so no host sync is needed.
- The reference's split plan (small fields all-gathered as replicated
  subtables) is a TPU mechanism and is not ported. Its ``lax.scan`` route
  (:func:`make_sharded_scan_train_step`) is K eager steps on the CPU and,
  on the card, one CUDA graph replay of K steps with the NCCL collectives
  captured inside.
- The dropout seed: every rank draws the same seed from the state's
  generator, then mixes in its rank (:func:`rank_seed`), so ranks' masks
  differ, rank 0 keeps the drawn seed, and the generator advances alike on
  every rank. A world-1 step equals the single-device step bit for bit.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Iterator, NamedTuple

import torch
import torch.distributed as dist

from ..data import Schema
from ..models.base import lazy_l2, weighted_bce_with_logits
from ..ops.kernels.mlp import SEED_LIMIT
from ..train.step import (
    TrainState,
    _clone_tree,
    _per_step,
    _to_device,
    chunk_route,
    dense_params,
    init_state,
)
from ..utils import prof
from .comm import exchange_capacity
from .group import Group

_WIRE_DTYPES = {"f32": None, "bf16": torch.bfloat16}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Stored <-> logical layout
# ---------------------------------------------------------------------------


def shard_rows(vocab_padded: int, num_shards: int) -> int:
    """Logical rows per shard, the sentinel row not counted."""
    return _cdiv(vocab_padded, num_shards)


def pack_table(logical: torch.Tensor, num_shards: int) -> torch.Tensor:
    """``[V_padded, D]`` logical -> ``[N·(R+1), D]`` stored: shard after
    shard, each with its zero sentinel row last."""
    vp, d = logical.shape
    r = shard_rows(vp, num_shards)
    padded = logical.new_zeros(r * num_shards, d)
    padded[:vp] = logical
    stored = logical.new_zeros(num_shards, r + 1, d)
    stored[:, :r] = padded.view(r, num_shards, d).transpose(0, 1)
    return stored.view(num_shards * (r + 1), d)


def unpack_table(stored: torch.Tensor, vocab_padded: int,
                 num_shards: int) -> torch.Tensor:
    """Inverse of :func:`pack_table`."""
    d = stored.shape[-1]
    st = stored.reshape(num_shards, -1, d)
    return st.transpose(0, 1).reshape(-1, d)[:vocab_padded].clone()


def local_shard(logical: torch.Tensor, num_shards: int, rank: int) -> torch.Tensor:
    """Shard ``rank`` of the stored layout, ``[R+1, D]``: logical rows
    ``rank, rank+N, ...`` and the zero sentinel."""
    vp, d = logical.shape
    rows = logical[rank::num_shards]
    shard = logical.new_zeros(shard_rows(vp, num_shards) + 1, d)
    shard[:rows.shape[0]] = rows
    return shard


# ---------------------------------------------------------------------------
# Bucketing and the exchange
# ---------------------------------------------------------------------------


class Buckets(NamedTuple):
    send: torch.Tensor     # int64[N, C] local rows requested of each owner
    order: torch.Tensor    # int64[M] stable sort of the occurrences by owner
    owner_s: torch.Tensor  # int64[M] owner of each sorted occurrence
    rank: torch.Tensor     # int64[M] rank within its owner's bucket
    dropped: torch.Tensor  # int64 scalar, occurrences ranked C or beyond
    src: torch.Tensor      # int64[N, C] sorted occurrence of each slot
    valid: torch.Tensor    # bool[N, C] slots that have one


def bucket_by_owner(flat_ids: torch.Tensor, n: int, sentinel: int,
                    cap: int) -> Buckets:
    """Bucket ``M`` occurrence ids by owner shard, ``cap`` a bucket."""
    m = flat_ids.shape[0]
    flat_ids = flat_ids.long()
    owner = flat_ids % n
    order = torch.argsort(owner, stable=True)
    owner_s = owner[order]
    local_s = (flat_ids // n)[order]
    # each owner's run in the sorted owners, by binary search: bincount
    # reads the ids' maximum back to the host, and a scatter-add of ones
    # serialises its atomics on a few addresses
    bounds = torch.searchsorted(owner_s, torch.arange(n + 1, device=flat_ids.device))
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    rank = torch.arange(m, device=flat_ids.device) - starts[owner_s]
    col = torch.arange(cap, device=flat_ids.device)
    valid = col[None, :] < counts[:, None]
    src = (starts[:, None] + col[None, :]).clamp(max=max(m - 1, 0))
    send = torch.where(valid, local_s[src], sentinel)
    dropped = (counts - cap).clamp(min=0).sum()
    return Buckets(send, order, owner_s, rank, dropped, src, valid)


class Collective(NamedTuple):
    """One collective a step issued, as :func:`record_collectives` saw it."""

    op: str              # "all_to_all", "all_reduce" or "all_gather"
    nbytes: int          # the operand's bytes on this rank
    dtype: torch.dtype
    shape: tuple         # () for the scalar all-reduces
    captured: bool       # issued while a CUDA graph was being captured


_RECORD: list[Collective] | None = None


@contextlib.contextmanager
def record_collectives() -> Iterator[list[Collective]]:
    """Record every collective the sharded steps issue while the block runs:
    yields the list that each call of :func:`_all_to_all`,
    :func:`all_reduce_sum` and :func:`touched_shard_rows` appends a
    :class:`Collective` to (the port's counterpart of reading the lowered
    step's collectives). A replay of a captured graph issues what its
    capture recorded and records nothing."""
    global _RECORD
    held, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = held


def _record(op: str, t: torch.Tensor) -> None:
    _RECORD.append(Collective(op, t.numel() * t.element_size(), t.dtype, tuple(t.shape),
                              t.is_cuda and torch.cuda.is_current_stream_capturing()))


def _all_to_all(x: torch.Tensor) -> torch.Tensor:
    if _RECORD is not None:
        _record("all_to_all", x)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous())
    return out


def exchange_lookup(table_shard: torch.Tensor, b: Buckets, cap: int,
                    wire_dtype: torch.dtype | None = None):
    """ids all_to_all -> local gather -> rows all_to_all. Returns (the
    occurrences' rows ``[M, D]`` in occurrence order, in the table's dtype,
    dropped occurrences zero; the received local ids ``int64[N·C]``).
    ``wire_dtype`` (bf16) narrows the rows on the wire only."""
    recv = _all_to_all(b.send.reshape(-1))
    rows = table_shard[recv]
    if wire_dtype is not None:
        rows = rows.to(wire_dtype)
    back = _all_to_all(rows).to(table_shard.dtype)
    kept = b.rank < cap
    slot = b.owner_s * cap + torch.where(kept, b.rank, 0)
    rows_s = torch.where(kept[:, None], back[slot], 0)
    out = torch.empty_like(rows_s)
    out[b.order] = rows_s
    return out, recv


def exchange_scatter_grads(g_occ: torch.Tensor, b: Buckets,
                           wire_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Route occurrence gradients ``[M, D]`` to their owners -> ``[N·C, D]``
    in the order of the received ids, f32. Each slot holds one
    occurrence's gradient, so the wire cast rounds single elements; the
    sums over duplicate ids happen after the exchange, in the optimizer."""
    out_dtype = g_occ.dtype
    if wire_dtype is not None:
        g_occ = g_occ.to(wire_dtype)
    g_s = g_occ[b.order]
    buf = torch.where(b.valid[..., None], g_s[b.src], 0)
    return _all_to_all(buf.reshape(-1, g_occ.shape[-1])).to(out_dtype)


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedTrainState(TrainState):
    """A ``TrainState`` whose ``model.table`` and table-shaped sparse-state
    leaves hold this rank's shard ``[R+1, D]``; the dense parameters, their
    optimizer's state, the step and the generator are replicated."""

    num_shards: int
    vocab_padded: int


def sharded_state_from_state(state: TrainState, group: Group) -> ShardedTrainState:
    """Take a prepared single-device ``TrainState`` (initialised,
    pretrained, seeded from FM or resumed; the same on every rank) into the
    sharded layout, in place: its model's table and every table-shaped
    sparse-state leaf are replaced by this rank's shard, and the logical
    ones are freed."""
    table = state.model.table
    shape = tuple(table.shape)

    def shard(t):
        if tuple(t.shape) == shape:
            return local_shard(t.detach(), group.world, group.rank)
        return t

    state.sparse_state = type(state.sparse_state)(*(shard(t) for t in state.sparse_state))
    table.data = shard(table.data)
    return ShardedTrainState(
        step=state.step, model=state.model, sparse_state=state.sparse_state,
        dense_state=state.dense_state, generator=state.generator,
        num_shards=group.world, vocab_padded=shape[0])


def init_sharded_state(model: torch.nn.Module, schema: Schema, sparse_opt,
                       dense_opt, group: Group, seed: int = 0,
                       table_dtype: str = "f32") -> ShardedTrainState:
    """``train.init_state`` (the whole logical table, made once from
    ``seed``), then :func:`sharded_state_from_state`."""
    state = init_state(model, schema, sparse_opt, dense_opt, seed=seed,
                       table_dtype=table_dtype)
    return sharded_state_from_state(state, group)


def _gather_logical(shard: torch.Tensor, sst: ShardedTrainState, group: Group):
    parts = ([torch.empty_like(shard) for _ in range(group.world)]
             if group.rank == 0 else None)
    dist.gather(shard.contiguous(), parts, dst=0)
    if group.rank != 0:
        return None
    return unpack_table(torch.stack(parts).view(-1, shard.shape[-1]),
                        sst.vocab_padded, sst.num_shards)


def host_state_from_sharded(sst: ShardedTrainState, group: Group) -> TrainState | None:
    """Inverse of :func:`sharded_state_from_state`: the shards gathered to
    rank 0 and unpacked into a single-device ``TrainState`` (a new model on
    the shards' device), the layout of a portable checkpoint: a sharded
    run's checkpoint resumes unsharded and the other way round. Every rank
    must call it; ranks other than 0 get None."""
    shard = sst.model.table
    table = _gather_logical(shard.data, sst, group)
    sparse = [_gather_logical(t, sst, group) if t.shape == shard.shape else t
              for t in sst.sparse_state]
    if group.rank != 0:
        return None
    held, shard.data = shard.data, shard.data.new_empty(0)
    try:
        model = copy.deepcopy(sst.model)
    finally:
        shard.data = held
    model.table.data = table
    generator = torch.Generator()
    generator.set_state(sst.generator.get_state())
    return TrainState(step=sst.step, model=model,
                      sparse_state=type(sst.sparse_state)(*sparse),
                      dense_state=_clone_tree(sst.dense_state), generator=generator)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def rank_seed(seed: int, rank: int) -> int:
    """Rank ``rank``'s dropout seed from the seed every rank drew: rank 0
    keeps it; an odd multiplier keeps the ranks' seeds apart."""
    return (seed + rank * 0x9E3779B1) % SEED_LIMIT


def _wire(exchange_dtype: str):
    if exchange_dtype not in _WIRE_DTYPES:
        raise ValueError(f"exchange_dtype {exchange_dtype!r} (f32|bf16)")
    return _WIRE_DTYPES[exchange_dtype]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    if _RECORD is not None:
        _record("all_reduce", t)
    dist.all_reduce(t)
    return t


def all_reduce_dense(grads: list[torch.Tensor]) -> list[torch.Tensor]:
    """Sum the dense gradients over the ranks, in one collective."""
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]))
    return [part.view_as(g) for part, g in zip(flat.split([g.numel() for g in grads]),
                                                grads)]


def touched_shard_rows(ids: torch.Tensor, group: Group, sentinel: int) -> torch.Tensor:
    """The local rows of this rank's shard that a sharded step on every
    rank's batch ``ids`` (this rank's ``[b, S]``) can write: the ids every
    rank holds, gathered by one ``all_gather``, kept where ``id % N`` is
    this rank, as local rows ``id // N``, and the sentinel row. Every rank
    must call it; it reads the rows back to the host (outside any
    capture)."""
    n = group.world
    ids = ids.contiguous()
    if _RECORD is not None:
        _record("all_gather", ids)
    every = [torch.empty_like(ids) for _ in range(n)]
    dist.all_gather(every, ids)
    flat = torch.cat(every).reshape(-1)
    mine = flat[flat % n == group.rank] // n
    return torch.unique(torch.cat([mine, mine.new_tensor([sentinel])]))


class ShardedStepMetrics(NamedTuple):
    loss: torch.Tensor      # the global loss
    dropped: torch.Tensor   # occurrences dropped over every rank


class ShardedScanMetrics(NamedTuple):
    losses: torch.Tensor    # [K] the global loss of each step
    dropped: torch.Tensor   # [K] int64, occurrences dropped over every rank


def _sharded_step_body(schema: Schema, sparse_opt, dense_opt, group: Group,
                       l2: float, capacity_factor: float, exchange_dtype: str,
                       check_finite: bool):
    """``body(state, ids, labels, weights, lr_scale, seed, dense=None) ->
    (loss_total, dropped)``: one sharded train step on a rank's local batch
    already on the device (ids int64), updating this rank's shard, the
    replicated dense parameters and both optimizers' states in place; the sharded
    counterpart of ``train/step.py::_step_body``. ``seed`` is an int or a
    0-d int32 device tensor, the rank already mixed in (:func:`rank_seed`);
    drawing it and ``state.step`` are the caller's. The per-step route and
    the graph of K steps run this same body. Every collective is issued in
    one order on every rank, and nothing here waits on the device but
    ``check_finite``'s read of the loss. It marks the end of each of its
    phases for the tracing (:func:`..utils.prof.phase`): ``lookup`` (the
    weight all-reduce, the owner buckets and ``exchange_lookup``), ``tower``
    (forward, the loss's all-reduce, backward), ``dense`` (the dense
    all-reduce and update), ``grads`` (``exchange_scatter_grads``) and
    ``sparse`` (the update and the dropped count's all-reduce). It takes no
    dense features: ``dense`` other than None raises before any
    collective."""
    n = group.world
    pad_id = schema.pad_id
    sentinel = shard_rows(schema.padded_vocab_size, n)
    wire = _wire(exchange_dtype)

    def body(state: ShardedTrainState, ids, labels, weights, lr_scale, seed, dense=None):
        if dense is not None:
            raise ValueError("the sharded step takes no dense features")
        model = state.model
        b_loc, slots = ids.shape
        m = b_loc * slots
        cap = exchange_capacity(m, n, capacity_factor)
        mask = (ids != pad_id).float()
        weight_sum = all_reduce_sum(weights.sum())
        buckets = bucket_by_owner(ids.reshape(-1), n, sentinel, cap)
        occ_rows, recv = exchange_lookup(model.table.detach(), buckets, cap, wire)
        rows = occ_rows.float().reshape(b_loc, slots, -1).requires_grad_(True)
        params = dense_params(model)
        prof.phase("lookup")

        logits = model.apply_rows(rows, mask, train=True, seed=seed)
        loss = weighted_bce_with_logits(logits, labels, weights, weight_sum)
        loss = loss + lazy_l2(rows, mask, l2, batch=b_loc * n)
        total = all_reduce_sum(loss.detach().clone())
        if check_finite and not bool(torch.isfinite(total)):
            raise FloatingPointError(f"train step {state.step + 1}: loss "
                                     f"{float(total)} is not finite")
        g_rows, *g_dense = torch.autograd.grad(loss, [rows] + params)
        prof.phase("tower")

        dense_opt.update(params, all_reduce_dense(g_dense), state.dense_state,
                         lr_scale=lr_scale)
        prof.phase("dense")
        g_recv = exchange_scatter_grads(g_rows.reshape(m, -1), buckets, wire)
        prof.phase("grads")
        sparse_opt.update(model.table.data, state.sparse_state, recv, g_recv,
                          lr_scale=lr_scale)
        dropped = all_reduce_sum(buckets.dropped)
        prof.phase("sparse")
        return total, dropped

    return body


def make_sharded_train_step(schema: Schema, sparse_opt, dense_opt, group: Group,
                            l2: float = 0.0, capacity_factor: float = 2.0,
                            exchange_dtype: str = "f32",
                            check_finite: bool = False):
    """Build ``step(state, ids, labels, weights, lr_scale=1.0, seed=None,
    dense=None) -> (state, ShardedStepMetrics(loss, dropped))`` on a rank's
    local batch ``[b, S]``; ``dense`` other than None raises.

    The reference's arithmetic: the BCE divides by the global weight sum
    and the lazy L2 by the global batch ``b·N``; the dense gradients are
    summed over the ranks (not averaged) and every rank applies the same
    dense update; the sparse optimizer runs on the local shard. ``loss`` is
    the global loss and ``dropped`` the global count of dropped
    occurrences, both device scalars. ``seed`` replaces the drawn dropout
    seed (before the rank is mixed in); ``check_finite`` raises
    ``FloatingPointError`` on every rank at the first step whose global
    loss is not finite, before anything is updated."""
    return _per_step(
        _sharded_step_body(schema, sparse_opt, dense_opt, group, l2, capacity_factor,
                           exchange_dtype, check_finite),
        lambda seed: rank_seed(seed, group.rank), ShardedStepMetrics)


def make_sharded_scan_train_step(schema: Schema, sparse_opt, dense_opt, group: Group,
                                 l2: float = 0.0, capacity_factor: float = 2.0,
                                 exchange_dtype: str = "f32",
                                 check_finite: bool = False):
    """Build ``scan_step(state, ids [K, b, S], labels [K, b], weights [K, b],
    lr_scale=1.0, seeds=None, dense=None) -> (state, ShardedScanMetrics(losses
    [K], dropped [K]))``: K sharded train steps on a rank's local chunk, the
    reference's ``make_sharded_scan_train_step``; ``dense`` other than None
    raises. ``seeds`` (K ints) replaces the drawn dropout seeds before the
    rank is mixed in; the K
    draws are taken all the same, so the generator advances by K on every
    rank.

    On the CPU (gloo), and under ``check_finite``, the K steps run eagerly,
    one ``make_sharded_train_step`` step each. On the card they are one
    replay of a CUDA graph of the K steps, both all-to-all exchanges and
    the all-reduces of each captured inside (``train/step.py::
    chunk_route``, ``_ChunkGraph``); a capture or a collective that fails
    raises. Each capture's warm-up step runs on the shard itself and puts
    back the rows of its batch that every rank's ids reach
    (:func:`touched_shard_rows`, one ``all_gather`` a capture), so the
    route holds one copy of the shard. Every rank must call it with chunks
    of one shape and the same ``lr_scale``. Weight-0 steps that pad a
    short chunk are full steps, as the reference's: ``state.step`` counts
    them, they draw a seed, move Adam's moments, and count the occurrences
    they drop (an all-pad step sends every occurrence to the pad id's
    owner).

    A graph that captured NCCL collectives holds the communicator's
    resources: release it (``scan_step.graph.clear()``, or drop the step)
    before the process group ends, or destroying the group waits for it
    forever."""
    body = _sharded_step_body(schema, sparse_opt, dense_opt, group, l2,
                              capacity_factor, exchange_dtype, check_finite)
    sentinel = shard_rows(schema.padded_vocab_size, group.world)
    run = chunk_route(body, eager=check_finite,
                      touched=lambda ids: touched_shard_rows(ids, group, sentinel),
                      seed_map=lambda seed: rank_seed(seed, group.rank), dropped=True)

    def scan_step(state: ShardedTrainState, ids, labels, weights,
                  lr_scale: float = 1.0, seeds=None, dense=None):
        state, losses, dropped = run(state, ids, labels, weights, lr_scale, seeds, dense)
        return state, ShardedScanMetrics(losses, dropped)

    scan_step.graph = run.graph
    return scan_step


def make_sharded_eval_step(schema: Schema, group: Group,
                           capacity_factor: float = 2.0,
                           exchange_dtype: str = "f32"):
    """Build ``eval_step(model, ids) -> logits`` (no dropout) on a rank's
    local ids, through the same exchange; every rank must call it with
    batches of one shape."""
    n = group.world
    pad_id = schema.pad_id
    sentinel = shard_rows(schema.padded_vocab_size, n)
    wire = _wire(exchange_dtype)

    @torch.no_grad()
    def eval_step(model: torch.nn.Module, ids) -> torch.Tensor:
        ids = _to_device(ids, model.table.device, torch.long)
        b_loc, slots = ids.shape
        m = b_loc * slots
        cap = exchange_capacity(m, n, capacity_factor)
        buckets = bucket_by_owner(ids.reshape(-1), n, sentinel, cap)
        rows, _ = exchange_lookup(model.table, buckets, cap, wire)
        return model.apply_rows(rows.float().reshape(b_loc, slots, -1),
                                (ids != pad_id).float(), train=False)

    return eval_step


def state_tensors(state: TrainState) -> list[torch.Tensor]:
    """Every tensor of a train state: the table, the sparse optimizer's
    state, the dense parameters and the dense optimizer's state."""
    def leaves(node):
        if isinstance(node, torch.Tensor):
            return [node]
        return [t for sub in node for t in leaves(sub)]

    return [state.model.table, *state.sparse_state, *dense_params(state.model),
            *leaves(state.dense_state)]


def state_digest(state: TrainState) -> torch.Tensor:
    """float64 ``[2·tensors + 1]``: the sum and the sum of absolute values
    of every tensor of the state, and the sum of the generator's bytes.
    Ranks that prepared the same state give the same digest."""
    device = state.model.table.device
    sums = [s.to(device) for t in state_tensors(state) for s in (
        t.detach().sum(dtype=torch.float64),
        t.detach().abs().sum(dtype=torch.float64))]
    sums.append(torch.tensor(float(state.generator.get_state().long().sum()),
                             dtype=torch.float64, device=device))
    return torch.stack(sums)


def check_ranks_agree(state: TrainState, group: Group) -> None:
    """Raise ``RuntimeError`` unless every rank holds the same prepared
    state (by :func:`state_digest`): a sharded run whose ranks prepared
    different states would train on a mix of them."""
    if group.world == 1:
        return
    digest = state_digest(state)
    every = [torch.empty_like(digest) for _ in range(group.world)]
    dist.all_gather(every, digest)
    for r, other in enumerate(every):
        if not torch.equal(other, every[0]):
            raise RuntimeError(f"rank {r}'s prepared train state differs from "
                               f"rank 0's (digest {other.tolist()} vs "
                               f"{every[0].tolist()})")

