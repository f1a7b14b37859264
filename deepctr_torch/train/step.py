"""Train and eval steps: the port of ``deepctr_tpu/train/step.py``.

The reference's structure is kept: the loss is differentiated with respect
to the gathered rows ``[B, S, D]`` and the dense parameters, never the
``[V, D]`` table, and the occurrence gradients go to the sparse optimizer,
so the table update costs O(batch) however large the vocabulary.

What differs from the reference, and why:

- The model module holds the parameters (table and tower), and a step
  updates them in place, with the optimizers' states, instead of returning
  new arrays. ``TrainState.clone`` copies a state where a caller needs two.
- The dropout seed of each step is an int below 2^24 drawn from the state's
  ``torch.Generator`` (on the CPU), or given as ``seed=`` so that a test can
  feed the JAX step's seeds.
- ``make_scan_train_step``, the reference's ``lax.scan`` of K steps in one
  dispatch, is K eager steps on the CPU and, on the card, one replay of a
  CUDA graph that holds the K whole steps (:class:`_ChunkGraph`).
  :func:`chunk_route` serves the sharded step's scan route too
  (``parallel/sharded.py::make_sharded_scan_train_step``). Like the
  reference's donated scan step, it keeps one copy of the state on the
  device: each capture's warm-up step runs on the real state and then puts
  back what it wrote, the dense leaves and the table's and the sparse
  state's rows of the batch's ids (:func:`_warm_up`).
- The reference's split plan (``ops/split_embed.py``) is not ported: its
  one-hot matmuls are a TPU gather mechanism. One gather of all slots and
  one scatter of the occurrence gradients give the same per-row sums, up to
  f32 summation order; the parity tests hold the port against the JAX step
  with and without the plan.
- ``make_pretrain_step`` has no ``jit`` and no ``donate_argnums``, and takes
  a ``torch.Generator`` where the reference threads a PRNG key: the table,
  the optimizer's state and ``b1`` are updated in place.

On the card the step is bitwise repeatable: the gather's backward is never
taken (rows are a leaf), the tower's backward kernel and the FM scorer
kernel sum in a fixed order, and the sparse optimizers sum duplicate ids
with ``ops/scatter.py``'s prefix sums in 61-bit fixed point, exact in any
order (``scatter_totals`` in dense mode, ``dedupe_grads`` in sorted mode);
no float atomics.
"""

from __future__ import annotations

import copy
import dataclasses
import time
import weakref
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from ..models.base import lazy_l2, weighted_bce_with_logits
from ..ops.kernels import add_launch_counts, launch_counts
from ..ops.kernels import stamp as stamp_k
from ..ops.kernels.mlp import SEED_LIMIT
from ..data import Schema
from ..utils import prof

# CUDA graphs of K steps captured since the last reset; each capture ran
# one eager warm-up step on its state (then restored, :func:`_warm_up`),
# whose launches count
CAPTURES = 0

# the side stream of every warm-up and capture, one a device: cuBLAS keeps a
# workspace for each stream it has run on, so a new stream a capture would
# hold one more workspace for every graph captured
_CAPTURE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The device's one capture stream, made at its first capture."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device=device)
    return _CAPTURE_STREAMS[device]


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module              # table and dense parameters, updated in place
    sparse_state: Any
    dense_state: Any              # the dense optimizer's (a list, or AdamState)
    generator: torch.Generator    # dropout seeds, on the CPU

    @property
    def table(self) -> torch.Tensor:
        return self.model.table

    def clone(self) -> "TrainState":
        """A copy of every tensor and of the generator, of the same type (a
        sharded state stays one)."""
        generator = torch.Generator()
        generator.set_state(self.generator.get_state())
        return dataclasses.replace(
            self,
            model=copy.deepcopy(self.model),
            sparse_state=type(self.sparse_state)(
                *(t.clone() for t in self.sparse_state)),
            dense_state=_clone_tree(self.dense_state),
            generator=generator,
        )


def _clone_tree(node):
    """A copy of a state made of tensors, lists and NamedTuples."""
    if isinstance(node, torch.Tensor):
        return node.clone()
    if isinstance(node, tuple):
        return type(node)(*(_clone_tree(sub) for sub in node))
    return [_clone_tree(sub) for sub in node]


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    logits: torch.Tensor


def dense_params(model: nn.Module) -> list[torch.Tensor]:
    """The dense parameters (tower, bias) in ``named_parameters`` order
    (the table is the sparse optimizer's)."""
    return [p for name, p in model.named_parameters() if name != "table"]


def init_state(model: nn.Module, schema: Schema, sparse_opt, dense_opt,
               seed: int = 0, table_dtype: str = "f32") -> TrainState:
    """Initialise ``model`` in place from ``seed`` and build the state.

    ``table_dtype="bf16"`` stores the table in bfloat16; the gathered rows,
    the gradients and the Adagrad accumulator stay f32, and updates round on
    write."""
    device = model.table.device
    model.init_parameters(torch.Generator(device=device).manual_seed(seed),
                          schema.pad_id)
    if table_dtype == "bf16":
        model.table.data = model.table.data.to(torch.bfloat16)
    elif table_dtype != "f32":
        raise ValueError(f"table_dtype {table_dtype!r} (f32|bf16)")
    model.table.requires_grad_(False)
    return TrainState(
        step=0,
        model=model,
        sparse_state=sparse_opt.init(model.table),
        dense_state=dense_opt.init(dense_params(model)),
        generator=torch.Generator().manual_seed(seed),
    )


def _to_device(a, device, dtype) -> torch.Tensor:
    """A numpy array or tensor on ``device`` in ``dtype``. A tensor already
    there (a prefetched batch) is not copied again; a dtype change is then
    an op on the device."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=dtype, non_blocking=True)


def draw_seed(generator: torch.Generator) -> int:
    """One step's dropout seed: an int below 2^24 from the state's
    generator."""
    return int(torch.randint(0, SEED_LIMIT, (), generator=generator))


def _checked_seed(seed) -> int:
    if not 0 <= int(seed) < SEED_LIMIT:
        raise ValueError(f"dropout seed {seed} outside [0, 2^24)")
    return int(seed)


def _step_body(schema: Schema, sparse_opt, dense_opt, l2: float,
               check_finite: bool):
    """``body(state, ids, labels, weights, lr_scale, seed) -> (loss,
    logits)``: one train step on batches already on the model's device
    (ids int64), updating the model and the optimizers' states in place.
    ``state.step`` and the generator are the caller's. ``seed`` is an int or
    a 0-d int32 device tensor (:mod:`..ops.kernels.mlp`). The per-step route
    and the graph of K steps run this same body. It marks the end of each of
    its phases for the tracing (:func:`..utils.prof.phase`): ``lookup`` (the
    gather), ``tower`` (forward, loss and backward), ``sparse`` and
    ``dense`` (the two updates)."""
    pad_id = schema.pad_id

    def body(state: TrainState, ids, labels, weights, lr_scale, seed):
        model = state.model
        mask = (ids != pad_id).float()
        rows = model.table.detach()[ids].float().requires_grad_(True)
        params = dense_params(model)
        prof.phase("lookup")

        logits = model.apply_rows(rows, mask, train=True, seed=seed)
        loss = weighted_bce_with_logits(logits, labels, weights)
        loss = loss + lazy_l2(rows, mask, l2)
        if check_finite and not bool(torch.isfinite(loss)):
            raise FloatingPointError(f"train step {state.step + 1}: loss "
                                     f"{float(loss.detach())} is not finite")
        g_rows, *g_dense = torch.autograd.grad(loss, [rows] + params)
        prof.phase("tower")

        sparse_opt.update(model.table.data, state.sparse_state,
                          ids.reshape(-1), g_rows.reshape(-1, g_rows.shape[-1]),
                          lr_scale=lr_scale)
        prof.phase("sparse")
        dense_opt.update(params, g_dense, state.dense_state, lr_scale=lr_scale)
        prof.phase("dense")
        return loss.detach(), logits.detach()

    return body


def make_train_step(schema: Schema, sparse_opt, dense_opt, l2: float = 0.0,
                    check_finite: bool = False):
    """Build ``step(state, ids, labels, weights, lr_scale=1.0, seed=None)
    -> (state, StepMetrics)``. Batches are numpy arrays or tensors; they
    go to the model's device.

    ``check_finite`` (the CLI's ``train.debug_nans``) reads the loss on the
    host before the backward pass, a sync every step, and raises
    ``FloatingPointError`` at the first step whose loss is not finite,
    before anything is updated."""
    return _per_step(_step_body(schema, sparse_opt, dense_opt, l2, check_finite))


def _per_step(body, seed_map=None, metrics=StepMetrics):
    """``make_train_step``'s step around ``body``: the seed drawn (or
    given) and mapped by ``seed_map`` (the sharded step mixes in its rank),
    the batch moved to the device, ``state.step`` counted; the body's two
    outputs come back as ``metrics``. On the CPU the step opens a unit of
    the tracing's host phase marks (:func:`..utils.prof.marking`)."""

    def step(state: TrainState, ids, labels, weights, lr_scale: float = 1.0,
             seed: int | None = None):
        device = state.model.table.device
        drawn = draw_seed(state.generator)
        seed = drawn if seed is None else _checked_seed(seed)
        if seed_map is not None:
            seed = seed_map(seed)
        with prof.marking(device):
            prof.phase(prof.START)
            out = body(state, _to_device(ids, device, torch.long),
                       _to_device(labels, device, torch.float32),
                       _to_device(weights, device, torch.float32), lr_scale, seed)
        state.step += 1
        return state, metrics(*out)

    return step


def make_scan_train_step(schema: Schema, sparse_opt, dense_opt, l2: float = 0.0,
                         check_finite: bool = False):
    """Build ``scan_step(state, ids [K, B, S], labels [K, B], weights [K, B],
    lr_scale=1.0, seeds=None) -> (state, losses [K])``: K train steps, the
    reference's ``make_scan_train_step``. ``seeds`` (K ints) replaces the
    drawn dropout seeds, as ``make_train_step``'s ``seed=`` does; the K draws
    are taken all the same, so the generator ends where it would.

    On the CPU, and under ``check_finite`` (which must stop before the
    update of the step that went bad), the K steps run eagerly, one
    ``make_train_step`` step each. On the card they are one replay of a CUDA
    graph that holds all K steps (:class:`_ChunkGraph`); a capture that
    fails raises. ``state.step`` grows by K either way: weight-0 steps that
    pad a short chunk are full steps, as in the reference (a dropout seed
    each, Adam's moments and count move; SGD and Adagrad leave the table
    and accumulator as they were, since the gradient is 0)."""
    pad_id = schema.pad_id
    run = chunk_route(_step_body(schema, sparse_opt, dense_opt, l2, check_finite),
                      eager=check_finite, touched=lambda ids: touched_rows(ids, pad_id))

    def scan_step(state: TrainState, ids, labels, weights, lr_scale: float = 1.0,
                  seeds=None):
        state, losses, _ = run(state, ids, labels, weights, lr_scale, seeds)
        return state, losses

    scan_step.graph = run.graph
    return scan_step


def chunk_route(body, eager: bool, touched, seed_map=None, dropped: bool = False):
    """``run(state, ids [K, B, S], labels [K, B], weights [K, B], lr_scale,
    seeds) -> (state, losses [K], dropped [K] or None)``: a chunk of K steps,
    the scan route of the single-device and the sharded step alike.

    ``body`` is a step on batches already on the device (``_step_body``'s
    signature), returning ``(loss, second)``. On the CPU, and with
    ``eager``, the chunk is K steps of :func:`_per_step` around it. On the
    card it is one replay of a :class:`_ChunkGraph` of K calls of ``body``,
    captured at the first chunk and again whenever the chunk's shape,
    ``lr_scale``, the state object or its tensors' addresses change; a
    capture that fails raises. Each capture first runs one warm-up step on
    the state itself and puts back what it wrote (:func:`_warm_up`), so the
    route holds one copy of the state: ``touched(ids)`` gives the rows of
    the table (and of each table-shaped sparse-state leaf) that a step on
    the batch ``ids`` can write (:func:`touched_rows`; the sharded step's
    gathers every rank's ids). ``seed_map`` maps each dropout seed drawn
    from the state's generator (or given) to the one the body takes, on
    both routes (the sharded step mixes in its rank). With ``dropped``
    the body's second output is a count kept step by step (the sharded
    step's dropped occurrences, int64); otherwise it is discarded."""
    step = _per_step(body, seed_map)
    graph: list[_ChunkGraph] = []   # the last one captured

    def run(state: TrainState, ids, labels, weights, lr_scale: float = 1.0,
            seeds=None):
        k = ids.shape[0]
        if labels.shape[0] != k or weights.shape[0] != k or (
                seeds is not None and len(seeds) != k):
            raise ValueError(f"a chunk of {k} steps needs {k} labels, weights "
                             f"and seeds")
        if state.model.table.device.type != "cuda" or eager:
            outs = []
            for i in range(k):
                state, m = step(state, ids[i], labels[i], weights[i], lr_scale,
                                seed=None if seeds is None else seeds[i])
                outs.append(m)
            return (state, torch.stack([m[0] for m in outs]),
                    torch.stack([m[1] for m in outs]) if dropped else None)
        key = _graph_key(state, ids.shape, lr_scale)
        if not graph or not graph[0].fits(state, key):
            graph.clear()   # its pool goes before the next capture
            graph.append(_ChunkGraph(body, state, ids, labels, weights, lr_scale, key,
                                     touched, seed_map, dropped))
        return graph[0].run(state, ids, labels, weights, seeds)

    run.graph = graph
    return run


def _graph_key(state: TrainState, shape, lr_scale: float) -> tuple:
    """What a captured graph is good for: one chunk shape, one
    ``lr_scale`` and the addresses of one state's tensors (and the state
    object itself: :meth:`_ChunkGraph.fits`)."""
    return (tuple(shape), float(lr_scale), state.model.table.dtype,
            tuple(t.data_ptr() for t in _state_tensors(state)))


def _state_tensors(state: TrainState) -> list[torch.Tensor]:
    """Every tensor a step reads or writes in place: the model's parameters
    and buffers and the optimizers' states."""
    out = list(state.model.parameters()) + list(state.model.buffers())
    out += list(state.sparse_state)
    stack = [state.dense_state]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            out.append(node)
        else:
            stack.extend(node)
    return out


def touched_rows(ids: torch.Tensor, pad_id: int) -> torch.Tensor:
    """The table rows a single-device step on the batch ``ids`` can write:
    its unique ids and the pad row (a host sync, outside any capture)."""
    flat = ids.reshape(-1)
    return torch.unique(torch.cat([flat, flat.new_tensor([pad_id])]))


def _warm_up(body, state: TrainState, ids, labels, weights, lr_scale: float, seed,
             touched: torch.Tensor) -> int:
    """One eager call of ``body`` on ``state`` itself, then every bit it
    wrote put back in place: what a capture's first call must set up is set
    up, the state ends as it began, and no second copy of it is made.
    Returns the bytes it kept meanwhile.

    Before the step it keeps only what one step can change: the rows
    ``touched`` of the table and of each table-shaped sparse-state leaf
    (the sorted update writes those rows alone; the dense update rewrites
    every row, but an untouched row's gradient is 0 and it keeps its bits),
    and a copy of every other tensor of :func:`_state_tensors` (the dense
    parameters, the model's buffers, the dense optimizer's state with
    Adam's count), ``state.step`` and the generator's state. After the step,
    or a failure in it, these go back with ``index_copy_`` and ``copy_``
    into the same tensors, so the addresses a graph key holds stay valid."""
    table = state.model.table
    rowwise = [table, *(t for t in state.sparse_state if t.shape == table.shape)]
    held = {id(t) for t in rowwise}
    whole = [t for t in _state_tensors(state) if id(t) not in held]
    with torch.no_grad():
        rows = [t.index_select(0, touched) for t in rowwise]
        copies = [t.clone() for t in whole]
    kept_bytes = sum(t.numel() * t.element_size() for t in rows + copies)
    step, generator = state.step, state.generator.get_state()
    try:
        body(state, ids, labels, weights, lr_scale, seed)
    finally:
        with torch.no_grad():
            for t, kept in zip(rowwise, rows):
                t.index_copy_(0, touched, kept)
            for t, kept in zip(whole, copies):
                t.copy_(kept)
        state.step = step
        state.generator.set_state(generator)
    return kept_bytes


class _ChunkGraph:
    """K whole train steps (gather, model with its kernels, loss, backward,
    sparse and dense updates; in a sharded step also its NCCL exchanges
    and all-reduces) captured once as a ``torch.cuda.CUDAGraph`` and
    replayed once a chunk.

    A graph replays fixed addresses with fixed arguments. So it belongs to
    one state (the object, held by a weak reference, and the addresses of
    its tensors, :func:`_state_tensors`), one chunk shape and one
    ``lr_scale`` (a Python float in the arithmetic, baked in as the eager
    step bakes it; a new value is captured anew, which keeps the eager
    step's bits); each chunk is copied into static input buffers; each
    replay's K dropout seeds are drawn from the state's generator in the
    eager order, mapped by ``seed_map`` (when given), staged in pinned
    memory (two buffers, each reused only once its last copy has ended, an
    event says when) and copied to a ``[K]`` device buffer that the tower
    kernels read (the ``seed_ptr`` of ``csrc/dropout_hash.cuh``); the K
    losses land in a static ``[K]`` buffer, and with ``dropped`` the body's
    second outputs in a ``[K]`` int64 one.

    Before the capture one eager step runs on the state itself, on the
    device's one capture stream (:func:`_capture_stream`), so that what a
    first call sets up (cuBLAS's handle and workspace, the kernels' library,
    their shared-memory limits, an NCCL communicator) is not set up inside
    the capture; :func:`_warm_up` then puts back every bit it wrote (the
    rows ``touched`` gives for the chunk's first batch, and the dense
    leaves), so the route holds no second copy of the state. In a sharded
    step that warm-up and ``touched``'s gather run collectives, and so does
    every replay: capturing is collective, and every rank must capture at
    the same chunk. It does,
    since the key changes on every rank at once: the chunk shape and
    ``lr_scale`` (``lr_decay ** epoch``) are the same on every rank, a new
    state object is new on every rank, and the addresses of one state's
    tensors change only where a caller replaces them, which ``fit`` does on
    no rank. The capture itself runs
    nothing; ``capture_error_mode="thread_local"`` leaves other threads
    (the process group's watchdog) free to query the device meanwhile. Its
    launch counts are taken back and added again at every replay
    (:mod:`..ops.kernels`).

    Tracing (:mod:`..utils.prof`): a graph captured while it is on owns a
    :class:`~..utils.prof.PhaseRing` and holds a device stamp at the start
    of each replay and at each phase mark of each step (33 stamps in a
    replay of 8 single-device steps, 41 sharded); one captured while it is
    off holds none. The capture is the span ``graph.capture`` (``graph.
    warm_up``, ``graph.record``); a replay is ``chunk`` (``chunk.load``,
    ``chunk.seeds``, ``chunk.seed_wait``, ``chunk.replay``), numbered from 0
    as the ring numbers its rows.
    """

    def __init__(self, body, state: TrainState, ids, labels, weights,
                 lr_scale: float, key: tuple, touched, seed_map=None,
                 dropped: bool = False):
        device = state.model.table.device
        k, b = ids.shape[:2]
        self.key = key
        self.state = weakref.ref(state)
        self.seed_map = seed_map
        self.ids = torch.empty(ids.shape, dtype=torch.long, device=device)
        self.labels = torch.empty((k, b), dtype=torch.float32, device=device)
        self.weights = torch.empty((k, b), dtype=torch.float32, device=device)
        self.seeds = torch.zeros(k, dtype=torch.int32, device=device)
        self.losses = torch.empty(k, dtype=torch.float32, device=device)
        self.dropped = (torch.zeros(k, dtype=torch.long, device=device) if dropped
                        else None)
        self._staging = [torch.empty(k, dtype=torch.int32, pin_memory=True)
                         for _ in range(2)]
        self._copied: list[torch.cuda.Event | None] = [None, None]
        self._slot = 0
        self._load(ids, labels, weights)
        self.replays = 0
        self.ring = prof.PhaseRing(k, device, self) if prof.enabled() else None

        t0 = time.perf_counter()
        with prof.span("graph.capture", steps=k):
            stream = _capture_stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with prof.span("graph.warm_up"), torch.cuda.stream(stream):
                # the bytes of the state the warm-up held meanwhile
                self.snapshot_bytes = _warm_up(
                    body, state, self.ids[0], self.labels[0], self.weights[0], lr_scale,
                    self.seeds[0], touched(self.ids[0]))
            torch.cuda.current_stream(device).wait_stream(stream)

            self.graph = torch.cuda.CUDAGraph()
            before = launch_counts()
            with prof.span("graph.record"), torch.cuda.graph(
                    self.graph, stream=stream, capture_error_mode="thread_local"), \
                    prof.stamping(self.ring):
                prof.phase(prof.START)
                for i in range(k):
                    loss, second = body(state, self.ids[i], self.labels[i],
                                        self.weights[i], lr_scale, self.seeds[i])
                    self.losses[i].copy_(loss)
                    if self.dropped is not None:
                        self.dropped[i].copy_(second)
            captured = launch_counts()
            self.launches = tuple(a - b for a, b in zip(captured, before))
            add_launch_counts(tuple(-n for n in self.launches))
            # the stamps' launches, the same way (kept apart from the kernels'
            # counters, whose four entries the tools read)
            self.stamps = len(self.ring.names) if self.ring is not None else 0
            stamp_k.LAUNCHES -= self.stamps
        self.capture_s = time.perf_counter() - t0
        global CAPTURES
        CAPTURES += 1

    def fits(self, state: TrainState, key: tuple) -> bool:
        """This graph replays ``state``'s step at ``key``."""
        return self.key == key and self.state() is state

    def _load(self, ids, labels, weights) -> None:
        device = self.ids.device
        self.ids.copy_(_to_device(ids, device, torch.long))
        self.labels.copy_(_to_device(labels, device, torch.float32))
        self.weights.copy_(_to_device(weights, device, torch.float32))

    def run(self, state: TrainState, ids, labels, weights, seeds=None):
        """One replay: ``(state, losses [K], dropped [K] or None)``."""
        k = self.seeds.shape[0]
        with prof.span("chunk", replay=self.replays):
            with prof.span("chunk.load"):
                self._load(ids, labels, weights)
            with prof.span("chunk.seeds"):
                drawn = [draw_seed(state.generator) for _ in range(k)]
                values = drawn if seeds is None else [_checked_seed(s) for s in seeds]
                if self.seed_map is not None:
                    values = [self.seed_map(v) for v in values]
            staging, copied = self._staging[self._slot], self._copied[self._slot]
            if copied is not None:
                with prof.span("chunk.seed_wait"):
                    copied.synchronize()   # this buffer's last copy has ended
            with prof.span("chunk.replay"):
                staging.copy_(torch.tensor(values, dtype=torch.int32))
                self.seeds.copy_(staging, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                self._copied[self._slot] = event
                self._slot ^= 1
                self.graph.replay()
            self.replays += 1
            add_launch_counts(self.launches)
            stamp_k.LAUNCHES += self.stamps
            state.step += k
            return (state, self.losses.clone(),
                    None if self.dropped is None else self.dropped.clone())


def make_eval_step(schema: Schema):
    """Build ``eval_step(model, ids) -> logits`` (no dropout)."""
    pad_id = schema.pad_id

    @torch.no_grad()
    def eval_step(model: nn.Module, ids) -> torch.Tensor:
        ids = _to_device(ids, model.table.device, torch.long)
        rows = model.table[ids].float()
        return model.apply_rows(rows, (ids != pad_id).float(), train=False)

    return eval_step


# ---------------------------------------------------------------------------
# SNN unsupervised pretraining step (shared by DAE and RBM)
# ---------------------------------------------------------------------------


def make_pretrain_step(pretrainer, schema: Schema, sparse_opt, dense_lr: float,
                       with_noise: bool = False):
    """Build ``pstep(table, sparse_state, dense, generator, ids) -> (table,
    sparse_state, dense, generator, loss)`` where ``dense`` = ``{"b1",
    "vbias"}`` (``init_pretrain_dense``). The table goes through
    ``sparse_opt.update`` (duplicates of an id, a sampled negative that is
    also active among them, are summed before the rule); ``vbias`` takes
    plain SGD through a deduplicated scatter, ``b1`` plain SGD. The table,
    the sparse state and ``b1`` are updated in place; ``dense`` is the same
    dict with a new ``vbias``.

    ``with_noise=True`` builds ``pstep(..., ids, noise)`` where ``noise`` is
    the pretrainer's dict of uniforms: the same uniforms fed to the
    reference's step and to the NumPy oracle make the trajectories
    comparable."""
    from ..models.snn import field_sampling
    from ..ops.scatter import scatter_add_dedup

    pad_id = schema.pad_id
    sampling = {}  # device -> FieldSampling

    @torch.no_grad()
    def pstep(table, sparse_state, dense, generator, ids, noise=None):
        device = table.device
        if device not in sampling:
            sampling[device] = field_sampling(schema, device)
        ids = _to_device(ids, device, torch.long)
        loss, occ_ids, occ_rows, dgrads = pretrainer.loss_and_grads(
            table, dense, ids, pad_id, sampling[device], generator, noise=noise)
        table, sparse_state = sparse_opt.update(table, sparse_state, occ_ids, occ_rows)
        dense["vbias"] = scatter_add_dedup(
            dense["vbias"][:, None], dgrads["vbias_ids"],
            -dense_lr * dgrads["vbias_grads"][:, None])[:, 0]
        dense["b1"].sub_(dense_lr * dgrads["b1"])
        return table, sparse_state, dense, generator, loss

    if with_noise:
        return pstep
    return lambda table, sparse_state, dense, generator, ids: pstep(
        table, sparse_state, dense, generator, ids)
