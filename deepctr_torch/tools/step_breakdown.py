"""Speed-of-light audit of the full-vocab FNN train step -> ``ROOFLINE_TORCH.md``.

One tool where the reference has four; the counterpart of ``BENCH.md``'s
"Roofline: the full-vocab FNN step" (``BENCH.md:58-200``):

- ``tools/step_breakdown.py``: the full step with and without the fused
  tower (:85, ``use_pallas``), ``fwd_only`` (:137-153) and
  ``fwd_bwd_no_update`` (:156-177) -> the variants ``full``,
  ``full_plain_tower``, ``fwd_only`` and ``fwd_bwd_no_update``;
- ``tools/bench_step_breakdown.py::build`` (:42; variants :130): ``full``,
  ``no_sparse`` and ``fwd_only`` -> the same names;
- ``tools/profile_step.py``: ``gather_ms`` (:71), ``scatter_dense_ms`` (:89),
  ``adagrad_dense_ms`` (:112), ``adagrad_sorted_ms`` (:133),
  ``tower_fwdbwd_ms`` (:169) and ``full_step_ms`` (:197) -> the components
  ``gather``, ``scatter_dense``, ``adagrad_dense``, ``adagrad_sorted``,
  ``tower_fwdbwd`` and the ``full`` variant, with ``dense_adagrad`` (the
  tower's optimizer) and ``dropout_mask_plain`` (the plain tower's mask)
  added, each with its bytes, FLOP and bound;
- ``tools/roofline_lab.py``: the f32 and bf16 table variants (:37,
  :112-121) -> every part runs with both; ``--quality`` (:82-103) -> the
  AUC of each table dtype after 3 epochs and their difference.

Configuration: ``bench.py``'s, built by ``bench_suite.build``: FNN k=10, a 200-300-100 tanh tower with dropout 0.5 on
``ipinyou_full_schema()`` (927,658 rows, 18 slots, tower input 176), batch
8192, ``SparseAdagrad(0.05)`` in dense mode, Adagrad 0.02 on the tower, on
``synthetic.generate(k=2, seed=5)``, ``roofline_lab.py``'s data.

Protocol. Each variant is a body with ``train/step.py::_step_body``'s
signature run through ``chunk_route``: on the card one CUDA graph of K = 8
steps a replay, where the reference jits one ``lax.scan`` a variant. Wall
and device ms a step are ``bench_suite.measure``'s medians of 5
repeats over 2 chunks after an untimed replay (the capture is never
timed); ``full`` with each table dtype is also timed in turns, 5 passes
each (:func:`full_in_turns`). Components run as the step runs them, each
call a CUDA graph replay, timed by ``bench_suite.Bench.call_ms`` (CUDA
events around 50 calls behind a sleep kernel), at the step's shapes and on
the staged batch's ids; the gather and the sorted update rotate over table
copies that exceed the 50 MB L2, as the step finds the table cold after
the dense update's full-table passes. A bound is the larger of the bytes
at 3.35 TB/s (each input read once, each output written once; rows of the
table counted once per distinct id of the batch) and the FLOP at 67
TFLOP/s, or 165 TFLOP/s for the towers' 3xTF32 products.

Gates, raised on the card and the CPU alike (:func:`check_gates`):
``full``, ``no_sparse``, ``fwd_bwd_no_update`` and ``fwd_only`` give the
same first-step loss bit for bit from one state, batch and seeds;
``fwd_only`` and ``fwd_bwd_no_update`` leave the table, the accumulator and
every dense leaf as they were, ``no_sparse`` the table and the
accumulator; ``full``'s chunk equals ``make_scan_train_step``'s bit for bit;
``full_plain_tower``'s first loss is within ``PLAIN_RTOL``/``PLAIN_ATOL`` of
``full``'s; the tower launches a replay are as :func:`predicted_launches`
says.

Not ported, and why (TPU protocol, not decomposition): the marginal T/2T
``lax.scan`` timing (on the card CUDA events and a synchronize measure the
work); the split-plan variants ``no_scatter`` and ``no_big`` (the port
gathers and scatters all slots, ``ops/split_embed.py`` is a TPU gather
mechanism); the MXU-precision variants ``full_step_sel_*`` and
``full_step_all_bf16``; ``roofline_lab.py``'s bf16-scratch variant
(``SparseAdagrad.scratch_dtype`` is not ported, its win was noise).

Usage:
  python -m deepctr_torch.tools.step_breakdown --quality   # on the card
  python -m deepctr_torch.tools.step_breakdown --device cpu --small
``--parts`` is a comma list of ``variants,components,ops,batch`` (all by
default); ``--quality`` adds the AUC check. ``--device cuda`` (the default)
without a card raises. On the CPU every time is "not measured (cpu)", and
a file is written only where ``--out`` names one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time

import numpy as np
import torch

from ..utils.artifacts import protocol_stamp
from . import bench_suite

TOOL = "deepctr_torch/tools/step_breakdown.py"
PARTS = ("variants", "components", "ops", "batch")
VARIANTS = ("full", "no_sparse", "fwd_bwd_no_update", "fwd_only", "full_plain_tower")
TABLE_DTYPES = ("f32", "bf16")
SCAN_K = 8
CHUNKS = 2            # chunks a timed pass
BATCHES = (8192, 16384, 32768)
SMALL_DIV = 128       # --small: batch 64; the batch rows 64, 128, 256
DATA_K, DATA_SEED = 2, 5   # roofline_lab.py's data
GATE_SEED = 17        # the gate chunk's dropout seeds come from this
# the card's peaks (NVIDIA's H100 SXM data sheet): f32 on the CUDA cores,
# TF32 / 3 for 3xTF32 products, HBM
F32_FLOPS, TF32X3_FLOPS, HBM_BYTES = 67e12, 495e12 / 3, 3.35e12
L2_BYTES = 50 * 2**20
# full_plain_tower's first loss against full's: the kernels' 3xTF32 products
# against cuBLAS's f32 (allow_tf32 off), the kernel-vs-plain logit tolerance
# of chip_smoke.py; a mean of 8192 per-example losses moves by no more
PLAIN_RTOL, PLAIN_ATOL = 1e-4, 1e-5
COMPONENTS = ("gather", "scatter_dense", "adagrad_dense", "adagrad_sorted",
              "tower_fwdbwd", "dense_adagrad", "dropout_mask_plain")
# the components the full step runs (scatter_dense is inside adagrad_dense on
# the CPU alone: on the card the dense update is one kernel without it;
# adagrad_sorted and dropout_mask_plain are off its path)
STEP_COMPONENTS = ("gather", "adagrad_dense", "tower_fwdbwd", "dense_adagrad")
# per-row terms of the batch model: they grow with the batch
PER_ROW = ("gather", "scatter_dense", "tower_fwdbwd")
TOP_OPS = 12
NOT_MEASURED = "not measured (cpu)"


class GateError(AssertionError):
    """A gate of the audit failed."""


# ---- the variants ------------------------------------------------------------


def variant_body(name: str, schema, sparse_opt, dense_opt):
    """``body(state, ids, labels, weights, lr_scale, seed, dense=None) ->
    (loss, logits)`` of one variant, ``_step_body``'s signature, for FNN
    (which refuses ``dense``): ``full`` is
    ``_step_body`` itself; the others repeat its gather, forward and loss
    and then take fewer of its stages."""
    from ..models.base import lazy_l2, refuse_dense, weighted_bce_with_logits
    from ..ops.kernels.mlp import mlp_tower_plain
    from ..train.step import _step_body, dense_params

    if name == "full":
        return _step_body(schema, sparse_opt, dense_opt, 0.0, False)
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r} ({', '.join(VARIANTS)})")
    pad_id = schema.pad_id

    def body(state, ids, labels, weights, lr_scale, seed, dense=None):
        model = state.model
        refuse_dense(model, dense)
        mask = (ids != pad_id).float()
        rows = model.table.detach()[ids].float()
        if name == "fwd_only":
            with torch.no_grad():
                logits = model.apply_rows(rows, mask, train=True, seed=seed)
                loss = weighted_bce_with_logits(logits, labels, weights)
                return loss + lazy_l2(rows, mask, 0.0), logits
        rows.requires_grad_(True)
        params = dense_params(model)
        if name == "full_plain_tower":
            spec = model.mlp.spec
            logits = mlp_tower_plain(model.tower_input(rows, mask), model.mlp.params(),
                                     spec.activation, spec.dropout, seed)
        else:
            logits = model.apply_rows(rows, mask, train=True, seed=seed)
        loss = weighted_bce_with_logits(logits, labels, weights)
        loss = loss + lazy_l2(rows, mask, 0.0)
        # every gradient is taken; torch runs each op it is given and drops
        # no unused work, so the reference's `1e-30 * tiny` fold that kept XLA
        # from eliminating the gradients is not needed
        g_rows, *g_dense = torch.autograd.grad(loss, [rows] + params)
        if name == "full_plain_tower":
            sparse_opt.update(model.table.data, state.sparse_state, ids.reshape(-1),
                              g_rows.reshape(-1, g_rows.shape[-1]), lr_scale=lr_scale)
        if name != "fwd_bwd_no_update":
            dense_opt.update(params, g_dense, state.dense_state, lr_scale=lr_scale)
        return loss.detach(), logits.detach()

    return body


def variant_route(name: str, schema, sparse_opt, dense_opt):
    """The variant as ``chunk_route``'s ``run(state, ids, labels, weights,
    lr_scale, seeds)``: one CUDA graph of K steps on the card, K eager
    steps on the CPU. Each variant has its own route, so its own graph."""
    from ..train.step import chunk_route, touched_rows

    return chunk_route(variant_body(name, schema, sparse_opt, dense_opt), eager=False,
                       touched=lambda ids: touched_rows(ids, schema.pad_id))


def predicted_launches(name: str, cuda: bool) -> dict:
    """Tower launches a replay of K steps: ``fwd_dropout`` (the forward with
    dropout), ``fwd`` (without) and ``bwd``. A CPU tensor takes the plain
    path, which launches nothing; so does the plain tower."""
    if not cuda or name == "full_plain_tower":
        return {"fwd_dropout": 0, "fwd": 0, "bwd": 0}
    return {"fwd_dropout": SCAN_K, "fwd": 0, "bwd": 0 if name == "fwd_only" else SCAN_K}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                            1: torch.uint8}[t.element_size()])


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _state_parts(state) -> dict:
    """The table, the sparse accumulator and the dense leaves (the tower,
    its optimizer's state, the model's buffers) of a train state."""
    from ..train.step import _state_tensors

    sparse = [state.table, *state.sparse_state]
    return {"table": sparse[:1], "acc": sparse[1:],
            "dense": [t for t in _state_tensors(state) if all(t is not x for x in sparse)]}


def kept_parts(state, init) -> dict:
    """``{part: bool}``: whether each part of ``state`` has ``init``'s bits."""
    a, b = _state_parts(state), _state_parts(init)
    return {part: all(_same_bits(x, y) for x, y in zip(a[part], b[part], strict=True))
            for part in a}


def restore(dst, src) -> None:
    """``src``'s bits into ``dst``'s tensors in place (the addresses a
    captured graph holds stay valid), with its generator and step."""
    from ..train.step import _state_tensors

    with torch.no_grad():
        for a, b in zip(_state_tensors(dst), _state_tensors(src), strict=True):
            a.copy_(b)
    dst.generator.set_state(src.generator.get_state())
    dst.step = src.step


def gate_seeds() -> list[int]:
    """The K dropout seeds of the gate chunk."""
    return [int(s) for s in np.random.default_rng(GATE_SEED).integers(0, 1 << 24, SCAN_K)]


def run_variants(h, schema, chunks, device) -> dict:
    """Every variant from one state: the gate chunk (``chunks[0]`` with
    :func:`gate_seeds`) from the initial state, then ``measure``'s timed
    passes; the state is put back before each. ``full``'s gate chunk is
    also held against ``h.scan_step`` (``make_scan_train_step``) from the
    same state. Returns ``{variant: record}``."""
    cuda = device.type == "cuda"
    batch = chunks[0][0].shape[1]
    state, seeds = h.state, gate_seeds()
    init = state.clone()
    _, want_losses = h.scan_step(state, *chunks[0], seeds=seeds)
    want = state.clone()
    h.scan_step.graph.clear()
    out = {}
    for name in VARIANTS:
        restore(state, init)
        route = variant_route(name, schema, h.sparse_opt, h.dense_opt)
        _, losses, _ = route(state, *chunks[0], seeds=seeds)
        rec = {"first_loss": float(losses[0]), "kept": kept_parts(state, init)}
        if name == "full":
            rec["equals_scan_step"] = (_same_bits(losses, want_losses)
                                       and all(kept_parts(state, want).values()))
        measured = bench_suite.measure(lambda c, route=route: route(state, *c), chunks,
                                       device, batch)
        replays = len(chunks)
        last = measured["launches"]
        rec["launches"] = {"fwd_dropout": last["fwd_dropout"] // replays,
                           "fwd": (last["fwd"] - last["fwd_dropout"]) // replays,
                           "bwd": last["bwd"] // replays}
        rec["kept_after_replays"] = kept_parts(state, init)
        rec["wall_ms"] = measured["wall_ms"] if cuda else None
        rec["device_ms"] = measured["device_ms"]
        route.graph.clear()
        out[name] = rec
    restore(state, init)
    return out


def check_gates(variants: dict, cuda: bool) -> list[dict]:
    """The gates over one table dtype's :func:`run_variants` records:
    ``[{"gate", "ok", "detail"}]``, every gate whose variants were run."""
    gates = []

    def gate(name, ok, detail):
        gates.append({"gate": name, "ok": bool(ok), "detail": detail})

    same = [n for n in ("full", "no_sparse", "fwd_bwd_no_update", "fwd_only")
            if n in variants]
    if len(same) > 1:
        losses = {n: variants[n]["first_loss"] for n in same}
        gate("first-step loss bit for bit: " + ", ".join(same),
             len({np.float32(v).tobytes() for v in losses.values()}) == 1,
             ", ".join(f"{n} {v!r}" for n, v in losses.items()))
    for name, parts in (("fwd_only", ("table", "acc", "dense")),
                        ("fwd_bwd_no_update", ("table", "acc", "dense")),
                        ("no_sparse", ("table", "acc"))):
        if name in variants:
            rec = variants[name]
            kept = {p: rec["kept"][p] and rec["kept_after_replays"][p] for p in parts}
            gate(f"{name} keeps the bits of {', '.join(parts)}", all(kept.values()),
                 ", ".join(f"{p} {'kept' if k else 'CHANGED'}" for p, k in kept.items()))
    if "full" in variants:
        gate("full's chunk equals make_scan_train_step's bit for bit",
             variants["full"]["equals_scan_step"], "losses, table, accumulator, dense")
        if "full_plain_tower" in variants:
            a = variants["full"]["first_loss"]
            b = variants["full_plain_tower"]["first_loss"]
            gate(f"full_plain_tower's first loss within rtol {PLAIN_RTOL:g} / atol "
                 f"{PLAIN_ATOL:g} of full's", abs(a - b) <= PLAIN_ATOL + PLAIN_RTOL * abs(a),
                 f"{b!r} against {a!r}, difference {abs(a - b):.3e}")
    for name, rec in variants.items():
        want = predicted_launches(name, cuda)
        gate(f"{name}: tower launches a replay as predicted", rec["launches"] == want,
             f"{rec['launches']} (predicted {want})")
    return gates


def raise_failed(gates: list[dict]) -> None:
    failed = [g for g in gates if not g["ok"]]
    if failed:
        raise GateError("; ".join(f"{g['gate']}: {g['detail']}" for g in failed))


# ---- the components --------------------------------------------------------


def tower_flop(batch: int, dims) -> tuple[int, int]:
    """FLOP of the tower's forward (every layer's product) and backward (the
    hidden layers' recompute, the transposed chain and the weight-gradient
    products) at ``[batch, dims[0]]``."""
    macs = [a * b for a, b in zip(dims[:-1], dims[1:])]
    return 2 * batch * sum(macs), 2 * batch * (sum(macs[:-1]) + 2 * sum(macs))


def tower_params(dims) -> int:
    return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))


def component_work(name: str, *, batch: int, slots: int, d: int, vocab: int,
                   unique: int, table_bytes: int, dims, cuda: bool = False) -> dict:
    """Bytes and FLOP of one component at the step's shapes, each input read
    once and each output written once, and the peak that bounds its FLOP.
    ``unique`` is the batch's distinct ids (the rows a gather, the sorted
    update or the dense-mode kernel must touch), ``table_bytes`` the table's
    element size; ``cuda`` says the dense-mode update runs as its kernel,
    which touches those rows alone, and not as the plain version's
    whole-table pass."""
    m = batch * slots
    ids, occ = 8 * m, 4 * m * d                      # int64 ids, f32 occurrence rows
    rows_t, rows_acc = unique * d * table_bytes, unique * d * 4
    full_t, full_acc = vocab * d * table_bytes, vocab * d * 4
    params = tower_params(dims)
    hidden = sum(dims[1:-1])
    peak = F32_FLOPS
    if name == "gather":
        nbytes, flop = ids + rows_t + occ, 0
    elif name == "scatter_dense":
        nbytes, flop = ids + occ + full_acc, m * d
    elif name == "adagrad_dense" and not cuda:
        # ids and rows in; table and accumulator read and written; 7 ops an
        # element (g*g, acc +=, sqrt, + eps, lr *, /, table -)
        nbytes, flop = ids + occ + 2 * (full_t + full_acc), m * d + 7 * vocab * d
    elif name in ("adagrad_dense", "adagrad_sorted"):
        nbytes, flop = ids + occ + 2 * (rows_t + rows_acc), m * d + 7 * unique * d
    elif name == "tower_fwdbwd":
        # x, the parameters and g in; logits, gx and the gradients out
        fwd, bwd = tower_flop(batch, dims)
        nbytes = 4 * (2 * batch * dims[0] + 2 * params + 2 * batch)
        flop, peak = fwd + bwd, TF32X3_FLOPS
    elif name == "dense_adagrad":
        # parameters, gradients and accumulators in; parameters and
        # accumulators out; 8 ops an element
        nbytes, flop = 4 * 5 * params, 8 * params
    elif name == "dropout_mask_plain":
        # the masks written; the hash's integer ops have no peak in the table
        nbytes, flop = 4 * batch * hidden, 0
    else:
        raise ValueError(f"unknown component {name!r}")
    return {"bytes": int(nbytes), "flop": int(flop), "peak_flops": peak}


def bound(work: dict) -> dict:
    """The least time of ``work`` on the card: the larger of its bytes at
    3.35 TB/s and its FLOP at its peak."""
    bytes_ms = work["bytes"] / HBM_BYTES * 1e3
    flop_ms = work["flop"] / work["peak_flops"] * 1e3
    return {"bound_ms": max(bytes_ms, flop_ms),
            "bound_by": "operations" if flop_ms > bytes_ms else "bytes"}


def _copies(table: torch.Tensor, acc: torch.Tensor, cuda: bool) -> tuple[list, list]:
    """As many copies of the table and of the accumulator as make the
    tables' bytes together exceed three L2s (one of each on the CPU): a
    call on each pair in turn finds its operands cold."""
    n = max(2, -(-3 * L2_BYTES // (table.numel() * table.element_size()))) if cuda else 1
    return [table.clone() for _ in range(n)], [acc.clone() for _ in range(n)]


def component_calls(h, ids: torch.Tensor, seed: int) -> dict:
    """``{component: [callable, ...]}``: one call of each at the step's
    shapes on ``h``'s state (copies of it where a call writes), the batch
    ``ids``; the gather and the sorted update have one callable a copy of
    the table and accumulator, taken in turn."""
    from ..ops.kernels.mlp import dropout_mask_plain, mlp_tower
    from ..ops.scatter import scatter_totals
    from ..optim import SparseAdagrad
    from ..optim.sparse import SparseAdagradState

    state = h.state
    table, device = state.table, state.table.device
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = ids.reshape(-1)
    g_rows = torch.randn(flat.shape[0], table.shape[1], generator=gen, device=device) * 1e-3
    tables, accs = _copies(table, state.sparse_state.acc, device.type == "cuda")
    dense = SparseAdagrad(h.sparse_opt.learning_rate, mode="dense")
    sorted_ = SparseAdagrad(h.sparse_opt.learning_rate, mode="sorted")

    def adagrad(opt, i):
        return lambda: opt.update(tables[i], SparseAdagradState(acc=accs[i]), flat, g_rows)

    tower = state.model.mlp
    spec = tower.spec
    x = torch.randn(ids.shape[0], tower.layers[0].w.shape[0], generator=gen,
                    device=device).requires_grad_(True)
    layers = [(w.detach().clone().requires_grad_(True),
               b.detach().clone().requires_grad_(True)) for w, b in tower.params()]
    flat_params = [t for layer in layers for t in layer]
    g = torch.ones(ids.shape[0], device=device)

    def tower_fwdbwd():
        out = mlp_tower(x, layers, spec.activation, spec.dropout, seed)
        return torch.autograd.grad(out, [x] + flat_params, g)

    params = [t.detach().clone() for t in flat_params]
    grads = [torch.randn(t.shape, generator=gen, device=device) * 1e-3 for t in params]
    opt_state = h.dense_opt.init(params)

    def masks():
        return [dropout_mask_plain((ids.shape[0], w), 1.0 - spec.dropout, seed, layer,
                                   device=device)
                for layer, w in enumerate(spec.hidden)]

    return {
        "gather": [lambda t=t: t[ids].float() for t in tables],
        "scatter_dense": [lambda: scatter_totals(table.shape[0], flat, g_rows)],
        "adagrad_dense": [adagrad(dense, 0)],
        "adagrad_sorted": [adagrad(sorted_, i) for i in range(len(tables))],
        "tower_fwdbwd": [tower_fwdbwd],
        "dense_adagrad": [lambda: h.dense_opt.update(params, grads, opt_state)],
        "dropout_mask_plain": [masks],
    }


def _in_turn(fns: list, cuda: bool):
    """One call a turn over ``fns``; on the card each is a CUDA graph
    captured after a warm-up call, as the step runs: timing the calls
    eagerly would time the host, whose launches of a component of tens
    of kernels fall behind the card once the device's queue is full."""
    if cuda:
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for fn in fns:
                fn()
        torch.cuda.current_stream().wait_stream(stream)
        graphs = []
        for fn in fns:
            graphs.append(torch.cuda.CUDAGraph())
            with torch.cuda.graph(graphs[-1]):
                fn()
        fns = [g.replay for g in graphs]
    turn = [0]

    def call():
        turn[0] = (turn[0] + 1) % len(fns)
        fns[turn[0]]()

    return call


def _device_ops(fn) -> dict:
    """``{op: (device µs, launches)}`` of one call of ``fn`` under
    ``torch.profiler``, after a warm call, most time first. Ops keep their
    full names: kernels that differ in a template argument stay apart."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            ops[e.key] = (float(e.self_cuda_time_total if us is None else us), e.count)
    return dict(sorted(ops.items(), key=lambda kv: -kv[1][0]))


def run_components(h, ids: torch.Tensor, seed: int) -> tuple[dict, dict]:
    """Each component's time, bytes, FLOP, bound and share at the step's
    shapes; and, on the card, the names of the device ops each launches
    (for the op table's attribution)."""

    device = h.state.table.device
    cuda = device.type == "cuda"
    bench = bench_suite.Bench(device, small=False, tmp="", results={})
    calls = component_calls(h, ids, seed)
    spec = h.state.model.mlp.spec
    dims = (h.state.model.mlp.layers[0].w.shape[0], *spec.hidden, 1)
    unique = int(torch.unique(ids.reshape(-1)).numel())
    shape = dict(batch=ids.shape[0], slots=ids.shape[1], d=h.state.table.shape[1],
                 vocab=h.state.table.shape[0], unique=unique,
                 table_bytes=h.state.table.element_size(), dims=dims)
    out, names = {}, {}
    for name in COMPONENTS:
        if cuda:
            names[name] = set(_device_ops(calls[name][0]))
        call = _in_turn(calls[name], cuda)
        ms = bench.call_ms(call)
        del call
        work = component_work(name, **shape, cuda=cuda)
        rec = {**work, **bound(work), "unique_ids": unique,
               "ms": ms if cuda else None, "in_step": name in STEP_COMPONENTS}
        rec["share"] = rec["bound_ms"] / ms if cuda else None
        out[name] = rec
    return out, names


def ptxas_lines(cuda: bool) -> list[str]:
    """The build log's ptxas lines on the tower kernels' registers and any
    ``wgmma`` serialization (the weight-gradient kernel's, PERF.md)."""
    if not cuda:
        return []
    from ..ops.kernels import _build

    path = _build.compile_library() + ".log"
    lines, name = [], "?"
    with open(path) as f:
        for line in f:
            entry = re.search(r"entry function '.*?\d+(tower_\w+?_kernel)", line)
            if entry:
                name = entry.group(1)
            elif "serialized" in line:
                named = re.search(r"\d+(tower_\w+?_kernel)", line)
                lines.append(f"{named.group(1) if named else name}: {line.strip()}")
            elif name.startswith("tower_wgrad") and "registers" in line:
                lines.append(f"{name}: {line.strip()}")
    return sorted(set(lines))


# the full step's pieces, each a difference of two variants' device ms
PIECES = (("forward: fwd_only", None, "fwd_only"),
          ("backward: fwd_bwd_no_update - fwd_only", "fwd_bwd_no_update", "fwd_only"),
          ("dense update: no_sparse - fwd_bwd_no_update", "no_sparse",
           "fwd_bwd_no_update"),
          ("sparse update: full - no_sparse", "full", "no_sparse"))


def _piece_ms(variants: dict, a, b):
    """``a``'s device ms less ``b``'s (``b``'s alone where ``a`` is None)."""
    if variants[b]["device_ms"] is None:
        return None
    return variants[b]["device_ms"] if a is None else (
        variants[a]["device_ms"] - variants[b]["device_ms"])


def roofline(variants: dict, components: dict, cuda: bool) -> dict:
    """The composite bound (the sum of the bounds of the components the
    full step runs, ``BENCH.md:117-125``'s definition) against the measured
    ``full`` step; the step's pieces from the variants' differences; and
    the kernels' in-step gain, with and without the plain tower's mask."""
    composite = sum(components[c]["bound_ms"] for c in STEP_COMPONENTS)
    summed = sum(components[c]["ms"] for c in STEP_COMPONENTS) if cuda else None
    full = variants["full"]["device_ms"]
    mask = components["dropout_mask_plain"]["ms"]
    plain = variants["full_plain_tower"]["device_ms"]
    gain = _piece_ms(variants, "full_plain_tower", "full")
    return {"composite_bound_ms": composite, "components_ms": summed,
            "full_device_ms": full, "share": composite / full if full else None,
            "residual_ms": None if summed is None else full - summed,
            "pieces": {label: _piece_ms(variants, a, b) for label, a, b in PIECES},
            "kernels_gain_ms": gain,
            "kernels_gain_without_mask_ms": None if mask is None else gain - mask,
            "plain_tower_without_mask_ms": None if mask is None else plain - mask}


def op_component(name: str, launched_by: dict) -> str:
    """The component(s) whose own calls launch the device op ``name``, or
    "other" (pooling, loss, casts: no component's)."""
    hits = [c for c in COMPONENTS if name in launched_by.get(c, ())]
    return "/".join(hits) if hits else "other (pooling, loss, casts)"


def run_ops(h, schema, chunks, launched_by: dict) -> list:
    """``torch.profiler`` over one replay of ``full`` (after one that
    captures): every device op, most time first, with its µs and launches
    a step, its share and its component. Raises where the profiler gives
    no device time."""
    route = variant_route("full", schema, h.sparse_opt, h.dense_opt)
    init = h.state.clone()
    try:
        ops = _device_ops(lambda: route(h.state, *chunks[0]))
    finally:
        restore(h.state, init)
        route.graph.clear()
    total = sum(us for us, _ in ops.values())
    if not total:
        raise RuntimeError("torch.profiler gave no device time for the graph's kernels")
    return [{"name": key, "us_per_step": us / SCAN_K, "launches_per_step": n / SCAN_K,
             "share": us / total, "component": op_component(key, launched_by)}
            for key, (us, n) in ops.items()]


def batch_scaling(h, schema, ds, batches, components, device) -> list:
    """``full`` (the state's table dtype) at each batch, against the
    component model: the per-row terms (``PER_ROW``) scale with the batch,
    the rest of the first batch's step is fixed."""
    cuda = device.type == "cuda"
    rows = []
    init = h.state.clone()
    for batch in batches:
        chunks = bench_suite.stage(ds.ids, ds.labels, batch, CHUNKS * SCAN_K, device)
        route = variant_route("full", schema, h.sparse_opt, h.dense_opt)
        measured = bench_suite.measure(lambda c, route=route: route(h.state, *c), chunks,
                                       device, batch)
        restore(h.state, init)
        route.graph.clear()
        rows.append({"batch": batch, "device_ms": measured["device_ms"],
                     "wall_ms": measured["wall_ms"] if cuda else None})
        del chunks
    if cuda:
        per_row = sum(components[c]["ms"] for c in PER_ROW)
        fixed = rows[0]["device_ms"] - per_row
        for r in rows:
            r["predicted_ms"] = fixed + per_row * r["batch"] / batches[0]
            r["error"] = r["predicted_ms"] / r["device_ms"] - 1
    return rows


def full_in_turns(heads: dict, schema, chunks, device) -> dict | None:
    """``full`` with each table dtype timed in turns (f32, bf16, bf16, f32,
    ...), ``REPEATS`` passes over ``chunks`` each after a capture: the
    device ms a step of every pass, their median and range. None on the
    CPU. The variants' medians come from one dtype after the other; this
    is the comparison that can tell a difference from drift."""
    if device.type != "cuda":
        return None
    steps = sum(c[0].shape[0] for c in chunks)
    inits = {d: h.state.clone() for d, h in heads.items()}
    routes = {d: variant_route("full", schema, h.sparse_opt, h.dense_opt)
              for d, h in heads.items()}
    samples: dict = {d: [] for d in heads}
    try:
        for d, h in heads.items():
            routes[d](h.state, *chunks[0])   # the capture and a replay
        order = list(heads)
        for r in range(bench_suite.REPEATS):
            for d in order if r % 2 == 0 else order[::-1]:
                _, ms = bench_suite.time_pass(
                    lambda c, d=d: routes[d](heads[d].state, *c), chunks, device)
                samples[d].append(ms / steps)
    finally:
        for d, h in heads.items():
            restore(h.state, inits[d])
            routes[d].graph.clear()
    return {d: {"device_ms": v, "median": float(np.median(v)), "min": min(v),
                "max": max(v)} for d, v in samples.items()}


def quality(device, small: bool) -> dict:
    """``roofline_lab.py --quality``: FNN k=10 with a 64-32 tower, dropout 0,
    3 epochs of batch 1024 on ``ipinyou_like_schema()``'s 60,000 rows of
    the mlp teacher (seed 7), 85% train, with an f32 and a bf16 table
    through ``train/loop.py::fit``; the best AUC of each and the bf16 one's
    difference."""
    from ..data import ipinyou_like_schema, synthetic
    from ..models import MlpSpec, make_fnn
    from ..optim import SparseAdagrad, make_dense_optimizer
    from ..train import fit

    schema = ipinyou_like_schema()
    n = 4000 if small else 60_000
    ds = synthetic.generate(schema, num_examples=n, k=4, seed=7, teacher="mlp")
    tr, te = slice(0, int(0.85 * n)), slice(int(0.85 * n), n)
    out = {"examples": n}
    for dtype in TABLE_DTYPES:
        model = make_fnn(schema, k=10, mlp=MlpSpec(hidden=(64, 32), dropout=0.0),
                         device=device)
        res = fit(model, schema, ds.ids[tr], ds.labels[tr], ds.ids[te], ds.labels[te],
                  sparse_opt=SparseAdagrad(0.05),
                  dense_opt=make_dense_optimizer("adagrad", 0.02),
                  batch_size=256 if small else 1024, epochs=1 if small else 3, seed=0,
                  prefetch=False, early_stop_patience=99, table_dtype=dtype)
        out[f"auc_{dtype}"] = float(res.best_auc)
    out["delta_auc_bf16"] = out["auc_bf16"] - out["auc_f32"]
    return out


# ---- the run and its report --------------------------------------------------


def _ms(v) -> str:
    return NOT_MEASURED if v is None else f"{v:.4f}"


def _fmt_int(v: int) -> str:
    return f"{v:,}"


def report_lines(res: dict) -> list[str]:
    """``ROOFLINE_TORCH.md``'s body (everything but the title and footer)."""
    cuda = res["cuda"]
    lines = [f"Device: {res['where']}.", "",
             f"Configuration: {res['config']}.", "",
             "Protocol: each variant is one CUDA graph of 8 steps a replay "
             "(`train/step.py::chunk_route`); wall and device ms a step are "
             "`bench_suite.measure`'s medians of 5 repeats of 2 replays after an "
             "untimed one (the capture is never timed), device ms from CUDA events; "
             "`full` of each table dtype also in turns, 5 passes each. Components: "
             "each call a CUDA graph replay, as in the step, CUDA events around 50 "
             "calls behind a sleep kernel (`bench_suite.Bench.call_ms`) at the step's "
             "shapes and on the staged batch's ids; the gather and the sorted update "
             "rotate over table copies past the 50 MB L2. Bound: the larger of the "
             "bytes at 3.35 TB/s (each "
             "input read once, each output written once; table rows once per distinct "
             "id) and the FLOP at 67 TFLOP/s (165 for the towers' 3xTF32 products); "
             "share = bound / measured.", ""]
    for dtype in res["dtypes"]:
        variants = res["variants"].get(dtype)
        if variants:
            lines += [f"## Step variants, {dtype} table", "",
                      "| variant | wall ms/step | device ms/step | tower launches a replay "
                      "(fwd dropout / fwd / bwd) | first-step loss |",
                      "|---|---|---|---|---|"]
            for name, rec in variants.items():
                la = rec["launches"]
                lines.append(f"| {name} | {_ms(rec['wall_ms'])} | {_ms(rec['device_ms'])} "
                             f"| {la['fwd_dropout']} / {la['fwd']} / {la['bwd']} | "
                             f"{rec['first_loss']!r} |")
            lines.append("")
            lines += ["| gate | result | detail |", "|---|---|---|"]
            for g in res["gates"][dtype]:
                lines.append(f"| {g['gate']} | {'pass' if g['ok'] else 'FAIL'} | "
                             f"{g['detail']} |")
            lines.append("")
        comps = res["components"].get(dtype)
        if comps:
            lines += [f"## Components, {dtype} table", "",
                      "| component | ms | bytes | FLOP | bound ms | bound by | share of "
                      "bound | in the full step |", "|---|---|---|---|---|---|---|---|"]
            for name, c in comps.items():
                share = NOT_MEASURED if c["share"] is None else f"{100 * c['share']:.1f}%"
                in_step = ("yes" if c["in_step"] else "within adagrad_dense"
                           if name == "scatter_dense" and not cuda else "no")
                lines.append(f"| {name} | {_ms(c['ms'])} | {_fmt_int(c['bytes'])} | "
                             f"{_fmt_int(c['flop'])} | {c['bound_ms']:.4f} | {c['bound_by']} "
                             f"| {share} | {in_step} |")
            lines += ["", f"Distinct ids in the batch: {comps['gather']['unique_ids']:,} "
                      f"of {res['occurrences']:,} occurrences."]
            if cuda:
                lines += ["", "On the card `adagrad_dense` times "
                          "`ops/kernels/sparse.py::adagrad_dense_update`, which reads and "
                          "writes the touched rows alone, and its bytes and bound count "
                          "those rows, as `chip_smoke.py` phase 26 does at this shape "
                          "and phase 27 at DLRM-DCNv2's."]
            if dtype == res["dtypes"][0] and res.get("ptxas"):
                lines += ["", "ptxas on the tower kernels, beside `tower_fwdbwd`'s time:"]
                lines += [f"- `{x}`" for x in res["ptxas"]]
            lines.append("")
    if res["roofline"]:
        dts = [d for d in res["dtypes"] if d in res["roofline"]]
        lines += ["## Composite bound and attribution", "",
                  "| measure | " + " | ".join(f"{d} table" for d in dts) + " |",
                  "|---" * (len(dts) + 1) + "|"]
        rows = [(f"composite bound ms ({' + '.join(STEP_COMPONENTS)})", "composite_bound_ms"),
                ("those components measured, ms", "components_ms"),
                ("full step, device ms", "full_device_ms"),
                ("residual: full - components (pooling, loss, casts), ms", "residual_ms"),
                *((f"{label}, ms", label) for label, _, _ in PIECES),
                ("kernels' in-step gain: full_plain_tower - full, ms", "kernels_gain_ms"),
                ("the same less the plain mask (dropout_mask_plain), ms",
                 "kernels_gain_without_mask_ms"),
                ("full_plain_tower less the plain mask, ms", "plain_tower_without_mask_ms")]
        for label, key in rows:
            lines.append(f"| {label} | " + " | ".join(
                _ms(res["roofline"][d].get(key, res["roofline"][d]["pieces"].get(key)))
                for d in dts) + " |")
        lines.append("| share of the composite bound | " + " | ".join(
            NOT_MEASURED if res["roofline"][d]["share"] is None
            else f"{100 * res['roofline'][d]['share']:.1f}%" for d in dts) + " |")
        lines.append("")
    if res.get("h10"):
        lines += ["## bf16 against f32 by piece and component (H10)", "",
                  "| step, piece or component | f32 ms | bf16 ms | bf16 - f32 ms |",
                  "|---|---|---|---|"]
        for r in res["h10"]:
            lines.append(f"| {r['name']} | {_ms(r['f32'])} | {_ms(r['bf16'])} | "
                         f"{_ms(r['delta'])} |")
        lines += ["", res["h10_answer"], ""]
    if res["ops"]:
        for dtype, ops in res["ops"].items():
            lines += [f"## Top device ops of one replay of full, {dtype} table", ""]
            if isinstance(ops, str):
                lines += [ops, ""]
                continue
            lines += ["| op | µs a step | launches a step | share | component |",
                      "|---|---|---|---|---|"]
            for op in ops[:TOP_OPS]:
                lines.append(f"| `{op['name'][:100]}` | {op['us_per_step']:.2f} | "
                             f"{op['launches_per_step']:g} | {100 * op['share']:.1f}% | "
                             f"{op['component']} |")
            lines += ["", "An op that several components launch names each; "
                      "\"other\" is no component's (pooling, loss, casts).", ""]
    if res.get("ops_diff"):
        lines += ["## Device ops, bf16 against f32 table (one replay of full)", "",
                  "| op | f32 µs a step | bf16 µs a step | bf16 - f32 | component |",
                  "|---|---|---|---|---|"]
        for d in res["ops_diff"]:
            lines.append(f"| `{d['name'][:100]}` | {d['f32_us']:.2f} | {d['bf16_us']:.2f} | "
                         f"{d['delta_us']:+.2f} | {d['component']} |")
        lines.append("")
    if res["batch"]:
        lines += ["## Batch scaling, full step, f32 table", "",
                  "| batch | wall ms/step | device ms/step | predicted ms | error |",
                  "|---|---|---|---|---|"]
        for r in res["batch"]:
            err = r.get("error")
            lines.append(f"| {r['batch']} | {_ms(r['wall_ms'])} | {_ms(r['device_ms'])} | "
                         f"{_ms(r.get('predicted_ms'))} | "
                         f"{NOT_MEASURED if err is None else f'{100 * err:+.1f}%'} |")
        lines += ["", "Model: the per-row components (" + ", ".join(PER_ROW) + ") at "
                  "the first batch scale with the batch; the rest of its full step is "
                  "fixed. No gate.", ""]
    if res.get("quality"):
        q = res["quality"]
        lines += ["## Quality (--quality)", "",
                  "| table | AUC |", "|---|---|",
                  f"| f32 | {q['auc_f32']:.4f} |", f"| bf16 | {q['auc_bf16']:.4f} |",
                  f"| ΔAUC bf16 - f32 | {q['delta_auc_bf16']:+.4f} |", "",
                  f"`roofline_lab.py --quality`'s protocol: {q['examples']:,} rows of "
                  "`ipinyou_like_schema()`, mlp teacher, seed 7.", ""]
    return lines


def h10_rows(res: dict) -> tuple[list, str]:
    """bf16 against f32: the full step, its pieces (the variants'
    differences) and each component alone, device ms and the difference;
    and the answer: which pieces and ops take the bf16 step's extra time."""
    comps, variants = res["components"], res["variants"]
    rows: list[dict] = []

    def row(name, a, b):
        rows.append({"name": name, "f32": a, "bf16": b,
                     "delta": None if a is None or b is None else b - a})

    roof = res["roofline"]
    if all(d in roof for d in TABLE_DTYPES):
        row("full step", variants["f32"]["full"]["device_ms"],
            variants["bf16"]["full"]["device_ms"])
        for label, _, _ in PIECES:
            row(label, roof["f32"]["pieces"][label], roof["bf16"]["pieces"][label])
    if all(comps.get(d) for d in TABLE_DTYPES):
        for name in COMPONENTS:
            row(f"{name} alone", comps["f32"][name]["ms"], comps["bf16"][name]["ms"])
    turns = res.get("turns")
    if turns:
        row("full step in turns (median)", turns["f32"]["median"], turns["bf16"]["median"])
    if not turns or not rows or rows[0]["name"] != "full step":
        return rows, "Not measured (cpu): no answer to H10 from this run."
    delta = turns["bf16"]["median"] - turns["f32"]["median"]
    spread = max(t["max"] - t["min"] for t in turns.values())
    pieces = sorted(rows[1:1 + len(PIECES)], key=lambda r: -r["delta"])
    text = (f"In turns ({len(turns['f32']['device_ms'])} passes each), the bf16 step "
            f"takes {delta:+.4f} ms of device time against the f32 step's (f32 "
            f"{turns['f32']['min']:.4f}-{turns['f32']['max']:.4f}, bf16 "
            f"{turns['bf16']['min']:.4f}-{turns['bf16']['max']:.4f} ms): "
            + ("more than" if abs(delta) > spread else "within")
            + f" the larger range, {spread:.4f} ms. From the variants one dtype after "
            f"the other: {rows[0]['delta']:+.4f} ms, by piece "
            + ", ".join(f"{r['name'].split(':')[0]} {r['delta']:+.4f}" for r in pieces)
            + " ms.")
    diff = res.get("ops_diff")
    if diff:
        text += (" By op in one replay (torch.profiler, bf16 - f32 µs a step): "
                 + ", ".join(f"`{d['name'][:60]}` ({d['component']}) {d['delta_us']:+.2f}"
                             for d in diff[:6]) + ".")
    return rows, text


def ops_diff(ops: dict) -> list:
    """The device ops whose µs a step differ most between the bf16 and the
    f32 step's replay (an op one replay lacks counts 0 there)."""
    a = {o["name"]: o for o in ops["f32"]}
    b = {o["name"]: o for o in ops["bf16"]}
    out = [{"name": n, "component": (b.get(n) or a.get(n))["component"],
            "f32_us": a[n]["us_per_step"] if n in a else 0.0,
            "bf16_us": b[n]["us_per_step"] if n in b else 0.0} for n in set(a) | set(b)]
    for d in out:
        d["delta_us"] = d["bf16_us"] - d["f32_us"]
    return sorted(out, key=lambda d: -abs(d["delta_us"]))[:TOP_OPS]


def write(path: str, res: dict) -> None:
    with open(path, "w") as f:
        f.write("# ROOFLINE_TORCH — speed-of-light audit of the full-vocab FNN train "
                "step (deepctr_torch)\n\n")
        f.write("\n".join(report_lines(res)))
        f.write(f"\nGenerated by `python -m deepctr_torch.tools.step_breakdown` at "
                f"{time.ctime()}. {protocol_stamp(TOOL)}\n")
    with open(os.path.splitext(path)[0] + ".json", "w") as f:
        json.dump(res, f, indent=1, default=str)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    p.add_argument("--small", action="store_true", help="cut every size (the tests)")
    p.add_argument("--parts", default=",".join(PARTS),
                   help="comma list out of: " + ",".join(PARTS))
    p.add_argument("--quality", action="store_true",
                   help="also train the f32 and bf16 tables 3 epochs and compare AUC")
    p.add_argument("--out", help="the markdown file (default ROOFLINE_TORCH.md on the "
                   "card; on the CPU no file without it); the JSON goes beside it")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the audit, print its report and write it; returns the record."""
    from ..cli import resolve_device
    from ..data import ipinyou_full_schema, ipinyou_like_schema, synthetic
    from ..ops.kernels import count_difference, launch_counts, tower_launches
    from .reproduce import card_line

    args = parse_args(argv)
    parts = [p for p in args.parts.split(",") if p]
    unknown = sorted(set(parts) - set(PARTS))
    if unknown:
        raise ValueError(f"unknown parts {unknown} (known: {', '.join(PARTS)})")
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    if cuda and args.small:
        raise ValueError("--small is the CPU tests' cut: run the card at full size")
    card = card_line() if cuda else None
    if cuda and card is None:
        raise RuntimeError("nvidia-smi gave no card name and power limit")
    where = (f"{torch.cuda.get_device_name(device)}; nvidia-smi: {card}; torch "
             f"{torch.__version__}, CUDA {torch.version.cuda}" if cuda
             else f"cpu (the kernels' plain versions); torch {torch.__version__}")
    print(where)
    if args.small:
        schema, hidden = ipinyou_like_schema(), (16, 8)
        batches = tuple(b // SMALL_DIV for b in BATCHES)
    else:
        schema, hidden = ipinyou_full_schema(), bench_suite.HIDDEN
        batches = BATCHES
    batch = batches[0]
    top = batches[-1] if "batch" in parts else batch
    t0 = time.perf_counter()
    ds = synthetic.generate(schema, num_examples=CHUNKS * SCAN_K * top, k=DATA_K,
                            seed=DATA_SEED)
    print(f"data: {len(ds.labels):,} rows made in {time.perf_counter() - t0:.1f} s")
    res = {"cuda": cuda, "where": where, "card": card, "dtypes": list(TABLE_DTYPES),
           "config": (f"FNN k={bench_suite.K}, {'-'.join(map(str, hidden))} tanh, "
                      f"dropout "
                      f"{bench_suite.DROPOUT}; {schema.padded_vocab_size:,} table rows x "
                      f"{bench_suite.K + 1}, {schema.num_slots} slots; batch {batch}; "
                      f"SparseAdagrad({bench_suite.SPARSE_LR}) dense mode, "
                      f"Adagrad({bench_suite.DENSE_LR}) "
                      f"on the tower; synthetic.generate(k={DATA_K}, seed={DATA_SEED})"),
           "occurrences": batch * schema.num_slots, "ptxas": ptxas_lines(cuda),
           "variants": {}, "gates": {}, "components": {}, "roofline": {}, "ops": {},
           "batch": [], "turns": None, "quality": None}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain tower in full f32
    launches = dict.fromkeys(("fwd", "fwd_dropout", "bwd", "fm_score"), 0)

    def counted(fn, *a):
        """``fn(*a)``, its tower launches added to the run's."""
        before = launch_counts()
        out = fn(*a)
        for name, n in tower_launches(count_difference(launch_counts(), before)).items():
            launches[name] += n
        return out

    heads = {d: bench_suite.build(schema, device, table_dtype=d, hidden=hidden)
             for d in TABLE_DTYPES}
    chunks = bench_suite.stage(ds.ids, ds.labels, batch, CHUNKS * SCAN_K, device)
    try:
        for dtype, h in heads.items():
            launched_by = {}
            if "variants" in parts:
                t0 = time.perf_counter()
                res["variants"][dtype] = counted(run_variants, h, schema, chunks, device)
                res["gates"][dtype] = check_gates(res["variants"][dtype], cuda)
                print(f"{dtype}: variants in {time.perf_counter() - t0:.1f} s")
                raise_failed(res["gates"][dtype])
            if "components" in parts:
                t0 = time.perf_counter()
                res["components"][dtype], launched_by = run_components(
                    h, chunks[0][0][0], GATE_SEED)
                print(f"{dtype}: components in {time.perf_counter() - t0:.1f} s")
            if "variants" in parts and "components" in parts:
                res["roofline"][dtype] = roofline(res["variants"][dtype],
                                                  res["components"][dtype], cuda)
            if "ops" in parts:
                res["ops"][dtype] = (run_ops(h, schema, chunks, launched_by) if cuda
                                     else f"{NOT_MEASURED}: no device op to trace.")
            if "batch" in parts and dtype == "f32":
                if "components" not in parts:
                    raise ValueError("--parts batch needs components (its model)")
                t0 = time.perf_counter()
                res["batch"] = counted(batch_scaling, h, schema, ds, batches,
                                       res["components"]["f32"], device)
                print(f"batch scaling in {time.perf_counter() - t0:.1f} s")
        if "variants" in parts:
            res["turns"] = counted(full_in_turns, heads, schema, chunks, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del heads, chunks
    # the tower launches of the step's runs (variants and batch rows: each
    # capture's warm-up step and the replays)
    res["launches_total"] = launches
    if all(isinstance(res["ops"].get(d), list) for d in TABLE_DTYPES):
        res["ops_diff"] = ops_diff(res["ops"])
    res["h10"], res["h10_answer"] = h10_rows(res)
    if args.quality:
        t0 = time.perf_counter()
        res["quality"] = quality(device, args.small)
        print(f"quality in {time.perf_counter() - t0:.1f} s")
    for line in report_lines(res):
        print(line)
    out = args.out or ("ROOFLINE_TORCH.md" if cuda else None)
    if out:
        write(out, res)
        print(f"wrote {out} and {os.path.splitext(out)[0]}.json")
    return res


if __name__ == "__main__":
    main()
