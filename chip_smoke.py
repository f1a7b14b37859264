#!/usr/bin/env python3
"""Drive the PyTorch port's FNN serving and training paths once on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and ``nvidia-smi``, and imports nothing of JAX.

Phases, each printing its own lines:
1. device: the card's name and power limit, as nvidia-smi gives them;
2. build: the CUDA kernels of ``deepctr_torch/csrc`` compiled from source,
   one nvcc per source in parallel, with ptxas registers and spills;
3. kernel vs plain: ``mlp_tower_fwd`` against ``mlp_tower_plain`` on the
   card at the serving shape [8192, 176] with FNN widths 200-300-100 tanh,
   at [65536, 176], at a ragged batch, and at small relu and sigmoid
   towers; the FNN shapes timed on both with CUDA events;
4. serving end to end: full-width iPinYou FNN parameters from a seed are
   written with the port's checkpoint writer, 65,536 synthetic requests are
   scored through ``deepctr_torch.cli --score``, and the output is held
   against the same gather and pooling followed by the plain tower on the
   card, and against a float64 numpy forward;
5. profile: ``torch.profiler`` around one scorer call over the requests,
   printing the device's busy share and its time per op;
6. training kernels vs plain: the forward with dropout and the backward
   kernel against the plain tower and autograd through it, at [8192, 176]
   and [1000, 176], dropout 0.5 and 0; a second backward launch compared
   bit for bit; forward, backward and both timed against the plain ones;
7. training end to end: ``deepctr_torch.cli``'s run on
   ``configs/fnn_full_ipinyou.json`` at full iPinYou width, batch 8192, bf16
   table, for one epoch of 40 steps; launch counts of both training
   kernels, the eval AUC, and the written checkpoint scored by ``--score``
   against the eval step; then 5 steps of the kernel path against 5 steps
   of a plain comparator from one state, 3 steps run twice compared bit for
   bit, step times on both paths, the occurrence-gradient scatter's forms
   timed, and ``torch.profiler`` around warm steps.
Then one JSON line on the kernels, and last ``{"ok": true, "device": ...}``.
Any failure raises, and the script exits non-zero without that last line;
so it does without a CUDA device, or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
# kernel and plain version are both f32 with f32 accumulation; they differ
# only in summation order (and tanhf vs torch.tanh in the last ulp)
RTOL, ATOL = 1e-4, 1e-5
# printed probabilities: 6 decimals (5e-7) plus the logit tolerance through
# the sigmoid, whose slope is at most 1/4
PROB_ATOL = 1e-5
# a weight or bias gradient sums 8192 rows in another order than cuBLAS:
# held to this share of the gradient's largest element
GRAD_REL = 1e-4
FNN_HIDDEN = (200, 300, 100)
K = 10
BATCH = 8192
REQUESTS = 8 * BATCH
DROPOUT = 0.5
TRAIN_STEPS = 40            # steps of the CLI's one-epoch training run
TEST_FRACTION = 0.15        # the config's held-out share
CONFIG = "configs/fnn_full_ipinyou.json"


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _tower(rng, dims, device):
    import torch

    layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        lim = np.sqrt(6.0 / (d_in + d_out))
        w = rng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32)
        b = rng.normal(0.0, 0.1, d_out).astype(np.float32)
        layers.append((torch.from_numpy(w).to(device), torch.from_numpy(b).to(device)))
    return layers


def _check_close(what, got, want, rtol=RTOL, atol=ATOL) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    err = np.abs(got - want)
    max_err = float(err.max()) if err.size else 0.0
    bad = int((err > atol + rtol * np.abs(want)).sum())
    print(f"{what}: max |d| {max_err:.3e} (rtol {rtol:g}, atol {atol:g}), "
          f"{bad} of {err.size} outside")
    if bad or not np.all(np.isfinite(got)):
        raise AssertionError(f"{what}: kernel and reference disagree")
    return max_err


def _time_ms(fn, iters=50, warmup=5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _numpy_fnn(table, layers, schema, ids):
    """float64 numpy forward of FNN: gather, mask, pool, tower."""
    rows = table[ids].astype(np.float64)
    rows *= (ids != schema.pad_id)[..., None]
    pooled = np.zeros((ids.shape[0], schema.num_fields, table.shape[1]))
    for s, f in enumerate(schema.slot_field):
        pooled[:, f] += rows[:, s]
    h = pooled.reshape(ids.shape[0], -1)
    for i, layer in enumerate(layers):
        h = h @ layer["w"].astype(np.float64) + layer["b"]
        if i < len(layers) - 1:
            h = np.tanh(h)
    return h[:, 0]


def _profile_scorer(scorer, ids, n_batches) -> None:
    """Device time per op and the device's busy share of the wall time,
    under ``torch.profiler``, for one ``Scorer.logits`` call. The profiler
    adds host time, so the busy share it gives is a lower bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scorer.logits(ids)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scorer.logits(ids)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        device.append((us, e.count, e.key))
    busy_us = sum(us for us, _, _ in device)
    print(f"profile: device busy {busy_us:.1f} us of {wall_us:.1f} us wall "
          f"({100 * busy_us / wall_us:.1f}%) for {n_batches} batches")
    for us, count, key in sorted(device, reverse=True)[:10]:
        print(f"  {us / n_batches:9.2f} us/batch  {count // n_batches:3d}/batch  "
              f"{key[:90]}")


def _check_grad(what, got, want) -> float:
    """A batch-summed gradient: held to GRAD_REL of its largest element."""
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    return _check_close(f"{what} (atol {GRAD_REL:g} x max |want| = "
                        f"{GRAD_REL * scale:.2e})", got, want, rtol=0.0,
                        atol=GRAD_REL * scale)


def _in_turns(fns: dict, iters=50) -> dict:
    """Mean CUDA-event ms of each callable, timed in turns a, b, b, a."""
    names = list(fns)
    order = names + names[::-1]
    times = {name: [] for name in names}
    for name in order:
        times[name].append(_time_ms(fns[name], iters=iters))
    return {name: float(np.mean(t)) for name, t in times.items()}


def _phase6_training_kernels(dev, rng) -> dict:
    """The forward with dropout and the backward kernel against the plain
    tower and autograd through it; returns errors and times for the report."""
    import torch

    from deepctr_torch.ops.kernels import mlp as mlp_k

    dims = (16 * (1 + K),) + FNN_HIDDEN + (1,)
    seed = 12345
    out = {"fwd_drop_err": 0.0, "bwd_err": 0.0}
    for batch in (BATCH, 1000):
        x = torch.from_numpy(rng.normal(size=(batch, dims[0])).astype(np.float32)).to(dev)
        g = torch.from_numpy(rng.normal(size=batch).astype(np.float32)).to(dev)
        layers = _tower(rng, dims, dev)
        for drop in (DROPOUT, 0.0):
            tag = f"[{batch}, {dims[0]}] dropout {drop}"
            got = mlp_k.mlp_tower_fwd(x, layers, "tanh", drop, seed)
            want = mlp_k.mlp_tower_plain(x, layers, "tanh", drop, seed)
            err = _check_close(f"fwd kernel vs plain {tag}", got.cpu(), want.cpu())
            if drop > 0:
                out["fwd_drop_err"] = max(out["fwd_drop_err"], err)
            gx, grads = mlp_k.mlp_tower_bwd(x, layers, g, "tanh", drop, seed)
            torch.cuda.synchronize()
            wgx, wgrads = mlp_k.mlp_tower_bwd_plain(x, layers, g, "tanh", drop, seed)
            errs = [_check_close(f"bwd kernel vs autograd {tag}: gx", gx.cpu(),
                                 wgx.cpu())]
            for i, ((gw, gb), (ww, wb)) in enumerate(zip(grads, wgrads)):
                errs.append(_check_grad(f"bwd kernel vs autograd {tag}: gW{i}",
                                        gw.cpu(), ww.cpu()))
                errs.append(_check_grad(f"bwd kernel vs autograd {tag}: gb{i}",
                                        gb.cpu(), wb.cpu()))
            out["bwd_err"] = max(out["bwd_err"], *errs)
            gx2, grads2 = mlp_k.mlp_tower_bwd(x, layers, g, "tanh", drop, seed)
            same = torch.equal(gx, gx2) and all(
                torch.equal(a, c) and torch.equal(b, d)
                for (a, b), (c, d) in zip(grads, grads2))
            print(f"bwd kernel {tag}: second launch bitwise equal: {same}")
            if not same:
                raise AssertionError("two backward launches gave different bits")

    x = torch.from_numpy(rng.normal(size=(BATCH, dims[0])).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=BATCH).astype(np.float32)).to(dev)
    layers = _tower(rng, dims, dev)
    xg = x.clone().requires_grad_(True)
    lg = [(w.clone().requires_grad_(True), b.clone().requires_grad_(True))
          for w, b in layers]
    flat = [xg] + [t for pair in lg for t in pair]

    def kernel_step():
        torch.autograd.grad(mlp_k.mlp_tower(xg, lg, "tanh", DROPOUT, seed), flat, g)

    def plain_step():
        torch.autograd.grad(mlp_k.mlp_tower_plain(xg, lg, "tanh", DROPOUT, seed),
                            flat, g)

    fwd = _in_turns({
        "plain": lambda: mlp_k.mlp_tower_plain(x, layers, "tanh", DROPOUT, seed),
        "kernel": lambda: mlp_k.mlp_tower_fwd(x, layers, "tanh", DROPOUT, seed)})
    bwd = _in_turns({
        "plain": lambda: mlp_k.mlp_tower_bwd_plain(x, layers, g, "tanh", DROPOUT, seed),
        "kernel": lambda: mlp_k.mlp_tower_bwd(x, layers, g, "tanh", DROPOUT, seed)})
    both = _in_turns({"plain": plain_step, "kernel": kernel_step})
    for name, t in (("forward with dropout", fwd),
                    ("backward (recompute + gradients; plain: forward + "
                     "autograd)", bwd),
                    ("forward + backward (autograd.grad)", both)):
        print(f"time [{BATCH}, {dims[0]}] dropout {DROPOUT}, {name}: kernel "
              f"{t['kernel']:.4f} ms, plain {t['plain']:.4f} ms")
    # without dropout the plain version has no hash mask to compute
    bwd0 = _in_turns({
        "plain": lambda: mlp_k.mlp_tower_bwd_plain(x, layers, g, "tanh"),
        "kernel": lambda: mlp_k.mlp_tower_bwd(x, layers, g, "tanh")})
    print(f"time [{BATCH}, {dims[0]}] dropout 0, backward: kernel "
          f"{bwd0['kernel']:.4f} ms, plain {bwd0['plain']:.4f} ms")
    out.update(fwd_drop_ms=fwd["kernel"], fwd_drop_plain_ms=fwd["plain"],
               bwd_ms=bwd["kernel"], bwd_plain_ms=bwd["plain"])
    return out


def _plain_train_step(schema, sparse_opt, dense_opt):
    """The port's train step with the plain tower called directly, built
    from the port's pieces: the comparator of the kernel path."""
    import torch

    from deepctr_torch.models import weighted_bce_with_logits
    from deepctr_torch.ops.kernels.mlp import mlp_tower_plain
    from deepctr_torch.train import dense_params

    def step(state, ids, labels, weights, seed):
        model = state.model
        mask = (ids != schema.pad_id).float()
        rows = model.table.detach()[ids].float().requires_grad_(True)
        params = dense_params(model)
        spec = model.mlp.spec
        logits = mlp_tower_plain(model.tower_input(rows, mask), model.mlp.params(),
                                 spec.activation, spec.dropout, seed)
        loss = weighted_bce_with_logits(logits, labels, weights)
        g_rows, *g_dense = torch.autograd.grad(loss, [rows] + params)
        sparse_opt.update(model.table.data, state.sparse_state, ids.reshape(-1),
                          g_rows.reshape(-1, g_rows.shape[-1]))
        dense_opt.update(params, g_dense, state.dense_state)
        state.step += 1
        return state, loss.detach()

    return step


def _bf16_ulps(a, b):
    import torch

    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


def _compare_states(what, a, b) -> None:
    """Table (bf16), Adagrad accumulator and tower of two states."""
    ulps = _bf16_ulps(a.table, b.table)
    far = int((ulps > 1).sum())
    print(f"{what}: table {int((ulps > 0).sum())} of {ulps.numel()} elements "
          f"differ, max {int(ulps.max())} bf16 ulps, {far} beyond 1 ulp "
          f"(allowed: {ulps.numel() // 10000})")
    if far > ulps.numel() // 10000:
        raise AssertionError(f"{what}: tables disagree")
    acc_a, acc_b = a.sparse_state.acc, b.sparse_state.acc
    _check_close(f"{what}: Adagrad accumulator (atol 1e-6 x max)", acc_a.cpu(),
                 acc_b.cpu(), rtol=1e-3, atol=1e-6 * float(acc_b.max()))
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        if name != "table":
            _check_close(f"{what}: {name}", p.detach().cpu(), q.detach().cpu(),
                         rtol=1e-4, atol=1e-5)


def _profile_steps(step, state, batches, seeds) -> None:
    """Device time per op and the device's busy share of the wall time,
    under ``torch.profiler``, for warm train steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = len(batches)
    for b, s in zip(batches, seeds):  # warm
        state, _ = step(state, *b, seed=s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b, s in zip(batches, seeds):
            state, _ = step(state, *b, seed=s)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        device.append((us, e.count, e.key))
    busy_us = sum(us for us, _, _ in device)
    print(f"profile, train step: device busy {busy_us:.1f} us of {wall_us:.1f} us "
          f"wall ({100 * busy_us / wall_us:.1f}%) for {n} steps")
    for us, count, key in sorted(device, reverse=True)[:14]:
        print(f"  {us / n:9.2f} us/step  {count / n:5.1f}/step  {key[:90]}")


def _time_scatter_forms(dev, schema, ids) -> None:
    """The dense-mode occurrence-gradient scatter at the step's shape: the
    port's sorted prefix-sum form against ``index_put_(accumulate=True)``
    (deterministic too) and ``index_add_`` (float atomics), each with
    bitwise repeatability."""
    import torch

    from deepctr_torch.ops.scatter import scatter_totals

    shape = (schema.padded_vocab_size, 1 + K)
    occ = ids.reshape(-1)
    rows = torch.randn(occ.shape[0], 1 + K, device=dev)
    forms = {
        "sort + prefix-sum totals (the port's)":
            lambda: scatter_totals(shape[0], occ, rows),
        "index_put_(accumulate=True)":
            lambda: torch.zeros(shape, device=dev).index_put_((occ,), rows,
                                                              accumulate=True),
        "index_add_ (atomics)":
            lambda: torch.zeros(shape, device=dev).index_add_(0, occ, rows),
    }
    times = _in_turns(forms, iters=20)
    want = forms["index_put_(accumulate=True)"]().double()
    for name, fn in forms.items():
        got = fn()
        same = torch.equal(got, fn())
        err = float((got.double() - want).abs().max())
        print(f"scatter of {occ.shape[0]} occurrence rows into {shape}: {name} "
              f"{times[name]:.4f} ms, two calls bitwise equal: {same}, max |d| "
              f"vs index_put_ {err:.2e}")


def _phase7_training(dev, root, tmp) -> dict:
    """The training slice end to end through ``deepctr_torch.cli``, then the
    kernel path against the plain comparator on the card."""
    import torch

    from deepctr_torch import cli
    from deepctr_torch.ops.kernels import mlp as mlp_k
    from deepctr_torch.shared import RunConfig, ipinyou_full_schema, synthetic
    from deepctr_torch.train import make_eval_step, make_train_step

    schema = ipinyou_full_schema()
    schema_path = os.path.join(tmp, "ipinyou_full.json")
    with open(schema_path, "w") as f:
        f.write(schema.to_json())
    examples = int(np.ceil(TRAIN_STEPS * BATCH / (1 - TEST_FRACTION))) + 1
    ckpt = os.path.join(tmp, "fnn_train.ckpt")
    metrics = os.path.join(tmp, "metrics.jsonl")
    overrides = ["model.init_from=none", f"data.schema_path={schema_path}",
                 f"train.batch_size={BATCH}", "train.table_dtype=bf16",
                 f"data.synthetic_examples={examples}", "train.epochs=1",
                 f"train.checkpoint_path={ckpt}", f"train.metrics_path={metrics}"]
    config = os.path.join(root, CONFIG)
    cfg = RunConfig.load(config).apply_overrides(overrides)
    print(f"train: python -m deepctr_torch.cli --config {CONFIG} "
          f"{' '.join(overrides)} --device cuda")

    mlp_k.LAUNCHES = mlp_k.DROPOUT_LAUNCHES = mlp_k.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        result = cli.run(cfg, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwd_dropout": mlp_k.DROPOUT_LAUNCHES, "bwd": mlp_k.BWD_LAUNCHES,
                "fwd_eval": mlp_k.LAUNCHES - mlp_k.DROPOUT_LAUNCHES}
    rec = result["history"][0]
    state = result["state"]
    print(f"cli train: {state.step} steps in {wall:.2f} s (data, init, epoch, eval, "
          f"checkpoint); launches {launches}; train_loss {rec['train_loss']:.5f}, "
          f"eval auc {rec['auc']:.5f}, logloss {rec['logloss']:.5f}, rmse "
          f"{rec['rmse']:.5f}; examples_per_s {rec['examples_per_s']:.0f} "
          f"(host clock, the epoch's steps)")
    if state.step != TRAIN_STEPS:
        raise AssertionError(f"{state.step} steps, expected {TRAIN_STEPS}")
    if launches["fwd_dropout"] < state.step or launches["bwd"] < state.step:
        raise AssertionError(f"training kernels launched {launches} in "
                             f"{state.step} steps")
    if launches["fwd_eval"] < 1:
        raise AssertionError("eval launched no dropout-free forward kernel")
    if not (np.isfinite(rec["train_loss"]) and rec["auc"] > 0.5):
        raise AssertionError(f"training did not learn: {rec}")
    with open(metrics) as f:
        if not any('"auc"' in line for line in f):
            raise AssertionError("no eval record in the metrics file")

    # the checkpoint through --score against the eval step on the trained state
    _, tr_ids, tr_labels, te_ids, te_labels = cli.load_data(cfg)
    yx = os.path.join(tmp, "test_rows.yx")
    synthetic.write_yx_file(synthetic.SyntheticDataset(
        schema, te_ids, te_labels, np.zeros(len(te_labels), np.float32)), yx)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--config", config, "--score", yx, *overrides,
                       "--device", "cuda"])
    if rc != 0:
        raise AssertionError(f"deepctr_torch.cli --score returned {rc}")
    probs = np.array(out.getvalue().split(), dtype=np.float64)
    eval_step = make_eval_step(schema)
    logits = np.concatenate([
        eval_step(state.model, te_ids[i:i + BATCH]).cpu().numpy()
        for i in range(0, len(te_ids), BATCH)])
    _check_close(f"train: --score of the checkpoint vs eval step ({len(probs)} "
                 f"test rows)", probs, 1.0 / (1.0 + np.exp(-np.clip(logits, -30, 30))),
                 rtol=0.0, atol=PROB_ATOL)

    # the kernel path against the plain comparator, from one state
    sparse_opt, dense_opt = cli.build_optimizers(cfg)
    kstep = make_train_step(schema, sparse_opt, dense_opt)
    pstep = _plain_train_step(schema, sparse_opt, dense_opt)
    batches = []
    for i in range(10):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        batches.append((torch.from_numpy(tr_ids[sl]).to(dev).long(),
                        torch.from_numpy(tr_labels[sl]).to(dev),
                        torch.ones(BATCH, device=dev)))
    seeds = [int(s) for s in np.random.default_rng(SEED + 7).integers(0, 1 << 24, 10)]
    k_state, p_state = state.clone(), state.clone()
    for i in range(5):
        k_state, km = kstep(k_state, *batches[i], seed=seeds[i])
        p_state, pl = pstep(p_state, *batches[i], seed=seeds[i])
        _check_close(f"5 steps, kernel vs plain: loss of step {i}", [float(km.loss)],
                     [float(pl)], rtol=1e-4, atol=1e-6)
    _compare_states("5 steps, kernel vs plain", k_state, p_state)

    a, b = state.clone(), state.clone()
    for i in range(3):
        a, _ = kstep(a, *batches[i])
        b, _ = kstep(b, *batches[i])
    same = (torch.equal(a.table, b.table)
            and torch.equal(a.sparse_state.acc, b.sparse_state.acc)
            and all(torch.equal(p, q) for p, q in zip(a.model.parameters(),
                                                      b.model.parameters())))
    print(f"3 steps twice from one state: table, accumulator and tower "
          f"bit-identical: {same}")
    if not same:
        raise AssertionError("the train step is not bitwise repeatable")

    # step time on the card: batches already on the card, CUDA events
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        st = state.clone()
        fn = kstep if which == "kernel" else pstep
        for i in range(2):
            st, _ = fn(st, *batches[i], seed=seeds[i])
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(10):
            st, _ = fn(st, *batches[i], seed=seeds[i])
        end.record()
        end.synchronize()
        times[which].append(start.elapsed_time(end) / 10)
        del st
    step_ms = {k: float(np.mean(v)) for k, v in times.items()}
    print(f"train step on the card ({BATCH} rows, CUDA events over 10 steps, in "
          f"turns): kernel {step_ms['kernel']:.4f} ms, plain {step_ms['plain']:.4f} "
          f"ms; runs {times}")
    _time_scatter_forms(dev, schema, batches[0][0])
    _profile_steps(kstep, state.clone(), batches[:5], seeds[:5])
    return {"launches": launches, "step_ms": step_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA device: torch.cuda.is_available() is false")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "deepctr_torch", "csrc")):
        _fail("deepctr_torch/csrc not found beside chip_smoke.py: run it "
              "from the root of a checkout of the repository")
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # 2. build
    from deepctr_torch.ops.kernels import _build
    from deepctr_torch.ops.kernels import mlp as mlp_k

    t0 = time.perf_counter()
    lib_path = _build.compile_library()
    _build.load_library()
    print(f"build: {os.path.relpath(lib_path, root)} from "
          f"{os.path.relpath(_build.CSRC_DIR, root)} in "
          f"{time.perf_counter() - t0:.1f} s")
    name = "?"
    with open(lib_path + ".log") as f:
        for line in f:
            entry = re.search(r"entry function '.*?\d+(tower_\w+?_kernel)(ILb([01])E)?",
                              line)
            if entry:
                name = entry.group(1) + {None: "", "1": "<true>", "0": "<false>"}[
                    entry.group(3)]
            elif "registers" in line or "spill" in line:
                print(f"  ptxas, {name}: {line.strip()}")

    # 3. kernel vs plain on the card; timed at three batch sizes
    rng = np.random.default_rng(SEED)
    in_dim = 16 * (1 + K)   # ipinyou_full_schema: 16 fields of 1+k
    fnn_dims = (in_dim,) + FNN_HIDDEN + (1,)
    cases = [
        ("fnn tanh", BATCH, fnn_dims, "tanh", True),
        ("fnn tanh, 8 batches", REQUESTS, fnn_dims, "tanh", True),
        ("fnn tanh ragged", 1000, fnn_dims, "tanh", True),
        ("small relu", 300, (24, 32, 16, 1), "relu", False),
        ("small sigmoid", 77, (24, 32, 16, 1), "sigmoid", False),
    ]
    tower_times = {}
    main_err = None
    for name, batch, dims, act, timed in cases:
        x = torch.from_numpy(
            rng.normal(size=(batch, dims[0])).astype(np.float32)).to(dev)
        layers = _tower(rng, dims, dev)
        got = mlp_k.mlp_tower_fwd(x, layers, act)
        torch.cuda.synchronize()
        want = mlp_k.mlp_tower_plain(x, layers, act)
        err = _check_close(f"kernel vs plain [{batch}, {dims[0]}] "
                           f"{'-'.join(map(str, dims[1:]))} {act} ({name})",
                           got.cpu(), want.cpu())
        if main_err is None:
            main_err = err
        if not timed:
            continue
        times = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = mlp_k.mlp_tower_plain if which == "plain" else mlp_k.mlp_tower_fwd
            times[which].append(_time_ms(lambda: fn(x, layers, act)))
        kernel_ms = float(np.mean(times["kernel"]))
        plain_ms = float(np.mean(times["plain"]))
        tower_times[batch] = (kernel_ms, plain_ms)
        flop = 2 * batch * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        print(f"time [{batch}, {dims[0]}]: kernel {kernel_ms:.4f} ms "
              f"({flop / kernel_ms / 1e9:.2f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms ({flop / plain_ms / 1e9:.2f} TFLOP/s); "
              f"runs {times}")
    kernel_ms, plain_ms = tower_times[BATCH]

    # 4. the slice end to end, through the CLI
    from deepctr_torch import cli
    from deepctr_torch.models import MlpSpec, apply_model, make_fnn
    from deepctr_torch.serving import Scorer
    from deepctr_torch.shared import ipinyou_full_schema, synthetic
    from deepctr_torch.utils.checkpoint import save_scoring_params

    schema = ipinyou_full_schema()
    prng = np.random.default_rng(SEED + 1)
    table = prng.normal(0.0, 0.3, (schema.padded_vocab_size, 1 + K)).astype(np.float32)
    table[schema.pad_id] = 0.0
    dims = (schema.num_fields * (1 + K),) + FNN_HIDDEN + (1,)
    assert dims[0] == in_dim
    dense_layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        lim = np.sqrt(6.0 / (d_in + d_out))
        dense_layers.append({
            "w": prng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32),
            "b": prng.normal(0.0, 0.1, d_out).astype(np.float32),
        })
    spec = MlpSpec(hidden=FNN_HIDDEN, activation="tanh")

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "fnn.ckpt")
        save_scoring_params(ckpt, table, {"mlp": {"layers": dense_layers}},
                            schema=schema, meta={"model": "fnn"})
        t0 = time.perf_counter()
        ds = synthetic.generate(schema, num_examples=REQUESTS, k=K, seed=SEED)
        yx = os.path.join(tmp, "requests.yx")
        synthetic.write_yx_file(ds, yx)
        print(f"requests: {REQUESTS} rows, {os.path.getsize(yx)} bytes of yx, "
              f"made in {time.perf_counter() - t0:.1f} s")

        argv = ["--score", yx, f"train.checkpoint_path={ckpt}", "model.name=fnn",
                f"model.k={K}", "model.hidden=" + ",".join(map(str, FNN_HIDDEN)),
                "model.activation=tanh", f"train.batch_size={BATCH}",
                "--device", "cuda"]
        out = io.StringIO()
        mlp_k.LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = mlp_k.LAUNCHES
        if rc != 0:
            raise AssertionError(f"deepctr_torch.cli --score returned {rc}")
        if launches == 0:
            raise AssertionError("the scoring run launched the tower kernel 0 times")
        probs = np.array(out.getvalue().split(), dtype=np.float64)
        if probs.shape != (REQUESTS,):
            raise AssertionError(f"scored {probs.shape} rows, expected {REQUESTS}")
        if not (np.all(np.isfinite(probs)) and probs.min() >= 0 and probs.max() <= 1):
            raise AssertionError("probabilities not finite or outside [0, 1]")
        print(f"cli --score: {probs.size} rows in {cli_s:.2f} s (checkpoint "
              f"load, parse and scoring), {launches} kernel launches, "
              f"probabilities in [{probs.min():.4f}, {probs.max():.4f}]")

        scorer = Scorer.from_checkpoint(
            ckpt, make_fnn(schema, k=K, mlp=spec, device=dev), batch_size=BATCH)
    model = scorer.model

    def plain_forward(ids_dev):
        """The model's gather and pooling, then the plain tower on the card."""
        rows = model.table[ids_dev]
        mask = (ids_dev != schema.pad_id).to(rows.dtype)
        return mlp_k.mlp_tower_plain(model.tower_input(rows, mask),
                                     model.mlp.params(), spec.activation)

    kernel_logits = scorer.logits(ds.ids)
    with torch.inference_mode():
        plain_logits = np.concatenate([
            plain_forward(torch.from_numpy(ds.ids[i:i + BATCH]).to(dev).long())
            .cpu().numpy() for i in range(0, REQUESTS, BATCH)])
    _check_close("slice: kernel scorer vs plain forward logits", kernel_logits,
                 plain_logits)
    _check_close("slice: cli probabilities vs plain forward", probs,
                 1.0 / (1.0 + np.exp(-np.clip(plain_logits, -30, 30))),
                 rtol=0.0, atol=PROB_ATOL)
    n_ref = 512
    _check_close(f"slice: kernel scorer vs float64 numpy forward ({n_ref} rows)",
                 kernel_logits[:n_ref],
                 _numpy_fnn(table, dense_layers, schema, ds.ids[:n_ref]))

    n_batches = REQUESTS // BATCH
    for _ in range(3):
        t0 = time.perf_counter()
        scorer.logits(ds.ids)
        dt = time.perf_counter() - t0
        print(f"scorer: {dt * 1e3 / n_batches:.3f} ms per {BATCH}-row batch "
              f"(host clock: batching, H2D, forward, D2H)")
    ids_dev = torch.from_numpy(ds.ids[:BATCH]).to(dev).long()
    with torch.inference_mode():
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = ((lambda: plain_forward(ids_dev)) if which == "plain" else
                  (lambda: apply_model(model, ids_dev, schema.pad_id)))
            print(f"forward on the card, {which} tower: {_time_ms(fn):.4f} ms "
                  f"per {BATCH}-row batch (gather, pool, tower; CUDA events)")

    # 5. where the scorer's time goes: torch.profiler around one warm call
    _profile_scorer(scorer, ds.ids, n_batches)

    # 6. the training kernels against their plain versions
    train_k = _phase6_training_kernels(dev, rng)

    # 7. the training slice end to end, through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        train = _phase7_training(dev, root, tmp)

    report = {"kernels": [{
        "name": "mlp_tower_fwd",
        "route": "cuda",
        "source": "deepctr_torch/csrc/mlp_tower_fwd.cu",
        "replaces": "deepctr_tpu/ops/pallas/mlp.py:190",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }, {
        "name": "mlp_tower_fwd (dropout branch)",
        "route": "cuda",
        "source": "deepctr_torch/csrc/mlp_tower_fwd.cu",
        "replaces": "deepctr_tpu/ops/pallas/mlp.py:110",
        "launches": train["launches"]["fwd_dropout"],
        "max_abs_err": train_k["fwd_drop_err"],
        "ms": train_k["fwd_drop_ms"],
        "plain_ms": train_k["fwd_drop_plain_ms"],
    }, {
        "name": "mlp_tower_bwd",
        "route": "cuda",
        "source": "deepctr_torch/csrc/mlp_tower_bwd.cu",
        "replaces": "deepctr_tpu/ops/pallas/mlp.py:373",
        "launches": train["launches"]["bwd"],
        "max_abs_err": train_k["bwd_err"],
        "ms": train_k["bwd_ms"],
        "plain_ms": train_k["bwd_plain_ms"],
    }]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
