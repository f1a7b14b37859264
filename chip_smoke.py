#!/usr/bin/env python3
"""Drive the PyTorch port's FNN serving path once on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and ``nvidia-smi``, and imports nothing of JAX.

Phases, each printing its own lines:
1. device: the card's name and power limit, as nvidia-smi gives them;
2. build: the CUDA kernels of ``deepctr_torch/csrc`` compiled from source;
3. kernel vs plain: ``mlp_tower_fwd`` against ``mlp_tower_plain`` on the
   card at the serving shape [8192, 176] with FNN widths 200-300-100 tanh,
   at [65536, 176], at a ragged batch, and at small relu and sigmoid
   towers; the FNN shapes timed on both with CUDA events;
4. the slice end to end: full-width iPinYou FNN parameters from a seed are
   written with the port's checkpoint writer, 65,536 synthetic requests are
   scored through ``deepctr_torch.cli --score``, and the output is held
   against the same gather and pooling followed by the plain tower on the
   card, and against a float64 numpy forward;
5. profile: ``torch.profiler`` around one scorer call over the requests,
   printing the device's busy share and its time per op.
Then one JSON line on the kernels, and last ``{"ok": true, "device": ...}``.
Any failure raises, and the script exits non-zero without that last line;
so it does without a CUDA device, or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
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
FNN_HIDDEN = (200, 300, 100)
K = 10
BATCH = 8192
REQUESTS = 8 * BATCH


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
    with open(lib_path + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

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

    report = {"kernels": [{
        "name": "mlp_tower_fwd",
        "route": "cuda",
        "source": "deepctr_torch/csrc/mlp_tower_fwd.cu",
        "replaces": "deepctr_tpu/ops/pallas/mlp.py:190",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
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
