#!/usr/bin/env python3
"""Ablation builds of the FM scorer kernel, timed against each other on one
GPU.

Run from the root of a checkout, on a machine with a card and ``nvcc``::

    PYTHONPATH=. python3 deepctr_torch/csrc/tune_fm_score.py \\
        --variant base: --variant s2:FM_STAGES=2 \\
        --variant wide:FM_STAGE_KB=32,FM_BLOCKS_PER_SM=1 \\
        [--source name=path/to/another/fm_score.cu] [--out results.json]

Each ``--variant name:MACRO=value,...`` compiles ``fm_score.cu`` with those
``FM_*`` macros (its tuning constants) into a library of its own under
``build/tune/``; ``--source name=path`` compiles another source with the same
C entry point (an earlier design, to compare with). Every build is held
against ``fm_score_plain`` at the shipped shapes and ragged ones, two launches
are compared bit for bit, and then all builds are timed in turns (forwards,
then backwards) at each timed shape with CUDA events behind a sleep kernel,
as ``chip_smoke.py`` times kernels. ``[8192, 18, 11] cold`` rotates over
eight inputs (57 MB, more than the card's 50 MB L2) so that every call reads
device memory; the plain ``[8192, 18, 11]`` reuses one 7.1 MB input, which
stays in L2. Builds with ``fm_score_empty`` also give the time of an empty
kernel of the same launch. Prints one line a build and shape, and writes them
as JSON where ``--out`` says.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHECK_SHAPES = [(8192, 18, 11), (65536, 18, 11), (1000, 18, 11), (77, 5, 4),
                (8192, 39, 17), (16, 18, 11), (8197, 18, 11), (300, 100, 65),
                (64, 3, 1)]
TIMED_SHAPES = [(8192, 18, 11), (65536, 18, 11), (8192, 39, 17)]
TOL = 1e-4
HBM_BYTES = 3.35e12


def build(name: str, source: str, macros: list[str], out_dir: str) -> ctypes.CDLL:
    from deepctr_torch.ops.kernels import _build

    out = os.path.join(out_dir, f"libfm_{name}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
           f"-I{_build.CSRC_DIR}", *(f"-D{m}" for m in macros), source, "-o", out]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed:\n{res.stdout}{res.stderr}")
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas {name}: {line.strip()}")
    lib = ctypes.CDLL(out)
    lib.fm_score_fwd.restype = ctypes.c_int
    lib.fm_score_fwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p]
    if hasattr(lib, "fm_score_empty"):
        lib.fm_score_empty.restype = ctypes.c_int
        lib.fm_score_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
    return lib


def time_ms(fn, iters=50, warmup=5) -> float:
    """Device ms of one call: events around ``iters`` calls enqueued behind a
    sleep kernel."""
    import torch

    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * iters * host_s, 0.2) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    from deepctr_torch.ops.kernels.interaction import fm_score_plain

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME:MACRO=V,...")
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_fm_score: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    out_dir = os.path.join(ROOT, "build", "tune")
    os.makedirs(out_dir, exist_ok=True)
    shipped = os.path.join(ROOT, "deepctr_torch", "csrc", "fm_score.cu")
    libs = {}
    for spec in args.source:
        name, path = spec.split("=", 1)
        libs[name] = build(name, path, [], out_dir)
    for spec in args.variant or ["base:"]:
        name, _, macros = spec.partition(":")
        libs[name] = build(name, shipped, [m for m in macros.split(",") if m], out_dir)

    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(0)

    def inputs(batch, slots, d):
        rows = rng.normal(0.0, 0.5, (batch, slots, d)).astype(np.float32)
        mask = (rng.random((batch, slots)) < 0.9).astype(np.float32)
        mask[0] = 0.0
        return torch.from_numpy(rows).to(dev), torch.from_numpy(mask).to(dev)

    def launch(lib, rows, mask, out):
        code = lib.fm_score_fwd(rows.data_ptr(), mask.data_ptr(), rows.shape[0],
                                rows.shape[1], rows.shape[2], out.data_ptr(), stream)
        if code != 0:
            raise RuntimeError(f"fm_score_fwd returned CUDA error {code}")

    for shape in CHECK_SHAPES:
        rows, mask = inputs(*shape)
        want = fm_score_plain(rows, mask)
        for name, lib in libs.items():
            got = torch.full((shape[0],), float("nan"), device=dev)
            again = torch.full((shape[0],), float("nan"), device=dev)
            launch(lib, rows, mask, got)
            launch(lib, rows, mask, again)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = bool(torch.all((got - want).abs() <= TOL + TOL * want.abs()))
            same = torch.equal(got, again)
            print(f"check {name} {list(shape)}: max |d| {err:.3e}, within {TOL:g}: "
                  f"{ok}, second launch bitwise equal: {same}")
            if not (ok and same):
                return 1
    first = next(iter(libs.values()))
    rows, mask = inputs(8192, 18, 11)
    ref = torch.empty(8192, device=dev)
    launch(first, rows, mask, ref)
    for name, lib in libs.items():
        got = torch.empty(8192, device=dev)
        launch(lib, rows, mask, got)
        print(f"bits {name} vs {next(iter(libs))} at [8192, 18, 11]: "
              f"{'equal' if torch.equal(got, ref) else 'differ'}")

    results = []
    for shape in TIMED_SHAPES:
        batch, slots, d = shape
        for cold in ((False, True) if shape == TIMED_SHAPES[0] else (False,)):
            sets = [inputs(*shape) for _ in range(8 if cold else 1)]
            out = torch.empty(batch, device=dev)
            nbytes = 4 * (batch * slots * (d + 1) + batch)
            tag = f"{list(shape)}{' cold' if cold else ''}"
            calls = {}
            for name, lib in libs.items():
                turn = [0]

                def call(lib=lib, turn=turn):
                    r, m = sets[turn[0] % len(sets)]
                    turn[0] += 1
                    launch(lib, r, m, out)

                calls[name] = call
                if hasattr(lib, "fm_score_empty"):
                    calls[name + "/empty"] = (
                        lambda lib=lib: lib.fm_score_empty(batch, slots, d, stream))
            calls["plain"] = lambda: fm_score_plain(*sets[0])
            names = list(calls)
            times = {n: [] for n in names}
            for n in names + names[::-1]:
                times[n].append(time_ms(calls[n], iters=56))
            for n in names:
                ms = float(np.mean(times[n]))
                line = f"time {tag} {n}: {ms:.4f} ms (runs {times[n]})"
                if "/" not in n:
                    line += (f", {nbytes / ms / 1e6:.0f} GB/s, bytes' bound "
                             f"{nbytes / HBM_BYTES * 1e3:.4f} ms")
                print(line)
                results.append({"shape": tag, "build": n, "ms": ms, "runs": times[n]})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
