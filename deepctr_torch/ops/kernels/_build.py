"""Build and load the port's CUDA kernels.

The counterpart of ``deepctr_tpu/ops/pallas/runtime.py``. The TPU package
chose interpret mode off the TPU; the port has one device rule instead: a
kernel wrapper given CPU tensors runs its kernel's plain PyTorch version,
and given CUDA tensors it launches the kernel or raises. Nothing falls back.

The kernels are CUDA C++ for ``sm_90a`` (``deepctr_torch/csrc/*.cu``) with
plain ``extern "C"`` entry points. At first use they are compiled by
``nvcc``, one process per source in parallel, and linked into one shared
library under ``build/kernels/`` at the root of the
checkout, named by a hash of the sources and flags, and loaded with
``ctypes`` (the same pattern as ``deepctr_tpu/data/native`` for g++). A
failed build raises :class:`KernelBuildError`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.access(path, os.X_OK):
        raise KernelBuildError(
            "nvcc not found (PATH, or $CUDA_HOME/bin): the CUDA kernels of "
            "deepctr_torch are compiled on the machine with the GPU"
        )
    return path


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise KernelBuildError(f"no CUDA sources in {CSRC_DIR}")
    return srcs


def compile_library(out_dir: str = BUILD_DIR) -> str:
    """Compile every ``csrc/*.cu`` into one shared library; return its path.

    The sources compile in parallel, one ``nvcc`` each, and are then linked.
    An existing library with the same hash is reused. ``nvcc``'s output,
    including ``-Xptxas=-v``'s registers and spills per kernel, is kept
    beside it as ``<library>.log``.
    """
    srcs = _sources()
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in srcs + headers:
        with open(path, "rb") as f:
            h.update(f.read())
    out = os.path.join(out_dir, f"libdeepctr_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    nvcc = _nvcc()
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}"
    objs = [f"{tmp}.{i}.o" for i in range(len(srcs))]
    log = []
    procs: list[subprocess.Popen] = []
    try:
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for src, obj in zip(srcs, objs)
        ]
        failed = []
        for src, proc in zip(srcs, procs):
            text = proc.communicate(timeout=600)[0]
            log.append(f"== {os.path.basename(src)}\n{text}")
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)} ({proc.returncode}):\n"
                              f"{text[-4000:]}")
        if failed:
            raise KernelBuildError("nvcc failed: " + "\n".join(failed))
        res = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp + ".so", *objs],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise KernelBuildError(
                f"nvcc link failed ({res.returncode}):\n{res.stderr[-4000:]}")
        log.append(f"== link\n{res.stdout}{res.stderr}")
    except (OSError, subprocess.TimeoutExpired) as e:
        raise KernelBuildError(f"nvcc did not run: {e}") from e
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    with open(out + ".log", "w") as f:
        f.write("\n".join(log))
    os.replace(tmp + ".so", out)
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, compiled at the first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = ctypes.CDLL(compile_library())
            _LIB.deepctr_cuda_error_string.restype = ctypes.c_char_p
            _LIB.deepctr_cuda_error_string.argtypes = [ctypes.c_int]
        return _LIB


def is_cuda(x, what: str) -> bool:
    """The device rule: True for a CUDA tensor (launch the kernel), False for
    a CPU one (take the plain version); raise for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    return True


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if code != 0:
        msg = load_library().deepctr_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
