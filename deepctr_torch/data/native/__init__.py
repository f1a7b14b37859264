"""ctypes bindings for the native yx parser (built on demand with g++).

Copy of ``deepctr_tpu/data/native/__init__.py`` (and ``parser.cpp`` beside
it). The port imports nothing of the JAX package, so it keeps this copy;
its behaviour is meant to be identical, and ``tests/test_torch_data.py``
holds it to the original. The one difference is where the library goes:
``build/native/`` at the root of the checkout, keyed by a hash of the
source, so repeated imports don't rebuild.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "parser.cpp")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
BUILD_DIR = os.path.join(_ROOT, "build", "native")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


class NativeBuildError(RuntimeError):
    pass


def _build(force: bool = False) -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"_yx_parser_{digest}.so")
    if os.path.exists(out) and not force:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC",
        "-std=c++17", _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError) as e:
        stderr = getattr(e, "stderr", b"") or b""
        raise NativeBuildError(f"native parser build failed: {stderr.decode()[:500]}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    """Build-if-needed then dlopen; a stale/incompatible cached .so (wrong
    ISA or OS — built with -march=native on another host) raises OSError,
    in which case we rebuild from source on THIS host and retry once."""
    path = _build()
    try:
        return ctypes.CDLL(path)
    except OSError:
        try:
            os.unlink(path)
        except OSError:
            pass
        return ctypes.CDLL(_build(force=True))


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                lib = _load()
                lib.yx_count_rows.restype = ctypes.c_int64
                lib.yx_count_rows.argtypes = [ctypes.c_char_p, ctypes.c_int64]
                lib.yx_parse.restype = ctypes.c_int64
                lib.yx_parse.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64,
                    np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                    ctypes.c_int32,
                    np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                    np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                    ctypes.c_int32, ctypes.c_int32,
                    np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                    np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                    ctypes.c_int64,
                ]
                lib.criteo_parse.restype = ctypes.c_int64
                lib.criteo_parse.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64,
                    np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                    ctypes.c_int32, ctypes.c_int64,
                    np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                    np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                    ctypes.c_int64,
                ]
                _LIB = lib
    return _LIB


def available() -> bool:
    try:
        _lib()
        return True
    except (NativeBuildError, OSError):
        return False


_ROW_BYTES_HINT = [48.0]  # EWMA of observed bytes/row, schema-agnostic start


def parse_yx_bytes(data: bytes, schema) -> tuple[np.ndarray, np.ndarray]:
    """Parse a whole yx byte buffer -> (labels float32[B], ids int32[B, S]).

    Output capacity comes from a bytes/row running estimate (+25% slack)
    rather than a counting pre-pass — the count pass costs ~5% of parse
    time in the streaming hot loop.  If the estimate is ever too small
    (yx_parse returns -1) we fall back to the exact count and re-parse."""
    lib = _lib()
    n = min(
        int(len(data) / _ROW_BYTES_HINT[0] * 1.25) + 64,
        len(data) // 2 + 1,  # a non-blank row is >= 2 bytes ("0\n")
    )
    bounds = np.cumsum([f.vocab_size for f in schema.fields]).astype(np.int64)
    slot_offsets = schema.slot_offsets.astype(np.int32)
    max_lens = np.asarray([f.max_len for f in schema.fields], dtype=np.int32)
    labels = np.empty(n, dtype=np.float32)
    ids = np.empty((n, schema.num_slots), dtype=np.int32)
    wrote = lib.yx_parse(
        data, len(data), bounds, len(schema.fields), slot_offsets, max_lens,
        schema.num_slots, schema.pad_id, labels, ids.reshape(-1), n,
    )
    if wrote == -1:  # estimate too small: exact count, then re-parse
        n = lib.yx_count_rows(data, len(data))
        labels = np.empty(n, dtype=np.float32)
        ids = np.empty((n, schema.num_slots), dtype=np.int32)
        wrote = lib.yx_parse(
            data, len(data), bounds, len(schema.fields), slot_offsets,
            max_lens, schema.num_slots, schema.pad_id, labels,
            ids.reshape(-1), n,
        )
    if wrote < 0:
        raise RuntimeError(f"yx_parse failed with code {wrote}")
    if wrote > 0:
        obs = len(data) / wrote
        _ROW_BYTES_HINT[0] = 0.7 * _ROW_BYTES_HINT[0] + 0.3 * obs
    return labels[:wrote], ids[:wrote]


def parse_yx_lines(lines, schema) -> tuple[np.ndarray, np.ndarray]:
    """Line-list API matching deepctr_torch.data.parser.parse_yx_lines."""
    if lines and isinstance(lines[0], str):
        data = ("\n".join(lines) + "\n").encode()
    else:
        data = b"\n".join(lines) + b"\n"
    return parse_yx_bytes(data, schema)


def parse_yx_file(path: str, schema) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        return parse_yx_bytes(f.read(), schema)


def parse_criteo_bytes(data: bytes, schema) -> tuple[np.ndarray, np.ndarray]:
    """Native Criteo TSV parse -> (labels float32[B], ids int32[B, 39])."""
    from ..criteo import NUM_CAT, NUM_INT, _INT_BUCKETS

    lib = _lib()
    n = lib.yx_count_rows(data, len(data))  # rows = non-blank lines, same rule
    offsets = schema.offsets.astype(np.int64)
    cat_buckets = schema.fields[NUM_INT].vocab_size
    labels = np.empty(n, dtype=np.float32)
    ids = np.empty((n, NUM_INT + NUM_CAT), dtype=np.int32)
    wrote = lib.criteo_parse(
        data, len(data), offsets, _INT_BUCKETS, cat_buckets,
        labels, ids.reshape(-1), n,
    )
    if wrote < 0:
        raise RuntimeError(f"criteo_parse failed with code {wrote}")
    return labels[:wrote], ids[:wrote]


def parse_criteo_file(path: str, schema) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        return parse_criteo_bytes(f.read(), schema)
