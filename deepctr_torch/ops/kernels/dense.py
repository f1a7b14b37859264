"""The dense layers' backward products: the CUDA kernel and its plain
PyTorch versions.

``ops/layers.py``'s ``_Linear`` (DLRM-DCNv2's float32 layers) computes a
layer's input gradient ``g @ w.T`` with :func:`input_grad` and its weight
gradient ``x.T @ g`` with :func:`weight_grad`. The kernel is
``deepctr_torch/csrc/dense_bwd.cu``; it replaces no TPU kernel (DLRM has no
counterpart in the JAX package), and its source says what bounds it and how
its design answers that. It computes in float32 by the 3xTF32 split on the
tensor cores: each operand ``x = hi + lo`` with ``hi`` and ``lo`` rounded to
TF32 (:func:`split_tf32`), each product ``lo.hi + hi.lo + hi.hi``, summed in
f32.

The route is chosen by shape, before the call. A CUDA product whose shape
the kernel takes (:func:`takes`: M and N multiples of 128, K of 32) runs
the kernel and counts in ``BWD_LAUNCHES``; any other CUDA product runs the
plain version, cuBLAS, and counts in ``BWD_LIBRARY``. CPU tensors take the
plain version and count in neither. The plain versions compute in the
precision the backend flags give: ``_Linear`` calls these functions with
TF32 off (``layers.f32_products``), and whoever compares with them on the
card sets that flag.

A weight gradient has a deep K (the batch) and a small output, too few
128 x 128 tiles to fill the card: :func:`slices` cuts its depth into a fixed
number of slices by the shape and the card's SM count, the kernel writes
each slice's partial tile into a workspace, and a second kernel adds the
slices in slice order. No float atomics: two calls on one card give the
same bits.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._build import check, is_cuda, load_library

# products the kernel ran, and CUDA products the shape rule sent to cuBLAS,
# since the last reset; a graph's capture takes them back and adds them at
# each replay (``train/step.py::_ChunkGraph``)
BWD_LAUNCHES = 0
BWD_LIBRARY = 0

TILE = 128       # output rows and columns of a tile (kTileM, kTileN)
DEPTH = 32       # depth of a stage (kDepth)
MAX_SLICES = 32
MIN_SLICE_BLOCKS = 8   # stages a slice has at least, where it is cut

# the slice rule's cost model: one tile's stage on one SM, and the partial
# tiles' round trip through device memory
_STAGE_S = 1.3e-6
_BYTES_PER_S = 3.0e12

_TF32_MAX = 0x7F7FE000   # the largest finite TF32 value's bits


def takes(m: int, n: int, k: int) -> bool:
    """Whether the kernel takes a product ``C [m, n]`` over depth ``k``."""
    return m > 0 and n > 0 and k > 0 and m % TILE == 0 and n % TILE == 0 and k % DEPTH == 0


def slices(m: int, n: int, k: int, sms: int) -> int:
    """The slices the kernel cuts depth ``k`` into, on a card of ``sms`` SMs:
    the count that fills the card's waves of one block an SM best, less the
    partial tiles' traffic; at least ``MIN_SLICE_BLOCKS`` stages a slice."""
    tiles = (m // TILE) * (n // TILE)
    stages = k // DEPTH
    best, best_s = math.inf, 1
    for s in range(1, MAX_SLICES + 1):
        if s > 1 and stages // s < MIN_SLICE_BLOCKS:
            break
        t = math.ceil(tiles * s / sms) * math.ceil(stages / s) * _STAGE_S
        if s > 1:
            t += (2 * s + 1) * 4 * m * n / _BYTES_PER_S
        if t < best:
            best, best_s = t, s
    return best_s


def input_grad_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``g [B, out] @ w [in, out].T``."""
    return g @ w.t()


def weight_grad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``x [B, in].T @ g [B, out]``."""
    return x.t() @ g


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of f32 ``x`` as the kernel splits it
    (``csrc/tower_tile.cuh::split_tf32``): ``hi`` is x rounded to the
    nearest TF32 value, ties away from zero, and the largest TF32 value of
    x's sign where that would be inf; ``lo`` is ``x - hi`` rounded the same
    way. Finite x, and inf; the device's NaN bits are not reproduced."""
    bits = x.contiguous().view(torch.int32)
    hi = (bits + 0x1000) & -0x2000
    overflow = (hi & 0x7FFFFFFF) == 0x7F800000
    hi = torch.where(overflow, (hi & -0x80000000) | _TF32_MAX, hi).view(torch.float32)
    lo = ((x - hi).view(torch.int32) + 0x1000) & -0x2000
    return hi, lo.view(torch.float32)


@functools.cache
def _kernel():
    fn = load_library().dense_bwd_product
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    return fn


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_args(what: str, a: torch.Tensor, b: torch.Tensor, agree: bool) -> None:
    """Raise on operands the kernel does not take: ``agree`` says whether
    their shapes go together."""
    if a.device != b.device:
        raise ValueError(f"{what}: tensors on {a.device} and {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"{what} takes float32, not {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"{what} takes matrices, not {tuple(a.shape)} and {tuple(b.shape)}")
    if not agree:
        raise ValueError(f"{what}: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    for t in (a, b):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} takes contiguous, 16-byte aligned tensors; "
                             f"strides {t.stride()} at {t.data_ptr():#x}")


def _launch(what: str, a: torch.Tensor, b: torch.Tensor, m: int, n: int, k: int,
            k_major: bool) -> torch.Tensor:
    global BWD_LAUNCHES
    device = a.device
    index = device.index if device.index is not None else torch.cuda.current_device()
    s = slices(m, n, k, _sms(index))
    out = torch.empty((m, n), dtype=torch.float32, device=device)
    parts = torch.empty((s, m, n), dtype=torch.float32, device=device) if s > 1 else None
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = _kernel()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                         parts.data_ptr() if parts is not None else None, m, n, k,
                         int(k_major), s, stream)
    check(code, f"{what} ([{m}, {n}] over {k}, {s} slices)")
    BWD_LAUNCHES += 1
    return out


def input_grad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``g [B, out] @ w [in, out].T``, f32: the kernel on the card where it
    takes ``[B, in]`` over ``out``, else the plain version."""
    global BWD_LIBRARY
    if not is_cuda(g, "input_grad"):
        return input_grad_plain(g, w)
    m, k, n = g.shape[0], g.shape[-1], w.shape[0]
    if not takes(m, n, k):
        BWD_LIBRARY += 1
        return input_grad_plain(g, w)
    _check_args("input_grad", g, w, g.shape[1] == w.shape[1])
    return _launch("input_grad", g, w, m, n, k, True)


def weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``x [B, in].T @ g [B, out]``, f32: the kernel on the card where it
    takes ``[in, out]`` over ``B``, else the plain version."""
    global BWD_LIBRARY
    if not is_cuda(x, "weight_grad"):
        return weight_grad_plain(x, g)
    k, m, n = x.shape[0], x.shape[-1], g.shape[-1]
    if not takes(m, n, k):
        BWD_LIBRARY += 1
        return weight_grad_plain(x, g)
    _check_args("weight_grad", x, g, x.shape[0] == g.shape[0])
    return _launch("weight_grad", x, g, m, n, k, False)
