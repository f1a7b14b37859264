"""xDeepFM's CIN products on the card: the CUDA kernel's wrapper.

``ops/cin.py`` runs one CIN layer ``X^k = Z·W^k`` with ``Z[r, i·m + j] =
x[r, i]·x0[r, j]`` (``x`` = ``X^{k-1}`` ``[R, H]``, ``x0`` = ``X^0`` ``[R,
m]``, ``W^k`` ``[H·m, H_k]``) through three products: :func:`forward`,
:func:`weight_grad` (``Z^T·G``) and :func:`operand_grad` (``G·W^T``
reduced against the factors to the gradients of ``x`` and of ``x0``);
:func:`layer_grads` runs the last two on one set of operands. The kernel
is ``deepctr_torch/csrc/cin.cu``; it replaces no TPU kernel (the JAX package
has no CIN), and its source says what bounds it and how its design answers
that. It computes in float32 by the 3xTF32 split on the tensor cores and
forms ``Z`` in registers: neither ``Z`` nor its gradient reaches device
memory.

The entry points take CUDA tensors only: ``ops/cin.py`` chooses the route
by device and keeps the plain version (``outer`` and ``layer_grads``) for
CPU tensors. Each call launches the kernel (and counts in ``LAUNCHES``) or
raises: it takes any rows and maps, ``m <= MAX_FIELDS``, and for the
operand gradient ``H_k <= MAX_DEPTH``. The wrappers lay the factors out as
the kernel's copies want them (:class:`_Factors`: rows padded with zeros to
a multiple of ``TILE_M``, ``x`` transposed, ``x0`` padded to 40 fields) and
allocate the buffer for B's images, which the kernel packs itself. The
weight gradient's depth is cut into a fixed number of slices and the
operand gradient's columns into a fixed number of chunks, both chosen from
the shape and the card's SM count; a second kernel adds their parts in
order. No float atomics: two calls on one card give the same bits.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._build import check, load_library

# the kernel's launches since the last reset; a graph's capture takes them
# back and adds them at each replay (``train/step.py::_ChunkGraph``)
LAUNCHES = 0

MAX_FIELDS = 40    # m, padded to 40 inside the kernel (kFields)
MAX_DEPTH = 200    # the operand gradient's H_k: G's tile stays on chip (kMaxGLd)
TILE_M = 128       # rows of a tile (kTileM)
TILE_N = 104       # columns of a forward or weight-gradient tile
DEPTH = 32         # rows of R a weight-gradient stage (Wgrad::kDepth)
X_PAD = 8          # zero rows after x^T's maps (kXPad)
MAX_SPLIT = 32

# the split rule's cost model: one stage on one SM, and the parts' round
# trip through device memory
_STAGE_S = 1.2e-6
_BYTES_PER_S = 3.0e12


def split(parts: int, stages: int, tiles: int, sms: int, part_bytes: int,
          min_parts: int = 1) -> int:
    """The count of fixed pieces that ``parts`` whole parts of ``stages``
    stages each, of each of ``tiles`` tiles, are cut into: the one that
    fills the card's waves of one block an SM best, less the pieces'
    traffic (``part_bytes`` a piece); ties go to the fewer pieces; at least
    ``min_parts`` parts a piece where cut."""
    best, best_s = math.inf, 1
    for s in range(1, min(parts, MAX_SPLIT) + 1):
        if s > 1 and parts // s < min_parts:
            break
        t = math.ceil(tiles * s / sms) * math.ceil(parts / s) * stages * _STAGE_S
        if s > 1:
            t += (2 * s + 1) * part_bytes / _BYTES_PER_S
        if t < best - 1e-12:
            best, best_s = t, s
    return best_s


def slices(rows: int, h_in: int, h_out: int, sms: int) -> int:
    """The weight gradient's depth slices on a card of ``sms`` SMs: stages
    of ``DEPTH`` rows, at least 8 a slice."""
    tiles = math.ceil(h_in * MAX_FIELDS / TILE_M) * math.ceil(h_out / TILE_N)
    return split(math.ceil(rows / DEPTH), 1, tiles, sms, 4 * h_in * MAX_FIELDS * h_out,
                 min_parts=8)


def chunks(rows: int, h_in: int, h_out: int, m: int, sms: int) -> int:
    """The operand gradient's column chunks on a card of ``sms`` SMs: whole
    column tiles of two maps, each ``ceil(h_out / 40)`` stages."""
    return split(math.ceil(h_in / 2), math.ceil(h_out / 40), math.ceil(rows / TILE_M), sms,
                 4 * rows * m)


@functools.cache
def _kernels():
    lib = load_library()
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {"image_floats": (lib.cin_image_floats, [i, i, i, i, i], ctypes.c_longlong),
           "forward": (lib.cin_forward, [p] * 5 + [i] * 4 + [p], ctypes.c_int),
           "weight_grad": (lib.cin_weight_grad, [p] * 6 + [i] * 6 + [p], ctypes.c_int),
           "operand_grad": (lib.cin_operand_grad, [p] * 8 + [i] * 6 + [p], ctypes.c_int)}
    for fn, argtypes, restype in fns.values():
        fn.restype = restype
        fn.argtypes = argtypes
    return {name: fn for name, (fn, _, _) in fns.items()}


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_args(what: str, h_out: int, max_out: int | None = None,
               **tensors: torch.Tensor) -> None:
    """Raise on operands the kernel does not take: ``x`` ``[R, H]``, ``x0``
    ``[R, m]`` and any of ``w`` ``[H·m, h_out]``, ``g`` ``[R, h_out]`` and
    ``g_x0`` ``[R, m]``, f32, contiguous, on one device; ``0 < m <=
    MAX_FIELDS``; ``h_out <= max_out`` where given; nothing empty; indices
    within 32 bits."""
    x = tensors["x"]
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes float32, not {t.dtype} ({name})")
        if t.dim() != 2:
            raise ValueError(f"{what} takes matrices, not {name} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors; {name} has strides "
                             f"{t.stride()}")
    rows, h_in, m = x.shape[0], x.shape[1], tensors["x0"].shape[1]
    want = {"x": (rows, h_in), "x0": (rows, m), "w": (h_in * m, h_out),
            "g": (rows, h_out), "g_x0": (rows, m)}
    for name, t in tensors.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} with x {tuple(x.shape)} and "
                             f"x0 {tuple(tensors['x0'].shape)} (expected {want[name]})")
    if not 0 < m <= MAX_FIELDS:
        raise ValueError(f"{what} takes 1 to {MAX_FIELDS} fields, not {m}")
    if max_out is not None and h_out > max_out:
        raise ValueError(f"{what} takes up to {max_out} maps out, not {h_out}")
    if rows == 0 or h_in == 0 or h_out == 0:
        raise ValueError(f"{what}: an empty operand ({rows} rows, {h_in} maps in, "
                         f"{h_out} out)")
    rows_p = _padded(rows)
    if max(rows_p * max(h_in + X_PAD, MAX_FIELDS, h_out), h_in * m * h_out) >= 2 ** 31:
        raise ValueError(f"{what}: [{rows}, {h_in}] x [{h_in * m}, {h_out}] is past the "
                         f"kernel's 32-bit indices")


def _padded(rows: int) -> int:
    return -(-rows // TILE_M) * TILE_M


class _Factors:
    """The kernel's views of ``x`` and ``x0`` (rows padded with zeros to a
    multiple of ``TILE_M``): ``xt`` = x^T ``[H + X_PAD, rows]``, zero past
    ``H``; ``x0p`` = x0 ``[rows, 40]``, zero past ``m``; and, made on first
    use, ``xb`` and ``x0b``, both transposed by blocks of ``DEPTH`` rows
    (``[rows / 32, H + X_PAD, 48]`` and ``[rows / 32, 40, 48]``, 32 floats
    of data a row: a weight-gradient stage copies one block of each)."""

    def __init__(self, x: torch.Tensor, x0: torch.Tensor):
        self.rows_real, self.h_in = x.shape
        self.m = x0.shape[1]
        self.rows = _padded(self.rows_real)
        self.xt = torch.empty((self.h_in + X_PAD, self.rows), dtype=torch.float32,
                              device=x.device)
        self.xt[:self.h_in, :self.rows_real].copy_(x.t())
        self.xt[:self.h_in, self.rows_real:].zero_()
        self.xt[self.h_in:].zero_()
        self.x0p = torch.zeros((self.rows, MAX_FIELDS), dtype=torch.float32, device=x.device)
        self.x0p[:self.rows_real, :self.m].copy_(x0)
        self._blocks = None

    def blocks(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._blocks is None:
            nb = self.rows // DEPTH
            xb = torch.empty((nb, self.h_in + X_PAD, DEPTH + 16), dtype=torch.float32,
                             device=self.xt.device)
            xb[:, :, :DEPTH].copy_(self.xt.view(-1, nb, DEPTH).transpose(0, 1))
            x0b = torch.empty((nb, MAX_FIELDS, DEPTH + 16), dtype=torch.float32,
                              device=self.xt.device)
            x0b[:, :, :DEPTH].copy_(self.x0p.view(nb, DEPTH, MAX_FIELDS).transpose(1, 2))
            self._blocks = (xb, x0b)
        return self._blocks

    def images(self, form: int, h_out: int) -> torch.Tensor:
        n = _kernels()["image_floats"](form, self.rows, self.h_in, self.m, h_out)
        return torch.empty(n, dtype=torch.float32, device=self.xt.device)


def _launch(what: str, x: torch.Tensor, ptrs: tuple, dims: tuple) -> None:
    global LAUNCHES
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _kernels()[what](*ptrs, *dims, stream)
    check(code, f"cin {what} at rows, (real rows,) maps in, fields, maps out (, pieces) "
                f"{dims}")
    LAUNCHES += 1


def _card_sms(x: torch.Tensor) -> int:
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return _sms(index)


def _forward(f: _Factors, w: torch.Tensor) -> torch.Tensor:
    h_out = w.shape[1]
    out = torch.empty((f.rows, h_out), dtype=torch.float32, device=w.device)
    img = f.images(0, h_out)
    _launch("forward", w, (f.xt.data_ptr(), f.x0p.data_ptr(), w.data_ptr(), img.data_ptr(),
                           out.data_ptr()), (f.rows, f.h_in, f.m, h_out))
    return out[:f.rows_real]


def _weight_grad(f: _Factors, g: torch.Tensor) -> torch.Tensor:
    h_out = g.shape[1]
    s = slices(f.rows, f.h_in, h_out, _card_sms(g))
    out = torch.empty((f.h_in * f.m, h_out), dtype=torch.float32, device=g.device)
    parts = (torch.empty((s, f.h_in * f.m, h_out), dtype=torch.float32, device=g.device)
             if s > 1 else None)
    img = f.images(1, h_out)
    xb, x0b = f.blocks()
    _launch("weight_grad", g, (xb.data_ptr(), x0b.data_ptr(), g.data_ptr(), img.data_ptr(),
                               out.data_ptr(), parts.data_ptr() if parts is not None else None),
            (f.rows, f.rows_real, f.h_in, f.m, h_out, s))
    return out


def _operand_grad(f: _Factors, w: torch.Tensor, g: torch.Tensor,
                  g_x0: torch.Tensor) -> torch.Tensor:
    h_out = w.shape[1]
    ld = 40 * -(-h_out // 40)
    if ld == h_out and f.rows == f.rows_real:
        gp = g
    else:
        gp = torch.zeros((f.rows, ld), dtype=torch.float32, device=g.device)
        gp[:f.rows_real, :h_out].copy_(g)
    c = chunks(f.rows, f.h_in, h_out, f.m, _card_sms(g))
    g_x = torch.empty((f.rows, f.h_in), dtype=torch.float32, device=g.device)
    parts = torch.empty((c, f.rows, f.m), dtype=torch.float32, device=g.device)
    img = f.images(2, h_out)
    _launch("operand_grad", g, (f.xt.data_ptr(), f.x0p.data_ptr(), gp.data_ptr(), w.data_ptr(),
                                img.data_ptr(), g_x.data_ptr(), g_x0.data_ptr(),
                                parts.data_ptr()),
            (f.rows, f.rows_real, f.h_in, f.m, h_out, c))
    return g_x[:f.rows_real]


def _on_card(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on a CUDA card, not {x.device}: ops/cin.py takes "
                         f"other tensors to its plain version")


def forward(x: torch.Tensor, x0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``X^k = Z @ w`` ``[R, H_k]``."""
    _on_card(x, "cin forward")
    check_args("cin forward", w.shape[-1], x=x, x0=x0, w=w)
    return _forward(_Factors(x, x0), w)


def weight_grad(x: torch.Tensor, x0: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``g_W = Z.T @ g`` ``[H·m, H_k]``."""
    _on_card(x, "cin weight_grad")
    check_args("cin weight_grad", g.shape[-1], x=x, x0=x0, g=g)
    return _weight_grad(_Factors(x, x0), g)


def operand_grad(x: torch.Tensor, x0: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                 g_x0: torch.Tensor) -> torch.Tensor:
    """``g_x`` ``[R, H]`` of ``Z @ w`` under upstream ``g``, adding what
    passes through the ``x0`` factor into ``g_x0`` ``[R, m]`` in place."""
    _on_card(x, "cin operand_grad")
    check_args("cin operand_grad", w.shape[-1], MAX_DEPTH, x=x, x0=x0, w=w, g=g, g_x0=g_x0)
    return _operand_grad(_Factors(x, x0), w, g, g_x0)


def layer_grads(x: torch.Tensor, x0: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                g_x0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(g_x, g_W)`` of one layer, :func:`weight_grad` and
    :func:`operand_grad` on one set of the kernel's views of the factors."""
    _on_card(x, "cin layer_grads")
    check_args("cin layer_grads", w.shape[-1], MAX_DEPTH, x=x, x0=x0, w=w, g=g, g_x0=g_x0)
    f = _Factors(x, x0)
    g_w = _weight_grad(f, g)
    return _operand_grad(f, w, g, g_x0), g_w
