"""Dense-mode sparse Adagrad: the CUDA update of the touched rows and its
plain PyTorch version.

The kernel is ``deepctr_torch/csrc/sparse_adagrad.cu``; it replaces no TPU
kernel (the reference's update is plain jnp; its source says why it
exists). :class:`~deepctr_torch.optim.sparse.SparseAdagrad` calls
:func:`adagrad_dense_update` in dense mode (``mode="dense"``, or ``"auto"``
on a table of 64 M elements or fewer). The kernel writes only the rows the
batch touches, and gives the table and accumulator that the plain version,
a scatter of the per-row totals and a pass over the whole table, gives, bit
for bit: its per-row sums are exact integers in the same 61-bit fixed point.

Each accumulator the kernel updates owns one workspace: an int32 ``[V]``
of owner slots (``INT_MAX`` between calls) and a few KB of scratch (the
scale, counts, the elect pass's maxima), made once; and, for the largest
occurrence count M it has seen, an int32 ``[M]`` of counts (zeros between
calls), a buffer of lists (the owner list, each occurrence's place, the rows'
segments and chunks: nothing kept between calls) and the split rows'
workspace, an int64 ``[M // (C + 1), D]`` of sums and an int32 count of
finished chunks each (zeros between calls), C the kernel's chunk for M
occurrences of width D (:func:`chunk`). Each call leaves them as it found
them. The workspace is made, and grown to a larger M, outside any capture
(the graph route's eager warm-up step does it); a capture that would have
to make or grow it raises. A grown workspace keeps its smaller buffers,
which a graph captured at that M still launches on. It goes with the
accumulator: a released train state leaves no device memory behind.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref

import torch

from ..scatter import scatter_totals
from ._build import check, is_cuda, load_library

# kernel launches since the last reset (one an update: its four kernels); a
# graph's capture takes its launches back and adds them at each replay
# (``train/step.py::_ChunkGraph``)
LAUNCHES = 0

# device -> int64 [1]: the rows the kernel has written on that device, added
# on the device by every update (eager or replayed); read with
# :func:`rows_written`. The train step never reads it.
ROWS_WRITTEN: dict[torch.device, torch.Tensor] = {}
# device -> int64 [1]: the rows whose occurrences in an update took more than
# one chunk of C, added like ROWS_WRITTEN; read with :func:`rows_split`.
ROWS_SPLIT: dict[torch.device, torch.Tensor] = {}

# each pass's blocks at most (the elect pass's take 256 occurrences at a
# time): one partial maximum an elect block in the scratch
MAX_BLOCKS = 1024
_INT_MAX = 2**31 - 1


@dataclasses.dataclass
class _Workspace:
    owner: torch.Tensor          # int32 [V]
    scratch: torch.Tensor        # int64, _scratch_bytes() at least
    counts: torch.Tensor         # int32 [M], M the largest count seen
    lists: torch.Tensor          # uint8, _list_bytes(M, C) at least
    split_sums: torch.Tensor     # int64 [M // (C + 1), D] at least
    split_done: torch.Tensor     # int32 [M // (C + 1)] at least
    retired: list = dataclasses.field(default_factory=list)   # smaller M's buffers


# id of the accumulator -> its workspace; dropped when the accumulator is freed
_WORKSPACES: dict[int, _Workspace] = {}


def adagrad_dense_plain(table: torch.Tensor, acc: torch.Tensor, ids: torch.Tensor,
                        rows: torch.Tensor, lr: float, eps: float) -> None:
    """The plain version: the per-row totals of ``rows`` by ``ids`` in a
    dense f32 scratch (ids equal to V go to a spare row, dropped), then
    Adagrad on every row of ``table`` and ``acc``, in place; a row no id
    touches has a total of 0 and keeps its bits."""
    g = scatter_totals(table.shape[0], ids, rows)
    acc.add_(g * g)
    table.copy_(table.float() - lr * g / (acc.sqrt() + eps))


@functools.cache
def _kernel():
    fn = load_library().sparse_adagrad_dense
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, *[ctypes.c_void_p] * 6, ctypes.c_int,
                   *[ctypes.c_void_p] * 3]
    return fn


@functools.cache
def _scratch_bytes() -> int:
    fn = load_library().sparse_adagrad_scratch_bytes
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int]
    return fn(MAX_BLOCKS)


@functools.cache
def _chunk(m: int, d: int, index: int) -> int:
    fn = load_library().sparse_adagrad_chunk
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int]
    with torch.cuda.device(index):
        c = fn(m, d)
    if c < 1:
        raise RuntimeError(f"sparse_adagrad_chunk({m}, {d}) failed on cuda:{index}")
    return c


def chunk(m: int, d: int, device) -> int:
    """C, the kernel's chunk for an update of ``m`` occurrences of width
    ``d`` on the CUDA ``device``: a row with more than C occurrences is
    summed in chunks of C and counted in ``ROWS_SPLIT``. C is about half the
    occurrences each lane group of the card would take if they were dealt
    out evenly (at least one round of loads), so no chunk keeps its group
    much past the others."""
    device = torch.device(device)
    return _chunk(m, d, device.index if device.index is not None
                  else torch.cuda.current_device())


def _list_bytes(m: int, c: int) -> int:
    fn = load_library().sparse_adagrad_list_bytes
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    return fn(m, c)


def _check_args(table, acc, ids, rows) -> None:
    for t in (acc, ids, rows):
        if t.device != table.device:
            raise ValueError(f"tensors on {t.device} and {table.device}")
    for name, t in (("table", table), ("acc", acc), ("ids", ids), ("rows", rows)):
        if not t.is_contiguous():
            raise ValueError(f"the update takes contiguous tensors; {name} is not")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the table is float32 or bfloat16, not {table.dtype}")
    if acc.dtype != torch.float32 or rows.dtype != torch.float32:
        raise TypeError(f"acc and rows are float32, not {acc.dtype} and {rows.dtype}")
    if ids.dtype != torch.int64:
        raise TypeError(f"ids are int64, not {ids.dtype}")
    if table.dim() != 2 or acc.shape != table.shape:
        raise ValueError(f"table [V, D] and acc of its shape, not {tuple(table.shape)} "
                         f"and {tuple(acc.shape)}")
    if ids.dim() != 1 or rows.shape != (ids.shape[0], table.shape[1]):
        raise ValueError(f"ids [M] and rows [M, {table.shape[1]}], not {tuple(ids.shape)} "
                         f"and {tuple(rows.shape)}")
    if rows.numel() >= 2**31 or table.shape[0] >= 2**31:
        raise ValueError(f"rows {tuple(rows.shape)} or table {tuple(table.shape)} past "
                         f"the kernel's 32-bit indices")


def _workspace(acc: torch.Tensor, m: int, c: int) -> _Workspace:
    """``acc``'s workspace, made at its first use and grown to ``m``
    occurrences in chunks of ``c``."""
    d, list_bytes, split_rows = acc.shape[1], _list_bytes(m, c), m // (c + 1)
    ws = _WORKSPACES.get(id(acc))
    if ws is not None and (ws.counts.shape[0] >= m and ws.lists.shape[0] >= list_bytes
                           and ws.split_done.shape[0] >= split_rows):
        return ws
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "adagrad_dense_update would make or grow its workspace inside a CUDA graph "
            "capture: run one update of this accumulator and batch shape eagerly "
            "first (the graph route's warm-up step does)")
    device = acc.device
    if ws is not None:   # grown to hold both what it held and this call
        m = max(m, ws.counts.shape[0])
        list_bytes = max(list_bytes, ws.lists.shape[0])
        split_rows = max(split_rows, ws.split_done.shape[0])
    per_m = (torch.zeros(m, dtype=torch.int32, device=device),
             torch.empty(list_bytes, dtype=torch.uint8, device=device),
             torch.zeros((split_rows, d), dtype=torch.int64, device=device),
             torch.zeros(split_rows, dtype=torch.int32, device=device))
    if ws is None:
        for counters in (ROWS_WRITTEN, ROWS_SPLIT):
            if device not in counters:
                counters[device] = torch.zeros(1, dtype=torch.int64, device=device)
        ws = _Workspace(
            torch.full((acc.shape[0],), _INT_MAX, dtype=torch.int32, device=device),
            torch.zeros(-(-_scratch_bytes() // 8), dtype=torch.int64, device=device),
            *per_m)
        _WORKSPACES[id(acc)] = ws
        weakref.finalize(acc, _WORKSPACES.pop, id(acc), None)
    else:
        ws.retired.append((ws.counts, ws.lists, ws.split_sums, ws.split_done))
        ws.counts, ws.lists, ws.split_sums, ws.split_done = per_m
    return ws


def _read(counters: dict, device) -> int:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    count = counters.get(device)
    return 0 if count is None else int(count)


def rows_written(device) -> int:
    """The rows the kernel has written on ``device`` (a synchronising read)."""
    return _read(ROWS_WRITTEN, device)


def rows_split(device) -> int:
    """The rows the kernel has summed in more than one chunk on ``device``
    (a synchronising read)."""
    return _read(ROWS_SPLIT, device)


def adagrad_dense_update(table: torch.Tensor, acc: torch.Tensor, ids: torch.Tensor,
                         rows: torch.Tensor, lr: float, eps: float) -> None:
    """Sparse Adagrad in dense mode, in place: ``acc += G^2``, ``table -= lr
    * G / (sqrt(acc) + eps)`` with ``G`` the per-row sums of ``rows``
    (f32 ``[M, D]``) by ``ids`` (int64 ``[M]``); a table in f32 or bf16
    ``[V, D]``, an f32 accumulator of its shape.

    CPU tensors take :func:`adagrad_dense_plain`. CUDA tensors launch the
    kernel on the current stream, with no host sync, or raise; it writes the
    rows of ``ids`` in ``[0, V)`` alone, with the plain version's bits. Each
    of ``lr`` and ``eps`` is rounded to f32, as PyTorch rounds a scalar.
    """
    global LAUNCHES
    _check_args(table, acc, ids, rows)
    if not is_cuda(table, "adagrad_dense_update"):
        adagrad_dense_plain(table, acc, ids, rows, lr, eps)
        return
    m, d = rows.shape
    if m == 0:
        return
    c = chunk(m, d, table.device)
    ws = _workspace(acc, m, c)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        code = _kernel()(table.data_ptr(), int(table.dtype == torch.bfloat16),
                         acc.data_ptr(), ids.data_ptr(), rows.data_ptr(), table.shape[0],
                         d, m, c, lr, eps, ws.owner.data_ptr(), ws.counts.data_ptr(),
                         ws.lists.data_ptr(), ws.split_sums.data_ptr(),
                         ws.split_done.data_ptr(), ws.scratch.data_ptr(), MAX_BLOCKS,
                         ROWS_WRITTEN[table.device].data_ptr(),
                         ROWS_SPLIT[table.device].data_ptr(), stream)
    check(code, f"adagrad_dense_update (table {list(table.shape)}, rows {list(rows.shape)})")
    LAUNCHES += 1
