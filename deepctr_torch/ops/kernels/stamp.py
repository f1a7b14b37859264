"""Device phase stamps: the CUDA kernel and its plain PyTorch version.

The kernel is ``deepctr_torch/csrc/phase_stamp.cu``; it replaces no TPU
kernel (its source says why it exists). :class:`~deepctr_torch.utils.prof.
PhaseRing` owns the buffer and calls :func:`phase_stamp` while a graph is
captured with tracing on, once at each boundary of each step.

``buf`` is int64 ``[replays + 1, width]``: a ring of ``replays`` rows of
``width`` stamps, and ``buf[replays, 0]``, the count of replays whose first
stamp (slot 0) has run. Slot 0 takes the count as its row and advances it;
every later slot writes into row ``count - 1``, modulo ``replays``.
"""

from __future__ import annotations

import ctypes
import functools
import time

import torch

from ._build import check, is_cuda, load_library

# kernel launches since the last reset; a graph's capture takes its stamps
# back and adds them at each replay (``train/step.py::_ChunkGraph``), as it
# does the other kernels' counts
LAUNCHES = 0


def phase_stamp_plain(buf: torch.Tensor, slot: int, now_ns: int) -> None:
    """The plain version: the kernel's arithmetic on a CPU buffer, with
    ``now_ns`` for the device's clock."""
    replays = buf.shape[0] - 1
    n = int(buf[replays, 0])
    if slot == 0:
        buf[replays, 0] = n + 1
    else:
        n -= 1
    buf[n % replays, slot] = now_ns


@functools.cache
def _kernel():
    fn = load_library().phase_stamp
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    return fn


def phase_stamp(buf: torch.Tensor, slot: int) -> None:
    """Stamp ``slot`` of the current replay's row of ``buf``: on the card the
    device's ``%globaltimer``, launched on the current stream (a captured
    graph replays it); on the CPU the host's ``time.perf_counter_ns()``."""
    global LAUNCHES
    if buf.dtype != torch.int64 or buf.dim() != 2 or not buf.is_contiguous():
        raise ValueError(f"a stamp buffer is contiguous int64 [replays + 1, width], "
                         f"not {buf.dtype} {tuple(buf.shape)}")
    replays, width = buf.shape[0] - 1, buf.shape[1]
    if replays < 1 or not 0 <= slot < width:
        raise ValueError(f"slot {slot} of a buffer {tuple(buf.shape)}")
    if not is_cuda(buf, "phase_stamp"):
        phase_stamp_plain(buf, slot, time.perf_counter_ns())
        return
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        code = _kernel()(buf.data_ptr(), replays, width, slot, stream)
    check(code, f"phase_stamp (slot {slot} of {tuple(buf.shape)})")
    LAUNCHES += 1
