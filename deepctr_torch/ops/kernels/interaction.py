"""Fused FM scorer: the CUDA kernel and its plain PyTorch version.

Port of ``deepctr_tpu/ops/pallas/interaction.py``: the forward
``_fm_scorer_fwd`` (entry ``fm_score_fused``) and the ``custom_vjp``
``fm_score``, here the autograd Function behind :func:`fm_score`. The
kernel is ``deepctr_torch/csrc/fm_score.cu``: persistent blocks walk over
tiles of whole examples, which the copy engine brings into a ring of
shared-memory stages (bulk asynchronous copies completing on ``mbarrier``s)
while the consumer warps reduce the tile before. Its source says what bounds
it on the card (bytes, and at the training shape the launch) and how the
design answers that. The copy engine wants 16-byte aligned addresses, so the
wrapper refuses tensors whose first element is not: a view with a storage
offset is copied by the caller first (``.clone()``).

For rows f32 ``[B, S, 1+k]`` = ``(w | v)`` and mask f32 ``[B, S]`` the
logit part is ``sum_s w_s m_s + 1/2 sum_f [(sum_s v_sf m_s)^2 -
sum_s (v_sf m_s)^2]``, f32 ``[B]``, in full f32 (no TF32, no tensor cores:
the reference insisted on HIGHEST precision for its selection matmuls).

The backward is the reference's closed form in plain ops, as
``_fm_score_bwd_rule`` is plain jnp: ``d/dw_s = g m_s`` and ``d/dv_sf =
(sum_s' v_s'f m_s' - v_sf m_s) g m_s``. The mask gets no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..interaction import fm_interaction
from ._build import check, is_cuda, load_library

MAX_K = 64  # kMaxD - 1 in csrc/fm_score.cu
ALIGN = 16  # bytes: the bulk copies' source alignment

# kernel launches since the last reset
LAUNCHES = 0


def fm_score_plain(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The plain version, the reference oracle's arithmetic: the masked
    linear sum plus :func:`~deepctr_torch.ops.interaction.fm_interaction`."""
    return (rows[..., 0] * mask).sum(dim=1) + fm_interaction(rows[..., 1:], mask)


def fm_score_bwd(rows: torch.Tensor, mask: torch.Tensor,
                 g: torch.Tensor) -> torch.Tensor:
    """The gradient of the scorer for rows, given the upstream ``g`` ``[B]``
    (the reference's ``_fm_score_bwd_rule``)."""
    m = mask[..., None]
    v = rows[..., 1:] * m
    gv = (v.sum(dim=1, keepdim=True) - v) * g[:, None, None]
    gw = g[:, None, None].expand(rows[..., :1].shape)
    return torch.cat([gw, gv], dim=-1) * m


@functools.cache
def _kernel():
    fn = load_library().fm_score_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _check_args(rows: torch.Tensor, mask: torch.Tensor) -> None:
    for t in (rows, mask):
        if t.device != rows.device:
            raise ValueError(f"tensors on {t.device} and {rows.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
        if t.data_ptr() % ALIGN:
            raise ValueError(
                f"the kernel takes tensors aligned to {ALIGN} bytes; this one "
                f"starts {t.data_ptr() % ALIGN} bytes past that (a view with a "
                f"storage offset?)")
    if rows.dim() != 3 or rows.shape[1] < 1:
        raise ValueError(f"rows must be [B, S, 1+k], got {tuple(rows.shape)}")
    if mask.shape != rows.shape[:2]:
        raise ValueError(f"mask {tuple(mask.shape)} does not match rows "
                         f"{tuple(rows.shape)}")
    if not 1 <= rows.shape[2] <= MAX_K + 1:
        raise ValueError(f"rows of width {rows.shape[2]}: the kernel takes "
                         f"1 + k with k <= {MAX_K}")


def fm_score_fwd(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Fused FM logit part: rows ``[B, S, 1+k]``, mask ``[B, S]`` -> ``[B]``,
    no autograd.

    CPU tensors take :func:`fm_score_plain`. CUDA tensors launch the kernel
    on the current stream, or raise. The kernel sums in a fixed order: two
    launches on the same inputs give the same bits.
    """
    global LAUNCHES
    if not is_cuda(rows, "fm_score_fwd"):
        return fm_score_plain(rows, mask)
    _check_args(rows, mask)
    batch, slots, d = rows.shape
    out = torch.empty(batch, device=rows.device, dtype=torch.float32)
    if batch == 0:
        return out
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        code = _kernel()(rows.data_ptr(), mask.data_ptr(), batch, slots, d,
                         out.data_ptr(), stream)
    check(code, f"fm_score_fwd (rows {list(rows.shape)})")
    LAUNCHES += 1
    return out


class _FMScore(torch.autograd.Function):
    """The counterpart of the reference's ``custom_vjp`` ``fm_score``."""

    @staticmethod
    def forward(ctx, rows, mask):
        ctx.save_for_backward(rows, mask)
        return fm_score_fwd(rows, mask)

    @staticmethod
    def backward(ctx, g):
        rows, mask = ctx.saved_tensors
        return fm_score_bwd(rows, mask, g), None


def fm_score(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Differentiable fused FM logit part: rows ``[B, S, 1+k]``, mask
    ``[B, S]`` -> ``[B]``, with a gradient for ``rows``."""
    return _FMScore.apply(rows, mask)
