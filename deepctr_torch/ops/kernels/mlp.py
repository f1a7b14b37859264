"""Fused dense-tower forward: the CUDA kernel and its plain PyTorch version.

Port of ``deepctr_tpu/ops/pallas/mlp.py::_tower_fwd`` (entry
``mlp_tower_fused``) on its dropout-free branch, the one serving runs. The
kernel is ``deepctr_torch/csrc/mlp_tower_fwd.cu``; its source says what
bounds it on the card and how its design answers that.

Layers are ``(w, b)`` pairs in the JAX layout: ``w`` is ``[in, out]``, ``b``
is ``[out]``. The hidden layers take the activation; the logit is column 0
of the last layer. No dims are padded: the TPU kernel's 128-lane padding is
a TPU mechanism, and the CUDA kernel masks its ragged edges itself.

The plain version is ``torch.matmul`` + bias + activation per layer. It
computes in full f32 as long as ``torch.backends.cuda.matmul.allow_tf32`` is
False (PyTorch's default); whoever times or compares it on the card sets
that flag explicitly.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from ._build import check, load_library

Layers = Sequence[tuple[torch.Tensor, torch.Tensor]]

ACTIVATIONS = {"tanh": 0, "relu": 1, "sigmoid": 2}
_PLAIN_ACTS = {"tanh": torch.tanh, "relu": torch.relu, "sigmoid": torch.sigmoid}
MAX_LAYERS = 8  # kMaxLayers in the CUDA source

# kernel launches made by mlp_tower_fwd since the last reset
LAUNCHES = 0


def mlp_tower_plain(x: torch.Tensor, layers: Layers,
                    activation: str = "tanh") -> torch.Tensor:
    """Plain tower: ``[B, in]`` -> ``[B]`` logits (the eval path of
    ``deepctr_tpu.models.base.apply_mlp``)."""
    act = _PLAIN_ACTS[activation]
    h = x
    for i, (w, b) in enumerate(layers):
        h = torch.matmul(h, w) + b
        if i < len(layers) - 1:
            h = act(h)
    return h[:, 0]


@functools.cache
def _kernel():
    fn = load_library().mlp_tower_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    return fn


def _check_args(x: torch.Tensor, layers: Layers, activation: str) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r} (tanh|relu|sigmoid)")
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"{len(layers)} layers; the kernel takes 1..{MAX_LAYERS}")
    tensors = [x] + [t for layer in layers for t in layer]
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    if x.dim() != 2:
        raise ValueError(f"x must be [B, in], got {tuple(x.shape)}")
    d_in = x.shape[1]
    for i, (w, b) in enumerate(layers):
        if w.dim() != 2 or w.shape[0] != d_in or b.shape != (w.shape[1],):
            raise ValueError(
                f"layer {i}: w {tuple(w.shape)}, b {tuple(b.shape)} do not "
                f"chain from width {d_in}"
            )
        d_in = w.shape[1]


def mlp_tower_fwd(x: torch.Tensor, layers: Layers,
                  activation: str = "tanh") -> torch.Tensor:
    """Fused tower: ``[B, in]`` -> ``[B]`` logits.

    A CPU ``x`` takes :func:`mlp_tower_plain`. A CUDA ``x`` launches the
    kernel on the current stream, or raises.
    """
    global LAUNCHES
    if x.device.type == "cpu":
        return mlp_tower_plain(x, layers, activation)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_tower_fwd runs on cpu or cuda, not {x.device}")
    _check_args(x, layers, activation)
    batch = x.shape[0]
    out = torch.empty(batch, device=x.device, dtype=torch.float32)
    if batch == 0:
        return out
    n = len(layers)
    dims = (ctypes.c_int * (n + 1))(x.shape[1], *(w.shape[1] for w, _ in layers))
    weights = (ctypes.c_void_p * n)(*(w.data_ptr() for w, _ in layers))
    biases = (ctypes.c_void_p * n)(*(b.data_ptr() for _, b in layers))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _kernel()(
            x.data_ptr(), batch, n, dims, weights, biases,
            ACTIVATIONS[activation], out.data_ptr(), stream,
        )
    check(code, f"mlp_tower_fwd (widths {list(dims)})")
    LAUNCHES += 1
    return out
