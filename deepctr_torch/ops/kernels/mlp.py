"""Fused dense tower: the CUDA kernels and their plain PyTorch versions.

Port of ``deepctr_tpu/ops/pallas/mlp.py``: the forward ``_tower_fwd``
(entry ``mlp_tower_fused``) with and without its in-kernel dropout
(``_dropout_mask``), the fused backward ``_tower_bwd``, and the
``custom_vjp`` ``mlp_tower`` that joins them, here the autograd Function
behind :func:`mlp_tower`. The kernels are ``deepctr_torch/csrc/
mlp_tower_fwd.cu`` and ``mlp_tower_bwd.cu``; their sources say what bounds
them on the card and how their design answers that.

Layers are ``(w, b)`` pairs in the JAX layout: ``w`` is ``[in, out]``, ``b``
is ``[out]``. The hidden layers take the activation, then the dropout; the
logit is column 0 of the last layer. No dims are padded: the TPU kernel's
128-lane padding is a TPU mechanism, and the CUDA kernels mask their ragged
edges themselves.

Dropout is the reference's stateless counter hash: element ``(row, col)`` of
hidden layer ``l`` is kept when ``fmix32(row*0x9E3779B9 + col*0x85EBCA6B +
seed*0xC2B2AE35 + (l+1)*0x27D4EB2F) < int(keep * 0xFFFFFFFF)`` (uint32
arithmetic), and kept values are multiplied by the f32 quotient
``1 / keep``. ``row`` is the global batch row, so the mask does not depend
on tiling, and forward and backward draw the same mask by construction.

The seed is an int, or a 0-d int32 tensor on the tower's device that the
kernels read when they run: a CUDA graph replays its launches with the
arguments they were captured with, so a graph of train steps
(``train/step.py::make_scan_train_step``) hands each step a slot of a seed
buffer that it refills before every replay. Both forms give the same mask.
An int seed is held below ``SEED_LIMIT`` here; a tensor's value is not read
on the host (that would be a sync), so whoever draws it keeps it in range.

The plain versions are ``torch.matmul`` + bias + activation per layer. They
compute in full f32 as long as ``torch.backends.cuda.matmul.allow_tf32`` is
False (PyTorch's default); whoever times or compares them on the card sets
that flag explicitly.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from ._build import check, is_cuda, load_library

Layers = Sequence[tuple[torch.Tensor, torch.Tensor]]

ACTIVATIONS = {"tanh": 0, "relu": 1, "sigmoid": 2}
_PLAIN_ACTS = {"tanh": torch.tanh, "relu": torch.relu, "sigmoid": torch.sigmoid}
MAX_LAYERS = 8  # kMaxLayers in the CUDA sources
SEED_LIMIT = 1 << 24  # the reference carries the seed as an exact f32

Seed = int | torch.Tensor  # an int, or a 0-d int32 tensor on the device

# kernel launches since the last reset: every forward, the forwards with
# dropout among them, and the backward
LAUNCHES = 0
DROPOUT_LAUNCHES = 0
BWD_LAUNCHES = 0

_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32): the constant is split
    into 16-bit halves so that no product reaches 2^63."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _keep_params(keep: float) -> tuple[int, float]:
    """``(threshold, scale)`` of a keep probability, computed as the
    reference computes them: the threshold in Python double, the scale as
    the f32 quotient ``1 / f32(keep)``."""
    return int(keep * 0xFFFFFFFF), float(np.float32(1.0) / np.float32(keep))


def dropout_params(dropout: float) -> tuple[int, float]:
    """``(threshold, scale)`` of a dropout rate, whose keep probability is
    ``1.0 - dropout`` as the reference's kernels take it."""
    return _keep_params(1.0 - dropout)


def dropout_mask_plain(shape: tuple[int, int], keep: float, seed: Seed,
                       layer: int, row0: int = 0,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """The reference's ``_dropout_mask``, bit for bit: f32 ``[rows, cols]``
    of ``1/keep`` where kept and 0 where dropped. ``seed`` is an int or a
    0-d integer tensor."""
    rows, cols = shape
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None] + row0
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    s = (seed.to(device=device, dtype=torch.int64)
         if isinstance(seed, torch.Tensor) else int(seed))
    h = (_mul_u32(r & _U32, 0x9E3779B9) + _mul_u32(c, 0x85EBCA6B)
         + _mul_u32(s & _U32, 0xC2B2AE35)
         + ((layer + 1) * 0x27D4EB2F & _U32)) & _U32
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul_u32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    threshold, scale = _keep_params(keep)
    return torch.where(h < threshold, scale, 0.0).to(torch.float32)


def mlp_tower_plain(x: torch.Tensor, layers: Layers, activation: str = "tanh",
                    dropout: float = 0.0, seed: Seed = 0) -> torch.Tensor:
    """Plain tower: ``[B, in]`` -> ``[B]`` logits. With ``dropout > 0``
    each hidden activation is multiplied by :func:`dropout_mask_plain` of
    its layer, as the reference's fused kernel does."""
    act = _PLAIN_ACTS[activation]
    h = x
    for i, (w, b) in enumerate(layers):
        h = torch.matmul(h, w) + b
        if i < len(layers) - 1:
            h = act(h)
            if dropout > 0.0:
                h = h * dropout_mask_plain(tuple(h.shape), 1.0 - dropout, seed,
                                           i, device=h.device)
    return h[:, 0]


def mlp_tower_bwd_plain(x: torch.Tensor, layers: Layers, g: torch.Tensor,
                        activation: str = "tanh", dropout: float = 0.0,
                        seed: Seed = 0):
    """Gradients of :func:`mlp_tower_plain` for upstream ``g`` ``[B]``:
    ``(gx, [(gw, gb), ...])``, by autograd through the plain forward."""
    with torch.enable_grad():
        xs = x.detach().requires_grad_(True)
        params = [t.detach().requires_grad_(True) for layer in layers for t in layer]
        pairs = list(zip(params[0::2], params[1::2]))
        out = mlp_tower_plain(xs, pairs, activation, dropout, seed)
        grads = torch.autograd.grad(out, [xs] + params, g)
    return grads[0], list(zip(grads[1::2], grads[2::2]))


@functools.cache
def _fwd_kernel():
    lib = load_library()
    fn = lib.mlp_tower_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p,
    ]
    ws = lib.mlp_tower_fwd_workspace
    ws.restype = ctypes.c_size_t
    ws.argtypes = [ctypes.c_int, ctypes.c_void_p]
    return fn, ws


@functools.cache
def _bwd_kernel():
    lib = load_library()
    fn = lib.mlp_tower_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_uint32,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
    ]
    ws = lib.mlp_tower_bwd_workspace
    ws.restype = ctypes.c_size_t
    ws.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn, ws


def _check_args(x: torch.Tensor, layers: Layers, activation: str,
                dropout: float = 0.0, seed: Seed = 0) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r} (tanh|relu|sigmoid)")
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"{len(layers)} layers; the kernel takes 1..{MAX_LAYERS}")
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"dropout {dropout} outside [0, 1)")
    if isinstance(seed, torch.Tensor):
        if seed.shape != () or seed.dtype != torch.int32 or seed.device != x.device:
            raise ValueError(f"a tensor seed is 0-d int32 on {x.device}; got "
                             f"{tuple(seed.shape)} {seed.dtype} on {seed.device}")
    elif not 0 <= int(seed) < SEED_LIMIT:
        raise ValueError(f"dropout seed {seed} outside [0, 2^24)")
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


def _seed_args(seed: Seed) -> tuple[int, int | None]:
    """The entry points' ``(seed, seed_ptr)`` of an int or a device seed."""
    if isinstance(seed, torch.Tensor):
        return 0, seed.data_ptr()
    return int(seed), None


def _tower_args(x: torch.Tensor, layers: Layers):
    n = len(layers)
    dims = (ctypes.c_int * (n + 1))(x.shape[1], *(w.shape[1] for w, _ in layers))
    weights = (ctypes.c_void_p * n)(*(w.data_ptr() for w, _ in layers))
    biases = (ctypes.c_void_p * n)(*(b.data_ptr() for _, b in layers))
    return n, dims, weights, biases


def mlp_tower_fwd(x: torch.Tensor, layers: Layers, activation: str = "tanh",
                  dropout: float = 0.0, seed: Seed = 0) -> torch.Tensor:
    """Fused tower forward: ``[B, in]`` -> ``[B]`` logits, no autograd.

    A CPU ``x`` takes :func:`mlp_tower_plain`. A CUDA ``x`` launches the
    kernel on the current stream, or raises.
    """
    global LAUNCHES, DROPOUT_LAUNCHES
    if not is_cuda(x, "mlp_tower_fwd"):
        return mlp_tower_plain(x, layers, activation, dropout, seed)
    _check_args(x, layers, activation, dropout, seed)
    batch = x.shape[0]
    out = torch.empty(batch, device=x.device, dtype=torch.float32)
    if batch == 0:
        return out
    n, dims, weights, biases = _tower_args(x, layers)
    threshold, scale = dropout_params(dropout)
    kernel, workspace_bytes = _fwd_kernel()
    workspace = torch.empty(workspace_bytes(n, dims), dtype=torch.uint8,
                            device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = kernel(
            x.data_ptr(), batch, n, dims, weights, biases,
            ACTIVATIONS[activation], int(dropout > 0.0), *_seed_args(seed),
            threshold, scale, 0, out.data_ptr(), workspace.data_ptr(),
            workspace.numel(), stream,
        )
    check(code, f"mlp_tower_fwd (widths {list(dims)}, dropout {dropout})")
    LAUNCHES += 1
    DROPOUT_LAUNCHES += dropout > 0.0
    return out


def mlp_tower_bwd(x: torch.Tensor, layers: Layers, g: torch.Tensor,
                  activation: str = "tanh", dropout: float = 0.0,
                  seed: Seed = 0):
    """Fused tower backward for upstream ``g`` ``[B]`` (the logit's
    gradient): ``(gx, [(gw, gb), ...])``.

    A CPU ``x`` takes :func:`mlp_tower_bwd_plain`. A CUDA ``x`` launches the
    kernels on the current stream, or raises. The kernels recompute the
    forward with the same dropout masks, and sum the weight gradients over
    the batch in a fixed order: two launches on the same inputs give the
    same bits.
    """
    global BWD_LAUNCHES
    if not is_cuda(x, "mlp_tower_bwd"):
        return mlp_tower_bwd_plain(x, layers, g, activation, dropout, seed)
    _check_args(x, layers, activation, dropout, seed)
    batch = x.shape[0]
    if g.shape != (batch,) or g.dtype != torch.float32 or g.device != x.device:
        raise ValueError(f"g must be f32 [{batch}] on {x.device}")
    g = g.contiguous()
    gx = torch.empty_like(x)
    grads = [(torch.empty_like(w), torch.empty_like(b)) for w, b in layers]
    n, dims, weights, biases = _tower_args(x, layers)
    kernel, workspace_bytes = _bwd_kernel()
    workspace = torch.empty(workspace_bytes(batch, n, dims), dtype=torch.uint8,
                            device=x.device)
    gws = (ctypes.c_void_p * n)(*(gw.data_ptr() for gw, _ in grads))
    gbs = (ctypes.c_void_p * n)(*(gb.data_ptr() for _, gb in grads))
    threshold, scale = dropout_params(dropout)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = kernel(
            x.data_ptr(), batch, n, dims, weights, biases, g.data_ptr(),
            ACTIVATIONS[activation], int(dropout > 0.0), *_seed_args(seed),
            threshold, scale, gx.data_ptr(), gws, gbs, workspace.data_ptr(),
            workspace.numel(), stream,
        )
    check(code, f"mlp_tower_bwd (widths {list(dims)}, dropout {dropout})")
    BWD_LAUNCHES += 1
    return gx, grads


class _Tower(torch.autograd.Function):
    """The counterpart of the reference's ``custom_vjp`` ``mlp_tower``: the
    forward saves ``x``, the layers and the seed (a device seed as a saved
    tensor, so the backward reads the same buffer), and the backward
    recomputes the forward inside :func:`mlp_tower_bwd`."""

    @staticmethod
    def forward(ctx, x, activation, dropout, seed, *flat):
        layers = list(zip(flat[0::2], flat[1::2]))
        device_seed = isinstance(seed, torch.Tensor)
        ctx.save_for_backward(x, *flat, *([seed] if device_seed else []))
        ctx.cfg = (activation, dropout, None if device_seed else seed, len(flat))
        return mlp_tower_fwd(x, layers, activation, dropout, seed)

    @staticmethod
    def backward(ctx, g):
        activation, dropout, seed, n = ctx.cfg
        x, *rest = ctx.saved_tensors
        flat = rest[:n]
        if seed is None:
            seed = rest[n]
        layers = list(zip(flat[0::2], flat[1::2]))
        gx, grads = mlp_tower_bwd(x, layers, g.contiguous(), activation,
                                  dropout, seed)
        return (gx, None, None, None, *(t for pair in grads for t in pair))


def mlp_tower(x: torch.Tensor, layers: Layers, activation: str = "tanh",
              dropout: float = 0.0, seed: Seed = 0) -> torch.Tensor:
    """Differentiable fused tower: ``[B, in]`` -> ``[B]`` logits, with
    gradients for ``x`` and every layer. ``dropout``/``seed`` switch on the
    in-kernel counter-hash dropout."""
    seed = seed if isinstance(seed, torch.Tensor) else int(seed)
    return _Tower.apply(x, activation, float(dropout), seed,
                        *(t for layer in layers for t in layer))
