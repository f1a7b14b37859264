"""Wide float32 layers: the dense layers of DLRM-DCNv2 (``models/dlrm.py``).

The tower kernels (``ops/kernels/mlp.py``) hold a block's activations in
shared memory and end in one logit a row, so they take neither a 1024-wide
layer at 32 rows (264 KB against the 227 KB a block can have) nor DLRM's
3456-wide cross input, nor a bottom MLP that ends in 128 outputs. These
layers run on cuBLAS instead, in full float32: each product is an autograd
Function that turns TF32 off for its forward and its backward
(:func:`f32_products`), whatever the process's setting, so the layers
compute in the precision the model states. On the CPU the same code runs on
PyTorch's CPU kernels.

The backward's two products on the card go to ``kernels/dense.py``: a
hand-written 3xTF32 kernel for the shapes it takes (M and N multiples of
128, K of 32; at DLRM's widths 24 of a step's 27 products), cuBLAS in
float32 for the rest. The forward stays on cuBLAS in float32.

- :func:`linear`: ``x @ w + b``, with ``w`` ``[in, out]`` as the port's
  layers keep it, and an optional fused ReLU.
- :func:`mlp`: a stack of them, ReLU on every layer or on all but the last.
- :func:`low_rank_cross`: one DCN-V2 cross layer of rank ``r``,
  ``x0 * (W (V x) + b) + x``, with ``V`` ``[in, r]`` and ``W`` ``[r, in]``.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch

from .kernels import dense


@contextlib.contextmanager
def f32_products():
    """TF32 off for cuBLAS and cuDNN inside the block, put back after it."""
    held = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = held


class _Linear(torch.autograd.Function):
    """``y = x @ w (+ b)``, ReLU'd where asked; every product in float32."""

    @staticmethod
    def forward(ctx, x, w, b, relu: bool):
        with f32_products():
            y = x @ w if b is None else torch.addmm(b, x, w)
        if relu:
            y = torch.relu_(y)
        ctx.relu, ctx.has_bias = relu, b is not None
        ctx.save_for_backward(x, w, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        if ctx.relu:
            g = g * (y > 0).to(g.dtype)
        with f32_products():
            gx = dense.input_grad(g, w) if ctx.needs_input_grad[0] else None
            gw = dense.weight_grad(x, g) if ctx.needs_input_grad[1] else None
        gb = g.sum(0) if ctx.has_bias and ctx.needs_input_grad[2] else None
        return gx, gw, gb, None


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           relu: bool = False) -> torch.Tensor:
    """``[B, in] @ [in, out] (+ [out])``, then ReLU when ``relu``."""
    return _Linear.apply(x, w, b, relu)


def mlp(x: torch.Tensor, layers: Sequence[tuple[torch.Tensor, torch.Tensor]],
        relu_last: bool) -> torch.Tensor:
    """``layers`` of ``(w, b)`` in turn, ReLU after each hidden layer and,
    with ``relu_last``, after the last too."""
    for i, (w, b) in enumerate(layers):
        x = linear(x, w, b, relu=relu_last or i < len(layers) - 1)
    return x


def low_rank_cross(x0: torch.Tensor, x: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """One DCN-V2 cross layer: ``x0 * (linear(x @ v, w) + b) + x``."""
    return x0 * linear(linear(x, v), w, b) + x
