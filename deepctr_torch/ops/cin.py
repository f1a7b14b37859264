"""xDeepFM's Compressed Interaction Network (CIN; Lian et al., KDD 2018,
arXiv:1803.05170, Eq. 6) as one autograd Function over all its layers.

With ``X^0`` the fields' embeddings ``[m, D]`` of an example and ``X^k``
``[H_k, D]``::

    X^k[h, :] = Σ_{i<H_{k-1}} Σ_{j<m} W^k[h, i, j] · (X^{k-1}[i, :] ∘ X^0[j, :])
    p^k[h]    = Σ_d X^k[h, d]

with direct connections (every feature map goes both to the next layer and
to the sum pooling), no bias and no activation. Seen as a matrix product,
layer k has ``M = B·D`` rows (one an example and embedding dimension), a
depth ``K = H_{k-1}·m`` and ``N = H_k`` columns; its left operand, the
outer product ``Z^k[(b, d), (i, j)] = X^{k-1}[b, i, d] · X^0[b, j, d]``,
exists nowhere in the data.

Layout: the Function takes ``X^0`` as ``[B, D, m]`` (rows ``(b, d)``, the
fields contiguous) and keeps each ``X^k`` as ``[B·D, H_k]``, so that every
operand of a product is a plain row-major matrix. ``W^k`` is ``[H_{k-1}·m,
H_k]``, the port's ``[in, out]``, row ``i·m + j``. Its output is the pooled
``[p^1, ..., p^T]`` ``[B, Σ H_k]``.

The Function saves ``X^0``, the ``W^k`` and ``X^1 .. X^{T-1}``, never a
``Z^k``. It chooses its route by device (the kernel's wrapper takes CUDA
tensors only):

- On the card, each layer's three products run on the CIN kernel
  (``kernels/cin.py``, ``csrc/cin.cu``, 3xTF32 on the tensor cores), which
  forms ``Z^k`` and its gradient in registers: the forward ``Z^k·W^k``, the
  weight gradient ``Z^T·G`` and the operand gradient ``G·W^T`` reduced in
  its epilogue against the factors. Nothing else falls back.
- On the CPU, the plain version: the forward builds ``Z^k`` in memory and
  multiplies it by ``W^k``; the backward recomputes each ``Z^k`` for the
  weight gradient ``Z^T·G`` (``kernels/dense.py::weight_grad``), then forms
  the operand's gradient ``G·W^T`` (``input_grad``) and reduces it against
  the other factor: over the fields ``j`` against ``X^0`` for
  ``X^{k-1}``'s gradient, over the maps ``i`` against ``X^{k-1}`` for
  ``X^0``'s, by batched products, one matrix a row. Every product in
  float32 with TF32 off (``layers.f32_products``).

Tracing (``utils/prof.py``): the backward marks ``backward`` as it starts
(the backward of what came after the CIN in the forward) and ``cin_bwd`` as
it ends, so the CIN's backward is a phase of its own. Two counters, added
at every replay of a captured graph as the kernels' launches are
(``ops/kernels/__init__.py``): ``OUTER_BYTES``, the bytes of ``Z^k`` and of
its gradient the plain version writes to memory (``4·B·D·H_{k-1}·m`` for
each ``Z^k`` of the forward, and twice that in the backward: ``Z^k`` again
and its gradient; :func:`outer_bytes`), 0 on the card; and ``PRODUCTS``,
the CIN's matrix products (one a layer forward, two backward) on either
route. The kernel counts its launches in ``kernels/cin.py``'s
``LAUNCHES``.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import torch

from ..utils import prof
from .kernels import cin as cin_k
from .kernels import dense
from .kernels._build import is_cuda
from .layers import f32_products

# bytes of outer-product operand (and of its gradient) written, and matrix
# products run, by the CIN since the last reset (a replay's included)
OUTER_BYTES = 0
PRODUCTS = 0


def outer_bytes(batch: int, dim: int, num_fields: int, maps: Sequence[int]) -> int:
    """``OUTER_BYTES`` of one train step (forward and backward): three
    float32 ``[B·D, H_{k-1}·m]`` operands a layer, ``H_0 = m``."""
    widths = [num_fields] + list(maps[:-1])
    return 3 * 4 * batch * dim * num_fields * sum(widths)


def _count(outer: int, products: int) -> None:
    global OUTER_BYTES, PRODUCTS
    OUTER_BYTES += outer
    PRODUCTS += products


def outer(x: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """``Z [R, H·m]`` of ``x [R, H]`` and ``x0 [R, m]``: ``Z[r, i·m + j] =
    x[r, i]·x0[r, j]``."""
    return (x[:, :, None] * x0[:, None, :]).reshape(x.shape[0], -1)


def layer_grads(x: torch.Tensor, x0: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """One layer's backward, ``X^k = outer(X^{k-1}, X^0) @ W^k``: from
    ``x`` = ``X^{k-1}`` ``[R, H]``, ``x0`` ``[R, m]``, ``w`` ``[H·m, H_k]`` and
    ``g`` = the gradient of ``X^k`` ``[R, H_k]`` (contiguous), ``(g_x [R, H],
    g_x0 [R, m], g_w)``; ``g_x0`` is what passes through the ``X^0`` factor
    alone (for the first layer, where ``x`` is ``X^0``, add ``g_x`` to it).
    Products in the precision the backend flags give."""
    m = x0.shape[1]
    z = outer(x, x0)
    g_w = dense.weight_grad(z, g)
    del z
    gz = dense.input_grad(g, w).view(x.shape[0], x.shape[1], m)
    _count(8 * gz.numel(), 2)
    g_x = torch.bmm(gz, x0[:, :, None])[:, :, 0]
    g_x0 = torch.bmm(x[:, None, :], gz)[:, 0, :]
    return g_x, g_x0, g_w


class _Cin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, *weights):
        b, d, m = x0.shape
        r0 = x0.reshape(b * d, m)
        xs, pooled = [r0], []
        card = is_cuda(x0, "cin")
        with f32_products():
            for w in weights:
                if card:
                    xs.append(cin_k.forward(xs[-1], r0, w))
                    _count(0, 1)
                else:
                    z = outer(xs[-1], r0)
                    _count(4 * z.numel(), 1)
                    xs.append(z @ w)
                    del z
                pooled.append(xs[-1].view(b, d, -1).sum(1))
        ctx.save_for_backward(x0, *weights, *xs[1:-1])
        ctx.layers = len(weights)
        return torch.cat(pooled, 1)

    @staticmethod
    def backward(ctx, gp):
        prof.phase("backward")
        x0, *saved = ctx.saved_tensors
        weights, xs = saved[:ctx.layers], saved[ctx.layers:]
        b, d, m = x0.shape
        r0 = x0.reshape(b * d, m)
        xs = [r0] + list(xs)
        ends = list(itertools.accumulate(w.shape[1] for w in weights))
        g_x0 = torch.zeros_like(r0)
        g_w: list[torch.Tensor | None] = [None] * len(weights)
        g_x = None
        card = is_cuda(r0, "cin")
        with f32_products():
            for k in reversed(range(len(weights))):
                h = weights[k].shape[1]
                g = gp[:, ends[k] - h:ends[k]][:, None, :].expand(b, d, h)
                g = (g if g_x is None else g + g_x.view(b, d, h)).reshape(b * d, h)
                if card:
                    g_x, g_w[k] = cin_k.layer_grads(xs[k], r0, weights[k], g, g_x0)
                    _count(0, 2)
                else:
                    g_x, part, g_w[k] = layer_grads(xs[k], r0, weights[k], g)
                    g_x0 += part
            g_x0 += g_x   # the first layer's X^{k-1} is X^0 itself
        prof.phase("cin_bwd")
        return (g_x0.view(b, d, m), *g_w)


def cin(x0: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """The CIN over ``x0`` ``[B, D, m]`` (contiguous) with layers ``weights``
    (``[H_{k-1}·m, H_k]`` each): the pooled maps ``[B, Σ H_k]``,
    differentiable in ``x0`` and every weight."""
    return _Cin.apply(x0, *weights)
