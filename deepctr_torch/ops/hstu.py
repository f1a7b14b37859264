"""HSTU's block, relative bias and sampled softmax (Zhai et al., *Actions
Speak Louder than Words: Trillion-Parameter Sequential Transducers for
Generative Recommendations*, ICML 2024, arXiv:2402.17152; the authors' code
is github.com/facebookresearch/generative-recommenders) as autograd-visible
torch operations in float32 with TF32 off, on histories padded to ``N``.

One block, with ``X`` the ``[B, N, D]`` sequence::

    U, V, Q, K = split( SiLU( LayerNorm(X) · W_uvqk ) )        # no bias
    A[h]       = SiLU( Q[h]·K[h]^T + rab ) / N  ⊙  mask        # no softmax
    Y          = X + dropout( LayerNorm( concat_h A[h]·V[h] ) ⊙ U ) · W_o + b_o

``mask[i, j]`` is 1 where ``j <= i`` and ``j`` is a valid position of the
sequence (the source drops padded positions by its jagged layout; here they
are masked, so a padded position changes no valid output and takes no
gradient). The layer norms have no affine parameters (eps 1e-6). The
relative bias, one a block and shared by the heads::

    rab[b, i, j] = w_pos[N - 1 + j - i] + w_time[ bucket(t[b, i+1] - t[b, j]) ]
    bucket(Δ)    = clamp( floor( ln(max(|Δ|, 1)) / 0.301 ), 0, 128 )

with ``t[b, N] = t[b, N - 1]`` (the source's extension) and the padded
timestamps as the batch holds them (0, as the source pads). The query at
``i`` thus reads the time of the action after it.

The projections go through ``layers.linear`` (forward on cuBLAS in float32,
backward on ``kernels/dense.py``); the attention's products are
``torch.matmul`` with TF32 off. No gradient is summed by float atomics, so
that a graph replay gives an eager step's bits: the item table's gathers
(:func:`gather_rows`) take ``F.embedding``'s backward in its deterministic
form (its occurrences sorted, each row's summed in order), and the bias
tables, a few hundred entries each read millions of times a step, are
gathered through one stable sort of their indices a step
(:func:`bias_index`), their gradients summed along it in 61-bit fixed point
(exact in any order, as ``ops/scatter.py`` sums the sparse rows), where
``F.embedding``'s backward would serialise each entry's occurrences.

Dropout and the sampled negatives come from the counter hash of the tower
kernels (``kernels/mlp.py::counter_hash``) on the step's seed: dropout
stream ``l`` (0 the input, ``1 + b`` block ``b``) keeps element ``(row,
col)`` of a ``[B·N, width]`` activation where the hash is under the keep
threshold; negative ``k`` of supervised position ``(b, i)`` (row ``b·(N-1) +
i``) is item ``(hash · items) >> 32`` of stream :data:`NEGATIVE_STREAM`.

Tracing (``utils/prof.py``): each block marks ``hstu_proj`` after its
first projection, ``hstu_attn`` after the attention (scores, bias, SiLU,
mask, ``A·V``, its norm and ``⊙ U``) and ``hstu_proj`` after its output
projection; in the backward the attention's output marks ``backward`` as its
gradient arrives and its inputs (``U``, ``V``, ``Q``, ``K`` and the bias
tables) ``hstu_attn_bwd`` once theirs are all done, so the attention's
backward is a phase of its own. Counters (:func:`counts`): ``hstu.TOKENS``
(valid positions), ``hstu.PADDED`` (padded positions) and
``hstu.NEGATIVES`` (sampled ids) of the train steps, kept on the device, so
that a graph's replay adds its own.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..utils import prof
from .kernels.mlp import Seed, _keep_params, counter_hash
from .layers import f32_products, linear

TIME_BUCKETS = 128
BUCKET_DIVISOR = 0.301
NORM_EPS = 1e-6          # the layer norms' and the L2 norms' epsilon
ACCIDENTAL_HIT = -5e4    # a negative that is the positive itself (the source's)
NEGATIVE_STREAM = 1000   # the counter hash's stream of the negatives

# valid positions, padded positions and sampled ids since the last reset, an
# int64 [3] on each device the steps ran on
_COUNTS: dict[torch.device, torch.Tensor] = {}
COUNTER_NAMES = ("hstu.TOKENS", "hstu.PADDED", "hstu.NEGATIVES")


def count(valid: torch.Tensor, negatives: int) -> None:
    """Add a step's valid and padded positions (``valid`` ``[B, N]``, 0/1)
    and its ``negatives`` sampled ids to the device's counters (no sync;
    under a capture, every replay adds them)."""
    dev = valid.device
    if dev not in _COUNTS:
        _COUNTS[dev] = torch.zeros(3, dtype=torch.int64, device=dev)
    tokens = valid.sum().to(torch.int64)
    counts = _COUNTS[dev]
    counts[0].add_(tokens)
    counts[1].add_(valid.numel() - tokens)
    counts[2].add_(negatives)


def counts() -> dict[str, int]:
    """The counters, summed over the devices (a sync)."""
    total = [0, 0, 0]
    for t in _COUNTS.values():
        total = [a + int(b) for a, b in zip(total, t.tolist())]
    return dict(zip(COUNTER_NAMES, total))


def reset_counts() -> None:
    for t in _COUNTS.values():
        t.zero_()


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic kernels for the block (and no fill of new
    memory), put back after it."""
    from torch.utils import deterministic

    held = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(held[0], warn_only=held[1])
        deterministic.fill_uninitialized_memory = held[2]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        with _deterministic():
            return torch.ops.aten.embedding_dense_backward(
                g.contiguous(), ids, ctx.rows, -1, False), None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (``[*ids.shape, D]``), its gradient summed without
    float atomics."""
    return _GatherRows.apply(table, ids)


class SortedIndex(NamedTuple):
    """An index into a 1-D table of ``rows`` entries, with its stable sort:
    ``order`` (the flat index's positions, sorted by entry) and ``bounds``
    ``[rows + 1]`` (where each entry's run starts in that order)."""

    index: torch.Tensor
    order: torch.Tensor
    bounds: torch.Tensor


def sorted_index(index: torch.Tensor, rows: int) -> SortedIndex:
    values, order = torch.sort(index.reshape(-1), stable=True)
    bounds = torch.searchsorted(values, torch.arange(rows + 1, device=index.device))
    return SortedIndex(index, order, bounds)


def segment_sums(values: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """f32 sums of ``values`` (1-D) over ``[bounds[r], bounds[r+1])``, by one
    prefix sum in 61-bit fixed point (``ops/scatter.py``'s scale: the sum of
    every ``|value|`` below 2^61), exact whatever order the scan takes."""
    flat = values.double()
    _, exponent = torch.frexp(flat.abs().max() * flat.numel())
    scale = torch.ldexp(torch.ones_like(flat[0]), 61 - exponent)
    csum = torch.cumsum(torch.round(flat * scale).long(), 0)
    csum = torch.cat([csum.new_zeros(1), csum])
    return ((csum[bounds[1:]] - csum[bounds[:-1]]).double() / scale).float()


class _SortedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, index, order, bounds):
        ctx.save_for_backward(order, bounds)
        return table[index]

    @staticmethod
    def backward(ctx, g):
        order, bounds = ctx.saved_tensors
        return segment_sums(g.reshape(-1)[order], bounds), None, None, None


def sorted_gather(table: torch.Tensor, idx: SortedIndex) -> torch.Tensor:
    """``table[idx.index]`` for a 1-D table, its gradient summed along the
    index's sort."""
    return _SortedGather.apply(table, idx.index, idx.order, idx.bounds)


class BiasIndex(NamedTuple):
    """A step's indices into every block's bias tables: the time buckets
    ``[B, N, N]`` and the positions ``[N, N]``, each with its sort."""

    time: SortedIndex
    pos: SortedIndex


def bias_index(ts: torch.Tensor) -> BiasIndex:
    """The indices of a step's timestamps ``[B, N]``, sorted once for the
    blocks' backward."""
    n = ts.shape[1]
    return BiasIndex(sorted_index(time_buckets(ts), TIME_BUCKETS + 1),
                     sorted_index(position_index(n, ts.device), 2 * n - 1))


def time_buckets(ts: torch.Tensor) -> torch.Tensor:
    """int64 timestamps ``[B, N]`` -> the bucket of ``t[i+1] - t[j]``,
    int64 ``[B, N, N]`` (the source's ``log(|Δ|)/0.301`` in float32,
    truncated, clamped to ``[0, 128]``)."""
    ext = torch.cat([ts, ts[:, -1:]], 1)
    delta = ext[:, 1:, None] - ext[:, None, :-1]
    b = (torch.log(delta.abs().clamp(min=1).float()) / BUCKET_DIVISOR).long()
    return b.clamp(0, TIME_BUCKETS)


def position_index(n: int, device) -> torch.Tensor:
    """``[N, N]`` int64: ``N - 1 + j - i``, the place of ``w_pos`` at
    ``(i, j)``."""
    r = torch.arange(n, device=device)
    return (n - 1) + r[None, :] - r[:, None]


def attention_mask(valid: torch.Tensor) -> torch.Tensor:
    """``[B, 1, N, N]`` float: 1 where ``j <= i`` and ``j`` is valid."""
    n = valid.shape[1]
    causal = torch.ones(n, n, dtype=torch.bool, device=valid.device).tril()
    return (causal[None] & valid.bool()[:, None, :]).float()[:, None]


def dropout_mask(rows: int, cols: int, rate: float, seed: Seed, stream: int,
                 device) -> torch.Tensor:
    """f32 ``[rows, cols]``: ``1/keep`` where kept, 0 where dropped."""
    threshold, scale = _keep_params(1.0 - rate)
    h = counter_hash((rows, cols), seed, stream, device=device)
    return torch.where(h < threshold, scale, 0.0).to(torch.float32)


def negative_ids(rows: int, k: int, items: int, seed: Seed, device) -> torch.Tensor:
    """int64 ``[rows, k]`` ids uniform over ``[0, items)``."""
    h = counter_hash((rows, k), seed, NEGATIVE_STREAM, device=device)
    return (h * items) >> 32


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=NORM_EPS)


class _Mark(torch.autograd.Function):
    """Identity forward; the backward marks the phase ``name`` once the
    gradients of every output are in, then passes them on."""

    @staticmethod
    def forward(ctx, name, *xs):
        ctx.name = name
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        prof.phase(ctx.name)
        return (None, *gs)


def _mark(name: str, *xs):
    """``xs`` marked for the backward (themselves when tracing is off, so
    the step's graph is the same as without marks)."""
    return _Mark.apply(name, *xs) if prof.enabled() else xs


def relative_bias(idx: BiasIndex, w_pos: torch.Tensor, w_time: torch.Tensor) -> torch.Tensor:
    """``rab`` ``[B, N, N]`` from the step's :class:`BiasIndex` and the
    block's tables ``w_pos [2N-1]``, ``w_time [129]``."""
    return sorted_gather(w_pos, idx.pos)[None] + sorted_gather(w_time, idx.time)


def block(x: torch.Tensor, w_uvqk: torch.Tensor, w_o: torch.Tensor, b_o: torch.Tensor,
          w_pos: torch.Tensor, w_time: torch.Tensor, bias: BiasIndex,
          mask: torch.Tensor, heads: int, d_qk: int, d_v: int,
          dropout: float, seed: Seed | None, stream: int) -> torch.Tensor:
    """One HSTU block (the module's docstring): ``x`` ``[B, N, D]`` -> ``Y``.
    ``seed`` None: no dropout."""
    b, n, d = x.shape
    with f32_products():
        h = F.layer_norm(x, (d,), eps=NORM_EPS).reshape(b * n, d)
        uvqk = F.silu(linear(h, w_uvqk))
        prof.phase("hstu_proj")
        u, v, q, k = torch.split(uvqk, [heads * d_v, heads * d_v, heads * d_qk,
                                        heads * d_qk], dim=1)
        u, v, q, k, w_pos, w_time = _mark("hstu_attn_bwd", u, v, q, k, w_pos, w_time)
        q = q.reshape(b, n, heads, d_qk).transpose(1, 2)
        k = k.reshape(b, n, heads, d_qk).transpose(1, 2)
        v = v.reshape(b, n, heads, d_v).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(2, 3))
        scores = scores + relative_bias(bias, w_pos, w_time)[:, None]
        a = F.silu(scores) / n * mask
        o = torch.matmul(a, v).transpose(1, 2).reshape(b * n, heads * d_v)
        o = F.layer_norm(o, (heads * d_v,), eps=NORM_EPS) * u
        (o,) = _mark("backward", o)
        prof.phase("hstu_attn")
        if seed is not None and dropout > 0.0:
            o = o * dropout_mask(b * n, heads * d_v, dropout, seed, stream, o.device)
        y = linear(o, w_o, b_o).view(b, n, d) + x
    prof.phase("hstu_proj")
    return y


def sampled_softmax(out: torch.Tensor, table: torch.Tensor, next_ids: torch.Tensor,
                    weights: torch.Tensor, items: int, negatives: int,
                    temperature: float, seed: Seed) -> torch.Tensor:
    """The source's sampled softmax over the positions ``i < N - 1``:
    ``out`` ``[B, N-1, D]`` the blocks' outputs there, ``next_ids`` ``[B,
    N-1]`` the item at ``i + 1``, ``weights`` ``[B, N-1]`` (0 where ``i + 1``
    is padded). Each output and each item embedding (the table's row, not
    scaled) is L2-normalised; position ``i``'s loss is the cross-entropy of
    ``next_ids[i]`` among itself and ``negatives`` ids drawn from ``seed``
    (a draw equal to the positive scores ``-5e4``), over cosines divided by
    ``temperature``; the loss is their weighted mean (over at least 1)."""
    b, m, d = out.shape
    with f32_products():
        y = l2_normalize(out)
        tn = l2_normalize(table)
        pos = (y * gather_rows(tn, next_ids)).sum(-1) / temperature
        neg_ids = negative_ids(b * m, negatives, items, seed, out.device).view(b, m, -1)
        neg = gather_rows(tn, neg_ids)                                    # [B, N-1, k, D]
        neg_logits = torch.matmul(neg, y[..., None])[..., 0] / temperature
        neg_logits = torch.where(neg_ids == next_ids[..., None], ACCIDENTAL_HIT,
                                 neg_logits)
        lse = torch.logsumexp(torch.cat([pos[..., None], neg_logits], -1), -1)
        loss = ((lse - pos) * weights).sum() / torch.clamp(weights.sum(), min=1.0)
    return loss


def input_embeddings(table: torch.Tensor, pos_emb: torch.Tensor, items: torch.Tensor,
                     valid: torch.Tensor, dropout: float, seed: Seed | None) -> torch.Tensor:
    """``e(item)·√D + p(position)``, dropout (stream 0), zero at padded
    positions: ``[B, N, D]``."""
    b, n = items.shape
    d = table.shape[1]
    x = gather_rows(table, items) * math.sqrt(d) + pos_emb[None, :n]
    if seed is not None and dropout > 0.0:
        x = x * dropout_mask(b * n, d, dropout, seed, 0, x.device).view(b, n, d)
    return x * valid[..., None]
