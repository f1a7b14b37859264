"""HSTU, the Hierarchical Sequential Transduction Unit of generative
recommenders (Zhai et al., ICML 2024, arXiv:2402.17152; the authors' code is
github.com/facebookresearch/generative-recommenders), trained by sampled
softmax on users' histories of items.

It has no counterpart in the JAX package, and it does not keep the other
models' contract (``model.apply_rows(rows, mask) -> logits``): its step is
its own loss (:meth:`HSTUModel.train_loss`), which ``train/step.py`` takes
in place of the gather, the binary cross-entropy and the sparse update.

A batch is int64 ``ids [B, 2, N]``: row 0 the items of each history, oldest
first, padded with the pad id (the table's last row) after its length; row
1 their timestamps in seconds, 0 where padded. The model:

- the input ``e(item)·√D + p(position)``, dropout, zero at padded positions
  (``ops/hstu.py::input_embeddings``);
- ``blocks`` HSTU blocks (``ops/hstu.py::block``): pointwise attention with
  ``heads`` heads of ``d_qk`` / ``d_v``, each block with its own relative
  position and time bias;
- each output L2-normalised, and at each position ``i`` whose next item is
  valid, the sampled softmax of that item against ``negatives`` ids drawn
  from the step's seed, over cosines divided by ``temperature``
  (``ops/hstu.py::sampled_softmax``), the weighted mean over positions.

The table ``[items + 1, D]`` is a dense parameter, trained by the dense
optimizer as the source trains it (nearly every row is touched each step:
``dense_table``). Parameters, in ``named_parameters`` order: ``table``,
``pos_emb [N, D]``, then each block's ``uvqk [D, 2·H·(d_v + d_qk)]`` (U, V,
Q, K side by side), ``w_o [H·d_v, D]``, ``b_o [D]``, ``w_pos [2N - 1]`` and
``w_time [129]``.

Tracing: the step marks ``lookup`` after the input embeddings and the
bias tables' sorted indices (``ops/hstu.py::bias_index``), each block
its ``hstu_proj`` / ``hstu_attn`` phases (and ``backward`` /
``hstu_attn_bwd`` in the backward), ``loss`` after the sampled softmax;
the train step ``backward`` and ``dense`` after it: :attr:`phases_a_step`
marks a step.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..data import Schema
from ..ops import hstu as ops
from ..utils import prof


def _trunc_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """Normal with ``std``, truncated to two standard deviations, by the
    inverse of its distribution function."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = lo + (1.0 - 2.0 * lo) * torch.rand(shape, generator=generator,
                                          device=generator.device)
    return torch.erfinv(2.0 * u - 1.0) * (math.sqrt(2.0) * std)


class HSTUBlock(nn.Module):
    def __init__(self, dim: int, max_len: int, heads: int, d_qk: int, d_v: int, *,
                 device):
        super().__init__()
        self.uvqk = nn.Parameter(torch.zeros(dim, 2 * heads * (d_v + d_qk), device=device))
        self.w_o = nn.Parameter(torch.zeros(heads * d_v, dim, device=device))
        self.b_o = nn.Parameter(torch.zeros(dim, device=device))
        self.w_pos = nn.Parameter(torch.zeros(2 * max_len - 1, device=device))
        self.w_time = nn.Parameter(torch.zeros(ops.TIME_BUCKETS + 1, device=device))


class HSTUModel(nn.Module):
    """Construct via :func:`make_hstu`."""

    name = "hstu"
    dense_table = True
    backward_phase = "backward"

    def __init__(self, items: int, max_len: int, dim: int, blocks: int, heads: int,
                 d_qk: int, d_v: int, dropout: float, negatives: int, temperature: float,
                 *, device: torch.device | str):
        super().__init__()
        self.items, self.max_len, self.dim = items, max_len, dim
        self.heads, self.d_qk, self.d_v = heads, d_qk, d_v
        self.dropout, self.negatives, self.temperature = dropout, negatives, temperature
        self.table = nn.Parameter(torch.zeros(items + 1, dim, device=device))
        self.pos_emb = nn.Parameter(torch.zeros(max_len, dim, device=device))
        self.blocks = nn.ModuleList(HSTUBlock(dim, max_len, heads, d_qk, d_v, device=device)
                                    for _ in range(blocks))

    @property
    def pad_id(self) -> int:
        return self.items

    @property
    def phases_a_step(self) -> int:
        """Phase marks of one train step: ``lookup``, three a block forward,
        ``loss``, two a block backward, ``backward`` and ``dense``."""
        return 5 * len(self.blocks) + 4

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator, pad_id: int) -> None:
        """In place, as the source's modules initialise themselves (recalled):
        the table truncated-normal with std 0.02 (its pad row zero), the
        positions with std ``sqrt(1/D)``; ``uvqk`` normal with std 0.02,
        ``w_o`` Glorot-uniform and ``b_o`` uniform within ``1/sqrt(H·d_v)``
        (``nn.Linear``'s), both bias tables normal with std 0.02."""
        self.table.copy_(_trunc_normal(self.table.shape, 0.02, generator))
        self.table[pad_id] = 0.0
        self.pos_emb.copy_(_trunc_normal(self.pos_emb.shape, math.sqrt(1.0 / self.dim),
                                         generator))
        dev = generator.device
        for blk in self.blocks:
            blk.uvqk.copy_(0.02 * torch.randn(blk.uvqk.shape, generator=generator,
                                              device=dev))
            fan_in, fan_out = blk.w_o.shape
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            blk.w_o.copy_(torch.rand(blk.w_o.shape, generator=generator, device=dev)
                          * (2 * limit) - limit)
            bound = 1.0 / math.sqrt(fan_in)
            blk.b_o.copy_(torch.rand(blk.b_o.shape, generator=generator, device=dev)
                          * (2 * bound) - bound)
            for p in (blk.w_pos, blk.w_time):
                p.copy_(0.02 * torch.randn(p.shape, generator=generator, device=dev))

    def encode(self, ids: torch.Tensor, seed: ops.Seed | None = None) -> torch.Tensor:
        """``ids [B, 2, N]`` -> the blocks' outputs ``[B, N, D]`` (before the
        L2 norm); ``seed`` draws the dropout masks (None: no dropout)."""
        items, ts = ids[:, 0], ids[:, 1]
        valid = (items != self.pad_id).float()
        x = ops.input_embeddings(self.table, self.pos_emb, items, valid, self.dropout, seed)
        bias = ops.bias_index(ts)
        mask = ops.attention_mask(valid)
        prof.phase("lookup")
        for i, blk in enumerate(self.blocks):
            x = ops.block(x, blk.uvqk, blk.w_o, blk.b_o, blk.w_pos, blk.w_time, bias, mask,
                          self.heads, self.d_qk, self.d_v, self.dropout, seed, 1 + i)
        return x

    def train_loss(self, ids: torch.Tensor, weights: torch.Tensor,
                   seed: ops.Seed) -> torch.Tensor:
        """One train step's loss: ``ids [B, 2, N]``, ``weights [B]`` (a
        sequence's weight; 0 in a pad step), dropout and negatives from
        ``seed``. Counts the step's positions and negatives
        (``ops/hstu.py::count``)."""
        out = self.encode(ids, seed)
        items = ids[:, 0]
        valid = (items != self.pad_id).float()
        next_ids = items[:, 1:]
        w = valid[:, 1:] * weights[:, None]
        loss = ops.sampled_softmax(out[:, :-1], self.table, next_ids, w, self.items,
                                   self.negatives, self.temperature, seed)
        ops.count(valid, next_ids.numel() * self.negatives)
        prof.phase("loss")
        return loss

    def scores(self, ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Cosines ``[B, items]`` of each sequence's normalised output at
        ``positions [B]`` against every item's normalised embedding, no
        dropout (retrieval over the whole catalogue)."""
        with torch.no_grad():
            out = self.encode(ids)
            y = ops.l2_normalize(out[torch.arange(ids.shape[0], device=ids.device),
                                     positions])
            with ops.f32_products():
                return y @ ops.l2_normalize(self.table[:self.items]).t()


def make_hstu(schema: Schema, k: int = 256, blocks: int = 8, heads: int = 4,
              d_qk: int = 64, d_v: int = 64, dropout: float = 0.2, negatives: int = 128,
              temperature: float = 0.05, *, device: torch.device | str) -> HSTUModel:
    """HSTU over ``schema``'s one field (its vocabulary the items, its slots
    the history's length ``N``), at the source's ML-20M large widths by
    default: item embeddings of ``k``, ``blocks`` blocks of ``heads`` heads
    of ``d_qk`` / ``d_v``, dropout, ``negatives`` sampled a position at
    ``temperature``."""
    if schema.num_fields != 1:
        raise ValueError(f"hstu reads one field of item ids, not {schema.num_fields}")
    f = schema.fields[0]
    return HSTUModel(items=f.vocab_size, max_len=f.max_len, dim=k, blocks=blocks,
                     heads=heads, d_qk=d_qk, d_v=d_v, dropout=dropout,
                     negatives=negatives, temperature=temperature, device=device)
