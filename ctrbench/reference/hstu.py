"""HSTU (Zhai et al., *Actions Speak Louder than Words: Trillion-Parameter
Sequential Transducers for Generative Recommendations*, ICML 2024,
arXiv:2402.17152; the authors' code is github.com/facebookresearch/
generative-recommenders) as the configuration states it, in plain float32
PyTorch with TF32 off, over padded histories ``ids [B, 2, N]`` (items, the
pad id ``items`` after each length; timestamps, 0 there):

- the input ``table[item]·√D + pos_emb[position]``, the dropout, zero at
  padded positions;
- each block: ``U, V, Q, K = split(SiLU(LayerNorm(X)·W_uvqk))`` (layer
  norms without affine parameters, eps 1e-6; no bias); the scores ``Q·K^T +
  rab`` per head by einsum; ``A = SiLU(scores)/N`` times the causal mask of
  the valid positions; ``Y = X + dropout(U ∘ LayerNorm(A·V))·W_o + b_o``;
  ``rab[i, j] = w_pos[N-1+j-i] + w_time[clamp(floor(ln(max(|t[i+1] -
  t[j]|, 1))/0.301), 0, 128)]``, indexed directly, with ``t[N] = t[N-1]``;
- each output L2-normalised, and at each position ``i < N - 1`` whose next
  item is valid the cross-entropy of that item's row (L2-normalised) among
  it and the configuration's negatives (rows gathered, then each
  normalised), cosines over the temperature, a negative equal to the
  positive at ``-5e4``; the loss the mean over those positions, each
  sequence's weight applied;
- autograd's gradients and optax's Adam on every leaf, the table included
  (``xdeepfm.Adam``), with the configuration's betas.

It works in blocks of :data:`BLOCK` sequences, each block's loss over the
whole batch's weight, the gradients summed, so that the full width fits.

What it keeps of the program, frozen as data: the counter hash that draws
the dropout masks (stream 0 the input, ``1 + b`` block ``b``; rows the
batch's positions ``b·N + i``) and the negatives (stream 1000; rows the
supervised positions ``b·(N-1) + i``; item ``(hash·items) >> 32``). The
departures from the source are the configuration's ``departures``.

A step given as None is a weight-0 pad step: its gradients are 0 and Adam
still steps (its count grows, its moments decay, the leaves move).

``precision="tf32"`` rounds every operand of the projections', the
attention's and the negatives' products, forward and backward, to TF32:
the control, one step of precision below the configuration's. ``fault``
plants one fault in the reference put in the program's place:
``unchanged`` (the step returns its state unchanged), ``half_batch`` (the
batch's second half at weight 0), ``no_bias`` (no relative bias),
``softmax`` (a softmax over the valid keys at or before ``i`` in place of
SiLU/N) and ``no_causal`` (every valid key, later ones too).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .fnn import _mul_u32, f32_products, tf32_round
from .xdeepfm import Adam

BLOCK = 32   # sequences a block
EPS = 1e-6
FAULTS = ("unchanged", "half_batch", "no_bias", "softmax", "no_causal")
_U32 = 0xFFFFFFFF


def leaf_names(config: dict) -> list[str]:
    names = ["table", "pos_emb"]
    for b in range(int(config["num_blocks"])):
        names += [f"blocks.{b}.{k}" for k in ("uvqk", "w_o", "b_o", "w_pos", "w_time")]
    return names


def counter_hash(rows: int, cols: int, seed: int, stream: int, row0: int, device):
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None] + row0
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    h = (_mul_u32(r, 0x9E3779B9) + _mul_u32(c, 0x85EBCA6B)
         + _mul_u32(torch.tensor(seed & _U32, device=device), 0xC2B2AE35)
         + ((stream + 1) * 0x27D4EB2F & _U32)) & _U32
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul_u32(h, 0x846CA68B)
    return h ^ (h >> 16)


def dropout_mask(rows, cols, rate, seed, stream, row0, device) -> torch.Tensor:
    keep = 1.0 - rate
    scale = float(torch.tensor(1.0, dtype=torch.float32) / torch.tensor(keep, dtype=torch.float32))
    h = counter_hash(rows, cols, seed, stream, row0, device)
    return torch.where(h < int(keep * 0xFFFFFFFF), scale, 0.0).to(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ tf32_round(b).transpose(-1, -2), tf32_round(a).transpose(-1, -2) @ g


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` (batched alike) in float32, or with TF32 operands."""
    if precision == "f32":
        return a @ b
    if precision == "tf32":
        return _Tf32Matmul.apply(a, b)
    raise ValueError(f"precision {precision!r} (f32|tf32)")


def _bucket(delta: torch.Tensor) -> torch.Tensor:
    return (torch.log(delta.abs().clamp(min=1).float()) / 0.301).long().clamp(0, 128)


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=EPS)


def _block(x, ts, valid, w, config, seed, index, row0, precision, fault):
    bs, n, d = x.shape
    h, dqk, dv = int(config["num_heads"]), int(config["dqk"]), int(config["dv"])
    uvqk = F.silu(mm(F.layer_norm(x, [d], eps=EPS).reshape(bs * n, d), w["uvqk"],
                     precision)).view(bs, n, -1)
    u, v, q, k = torch.split(uvqk, [h * dv, h * dv, h * dqk, h * dqk], -1)
    q = q.reshape(bs, n, h, dqk).transpose(1, 2)
    k = k.reshape(bs, n, h, dqk).transpose(1, 2)
    v = v.reshape(bs, n, h, dv).transpose(1, 2)
    scores = mm(q, k.transpose(-1, -2), precision)                     # [bs, h, n, n]
    if fault != "no_bias":
        i = torch.arange(n, device=x.device)[:, None]
        j = torch.arange(n, device=x.device)[None, :]
        ext = torch.cat([ts, ts[:, n - 1:n]], 1)
        rab = w["w_pos"][n - 1 + j - i][None] \
            + w["w_time"][_bucket(ext[:, 1:, None] - ext[:, None, :-1])]
        scores = scores + rab[:, None]
    keys = valid[:, None, :].expand(bs, n, n)
    if fault != "no_causal":
        keys = keys * torch.ones(n, n, device=x.device).tril()
    keys = keys[:, None]
    if fault == "softmax":
        a = torch.softmax(scores.masked_fill(keys == 0, float("-inf")), -1)
    else:
        a = F.silu(scores) / n * keys
    attn = mm(a, v, precision).transpose(1, 2).reshape(bs, n, h * dv)
    o = u * F.layer_norm(attn, [h * dv], eps=EPS)
    rate = float(config["linear_dropout_rate"])
    if rate > 0:
        o = o * dropout_mask(bs * n, h * dv, rate, seed, 1 + index, row0 * n,
                             x.device).view(bs, n, -1)
    return mm(o.reshape(bs * n, -1), w["w_o"], precision).view(bs, n, d) + w["b_o"] + x


def block_loss(config: dict, leaves: dict, ids, weights, total_weight, seed: int, row0: int,
               precision: str = "f32", fault: str | None = None) -> torch.Tensor:
    """A block of sequences' share of the step's loss: its positions' weighted
    losses over ``total_weight`` (the whole batch's); ``row0`` its first
    sequence in the batch (the hash's rows)."""
    items, ts = ids[:, 0], ids[:, 1]
    bs, n = items.shape
    d = int(config["item_embedding_dim"])
    pad = int(config["items"])
    valid = (items != pad).float()
    x = leaves["table"][items] * (d ** 0.5) + leaves["pos_emb"][:n][None]
    rate = float(config["dropout_rate"])
    if rate > 0:
        x = x * dropout_mask(bs * n, d, rate, seed, 0, row0 * n, x.device).view(bs, n, d)
    x = x * valid[..., None]
    for b in range(int(config["num_blocks"])):
        w = {k: leaves[f"blocks.{b}.{k}"] for k in ("uvqk", "w_o", "b_o", "w_pos", "w_time")}
        x = _block(x, ts, valid, w, config, seed, b, row0, precision, fault)
    nxt = items[:, 1:]
    wts = (nxt != pad).float() * weights[:, None]
    temp = float(config["temperature"])
    y = _l2(x[:, :-1])
    pos = (y * _l2(leaves["table"][nxt])).sum(-1) / temp
    m, kneg = n - 1, int(config["num_negatives"])
    neg_ids = ((counter_hash(bs * m, kneg, seed, 1000, row0 * m, x.device) * pad) >> 32)
    neg_ids = neg_ids.view(bs, m, kneg)
    neg_rows = _l2(leaves["table"][neg_ids])                          # [bs, m, k, d]
    neg = mm(neg_rows.reshape(bs * m, kneg, d), y.reshape(bs * m, d, 1),
             precision).view(bs, m, kneg) / temp
    neg = torch.where(neg_ids == nxt[..., None], -5e4, neg)
    per = -F.log_softmax(torch.cat([pos[..., None], neg], -1), -1)[..., 0]
    return (per * wts).sum() / torch.clamp(total_weight, min=1.0)


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def loss_and_grads(config: dict, params: list, ids, weights, seed: int,
                   precision: str = "f32", fault: str | None = None, block: int = BLOCK):
    """The step's loss and every leaf's gradient, block by block."""
    names = leaf_names(config)
    leaves = dict(zip(names, params))
    pad = int(config["items"])
    if fault == "half_batch":
        weights = weights.clone()
        weights[weights.shape[0] // 2:] = 0.0
    total = ((ids[:, 0, 1:] != pad).float() * weights[:, None]).sum()
    loss, grads = 0.0, [torch.zeros_like(p) for p in params]
    for s in range(0, ids.shape[0], block):
        part = block_loss(config, leaves, ids[s:s + block], weights[s:s + block], total,
                          seed, s, precision, fault)
        for g, dg in zip(grads, torch.autograd.grad(part, params, allow_unused=True)):
            if dg is not None:
                g += dg
        loss += float(part.detach())
    return loss, grads


def train_reading(config: dict, leaves0: list, steps, precision: str = "f32",
                  fault: str | None = None) -> dict:
    """The reference's steps from the leaves ``leaves0`` (unchanged; it works
    on copies) on ``steps``, each ``(ids [B, 2, N], weights [B], seed)`` or
    None (a pad step): ``{"losses"`` (the live steps'), ``"grad_norms"`` (the
    first live step's), ``"change_norms"}``."""
    names = leaf_names(config)
    with f32_products():
        params = [p.clone().requires_grad_(True) for p in leaves0]
        adam = Adam(params, config["optimizer"])
        losses, grad_norms = [], None
        for batch in steps:
            if batch is None:
                if fault != "unchanged":
                    adam.step([torch.zeros_like(p) for p in params])
                continue
            ids, weights, seed = batch
            loss, grads = loss_and_grads(config, params, ids, weights, seed, precision, fault)
            losses.append(loss)
            if grad_norms is None:
                grad_norms = dict(zip(names, [_norm(g) for g in grads]))
            if fault != "unchanged":
                adam.step(grads)
        if fault == "unchanged":   # what the program's state would show
            grad_norms = {k: 0.0 for k in grad_norms}
        change = [_norm(p - p0) for p, p0 in zip(params, leaves0)]
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": dict(zip(names, change))}
