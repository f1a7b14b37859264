"""HSTU (arXiv:2402.17152; github.com/facebookresearch/generative-recommenders)
written plainly from the source's equations, to hold the port's
``models/hstu.py`` and ``ops/hstu.py`` to: float32 PyTorch with TF32 off,
einsums over padded histories, the bias tables indexed directly, the
sampled softmax on gathered rows normalised one by one, autograd's
gradients and optax's Adam. It imports nothing of the port.

A batch is int64 ``ids [B, 2, N]`` (items, pad id ``items`` after each
length; timestamps, 0 there) and ``weights [B]``. Parameters are a dict by
the port's names (``table``, ``pos_emb``, ``blocks.<b>.uvqk``, ``.w_o``,
``.b_o``, ``.w_pos``, ``.w_time``).

Departures from the source, each the port's too: padded positions are
masked out of the attention, where the source drops them by its jagged
layout (the same valid outputs); the pad id is the table's last row, not
row 0; the negatives and the dropout masks are drawn by a counter hash of
the step's seed (:func:`counter_hash`, the rule the port draws them by),
not by ``torch.randint`` and ``F.dropout``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_U32 = 0xFFFFFFFF
EPS = 1e-6


@contextlib.contextmanager
def f32_products():
    held = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = held


def _mul_u32(x, c):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def counter_hash(rows: int, cols: int, seed: int, stream: int, device="cpu"):
    """uint32 values (int64) of ``fmix32(row·0x9E3779B9 + col·0x85EBCA6B +
    seed·0xC2B2AE35 + (stream+1)·0x27D4EB2F)``, ``[rows, cols]``."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    h = (_mul_u32(r, 0x9E3779B9) + _mul_u32(c, 0x85EBCA6B)
         + _mul_u32(torch.tensor(seed & _U32, device=device), 0xC2B2AE35)
         + ((stream + 1) * 0x27D4EB2F & _U32)) & _U32
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul_u32(h, 0x846CA68B)
    return h ^ (h >> 16)


def dropout_mask(rows, cols, rate, seed, stream, device="cpu"):
    keep = 1.0 - rate
    scale = float(torch.tensor(1.0) / torch.tensor(keep, dtype=torch.float32))
    h = counter_hash(rows, cols, seed, stream, device)
    return torch.where(h < int(keep * 0xFFFFFFFF), scale, 0.0).float()


def negatives(rows, k, items, seed, device="cpu"):
    return (counter_hash(rows, k, seed, 1000, device) * items) >> 32


def bucket(delta: torch.Tensor) -> torch.Tensor:
    """The source's ``(log(|Δ|.clamp(min=1)) / 0.301).long()``, clamped to
    ``[0, 128]``."""
    return (torch.log(delta.abs().clamp(min=1).float()) / 0.301).long().clamp(0, 128)


def rel_bias(ts, w_pos, w_time):
    """``[B, N, N]``: ``w_pos[N-1+j-i] + w_time[bucket(t[i+1] - t[j])]``, with
    ``t[N] = t[N-1]``."""
    n = ts.shape[1]
    i = torch.arange(n, device=ts.device)[:, None]
    j = torch.arange(n, device=ts.device)[None, :]
    ext = torch.cat([ts, ts[:, n - 1:n]], 1)
    return w_pos[(n - 1 + j - i)][None] + w_time[bucket(ext[:, 1:, None] - ext[:, None, :-1])]


def l2(x):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=EPS)


def encode(p: dict, ids, cfg: dict, seed=None):
    """The blocks' outputs ``[B, N, D]``; ``seed`` None: no dropout."""
    items, ts = ids[:, 0], ids[:, 1]
    b, n = items.shape
    d, heads, dqk, dv = cfg["k"], cfg["heads"], cfg["d_qk"], cfg["d_v"]
    rate = cfg["dropout"]
    valid = (items != cfg["items"]).float()
    x = p["table"][items] * (d ** 0.5) + p["pos_emb"][:n][None]
    dev = ids.device
    if seed is not None and rate > 0:
        x = x * dropout_mask(b * n, d, rate, seed, 0, dev).view(b, n, d)
    x = x * valid[..., None]
    causal = torch.tril(torch.ones(n, n, device=dev))
    mask = causal[None] * valid[:, None, :]
    for blk in range(cfg["blocks"]):
        w = {k: p[f"blocks.{blk}.{k}"] for k in ("uvqk", "w_o", "b_o", "w_pos", "w_time")}
        normed = F.layer_norm(x, [d], eps=EPS)
        mm = F.silu(torch.einsum("bnd,de->bne", normed, w["uvqk"]))
        u, v, q, k = torch.split(mm, [heads * dv, heads * dv, heads * dqk, heads * dqk], -1)
        qk = torch.einsum("bnhd,bmhd->bhnm", q.reshape(b, n, heads, dqk),
                          k.reshape(b, n, heads, dqk))
        qk = qk + rel_bias(ts, w["w_pos"], w["w_time"])[:, None]
        qk = F.silu(qk) / n * mask[:, None]
        attn = torch.einsum("bhnm,bmhd->bnhd", qk, v.reshape(b, n, heads, dv))
        o = u * F.layer_norm(attn.reshape(b, n, heads * dv), [heads * dv], eps=EPS)
        if seed is not None and rate > 0:
            o = o * dropout_mask(b * n, heads * dv, rate, seed, 1 + blk, dev).view(b, n, -1)
        x = torch.einsum("bne,ed->bnd", o, w["w_o"]) + w["b_o"] + x
    return x


def loss(p: dict, ids, weights, cfg: dict, seed: int):
    """The sampled softmax over positions ``i < N-1`` whose next item is
    valid, weighted by the sequence's weight."""
    with f32_products():
        out = encode(p, ids, cfg, seed)
        items = ids[:, 0]
        b, n = items.shape
        nxt = items[:, 1:]
        w = (nxt != cfg["items"]).float() * weights[:, None]
        y = l2(out[:, :-1])
        pos = (y * l2(p["table"][nxt])).sum(-1) / cfg["temperature"]
        neg_ids = negatives(b * (n - 1), cfg["negatives"], cfg["items"], seed,
                            ids.device).view(b, n - 1, -1)
        neg = torch.einsum("bnd,bnkd->bnk", y, l2(p["table"][neg_ids])) / cfg["temperature"]
        neg = torch.where(neg_ids == nxt[..., None], -5e4, neg)
        per = -F.log_softmax(torch.cat([pos[..., None], neg], -1), -1)[..., 0]
        return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


def adam_step(p: dict, grads: dict, state: dict, lr: float, b1: float, b2: float,
              eps: float = 1e-8) -> None:
    """optax's Adam, in place; ``state`` holds ``count``, ``mu``, ``nu``."""
    state["count"] += 1
    t = state["count"]
    bc1 = 1.0 - torch.tensor(b1) ** t
    bc2 = 1.0 - torch.tensor(b2) ** t
    with torch.no_grad():
        for name, g in grads.items():
            mu = state["mu"].setdefault(name, torch.zeros_like(g))
            nu = state["nu"].setdefault(name, torch.zeros_like(g))
            mu.copy_(g * (1 - b1) + mu * b1)
            nu.copy_(g * g * (1 - b2) + nu * b2)
            p[name].add_(mu / bc1 / ((nu / bc2).sqrt() + eps) * -lr)

