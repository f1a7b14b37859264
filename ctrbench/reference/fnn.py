"""FNN (arXiv:1601.02376) as the configuration states it, in plain float32
PyTorch with TF32 off: the gather of each slot's row, the masked sum of each
field's slots, the tanh tower with the counter-hash dropout, the mean
weighted binary cross-entropy, autograd's gradients, per-row Adagrad on the
table (each row's occurrence gradients summed first, the table rounded to
its dtype on write) and optax's Adagrad on the tower.

The two sums over a variable number of terms, a field's slots and a row's
occurrence gradients, are taken in float64 and rounded once to float32: a
float32 sum by atomics changes with the order of its terms from run to run,
and where a hot row's gradients nearly cancel, Adagrad's first step (its
accumulator at 0) turns that last bit into a visible change of the row.

What it keeps of the program, frozen as data: the counter hash that draws
the dropout mask (:func:`dropout_mask`, the reference kernel's) and the way
a sharded step mixes a rank into each step's seed (:func:`rank_seed`).
Everything else it works out from the configuration, the weights and the
inputs that the harness hands to both sides.

``precision="tf32"`` rounds every operand of the tower's products, forward
and backward, to TF32 (10 mantissa bits, to nearest even) before a float32
product: the control, one step of precision below what the configuration
states. ``fault`` plants one fault in the reference put in the program's
place: ``unchanged`` (the step returns its state unchanged), ``half_batch``
(each rank's batch keeps its first half, the mean taken over it),
``no_exchange`` (a rank sees only the rows it owns), ``sparse_lr`` (the
table's update at half its rate, the tower's as stated); and in scoring
``linear`` (the tower's hidden activation left out).
"""

from __future__ import annotations

import contextlib

import torch

from ..traffic import Fields

SEED_LIMIT = 1 << 24
_U32 = 0xFFFFFFFF


@contextlib.contextmanager
def f32_products():
    """TF32 off for cuBLAS and cuDNN while the reference runs."""
    held = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = held


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


class _Tf32Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ tf32_round(b).t(), tf32_round(a).t() @ g


def product(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return a @ b
    if precision == "tf32":
        return _Tf32Product.apply(a, b)
    raise ValueError(f"precision {precision!r} (f32|tf32)")


def rank_seed(seed: int, rank: int) -> int:
    """The seed rank ``rank``'s tower draws its mask from in a sharded step."""
    return (seed + rank * 0x9E3779B1) % SEED_LIMIT


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def dropout_mask(rows: int, cols: int, rate: float, seed: int, layer: int,
                 device) -> torch.Tensor:
    """f32 ``[rows, cols]``: ``1/keep`` where element ``(row, col)`` of hidden
    layer ``layer`` is kept, 0 where dropped. It is kept where
    ``fmix32(row·0x9E3779B9 + col·0x85EBCA6B + seed·0xC2B2AE35 +
    (layer+1)·0x27D4EB2F) < int(keep·0xFFFFFFFF)`` in uint32 arithmetic, with
    ``keep = 1 - rate`` and ``row`` counted from the rank's first row."""
    keep = 1.0 - rate
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    h = (_mul_u32(r, 0x9E3779B9) + _mul_u32(c, 0x85EBCA6B)
         + _mul_u32(torch.tensor(seed & _U32, device=device), 0xC2B2AE35)
         + ((layer + 1) * 0x27D4EB2F & _U32)) & _U32
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul_u32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    scale = float(torch.tensor(1.0, dtype=torch.float32) / torch.tensor(keep, dtype=torch.float32))
    return torch.where(h < int(keep * 0xFFFFFFFF), scale, 0.0).to(torch.float32)


_ACTS = {"tanh": torch.tanh, "relu": torch.relu, "sigmoid": torch.sigmoid}


def tower(x: torch.Tensor, layers, config: dict, seed: int | None,
          precision: str, linear: bool = False) -> torch.Tensor:
    """``[b, in]`` -> logits ``[b]``; with a seed, each hidden layer's
    activation is masked by :func:`dropout_mask`; ``linear`` leaves the
    activation out (a fault)."""
    act = (lambda t: t) if linear else _ACTS[config["activation"]]
    rate = float(config["dropout"])
    h = x
    for i, (w, b) in enumerate(layers):
        h = product(h, w, precision) + b
        if i < len(layers) - 1:
            h = act(h)
            if seed is not None and rate > 0.0:
                h = h * dropout_mask(h.shape[0], h.shape[1], rate, seed, i, h.device)
    return h[:, 0]


def pool(rows: torch.Tensor, ids: torch.Tensor, fields: Fields) -> torch.Tensor:
    """rows ``[B, S, D]`` -> the masked sum of each field's slots, the fields
    side by side: ``[B, F·D]``."""
    used = rows * (ids != fields.pad_id).to(rows.dtype)[..., None]
    slot_field = torch.tensor(fields.slot_field, device=rows.device)
    out = rows.new_zeros(rows.shape[0], fields.num_fields, rows.shape[2], dtype=torch.float64)
    out = out.index_add(1, slot_field, used.double())
    return out.to(rows.dtype).reshape(rows.shape[0], -1)


def _loss(config, fields, table, layers, ids, labels, seed, ranks, precision, fault):
    n = ids.shape[0]
    b = n // ranks
    rows = table[ids].float().requires_grad_(True)
    used = rows
    if fault == "no_exchange":
        rank_of_row = torch.arange(n, device=ids.device) // b
        own = (ids % ranks) == rank_of_row[:, None]
        used = rows * own[..., None].to(rows.dtype)
    x = pool(used, ids, fields)
    logits = torch.cat([tower(x[r * b:(r + 1) * b], layers, config, rank_seed(seed, r),
                              precision) for r in range(ranks)])
    weights = torch.ones(n, device=ids.device)
    if fault == "half_batch":
        for r in range(ranks):
            weights[r * b + b // 2:(r + 1) * b] = 0.0
    per = -(labels * torch.nn.functional.logsigmoid(logits)
            + (1.0 - labels) * torch.nn.functional.logsigmoid(-logits))
    loss = (per * weights).sum() / torch.clamp(weights.sum(), min=1.0)
    return loss, rows


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def leaf_names(n_layers: int) -> list[str]:
    return ["table"] + [f"{p}{i}" for i in range(n_layers) for p in ("w", "b")]


def train_reading(config: dict, table0: torch.Tensor, tower0, batches, seeds,
                  ranks: int = 1, precision: str = "f32", fault: str | None = None) -> dict:
    """The reference's three steps from ``table0`` and ``tower0``
    (unchanged; it works on copies) on ``batches`` (``(ids [ranks·b, S],
    labels [ranks·b])`` each, the ranks' rows side by side) with the steps'
    dropout ``seeds``: ``{"losses": [...], "grad_norms": {leaf: ...},
    "change_norms": {leaf: ...}}``: each step's loss, the norm of each
    leaf's first gradient (the table's summed by row), and the norm of each
    leaf's change after the last step."""
    fields = Fields(config)
    sp, dp = config["sparse_optimizer"], config["dense_optimizer"]
    d = table0.shape[1]
    with f32_products():
        table = table0.clone()
        layers = [(w.clone().requires_grad_(True), b.clone().requires_grad_(True))
                  for w, b in tower0]
        params = [t for layer in layers for t in layer]
        acc_t = torch.full(table.shape, float(sp["initial_accumulator"]),
                           dtype=torch.float32, device=table.device)
        acc_d = [torch.full_like(p, float(dp["initial_accumulator"])) for p in params]
        names = leaf_names(len(layers))
        losses, grad_norms = [], None
        for step, ((ids, labels), seed) in enumerate(zip(batches, seeds)):
            loss, rows = _loss(config, fields, table, layers, ids, labels, int(seed),
                               ranks, precision, fault)
            g_rows, *g_dense = torch.autograd.grad(loss, [rows] + params)
            uniq, inv = torch.unique(ids.reshape(-1), return_inverse=True)
            g = torch.zeros(uniq.shape[0], d, device=table.device, dtype=torch.float64)
            g = g.index_add_(0, inv.reshape(-1), g_rows.reshape(-1, d).double()).float()
            losses.append(float(loss.detach()))
            if step == 0:
                grad_norms = dict(zip(names, [_norm(g)] + [_norm(t) for t in g_dense]))
            if fault == "unchanged":
                continue
            lr_t = float(sp["lr"]) * (0.5 if fault == "sparse_lr" else 1.0)
            with torch.no_grad():
                a = acc_t[uniq] + g * g
                acc_t[uniq] = a
                table[uniq] = (table[uniq].float() - lr_t * g
                               / (a.sqrt() + float(sp["eps"]))).to(table.dtype)
                for p, gp, acc in zip(params, g_dense, acc_d):
                    acc.add_(gp * gp)
                    p.add_(gp * torch.rsqrt(acc + float(dp["eps"])) * -float(dp["lr"]))
        if fault == "unchanged":   # what the program's state would show
            grad_norms = {k: 0.0 for k in grad_norms}
        change = [_norm(table.float() - table0.float())]
        for (w, b), (w0, b0) in zip(layers, tower0):
            change += [_norm(w - w0), _norm(b - b0)]
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": dict(zip(names, change))}


def serve_logits(config: dict, table: torch.Tensor, tower0, ids: torch.Tensor,
                 precision: str = "f32", fault: str | None = None,
                 block: int = 65536) -> torch.Tensor:
    """Logits ``[n]`` of packed ids ``[n, S]``, no dropout, in blocks of rows;
    ``fault`` ``linear`` leaves the hidden activation out."""
    fields = Fields(config)
    out = []
    with f32_products(), torch.no_grad():
        for i in range(0, ids.shape[0], block):
            part = ids[i:i + block]
            x = pool(table[part].float(), part, fields)
            out.append(tower(x, tower0, config, None, precision, linear=fault == "linear"))
    return torch.cat(out)
