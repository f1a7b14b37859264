"""DLRM-DCNv2 (DLRM, arXiv:1906.00091; DCN-V2, arXiv:2008.13535; MLPerf
Training's ``recommendation_v2/torchrec_dlrm``) as the configuration states
it, in plain float32 PyTorch with TF32 off:

- ``e_t``: each field's slots' rows summed (pad slots masked out);
- ``d = bottom(log(1 + dense))``, ReLU on every layer;
- ``x0 = concat(d, e_1..e_F)``; ``x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l``;
- ``logit = top(x_L)``, ReLU on all but the last layer;
- each layer with a bias as ``torch.nn.Linear`` computes it (MLPerf's
  torchrec model is made of them): one ``addmm``, the bias added in the
  product's epilogue;
- the mean binary cross-entropy, autograd's gradients, per-row Adagrad on
  the table (each row's occurrence gradients summed first, ``acc += g^2``,
  ``row -= lr·g / (sqrt(acc) + eps)``), and Adagrad in optax's form on the
  dense leaves (``acc += g^2``, ``p -= lr·g·rsqrt(acc + eps)``). No dropout.

The two sums over a variable number of terms, a field's slots and a row's
occurrence gradients, are taken in float64 and rounded once to float32, as
``fnn.py`` takes them.

It works on the rows its steps touch: the caller hands it the initial
rows of the sorted unique ids of the steps' batches and each batch's ids
as places in that list (``local_ids``), with the slots' mask beside them.
Rows no step touches neither move nor have a gradient, so the norms it
gives are the whole table's.

``precision="tf32"`` rounds every operand of the dense layers' products,
forward and backward, to TF32 (``fnn.product``): the control, one step of
precision below the configuration's. ``fault`` plants one fault in the
reference put in the program's place: ``unchanged`` (the step returns its
state unchanged), ``half_batch`` (the batch's second half at weight 0) and
``sparse_lr`` (the table's update at half its rate).
"""

from __future__ import annotations

import torch

from .fnn import f32_products, product


def leaf_names(config: dict) -> list[str]:
    """``table``, then the dense leaves in the port's parameter order."""
    names = ["table"]
    for i in range(len(config["dense_arch_layer_sizes"])):
        names += [f"bottom.{i}.w", f"bottom.{i}.b"]
    for i in range(int(config["dcn_num_layers"])):
        names += [f"cross.{i}.v", f"cross.{i}.w", f"cross.{i}.b"]
    for i in range(len(config["over_arch_layer_sizes"])):
        names += [f"top.{i}.w", f"top.{i}.b"]
    return names


def _split(config: dict, leaves):
    """``(bottom [(w, b)], cross [(v, w, b)], top [(w, b)])`` of the dense
    leaves in :func:`leaf_names` order (the table left out)."""
    nb = 2 * len(config["dense_arch_layer_sizes"])
    nc = 3 * int(config["dcn_num_layers"])
    bottom = [tuple(leaves[i:i + 2]) for i in range(0, nb, 2)]
    cross = [tuple(leaves[i:i + 3]) for i in range(nb, nb + nc, 3)]
    top = [tuple(leaves[i:i + 2]) for i in range(nb + nc, len(leaves), 2)]
    return bottom, cross, top


def pool(rows: torch.Tensor, mask: torch.Tensor, slot_field: list[int],
         num_fields: int) -> torch.Tensor:
    """rows ``[B, S, D]`` -> the masked float64 sum of each field's slots,
    rounded to the rows' dtype, the fields side by side: ``[B, F·D]``."""
    used = rows.double() * mask.double()[..., None]
    index = torch.tensor(slot_field, device=rows.device)
    out = used.new_zeros(rows.shape[0], num_fields, rows.shape[2])
    return out.index_add(1, index, used).to(rows.dtype).reshape(rows.shape[0], -1)


def linear(x, w, b, precision: str) -> torch.Tensor:
    """``x @ w + b``: ``torch.nn.Linear``'s ``addmm`` in float32; under
    ``tf32``, the TF32 product and then the bias."""
    if precision == "f32":
        return torch.addmm(b, x, w)
    return product(x, w, precision) + b


def logits(config: dict, rows, mask, dense, leaves, slot_field, precision: str = "f32"):
    """Logits ``[B]`` from the gathered rows ``[B, S, D]``, the slots' mask
    ``[B, S]``, the dense features ``[B, n]`` (counts) and the dense leaves."""
    bottom, cross, top = _split(config, leaves)
    d = torch.log1p(dense)
    for w, b in bottom:
        d = torch.relu(linear(d, w, b, precision))
    x0 = torch.cat([d, pool(rows, mask, slot_field, len(config["multi_hot_sizes"]))], 1)
    x = x0
    for v, w, b in cross:
        x = x0 * linear(product(x, v, precision), w, b, precision) + x
    for i, (w, b) in enumerate(top):
        x = linear(x, w, b, precision)
        if i < len(top) - 1:
            x = torch.relu(x)
    return x[:, 0]


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def slot_fields(config: dict) -> list[int]:
    return [i for i, h in enumerate(config["multi_hot_sizes"]) for _ in range(int(h))]


def train_reading(config: dict, rows0: torch.Tensor, dense0, batches,
                  precision: str = "f32", fault: str | None = None) -> dict:
    """The reference's steps from the touched rows ``rows0`` (``[U, D]``)
    and the dense leaves ``dense0`` (unchanged; it works on copies) on
    ``batches``, each ``(local_ids [B, S], mask [B, S], dense [B, n],
    labels [B])``: ``{"losses", "grad_norms", "change_norms"}``, as
    ``fnn.train_reading`` gives them."""
    sp, dp = config["sparse_optimizer"], config["dense_optimizer"]
    slot_field = slot_fields(config)
    names = leaf_names(config)
    with f32_products():
        table = rows0.clone()
        params = [p.clone().requires_grad_(True) for p in dense0]
        acc_t = torch.full(table.shape, float(sp["initial_accumulator"]), device=table.device)
        acc_d = [torch.full_like(p, float(dp["initial_accumulator"])) for p in params]
        losses, grad_norms = [], None
        for step, (ids, mask, dense, labels) in enumerate(batches):
            rows = table[ids].requires_grad_(True)
            z = logits(config, rows, mask, dense, params, slot_field, precision)
            weights = torch.ones_like(labels)
            if fault == "half_batch":
                weights[labels.shape[0] // 2:] = 0.0
            per = -(labels * torch.nn.functional.logsigmoid(z)
                    + (1.0 - labels) * torch.nn.functional.logsigmoid(-z))
            loss = (per * weights).sum() / torch.clamp(weights.sum(), min=1.0)
            g_rows, *g_dense = torch.autograd.grad(loss, [rows] + params)
            d = table.shape[1]
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
                table[uniq] = table[uniq] - lr_t * g / (a.sqrt() + float(sp["eps"]))
                for p, gp, acc in zip(params, g_dense, acc_d):
                    acc.add_(gp * gp)
                    p.add_(gp * torch.rsqrt(acc + float(dp["eps"])) * -float(dp["lr"]))
        if fault == "unchanged":   # what the program's state would show
            grad_norms = {k: 0.0 for k in grad_norms}
        change = [_norm(table - rows0)] + [_norm(p - p0) for p, p0 in zip(params, dense0)]
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": dict(zip(names, change))}
