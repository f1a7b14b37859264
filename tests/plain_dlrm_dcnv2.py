"""A plain DLRM-DCNv2 for the port's CPU tests: float32 PyTorch, no kernel,
no module of the port (a copy of ``ctrbench/reference/dlrm_dcnv2.py``'s
arithmetic).

- ``e_t``: each field's slots' rows, masked, summed in float64 and rounded
  once to float32;
- ``d = bottom(log(1 + dense))``, ReLU on every layer;
- ``x0 = concat(d, e_1..e_F)``; ``x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l``;
- ``logit = top(x_L)``, ReLU on all but the last layer;
- the mean weighted binary cross-entropy; per-row Adagrad on the table
  (each row's occurrence gradients summed in float64, rounded once;
  ``acc += g^2``, ``row -= lr·g / (sqrt(acc) + eps)``) and optax's Adagrad
  on the dense leaves (``acc += g^2``, ``p -= lr·g·rsqrt(acc + eps)``).

Dense leaves are a dict of the port's parameter names (``bottom.layers.0.w``,
``cross.layers.0.v``, ``top.layers.0.b``, ...) to tensors.
"""

from __future__ import annotations

import torch


def _layers(leaves: dict, part: str, keys: tuple[str, ...]) -> list[tuple]:
    out, i = [], 0
    while f"{part}.layers.{i}.{keys[0]}" in leaves:
        out.append(tuple(leaves[f"{part}.layers.{i}.{k}"] for k in keys))
        i += 1
    return out


def logits(leaves: dict, rows, mask, dense, slot_field, num_fields: int) -> torch.Tensor:
    """rows ``[B, S, D]``, mask ``[B, S]``, dense ``[B, n]`` -> ``[B]``."""
    used = rows.double() * mask.double()[..., None]
    pooled = used.new_zeros(rows.shape[0], num_fields, rows.shape[2]).index_add(
        1, torch.as_tensor(slot_field, dtype=torch.long), used)
    d = torch.log1p(dense)
    for w, b in _layers(leaves, "bottom", ("w", "b")):
        d = torch.relu(d @ w + b)
    x0 = torch.cat([d, pooled.float().reshape(rows.shape[0], -1)], 1)
    x = x0
    for v, w, b in _layers(leaves, "cross", ("v", "w", "b")):
        x = x0 * ((x @ v) @ w + b) + x
    top = _layers(leaves, "top", ("w", "b"))
    for i, (w, b) in enumerate(top):
        x = x @ w + b
        if i < len(top) - 1:
            x = torch.relu(x)
    return x[:, 0]


def loss(z, labels, weights) -> torch.Tensor:
    per = -(labels * torch.nn.functional.logsigmoid(z)
            + (1.0 - labels) * torch.nn.functional.logsigmoid(-z))
    return (per * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def loss_and_grads(table, leaves: dict, ids, mask, dense, labels, weights, slot_field,
                   num_fields: int):
    """``(loss, per-row gradients [V, D] (f32, float64 sums), {leaf: grad})``."""
    with torch.enable_grad():
        rows = table[ids].detach().requires_grad_(True)
        params = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
        value = loss(logits(params, rows, mask, dense, slot_field, num_fields), labels,
                     weights)
        g_rows, *g = torch.autograd.grad(value, [rows] + list(params.values()))
    d = table.shape[1]
    g_table = torch.zeros(table.shape, dtype=torch.float64).index_add_(
        0, ids.reshape(-1), g_rows.reshape(-1, d).double()).float()
    return value.detach(), g_table, dict(zip(params, g))


def step(state: dict, ids, mask, dense, labels, weights, slot_field, num_fields: int,
         sparse: dict, dense_opt: dict):
    """One step on ``state`` (``table``, ``acc``, ``leaves``, ``acc_d``), in
    place; returns the loss. ``sparse`` and ``dense_opt`` hold ``lr`` and
    ``eps``."""
    value, g, g_d = loss_and_grads(state["table"], state["leaves"], ids, mask, dense,
                                   labels, weights, slot_field, num_fields)
    touched = torch.unique(ids.reshape(-1))
    with torch.no_grad():
        a = state["acc"][touched] + g[touched] * g[touched]
        state["acc"][touched] = a
        state["table"][touched] = (state["table"][touched] - sparse["lr"] * g[touched]
                                   / (a.sqrt() + sparse["eps"]))
        for k, p in state["leaves"].items():
            acc = state["acc_d"][k]
            acc.add_(g_d[k] * g_d[k])
            p.add_(g_d[k] * torch.rsqrt(acc + dense_opt["eps"]) * -dense_opt["lr"])
    return value
