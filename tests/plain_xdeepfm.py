"""A plain xDeepFM for the port's CPU tests: float32 PyTorch with TF32 off,
no kernel, no module of the port (a copy of
``ctrbench/reference/xdeepfm.py``'s arithmetic).

xDeepFM (Lian et al., KDD 2018, arXiv:1803.05170):

- each field's slots' rows ``[1+k]``, masked, summed in float64 and rounded
  once to float32; column 0 is the field's linear weight, columns 1..k its
  embedding, ``X^0 = [e_1..e_m]`` ``[m, k]``;
- the CIN (Eq. 6): ``X^k[h] = Σ_{i,j} W^k[h, i, j] (X^{k-1}[i] ∘ X^0[j])``,
  an einsum over the materialised outer product, in blocks of examples, and
  ``p^k = Σ_d X^k[:, d]``; direct connections, no bias, no activation;
- the logit (Eq. 8): ``Σ_fields w_lin + DNN(flatten X^0) + w_cin·[p^1..p^T]
  + b``, the DNN ReLU on its hidden layers, one output, no dropout;
- the mean weighted binary cross-entropy; per-row Adagrad on the table
  (each row's occurrence gradients summed in float64, rounded once; ``acc
  += g^2``, ``row -= lr·g / (sqrt(acc) + eps)``) and optax's Adam on the
  dense leaves (``mu = (1 - b1)·g + b1·mu``, ``nu = (1 - b2)·g² + b2·nu``,
  ``p -= lr·(mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)``).

Departures from the paper: the table trains with Adagrad, not Adam; no L2
term; the DNN's last layer has a bias beside ``b``.

Dense leaves are a dict of the port's parameter names (``bias``, ``cin.0``
``[H_0·m, H_1]`` with row ``i·m + j``, ``w_cin``, ``mlp.layers.0.w``, ...)
to tensors.
"""

from __future__ import annotations

import contextlib

import torch

BLOCK = 64   # examples a block of the CIN's outer product


@contextlib.contextmanager
def f32_products():
    held = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = held


def cin_maps(x0: torch.Tensor, weights: list, block: int = BLOCK) -> list[torch.Tensor]:
    """``x0`` ``[B, m, D]`` -> every layer's ``X^k`` ``[B, H_k, D]``."""
    m = x0.shape[1]
    per_block = []
    for s in range(0, x0.shape[0], block):
        e = x0[s:s + block]
        x, maps = e, []
        for w in weights:
            z = torch.einsum("bid,bjd->bijd", x, e)
            x = torch.einsum("bijd,ijh->bhd", z, w.view(x.shape[1], m, -1))
            maps.append(x)
        per_block.append(maps)
    return [torch.cat(layer) for layer in zip(*per_block)]


def cin(x0: torch.Tensor, weights: list, block: int = BLOCK) -> torch.Tensor:
    """The pooled maps ``[B, Σ H_k]``."""
    return torch.cat([x.sum(-1) for x in cin_maps(x0, weights, block)], 1)


def _layers(leaves: dict, prefix: str) -> list:
    out, i = [], 0
    while f"{prefix}.{i}" in leaves or f"{prefix}.{i}.w" in leaves:
        out.append(leaves[f"{prefix}.{i}"] if f"{prefix}.{i}" in leaves
                   else (leaves[f"{prefix}.{i}.w"], leaves[f"{prefix}.{i}.b"]))
        i += 1
    return out


def logits(leaves: dict, rows, mask, slot_field, num_fields: int) -> torch.Tensor:
    """rows ``[B, S, 1+k]``, mask ``[B, S]`` -> ``[B]``."""
    with f32_products():
        used = rows.double() * mask.double()[..., None]
        pooled = used.new_zeros(rows.shape[0], num_fields, rows.shape[2]).index_add(
            1, torch.as_tensor(slot_field, dtype=torch.long), used).float()
        x0 = pooled[:, :, 1:]
        h = x0.reshape(rows.shape[0], -1)
        tower = _layers(leaves, "mlp.layers")
        for i, (w, b) in enumerate(tower):
            h = h @ w + b
            if i < len(tower) - 1:
                h = torch.relu(h)
        explicit = cin(x0, _layers(leaves, "cin")) @ leaves["w_cin"]
        return pooled[:, :, 0].sum(1) + h[:, 0] + explicit + leaves["bias"]


def loss(z, labels, weights) -> torch.Tensor:
    per = -(labels * torch.nn.functional.logsigmoid(z)
            + (1.0 - labels) * torch.nn.functional.logsigmoid(-z))
    return (per * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def loss_and_grads(table, leaves: dict, ids, mask, labels, weights, slot_field,
                   num_fields: int):
    """``(loss, per-row gradients [V, 1+k] (f32, float64 sums), {leaf: grad})``."""
    with torch.enable_grad():
        rows = table[ids].detach().requires_grad_(True)
        params = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
        value = loss(logits(params, rows, mask, slot_field, num_fields), labels, weights)
        g_rows, *g = torch.autograd.grad(value, [rows] + list(params.values()))
    d = table.shape[1]
    g_table = torch.zeros(table.shape, dtype=torch.float64).index_add_(
        0, ids.reshape(-1), g_rows.reshape(-1, d).double()).float()
    return value.detach(), g_table, dict(zip(params, g))


def adam(state: dict, grads: dict, lr: float, b1=0.9, b2=0.999, eps=1e-8) -> None:
    """optax's Adam on ``state["leaves"]`` in place, its moments in
    ``state["mu"]``, ``state["nu"]`` and its count in ``state["count"]``."""
    state["count"] += 1
    t = torch.tensor(float(state["count"]))
    bc1, bc2 = 1.0 - torch.tensor(b1) ** t, 1.0 - torch.tensor(b2) ** t
    for k, p in state["leaves"].items():
        g = grads[k]
        state["mu"][k] = g * (1.0 - b1) + state["mu"][k] * b1
        state["nu"][k] = g * g * (1.0 - b2) + state["nu"][k] * b2
        p.add_(state["mu"][k] / bc1 / ((state["nu"][k] / bc2).sqrt() + eps) * -lr)


def step(state: dict, ids, mask, labels, weights, slot_field, num_fields: int,
         sparse: dict, dense_lr: float):
    """One step on ``state`` (``table``, ``acc``, ``leaves``, ``mu``, ``nu``,
    ``count``), in place; returns the loss. ``sparse`` holds ``lr`` and
    ``eps``."""
    value, g, g_d = loss_and_grads(state["table"], state["leaves"], ids, mask, labels,
                                   weights, slot_field, num_fields)
    touched = torch.unique(ids.reshape(-1))
    with torch.no_grad():
        a = state["acc"][touched] + g[touched] * g[touched]
        state["acc"][touched] = a
        state["table"][touched] = (state["table"][touched] - sparse["lr"] * g[touched]
                                   / (a.sqrt() + sparse["eps"]))
        adam(state, g_d, dense_lr)
    return value
