"""xDeepFM (Lian et al., *xDeepFM: Combining Explicit and Implicit Feature
Interactions for Recommender Systems*, KDD 2018, arXiv:1803.05170; the
authors' code is github.com/Leavingseason/xDeepFM) as the configuration
states it, in plain float32 PyTorch with TF32 off:

- each field's slots' rows ``[1+k]``, masked and summed (in float64,
  rounded once to float32, as ``fnn.py`` sums them): column 0 the field's
  linear weight, columns 1..k its embedding ``e_j``; ``X^0 = [e_1..e_m]``;
- the CIN (Eq. 6): ``X^k[h, :] = Σ_{i,j} W^k[h, i, j] (X^{k-1}[i, :] ∘
  X^0[j, :])``: the outer product of ``X^{k-1}`` and ``X^0`` materialised
  by an einsum, in blocks of examples, then its product with ``W^k``; every
  map goes both to the next layer and to the sum pooling ``p^k = Σ_d X^k[:,
  d]`` (direct connections); no bias, no activation;
- the logit (Eq. 8): ``Σ_fields w_lin + DNN(flatten X^0) + w_cin·[p^1..p^T]
  + b``, the DNN ReLU on its hidden layers and one output;
- the mean binary cross-entropy, autograd's gradients, per-row Adagrad on
  the table (each row's occurrence gradients summed first, in float64;
  ``acc += g^2``, ``row -= lr·g / (sqrt(acc) + eps)``) and optax's Adam on
  the dense leaves (``mu = (1 - b1)·g + b1·mu``, ``nu = (1 - b2)·g² +
  b2·nu``, ``p -= lr·(mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)``).

Departures from the paper, each the configuration's: the table trains with
Adagrad, where the paper trains every parameter with Adam (the port has no
sparse Adam); no L2 term (the paper's λ = 1e-4); the DNN's last layer has a
bias of its own beside ``b``; no dropout. ``W^k`` is kept as the port keeps
it, ``[H_{k-1}·m, H_k]`` with row ``i·m + j``.

It works on the rows its steps touch: the caller hands it the initial rows
of the sorted unique ids of the steps' batches and each batch's ids as
places in that list, with the slots' mask beside them. Rows no step touches
neither move nor have a gradient, so the norms it gives are the whole
table's. A step given as None is a weight-0 pad step, as the program pads a
chunk: its gradients are 0, the table and its accumulator keep their bits,
and Adam still steps (its count grows, its moments decay, the leaves move).

``precision="tf32"`` rounds every operand of the CIN's and the DNN's
products, forward and backward, to TF32 (``fnn.product``): the control, one
step of precision below the configuration's. ``fault`` plants one fault in
the reference put in the program's place: ``unchanged`` (the step returns
its state unchanged), ``half_batch`` (the batch's second half at weight 0),
``sparse_lr`` (the table's update at half its rate) and ``cin_no_x0`` (the
last CIN layer without its ``X^0`` factor).
"""

from __future__ import annotations

import torch

from .fnn import f32_products, product

BLOCK = 512   # examples a block of the CIN's outer product
FAULTS = ("unchanged", "half_batch", "sparse_lr", "cin_no_x0")


def leaf_names(config: dict) -> list[str]:
    """``table``, then the dense leaves in the port's parameter order."""
    names = ["table", "bias", "w_cin"]
    names += [f"cin.{i}" for i in range(len(config["cin_layer_sizes"]))]
    for i in range(len(config["dnn_hidden"]) + 1):
        names += [f"mlp.layers.{i}.w", f"mlp.layers.{i}.b"]
    return names


def _split(config: dict, leaves):
    """``(bias, w_cin, [W^k], [(w, b)])`` of the dense leaves."""
    t = len(config["cin_layer_sizes"])
    bias, w_cin, rest = leaves[0], leaves[1], leaves[2:]
    return bias, w_cin, rest[:t], [tuple(rest[i:i + 2]) for i in range(t, len(rest), 2)]


def pool(rows: torch.Tensor, mask: torch.Tensor, slot_field: list[int],
         num_fields: int) -> torch.Tensor:
    """rows ``[B, S, 1+k]`` -> the masked float64 sum of each field's slots,
    rounded to float32: ``[B, m, 1+k]``."""
    used = rows.double() * mask.double()[..., None]
    index = torch.tensor(slot_field, device=rows.device)
    out = used.new_zeros(rows.shape[0], num_fields, rows.shape[2])
    return out.index_add(1, index, used).float()


def cin(x0: torch.Tensor, weights, precision: str, fault: str | None = None,
        block: int = BLOCK) -> torch.Tensor:
    """``x0`` ``[B, m, D]`` -> the pooled maps ``[B, Σ H_k]``."""
    b_all, m, d = x0.shape
    out = []
    for s in range(0, b_all, block):
        e = x0[s:s + block]
        b = e.shape[0]
        x, pooled = e, []
        for k, w in enumerate(weights):
            other = torch.ones_like(e) if fault == "cin_no_x0" and k == len(weights) - 1 else e
            z = torch.einsum("bid,bjd->bdij", x, other).reshape(b * d, -1)
            x = product(z, w, precision).view(b, d, -1).transpose(1, 2)   # [b, H_k, D]
            pooled.append(x.sum(-1))
        out.append(torch.cat(pooled, 1))
    return torch.cat(out)


def logits(config: dict, rows, mask, leaves, slot_field, precision: str = "f32",
           fault: str | None = None) -> torch.Tensor:
    """Logits ``[B]`` from the gathered rows ``[B, S, 1+k]``, the slots' mask
    ``[B, S]`` and the dense leaves (:func:`leaf_names` order, no table)."""
    bias, w_cin, cin_w, dnn = _split(config, leaves)
    pooled = pool(rows, mask, slot_field, len(config["fields"]))
    x0 = pooled[:, :, 1:]
    h = x0.reshape(x0.shape[0], -1)
    for i, (w, b) in enumerate(dnn):
        h = product(h, w, precision) + b
        if i < len(dnn) - 1:
            h = torch.relu(h)
    explicit = product(cin(x0, cin_w, precision, fault), w_cin[:, None], precision)[:, 0]
    return pooled[:, :, 0].sum(1) + h[:, 0] + explicit + bias


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def slot_fields(config: dict) -> list[int]:
    return [i for i, f in enumerate(config["fields"]) for _ in range(int(f[2]))]


class Adam:
    """optax's Adam on a list of float32 leaves, in place, in the port's
    order of operations (``deepctr_torch/optim/dense.py`` keeps optax's)."""

    def __init__(self, params, opt: dict):
        self.params, self.opt = params, opt
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        b1, b2 = float(self.opt["b1"]), float(self.opt["b2"])
        self.count += 1
        t = torch.tensor(float(self.count), device=self.params[0].device)
        bc1 = 1.0 - torch.full_like(t, b1) ** t
        bc2 = 1.0 - torch.full_like(t, b2) ** t
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_(g * (1.0 - b1) + mu * b1)
            nu.copy_(g * g * (1.0 - b2) + nu * b2)
            p.add_(mu / bc1 / ((nu / bc2).sqrt() + float(self.opt["eps"]))
                   * -float(self.opt["lr"]))


def train_reading(config: dict, rows0: torch.Tensor, dense0, steps,
                  precision: str = "f32", fault: str | None = None) -> dict:
    """The reference's steps from the touched rows ``rows0`` (``[U, 1+k]``)
    and the dense leaves ``dense0`` (unchanged; it works on copies) on
    ``steps``, each ``(local_ids [B, S], mask [B, S], labels [B])`` or None
    (a pad step): ``{"losses"`` (the live steps'), ``"grad_norms"`` (the
    first live step's), ``"change_norms"}``, as ``fnn.train_reading``
    gives them."""
    sp = config["sparse_optimizer"]
    slot_field = slot_fields(config)
    names = leaf_names(config)
    with f32_products():
        table = rows0.clone()
        params = [p.clone().requires_grad_(True) for p in dense0]
        adam = Adam(params, config["dense_optimizer"])
        acc_t = torch.full(table.shape, float(sp["initial_accumulator"]), device=table.device)
        losses, grad_norms = [], None
        for batch in steps:
            if batch is None:
                if fault != "unchanged":
                    adam.step([torch.zeros_like(p) for p in params])
                continue
            ids, mask, labels = batch
            rows = table[ids].requires_grad_(True)
            z = logits(config, rows, mask, params, slot_field, precision, fault)
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
            if grad_norms is None:
                grad_norms = dict(zip(names, [_norm(g)] + [_norm(t) for t in g_dense]))
            if fault == "unchanged":
                continue
            lr_t = float(sp["lr"]) * (0.5 if fault == "sparse_lr" else 1.0)
            with torch.no_grad():
                a = acc_t[uniq] + g * g
                acc_t[uniq] = a
                table[uniq] = table[uniq] - lr_t * g / (a.sqrt() + float(sp["eps"]))
            adam.step(g_dense)
        if fault == "unchanged":   # what the program's state would show
            grad_norms = {k: 0.0 for k in grad_norms}
        change = [_norm(table - rows0)] + [_norm(p - p0) for p, p0 in zip(params, dense0)]
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": dict(zip(names, change))}
