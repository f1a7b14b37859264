"""Dense optimizers for the tower: the counterparts of ``optax.sgd``,
``optax.adagrad`` and ``optax.adam`` as ``deepctr_tpu/cli.py::build_optimizers``
builds them.

They keep optax's arithmetic and its order of operations, and the train
step's: the optimizer's update, then ``x lr_scale``, then the add. Adagrad is
optax 0.2.6's ``scale_by_rss`` followed by ``scale_by_learning_rate``: the
accumulator starts at 0.1 and the update is ``-lr * g * rsqrt(acc + 1e-7)``.
``torch.optim.Adagrad`` starts at 0 and divides by ``sqrt(acc) + 1e-10``,
and its first steps differ by orders of magnitude, so it is not used.

Adam is optax 0.2.6's ``scale_by_adam(b1=0.9, b2=0.999, eps=1e-8,
eps_root=0)`` followed by ``scale_by_learning_rate``: the moments
``(1 - b) * g^k + b * m``, the count incremented before the bias correction
``m / (1 - b^count)`` (computed in f32 on the device, as optax's is), and
the update ``-lr * mu_hat / (sqrt(nu_hat) + eps)``.

Parameters are a list of tensors, updated in place with PyTorch's
multi-tensor (``_foreach``) ops, a few launches for the whole tower. The
state is a list of accumulators (nothing, for SGD), or for Adam an
``AdamState`` laid out as optax's ``ScaleByAdamState(count, mu, nu)``, so
that a checkpoint holds its leaves in optax's order.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class Sgd:
    learning_rate: float

    def init(self, params: list[torch.Tensor]) -> list[torch.Tensor]:
        del params
        return []

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               state: list[torch.Tensor], lr_scale: float = 1.0):
        updates = torch._foreach_mul(grads, -self.learning_rate)
        torch._foreach_mul_(updates, lr_scale)
        torch._foreach_add_(params, updates)
        return state


@dataclasses.dataclass(frozen=True)
class Adagrad:
    learning_rate: float
    initial_accumulator_value: float = 0.1
    eps: float = 1e-7

    def init(self, params: list[torch.Tensor]) -> list[torch.Tensor]:
        return [torch.full_like(p, self.initial_accumulator_value) for p in params]

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               state: list[torch.Tensor], lr_scale: float = 1.0):
        torch._foreach_add_(state, torch._foreach_mul(grads, grads))
        # optax zeroes rsqrt where acc == 0; there g == 0 too, and with eps > 0
        # the product is the same 0
        updates = torch._foreach_rsqrt(torch._foreach_add(state, self.eps))
        torch._foreach_mul_(updates, grads)
        torch._foreach_mul_(updates, -self.learning_rate)
        torch._foreach_mul_(updates, lr_scale)
        torch._foreach_add_(params, updates)
        return state


class AdamState(NamedTuple):
    count: torch.Tensor       # int32 scalar on the parameters' device
    mu: list[torch.Tensor]    # first moments, one per parameter
    nu: list[torch.Tensor]    # second moments


@dataclasses.dataclass(frozen=True)
class Adam:
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: list[torch.Tensor]) -> AdamState:
        device = params[0].device if params else None
        return AdamState(count=torch.zeros((), dtype=torch.int32, device=device),
                         mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               state: AdamState, lr_scale: float = 1.0):
        mu, nu = state.mu, state.nu
        new_mu = torch._foreach_mul(grads, 1.0 - self.b1)
        torch._foreach_add_(new_mu, torch._foreach_mul(mu, self.b1))
        new_nu = torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - self.b2)
        torch._foreach_add_(new_nu, torch._foreach_mul(nu, self.b2))
        for dst, src in ((mu, new_mu), (nu, new_nu)):
            torch._foreach_copy_(dst, src)
        # optax's safe_increment: the count stops at int32's largest value
        state.count.add_((state.count < torch.iinfo(torch.int32).max).int())
        t = state.count.float()
        bc1 = 1.0 - torch.full_like(t, self.b1) ** t
        bc2 = 1.0 - torch.full_like(t, self.b2) ** t
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu, bc1)
        torch._foreach_div_(updates, denom)
        torch._foreach_mul_(updates, -self.learning_rate)
        torch._foreach_mul_(updates, lr_scale)
        torch._foreach_add_(params, updates)
        return state


DENSE_OPTIMIZERS = {"sgd": Sgd, "adagrad": Adagrad, "adam": Adam}


def make_dense_optimizer(name: str, learning_rate: float):
    """``optim.dense`` of the config: ``sgd``, ``adagrad`` or ``adam``, each
    with optax's defaults. The reference takes any optax factory; any other
    name raises ``ValueError``, its error for an unknown one."""
    if name not in DENSE_OPTIMIZERS:
        raise ValueError(f"unknown dense optimizer {name!r} (the port has "
                         f"{' | '.join(DENSE_OPTIMIZERS)})")
    return DENSE_OPTIMIZERS[name](learning_rate)
