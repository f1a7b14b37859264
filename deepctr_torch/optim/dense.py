"""Dense optimizers for the tower: the counterparts of ``optax.sgd`` and
``optax.adagrad`` as ``deepctr_tpu/cli.py::build_optimizers`` builds them.

They keep optax's arithmetic and its order of operations, and the train
step's: the optimizer's update, then ``x lr_scale``, then the add. Adagrad is
optax 0.2.6's ``scale_by_rss`` followed by ``scale_by_learning_rate``: the
accumulator starts at 0.1 and the update is ``-lr * g * rsqrt(acc + 1e-7)``.
``torch.optim.Adagrad`` starts at 0 and divides by ``sqrt(acc) + 1e-10``,
and its first steps differ by orders of magnitude, so it is not used.

Parameters are a list of tensors, updated in place with PyTorch's
multi-tensor (``_foreach``) ops, a few launches for the whole tower; the
state is a list of accumulators (or nothing, for SGD).
"""

from __future__ import annotations

import dataclasses

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


def make_dense_optimizer(name: str, learning_rate: float):
    """``optim.dense`` of the config: ``sgd`` or ``adagrad``."""
    if name == "sgd":
        return Sgd(learning_rate)
    if name == "adagrad":
        return Adagrad(learning_rate)
    raise NotImplementedError(
        f"dense optimizer {name!r} is not ported to deepctr_torch (sgd and "
        f"adagrad are; ROADMAP.md, 'Modules still to port', slice 4: cli.py)"
    )
