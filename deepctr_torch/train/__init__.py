"""Training of the port: the step, the loop."""

from .loop import FitResult, evaluate, fit
from .step import (
    StepMetrics,
    TrainState,
    dense_params,
    init_state,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "FitResult",
    "evaluate",
    "fit",
    "StepMetrics",
    "TrainState",
    "dense_params",
    "init_state",
    "make_eval_step",
    "make_train_step",
]
