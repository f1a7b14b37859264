"""Training of the port: the steps, the loop, SNN's pretraining."""

from .loop import FitResult, evaluate, fit, pretrain_snn
from .step import (
    StepMetrics,
    TrainState,
    dense_params,
    init_state,
    make_eval_step,
    make_pretrain_step,
    make_scan_train_step,
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
    "make_pretrain_step",
    "make_scan_train_step",
    "make_train_step",
    "pretrain_snn",
]
