"""Models of the port: FNN so far."""

from .base import MlpSpec, apply_model, init_mlp, lazy_l2, weighted_bce_with_logits
from .fnn import FNNModel, make_fnn

__all__ = ["MlpSpec", "apply_model", "init_mlp", "lazy_l2",
           "weighted_bce_with_logits", "FNNModel", "make_fnn"]
