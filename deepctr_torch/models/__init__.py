"""Models of the port (forward only): FNN so far."""

from .base import MlpSpec, apply_model
from .fnn import FNNModel, make_fnn

__all__ = ["MlpSpec", "apply_model", "FNNModel", "make_fnn"]
