"""Optimizers of the port: sparse per-row (table) and dense (tower)."""

from .dense import Adagrad, Adam, AdamState, Sgd, make_dense_optimizer
from .sparse import (
    SparseAdagrad,
    SparseAdagradState,
    SparseSgd,
    SparseSgdState,
    make_sparse_optimizer,
)

__all__ = [
    "Adagrad",
    "Adam",
    "AdamState",
    "Sgd",
    "make_dense_optimizer",
    "SparseAdagrad",
    "SparseAdagradState",
    "SparseSgd",
    "SparseSgdState",
    "make_sparse_optimizer",
]
