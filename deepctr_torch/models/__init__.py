"""Models of the port: LR, FM, FNN, SNN (with its DAE and RBM pretrainers),
DeepFM and PNN (IPNN/OPNN)."""

from .base import MlpSpec, apply_model, init_mlp, lazy_l2, weighted_bce_with_logits
from .deepfm import DeepFMModel, make_deepfm
from .fm import FMModel, make_fm
from .fnn import FNNModel, make_fnn
from .lr import LRModel, make_lr
from .pnn import PNNModel, make_pnn
from .snn import (
    DaePretrainer,
    FieldSampling,
    RbmPretrainer,
    SNNModel,
    field_sampling,
    init_pretrain_dense,
    make_snn,
    sample_negatives,
)

__all__ = ["MlpSpec", "apply_model", "init_mlp", "lazy_l2",
           "weighted_bce_with_logits", "DeepFMModel", "make_deepfm", "FMModel",
           "make_fm", "FNNModel", "make_fnn", "LRModel", "make_lr", "PNNModel",
           "make_pnn", "DaePretrainer", "FieldSampling", "RbmPretrainer", "SNNModel",
           "field_sampling", "init_pretrain_dense", "make_snn", "sample_negatives"]
