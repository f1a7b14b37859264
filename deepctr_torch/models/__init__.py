"""Models of the port: LR, FM, FNN, SNN (with its DAE and RBM pretrainers),
DeepFM, PNN (IPNN/OPNN), DLRM-DCNv2, xDeepFM and HSTU."""

from .base import MlpSpec, apply_model, init_mlp, lazy_l2, weighted_bce_with_logits
from .deepfm import DeepFMModel, make_deepfm
from .dlrm import DLRMModel, make_dlrm_dcnv2
from .fm import FMModel, make_fm
from .fnn import FNNModel, make_fnn
from .hstu import HSTUModel, make_hstu
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
from .xdeepfm import XDeepFMModel, make_xdeepfm

__all__ = ["MlpSpec", "apply_model", "init_mlp", "lazy_l2",
           "weighted_bce_with_logits", "DeepFMModel", "make_deepfm", "DLRMModel",
           "make_dlrm_dcnv2", "FMModel",
           "make_fm", "FNNModel", "make_fnn", "LRModel", "make_lr", "PNNModel",
           "make_pnn", "DaePretrainer", "FieldSampling", "RbmPretrainer", "SNNModel",
           "field_sampling", "init_pretrain_dense", "make_snn", "sample_negatives",
           "XDeepFMModel", "make_xdeepfm", "HSTUModel", "make_hstu"]
