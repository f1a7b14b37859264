"""deepctr_torch — the PyTorch/CUDA port of deepctr_tpu, for NVIDIA Hopper.

The JAX package ``deepctr_tpu`` stays the reference the port is held
against. This package imports ``torch`` and nothing of ``jax`` or of the
JAX package: it keeps its own copies of the reference's data layer
(``data/``) and run config (``config.py``). Its Pallas kernels become CUDA
C++ kernels under ``csrc/``, each with a plain PyTorch version beside it
(``ops/kernels/``).

Ported so far: FNN serving (``cli --score`` -> ``serving.Scorer`` ->
``models.fnn`` -> the fused tower forward kernel) and FNN training (``cli``
-> ``train.fit`` -> ``train.step`` -> ``optim`` and the tower's forward
kernel with in-kernel dropout and its backward kernel).
"""

__version__ = "0.1.0"
