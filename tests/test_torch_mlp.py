"""The port's fused-tower wrapper and plain tower vs the JAX package.

Same numpy inputs through JAX ``mlp_tower`` (the Pallas kernel in interpret
mode on the CPU, as tests/test_pallas.py runs it), JAX ``apply_mlp`` and the
port. The CUDA kernel itself runs only on a card: ``chip_smoke.py`` holds it
against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepctr_torch.ops.kernels import _build
from deepctr_torch.ops.kernels import mlp as mlp_k
from deepctr_tpu.models.base import MlpSpec, apply_mlp
from deepctr_tpu.ops.pallas import mlp_tower

# f32 on both sides; only the summation order differs (test_pallas.py:54)
RTOL, ATOL = 1e-4, 1e-5
DIMS = (24, 32, 16, 1)


def _params(seed, dims=DIMS):
    rng = np.random.default_rng(seed)
    layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        lim = np.sqrt(6.0 / (d_in + d_out))
        layers.append({
            "w": rng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32),
            "b": rng.normal(0.0, 0.1, d_out).astype(np.float32),
        })
    return layers


def _torch_layers(layers):
    return [(torch.from_numpy(l["w"]), torch.from_numpy(l["b"])) for l in layers]


@pytest.mark.parametrize("batch", [128, 100])
@pytest.mark.parametrize("activation", ["tanh", "relu", "sigmoid"])
def test_tower_matches_jax(activation, batch):
    layers = _params(seed=batch)
    x = np.random.default_rng(1).normal(size=(batch, DIMS[0])).astype(np.float32)
    jmlp = {"layers": [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]}
    spec = MlpSpec(hidden=DIMS[1:-1], activation=activation, dropout=0.0)
    want_kernel = np.asarray(mlp_tower(jmlp, jnp.asarray(x), activation))
    want_plain = np.asarray(apply_mlp(jmlp, jnp.asarray(x), spec, train=False))

    got = mlp_k.mlp_tower_plain(torch.from_numpy(x), _torch_layers(layers),
                                activation).numpy()
    np.testing.assert_allclose(got, want_kernel, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_plain, rtol=RTOL, atol=ATOL)


def test_wrapper_takes_plain_path_on_cpu(monkeypatch):
    monkeypatch.setattr(mlp_k, "LAUNCHES", 0)
    layers = _torch_layers(_params(seed=3))
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(100, DIMS[0]))
                         .astype(np.float32))
    got = mlp_k.mlp_tower_fwd(x, layers, "tanh")
    torch.testing.assert_close(got, mlp_k.mlp_tower_plain(x, layers, "tanh"),
                               rtol=0, atol=0)
    assert got.shape == (100,)
    assert mlp_k.LAUNCHES == 0


def test_wrapper_raises_off_cpu_and_cuda():
    """No silent fallback: a tensor that is not on the CPU never takes the
    plain path (a CUDA tensor launches the kernel or raises)."""
    layers = [(w.to("meta"), b.to("meta")) for w, b in _torch_layers(_params(4))]
    with pytest.raises(ValueError, match="cpu or cuda"):
        mlp_k.mlp_tower_fwd(torch.zeros(8, DIMS[0], device="meta"), layers)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.compile_library(str(tmp_path / "kernels"))
    assert not (tmp_path / "kernels").exists()


@pytest.mark.parametrize("case", ["dtype", "contiguous", "chain", "bias",
                                  "activation", "depth"])
def test_kernel_argument_checks(case):
    """What the wrapper checks before a launch (on the card it is the only
    guard in front of raw pointers)."""
    layers = _torch_layers(_params(seed=5))
    x = torch.zeros(8, DIMS[0])
    activation = "tanh"
    if case == "dtype":
        x = x.double()
    elif case == "contiguous":
        x = torch.zeros(DIMS[0], 8).t()
    elif case == "chain":
        layers = layers[1:]
    elif case == "bias":
        layers[0] = (layers[0][0], layers[0][1][:-1].contiguous())
    elif case == "activation":
        activation = "gelu"
    else:
        layers = _torch_layers(_params(seed=5, dims=(DIMS[0],) * 9 + (1,)))
    with pytest.raises((TypeError, ValueError)):
        mlp_k._check_args(x, layers, activation)
    mlp_k._check_args(torch.zeros(8, DIMS[0]), _torch_layers(_params(seed=5)), "tanh")
