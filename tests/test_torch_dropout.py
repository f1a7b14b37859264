"""The port's dropout mask and the differentiable tower against the JAX package.

The mask must equal ``deepctr_tpu.ops.pallas.mlp._dropout_mask`` bit for
bit: the CUDA kernels compute the same hash, and ``chip_smoke.py`` holds
them against the plain versions tested here. The tower's forward and
gradients with dropout are held against JAX ``mlp_tower`` (the Pallas
kernels in interpret mode on the CPU, as tests/test_pallas.py runs them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepctr_torch.ops.kernels import mlp as mlp_k
from deepctr_tpu.ops.pallas import mlp_tower
from deepctr_tpu.ops.pallas.mlp import _dropout_mask

# f32 on both sides; only the summation order differs (test_pallas.py:184)
RTOL, ATOL = 1e-4, 1e-5
DIMS = (48, 40, 24, 1)


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


def _torch_layers(layers, requires_grad=False):
    return [(torch.tensor(l["w"], requires_grad=requires_grad),
             torch.tensor(l["b"], requires_grad=requires_grad)) for l in layers]


@pytest.mark.parametrize("seed", [0, 11, (1 << 24) - 1])
@pytest.mark.parametrize("keep", [0.5, 0.7, 0.9])
def test_mask_is_bit_identical_to_jax(keep, seed):
    for layer in range(4):
        for row0 in (0, 512):
            want = np.asarray(_dropout_mask((96, 40), keep, jnp.int32(seed),
                                            layer, row0))
            got = mlp_k.dropout_mask_plain((96, 40), keep, seed, layer, row0).numpy()
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_mask_threshold_and_scale_are_the_references():
    """The kernels get the threshold as a uint32 computed in double and the
    scale as the f32 quotient 1/f32(keep), exactly the reference's."""
    for dropout in (0.5, 0.3, 0.1):
        threshold, scale = mlp_k.dropout_params(dropout)
        keep = 1.0 - dropout
        assert threshold == int(keep * 0xFFFFFFFF)
        want = np.asarray(_dropout_mask((64, 64), keep, jnp.int32(5), 0, 0))
        assert np.float32(scale) == want.max()
        assert set(np.unique(want)) == {0.0, np.float32(scale)}


def test_keep_rate_on_a_rigged_tower():
    """W1 = 0, b1 = atanh(0.5): every hidden activation is 0.5; W2 = ones,
    b2 = 0: logit = (0.5/keep) * kept units. 128 x 64 draws x 8 seeds pin
    the keep rate to about 1% at 3 sigma (test_pallas.py:134-152)."""
    h1, keep = 64, 0.5
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(128, 48))
                         .astype(np.float32))
    rig = [(torch.zeros(48, h1), torch.full((h1,), float(np.arctanh(0.5)))),
           (torch.ones(h1, 1), torch.zeros(1))]
    tot = 0.0
    for s in range(8):
        tot += mlp_k.mlp_tower_plain(x, rig, "tanh", 1 - keep, 100 + s).mean().item()
    keep_rate = (tot / 8) * keep / (0.5 * h1)
    assert abs(keep_rate - keep) < 0.015, keep_rate


@pytest.mark.parametrize("batch", [128, 100])
@pytest.mark.parametrize("activation", ["tanh", "relu", "sigmoid"])
def test_tower_with_dropout_matches_jax(activation, batch):
    """Forward and gradients (gx, gW, gb) of the port's differentiable
    tower against JAX ``mlp_tower`` with the same dropout and seed."""
    drop, seed = 0.5, 11
    layers = _params(seed=batch)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(batch, DIMS[0])).astype(np.float32)
    up = rng.normal(size=batch).astype(np.float32)
    jmlp = {"layers": [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]}

    def jloss(m, x_):
        return (mlp_tower(m, x_, activation, None, drop, float(seed)) * up).sum()

    want = np.asarray(mlp_tower(jmlp, jnp.asarray(x), activation, None, drop,
                                float(seed)))
    jgm, jgx = jax.grad(jloss, argnums=(0, 1))(jmlp, jnp.asarray(x))

    tx = torch.tensor(x, requires_grad=True)
    tl = _torch_layers(layers, requires_grad=True)
    out = mlp_k.mlp_tower(tx, tl, activation, drop, seed)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    (out * torch.from_numpy(up)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=RTOL, atol=ATOL)
    for (w, b), jl in zip(tl, jgm["layers"], strict=True):
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(jl["w"]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(jl["b"]),
                                   rtol=RTOL, atol=ATOL)


def test_same_seed_same_output_other_seed_other_output():
    layers = _torch_layers(_params(seed=3))
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(64, DIMS[0]))
                         .astype(np.float32))
    a = mlp_k.mlp_tower(x, layers, "tanh", 0.5, 3)
    b = mlp_k.mlp_tower(x, layers, "tanh", 0.5, 3)
    c = mlp_k.mlp_tower(x, layers, "tanh", 0.5, 4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 1e-6
    assert (a - mlp_k.mlp_tower(x, layers, "tanh")).abs().max() > 1e-6


def test_backward_wrapper_takes_plain_path_on_cpu(monkeypatch):
    monkeypatch.setattr(mlp_k, "BWD_LAUNCHES", 0)
    monkeypatch.setattr(mlp_k, "DROPOUT_LAUNCHES", 0)
    layers = _torch_layers(_params(seed=5))
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(50, DIMS[0])).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=50).astype(np.float32))
    gx, grads = mlp_k.mlp_tower_bwd(x, layers, g, "tanh", 0.5, 9)
    want_gx, want = mlp_k.mlp_tower_bwd_plain(x, layers, g, "tanh", 0.5, 9)
    torch.testing.assert_close(gx, want_gx, rtol=0, atol=0)
    for (gw, gb), (ww, wb), (w, b) in zip(grads, want, layers, strict=True):
        assert gw.shape == w.shape and gb.shape == b.shape
        torch.testing.assert_close(gw, ww, rtol=0, atol=0)
        torch.testing.assert_close(gb, wb, rtol=0, atol=0)
    mlp_k.mlp_tower_fwd(x, layers, "tanh", 0.5, 9)
    assert mlp_k.BWD_LAUNCHES == 0 and mlp_k.DROPOUT_LAUNCHES == 0


def test_backward_wrapper_raises_off_cpu_and_cuda():
    layers = [(w.to("meta"), b.to("meta")) for w, b in _torch_layers(_params(7))]
    x = torch.zeros(8, DIMS[0], device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        mlp_k.mlp_tower_bwd(x, layers, torch.zeros(8, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        mlp_k.mlp_tower_fwd(x, layers, "tanh", 0.5, 1)


@pytest.mark.parametrize("dropout, seed", [(1.0, 0), (-0.1, 0), (0.5, 1 << 24),
                                           (0.5, -1)])
def test_dropout_argument_checks(dropout, seed):
    layers = _torch_layers(_params(seed=8))
    with pytest.raises(ValueError):
        mlp_k._check_args(torch.zeros(8, DIMS[0]), layers, "tanh", dropout, seed)
