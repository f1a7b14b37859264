"""Why the tower kernels split every operand into two TF32 halves.

The tower kernels (``deepctr_torch/csrc/tower_tile.cuh``) run their products
on Hopper's tensor cores with TF32 operands, which keep 10 of f32's 23
mantissa bits. Each operand x is split into ``hi = tf32(x)`` and
``lo = tf32(x - hi)``, rounded to nearest as ``cvt.rna.tf32.f32`` does, and
a product is ``lo.hi + hi.lo + hi.hi`` accumulated in f32 ("3xTF32").

This test emulates that product in numpy, pushes FNN's tower (176-200-300-
100-1, tanh) and its gradients through it, and holds them to a float64
tower within the tolerances ``chip_smoke.py`` holds the kernels to. A
single TF32 product (operands rounded once) misses them, which is why the
split exists.
"""

import os
import sys

import numpy as np
import pytest
import torch

from deepctr_torch.ops.kernels.mlp import dropout_mask_plain

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (tolerances only; it imports no torch at the top)

DIMS = (176, 200, 300, 100, 1)
BATCH = 512
SEED = 12345


def tf32(x: np.ndarray) -> np.ndarray:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def matmul(a: np.ndarray, b: np.ndarray, mode: str) -> np.ndarray:
    """``a @ b`` in f32 arithmetic: plain f32, one TF32 product, or 3xTF32."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if mode == "f32":
        return a @ b
    ah, bh = tf32(a), tf32(b)
    if mode == "tf32":
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def tower(x, layers, g, masks, mm):
    """Logits and gradients (gx, [(gW, gb)]) of a tanh tower whose every
    product is ``mm``; the elementwise work is in the arrays' own type."""
    acts, tanhs = [x], [None]
    h = x
    for i, (w, b) in enumerate(layers[:-1]):
        tanhs.append(np.tanh(mm(h, w) + b))
        h = tanhs[-1] * masks[i]
        acts.append(h)
    w, b = layers[-1]
    logits = (mm(h, w) + b)[:, 0]
    gh = np.zeros((x.shape[0], w.shape[1]), x.dtype)
    gh[:, 0] = g
    ones = np.ones((1, x.shape[0]), x.dtype)
    grads = []
    for i in range(len(layers) - 1, -1, -1):
        grads.append((mm(acts[i].T, gh), mm(ones, gh)[0]))
        back = mm(gh, layers[i][0].T)
        if i > 0:
            back = back * masks[i - 1] * (1 - tanhs[i] * tanhs[i])
        gh = back
    return logits, gh, grads[::-1]


def _inputs(dropout):
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(BATCH, DIMS[0])).astype(np.float32)
    g = rng.normal(size=BATCH).astype(np.float32)
    layers = []
    for d_in, d_out in zip(DIMS[:-1], DIMS[1:]):
        lim = np.sqrt(6.0 / (d_in + d_out))
        layers.append((rng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32),
                       rng.normal(0.0, 0.1, d_out).astype(np.float32)))
    masks = [np.ones((BATCH, d), np.float32) if dropout == 0.0 else
             dropout_mask_plain((BATCH, d), 1.0 - dropout, 77, i).numpy()
             for i, d in enumerate(DIMS[1:-1])]
    return x, layers, g, masks


def _errors(mode, dropout):
    """Per output: (max |err| beyond its tolerance, max |err|) against the
    float64 tower; the first is <= 0 where the tolerance holds."""
    x, layers, g, masks = _inputs(dropout)
    ref = tower(x.astype(np.float64), [(w.astype(np.float64), b.astype(np.float64))
                                       for w, b in layers],
                g.astype(np.float64), [m.astype(np.float64) for m in masks],
                lambda a, b: a @ b)
    got = tower(x, layers, g, masks, lambda a, b: matmul(a, b, mode))
    out = {}

    def close(name, a, want):
        err = np.abs(a.astype(np.float64) - want)
        out[name] = (float((err - chip_smoke.ATOL - chip_smoke.RTOL * np.abs(want)).max()),
                     float(err.max()))

    def grad(name, a, want):
        err = np.abs(a.astype(np.float64) - want)
        out[name] = (float((err - chip_smoke.GRAD_REL * np.abs(want).max()).max()),
                     float(err.max()))

    close("logits", got[0], ref[0])
    close("gx", got[1], ref[1])
    for i, ((gw, gb), (rw, rb)) in enumerate(zip(got[2], ref[2])):
        grad(f"gW{i}", gw, rw)
        grad(f"gb{i}", gb, rb)
    return out


def test_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10
    x = np.array([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2 ** -23, -(1.0 + ulp / 2),
                  1.0 + 1.5 * ulp, 3.0e-3], np.float32)
    want = np.array([1.0, 1.0 + ulp, 1.0, -(1.0 + ulp), 1.0 + 2 * ulp, 0.0], np.float64)
    got = tf32(x).astype(np.float64)
    np.testing.assert_array_equal(got[:5], want[:5])
    assert abs(got[5] - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    assert np.all((tf32(x).view(np.uint32) & np.uint32(0x1FFF)) == 0)


@pytest.mark.parametrize("dropout", [0.0, 0.5])
@pytest.mark.parametrize("mode", ["tf32x3", "f32"])
def test_product_meets_the_kernel_tolerances(mode, dropout):
    errors = _errors(mode, dropout)
    over = {k: v for k, v in errors.items() if v[0] > 0}
    assert not over, over


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_single_tf32_product_misses_them(dropout):
    errors = _errors("tf32", dropout)
    assert errors["logits"][0] > 0 and errors["gx"][0] > 0, errors
    assert any(v[0] > 0 for k, v in errors.items() if k.startswith("gW")), errors
    # and it is the split that closes the gap, by orders of magnitude
    split = _errors("tf32x3", dropout)
    assert split["logits"][1] < errors["logits"][1] / 100, (split, errors)


def test_torch_agrees_with_the_emulated_f32_tower():
    """The emulation's f32 tower is the plain version's arithmetic."""
    from deepctr_torch.ops.kernels.mlp import mlp_tower_plain

    x, layers, g, masks = _inputs(0.0)
    want = tower(x, layers, g, masks, lambda a, b: matmul(a, b, "f32"))[0]
    got = mlp_tower_plain(torch.from_numpy(x), [(torch.from_numpy(w), torch.from_numpy(b))
                                                for w, b in layers], "tanh")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
