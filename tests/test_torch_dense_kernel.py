"""The dense layers' backward products (``ops/kernels/dense.py``,
``csrc/dense_bwd.cu``) on the CPU: the 3xTF32 split's arithmetic, the shape
rule at DLRM-DCNv2's widths, the slice rule, the CPU route of ``_Linear``
bit for bit as the plain products give it, and the counters. The kernel
itself runs only on the card: ``test_kernel_on_the_card`` is marked
``card`` and skips here."""

import math

import numpy as np
import pytest
import torch

import test_torch_tf32x3 as tf32x3
from deepctr_torch.data import FieldSpec, Schema
from deepctr_torch.models import make_dlrm_dcnv2
from deepctr_torch.ops import kernels, layers
from deepctr_torch.ops.kernels import dense

BATCH = 8192   # the benchmark cell's
SMS = 132      # an H100's

# products [m, n] over k at the cell's widths, scaled down: (form, m, k, n)
# with the batch 512 (input gradients) or 1024 (weight gradients)
SCALED = {
    "gx bottom": ("gx", 512, 256, 512),
    "gx cross v": ("gx", 512, 512, 3456),
    "gx cross w": ("gx", 512, 3456, 512),
    "gx top": ("gx", 512, 1024, 3456),
    "gw cross v": ("gw", 3456, 1024, 512),
    "gw top": ("gw", 1024, 1024, 1024),
}
# the stated multiple: the 3-term product's error over the f32 product's
# (the split drops lo.lo, some 2^-21 of a product); single-pass TF32 misses
# by orders of magnitude more
F32_MULTIPLE = 2.0
TF32_MULTIPLE = 100.0


def _operands(form, m, k, n, seed):
    """``(a [m, k], b [k, n])`` as the backward meets them: a gradient of
    mixed signs, Glorot weights, ReLU'd activations."""
    gen = torch.Generator().manual_seed(seed)
    if form == "gx":   # g [B, out] . w [in, out]^T
        g = torch.randn(m, k, generator=gen) * 1e-4
        w = torch.randn(n, k, generator=gen) * math.sqrt(2.0 / (n + k))
        return g, w.t()
    x = torch.relu(torch.randn(k, m, generator=gen))   # x [B, in]^T . g [B, out]
    g = torch.randn(k, n, generator=gen) * 1e-4
    return x.t(), g


def _rel(c, want):
    return float((c.double() - want).norm() / want.norm())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("values", ["normal", "wide", "special"])
def test_split_is_the_tower_kernels_split(values, seed):
    gen = np.random.default_rng(seed)
    if values == "normal":
        x = gen.normal(0.0, 1.0, 4096)
    elif values == "wide":
        x = gen.normal(0.0, 1.0, 4096) * np.exp2(gen.integers(-120, 120, 4096))
    else:
        big = np.finfo(np.float32).max
        x = np.array([np.inf, -np.inf, big, -big, np.nextafter(big, 0), 0.0, -0.0, 1e-45,
                      -1e-40, 1.0 + 2.0**-11, 1.0 - 2.0**-12, 65504.0, 3.0e38])
    x = x.astype(np.float32)
    hi, lo = dense.split_tf32(torch.from_numpy(x))
    want_hi, want_lo = tf32x3.split(x)
    assert np.array_equal(hi.numpy().view(np.uint32), want_hi.view(np.uint32))
    assert np.array_equal(lo.numpy().view(np.uint32), want_lo.view(np.uint32))


@pytest.mark.parametrize("case", list(SCALED))
def test_three_term_product_against_float64(case):
    a, b = _operands(*SCALED[case], seed=7)
    want = a.double() @ b.double()
    ah, al = dense.split_tf32(a)
    bh, bl = dense.split_tf32(b)
    three = (al @ bh + ah @ bl) + ah @ bh
    f32, tf32 = _rel(a @ b, want), _rel(ah @ bh, want)
    err = _rel(three, want)
    assert err <= F32_MULTIPLE * f32, (err, f32)
    assert tf32 >= TF32_MULTIPLE * err, (tf32, err)


def _dlrm_products(batch):
    """``(form, m, n, k, operands contiguous and f32)`` of every backward
    product of one DLRM-DCNv2 step at MLPerf's widths (small tables), in the
    order ``_Linear`` calls them, at a CPU batch of ``batch``."""
    schema = Schema(tuple(FieldSpec(f"C{i}", 5, 1 + i % 3) for i in range(26)))
    model = make_dlrm_dcnv2(schema, device="cpu")
    gen = torch.Generator().manual_seed(0)
    model.init_parameters(gen, schema.pad_id)
    ids = torch.randint(0, schema.padded_vocab_size - 1, (batch, schema.num_slots),
                        generator=gen)
    dense_x = torch.rand(batch, 13, generator=gen) * 10
    seen = []
    real = dense.input_grad, dense.weight_grad

    def record_gx(g, w):
        seen.append(("gx", g.shape[0], w.shape[0], g.shape[1],
                     all(t.is_contiguous() and t.dtype == torch.float32 for t in (g, w))))
        return real[0](g, w)

    def record_gw(x, g):
        seen.append(("gw", x.shape[1], g.shape[1], x.shape[0],
                     all(t.is_contiguous() and t.dtype == torch.float32 for t in (x, g))))
        return real[1](x, g)

    dense.input_grad, dense.weight_grad = record_gx, record_gw
    try:
        rows = model.table[ids]
        logits = model.apply_rows(rows, (ids != schema.pad_id).float(), dense=dense_x)
        logits.sum().backward()
    finally:
        dense.input_grad, dense.weight_grad = real
    return seen


def test_shape_rule_sends_24_of_a_steps_27_products_to_the_kernel():
    # a CPU batch of 256 takes the routes 8192 does (both multiples of 128)
    seen = _dlrm_products(256)
    assert len(seen) == 27
    assert all(ok for *_, ok in seen)
    routes = []
    for form, m, n, k, _ in seen:
        m, k = (BATCH, k) if form == "gx" else (m, BATCH)
        routes.append((form, m, n, k, dense.takes(m, n, k)))
    library = [r[:4] for r in routes if not r[4]]
    # the top's last layer (backward runs from the top down), the bottom's first
    assert library == [("gx", BATCH, 256, 1), ("gw", 256, 1, BATCH), ("gw", 13, 512, BATCH)]
    flop = sum(2 * m * n * k for _, m, n, k, kernel in routes if kernel)
    assert len(routes) - len(library) == 24 and flop == 525_059_751_936


@pytest.mark.parametrize("m,n,k,want", [
    (BATCH, 3456, 512, 1), (BATCH, 512, 3456, 1), (3456, 512, BATCH, 6),
    (512, 3456, BATCH, 6), (3456, 1024, BATCH, 3), (1024, 1024, BATCH, 2),
    (1024, 512, BATCH, 4), (512, 256, BATCH, 16), (256, 128, BATCH, 32),
])
def test_slices_at_the_cells_shapes(m, n, k, want):
    assert dense.slices(m, n, k, SMS) == want


def test_slices_keep_whole_stages_in_every_slice():
    for m in (128, 384, 1024, 3456, 8192):
        for n in (128, 512, 3456):
            for k in (32, 96, 256, 1024, 8192, 65536):
                s = dense.slices(m, n, k, SMS)
                assert 1 <= s <= dense.MAX_SLICES and s <= k // dense.DEPTH
                assert s == 1 or k // dense.DEPTH // s >= dense.MIN_SLICE_BLOCKS


@pytest.mark.parametrize("m,n,k,want", [
    (128, 128, 32, True), (8192, 3456, 512, True), (13, 512, 8192, False),
    (8192, 256, 1, False), (256, 1, 8192, False), (192, 128, 32, False),
    (128, 128, 48, False), (0, 128, 32, False),
])
def test_shape_rule(m, n, k, want):
    assert dense.takes(m, n, k) is want


@pytest.mark.parametrize("relu,bias", [(False, False), (True, True), (True, False)])
def test_cpu_route_gives_the_plain_products_bit_for_bit(relu, bias):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(256, 384, generator=gen, requires_grad=True)
    w = torch.randn(384, 128, generator=gen, requires_grad=True)
    b = torch.randn(128, generator=gen, requires_grad=True) if bias else None
    g = torch.randn(256, 128, generator=gen)
    before = kernels.launch_counts()
    layers.linear(x, w, b, relu=relu).backward(g)
    assert kernels.launch_counts() == before   # the CPU counts in neither counter
    y = torch.addmm(b.detach(), x.detach(), w.detach()) if bias else x.detach() @ w.detach()
    gz = g * (y > 0).float() if relu else g
    assert torch.equal(x.grad, gz @ w.detach().t())
    assert torch.equal(w.grad, x.detach().t() @ gz)
    if bias:
        assert torch.equal(b.grad, gz.sum(0))


def test_counters_are_launch_counts():
    counts = kernels.launch_counts()
    assert "dense.BWD_LAUNCHES" in counts and "dense.BWD_LIBRARY" in counts
    assert counts["dense.BWD_LAUNCHES"] == dense.BWD_LAUNCHES
    assert counts["dense.BWD_LIBRARY"] == dense.BWD_LIBRARY


@pytest.mark.card
@pytest.mark.parametrize("case", list(SCALED))
def test_kernel_on_the_card(case):
    """The kernel against float64 within the stated multiple of cuBLAS f32's
    error, and the same bits on a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    dev = torch.device("cuda", torch.cuda.current_device())
    form, m, k, n = SCALED[case]
    a, b = (t.to(dev) for t in _operands(form, m, k, n, seed=11))
    want = a.double() @ b.double()
    launches = dense.BWD_LAUNCHES
    if form == "gx":   # g [m, k], w [n, k]
        g, w = a.contiguous(), b.t().contiguous()
        got, again = dense.input_grad(g, w), dense.input_grad(g, w)
    else:              # x [k, m], g [k, n]
        x, g = a.t().contiguous(), b.contiguous()
        got, again = dense.weight_grad(x, g), dense.weight_grad(x, g)
    torch.cuda.synchronize()
    assert dense.BWD_LAUNCHES == launches + 2
    held = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f32 = _rel(a @ b, want)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = held
    assert _rel(got, want) <= F32_MULTIPLE * f32
    assert torch.equal(got, again)
