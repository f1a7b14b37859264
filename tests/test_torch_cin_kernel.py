"""The CIN's kernel (``ops/kernels/cin.py``, ``csrc/cin.cu``) on the CPU: the
wrapper's checks, its refusal of CPU tensors, ``ops/cin.py``'s CPU route
bit for bit as the plain version gives it, the split rules at the benchmark
cell's widths, and the launch counter. The kernel itself runs only on the
card: the tests marked ``card`` skip here and compare each of its three
forms with float64 and with ``ops/cin.py``'s plain version in f32 (TF32
off) there."""

import math

import pytest
import torch

from deepctr_torch.ops import cin as cin_op
from deepctr_torch.ops import kernels
from deepctr_torch.ops.kernels import cin as cin_k

SMS = 132        # an H100's
ROWS = 40960     # the cell's B·D: 4096 examples of D = 10
FIELDS = 39      # Criteo's m


def _factors(rows, h_in, m, h_out, seed=0, device="cpu"):
    """``(x, x0, w, g)`` as a CIN layer meets them: factors of a trained
    scale, weights of ``1/sqrt(H·m)``, an upstream gradient of mixed signs."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = 0.5 * torch.randn(rows, h_in, generator=gen, device=device)
    x0 = 0.5 * torch.randn(rows, m, generator=gen, device=device)
    w = torch.randn(h_in * m, h_out, generator=gen, device=device) / math.sqrt(h_in * m)
    g = 1e-3 * torch.randn(rows, h_out, generator=gen, device=device)
    return x, x0, w, g


def _bad(what):
    x, x0, w, g = _factors(64, 6, 5, 6)
    args = {"x": x, "x0": x0, "w": w, "g": g, "g_x0": torch.zeros(64, 5)}
    h_out, max_out = 6, cin_k.MAX_DEPTH
    if what == "dtype":
        args["x"] = x.double()
    elif what == "x0 not contiguous":
        args["x0"] = torch.zeros(5, 64).t()
    elif what == "w not contiguous":
        args["w"] = torch.zeros(6, 30).t()
    elif what == "too many fields":
        x0 = torch.zeros(64, cin_k.MAX_FIELDS + 1)
        args.update(x0=x0, w=torch.zeros(6 * x0.shape[1], 6), g_x0=torch.zeros_like(x0))
    elif what == "too many maps out":
        h_out = cin_k.MAX_DEPTH + 1
        args.update(w=torch.zeros(30, h_out), g=torch.zeros(64, h_out))
    elif what == "w rows":
        args["w"] = torch.zeros(31, 6)
    elif what == "g rows":
        args["g"] = torch.zeros(63, 6)
    elif what == "a vector":
        args["g_x0"] = torch.zeros(64 * 5)
    elif what == "empty":
        args.update(x=torch.zeros(0, 6), x0=torch.zeros(0, 5), g=torch.zeros(0, 6),
                    g_x0=torch.zeros(0, 5))
    return h_out, max_out, args


@pytest.mark.parametrize("what", ["dtype", "x0 not contiguous", "w not contiguous",
                                  "too many fields", "too many maps out", "w rows", "g rows",
                                  "a vector", "empty"])
def test_the_checks_raise_on_what_the_kernel_does_not_take(what):
    h_out, max_out, args = _bad(what)
    with pytest.raises((TypeError, ValueError)):
        cin_k.check_args("cin", h_out, max_out, **args)


def test_the_checks_pass_the_cells_widths():
    x, x0, w, g = _factors(128, 200, FIELDS, 200)
    cin_k.check_args("cin", 200, cin_k.MAX_DEPTH, x=x, x0=x0, w=w, g=g,
                     g_x0=torch.zeros_like(x0))
    cin_k.check_args("cin", cin_k.MAX_DEPTH + 8, None, x=x, x0=x0)   # the forward's H_k: any


ENTRIES = {"forward": lambda x, x0, w, g, g_x0: cin_k.forward(x, x0, w),
           "weight_grad": lambda x, x0, w, g, g_x0: cin_k.weight_grad(x, x0, g),
           "operand_grad": cin_k.operand_grad,
           "layer_grads": cin_k.layer_grads}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_the_wrappers_take_cuda_tensors_only(entry):
    """CPU tensors go to ``ops/cin.py``'s plain version, never to the
    wrapper: it raises on them, launching nothing and changing nothing."""
    x, x0, w, g = _factors(64, 6, 5, 6)
    g_x0 = torch.ones_like(x0)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ENTRIES[entry](x, x0, w, g, g_x0)
    assert kernels.launch_counts() == before
    assert torch.equal(g_x0, torch.ones_like(x0))


def test_the_cins_cpu_route_gives_the_plain_bits():
    """``cin`` on CPU tensors: the forward and every gradient bit for bit as
    the plain layers give them (``outer`` and the product, ``layer_grads``),
    its nine products counted, no kernel launch."""
    b, d, m, maps = 6, 4, 5, (7, 7, 3)
    gen = torch.Generator().manual_seed(9)
    x0 = torch.randn(b, d, m, generator=gen)
    widths = (m,) + maps
    weights = [torch.randn(a * m, h, generator=gen) for a, h in zip(widths[:-1], widths[1:])]
    gp = torch.randn(b, sum(maps), generator=gen)
    leaves = [x0.requires_grad_(True)] + [w.requires_grad_(True) for w in weights]
    before = kernels.launch_counts()
    got_y = cin_op.cin(x0, weights)
    got = torch.autograd.grad(got_y, leaves, gp)
    delta = kernels.count_difference(kernels.launch_counts(), before)
    r0 = x0.detach().reshape(b * d, m)
    xs, pooled = [r0], []
    for w in weights:
        xs.append(cin_op.outer(xs[-1], r0) @ w.detach())
        pooled.append(xs[-1].view(b, d, -1).sum(1))
    assert torch.equal(got_y, torch.cat(pooled, 1))
    g_x0, g_ws, g_x, end = torch.zeros_like(r0), [None] * 3, None, sum(maps)
    for k in reversed(range(3)):
        h = maps[k]
        g = gp[:, end - h:end][:, None, :].expand(b, d, h)
        g = (g if g_x is None else g + g_x.view(b, d, h)).reshape(b * d, h)
        g_x, part, g_ws[k] = cin_op.layer_grads(xs[k], r0, weights[k].detach(), g)
        g_x0 += part
        end -= h
    g_x0 += g_x
    assert torch.equal(got[0], g_x0.view(b, d, m))
    for a, e in zip(got[1:], g_ws):
        assert torch.equal(a, e)
    assert delta["cin_kernel.LAUNCHES"] == 0 and delta["cin.PRODUCTS"] == 9
    assert delta["cin.OUTER_BYTES"] == cin_op.outer_bytes(b, d, m, maps)


def test_the_launch_counter_is_a_kernel_counter():
    """``cin_kernel.LAUNCHES`` is read by name, and a graph's way with it (take
    back what the capture counted, add it at each replay) leaves it at one
    replay's launches."""
    assert "cin_kernel.LAUNCHES" in kernels.COUNTERS
    before = kernels.launch_counts()
    assert before["cin_kernel.LAUNCHES"] == cin_k.LAUNCHES
    cin_k.LAUNCHES += 9 * 8                        # a capture of 8 steps
    captured = kernels.count_difference(kernels.launch_counts(), before)
    kernels.add_launch_counts({key: -n for key, n in captured.items()})
    assert kernels.launch_counts() == before
    kernels.add_launch_counts(captured)            # a replay
    try:
        assert cin_k.LAUNCHES == before["cin_kernel.LAUNCHES"] + 72
    finally:
        kernels.add_launch_counts({key: -n for key, n in captured.items()})


@pytest.mark.parametrize("h_in,want", [(FIELDS, 5), (200, 1)])
def test_the_weight_gradients_slices_at_the_cells_widths(h_in, want):
    """The first layer's 26 tiles cut 5 ways (130 units on 132 SMs); the
    others' 126 tiles left whole."""
    s = cin_k.slices(ROWS, h_in, 200, SMS)
    assert s == want
    tiles = math.ceil(h_in * cin_k.MAX_FIELDS / cin_k.TILE_M) * math.ceil(200 / cin_k.TILE_N)
    assert tiles * s <= SMS


@pytest.mark.parametrize("h_in,want", [(FIELDS, 2), (200, 2)])
def test_the_operand_gradients_chunks_at_the_cells_widths(h_in, want):
    """320 row tiles: two chunks make 640 units, five waves of 132 (97% of
    them full) where one chunk fills 2.4."""
    assert cin_k.chunks(ROWS, h_in, 200, FIELDS, SMS) == want


@pytest.mark.parametrize("rows,h_in,h_out", [(32, 1, 1), (33, 2, 7), (4096, 3, 250)])
def test_the_split_rules_stay_in_the_kernels_range(rows, h_in, h_out):
    for sms in (1, 7, SMS):
        assert 1 <= cin_k.slices(rows, h_in, h_out, sms) <= math.ceil(rows / cin_k.DEPTH)
        assert 1 <= cin_k.chunks(rows, h_in, h_out, 5, sms) <= math.ceil(h_in / 2)


# --- on the card -----------------------------------------------------------------

# (rows, maps in, fields, maps out): the cell's three layers, then ragged
# widths the tests' models use
CARD_SHAPES = {"criteo layer 1": (ROWS, FIELDS, FIELDS, 200),
               "criteo layer 2": (ROWS, 200, FIELDS, 200),
               "ragged tiny": (300, 7, 5, 6),
               "ragged": (1000, 13, FIELDS, 110)}
# the kernel's error against float64 over the plain version's in f32: the
# 3xTF32 split drops lo.lo, some 2^-21 of a product
F32_MULTIPLE = 2.0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CIN kernel has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _err(got, want):
    return float((got.double() - want).norm() / want.norm())


@pytest.mark.card
@pytest.mark.parametrize("case", list(CARD_SHAPES))
def test_each_form_on_the_card(case):
    """Each form against float64 within ``F32_MULTIPLE`` of the plain
    version's f32 error (or 1e-6), and the same bits on a second call. The
    operand gradient adds X^0's part to a ``g_x0`` that starts from a
    random matrix of the part's scale."""
    dev = _card()
    x, x0, w, g = _factors(*CARD_SHAPES[case], seed=5, device=dev)
    xd, x0d, wd, gd = (t.double() for t in (x, x0, w, g))
    want_x, want_part, want_w = cin_op.layer_grads(xd, x0d, wd, gd)
    plain_x, plain_part, plain_w = cin_op.layer_grads(x, x0, w, g)
    base = 1e-3 * torch.randn(x0.shape, generator=torch.Generator(device=dev).manual_seed(6),
                              device=dev)
    checks = {
        "forward": (lambda: cin_k.forward(x, x0, w), cin_op.outer(x, x0) @ w,
                    cin_op.outer(xd, x0d) @ wd),
        "weight_grad": (lambda: cin_k.weight_grad(x, x0, g), plain_w, want_w),
        "operand_grad g_x": (lambda: cin_k.operand_grad(x, x0, w, g, base.clone()), plain_x,
                             want_x),
    }
    for name, (fn, plain, want) in checks.items():
        got, again = fn(), fn()
        assert torch.equal(got, again), name
        assert _err(got, want) <= max(F32_MULTIPLE * _err(plain, want), 1e-6), name
    parts = [base.clone() for _ in range(2)]
    for p in parts:
        cin_k.operand_grad(x, x0, w, g, p)
    assert torch.equal(parts[0], parts[1])
    want = base.double() + want_part
    assert _err(parts[0], want) <= max(F32_MULTIPLE * _err(base + plain_part, want), 1e-6)
