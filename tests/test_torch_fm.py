"""The port's FM scorer (wrapper, plain version, gradient), its interaction
oracle and the FM model against the JAX package.

Same numpy inputs through JAX ``fm_score`` (the Pallas kernel in interpret
mode on the CPU, as tests/test_pallas.py runs it), the JAX oracle
(``fm_interaction``) and the port. The CUDA kernel itself runs only on a
card: ``chip_smoke.py`` holds it against the plain version there.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deepctr_torch.models import apply_model as t_apply_model
from deepctr_torch.models import make_fm as t_make_fm
from deepctr_torch.ops import interaction as t_inter
from deepctr_torch.ops.kernels import interaction as fm_k
from deepctr_torch.utils import checkpoint as t_ckpt
from deepctr_tpu.data import make_schema, synthetic
from deepctr_tpu.models import FMModel, apply_model
from deepctr_tpu.ops.interaction import fm_interaction, fm_interaction_bruteforce
from deepctr_tpu.ops.pallas import fm_score
from deepctr_tpu.utils import checkpoint as j_ckpt

# f32 on both sides, sums in other orders; the reference's own tolerance for
# its kernel against the oracle (tests/test_pallas.py:26)
RTOL = ATOL = 1e-4
K = 3


def _rows(B, S, k, seed):
    """rows N(0, 1) and a mask with pad slots; example 0 is all pad."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(B, S, 1 + k)).astype(np.float32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    mask[:1] = 0.0
    return rows, mask


def _jax_oracle(rows, mask):
    r, m = jnp.asarray(rows), jnp.asarray(mask)
    return np.asarray((r[..., 0] * m).sum(axis=1) + fm_interaction(r[..., 1:], m))


@pytest.mark.parametrize("B,S,k", [(256, 7, 5), (100, 4, 3), (77, 18, 10), (0, 4, 3)],
                         ids=["256x7x5", "odd-100", "ipinyou-slots", "empty"])
def test_fm_score_matches_jax(B, S, k):
    """The port's plain version, its wrapper and its autograd Function on
    CPU tensors against the JAX oracle and, where it runs, the JAX kernel
    (the reference's kernel raises at B=0)."""
    rows, mask = _rows(B, S, k, seed=B + S)
    want = _jax_oracle(rows, mask)
    r, m = torch.from_numpy(rows), torch.from_numpy(mask)
    for got in (fm_k.fm_score_plain(r, m), fm_k.fm_score_fwd(r, m), fm_k.fm_score(r, m)):
        assert got.shape == (B,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    if B:
        assert fm_k.fm_score_plain(r, m)[0] == 0.0    # the all-pad example
        kernel = np.asarray(fm_score(jnp.asarray(rows), jnp.asarray(mask), k))
        np.testing.assert_allclose(fm_k.fm_score_plain(r, m).numpy(), kernel,
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_fm_interaction_matches_bruteforce_and_jax(masked):
    rows, mask = _rows(64, 9, 4, seed=3)
    v = rows[..., 1:]
    m = mask if masked else None
    tm = torch.from_numpy(mask) if masked else None
    got = t_inter.fm_interaction(torch.from_numpy(v), tm).numpy()
    brute = t_inter.fm_interaction_bruteforce(torch.from_numpy(v), tm).numpy()
    jm = jnp.asarray(m) if masked else None
    np.testing.assert_allclose(got, brute, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(fm_interaction(jnp.asarray(v), jm)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        brute, np.asarray(fm_interaction_bruteforce(jnp.asarray(v), jm)),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,S,k", [(128, 5, 3), (100, 18, 10)])
def test_fm_score_grad_matches_jax(B, S, k):
    """d/d rows of sum(fm_score^2) against the JAX custom VJP
    (tests/test_pallas.py:29-43) and autograd through the plain version."""
    rows, mask = _rows(B, S, k, seed=k)
    want = np.asarray(jax.grad(
        lambda r: (fm_score(r, jnp.asarray(mask), k) ** 2).sum())(jnp.asarray(rows)))
    r = torch.from_numpy(rows).requires_grad_(True)
    m = torch.from_numpy(mask)
    (got,) = torch.autograd.grad((fm_k.fm_score(r, m) ** 2).sum(), [r])
    (plain,) = torch.autograd.grad((fm_k.fm_score_plain(r, m) ** 2).sum(), [r])
    # the products with the upstream gradient grow the magnitudes: the
    # reference's grad test holds its kernel to 1e-3 (test_pallas.py:43)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-3, atol=1e-3)
    assert np.all(got.numpy()[mask == 0.0] == 0.0)   # pad slots get nothing


def test_mask_gets_no_gradient():
    rows, mask = _rows(8, 3, 2, seed=0)
    r = torch.from_numpy(rows).requires_grad_(True)
    m = torch.from_numpy(mask).requires_grad_(True)
    fm_k.fm_score(r, m).sum().backward()
    assert r.grad is not None and m.grad is None


def test_wrapper_takes_plain_path_on_cpu(monkeypatch):
    monkeypatch.setattr(fm_k, "LAUNCHES", 0)
    r, m = map(torch.from_numpy, _rows(50, 6, 4, seed=1))
    torch.testing.assert_close(fm_k.fm_score_fwd(r, m), fm_k.fm_score_plain(r, m),
                               rtol=0, atol=0)
    assert fm_k.LAUNCHES == 0


def test_wrapper_raises_off_cpu_and_cuda():
    """No silent fallback: a tensor that is not on the CPU never takes the
    plain path (a CUDA tensor launches the kernel or raises)."""
    with pytest.raises(ValueError, match="cpu or cuda"):
        fm_k.fm_score_fwd(torch.zeros(8, 3, 4, device="meta"),
                          torch.zeros(8, 3, device="meta"))


@pytest.mark.parametrize("case", ["dtype", "contiguous", "mask", "rank", "width",
                                  "device", "rows-misaligned", "mask-misaligned"])
def test_kernel_argument_checks(case):
    """What the wrapper checks before a launch (on the card it is the only
    guard in front of raw pointers)."""
    rows, mask = torch.zeros(8, 3, 1 + K), torch.zeros(8, 3)
    if case == "dtype":
        rows = rows.double()
    elif case == "contiguous":
        rows = torch.zeros(3, 8, 1 + K).transpose(0, 1)
    elif case == "mask":
        mask = torch.zeros(8, 4)
    elif case == "rank":
        rows = torch.zeros(8, 3 * (1 + K))
    elif case == "width":
        rows = torch.zeros(8, 3, fm_k.MAX_K + 2)
    elif case == "rows-misaligned":
        # contiguous, but a view that starts one float into its storage: the
        # kernel's bulk copies take 16-byte aligned addresses only
        rows = torch.zeros(8 * 3 * (1 + K) + 1)[1:].view(8, 3, 1 + K)
        assert rows.is_contiguous() and rows.data_ptr() % fm_k.ALIGN == 4
    elif case == "mask-misaligned":
        mask = torch.zeros(8 * 3 + 3)[3:].view(8, 3)
        assert mask.is_contiguous() and mask.data_ptr() % fm_k.ALIGN == 12
    else:
        mask = torch.zeros(8, 3, device="meta")
    with pytest.raises((TypeError, ValueError)):
        fm_k._check_args(rows, mask)
    fm_k._check_args(torch.zeros(8, 3, fm_k.MAX_K + 1), torch.zeros(8, 3))


def test_misaligned_view_is_taken_after_a_copy():
    """The refusal names the alignment; a clone of the view is aligned and
    passes, and the CPU path never needs it."""
    rows = torch.randn(8 * 3 * (1 + K) + 1)[1:].view(8, 3, 1 + K)
    mask = torch.ones(8, 3)
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        fm_k._check_args(rows, mask)
    fm_k._check_args(rows.clone(), mask)
    assert torch.equal(fm_k.fm_score_fwd(rows, mask), fm_k.fm_score_plain(rows, mask))


@pytest.fixture(scope="module")
def schema():
    return make_schema([("a", 4), ("b", 8), ("c", 16), ("tags", 10, 3)])


@pytest.mark.parametrize("use_pallas", [True, False])
def test_fm_model_matches_jax(schema, use_pallas):
    """From JAX's initial parameters, with a nonzero bias and linear column
    and a nonzero pad row (only the mask keeps pad slots out)."""
    jmodel = FMModel(k=K, use_pallas=use_pallas)
    params = jmodel.init_params(jax.random.PRNGKey(0), schema)
    rng = np.random.default_rng(5)
    table = np.asarray(params["table"]) + rng.normal(
        0.0, 0.3, params["table"].shape).astype(np.float32)
    dense = {"bias": np.float32(0.25)}
    ids = synthetic.generate(schema, num_examples=100, k=K, seed=4).ids
    assert (ids == schema.pad_id).any()
    want = np.asarray(apply_model(jmodel, {"table": jnp.asarray(table), "dense": dense},
                                  jnp.asarray(ids), schema.pad_id))
    model = t_make_fm(schema, k=K, device="cpu")
    model.load_state_dict(t_ckpt.params_from_jax(table, dense))
    with torch.no_grad():
        got = t_apply_model(model, torch.from_numpy(ids).long(), schema.pad_id)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_fm_init_parameters(schema):
    """The table normal with init_sigma, its linear column and pad row zero;
    the bias zero; the seed alone decides the draws."""
    def init(seed):
        model = t_make_fm(schema, k=K, init_sigma=0.01, device="cpu")
        model.init_parameters(torch.Generator().manual_seed(seed), schema.pad_id)
        return model

    a, b, c = init(1), init(1), init(2)
    assert torch.equal(a.table, b.table) and not torch.equal(a.table, c.table)
    table = a.table.detach().numpy()
    assert np.all(table[:, 0] == 0.0) and np.all(table[schema.pad_id] == 0.0)
    assert 0.005 < table[:, 1:].std() < 0.02
    assert float(a.bias.detach()) == 0.0


@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
def test_fm_table_file_is_read_by_both_packages(tmp_path, table_dtype):
    """``save_fm_embeddings`` writes the reference's format: the JAX reader
    takes the leaf as stored (uint16 bits for bf16, the reference's known
    fault, ROADMAP.md section 3), the port's decodes it."""
    table = np.random.default_rng(0).normal(0.0, 0.3, (7, 1 + K)).astype(np.float32)
    t = torch.from_numpy(table)
    if table_dtype == "bf16":
        t = t.to(torch.bfloat16)
        table = table.astype(ml_dtypes.bfloat16).astype(np.float32)
    path = str(tmp_path / "fm.ckpt.fm_table")
    t_ckpt.save_fm_embeddings(path, t)
    np.testing.assert_array_equal(t_ckpt.load_fm_embeddings(path), table)
    raw = j_ckpt.load_fm_embeddings(path)
    if table_dtype == "f32":
        np.testing.assert_array_equal(raw, table)
    else:
        assert raw.dtype == np.uint16
        np.testing.assert_array_equal(raw.view(ml_dtypes.bfloat16).astype(np.float32),
                                      table)
