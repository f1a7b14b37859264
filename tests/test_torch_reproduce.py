"""The port's evidence tools against the reference's, on the CPU.

``deepctr_torch.tools.reproduce`` (the counterpart of ``tools/reproduce.py``)
and ``tools/parity_report_torch.py`` (the counterpart of
``tools/parity_report.py``) at tiny sizes: the same protocol (configs, grids,
shapes), the same family table from both packages' suites, and parity rows
inside their bands. The full runs are made on the card (README).
"""

import contextlib
import importlib.util
import io
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

TINY = ["--models", "lr,fnn", "--examples", "4000", "--epochs", "1", "--batch", "256",
        "--no-tuned", "--no-convergence-study"]


def _family(path) -> dict:
    from deepctr_torch.utils.artifacts import float_or_none, parse_md_table

    with open(path) as f:
        text = f.read()
    start = text.index("### Model family (shared dataset")
    return {r["run"]: float_or_none(r["AUC"]) for r in parse_md_table(text[start:])}


@pytest.fixture(scope="module")
def suites(tmp_path_factory):
    """Both packages' suites at the tiny arguments (FNN adds FM's run first):
    ``(jax family {run: AUC}, port family, port main's return)``."""
    import reproduce as jax_reproduce

    from deepctr_torch.tools import reproduce

    tmp = tmp_path_factory.mktemp("reproduce")
    with contextlib.redirect_stdout(io.StringIO()):
        jax_reproduce.main(TINY + ["--out", str(tmp / "RESULTS.md")])
        res = reproduce.main(TINY + ["--device", "cpu", "--out", str(tmp / "RESULTS_TORCH.md")])
    return _family(tmp / "RESULTS.md"), _family(tmp / "RESULTS_TORCH.md"), res


def test_family_rows_match_the_reference_tool(suites):
    jax, port, res = suites
    assert list(port) == list(jax) == ["lr", "fm", "fnn"], (jax, port)
    assert [r["label"] for r in res["tables"]["family"]] == list(port)
    assert res["runs"] == 3 and res["seconds"] > 0


def test_lr_auc_matches_the_reference_tool(suites):
    """LR starts at zero in both packages (deepctr_tpu/models/lr.py:30-35,
    deepctr_torch/models/lr.py:20-25) and sees the same chunks: the same AUC
    (the table's 4 decimals)."""
    jax, port, _ = suites
    assert abs(port["lr"] - jax["lr"]) <= 1e-4, (jax, port)


# |port - JAX| AUC of this tiny run (3,400 rows, one epoch of 13 steps, near
# chance), measured over --seed 0, 1, 2: FM 0.0088, 0.0457, 0.0077; FNN
# 0.0107, 0.0099, 0.0027. The two packages draw their initial values from
# different generators by design; the band is the largest measured
# difference with a third more room
TINY_BAND = {"fm": 0.06, "fnn": 0.015}


@pytest.mark.parametrize("model", sorted(TINY_BAND))
def test_fm_fnn_auc_within_the_measured_band(suites, model):
    jax, port, _ = suites
    assert abs(port[model] - jax[model]) <= TINY_BAND[model], (model, jax, port)


@pytest.mark.parametrize("name", ["lr", "fm", "fnn", "snn_dae", "snn_rbm", "deepfm",
                                  "ipnn", "opnn"])
def test_model_config_matches_the_reference_tool(name):
    """Flag for flag: every model's run config, from the protocol's defaults,
    equals the reference tool's."""
    import reproduce as jax_reproduce

    from deepctr_torch.tools import reproduce

    args = reproduce.parse_args([])
    assert reproduce.model_config(name, args, "/c/fm.ckpt") == \
        jax_reproduce.model_config(name, args, "/c/fm.ckpt")


def test_grids_and_shapes_match_the_reference_tool():
    import reproduce as jax_reproduce

    from deepctr_torch.tools import reproduce

    assert reproduce.MODELS == jax_reproduce.MODELS
    assert reproduce.TUNE_GRID == jax_reproduce.TUNE_GRID
    assert reproduce.SHAPES == jax_reproduce.SHAPES
    args = reproduce.parse_args([])
    assert (args.examples, args.teacher, args.epochs, args.batch, args.k, args.m,
            args.hidden, args.optimizer, args.sparse_lr, args.dense_lr, args.seed) == (
        120_000, "ortho", 8, 512, 10, 2, (200, 300, 100), "adagrad", 0.1, 0.05, 0)


def test_reference_column_reads_results_md():
    """The RESULTS.md AUC column: each section's rows by label (the tuned
    table's by model), and not the next table's."""
    from deepctr_torch.tools import reproduce

    ref = reproduce.reference_aucs(os.path.join(REPO, "RESULTS.md"))
    assert set(ref) == set(reproduce.REFERENCE_SECTIONS)
    assert ref["tuned"]["fm"] == 0.8136 and ref["tuned"]["lr"] == 0.6699
    assert ref["family"]["fnn"] == 0.7202 and ref["converged"]["fnn"] == 0.7259
    assert ref["regularization"]["fnn dropout 0.5"] == 0.7300
    assert len(ref["sampling"]) == 3


def _parity_tool():
    spec = importlib.util.spec_from_file_location(
        "parity_report_torch", os.path.join(REPO, "tools", "parity_report_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_parity_tool_rows_inside_their_bands(tmp_path):
    """The parity tool at 1 seed, 4,000 examples and 2 epochs, LR and FM on
    the CPU: each row within its band, the table in PARITY.md's columns plus
    the JAX column."""
    from deepctr_torch.utils.artifacts import parse_md_table, read_stamp

    out = tmp_path / "PARITY_TORCH.md"
    with contextlib.redirect_stdout(io.StringIO()):
        rows = _parity_tool().run(1, 4000, str(out), models=("lr", "fm"),
                                  device="cpu", epochs=2)
    assert [r[0] for r in rows] == ["lr", "fm"]
    for r in rows:
        assert abs(r[5]) <= r[8] == 0.002 and r[9], r
    text = out.read_text()
    table = parse_md_table(text)
    assert [t["model"] for t in table] == ["LR", "FM"]
    assert list(table[0]) == ["model", "ref AUC (±σ)", "port AUC (±σ)", "Δ AUC", "band",
                              "ok", "ref logloss", "port logloss", "JAX AUC (PARITY.md)"]
    assert table[0]["JAX AUC (PARITY.md)"].startswith("0.7357")
    assert read_stamp(str(out))[0] == "tools/parity_report_torch.py"


def test_parity_swap_band_is_the_independent_difference_envelope():
    tool = _parity_tool()
    assert tool.band_for("snn_dae supervised", 0.01, 0.01, 6) == 0.002
    assert tool.band_for("snn_rbm pretrain-swap", 0.0050, 0.0056, 6) == pytest.approx(
        2 * (0.0050**2 + 0.0056**2) ** 0.5 / 6**0.5)
    assert tool.band_for("snn_rbm pretrain-swap", 0.0, 0.0, 6) == 0.002


@pytest.mark.parametrize("tool", ["reproduce", "parity"])
def test_cuda_without_a_card_raises(tool, tmp_path, monkeypatch):
    """``--device cuda`` without a card raises in both tools: nothing falls
    back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out.md")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if tool == "reproduce":
            from deepctr_torch.tools import reproduce

            reproduce.main(TINY + ["--device", "cuda", "--out", out])
        else:
            _parity_tool().main(["--seeds", "1", "--examples", "4000", "--models", "lr",
                                 "--device", "cuda", "--out", out])
    assert not os.path.exists(out)
