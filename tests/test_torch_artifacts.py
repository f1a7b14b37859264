"""The port's evidence: its copy of ``utils/artifacts.py`` against the
original, and the artifacts its tools wrote on the card.

1. ``deepctr_torch/utils/artifacts.py`` parses, reads stamps and hashes as
   ``deepctr_tpu/utils/artifacts.py`` does, on the repo's stamped files;
2. ``RESULTS_TORCH.md`` (``python -m deepctr_torch.tools.reproduce --study
   all``), ``PARITY_TORCH.md`` (``python tools/parity_report_torch.py
   --seeds 6 --examples 40000``), ``BENCH_TORCH.md`` (``python -m
   deepctr_torch.tools.bench_suite`` with every section; its gates are in
   ``tests/test_torch_bench.py``), ``SCALING_TORCH.md`` (``python -m
   deepctr_torch.tools.scaling_report`` on four cards) and
   ``ROOFLINE_TORCH.md`` (``python -m deepctr_torch.tools.step_breakdown
   --quality``; its gates are in ``tests/test_torch_step_breakdown.py``)
   carry the stamps of their tools at HEAD: any edit to a tool invalidates
   its artifact until the tool is re-run on the card;
3. each artifact passes its gates: every parity row inside its own band,
   with the live oracle reproducing ``PARITY.md``'s; the family tables the
   gates ``tests/test_reproduce.py`` puts on ``RESULTS.md``; every
   executed-against-accounted row of ``SCALING_TORCH.md`` reads ``yes``, as
   ``tests/test_artifacts.py`` holds ``SCALING.md``'s; every header names
   the NVIDIA card and its power limit.
"""

import os
import re

import pytest

from deepctr_torch.utils import artifacts as port
from deepctr_tpu.utils import artifacts as ref

REPO = ref.REPO_ROOT

ARTIFACTS = {
    "RESULTS_TORCH.md": "deepctr_torch/tools/reproduce.py",
    "PARITY_TORCH.md": "tools/parity_report_torch.py",
    "BENCH_TORCH.md": "deepctr_torch/tools/bench_suite.py",
    "SCALING_TORCH.md": "deepctr_torch/tools/scaling_report.py",
    "ROOFLINE_TORCH.md": "deepctr_torch/tools/step_breakdown.py",
}
STAMPED = ["RESULTS.md", "PARITY.md", "SCALING.md", "BENCH.md", *ARTIFACTS]
TOOLS = ["tools/reproduce.py", "tools/parity_report.py", *ARTIFACTS.values()]
PARITY_ROWS = ["LR", "FM", "FNN"] + [f"{m} {c}" for m in ("SNN_DAE", "SNN_RBM")
                                     for c in ("SUPERVISED", "PRETRAIN-MATCHED",
                                               "PRETRAIN-SWAP")]
# "NVIDIA H100 80GB HBM3, 700.00 W", as nvidia-smi gives name,power.limit
CARD = re.compile(r"NVIDIA [^,;\n]+, \d+(?:\.\d+)? W")


def _read(name: str) -> str:
    with open(os.path.join(REPO, name)) as f:
        return f.read()


def _section(text: str, title: str) -> str:
    """One ``###`` section: ``parse_md_table`` reads on past blank lines."""
    start = text.index(title)
    end = text.find("\n###", start + 3)
    return text[start:] if end < 0 else text[start:end]


def test_copy_names_the_same_root():
    assert port.REPO_ROOT == ref.REPO_ROOT


@pytest.mark.parametrize("name", STAMPED)
def test_copy_parses_and_reads_stamps_as_the_original(name):
    text = _read(name)
    pieces = [text] + ["###" + p for p in text.split("###")[1:]]
    for piece in pieces:
        rows = ref.parse_md_table(piece)
        assert port.parse_md_table(piece) == rows
        for row in rows:
            for cell in row.values():
                assert port.float_or_none(cell) == ref.float_or_none(cell), cell
    path = os.path.join(REPO, name)
    assert port.read_stamp(path) == ref.read_stamp(path) is not None


@pytest.mark.parametrize("tool", TOOLS)
def test_copy_hashes_as_the_original(tool):
    assert port.tool_hash(tool) == ref.tool_hash(tool)
    assert port.protocol_stamp(tool) == ref.protocol_stamp(tool)


@pytest.mark.parametrize("artifact,tool", sorted(ARTIFACTS.items()))
def test_artifact_generated_by_current_protocol(artifact, tool):
    stamp = port.read_stamp(os.path.join(REPO, artifact))
    assert stamp is not None, f"{artifact} carries no protocol stamp"
    assert stamp == (tool, port.tool_hash(tool)), (
        f"{artifact} was generated by another version of {tool}: re-run it "
        f"on the card (README)")


@pytest.mark.parametrize("artifact", sorted(ARTIFACTS))
def test_artifact_header_names_the_card_and_its_power_limit(artifact):
    head = _read(artifact).split("\n|", 1)[0]
    assert CARD.search(head), head[:600]


def _parity_rows() -> dict:
    return {r["model"]: r for r in port.parse_md_table(_read("PARITY_TORCH.md"))}


def test_parity_has_every_row_inside_its_own_band():
    rows = _parity_rows()
    assert list(rows) == PARITY_ROWS
    for name, r in rows.items():
        delta, band = port.float_or_none(r["Δ AUC"]), port.float_or_none(r["band"])
        assert abs(delta) <= band + 1e-9, (name, delta, band)
        assert r["ok"] == "yes", name
        if "PRETRAIN-SWAP" not in name:
            assert band == 0.002, name


def test_parity_oracle_reproduces_parity_md():
    """The live oracle's AUC equals PARITY.md's within 0.0005 (the protocol
    was reproduced), and the JAX column quotes PARITY.md."""
    jax = {r["model"]: r for r in port.parse_md_table(_read("PARITY.md"))}
    for name, r in _parity_rows().items():
        got = port.float_or_none(r["ref AUC (±σ)"])
        want = port.float_or_none(jax[name]["ref AUC (±σ)"])
        assert abs(got - want) <= 5e-4, (name, got, want)
        assert r["JAX AUC (PARITY.md)"] == jax[name]["ours AUC (±σ)"], name


def test_results_has_every_section_of_results_md():
    from deepctr_torch.tools.reproduce import REFERENCE_SECTIONS

    text = _read("RESULTS_TORCH.md")
    for title in REFERENCE_SECTIONS.values():
        assert title in text, title
        rows = port.parse_md_table(_section(text, title))
        col = "RESULTS.md late AUC" if "regularization" in title else "RESULTS.md AUC"
        assert rows and all(port.float_or_none(r[col]) for r in rows), title
        assert all(port.float_or_none(r["wall s"]) > 0 for r in rows), title


def test_results_headline_tuned_table_ordering():
    """RESULTS.md's headline gate (tests/test_reproduce.py) on the port's
    tuned table: it leads, SNN >= LR + 0.005 and above the LR-FNN midpoint,
    FNN and FM >= LR + 0.005."""
    text = _read("RESULTS_TORCH.md")
    assert text.index("tuned per model (HEADLINE") < text.index(
        "shared dataset, shared budget")
    rows = port.parse_md_table(_section(text, "### Model family — tuned per model"))
    auc = {r["run"].split("[")[0].strip(): port.float_or_none(r["AUC"]) for r in rows}
    assert sorted(auc) == sorted(["lr", "fm", "fnn", "snn_dae", "snn_rbm", "deepfm",
                                  "ipnn", "opnn"]), auc
    midpoint = (auc["lr"] + auc["fnn"]) / 2
    for snn in ("snn_dae", "snn_rbm"):
        assert auc[snn] >= auc["lr"] + 0.005, (snn, auc)
        assert auc[snn] >= midpoint, (snn, auc, midpoint)
    assert auc["fnn"] >= auc["lr"] + 0.005, auc
    assert auc["fm"] >= auc["lr"] + 0.005, auc


def test_results_regularization_study_discriminates():
    """At the converged budget unregularized FNN overfits, and dropout beats
    both no regularization and L2 on late-epoch AUC (RESULTS.md's gate)."""
    section = _section(_read("RESULTS_TORCH.md"), "### FNN regularization")
    assert "converged" in section.splitlines()[0]
    rows = port.parse_md_table(section)
    late = {r["run"]: port.float_or_none(r["late AUC (last 3 ep)"]) for r in rows}
    best = {r["run"]: port.float_or_none(r["best AUC"]) for r in rows}
    assert best["fnn none"] - late["fnn none"] > 0.01, (best, late)
    drop_late = max(late["fnn dropout 0.25"], late["fnn dropout 0.5"])
    l2_late = max(late["fnn L2 1e-4"], late["fnn L2 1e-3"])
    assert drop_late >= late["fnn none"] + 0.005, late
    assert drop_late >= l2_late + 0.005, late


def test_results_snn_mechanism_separates_the_optimizers():
    """The SNN optimizer mechanism section: 2-epoch Adagrad well above
    2-epoch SGD for both pretrainers (RESULTS.md's: +0.13 and +0.16)."""
    rows = port.parse_md_table(_section(_read("RESULTS_TORCH.md"),
                                        "### SNN optimizer mechanism"))
    auc = {r["run"]: port.float_or_none(r["AUC"]) for r in rows}
    for snn in ("snn_dae", "snn_rbm"):
        assert auc[f"{snn} adagrad@2ep"] >= auc[f"{snn} sgd@2ep"] + 0.05, auc


def test_scaling_executed_rows_all_match():
    """SCALING_TORCH.md's executed-against-accounted table ships no row but
    ``yes``, from a run on cards, with the train, eval and scan steps of
    every case (the counterpart of ``tests/test_artifacts.py::
    test_scaling_hlo_validation_rows_all_match``)."""
    text = _read("SCALING_TORCH.md")
    start = text.index("## Accounted against executed")
    rows = port.parse_md_table(text[start:])
    assert rows and {r["match"] for r in rows} == {"yes"}, [
        r for r in rows if r["match"] != "yes"]
    assert all(r["accounted bytes/rank"] == r["executed bytes/rank"] for r in rows)
    steps = {r["step / config"].split()[0] for r in rows}
    assert steps == {"train", "eval", "scan"}, steps
    assert all("(captured)" in r["step / config"] for r in rows
               if r["step / config"].startswith("scan")), "the scan rows were not captured"
