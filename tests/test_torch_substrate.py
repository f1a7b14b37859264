"""The port's substrate lab (``deepctr_torch/tools/substrate_lab.py``)
against the reference's (``tools/substrate_lab.py``), with nothing trained.

Both labs' ``run`` is replaced by one that records the ``RunConfig`` each
experiment hands it and answers with a fixed AUC a model: the port's
configs must equal the reference lab's field for field, run for run, the
``mix`` route included (inside the run, ``synthetic.generate`` of each
package draws the same data as the original with that ``ortho_mix``, and
the port puts the original back after the run, also when the run raises).
``rank8`` prints the reference's historical numbers as the reference's;
the ``rank2`` gate raises where SNN or FNN do not beat LR by 0.02; and
``--device cuda`` without a card raises before anything runs.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os

import numpy as np
import pytest

import deepctr_torch.cli as t_cli
import deepctr_torch.data.synthetic as t_synthetic
import deepctr_tpu.cli as j_cli
import deepctr_tpu.data.synthetic as j_synthetic
from deepctr_torch.data import make_schema as t_make_schema
from deepctr_torch.tools import substrate_lab as t_lab
from deepctr_tpu.data import make_schema as j_make_schema

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUC = {"lr": 0.60, "fm": 0.75, "fnn": 0.70, "snn": 0.70}
MIX = (1.0, 1.2, 0.0)
FIELDS = [("a", 6), ("b", 9), ("c", 5), ("tags", 12, 2)]


def _reference_lab():
    spec = importlib.util.spec_from_file_location(
        "reference_substrate_lab", os.path.join(ROOT, "tools", "substrate_lab.py"))
    lab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lab)
    return lab


def _answer(cfg):
    return {"best_auc": AUC[cfg.model.name], "best_epoch": cfg.train.epochs}


@pytest.fixture
def labs(monkeypatch, tmp_path):
    """Both labs with ``run`` recording its configs, ``tempfile.mkdtemp``
    fixed (the FM checkpoint's directory) and each package's
    ``synthetic.generate`` put back at the end."""
    seen = {"port": [], "ref": []}

    def port_run(cfg, device):
        seen["port"].append(cfg)
        return _answer(cfg)

    def ref_run(cfg):
        seen["ref"].append(cfg)
        return _answer(cfg)

    monkeypatch.setattr(t_cli, "run", port_run)
    monkeypatch.setattr(j_cli, "run", ref_run)
    def mkdtemp(prefix=""):
        os.makedirs(tmp_path / "slab", exist_ok=True)
        return str(tmp_path / "slab")

    monkeypatch.setattr("tempfile.mkdtemp", mkdtemp)
    monkeypatch.setattr(t_synthetic, "generate", t_synthetic.generate)
    monkeypatch.setattr(j_synthetic, "generate", j_synthetic.generate)
    return _reference_lab(), seen


@pytest.mark.parametrize("exp", ["leakage", "rank2"])
def test_configs_equal_the_reference_labs(labs, exp):
    ref, seen = labs
    with contextlib.redirect_stdout(io.StringIO()) as out:
        t_lab.EXPERIMENTS[exp](120_000, t_lab.torch.device("cpu"))
        getattr(ref, f"exp_{exp}")(120_000)
    assert len(seen["port"]) == len(seen["ref"]) == {"leakage": 3, "rank2": 4}[exp]
    for got, want in zip(seen["port"], seen["ref"]):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    rows = [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith('{"label"')]
    port_rows = rows[:len(seen["port"])]
    assert [r["auc"] for r in port_rows] == [AUC[c.model.name] for c in seen["port"]]
    assert all(r["device"] == "cpu" and "secs" in r and "best_epoch" in r
               for r in port_rows)


def _draw(synthetic, make_schema):
    return synthetic.generate(make_schema(FIELDS), num_examples=64, k=2, seed=3,
                              teacher="ortho")


@pytest.mark.parametrize("fails", [False, True])
def test_mix_route_matches_and_is_undone(labs, monkeypatch, fails):
    """A run with ``mix`` sees ``generate`` draw with that ``ortho_mix`` in
    both labs, from the same config; after the run (also one that raises)
    the port's ``generate`` is the original again."""
    ref, seen = labs
    original = t_synthetic.generate
    drawn = {}

    def port_run(cfg, device):
        seen["port"].append(cfg)
        drawn["port"] = _draw(t_synthetic, t_make_schema)
        if fails:
            raise RuntimeError("the run failed")
        return _answer(cfg)

    def ref_run(cfg):
        seen["ref"].append(cfg)
        drawn["ref"] = _draw(j_synthetic, j_make_schema)
        return _answer(cfg)

    monkeypatch.setattr(t_cli, "run", port_run)
    monkeypatch.setattr(j_cli, "run", ref_run)
    kw = dict(teacher="ortho", examples=5000, mix=MIX, label="fm mix")
    with contextlib.redirect_stdout(io.StringIO()):
        if fails:
            with pytest.raises(RuntimeError, match="the run failed"):
                t_lab.train({"name": "fm", "k": 10}, "adagrad", 0.05, 0.02,
                            device=t_lab.torch.device("cpu"), **kw)
        else:
            t_lab.train({"name": "fm", "k": 10}, "adagrad", 0.05, 0.02,
                        device=t_lab.torch.device("cpu"), **kw)
        ref.train({"name": "fm", "k": 10}, "adagrad", 0.05, 0.02, **kw)
    assert t_synthetic.generate is original
    assert dataclasses.asdict(seen["port"][0]) == dataclasses.asdict(seen["ref"][0])
    want = original(t_make_schema(FIELDS), num_examples=64, k=2, seed=3, teacher="ortho",
                    ortho_mix=MIX)
    plain = _draw(t_synthetic, t_make_schema)
    for got in (drawn["port"], drawn["ref"]):
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.bayes_logits, want.bayes_logits)
    assert not np.array_equal(plain.bayes_logits, want.bayes_logits)


def test_rank8_prints_the_reference_record(labs):
    ref, seen = labs
    with contextlib.redirect_stdout(io.StringIO()) as port_out:
        t_lab.main(["--exp", "rank8", "--device", "cpu"])
    with contextlib.redirect_stdout(io.StringIO()) as ref_out:
        ref.exp_rank8(120_000)

    def record(text):
        return json.loads(text[text.index("{"):])

    (port_key, port_rec), = record(port_out.getvalue()).items()
    (_, ref_rec), = record(ref_out.getvalue()).items()
    assert port_key.startswith("reference_") and port_rec == ref_rec
    assert seen["port"] == []


def test_rank2_gate_raises(labs, monkeypatch):
    """LR within 0.02 of SNN: the gate the reference asserts raises."""
    monkeypatch.setitem(AUC, "lr", 0.69)
    with contextlib.redirect_stdout(io.StringIO()), \
            pytest.raises(AssertionError, match="must beat LR"):
        t_lab.main(["--exp", "rank2", "--device", "cpu"])


def test_cuda_without_a_card_raises(labs):
    """The lab runs on the card by default and does not fall back to the
    CPU: with no card it raises before any run."""
    _, seen = labs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_lab.main(["--exp", "rank2"])
    assert seen["port"] == []
