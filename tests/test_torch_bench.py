"""The port's benchmark suite on the CPU: ``deepctr_torch.tools.bench_suite``
(the counterpart of ``tools/bench_suite.py``).

- its headline configuration is ``bench.py``'s (constants read from
  ``bench.py`` as text), and its builder's two chunks of K = 2 steps equal
  the JAX package's ``make_scan_train_step`` on ``bench.py``'s model and
  optimizers (FNN, tanh tower, dropout 0.5, bf16 table,
  ``SparseAdagrad(0.05)``, ``optax.adagrad(0.02)``) from the same initial
  parameters;
- every section of ``tools/bench_suite.py`` (its ``--sections`` help and
  ``main()``, read as text) is run by the port's suite or listed in its
  docstring as not ported; the host sections give positive rates under the
  reference's keys at ``--small``, and the device sections run their plain
  versions there; a run with ``--device cpu`` writes no file;
- without ``--device cpu`` and without a card, the suite raises;
- ``BENCH_TORCH.json`` and ``BENCH_TORCH.md``, the suite's run of every
  section on the card, agree key for key, hold every section's keys and
  peak memory, name no TPU, and pass the reference's serving band
  (``tests/test_artifacts.py``: bf16 and int8 AUC within 0.002 of f32's).
"""

import ast
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from deepctr_torch.data import make_schema as t_make_schema
from deepctr_torch.tools import bench_suite
from deepctr_torch.utils import checkpoint as t_ckpt
from deepctr_tpu.data import make_schema, synthetic
from deepctr_tpu.models import MlpSpec, make_fnn
from deepctr_tpu.optim import SparseAdagrad
from deepctr_tpu.train import init_state as j_init_state
from deepctr_tpu.train.step import make_scan_train_step as j_make_scan_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 on both sides; sums are taken in other orders (tests/test_torch_scan.py)
RTOL, ATOL = 1e-4, 1e-5
FIELDS = [("a", 4), ("b", 8), ("c", 16), ("tags", 10, 3)]
K, HIDDEN, BATCH, STEPS = 3, (16, 8), 64, 2
CHUNKS = 2


def _env():
    # one intra-op thread: the suite's workers share the CPUs
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")


def _constants(path: str) -> dict:
    """Module-level ``NAME = literal`` assignments of a script, by name."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


def test_headline_configuration_is_bench_py():
    ref = _constants(os.path.join(ROOT, "bench.py"))
    for name in ("BATCH", "K", "HIDDEN", "MEASURE_STEPS"):
        assert getattr(bench_suite, name) == ref[name], name
    with open(os.path.join(ROOT, "bench.py")) as f:
        text = f.read()
    # the model, optimizers, state and data lines of bench.py:97-116
    assert "MlpSpec(hidden=HIDDEN, dropout=0.5)" in text
    assert "SparseAdagrad(0.05)" in text and "optax.adagrad(0.02)" in text
    assert 'seed=0, table_dtype="bf16"' in text
    assert "num_examples=N_EXAMPLES, k=4, seed=3" in text
    assert (bench_suite.DROPOUT, bench_suite.SPARSE_LR, bench_suite.DENSE_LR,
            bench_suite.TABLE_DTYPE, bench_suite.INIT_SEED, bench_suite.DATA_SEED) == (
        0.5, 0.05, 0.02, "bf16", 0, 3)


def _jax_seeds(rng, n):
    """The dropout seeds of n JAX steps (tests/test_torch_scan.py)."""
    seeds = []
    for _ in range(n):
        rng, step_rng = jax.random.split(rng)
        seeds.append(int(jax.random.randint(step_rng, (), 0, 1 << 24)))
    return seeds


def _bf16_bits(a) -> np.ndarray:
    return np.asarray(a, ml_dtypes.bfloat16).view(np.uint16).astype(np.int32)


def test_headline_chunks_match_jax():
    """Two chunks of K = 2 steps from ``bench_suite.build`` against the JAX
    package's ``make_scan_train_step`` on ``bench.py``'s model and
    optimizers, from the JAX state's parameters (the port's checkpoint
    conversion) and the JAX steps' dropout seeds: losses, ``state.step``,
    the bf16 table (within one bf16 ulp on at most 2% of its elements), the
    Adagrad accumulator, the tower and its Adagrad state, with
    ``test_scan_step_matches_jax``'s tolerance."""
    schema = make_schema(FIELDS)
    data = synthetic.generate(schema, num_examples=CHUNKS * STEPS * BATCH, k=K, seed=7)
    jmodel = make_fnn(schema, k=K, mlp=MlpSpec(hidden=HIDDEN, dropout=0.5),
                      use_pallas=True)
    jsopt, jdopt = SparseAdagrad(0.05), optax.adagrad(0.02)
    jstate = j_init_state(jmodel, schema, jsopt, jdopt, seed=0, table_dtype="bf16")
    seeds = _jax_seeds(jstate.rng, CHUNKS * STEPS)

    h = bench_suite.build(t_make_schema(FIELDS), "cpu", k=K, hidden=HIDDEN)
    assert h.state.table.dtype == torch.bfloat16
    h.state.model.load_state_dict(t_ckpt.params_from_jax(
        np.asarray(jstate.table).astype(np.float32), jstate.dense))
    chunks = bench_suite.stage(data.ids, data.labels, BATCH, CHUNKS * STEPS, "cpu",
                               scan_k=STEPS)
    j_scan = j_make_scan_train_step(jmodel, schema, jsopt, jdopt)
    for c, chunk in enumerate(chunks):
        jstate, jlosses = j_scan(jstate, *(jnp.asarray(t.numpy()) for t in chunk))
        _, losses = h.scan_step(h.state, *chunk, seeds=seeds[c * STEPS:(c + 1) * STEPS])
        np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=RTOL,
                                   atol=ATOL)
    assert h.state.step == int(jstate.step) == CHUNKS * STEPS
    ulps = np.abs(_bf16_bits(h.state.table.float().numpy()) - _bf16_bits(jstate.table))
    assert ulps.max() <= 1 and (ulps > 0).mean() <= 0.02
    want = jax.tree_util.tree_leaves((jstate.sparse_state, jstate.dense,
                                      jstate.dense_state))
    _, sparse_leaves, dense_p, dense_s = t_ckpt._state_leaves(h.state)
    got = [*sparse_leaves, *dense_p, *dense_s]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def _reference_sections() -> set:
    """Section names of tools/bench_suite.py: its --sections help and the
    names main() tests, read as text."""
    with open(os.path.join(ROOT, "tools", "bench_suite.py")) as f:
        text = f.read()
    help_text = re.search(r'help="comma list: (.*?)"\s*"\(run', text, re.S).group(1)
    names = {n.strip() for n in re.sub(r'"\s*"', "", help_text).split(",")}
    main = text[text.index("def main():"):]
    names |= set(re.findall(r'if "(\w+)" in sections', main))
    return names


def test_every_reference_section_is_ported_or_listed():
    names = _reference_sections()
    assert {"parser", "models", "batch", "h2d", "headline", "batchbf16med"} <= names
    doc = bench_suite.__doc__
    not_ported = doc[doc.index("Not ported"):]
    for name in sorted(names):
        assert name in bench_suite.SECTIONS or f"``{name}``" in not_ported, name
    assert bench_suite.DEFAULT_SECTIONS == "parser,models,full,lookup,serving,stream"


HOST_KEYS = {
    "parser": ["parser_native_mb_per_s", "parser_python_mb_per_s"],
    "parserscale": ["parser_2thread_speedup"],
    "stream": ["stream_rows_per_s", "stream_mb_per_s", "stream_npz_rows_per_s"],
}


def test_host_sections_run_small_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    res = bench_suite.main(["--sections", ",".join(HOST_KEYS), "--device", "cpu",
                            "--small"])
    for keys in HOST_KEYS.values():
        for key in keys:
            assert res[key] > 0, key
    assert res["stream_rows_per_s_sigma"] >= 0
    assert os.listdir(tmp_path) == []   # neither BENCH_TORCH.md nor .json


def test_device_sections_run_small_on_cpu(tmp_path, monkeypatch, capsys):
    """The card's sections on their plain versions: the keys the card's run
    writes, positive rates, no kernel launch (a CPU tensor takes the plain
    path), no device number, and no file."""
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # the suite's workers share the CPUs
    try:
        res = bench_suite.main(["--sections", "models,lookup,serving", "--device",
                                "cpu", "--small"])
    finally:
        torch.set_num_threads(threads)
    for model in ("lr", "fm", "fnn", "deepfm"):
        assert res[f"train_examples_per_s/{model}"] > 0
        assert res[f"device_ms_per_step/{model}"] is None
        assert set(res[f"launches_per_replay/{model}"].values()) == {0}
    for mode in ("f32", "bf16", "int8"):
        assert res[f"serving_examples_per_s/{mode}"] > 0
    assert res["embedding_lookups_per_s"] > 0 and res["scatter_add_rows_per_s"] > 0
    assert not any(k.startswith("device_peak_mib/") for k in res)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("argv", [["-m", "deepctr_torch.tools.bench_suite",
                                   "--sections", "parser"]],
                         ids=["bench_suite"])
def test_tools_raise_without_a_card(tmp_path, argv):
    res = subprocess.run([sys.executable, *argv], cwd=tmp_path,
                         env=dict(_env(), CUDA_VISIBLE_DEVICES=""), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device is available" in res.stderr
    assert not res.stdout.strip() or not res.stdout.strip().splitlines()[-1].startswith("{")
    assert os.listdir(tmp_path) == []


# a key that each section writes, besides its device_peak_mib/<section>
SECTION_KEYS = {
    "parser": "parser_native_mb_per_s",
    "models": "train_examples_per_s/deepfm",
    "full": "train_examples_per_s/fnn_full_vocab",
    "batch": "train_examples_per_s/fnn_full_vocab_b32768",
    "batchbf16": "train_examples_per_s/fnn_full_vocab_b32768_bf16table",
    "batchbf16med": "peak_sigma/fnn_full_vocab_b32768_bf16",
    "lookup": "scatter_add_rows_per_s",
    "serving": "serving_examples_per_s/int8",
    "stream": "stream_npz_rows_per_s",
    "criteostream": "criteo_stream_npz_rows_per_s",
    "parserscale": "parser_2thread_speedup",
    "servingquality": "serving_auc_delta/int8",
    "streamtrain": "train_stream_examples_per_s",
    "h2d": "h2d_examples_per_s_ceiling",
}


def _bench_artifacts():
    with open(os.path.join(ROOT, "BENCH_TORCH.json")) as f:
        results = json.load(f)
    with open(os.path.join(ROOT, "BENCH_TORCH.md")) as f:
        text = f.read()
    return results, text


def test_bench_torch_artifacts_cover_every_section():
    results, text = _bench_artifacts()
    assert set(SECTION_KEYS) == set(bench_suite.SECTIONS)
    for section, key in SECTION_KEYS.items():
        assert key in results, (section, key)
        assert results[f"device_peak_mib/{section}"] > 0 or section in (
            "parser", "parserscale", "stream", "criteostream"), section
    rows = [ln.split("|")[1].strip() for ln in text.splitlines()
            if ln.startswith("| ") and not ln.startswith("| metric")]
    assert rows == list(results)
    assert "TPU" not in text and "v5e" not in text


def test_bench_torch_serving_quality_in_band():
    results, _ = _bench_artifacts()
    for mode in ("bf16", "int8"):
        assert abs(results[f"serving_auc_delta/{mode}"]) <= 0.002, mode
    assert results["serving_auc/f32"] > 0.5
