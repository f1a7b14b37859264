"""deepctr_torch and chip_smoke.py never import jax, optax or ml_dtypes
(the machine with the GPU has none), nor any module of the JAX package
``deepctr_tpu``: the port keeps its own copies of what it needs. The
evidence and benchmark tools run there too: ``deepctr_torch.tools.reproduce``,
``deepctr_torch.tools.bench_suite``, ``deepctr_torch.tools.scaling_report``,
``deepctr_torch.tools.substrate_lab`` and ``deepctr_torch.tools.step_breakdown``
load none of them, ``tools/parity_report_torch.py`` (which runs the NumPy
oracle of ``deepctr_tpu.reference_impl``) no jax, optax or ml_dtypes. Every
module under ``deepctr_torch`` imports without loading a module that sits
outside the package in the checkout, and without editing ``sys.path``."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys
import numpy as np
import deepctr_torch, deepctr_torch.cli, deepctr_torch.serving
import deepctr_torch.optim, deepctr_torch.train, deepctr_torch.utils.metrics
import deepctr_torch.ops.interaction, deepctr_torch.ops.kernels.interaction
import deepctr_torch.models.snn
import deepctr_torch.data.stream, deepctr_torch.utils.prof
from deepctr_torch.data import DevicePrefetcher, StreamSource
from deepctr_torch.utils.checkpoint import load_train_state
from deepctr_torch.utils.metrics import auc_state_finalize, auc_state_init
from deepctr_torch.models import (DeepFMModel, FMModel, LRModel, MlpSpec, PNNModel,
                                  make_deepfm, make_fm, make_fnn, make_lr, make_pnn)
from deepctr_torch.optim import SparseAdagrad, make_dense_optimizer
from deepctr_torch.serving import Scorer
from deepctr_torch.train import init_state, make_train_step
from deepctr_torch.data import make_schema, synthetic
import deepctr_torch.parallel.comm, deepctr_torch.parallel.dp
import deepctr_torch.parallel.group, deepctr_torch.parallel.sharded
import deepctr_torch.parallel.hostckpt, deepctr_torch.parallel.drill
import deepctr_torch.parallel.parity
import deepctr_torch.parallel.scaling
import deepctr_torch.tools.scaling_report, deepctr_torch.tools.substrate_lab
from deepctr_torch import parallel
schema = make_schema([("a", 4), ("tags", 10, 3)])
model = make_fnn(schema, k=2, mlp=MlpSpec(hidden=(8,)), device="cpu")
ds = synthetic.generate(schema, num_examples=20, k=2, seed=0)
probs = Scorer(model, schema, batch_size=16).predict(ds.ids)
assert probs.shape == (20,) and np.allclose(probs, 0.5), probs
for q in ("bf16", "int8"):
    m = make_fnn(schema, k=2, mlp=MlpSpec(hidden=(8,)), device="cpu")
    assert np.allclose(Scorer(m, schema, batch_size=16, quantize=q).predict(ds.ids), 0.5)
with parallel.process_group("cpu") as group:
    m = make_fnn(schema, k=2, mlp=MlpSpec(hidden=(8,), dropout=0.5), device="cpu")
    sopt, dopt = SparseAdagrad(0.05), make_dense_optimizer("adagrad", 0.02)
    sst = parallel.init_sharded_state(m, schema, sopt, dopt, group)
    sst, (loss, dropped) = parallel.make_sharded_train_step(schema, sopt, dopt, group)(
        sst, ds.ids, ds.labels, np.ones(20, np.float32))
    assert np.isfinite(float(loss)) and int(dropped) == 0
model = make_fnn(schema, k=2, mlp=MlpSpec(hidden=(8,), dropout=0.5), device="cpu")
sopt, dopt = SparseAdagrad(0.05), make_dense_optimizer("adagrad", 0.02)
state = init_state(model, schema, sopt, dopt, seed=0, table_dtype="bf16")
state, m = make_train_step(schema, sopt, dopt)(state, ds.ids, ds.labels,
                                               np.ones(20, np.float32))
assert state.step == 1 and np.isfinite(float(m.loss)), m
assert [b.ids.shape for b in DevicePrefetcher(
    deepctr_torch.data.minibatches(ds.ids, ds.labels, 8, schema=schema), "cpu")] == [
    (8, schema.num_slots)] * 3
model = make_fm(schema, k=2, device="cpu")
state = init_state(model, schema, sopt, dopt, seed=0, table_dtype="bf16")
state, m = make_train_step(schema, sopt, dopt, l2=1e-6)(state, ds.ids, ds.labels,
                                                        np.ones(20, np.float32))
assert state.step == 1 and np.isfinite(float(m.loss)), m
from deepctr_torch.models import RbmPretrainer, SNNModel, make_snn
from deepctr_torch.train import pretrain_snn
table, b1 = pretrain_snn(RbmPretrainer(m=1), schema, 4, ds.ids, sparse_opt=sopt,
                         batch_size=10, device="cpu")
assert table.shape == (schema.padded_vocab_size, 4) and b1.shape == (4,)
assert isinstance(make_snn(schema, hidden1=4, device="cpu"), SNNModel)
for make in (make_lr, make_deepfm, make_pnn):
    assert isinstance(make(schema, device="cpu"), (LRModel, DeepFMModel, PNNModel))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "ml_dtypes"))
assert not bad, bad
ref = sorted(m for m in sys.modules if m.split(".")[0] == "deepctr_tpu")
assert not ref, ref
print("ok")
"""


def test_port_imports_and_scores_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "ok"


def _chip_smoke_imports() -> str:
    """Every import statement of chip_smoke.py, at any depth, as source."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    nodes = [n for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom))
             and not (isinstance(n, ast.ImportFrom) and n.module == "__future__")]
    return "\n".join(ast.unparse(n) for n in nodes)


def test_chip_smoke_imports_nothing_of_jax():
    """chip_smoke.py's imports, the ones inside its phases too, run on a
    machine without a card: none loads jax or the JAX package, and its
    main() refuses to run without CUDA."""
    imports = _chip_smoke_imports()
    assert "deepctr_torch.data" in imports and "deepctr_torch.config" in imports
    script = f"""
import sys
{imports}
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "optax", "ml_dtypes", "deepctr_tpu"))
assert not bad, bad
try:
    chip_smoke.main()
except SystemExit as e:
    assert e.code not in (0, None), e.code
else:
    raise AssertionError("chip_smoke.main() returned without a card")
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "ok"


TOOL_SCRIPTS = {
    # the port's reproduction suite, tiny, on the CPU: nothing of the JAX
    # package either
    "reproduce": ("""
import contextlib, io, sys, tempfile
from deepctr_torch.tools import reproduce
with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
    res = reproduce.main(["--models", "lr", "--examples", "2000", "--epochs", "1",
                          "--batch", "256", "--no-tuned", "--no-convergence-study",
                          "--device", "cpu", "--out", tmp + "/R.md"])
assert res["runs"] == 1, res
""", ("jax", "jaxlib", "optax", "ml_dtypes", "deepctr_tpu")),
    # the parity tool runs the NumPy oracle of deepctr_tpu.reference_impl,
    # whose imports load no jax
    "parity": ("""
import contextlib, io, runpy, sys, tempfile
with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
    sys.argv = ["parity_report_torch.py", "--seeds", "1", "--examples", "2000",
                "--epochs", "1", "--models", "lr", "--device", "cpu", "--out", tmp + "/P.md"]
    runpy.run_path("tools/parity_report_torch.py", run_name="__main__")
assert "deepctr_tpu.reference_impl" in sys.modules
""", ("jax", "jaxlib", "optax", "ml_dtypes")),
    # the benchmark suite builds the headline itself, and loads nothing of
    # the JAX package or of the checkout's root
    "bench_suite": ("""
import contextlib, io, os, sys, tempfile
import torch
from deepctr_torch.data import make_schema
from deepctr_torch.tools import bench_suite
torch.set_num_threads(1)   # the suite's workers share the CPUs
with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
    os.chdir(tmp)
    res = bench_suite.main(["--sections", "parser,lookup", "--device", "cpu", "--small"])
assert res["embedding_lookups_per_s"] > 0, res
h = bench_suite.build(make_schema([("a", 4), ("b", 8)]), "cpu", hidden=(4,))
assert h.state.step == 0 and "bench_torch" not in sys.modules
""", ("jax", "jaxlib", "optax", "ml_dtypes", "deepctr_tpu")),
    # the scaling report's accounting and the substrate lab's record: nothing
    # of the JAX package
    "scaling_report": ("""
import contextlib, io, sys
from deepctr_torch.tools import scaling_report, substrate_lab
text = "\\n".join(scaling_report.inventory_section(small=False))
assert "2,359,296" in text and "5,111,808" in text, text
with contextlib.redirect_stdout(io.StringIO()):
    assert substrate_lab.main(["--exp", "rank8", "--device", "cpu"]) == {"rank8": {}}
""", ("jax", "jaxlib", "optax", "ml_dtypes", "deepctr_tpu")),
    # the speed-of-light audit reuses the suite's builder, and loads nothing
    # of the JAX package or of the checkout's root
    "step_breakdown": ("""
import contextlib, io, sys
import torch
from deepctr_torch.tools import step_breakdown
torch.set_num_threads(1)   # the suite's workers share the CPUs
with contextlib.redirect_stdout(io.StringIO()):
    res = step_breakdown.main(["--device", "cpu", "--small", "--parts", "components"])
assert list(res["components"]) == ["f32", "bf16"], res
assert "bench_torch" not in sys.modules
""", ("jax", "jaxlib", "optax", "ml_dtypes", "deepctr_tpu")),
}


@pytest.mark.parametrize("tool", sorted(TOOL_SCRIPTS))
def test_evidence_tools_load_no_jax(tool):
    """The evidence and benchmark tools run on the card's machine, which has
    no jax: ``deepctr_torch.tools.reproduce`` and
    ``deepctr_torch.tools.bench_suite`` load none of jax, optax, ml_dtypes
    or ``deepctr_tpu``; ``tools/parity_report_torch.py`` none of jax, optax
    or ml_dtypes."""
    body, banned = TOOL_SCRIPTS[tool]
    script = body + f"""
bad = sorted(m for m in sys.modules if m.split(".")[0] in {banned!r})
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")


BOUNDARY_SCRIPT = """
import importlib, os, sys
root = os.getcwd()
path = list(sys.path)
names = []
for top, dirs, files in os.walk(os.path.join(root, "deepctr_torch")):
    dirs[:] = sorted(d for d in dirs if d != "__pycache__")
    rel = os.path.relpath(top, root).replace(os.sep, ".")
    names += [rel if f == "__init__.py" else f"{rel}.{f[:-3]}"
              for f in sorted(files) if f.endswith(".py")]
for name in names:
    importlib.import_module(name)
assert sys.path == path, sys.path[:4]
package = os.path.join(root, "deepctr_torch") + os.sep
outside = sorted(n for n, m in list(sys.modules.items())
                 if (getattr(m, "__file__", None) or "").startswith(root + os.sep)
                 and not m.__file__.startswith(package))
assert not outside, outside
print(len(names))
"""


def test_every_port_module_imports_within_the_package():
    """Every module under ``deepctr_torch``, the scripts of ``csrc/``
    included, imports without editing ``sys.path`` and without loading a
    module of the checkout that lies outside the package (a script at its
    root, ``tools/``, ``deepctr_tpu``): the package reaches up to nothing."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", BOUNDARY_SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert int(res.stdout.strip().splitlines()[-1]) > 60
