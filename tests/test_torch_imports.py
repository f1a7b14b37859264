"""deepctr_torch never imports jax, optax or ml_dtypes: the machine with
the GPU has none. Of the JAX package it loads only the jax-free data layer
and run config, through ``deepctr_torch/shared.py``."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys
import numpy as np
import deepctr_torch, deepctr_torch.cli, deepctr_torch.serving
import deepctr_torch.optim, deepctr_torch.train, deepctr_torch.utils.metrics
from deepctr_torch.models import MlpSpec, make_fnn
from deepctr_torch.optim import SparseAdagrad, make_dense_optimizer
from deepctr_torch.serving import Scorer
from deepctr_torch.train import init_state, make_train_step
from deepctr_tpu.data import make_schema, synthetic
schema = make_schema([("a", 4), ("tags", 10, 3)])
model = make_fnn(schema, k=2, mlp=MlpSpec(hidden=(8,)), device="cpu")
ds = synthetic.generate(schema, num_examples=20, k=2, seed=0)
probs = Scorer(model, schema, batch_size=16).predict(ds.ids)
assert probs.shape == (20,) and np.allclose(probs, 0.5), probs
model = make_fnn(schema, k=2, mlp=MlpSpec(hidden=(8,), dropout=0.5), device="cpu")
sopt, dopt = SparseAdagrad(0.05), make_dense_optimizer("adagrad", 0.02)
state = init_state(model, schema, sopt, dopt, seed=0, table_dtype="bf16")
state, m = make_train_step(schema, sopt, dopt)(state, ds.ids, ds.labels,
                                               np.ones(20, np.float32))
assert state.step == 1 and np.isfinite(float(m.loss)), m
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "ml_dtypes"))
assert not bad, bad
ref = sorted(m for m in sys.modules if m.split(".")[0] == "deepctr_tpu")
bad = [m for m in ref if m != "deepctr_tpu" and m != "deepctr_tpu.config"
       and not m.startswith("deepctr_tpu.data")]
assert not bad, bad
print("ok")
"""


def test_port_imports_and_scores_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "ok"
