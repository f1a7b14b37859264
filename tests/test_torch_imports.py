"""deepctr_torch never imports jax: the machine with the GPU has none. Of
the JAX package it loads only the jax-free data layer and run config."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys
import numpy as np
import deepctr_torch, deepctr_torch.cli, deepctr_torch.serving
from deepctr_torch.models import MlpSpec, make_fnn
from deepctr_torch.serving import Scorer
from deepctr_tpu.data import make_schema, synthetic
schema = make_schema([("a", 4), ("tags", 10, 3)])
model = make_fnn(schema, k=2, mlp=MlpSpec(hidden=(8,)), device="cpu")
probs = Scorer(model, schema, batch_size=16).predict(
    synthetic.generate(schema, num_examples=20, k=2, seed=0).ids)
assert probs.shape == (20,) and np.allclose(probs, 0.5), probs
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes"))
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
