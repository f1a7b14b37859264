"""The multi-process fault drill (``python -m deepctr_torch.parallel.drill``)
on two gloo ranks: each leg is one test, so that a failing leg names
itself. The legs and their gates are in the drill's docstring: a killed
rank's run fails within its limit and a fresh pair restores from the shard
files to the uninterrupted bits; the CLI's host-shard resume equals the
straight run, shard file for shard file; the rank-local stream over unequal
shards with the bf16 wire gives one history with and without the
prefetcher."""

import os
import subprocess
import sys

import pytest

from deepctr_torch.parallel import drill


@pytest.mark.parametrize("leg", drill.LEGS)
def test_drill_leg_on_two_cpu_ranks(leg, tmp_path, capsys):
    assert drill.main(["--device", "cpu", "--legs", leg,
                       "--workdir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"drill: {leg} passed on 2 cpu ranks" in out


def test_drill_refuses_cuda_without_two_gpus():
    """The drill never falls back to the CPU: asked for CUDA where there
    are fewer than two GPUs, it exits non-zero and says so."""
    res = subprocess.run([sys.executable, "-m", "deepctr_torch.parallel.drill"],
                         cwd=drill.ROOT, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=drill.ROOT,
                                  CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert "needs two ranks, one a GPU" in res.stderr
