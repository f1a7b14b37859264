"""The benchmark of ``deepctr_torch``, the PyTorch and CUDA port, on NVIDIA H100s.

One command runs one cell once::

    python3 -m ctrbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

and prints, as the last line of its standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and, traced,
``breakdown``) and ``checks``, the numbers that decided ``correct`` beside
their limits.

The harness is driven by data, found by name from ``BENCHMARK.json`` at the
root of the checkout:

- ``configs/<config>.json``: a model configuration (fields and their
  vocabularies, widths, optimizers, table dtype, batch, scan K);
- ``traffic/<mix>.json``: a traffic mix, whose ``kind`` names its runner;
- ``runners/<kind>.py``: one runner per kind of traffic;
- ``metrics/<metric>.py``: one reader per per-layer metric;
- ``limits/<cell>.json``: the limits of the numbers a cell's ``correct``
  compares, with the readings they were set from.

The yardstick is frozen here, where later changes to the program cannot move
it: the traffic generator (``traffic.py``), the initial weights
(``weights.py``), the FLOP and byte arithmetic and the table of peaks
(``arith.py``), the reduction of a profiler slice (``trace.py``), the
comparison that decides ``correct`` (``checks.py``) and the plain reference
(``reference/``), which imports nothing of the program. Nothing here imports
``jax``, ``jaxlib`` or ``deepctr_tpu``.
"""
