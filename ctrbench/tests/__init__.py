"""CPU tests of the benchmark harness: ``python -m pytest ctrbench/tests -q``."""
