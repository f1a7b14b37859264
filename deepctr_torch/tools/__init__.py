"""The port's evidence tools: ``python -m deepctr_torch.tools.reproduce``
writes the model-family reproduction (``RESULTS_TORCH.md``), the
counterpart of ``tools/reproduce.py``'s ``RESULTS.md``."""
