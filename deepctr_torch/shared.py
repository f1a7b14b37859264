"""The modules the port shares with ``deepctr_tpu``, named in one place.

The JAX package's data layer (schemas, yx parsing, featindex, synthetic
data, host batching) and its run config import no jax, so the port reuses
them instead of copying them. They are the only part of ``deepctr_tpu`` the
port imports, and it imports them only through this module;
``tests/test_torch_imports.py`` holds it to that.
"""

from deepctr_tpu.config import RunConfig
from deepctr_tpu.data import Schema, featindex, ipinyou_full_schema, ipinyou_like_schema, parser, synthetic
from deepctr_tpu.data.cache import cache_text_file, read_cache
from deepctr_tpu.data.criteo import criteo_schema, parse_criteo_file
from deepctr_tpu.data.pipeline import minibatches, stream_yx_batches

__all__ = [
    "RunConfig",
    "Schema",
    "cache_text_file",
    "criteo_schema",
    "featindex",
    "ipinyou_full_schema",
    "ipinyou_like_schema",
    "minibatches",
    "parse_criteo_file",
    "parser",
    "read_cache",
    "stream_yx_batches",
    "synthetic",
]
