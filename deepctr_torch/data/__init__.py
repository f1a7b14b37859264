"""Data layer of the port: schemas, parsers, synthetic data, host batching,
the binary cache and Criteo's format.

The port's own copy of ``deepctr_tpu/data`` (the port imports nothing of
the JAX package): each module copies its namesake there and is meant to
behave identically. Left out: ``DevicePrefetcher`` (JAX device code) and
``stream.py`` (``StreamSource``), which the port does not use yet.
"""

from .schema import FieldSpec, Schema, ipinyou_full_schema, ipinyou_like_schema, make_schema
from .parser import parse_yx_file, parse_yx_lines, pack_ids
from .featindex import FeatIndex, load_featindex
from .pipeline import Batch, epoch_iterator, minibatches, stream_yx_batches
from .synthetic import SyntheticDataset, generate, write_yx_file

__all__ = [
    "FieldSpec",
    "Schema",
    "ipinyou_full_schema",
    "ipinyou_like_schema",
    "make_schema",
    "parse_yx_file",
    "parse_yx_lines",
    "pack_ids",
    "FeatIndex",
    "load_featindex",
    "Batch",
    "epoch_iterator",
    "minibatches",
    "stream_yx_batches",
    "SyntheticDataset",
    "generate",
    "write_yx_file",
]
