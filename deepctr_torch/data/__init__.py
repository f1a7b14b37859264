"""Data layer of the port: schemas, parsers, synthetic data, host batching,
the binary cache and Criteo's format.

The port's own copy of ``deepctr_tpu/data`` (the port imports nothing of
the JAX package): each module copies its namesake there and is meant to
behave identically, but ``DevicePrefetcher``, written anew for CUDA streams.
"""

from .schema import FieldSpec, Schema, ipinyou_full_schema, ipinyou_like_schema, make_schema
from .parser import parse_yx_file, parse_yx_lines, pack_ids
from .featindex import FeatIndex, load_featindex
from .pipeline import (
    Batch,
    DevicePrefetcher,
    epoch_iterator,
    minibatches,
    stream_yx_batches,
)
from .stream import StreamSource, StreamStats, expand_shards
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
    "DevicePrefetcher",
    "epoch_iterator",
    "minibatches",
    "stream_yx_batches",
    "StreamSource",
    "StreamStats",
    "expand_shards",
    "SyntheticDataset",
    "generate",
    "write_yx_file",
]
