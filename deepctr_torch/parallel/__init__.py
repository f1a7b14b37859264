"""Row-sharded multi-GPU training: the port of ``deepctr_tpu/parallel``.

One process drives one device (``group.py``, the counterpart of the
reference's ``mesh.py``); the table is row-sharded over the ranks with
all-to-all id and row exchange (``sharded.py``), or replicated with the
batch split (``dp.py``); ``comm.py`` counts the bytes a step exchanges.
The reference's per-host shard checkpoints (``hostckpt.py``), its
process-local batch assembly and ``predict_scaling`` are not ported yet
(ROADMAP.md, item 16).
"""

from .comm import CommVolume, comm_volume, dense_param_bytes, exchange_capacity
from .dp import make_dp_train_step, replicate_state
from .group import Group, local_batch, process_group, rank_rows, rank_zero_first
from .sharded import (
    ShardedTrainState,
    bucket_by_owner,
    check_ranks_agree,
    host_state_from_sharded,
    init_sharded_state,
    make_sharded_eval_step,
    make_sharded_train_step,
    pack_table,
    shard_rows,
    sharded_state_from_state,
    unpack_table,
)

__all__ = [
    "CommVolume",
    "comm_volume",
    "dense_param_bytes",
    "exchange_capacity",
    "make_dp_train_step",
    "replicate_state",
    "Group",
    "local_batch",
    "process_group",
    "rank_rows",
    "rank_zero_first",
    "ShardedTrainState",
    "bucket_by_owner",
    "check_ranks_agree",
    "host_state_from_sharded",
    "init_sharded_state",
    "make_sharded_eval_step",
    "make_sharded_train_step",
    "pack_table",
    "shard_rows",
    "sharded_state_from_state",
    "unpack_table",
]
