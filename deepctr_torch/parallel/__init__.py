"""Row-sharded multi-GPU training: the port of ``deepctr_tpu/parallel``.

One process drives one device (``group.py``, the counterpart of the
reference's ``mesh.py``, with a rank-local stream whose ranks agree on each
epoch's step count); the table is row-sharded over the ranks with
all-to-all id and row exchange (``sharded.py``: a step, or a chunk of
K steps that the card replays as one CUDA graph), or replicated with the
batch split (``dp.py``); ``comm.py`` counts the bytes a step exchanges;
``hostckpt.py`` writes and reloads each rank's shard files; ``drill.py``
(``python -m deepctr_torch.parallel.drill``) kills a rank and restores
from them. The reference's ``predict_scaling`` (a TPU interconnect model)
is not ported.
"""

from .comm import CommVolume, comm_volume, dense_param_bytes, exchange_capacity
from .dp import make_dp_train_step, replicate_state
from .group import (
    Group,
    RankLocalStream,
    count_shard_rows,
    local_batch,
    local_chunk,
    process_group,
    rank_rows,
    rank_zero_first,
)
from .hostckpt import load_host_shards, save_host_shards
from .sharded import (
    ShardedScanMetrics,
    ShardedTrainState,
    bucket_by_owner,
    check_ranks_agree,
    host_state_from_sharded,
    init_sharded_state,
    make_sharded_eval_step,
    make_sharded_scan_train_step,
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
    "RankLocalStream",
    "count_shard_rows",
    "load_host_shards",
    "save_host_shards",
    "local_batch",
    "local_chunk",
    "process_group",
    "rank_rows",
    "rank_zero_first",
    "ShardedScanMetrics",
    "ShardedTrainState",
    "bucket_by_owner",
    "check_ranks_agree",
    "host_state_from_sharded",
    "init_sharded_state",
    "make_sharded_eval_step",
    "make_sharded_scan_train_step",
    "make_sharded_train_step",
    "pack_table",
    "shard_rows",
    "sharded_state_from_state",
    "unpack_table",
]
