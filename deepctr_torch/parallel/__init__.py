"""Row-sharded multi-GPU training: the port of ``deepctr_tpu/parallel``.

One process drives one device (``group.py``, the counterpart of the
reference's ``mesh.py``, with a rank-local stream whose ranks agree on each
epoch's step count); the table is row-sharded over the ranks with
all-to-all id and row exchange (``sharded.py``: a step, or a chunk of
K steps that the card replays as one CUDA graph), or replicated with the
batch split (``dp.py``); ``comm.py`` counts the bytes a step exchanges
and predicts the step at N devices from links fitted to a collective
sweep (``predict_scaling``, ``fit_links``), and ``sharded.py``'s
``record_collectives`` shows what a step really sends; ``scaling.py`` (``python -m
deepctr_torch.parallel.scaling``) measures that sweep and the sharded step
at 1, 2 and 4 GPUs; ``hostckpt.py`` writes and reloads each rank's shard
files; ``drill.py`` (``python -m deepctr_torch.parallel.drill``) kills a
rank and restores from them.
"""

from .comm import (
    CommVolume,
    LinkModel,
    ScalingPoint,
    comm_volume,
    dense_param_bytes,
    exchange_capacity,
    fit_links,
    inter_host_bytes,
    predict_scaling,
    sent_volume,
)
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
from .hostckpt import load_host_shards, save_host_shards, shard_table_dtype
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
    record_collectives,
    shard_rows,
    sharded_state_from_state,
    unpack_table,
)

__all__ = [
    "CommVolume",
    "LinkModel",
    "ScalingPoint",
    "comm_volume",
    "dense_param_bytes",
    "exchange_capacity",
    "fit_links",
    "inter_host_bytes",
    "predict_scaling",
    "sent_volume",
    "make_dp_train_step",
    "replicate_state",
    "Group",
    "RankLocalStream",
    "count_shard_rows",
    "load_host_shards",
    "save_host_shards",
    "shard_table_dtype",
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
    "record_collectives",
    "shard_rows",
    "sharded_state_from_state",
    "unpack_table",
]
