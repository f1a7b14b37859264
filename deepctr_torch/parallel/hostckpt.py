"""Per-rank shard checkpoints: the port of ``deepctr_tpu/parallel/hostckpt.py``.

The portable checkpoint (``utils/checkpoint.py``) gathers the logical table
onto rank 0, which at Criteo's size (26 M rows) moves the whole table
through one process. Here every rank writes and reloads only its own
shard and its copy of the replicated leaves; no collective is needed to
save or load.

The file layout is the reference's, key for key: ``<dir>/proc<rank>.npz``
holds ``__epoch`` and ``__nleaves``; for each sharded leaf i (the table and
every table-shaped sparse-state leaf) ``s{i}__{rank·(R+1)}_0``, the shard at
its row offset in the stored ``[N·(R+1), D]`` layout
(``parallel/sharded.py::pack_table``), and ``__shape{i}`` = ``[N·(R+1), D]``;
for each replicated leaf ``r{i}``. Leaf i is what it is in JAX: step,
table, the sparse state, the dense parameters, the dense optimizer's state
(``utils/checkpoint.py::_state_leaves`` order, as the portable checkpoint
uses), and last the dropout generator, whose own state the port writes
where the reference writes its PRNG key.

bf16 leaves are stored as their uint16 bits and listed in
``__bf16_leaves`` (the portable checkpoint's marker); they are decoded on
load. The reference stores a bf16 leaf through ``np.asarray``, which
writes it as ``|V2``, and its own ``load_host_shards`` then fails in
``jax.device_put``; the port reads such an entry as bf16 bits.

Restart contract: the restoring run has the same world size and the same
rank -> device assignment as the saving run.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.checkpoint import _host_array, _restore_generator, _state_leaves
from .group import Group
from .sharded import ShardedTrainState

_CONTRACT = ("restore with the world size and the rank -> device assignment "
             "of the run that saved")


def _leaves(state: ShardedTrainState) -> tuple[list, set[int]]:
    """The state's tensors in the reference's leaf order, step and generator
    excluded (leaf i of the file is ``[step, *these, generator][i]``), and
    the indices of the sharded ones."""
    table, sparse, dense, dense_state = _state_leaves(state)
    sharded = {1} | {2 + i for i, t in enumerate(sparse) if t.shape == table.shape}
    return [table, *sparse, *dense, *dense_state], sharded


def _shard_key(i: int, rows: int, group: Group) -> str:
    return f"s{i}__{group.rank * rows}_0"


def save_host_shards(dirpath: str, state: ShardedTrainState, group: Group,
                     epoch: int = 0) -> str:
    """Atomically write this rank's slice of ``state`` to
    ``<dirpath>/proc<rank>.npz`` (``epoch``: the epochs completed) and
    return its path. Every rank calls it; no collective runs."""
    os.makedirs(dirpath, exist_ok=True)
    tensors, sharded = _leaves(state)
    leaves = [np.int32(state.step), *tensors, state.generator.get_state()]
    payload = {"__epoch": np.int64(epoch), "__nleaves": np.int64(len(leaves))}
    bf16 = []
    for i, leaf in enumerate(leaves):
        a, is_bf16 = _host_array(leaf)
        if is_bf16:
            bf16.append(i)
        if i in sharded:
            payload[_shard_key(i, a.shape[0], group)] = a
            payload[f"__shape{i}"] = np.asarray(
                [group.world * a.shape[0], *a.shape[1:]], np.int64)
        else:
            payload[f"r{i}"] = a
    if bf16:
        payload["__bf16_leaves"] = np.asarray(bf16, np.int64)
    path = os.path.join(dirpath, f"proc{group.rank}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)
    return path


def _as_tensor(a: np.ndarray, bf16: bool) -> torch.Tensor:
    if bf16 or a.dtype == np.dtype("V2"):   # port's uint16 bits, JAX's |V2
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@torch.no_grad()
def load_host_shards(dirpath: str, like: ShardedTrainState,
                     group: Group) -> tuple[ShardedTrainState, int]:
    """Restore this rank's slice from ``<dirpath>/proc<rank>.npz`` into
    ``like`` (a freshly packed state for the same model, optimizers, table
    dtype and world size), in place; returns ``(like, epoch)``. A file
    written by either package loads. A leaf count, shape or dtype that does
    not match ``like``, or a missing shard, raises ``ValueError``."""
    path = os.path.join(dirpath, f"proc{group.rank}.npz")
    tensors, sharded = _leaves(like)
    n = len(tensors) + 2
    with np.load(path, allow_pickle=False) as z:
        if int(z["__nleaves"]) != n:
            raise ValueError(
                f"{path}: {int(z['__nleaves'])} leaves, the train state expects "
                f"{n}: model or optimizer mismatch")
        bf16 = set(z["__bf16_leaves"].tolist()) if "__bf16_leaves" in z.files else set()
        for i, target in enumerate(tensors, start=1):
            if i in sharded:
                rows = target.shape[0]
                want = [group.world * rows, *target.shape[1:]]
                shape = z[f"__shape{i}"].tolist()
                if shape != want:
                    raise ValueError(
                        f"{path}: leaf {i} is {shape} stored, this run's is "
                        f"{want}: {_CONTRACT}, and the same schema")
                key = _shard_key(i, rows, group)
                if key not in z.files:
                    raise ValueError(f"{path}: leaf {i}: shard {key} is missing: "
                                     f"{_CONTRACT}")
            else:
                key = f"r{i}"
            got = _as_tensor(z[key], i in bf16)
            if got.shape != target.shape or got.dtype != target.dtype:
                raise ValueError(
                    f"{path}: leaf {i} is {got.dtype}{list(got.shape)}, the "
                    f"train state's is {target.dtype}{list(target.shape)}: "
                    f"model, optimizer or train.table_dtype mismatch")
            target.copy_(got)
        _restore_generator(like.generator, z[f"r{n - 1}"], path)
        like.step = int(z["r0"])
        epoch = int(z["__epoch"])
    return like, epoch
