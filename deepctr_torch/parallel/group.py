"""Process-group set-up: the port's counterpart of
``deepctr_tpu/parallel/mesh.py``.

JAX drives N devices from one process through a 1-D ``data`` mesh. A
PyTorch run is one process per GPU: rank r drives ``cuda:{LOCAL_RANK}``
through an NCCL group, or, with ``--device cpu``, the CPU through a gloo
group. The dense tower is replicated on every rank with its gradients
all-reduced; the table is row-sharded over the ranks
(``parallel/sharded.py``).

:func:`process_group` starts the group where none is running: under
``torchrun`` from the rank and world size in its environment, and without
a launcher as a world of one through a ``file://`` store in a temporary
directory. A failure to start it raises; a CUDA run never falls back to
gloo. :func:`local_batch` cuts rank r's rows ``[r·B/N, (r+1)·B/N)`` out of
a global batch, the role of the reference's ``shard_batch_arrays``, and
:func:`local_chunk` out of each step of a scan route's chunk.

:class:`RankLocalStream` takes the role of the reference's
``assemble_process_local`` for a stream: rank r parses only its shard
files and makes only its B/N rows a step, and the ranks agree on each
epoch's step count before it starts, so that none waits in a collective
that another never enters.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from ..data import Batch
from ..data.stream import StreamSource

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place in the ``torch.distributed`` group."""

    rank: int
    world: int
    device: torch.device


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _torchrun_command(world: int) -> str:
    return (f"torchrun --standalone --nproc_per_node={world} -m "
            f"deepctr_torch.cli --config <config.json> train.sharded=true ...")


@contextlib.contextmanager
def process_group(device: torch.device | str,
                  num_devices: int | None = None) -> Iterator[Group]:
    """The process group of a sharded run on ``device``'s type.

    A group that is already running is used as it is; its backend must be
    the device's (NCCL for CUDA, gloo for the CPU). Otherwise one is
    started, and destroyed on exit: under ``torchrun`` (``RANK`` and
    ``WORLD_SIZE`` in the environment) with rank r on ``cuda:{LOCAL_RANK}``
    for a CUDA device, else a world of one through a ``file://`` store.
    ``num_devices`` (``train.num_devices``), when set, must equal the world
    size."""
    device = torch.device(device)
    backend = _backend(device)
    started, store_dir = False, None
    try:
        if not dist.is_initialized():
            if device.type == "cuda" and "LOCAL_RANK" in os.environ:
                device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
                init = "env://"
            else:
                store_dir = tempfile.mkdtemp(prefix="deepctr_group_")
                init = f"file://{os.path.join(store_dir, 'store')}"
            kwargs = {"device_id": device} if device.type == "cuda" else {}
            if device.type == "cuda":
                torch.cuda.set_device(device)
            dist.init_process_group(
                backend, init_method=init,
                rank=int(os.environ.get("RANK", 0)),
                world_size=int(os.environ.get("WORLD_SIZE", 1)), **kwargs)
            started = True
        elif dist.get_backend() != backend:
            raise RuntimeError(
                f"a {dist.get_backend()} process group is running; a sharded "
                f"run on {device} needs {backend}")
        world, rank = dist.get_world_size(), dist.get_rank()
        if num_devices is not None and num_devices != world:
            raise ValueError(
                f"train.num_devices={num_devices} but the process group has "
                f"{world} rank(s): one process drives one device; start "
                f"{num_devices} processes, e.g. {_torchrun_command(num_devices)}")
        yield Group(rank=rank, world=world, device=device)
    finally:
        if started:
            dist.destroy_process_group()
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)


@contextlib.contextmanager
def rank_zero_first(group: Group | None) -> Iterator[None]:
    """Run the body on rank 0 first and on the other ranks after it: work
    that writes a file every rank then reads, such as the data cache."""
    if group is not None and group.rank != 0:
        dist.barrier()
    yield
    if group is not None and group.world > 1 and group.rank == 0:
        dist.barrier()


def rank_rows(batch_size: int, group: Group) -> slice:
    """Rank r's rows ``[r·B/N, (r+1)·B/N)`` of a global batch of B rows."""
    if batch_size % group.world:
        raise ValueError(f"batch of {batch_size} rows does not split over "
                         f"{group.world} ranks")
    n = batch_size // group.world
    return slice(group.rank * n, (group.rank + 1) * n)


def local_batch(b: Batch, group: Group, global_rows: int | None = None) -> Batch:
    """This rank's share of a global batch. ``global_rows``, when given, is
    the size every global batch has: a batch that is already a rank's
    share would otherwise be cut again without error."""
    if global_rows is not None and b.ids.shape[0] != global_rows:
        raise ValueError(f"a batch of {b.ids.shape[0]} rows where the global "
                         f"batch has {global_rows}: is it a rank's share already?")
    rows = rank_rows(b.ids.shape[0], group)
    return Batch(ids=b.ids[rows], labels=b.labels[rows], weights=b.weights[rows])


def local_chunk(chunk, group: Group, global_rows: int | None = None):
    """:func:`local_batch` of a scan route's chunk ``(nb, (ids [K, B, S],
    labels [K, B], weights [K, B]))``: this rank's rows along axis 1."""
    nb, (ids, labels, weights) = chunk
    if global_rows is not None and ids.shape[1] != global_rows:
        raise ValueError(f"a chunk of {ids.shape[1]} rows a step where the global "
                         f"batch has {global_rows}: is it a rank's share already?")
    rows = rank_rows(ids.shape[1], group)
    return nb, (ids[:, rows], labels[:, rows], weights[:, rows])


def count_shard_rows(source: StreamSource, group: Group) -> dict[str, int]:
    """Every shard file's rows (``StreamSource.count_rows``), the same dict
    on every rank: rank r counts files ``paths[r::N]``, and one
    ``all_gather_object`` joins the counts."""
    rows = {p: source.count_rows(p) for p in source.paths[group.rank::group.world]}
    if group.world == 1:
        return rows
    every = [None] * group.world
    dist.all_gather_object(every, rows)
    return {p: n for part in every for p, n in part.items()}


class RankLocalStream:
    """Rank r's stream of a multi-process run, with the step count every
    rank agrees on.

    ``source`` is rank r's ``StreamSource`` (``process_index=r``,
    ``process_count=N``, B/N rows a batch): each epoch it streams shards
    ``epoch_order(epoch)[r::N]``. ``rows`` holds every shard file's rows
    (:func:`count_shard_rows`), so each epoch's permutation tells every rank
    every rank's rows, with no further communication: the epoch runs
    ``min_r floor(rows_r / (B/N))`` steps (``StreamSource`` emits
    ``floor(rows/(B/N))`` full batches), and :meth:`batches` stops there and
    closes the stream (its parser threads end); :meth:`scan_chunks` cuts
    the same batches into the scan route's chunks. ``log`` receives one
    event an epoch with ``rows_skipped``: the rows of full batches that longer
    ranks leave (each rank's last partial batch is dropped as in one
    process)."""

    def __init__(self, source: StreamSource, group: Group, rows: dict[str, int],
                 log: Callable[[dict], None] | None = None):
        if source.process_index != group.rank or source.process_count != group.world:
            raise ValueError(
                f"the source streams for process {source.process_index} of "
                f"{source.process_count}; this is rank {group.rank} of {group.world}")
        self.source, self.group, self.rows, self.log = source, group, rows, log

    def epoch_steps(self, epoch: int) -> tuple[int, int]:
        """``(steps, rows_skipped)`` of ``epoch``, the same on every rank."""
        order, n = self.source.epoch_order(epoch), self.group.world
        b = self.source.batch_size
        full = [sum(self.rows[p] for p in order[r::n]) // b for r in range(n)]
        steps = min(full)
        return steps, (sum(full) - n * steps) * b

    def scan_chunks(self, epoch: int, scan_steps: int):
        """The scan route's feed: :meth:`batches` (the agreed steps, the
        ``epoch_steps`` event, the stream closed at the end) cut into chunks
        ``(nb, (ids [K, B/N, S], labels [K, B/N], weights [K, B/N]))`` of
        K = ``scan_steps`` steps, the last padded to K with weight-0 steps of
        pad ids and label 0. With equal shards this is the rank's
        ``StreamSource.scan_chunks``, chunk for chunk."""
        schema, b = self.source.schema, self.source.batch_size
        it = self.batches(epoch)
        try:
            while part := list(itertools.islice(it, scan_steps)):
                nb, pad = len(part), scan_steps - len(part)
                ids = np.stack([x.ids for x in part])
                labels = np.stack([x.labels for x in part])
                weights = np.stack([x.weights for x in part])
                if pad:
                    ids = np.concatenate([ids, np.full((pad, b, schema.num_slots),
                                                       schema.pad_id, ids.dtype)])
                    labels = np.concatenate([labels, np.zeros((pad, b), labels.dtype)])
                    weights = np.concatenate([weights,
                                              np.zeros((pad, b), weights.dtype)])
                yield nb, (ids, labels, weights)
        finally:
            it.close()

    def batches(self, epoch: int) -> Iterator[Batch]:
        steps, skipped = self.epoch_steps(epoch)
        if self.log is not None:
            self.log({"event": "epoch_steps", "epoch": epoch, "steps": steps,
                      "rows_skipped": skipped})
        it = self.source.batches(epoch)
        try:
            for i in range(steps):
                b = next(it, None)
                if b is None:
                    raise RuntimeError(
                        f"rank {self.group.rank}'s stream ended after {i} of "
                        f"{steps} batches: its shards' row counts differ from "
                        f"what the parser reads")
                yield b
        finally:
            it.close()


def torchrun(args: list[str], nproc: int, timeout: float, check: bool = True):
    """``torchrun --standalone --nproc_per_node=nproc ARGS`` from the root
    of the checkout, with it on ``PYTHONPATH``; returns ``(exit code,
    stdout, stderr, seconds)``. Past ``timeout`` the launcher is sent
    SIGTERM, on which it stops its ranks, and ``RuntimeError`` raises with
    the end of their output."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={nproc}", *args],
        cwd=_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired as e:
        proc.terminate()
        try:
            out, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        raise RuntimeError(f"torchrun {' '.join(args)} did not end within {timeout} "
                           f"s:\n{out[-2000:]}\n{err[-4000:]}") from e
    seconds = time.perf_counter() - t0
    if check and proc.returncode != 0:
        raise RuntimeError(f"torchrun {' '.join(args)} exited {proc.returncode}:\n"
                           f"{out[-2000:]}\n{err[-4000:]}")
    return proc.returncode, out, err, seconds
