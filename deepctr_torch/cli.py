"""CLI entry point: ``python -m deepctr_torch.cli --config configs/fnn.json``.

Port of ``deepctr_tpu/cli.py`` for LR, FM, FNN, SNN, DeepFM and PNN
(IPNN/OPNN), and the port's own DLRM-DCNv2 (``model.name=dlrm_dcnv2``),
xDeepFM (``model.name=xdeepfm``) and HSTU (``model.name=hstu``), below: it reads the same
``configs/*.json`` and dotted overrides
(``deepctr_torch.config.RunConfig``, the port's copy of the reference's),
trains (``run``: data in RAM or streamed from shard files
(``data.stream``), model, optimizers, a resumed train state
(``train.resume``), the FM -> FNN hand-off, SNN's DAE or RBM pretraining
(``train.pretrain``) and its hand-off, ``fit``, checkpoints, an FM run's
``.fm_table`` and JSONL metrics), or with ``--score`` scores a yx file with
a checkpoint written by either package, printing one probability per
line; ``--print-config`` prints the resolved config and exits.
``--device`` names where the model runs, and the device alone picks the
kernels: on CUDA the hand-written ones, on the CPU their plain versions.
Asking for CUDA where there is none raises.

``train.sharded`` trains with the table row-sharded over a
``torch.distributed`` group (``parallel/``): one process per device, under
``torchrun --standalone --nproc_per_node=N -m deepctr_torch.cli ...``
(NCCL on ``--device cuda``, rank r on ``cuda:{LOCAL_RANK}``; gloo on
``--device cpu``; over M hosts ``torchrun --nnodes=M --nproc_per_node=G
--rdzv_backend=c10d --rdzv_endpoint=<host:port>``), or as a world of one
without a launcher. Every rank prepares the same state (initialisation,
resume, the FM hand-off, SNN's pretraining) and takes its slice of every
batch; rank 0 alone writes metrics and checkpoints, which keep the
single-device layout. ``train.num_devices``, when set, must equal the
world size.

``train.distributed``: JAX drives many devices from one process and
switches its multi-controller branches on ``jax.process_count() > 1``. A
sharded run of the port is already one process per device, so the key
itself selects the multi-controller contract, with ``train.sharded``, at
any world size (a world of one too):
- a stream is rank-local: rank r parses only shard files
  ``epoch_order[r::N]`` and makes B/N rows a step, and the ranks agree on
  each epoch's step count first (``parallel.RankLocalStream``; an
  ``epoch_steps`` event gives the steps and ``rows_skipped``). Data in RAM
  is held by every rank, which takes its rows of each batch, as without
  the key;
- checkpoints are per-rank shard files, ``<ckpt>.hostshards/proc<r>.npz``
  (``parallel/hostckpt.py``); no portable checkpoint and no ``.fm_table``
  is written;
- a run resumes from ``<ckpt>.hostshards`` when that directory exists,
  whatever ``train.resume`` says (the reference's rule), skipping the FM
  hand-off and SNN's pretraining, and logs ``resumed_hostshards``.
Without ``train.sharded`` the key has no effect, as in the reference's
single process; a ``distributed_ignored`` event says so.

``train.scan_steps`` (default 8) is the reference's chunked route: with
K > 1 an epoch trains in chunks of K steps, a short last chunk padded with
weight-0 steps that count as steps, as the reference's do. On the card a
chunk is one replay of a CUDA graph of the K steps, in a sharded run with
its NCCL exchanges and all-reduces inside; on the CPU it is K eager steps;
0 or 1 is the per-step route.

``model.name=dlrm_dcnv2`` (``configs/dlrm_dcnv2_criteo.json``), which the
reference lacks, trains on data generated from ``data.synthetic_seed``
with dense features beside multi-hot ids (``data/synthetic_dlrm.py``:
``data.synthetic_examples`` examples over the schema of
``data.schema_path``, or MLPerf's 26 Criteo fields with each table capped
at ``data.criteo_cat_buckets`` rows, the last ``data.test_fraction`` held
out), through the same ``fit`` and scan route, the dense features staged
and replayed with the ids; ``k`` is its table's width and ``model.hidden``
its top MLP's hidden widths, and its bottom MLP (512-256-128 over 13 dense
inputs) and cross network (3 layers of rank 512) are MLPerf's, fixed. Its
``.yx`` files, checkpoints, scoring, sharding and pretraining are not
supported, and asking for them raises.

``model.name=xdeepfm`` (``configs/xdeepfm_criteo.json``), which the
reference lacks, trains on the data the other models train on (generated
Criteo data with ``data.format=criteo``, or any schema and files), through
the same ``fit`` and scan route; ``k`` is its factors' width and
``model.hidden`` its DNN's hidden widths, ReLU and no dropout, and its CIN
is the paper's Criteo one, 200-200-200 feature maps, fixed. Its
checkpoints, scoring, sharding, pretraining and hand-off are not supported,
and asking for them raises.

``model.name=hstu`` (``configs/hstu_ml20m.json``), which the reference
lacks, trains on users' histories generated from ``data.synthetic_seed``
(``data/synthetic_hstu.py``: ``data.synthetic_examples`` users over the
one-field schema of ``data.schema_path``, its vocabulary the items and its
slots the history's length, or ML-20M's 26,744 items and 200 positions;
the last ``data.test_fraction`` of the users held out), in chunks of
``train.scan_steps`` steps of ``train.batch_size`` histories through
``make_scan_train_step`` (0 and 1 a chunk of one step), the last chunk
padded with weight-0 steps; each
epoch logs its mean loss, its rate and the held-out users' hit rate and
NDCG at 10 (each history's last item ranked among every item by the
output before it). ``model.k`` is the item embeddings' width,
``model.hidden`` ``[blocks, heads, head width]`` and ``model.dropout`` the
blocks' and the input's dropout; its Adam (``optim.dense=adam``) takes the
source's betas (0.9, 0.98). Its checkpoints, scoring, sharding,
pretraining, hand-off, L2 and file data are not supported, and asking for
them raises.

``train.prefetch`` (default true) stages the training batches, or chunks, on
a background thread, onto the card through pinned buffers and a side stream
(``data.DevicePrefetcher``). ``train.profile_dir`` writes a
``torch.profiler`` trace of the training phase, or of ``--score``'s
scoring, there, and the program's spans, counters and phase times beside it
(``utils/prof.py::trace``); ``train.debug_nans`` turns on autograd's anomaly mode and raises at the first step whose loss is
not finite, before that step's update: a graph cannot stop inside a replay,
so under this key every chunk runs as K eager steps with the check. Keys of
the shared config that are TPU mechanisms are read and have no effect
here: ``model.use_pallas`` (the device picks the kernels) and
``train.split_threshold`` (the one-hot split plan).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import sys
import time

import torch

from .config import RunConfig


def build_model(cfg, schema, device: torch.device | str):
    """The configured model, as the reference's ``build_model`` builds it."""
    from .models import (
        MlpSpec,
        make_deepfm,
        make_dlrm_dcnv2,
        make_fm,
        make_fnn,
        make_hstu,
        make_lr,
        make_pnn,
        make_snn,
        make_xdeepfm,
    )

    m = cfg.model
    mlp = MlpSpec(hidden=tuple(m.hidden), activation=m.activation,
                  dropout=m.dropout)
    if m.name == "lr":
        return make_lr(schema, device=device)
    if m.name == "fm":
        return make_fm(schema, k=m.k, init_sigma=m.init_sigma, device=device)
    if m.name == "fnn":
        return make_fnn(schema, k=m.k, mlp=mlp, init_sigma=m.init_sigma,
                        device=device)
    if m.name == "deepfm":
        return make_deepfm(schema, k=m.k, mlp=mlp, init_sigma=m.init_sigma,
                           device=device)
    if m.name in ("pnn", "ipnn", "opnn"):
        return make_pnn(schema, k=m.k,
                        product="outer" if m.name == "opnn" else "inner",
                        mlp=mlp, init_sigma=m.init_sigma, device=device)
    if m.name == "snn":
        return make_snn(schema, hidden1=m.hidden1, mlp=mlp,
                        init_sigma=m.init_sigma, device=device)
    if m.name == "dlrm_dcnv2":
        if m.activation != "relu" or m.dropout != 0.0:
            raise ValueError("dlrm_dcnv2 has ReLU layers and no dropout: set "
                             "model.activation=relu and model.dropout=0")
        return make_dlrm_dcnv2(schema, embed_dim=m.k, top=tuple(m.hidden),
                               init_sigma=m.init_sigma, device=device)
    if m.name == "xdeepfm":
        if m.activation != "relu" or m.dropout != 0.0:
            raise ValueError("xdeepfm's DNN has ReLU layers and no dropout: set "
                             "model.activation=relu and model.dropout=0")
        return make_xdeepfm(schema, k=m.k, dnn=tuple(m.hidden), init_sigma=m.init_sigma,
                            device=device)
    if m.name == "hstu":
        if len(m.hidden) != 3:
            raise ValueError("hstu takes model.hidden=[blocks, heads, head width], "
                             f"not {list(m.hidden)}")
        blocks, heads, width = (int(x) for x in m.hidden)
        return make_hstu(schema, k=m.k, blocks=blocks, heads=heads, d_qk=width, d_v=width,
                         dropout=m.dropout, device=device)
    raise ValueError(
        f"unknown model {m.name!r} (lr|fm|fnn|snn|deepfm|ipnn|opnn|dlrm_dcnv2|xdeepfm|hstu)"
    )


def build_optimizers(cfg):
    from .optim import make_dense_optimizer, make_sparse_optimizer

    kw = {}
    if cfg.optim.sparse == "adagrad":
        kw = {"eps": cfg.optim.eps, "mode": cfg.optim.sparse_mode}
    sparse = make_sparse_optimizer(cfg.optim.sparse, cfg.optim.sparse_lr, **kw)
    return sparse, make_dense_optimizer(cfg.optim.dense, cfg.optim.dense_lr)


def load_data(cfg, group=None):
    """Returns (schema, train_ids, train_labels, test_ids, test_labels), as
    the reference's ``load_data``.

    With ``data.stream=true`` the second element is a
    ``data.stream.StreamSource`` over the shard files of
    ``data.train_path`` (a file, glob or comma list) and the third is None;
    only the test set is read into RAM. Under ``train.distributed`` in a
    sharded run (``group``, this rank's place) the source is rank r's:
    shards ``epoch_order[r::N]`` in batches of B/N rows, the reference's
    process-local source. Without the key every rank streams every shard
    and makes the same global batches, of which it trains on its rows
    (``_sharded_parts``)."""
    from .data import Schema, featindex, ipinyou_like_schema, parser, synthetic
    from .data.cache import cache_text_file, read_cache
    from .data.criteo import criteo_schema, parse_criteo_file

    d = cfg.data
    if d.format not in ("yx", "criteo"):
        raise ValueError(f"unknown data format {d.format!r} (yx|criteo)")
    if d.stream and not d.train_path:
        raise ValueError("data.stream=true requires data.train_path "
                         "(shard file, glob, or comma list)")
    fi = None
    if d.featindex_path:
        if d.format != "yx":
            raise ValueError("data.featindex_path requires data.format=yx")
        fi = featindex.load_featindex(d.featindex_path, max_len=d.featindex_max_len)
        schema = fi.schema
    elif d.schema_path:
        with open(d.schema_path) as f:
            schema = Schema.from_json(f.read())
    elif d.format == "criteo":
        schema = criteo_schema(d.criteo_cat_buckets)
    else:
        schema = ipinyou_like_schema()

    if d.train_path is None:
        ds = synthetic.generate(
            schema, num_examples=d.synthetic_examples, seed=d.synthetic_seed,
            teacher=d.synthetic_teacher,
        )
        cut = int(ds.ids.shape[0] * (1 - d.test_fraction))
        return schema, ds.ids[:cut], ds.labels[:cut], ds.ids[cut:], ds.labels[cut:]

    def read(path):
        if fi is not None:
            if d.use_cache:
                return read_cache(featindex.cache_yx_file(path, fi, d.featindex_path))[:2]
            labels, ids = featindex.parse_yx_file(path, fi)
            return ids, labels
        if d.use_cache:
            return read_cache(cache_text_file(path, schema, fmt=d.format,
                                              use_native=d.use_native_parser))[:2]
        if d.format == "criteo":
            labels, ids = parse_criteo_file(path, schema,
                                            use_native=d.use_native_parser)
        else:
            labels, ids = parser.parse_yx_file(path, schema)
        return ids, labels

    if d.stream:
        if not d.test_path:
            raise ValueError(
                "data.stream=true requires data.test_path (the eval set is "
                "the only part materialized in RAM)"
            )
        from .data.stream import StreamSource

        rank, world = ((group.rank, group.world) if group is not None
                       and cfg.train.distributed else (0, 1))
        if cfg.train.batch_size % world:
            raise ValueError(f"train.batch_size {cfg.train.batch_size} must "
                             f"divide by the world size {world}")
        source = StreamSource(
            paths=d.train_path,
            schema=schema,
            batch_size=cfg.train.batch_size // world,
            fmt="yx-featindex" if fi is not None else d.format,
            buffer_rows=d.stream_buffer_rows,
            seed=cfg.train.seed,
            use_native=d.use_native_parser,
            featindex=fi,
            process_index=rank,
            process_count=world,
        )
        te_ids, te_labels = read(d.test_path)
        return schema, source, None, te_ids, te_labels

    tr_ids, tr_labels = read(d.train_path)
    if d.test_path:
        te_ids, te_labels = read(d.test_path)
    else:
        cut = int(tr_ids.shape[0] * (1 - d.test_fraction))
        tr_ids, te_ids = tr_ids[:cut], tr_ids[cut:]
        tr_labels, te_labels = tr_labels[:cut], tr_labels[cut:]
    return schema, tr_ids, tr_labels, te_ids, te_labels


def run(cfg, device: torch.device) -> dict:
    """Train the configured model on ``device``; returns the best AUC, its
    epoch, the per-epoch history and the final ``TrainState`` (with
    ``train.sharded``, this rank's ``parallel.ShardedTrainState``)."""
    if cfg.model.name in ("dlrm_dcnv2", "xdeepfm", "hstu"):
        _refuse_unsupported(cfg)
    with torch.autograd.set_detect_anomaly(cfg.train.debug_nans):
        if cfg.model.name == "hstu":
            return _run_hstu(cfg, device)
        if not cfg.train.sharded:
            return _run(cfg, device)
        from .parallel import process_group

        with process_group(device, cfg.train.num_devices) as group:
            return _run(cfg, group.device, group)


def _refuse_unsupported(cfg) -> None:
    """DLRM-DCNv2 and HSTU train on generated data in RAM on one device,
    xDeepFM on one device without checkpoints: raise for the options each
    does not take (the module's docstring)."""
    t, d = cfg.train, cfg.data
    unsupported = {"train.sharded": t.sharded, "train.checkpoint_path": t.checkpoint_path,
                   "train.resume": t.resume, "train.pretrain": t.pretrain,
                   "model.init_from": cfg.model.init_from}
    where = "on one device without checkpoints"
    if cfg.model.name in ("dlrm_dcnv2", "hstu"):
        unsupported.update({"data.train_path": d.train_path, "data.stream": d.stream})
        where = "on generated data in RAM on one device"
    if cfg.model.name == "hstu":
        unsupported["optim.l2"] = cfg.optim.l2
    asked = [k for k, v in unsupported.items() if v]
    if asked:
        raise ValueError(f"{cfg.model.name} trains {where}; "
                         f"it does not take {', '.join(asked)}")


def dense_input_data(cfg):
    """DLRM-DCNv2's data, generated from ``data.synthetic_seed`` (the
    module's docstring): ``(schema, (train ids, labels, dense), (test ids,
    labels, dense))``, the last ``data.test_fraction`` of the examples held
    out."""
    from .data import Schema, synthetic_dlrm

    d = cfg.data
    if d.schema_path:
        with open(d.schema_path) as f:
            schema = Schema.from_json(f.read())
    else:
        schema = synthetic_dlrm.mlperf_dlrm_schema(d.criteo_cat_buckets)
    data = synthetic_dlrm.generate(schema, d.synthetic_examples, seed=d.synthetic_seed)
    cut = int(len(data) * (1 - d.test_fraction))
    return schema, *((p.ids, p.labels, p.dense)
                     for p in (data.slice(slice(0, cut)), data.slice(slice(cut, None))))


def _run_hstu(cfg, device: torch.device) -> dict:
    """HSTU's training run (the module's docstring): ``{"history", "state"}``."""
    import numpy as np

    from .data import Schema, synthetic_hstu
    from .optim import Adam, make_dense_optimizer
    from .train.step import init_state, make_scan_train_step
    from .utils.logging import MetricsLogger
    from .utils.prof import trace

    d, t = cfg.data, cfg.train
    if d.schema_path:
        with open(d.schema_path) as f:
            schema = Schema.from_json(f.read())
    else:
        schema = synthetic_hstu.ml20m_schema()
    data = synthetic_hstu.generate(schema, d.synthetic_examples, seed=d.synthetic_seed)
    cut = int(len(data) * (1 - d.test_fraction))
    train_ids, test_ids = data.ids[:cut], data.ids[cut:]
    model = build_model(cfg, schema, device)
    dense_opt = (Adam(cfg.optim.dense_lr, b1=0.9, b2=0.98) if cfg.optim.dense == "adam"
                 else make_dense_optimizer(cfg.optim.dense, cfg.optim.dense_lr))
    state = init_state(model, schema, None, dense_opt, seed=t.seed)
    k, b = max(t.scan_steps, 1), t.batch_size
    step = make_scan_train_step(schema, None, dense_opt, check_finite=t.debug_nans)
    logger = MetricsLogger(t.metrics_path, echo=True)
    rng = np.random.default_rng(t.seed)
    pad = np.stack([np.full(schema.fields[0].max_len, schema.pad_id), np.zeros(
        schema.fields[0].max_len, dtype=np.int64)])
    history = []
    with trace(t.profile_dir):
        for epoch in range(t.epochs):
            order = rng.permutation(len(train_ids))
            steps = len(order) // b
            losses, t0 = [], time.perf_counter()
            for c in range(0, steps, k):
                live = min(k, steps - c)
                ids = np.broadcast_to(pad, (k, b) + pad.shape).copy()
                ids[:live] = train_ids[order[c * b:(c + live) * b]].reshape(
                    (live, b) + pad.shape)
                weights = torch.zeros(k, b)
                weights[:live] = 1.0
                state, loss = step(state, torch.from_numpy(ids).to(device),
                                   torch.zeros(k, b), weights)
                losses.append(loss[:live])
            mean = float(torch.cat(losses).mean()) if losses else float("nan")
            rec = {"epoch": epoch, "loss": mean, "steps": steps,
                   "examples_per_s": steps * b / max(time.perf_counter() - t0, 1e-9),
                   **_hstu_retrieval(model, test_ids, b, device)}
            logger.log(rec)
            history.append(rec)
    logger.log({"event": "done", "step": state.step})
    logger.close()
    return {"history": history, "state": state}


def _hstu_retrieval(model, ids, batch: int, device) -> dict:
    """Hit rate and NDCG at 10 of each held-out history's last item, ranked
    among every item by the (dropout-free) output at the position before
    it; histories shorter than 2 are left out."""
    import numpy as np

    lengths = (ids[:, 0] != model.pad_id).sum(1)
    ids = ids[lengths >= 2]
    lengths = lengths[lengths >= 2]
    hits = ndcg = 0.0
    for s in range(0, len(ids), batch):
        part = torch.from_numpy(ids[s:s + batch]).to(device)
        last = torch.from_numpy(lengths[s:s + batch] - 1).to(device)
        rows = torch.arange(part.shape[0], device=device)
        scores = model.scores(part, last - 1)
        target = part[rows, 0, last]
        rank = (scores > scores[rows, target][:, None]).sum(1).double()
        hits += float((rank < 10).sum())
        ndcg += float(torch.where(rank < 10, 1.0 / torch.log2(rank + 2.0), 0.0).sum())
    n = max(len(ids), 1)
    return {"hr@10": hits / n, "ndcg@10": ndcg / n, "eval_users": int(len(ids))}


def _run(cfg, device: torch.device, group=None) -> dict:
    from .data.stream import StreamSource
    from .train import fit, init_state, pretrain_snn
    from .utils.checkpoint import (
        init_fnn_from_fm,
        init_snn_from_pretrain,
        load_fm_embeddings,
        load_train_state,
        read_manifest,
        save_fm_embeddings,
        save_train_state,
        stored_table_dtype,
    )
    from .parallel import (
        RankLocalStream,
        count_shard_rows,
        host_state_from_sharded,
        load_host_shards,
        rank_zero_first,
        save_host_shards,
        shard_table_dtype,
    )
    from .utils.logging import MetricsLogger
    from .utils.prof import trace

    lead = group is None or group.rank == 0
    logger = MetricsLogger(cfg.train.metrics_path if lead else None, echo=lead)
    distributed = group is not None and cfg.train.distributed
    if cfg.train.distributed and group is None:
        logger.log({"event": "distributed_ignored", "reason":
                    "train.distributed has no effect without train.sharded"})
    tr_dense = te_dense = None
    if cfg.model.name == "dlrm_dcnv2":
        schema, (tr_ids, tr_labels, tr_dense), (te_ids, te_labels, te_dense) = \
            dense_input_data(cfg)
    else:
        with rank_zero_first(group):   # rank 0 writes the data cache the others read
            schema, tr_ids, tr_labels, te_ids, te_labels = load_data(cfg, group)
    train_source = tr_ids if isinstance(tr_ids, StreamSource) else None
    if train_source is not None:
        tr_ids = tr_labels = None
        if distributed:
            train_source = RankLocalStream(
                train_source, group, count_shard_rows(train_source, group), logger.log)
    model = build_model(cfg, schema, device)
    sparse_opt, dense_opt = build_optimizers(cfg)
    ckpt_path = cfg.train.checkpoint_path
    shards_dir = ckpt_path + ".hostshards" if distributed and ckpt_path else None
    from_shards = shards_dir is not None and os.path.isdir(shards_dir)
    resumed = from_shards or bool(cfg.train.resume and ckpt_path
                                  and os.path.exists(ckpt_path))
    # the dtype the table trains in. The reference's hand-offs replace the
    # table (deepctr_tpu/cli.py:277-280, 309-312): FNN seeded from an FM file
    # trains the file's table in the dtype stored there, SNN after
    # pretraining the pretraining's f32 table, whatever train.table_dtype
    # says; a resumed run skips the hand-off and takes its checkpoint's
    table_dtype = cfg.train.table_dtype
    fnn_handoff = cfg.model.name == "fnn" and bool(cfg.model.init_from)
    if fnn_handoff or (cfg.model.name == "snn" and cfg.train.pretrain):
        if from_shards:
            table_dtype = shard_table_dtype(shards_dir, group.rank)
        elif resumed:
            table_dtype = stored_table_dtype(ckpt_path)
        else:
            table_dtype = stored_table_dtype(cfg.model.init_from) if fnn_handoff else "f32"
    state = init_state(model, schema, sparse_opt, dense_opt, seed=cfg.train.seed,
                       table_dtype=table_dtype)
    start_epoch = 0
    if resumed and not from_shards:
        state = load_train_state(ckpt_path, state)
        start_epoch = int(read_manifest(ckpt_path).get("epoch", 0))
        logger.log({"event": "resumed", "path": ckpt_path, "step": state.step,
                    "epoch": start_epoch})
    # the two-phase flows, skipped when resuming (the checkpoint holds the
    # seeded or pretrained table). The FM -> FNN hand-off: for other models
    # init_from means nothing, as in the reference
    if not resumed and cfg.model.name == "fnn" and cfg.model.init_from:
        init_fnn_from_fm(model, load_fm_embeddings(cfg.model.init_from), table_dtype)
        logger.log({"event": "init_from_fm", "path": cfg.model.init_from,
                    "table_dtype": table_dtype})
    if not resumed and cfg.model.name == "snn" and cfg.train.pretrain:
        from .models import DaePretrainer, RbmPretrainer

        if train_source is not None:
            raise ValueError(
                "SNN pretraining iterates the training ids in RAM; use "
                "data.stream=false (or pretrain on a subsample file first "
                "and pass model.init_from)"
            )
        if cfg.train.pretrain not in ("dae", "rbm"):
            raise ValueError(f"train.pretrain {cfg.train.pretrain!r} (dae|rbm)")
        pre = (DaePretrainer(m=cfg.train.pretrain_m,
                             corruption=cfg.train.pretrain_corruption)
               if cfg.train.pretrain == "dae"
               else RbmPretrainer(m=cfg.train.pretrain_m))
        table, b1 = pretrain_snn(
            pre, schema, cfg.model.hidden1, tr_ids, sparse_opt=sparse_opt,
            dense_lr=cfg.train.pretrain_lr, batch_size=cfg.train.batch_size,
            epochs=cfg.train.pretrain_epochs, seed=cfg.train.seed, logger=logger,
            device=device)
        init_snn_from_pretrain(model, table, b1)
        del table
        logger.log({"event": "init_from_pretrain", "kind": cfg.train.pretrain,
                    "table_dtype": table_dtype})

    ckpt_meta = {"sparse_opt": cfg.optim.sparse, "model": cfg.model.name}
    sharded = {}
    if group is not None:
        sharded = _sharded_parts(cfg, schema, group, state, sparse_opt, dense_opt,
                                 te_ids, te_labels,
                                 rank_local=isinstance(train_source, RankLocalStream))
        state = sharded.pop("state")
    if from_shards:
        state, start_epoch = load_host_shards(shards_dir, state, group)
        logger.log({"event": "resumed_hostshards", "path": shards_dir,
                    "step": state.step, "epoch": start_epoch})

    def save(st, epoch: int, final: bool = False) -> None:
        if distributed:   # every rank writes its own shard file
            save_host_shards(shards_dir, st, group, epoch=epoch)
            if final:
                logger.log({"event": "saved_hostshards", "path": shards_dir,
                            "epoch": epoch})
            return
        # a sharded run's shards are gathered (every rank takes part) and
        # rank 0 writes the single-device layout
        host = st if group is None else host_state_from_sharded(st, group)
        if host is None:
            return
        save_train_state(ckpt_path, host, epoch=epoch, meta=ckpt_meta, schema=schema)
        if final and cfg.model.name == "fm":
            save_fm_embeddings(ckpt_path + ".fm_table", host.table)

    def on_epoch(epoch, st, rec):
        logger.log({"event": "heartbeat", "epoch": epoch, "step": st.step})
        if ckpt_path and (epoch + 1) % max(cfg.train.checkpoint_every, 1) == 0:
            save(st, epoch + 1)

    with trace(cfg.train.profile_dir), _release_graphs(sharded.get("scan_step")):
        res = fit(
            model, schema, tr_ids, tr_labels, te_ids, te_labels,
            sparse_opt=sparse_opt,
            dense_opt=dense_opt,
            batch_size=cfg.train.batch_size,
            epochs=cfg.train.epochs,
            l2=cfg.optim.l2,
            seed=cfg.train.seed,
            early_stop_patience=cfg.train.early_stop_patience,
            lr_decay=cfg.train.lr_decay,
            state=state,
            logger=logger,
            prefetch=cfg.train.prefetch,
            on_epoch=on_epoch,
            start_epoch=start_epoch,
            train_source=train_source,
            debug_nans=cfg.train.debug_nans,
            scan_steps=cfg.train.scan_steps,
            train_dense=tr_dense,
            test_dense=te_dense,
            **sharded,
        )
        if ckpt_path:
            epochs_done = start_epoch + sum(
                1 for r in res.history if not r.get("eval_only"))
            save(res.state, epochs_done, final=True)
    logger.log({"event": "done", "best_auc": res.best_auc})
    logger.close()
    return {"best_auc": res.best_auc, "best_epoch": res.best_epoch,
            "history": res.history, "state": res.state}


def _sharded_parts(cfg, schema, group, state, sparse_opt, dense_opt, te_ids,
                   te_labels, rank_local: bool = False) -> dict:
    """What ``fit`` runs in place of its single-device parts in a sharded
    run, the reference's ``_run_sharded``: the prepared state (checked
    equal on every rank) packed into this rank's shard, the sharded step
    and, with ``train.scan_steps`` K > 1, the sharded scan step (a chunk of
    K steps; K eager steps under ``train.debug_nans``), eval on the ranks'
    slices of every eval batch with the AUC histograms and the logloss sums
    all-reduced (every rank finalises them, so early stopping decides alike
    everywhere), and this rank's slice of every training batch, or of each
    step of every chunk, of B rows. A rank-local stream's batches and
    chunks (``rank_local``) are this rank's B/N rows already and pass as
    they are; each one's size is checked, since B/N rows that divide by N
    again would be cut a second time without error."""
    import torch.distributed as dist

    from .data import minibatches
    from .parallel import (
        check_ranks_agree,
        local_batch,
        local_chunk,
        make_sharded_eval_step,
        make_sharded_scan_train_step,
        make_sharded_train_step,
        sharded_state_from_state,
    )
    from .utils import metrics as M

    batch_size = cfg.train.batch_size
    if batch_size % group.world:
        raise ValueError(f"train.batch_size {batch_size} must divide by the "
                         f"world size {group.world}")
    check_ranks_agree(state, group)
    state = sharded_state_from_state(state, group)
    eval_step = make_sharded_eval_step(
        schema, group, capacity_factor=cfg.train.capacity_factor,
        exchange_dtype=cfg.train.exchange_dtype)
    device = group.device

    def sharded_eval(st) -> dict:
        auc = M.auc_state_init(device=device)
        sums = torch.zeros(2, dtype=torch.float64, device=device)  # logloss, weight
        for b in minibatches(te_ids, te_labels, batch_size, schema=schema,
                             shuffle=False, drop_remainder=False):
            b = local_batch(b, group)
            logits = eval_step(st.model, b.ids)
            labels = torch.from_numpy(b.labels).to(device)
            weights = torch.from_numpy(b.weights).to(device)
            M.auc_state_update(auc, logits, labels, weights)
            ll = -(labels * torch.nn.functional.logsigmoid(logits)
                   + (1 - labels) * torch.nn.functional.logsigmoid(-logits))
            sums += torch.stack([(ll * weights).sum(), weights.sum()]).double()
        for t in (auc.pos, auc.neg, sums):
            dist.all_reduce(t)
        return {"auc": M.auc_state_finalize(auc),
                "logloss": float(sums[0]) / max(float(sums[1]), 1.0)}

    kw = dict(l2=cfg.optim.l2, capacity_factor=cfg.train.capacity_factor,
              exchange_dtype=cfg.train.exchange_dtype,
              check_finite=cfg.train.debug_nans)
    chunked = cfg.train.scan_steps > 1
    if rank_local:
        transform = functools.partial(_local_rows, chunked=chunked)
    else:
        transform = local_chunk if chunked else local_batch
    parts = {
        "state": state,
        "step": make_sharded_train_step(schema, sparse_opt, dense_opt, group, **kw),
        "evaluate_state": sharded_eval,
        "batch_transform": functools.partial(transform, group=group,
                                             global_rows=batch_size),
    }
    if chunked:
        parts["scan_step"] = make_sharded_scan_train_step(
            schema, sparse_opt, dense_opt, group, **kw)
    return parts


@contextlib.contextmanager
def _release_graphs(scan_step):
    """Release the sharded scan step's CUDA graphs when the block ends, by
    an error too. A graph that captured NCCL collectives holds the
    communicator's resources, and destroying the process group waits for
    them forever while it lives; an error's traceback would keep it alive
    through ``fit``'s frame."""
    try:
        yield
    finally:
        if scan_step is not None:
            scan_step.graph.clear()


def _local_rows(item, group, global_rows: int, chunked: bool = False):
    """A rank-local batch, or chunk (``chunked``), checked to hold this
    rank's B/N rows a step."""
    rows = item[1][0].shape[1] if chunked else item.ids.shape[0]
    if rows != global_rows // group.world:
        raise ValueError(f"a rank-local batch of {rows} rows; rank "
                         f"{group.rank} of {group.world} takes "
                         f"{global_rows // group.world} of every {global_rows}")
    return item


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="deepctr_torch",
        description="CTR training and scoring on PyTorch/CUDA (LR, FM, FNN, "
        "SNN, DeepFM, IPNN/OPNN; training DLRM-DCNv2, xDeepFM and HSTU)",
    )
    ap.add_argument("--config", help="JSON config path (defaults applied)")
    ap.add_argument(
        "overrides", nargs="*",
        help="dotted overrides, e.g. train.checkpoint_path=fnn.ckpt train.batch_size=8192",
    )
    ap.add_argument("--print-config", action="store_true",
                    help="print the resolved config as JSON and exit")
    ap.add_argument(
        "--score", metavar="YX_FILE",
        help="score a yx file with the checkpoint at train.checkpoint_path "
        "and print one probability per line",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device to train or score on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = RunConfig.load(args.config) if args.config else RunConfig()
    cfg = cfg.apply_overrides(args.overrides)
    if args.print_config:
        print(cfg.to_json())
        return 0
    if args.score:
        return score(cfg, args.score, resolve_device(args.device))
    run(cfg, resolve_device(args.device))
    return 0


def score(cfg, yx_path: str, device: torch.device) -> int:
    """Offline scoring surface (the reference's pred_fn role).

    The schema comes from the checkpoint manifest; config-derived schemas
    are only a fallback for pre-``schema_json`` checkpoints. With
    ``data.featindex_path`` set, the yx file's raw make-ipinyou-data indices
    are remapped through the featindex exactly as at training time. With
    ``train.profile_dir`` set the scoring runs under ``utils/prof.py::trace``.
    """
    from .serving import Scorer
    from .data import Schema, featindex
    from .utils.checkpoint import read_manifest
    from .utils.prof import trace

    if not cfg.train.checkpoint_path:
        raise SystemExit("--score requires train.checkpoint_path")
    manifest = read_manifest(cfg.train.checkpoint_path)

    fi = None
    if cfg.data.featindex_path:
        fi = featindex.load_featindex(
            cfg.data.featindex_path, max_len=cfg.data.featindex_max_len
        )
    if "schema_json" in manifest:
        schema = Schema.from_json(manifest["schema_json"])
        if fi is not None and fi.schema.to_json() != schema.to_json():
            raise SystemExit(
                "featindex schema does not match the checkpoint's training "
                "schema — regenerated featindex? Retrain or point "
                "data.featindex_path at the file used for training."
            )
    elif fi is not None:
        schema = fi.schema
    else:
        schema = _load_schema_only(cfg)
    model = build_model(cfg, schema, device)
    scorer = Scorer.from_checkpoint(
        cfg.train.checkpoint_path, model, schema, batch_size=cfg.train.batch_size
    )
    with trace(cfg.train.profile_dir):
        if fi is not None:
            _, ids = featindex.parse_yx_file(yx_path, fi)
            for p in scorer.predict(ids):
                print(f"{p:.6f}")
            return 0
        for chunk in scorer.score_yx_file(yx_path, cfg.data.use_native_parser):
            for p in chunk:
                print(f"{p:.6f}")
    return 0


def _load_schema_only(cfg):
    """Config-derived schema — fallback for checkpoints without schema_json."""
    from .data import Schema, ipinyou_like_schema
    from .data.criteo import criteo_schema

    if cfg.data.schema_path:
        with open(cfg.data.schema_path) as f:
            return Schema.from_json(f.read())
    if cfg.data.format == "criteo":
        return criteo_schema(cfg.data.criteo_cat_buckets)
    return ipinyou_like_schema()


if __name__ == "__main__":
    sys.exit(main())
