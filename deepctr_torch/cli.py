"""CLI entry point: ``python -m deepctr_torch.cli --config configs/fnn.json``.

Port of ``deepctr_tpu/cli.py`` for FNN: it reads the same
``configs/*.json`` and dotted overrides (``deepctr_tpu.config.RunConfig``),
trains (``run``: data, model, optimizers, the FM -> FNN hand-off, ``fit``,
checkpoints and JSONL metrics), or with ``--score`` scores a yx file with a
checkpoint written by either package, printing one probability per line.
``--device`` names where the model runs, and the device alone picks the
tower: on CUDA the fused kernels, on the CPU their plain versions. Asking
for CUDA where there is none raises.

Keys of the shared config that are TPU mechanisms are read and have no
effect here: ``model.use_pallas`` (the device picks the kernels),
``train.scan_steps`` (``lax.scan`` dispatch), ``train.split_threshold`` (the
one-hot split plan) and ``train.prefetch`` (the JAX device prefetcher).
Keys the port does not honour yet raise ``NotImplementedError`` when set
away from their defaults (``UNPORTED_KEYS``).
"""

from __future__ import annotations

import argparse
import sys

import torch

from .shared import RunConfig

# config key -> the ROADMAP.md item that will honour it
UNPORTED_KEYS = {
    "train.sharded": "slice 5, item 15 (row-sharded multi-GPU training)",
    "train.distributed": "slice 5, item 16 (multi-process runs)",
    "data.stream": "slice 4, item 13 (streaming input to fit)",
    "train.pretrain": "slice 3, item 9 (SNN and its pretraining)",
    "train.profile_dir": "slice 4, item 13 (the CLI's profiler hook)",
    "train.resume": "slice 4, item 11 (train-state resume)",
    "train.debug_nans": "slice 4, item 13 (the CLI's NaN check)",
}


def build_model(cfg, schema, device: torch.device | str):
    from .models import MlpSpec, make_fnn

    m = cfg.model
    if m.name == "fnn":
        return make_fnn(
            schema,
            k=m.k,
            mlp=MlpSpec(hidden=tuple(m.hidden), activation=m.activation,
                        dropout=m.dropout),
            init_sigma=m.init_sigma,
            device=device,
        )
    raise NotImplementedError(
        f"model {m.name!r} is not ported to deepctr_torch yet (ROADMAP.md, "
        f"'Modules still to port', slice 3: the rest of the model family)"
    )


def build_optimizers(cfg):
    from .optim import make_dense_optimizer, make_sparse_optimizer

    kw = {}
    if cfg.optim.sparse == "adagrad":
        kw = {"eps": cfg.optim.eps, "mode": cfg.optim.sparse_mode}
    sparse = make_sparse_optimizer(cfg.optim.sparse, cfg.optim.sparse_lr, **kw)
    return sparse, make_dense_optimizer(cfg.optim.dense, cfg.optim.dense_lr)


def check_ported(cfg) -> None:
    """Raise for a key the port does not honour yet, set away from its
    default."""
    default = RunConfig()
    for key, item in UNPORTED_KEYS.items():
        section, name = key.split(".")
        if getattr(getattr(cfg, section), name) != getattr(getattr(default, section), name):
            raise NotImplementedError(
                f"{key} is not ported to deepctr_torch yet (ROADMAP.md, "
                f"'Modules still to port', {item})"
            )


def load_data(cfg):
    """Returns (schema, train_ids, train_labels, test_ids, test_labels), as
    the reference's ``load_data`` without its streaming branch."""
    from .shared import (
        Schema,
        cache_text_file,
        criteo_schema,
        featindex,
        ipinyou_like_schema,
        parse_criteo_file,
        parser,
        read_cache,
        synthetic,
    )

    d = cfg.data
    if d.format not in ("yx", "criteo"):
        raise ValueError(f"unknown data format {d.format!r} (yx|criteo)")
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
    epoch, the per-epoch history and the final ``TrainState``."""
    from .train import fit, init_state
    from .utils.checkpoint import init_fnn_from_fm, load_fm_embeddings, save_train_state
    from .utils.logging import MetricsLogger

    check_ported(cfg)
    schema, tr_ids, tr_labels, te_ids, te_labels = load_data(cfg)
    model = build_model(cfg, schema, device)
    sparse_opt, dense_opt = build_optimizers(cfg)
    logger = MetricsLogger(cfg.train.metrics_path, echo=True)
    state = init_state(model, schema, sparse_opt, dense_opt, seed=cfg.train.seed,
                       table_dtype=cfg.train.table_dtype)
    if cfg.model.init_from:
        init_fnn_from_fm(model, load_fm_embeddings(cfg.model.init_from))
        logger.log({"event": "init_from_fm", "path": cfg.model.init_from})

    ckpt_meta = {"sparse_opt": cfg.optim.sparse, "model": cfg.model.name}

    def on_epoch(epoch, st, rec):
        logger.log({"event": "heartbeat", "epoch": epoch, "step": st.step})
        if (cfg.train.checkpoint_path
                and (epoch + 1) % max(cfg.train.checkpoint_every, 1) == 0):
            save_train_state(cfg.train.checkpoint_path, st, epoch=epoch + 1,
                             meta=ckpt_meta, schema=schema)

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
        on_epoch=on_epoch,
    )
    if cfg.train.checkpoint_path:
        epochs_done = sum(1 for r in res.history if not r.get("eval_only"))
        save_train_state(cfg.train.checkpoint_path, res.state, epoch=epochs_done,
                         meta=ckpt_meta, schema=schema)
    logger.log({"event": "done", "best_auc": res.best_auc})
    logger.close()
    return {"best_auc": res.best_auc, "best_epoch": res.best_epoch,
            "history": res.history, "state": res.state}


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="deepctr_torch",
        description="CTR training and scoring on PyTorch/CUDA (FNN)",
    )
    ap.add_argument("--config", help="JSON config path (defaults applied)")
    ap.add_argument(
        "overrides", nargs="*",
        help="dotted overrides, e.g. train.checkpoint_path=fnn.ckpt train.batch_size=8192",
    )
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
    if args.score:
        return score(cfg, args.score, resolve_device(args.device))
    run(cfg, resolve_device(args.device))
    return 0


def score(cfg, yx_path: str, device: torch.device) -> int:
    """Offline scoring surface (the reference's pred_fn role).

    The schema comes from the checkpoint manifest; config-derived schemas
    are only a fallback for pre-``schema_json`` checkpoints. With
    ``data.featindex_path`` set, the yx file's raw make-ipinyou-data indices
    are remapped through the featindex exactly as at training time.
    """
    from .serving import Scorer
    from .shared import Schema, featindex
    from .utils.checkpoint import read_manifest

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
    from .shared import Schema, criteo_schema, ipinyou_like_schema

    if cfg.data.schema_path:
        with open(cfg.data.schema_path) as f:
            return Schema.from_json(f.read())
    if cfg.data.format == "criteo":
        return criteo_schema(cfg.data.criteo_cat_buckets)
    return ipinyou_like_schema()


if __name__ == "__main__":
    sys.exit(main())
