"""CLI entry point: ``python -m deepctr_torch.cli --score YX_FILE ...``.

Port of ``deepctr_tpu/cli.py`` for the serving path. It reads the same
``configs/*.json`` and dotted overrides (``deepctr_tpu.config.RunConfig``)
and scores a yx file with a checkpoint written by either package, printing
one probability per line. ``--device`` names where the model runs, and the
device alone picks the tower: on CUDA the fused kernel, on the CPU its plain
version. ``model.use_pallas`` is read with the rest of the JAX package's
config and has no effect here. Asking for CUDA where there is none raises.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .shared import RunConfig


def build_model(cfg, schema, device: torch.device | str):
    from .models import MlpSpec, make_fnn

    m = cfg.model
    if m.name == "fnn":
        return make_fnn(
            schema,
            k=m.k,
            mlp=MlpSpec(hidden=tuple(m.hidden), activation=m.activation),
            device=device,
        )
    raise NotImplementedError(
        f"model {m.name!r} is not ported to deepctr_torch yet (ROADMAP.md, "
        f"'Modules still to port', slice 3: the rest of the model family)"
    )


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="deepctr_torch",
        description="CTR scoring on PyTorch/CUDA (FNN)",
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
                    help="torch device to score on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = RunConfig.load(args.config) if args.config else RunConfig()
    cfg = cfg.apply_overrides(args.overrides)
    if args.score:
        return score(cfg, args.score, resolve_device(args.device))
    raise NotImplementedError(
        "training is not ported to deepctr_torch yet (ROADMAP.md, 'Modules "
        "still to port', slice 2); use --score"
    )


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
