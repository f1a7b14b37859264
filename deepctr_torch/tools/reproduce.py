"""One-command reproduction of the reference's experiment suite, on the port.

The counterpart of ``tools/reproduce.py``, which writes ``RESULTS.md`` with
the JAX package, under the same protocol flag for flag: the model family
(LR, FM, FNN seeded from FM's table, SNN-DAE and SNN-RBM after pretraining,
DeepFM, IPNN, OPNN) trained on one shared synthetic dataset (120,000
examples, seed 7, ``teacher=ortho``; 8 epochs of batch 512, k=10, tower
200-300-100, ``train.scan_steps`` 8, SNN ``hidden1`` 200 with m=2), led by
the tuned-per-model table (each model's best ``TUNE_GRID`` config at 3x the
epochs), then the shared-budget table, the SNN optimizer mechanism, the
converged budget, and the three hyperparameter studies:

  --study shapes          FNN hidden-architecture shapes at ~600 total units
  --study regularization  dropout vs L2 on FNN at the converged budget
  --study sampling        SNN-DAE negative-sample count m in {1, 2, 4}
  --study all             all three

What differs from the JAX tool:
- every run goes through the port's entry point, ``deepctr_torch.cli.run(cfg,
  device)``: on the card the default scan route, one CUDA graph of 8 steps
  replayed a chunk, through the hand-written tower and FM scorer kernels;
  ``--device cpu`` runs the plain versions; ``--device cuda`` without a
  card raises;
- the header names the card and its power limit (``nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader``), the device, the
  torch and CUDA versions and the suite's wall time;
- every table has three more columns: the run's peak device memory
  (``torch.cuda.max_memory_allocated``), its median epoch rate (the CLI
  record's ``examples_per_s``: the epoch's steps over its host clock, the
  graph's capture in the first) and ``RESULTS.md AUC``, the reference's row
  of the same label in the same section, read from ``RESULTS.md`` as a file
  (in the tuned table the row of the same model, whichever config won there;
  in the regularization table its late AUC);
- the stamp comes from ``deepctr_torch/utils/artifacts.py``.

Usage:
  python -m deepctr_torch.tools.reproduce --study all            # on the card
  python -m deepctr_torch.tools.reproduce --models lr,fnn --examples 4000 \\
      --epochs 1 --batch 256 --no-tuned --no-convergence-study --device cpu
"""

from __future__ import annotations

import argparse
import copy
import gc
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

from ..utils.artifacts import REPO_ROOT, float_or_none, parse_md_table, protocol_stamp

TOOL = "deepctr_torch/tools/reproduce.py"

MODELS = ("lr", "fm", "fnn", "snn_dae", "snn_rbm", "deepfm", "ipnn", "opnn")

# Tuned-within-budget grids, the reference's (tools/reproduce.py): each model
# sweeps optimizer x lr x dropout within one shared epoch budget and reports
# its best test AUC. Entries: (tag, optimizer, sparse_lr, dense_lr,
# dropout-or-None)
TUNE_GRID = {
    "lr": [("sgd1.0", "sgd", 1.0, 1.0, None),
           ("ada.05/.02", "adagrad", 0.05, 0.02, None),
           ("ada.1/.05", "adagrad", 0.1, 0.05, None)],
    "fm": [("sgd.3", "sgd", 0.3, 0.3, None),
           ("ada.05/.02", "adagrad", 0.05, 0.02, None),
           ("ada.1/.05", "adagrad", 0.1, 0.05, None)],
    "fnn": [("sgd.3", "sgd", 0.3, 0.3, 0.0),
            ("sgd1.0", "sgd", 1.0, 1.0, 0.0),
            ("ada.1/.1", "adagrad", 0.1, 0.1, 0.0),
            ("sgd.3 dr.25", "sgd", 0.3, 0.3, 0.25)],
    "snn_dae": [("sgd1.0", "sgd", 1.0, 1.0, 0.0),
                ("ada.1/.05", "adagrad", 0.1, 0.05, 0.0),
                ("ada.2/.1", "adagrad", 0.2, 0.1, 0.0),
                ("ada.3/.15", "adagrad", 0.3, 0.15, 0.0)],
    "snn_rbm": [("sgd1.0", "sgd", 1.0, 1.0, 0.0),
                ("ada.1/.05", "adagrad", 0.1, 0.05, 0.0),
                ("ada.2/.1", "adagrad", 0.2, 0.1, 0.0),
                ("ada.3/.15", "adagrad", 0.3, 0.15, 0.0)],
    "deepfm": [("ada.05/.02", "adagrad", 0.05, 0.02, 0.0),
               ("ada.1/.05", "adagrad", 0.1, 0.05, 0.0)],
    "ipnn": [("ada.05/.02", "adagrad", 0.05, 0.02, 0.0),
             ("ada.1/.05", "adagrad", 0.1, 0.05, 0.0)],
    "opnn": [("ada.05/.02", "adagrad", 0.05, 0.02, 0.0),
             ("ada.1/.05", "adagrad", 0.1, 0.05, 0.0)],
}

# ~600 total hidden units in four layouts (the paper's architecture study)
SHAPES = {
    "constant": (200, 200, 200),
    "increasing": (100, 200, 300),
    "decreasing": (300, 200, 100),
    "diamond": (150, 300, 150),
}

# each table's section in RESULTS.md, by the start of its title
REFERENCE_SECTIONS = {
    "tuned": "### Model family — tuned per model",
    "family": "### Model family (shared dataset",
    "mechanism": "### SNN optimizer mechanism",
    "converged": "### Converged budget",
    "shapes": "### FNN architecture shapes",
    "regularization": "### FNN regularization",
    "sampling": "### SNN-DAE negative-sample count",
}


def base_config(args) -> dict:
    data = {
        "train_path": args.train,
        "test_path": args.test,
        "schema_path": args.schema,
        "featindex_path": args.featindex,
        "synthetic_examples": args.examples,
        "synthetic_seed": 7,
        "synthetic_teacher": args.teacher,
    }
    train = {
        "batch_size": args.batch,
        "epochs": args.epochs,
        "seed": args.seed,
        "early_stop_patience": args.patience,
        "scan_steps": 8,
    }
    optim = {
        "sparse": args.optimizer, "sparse_lr": args.sparse_lr,
        "dense": args.optimizer, "dense_lr": args.dense_lr, "l2": 0.0,
    }
    return {"data": data, "train": train, "optim": optim}


def model_config(name: str, args, fm_ckpt: str) -> dict:
    """Per-model RunConfig dict on top of the shared base."""
    cfg = base_config(args)
    if name == "lr":
        cfg["model"] = {"name": "lr"}
    elif name == "fm":
        cfg["model"] = {"name": "fm", "k": args.k}
        cfg["train"]["checkpoint_path"] = fm_ckpt
    elif name == "fnn":
        cfg["model"] = {
            "name": "fnn", "k": args.k, "hidden": list(args.hidden),
            "dropout": args.dropout, "init_from": fm_ckpt + ".fm_table",
        }
    elif name in ("snn_dae", "snn_rbm"):
        cfg["model"] = {"name": "snn", "hidden": list(args.hidden),
                        "dropout": args.dropout, "hidden1": 200}
        cfg["train"]["pretrain"] = name.split("_")[1]
        cfg["train"]["pretrain_m"] = args.m
        cfg["train"]["pretrain_epochs"] = 1
    elif name == "deepfm":
        cfg["model"] = {"name": "deepfm", "k": args.k,
                        "hidden": list(args.hidden), "dropout": args.dropout}
    elif name in ("ipnn", "opnn"):
        cfg["model"] = {"name": name, "k": args.k,
                        "hidden": list(args.hidden), "dropout": args.dropout}
    else:
        raise ValueError(f"unknown model {name!r}")
    return cfg


def train_one(raw_cfg: dict, label: str, device: torch.device) -> dict:
    """One run through ``cli.run``: best AUC, its epoch and logloss, late
    AUC, wall s, peak device MiB (None on the CPU) and the median epoch
    rate. The run's state is released before it returns."""
    from ..cli import run
    from ..config import RunConfig

    cfg = RunConfig.from_dict(raw_cfg)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = run(cfg, device)
    if cuda:
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    best = res.get("best_epoch")
    row = {"label": label, "auc": float(res["best_auc"]),
           "best_epoch": best, "seconds": secs,
           "peak_mib": torch.cuda.max_memory_allocated(device) / 2**20 if cuda else None}
    hist = [rec for rec in res.get("history", []) if "auc" in rec]
    for rec in hist:
        if rec.get("epoch") == best and "logloss" in rec:
            row["logloss"] = float(rec["logloss"])
    if hist:
        # late-epoch AUC (mean of the last 3 evals): the overfitting-regime
        # observable the converged-budget regularization study gates on
        row["late_auc"] = float(np.mean([r["auc"] for r in hist[-3:]]))
    rates = [r["examples_per_s"] for r in hist if "examples_per_s" in r]
    row["examples_per_s"] = float(np.median(rates)) if rates else None
    del res   # the model, its table and the optimizers' states
    gc.collect()
    return row


def reference_aucs(path: str) -> dict:
    """``{section: {label: AUC}}`` from the reference's ``RESULTS.md`` (the
    regularization study's late AUC); empty where the file is missing."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        text = f.read()
    out = {}
    for key, title in REFERENCE_SECTIONS.items():
        start = text.find(title)
        if start < 0:
            continue
        end = text.find("\n###", start + 3)   # parse_md_table reads on past
        section = text[start:] if end < 0 else text[start:end]   # blank lines
        col = "late AUC (last 3 ep)" if key == "regularization" else "AUC"
        out[key] = {_reference_label(key, r["run"]): float_or_none(r[col])
                    for r in parse_md_table(section) if col in r}
    return out


def _reference_label(section: str, label: str) -> str:
    """The tuned table's rows match by model, whatever config won."""
    return label.split("[")[0].strip() if section == "tuned" else label


def _num(value, fmt: str) -> str:
    return "—" if value is None else format(value, fmt)


def fmt_table(rows, title, section, reference, late=False) -> str:
    ref = reference.get(section, {})
    extra = "| peak MiB | examples/s | RESULTS.md "
    cols = f"| run | AUC | logloss | best epoch | wall s {extra}AUC |"
    if late:
        cols = (f"| run | best AUC | late AUC (last 3 ep) | best epoch | wall s "
                f"{extra}late AUC |")
    out = [f"### {title}", "", cols, "|---" * 8 + "|"]
    for r in rows:
        if late:
            mid = f"{r.get('late_auc', float('nan')):.4f}"
        else:
            mid = f"{r['logloss']:.5f}" if "logloss" in r else "—"
        out.append(
            f"| {r['label']} | {r['auc']:.4f} | {mid} | {r['best_epoch']} | "
            f"{r['seconds']:.1f} | {_num(r['peak_mib'], '.0f')} | "
            f"{_num(r['examples_per_s'], '.0f')} | "
            f"{_num(ref.get(_reference_label(section, r['label'])), '.4f')} |"
        )
    out.append("")
    return "\n".join(out)


def card_line() -> str | None:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def run_tuned_family(args, names, tmp, device) -> list:
    """The headline protocol: the paper tuned hyperparameters per model, so
    the leading table gives every model its best config from TUNE_GRID under
    one shared epoch budget and reports that config's test AUC."""
    fm_best_ckpt = os.path.join(tmp, "fm_tuned.ckpt")
    rows = []
    for name in names:
        best = None
        for tag, opt, slr, dlr, drop in TUNE_GRID[name]:
            a = copy.copy(args)
            a.optimizer, a.sparse_lr, a.dense_lr = opt, slr, dlr
            a.epochs = 3 * args.epochs  # tuned budget: room to converge;
            # best-epoch selection inside it is part of the per-model tuning
            if drop is not None:
                a.dropout = drop
            safe = "".join(ch if ch.isalnum() or ch in "._-" else "_"
                           for ch in tag)
            ckpt = (os.path.join(tmp, f"fm_{safe}.ckpt")
                    if name == "fm" else fm_best_ckpt)
            cfg = model_config(name, a, ckpt)
            print(f"=== tuned {name} [{tag}] ===", flush=True)
            r = train_one(cfg, f"{name} [{tag}]", device)
            r["tag"], r["ckpt"] = tag, ckpt
            if best is None or r["auc"] > best["auc"]:
                best = r
        if name == "fm":
            # the FNN grid initialises from the best FM's embeddings (the
            # reference's two-script hand-off, at its tuned operating point)
            src = best["ckpt"] + ".fm_table"
            if os.path.exists(src):
                shutil.copyfile(src, fm_best_ckpt + ".fm_table")
        rows.append(best)
    return rows


SUBSTRATE_NOTE = (
    "**Why this substrate (teacher=ortho):** the reference's `RESULTS.md` "
    "gives the measurements behind it (`python tools/substrate_lab.py --exp "
    "all`). Its RANK-2 centered pairwise tier over the small dense fields is "
    "invisible to LR (zero first-order ANOVA under the sampling marginals), "
    "exactly representable by FM and learnable by the deep family, so FM and "
    "OPNN top the table by construction; the paper's FNN > FM on real "
    "iPinYou is not claimed here.\n"
)


def parse_args(argv=None) -> argparse.Namespace:
    """The tool's flags (``[]``: the protocol's defaults)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--models", default=",".join(MODELS),
                   help="comma list out of: " + ",".join(MODELS))
    p.add_argument("--study", default="none",
                   choices=["none", "shapes", "regularization", "sampling", "all"])
    p.add_argument("--examples", type=int, default=120_000,
                   help="synthetic dataset size (ignored with --train)")
    p.add_argument("--teacher", default="ortho", choices=["fm", "mlp", "ortho"],
                   help="planted synthetic process (the reference tool's)")
    p.add_argument("--train"), p.add_argument("--test")
    p.add_argument("--schema"), p.add_argument("--featindex")
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--m", type=int, default=2)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--optimizer", default="adagrad", choices=["sgd", "adagrad"],
                   help="shared-table optimizer of the shared-budget tables")
    p.add_argument("--sparse-lr", type=float, default=0.1)
    p.add_argument("--dense-lr", type=float, default=0.05)
    p.add_argument("--patience", type=int, default=99,
                   help="early-stop patience; the default runs the full budget "
                   "(best-epoch AUC is reported either way)")
    p.add_argument("--hidden", default="200,300,100",
                   type=lambda s: tuple(int(x) for x in s.split(",")))
    p.add_argument("--convergence-study", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="also emit the SNN optimizer-mechanism table and the "
                   "3x-epoch converged-budget family table")
    p.add_argument("--tuned", action=argparse.BooleanOptionalAction, default=True,
                   help="lead with the tuned-per-model family table")
    p.add_argument("--device", default="cuda",
                   help="torch device of every run (default: cuda)")
    p.add_argument("--out", default="RESULTS_TORCH.md")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the suite and write ``--out``; returns ``{"tables": {section:
    rows}, "seconds": suite wall s, "runs": runs}``."""
    from ..cli import resolve_device

    args = parse_args(argv)

    device = resolve_device(args.device)
    reference = reference_aucs(os.path.join(REPO_ROOT, "RESULTS.md"))
    t_suite = time.perf_counter()
    sections, tables = [], {}

    names = [m.strip() for m in args.models.split(",") if m.strip()]
    if "fnn" in names and "fm" not in names:
        names.insert(0, "fm")  # FNN needs the FM embedding checkpoint
    # FM must run before FNN (the reference's two-script hand-off)
    names.sort(key=lambda n: (n != "fm"))

    def table(key, rows, title, late=False):
        tables[key] = rows
        sections.append(fmt_table(rows, title, key, reference, late=late))

    with tempfile.TemporaryDirectory(prefix="deepctr_torch_reproduce_") as tmp:
        fm_ckpt = os.path.join(tmp, "fm.ckpt")
        if args.tuned:
            table("tuned", run_tuned_family(args, names, tmp, device),
                  "Model family — tuned per model (HEADLINE; each model's best "
                  "config from its TUNE_GRID sweep under a shared "
                  f"{3 * args.epochs}-epoch budget with best-epoch selection — "
                  "the paper's per-model-tuning protocol)")

        rows = []
        for name in names:
            print(f"=== {name} ===", flush=True)
            rows.append(train_one(model_config(name, args, fm_ckpt), name, device))
        rows.sort(key=lambda r: MODELS.index(r["label"]))  # display order
        table("family", rows, "Model family (shared dataset, shared budget)")

        if args.convergence_study:
            # 1. SNN optimizer mechanism: 2-epoch SGD against 2-epoch Adagrad
            # at matched everything else
            mrows = []
            for opt_name, opt, slr, dlr in (("sgd", "sgd", 0.3, 0.3),
                                            ("adagrad", "adagrad", 0.1, 0.05)):
                args2 = copy.copy(args)
                args2.optimizer, args2.sparse_lr, args2.dense_lr = opt, slr, dlr
                args2.epochs = 2
                for name in ("snn_dae", "snn_rbm"):
                    print(f"=== mechanism {name} {opt_name}@2 ===", flush=True)
                    mrows.append(train_one(model_config(name, args2, fm_ckpt),
                                           f"{name} {opt_name}@2ep", device))
            table("mechanism", mrows,
                  "SNN optimizer mechanism — 2-epoch Adagrad vs 2-epoch SGD at "
                  "matched everything-else; the SGD gap is conditioning of the "
                  "σ-sum bottom layer, not model quality "
                  "(gated: tests/test_torch_artifacts.py)")

            # 2. converged budget under the family table's one shared config
            args3 = copy.copy(args)
            args3.epochs = 3 * args.epochs
            fm_ckpt3 = os.path.join(tmp, "fm_conv.ckpt")
            crows = []
            for name in ("fm", "lr", "fnn", "snn_dae", "snn_rbm"):
                print(f"=== converged {name} ===", flush=True)
                crows.append(train_one(model_config(name, args3, fm_ckpt3), name,
                                       device))
            crows.sort(key=lambda r: MODELS.index(r["label"]))
            table("converged", crows,
                  f"Converged budget ({args3.epochs} epochs, same shared "
                  f"{args.optimizer}) — on this substrate the ordering persists "
                  "at convergence")
            sections.append(SUBSTRATE_NOTE)

        studies = ([args.study] if args.study not in ("none", "all")
                   else ["shapes", "regularization", "sampling"]
                   if args.study == "all" else [])
        for study in studies:
            srows = []
            if study == "shapes":
                argss = copy.copy(args)  # FNN's tuned operating point
                argss.optimizer, argss.sparse_lr, argss.dense_lr = "sgd", 0.3, 0.3
                for shape, hidden in SHAPES.items():
                    cfg = model_config("fnn", argss, fm_ckpt)
                    cfg["model"]["hidden"] = list(hidden)
                    print(f"=== fnn shape {shape} {hidden} ===", flush=True)
                    srows.append(train_one(cfg, f"fnn {shape} {hidden}", device))
                table("shapes", srows, "FNN architecture shapes (~600 hidden units)")
            elif study == "regularization":
                # at 3x the family budget FNN overfits, so the regularizers
                # separate on late-epoch AUC; at FNN's tuned point (sgd 0.3)
                argsr = copy.copy(args)
                argsr.epochs = 3 * args.epochs
                argsr.optimizer, argsr.sparse_lr, argsr.dense_lr = "sgd", 0.3, 0.3
                for label, drop, l2 in [("none", 0.0, 0.0),
                                        ("dropout 0.25", 0.25, 0.0),
                                        ("dropout 0.5", 0.5, 0.0),
                                        ("L2 1e-4", 0.0, 1e-4),
                                        ("L2 1e-3", 0.0, 1e-3)]:
                    cfg = model_config("fnn", argsr, fm_ckpt)
                    cfg["model"]["dropout"] = drop
                    cfg["optim"]["l2"] = l2
                    print(f"=== fnn reg {label} @{argsr.epochs}ep ===", flush=True)
                    srows.append(train_one(cfg, f"fnn {label}", device))
                table("regularization", srows,
                      f"FNN regularization: dropout vs L2 at the converged "
                      f"({argsr.epochs}-epoch) budget — the overfitting regime",
                      late=True)
            elif study == "sampling":
                for m in (1, 2, 4):
                    cfg = model_config("snn_dae", args, fm_ckpt)
                    cfg["train"]["pretrain_m"] = m
                    print(f"=== snn_dae m={m} ===", flush=True)
                    srows.append(train_one(cfg, f"snn_dae m={m}", device))
                table("sampling", srows,
                      "SNN-DAE negative-sample count m (paper: m ∈ {1,2,4})")

    seconds = time.perf_counter() - t_suite
    runs = sum(len(rows) for rows in tables.values())
    if args.tuned:   # the tuned table shows each model's best of its grid
        runs += sum(len(TUNE_GRID[n]) - 1 for n in names)
    card = card_line()
    if device.type == "cuda":
        where = (f"{device} ({torch.cuda.get_device_name(device)}); nvidia-smi: "
                 f"{card or 'not available'}; torch {torch.__version__}, CUDA "
                 f"{torch.version.cuda}; every run on the scan route, one CUDA "
                 "graph of 8 steps replayed a chunk, through the hand-written "
                 "tower and FM scorer kernels")
    else:
        where = (f"cpu (the kernels' plain versions, each chunk as 8 eager "
                 f"steps); torch {torch.__version__}")
    dataset = (args.train or
               f"synthetic ipinyou_like ({args.examples} examples, seed 7, "
               f"teacher={args.teacher})")
    header = (
        "# RESULTS_TORCH — model-family reproduction on the port (deepctr_torch)\n\n"
        f"Dataset: {dataset}.  Budget: {args.epochs} epochs, batch "
        f"{args.batch}, k={args.k}, hidden={args.hidden}, "
        f"{args.optimizer} lr {args.sparse_lr}/{args.dense_lr}, "
        f"dropout {args.dropout}, seed {args.seed}.  Generated by "
        "`python -m deepctr_torch.tools.reproduce` on "
        + time.strftime("%Y-%m-%d %H:%M") + ".\n\n"
        f"Device: {where}.\n\n"
        f"Suite wall time: {seconds:.1f} s for {runs} runs (each run's wall s: "
        "data, model, pretraining, training, evaluation, checkpoints).\n\n"
        "The protocol is `tools/reproduce.py`'s, whose JAX run is `RESULTS.md`; "
        "`RESULTS.md AUC` is that file's row of the same label in the same "
        "section (the tuned table: the same model, whichever config won; the "
        "regularization study: its late AUC). `PARITY_TORCH.md` holds the "
        "port's LR/FM/FNN/SNN to the NumPy reference reproduction.  Peak MiB: "
        "`torch.cuda.max_memory_allocated` over the run; examples/s: the median "
        "over epochs of the CLI record's rate (an epoch's steps over its host "
        "clock; the first holds the graph's capture).\n\n"
    )
    with open(args.out, "w") as f:
        f.write(header + "\n".join(sections))
        f.write(f"\nGenerated by {TOOL}. {protocol_stamp(TOOL)}\n")
    print(f"wrote {args.out} ({runs} runs in {seconds:.1f} s)")
    return {"tables": tables, "seconds": seconds, "runs": runs}


if __name__ == "__main__":
    main()
