"""Substrate elimination lab on the port: the measured negatives behind
``teacher="ortho"``.

The counterpart of ``tools/substrate_lab.py``, with its experiments, the
same configuration for every run and the same ``rank2`` gate. Each run
trains through the port's entry point, ``deepctr_torch.cli.run(cfg,
device)`` (on the card the scan route, through the hand-written tower and
FM scorer kernels; ``--device cpu`` runs their plain versions; ``--device
cuda`` without a card raises), and prints one JSON row: the port's best AUC,
its epoch, the run's seconds and the device with the card's name and power
limit (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``).

  --exp leakage    tuned LR on the mlp teacher reaches the deep models'
                   level (the leakage share is the learnable signal)
  --exp rank8      rank-8 centered quadratic: the reference's historical
                   record (FM learns it exactly, every deep student stalls
                   at about LR's level); the shipped teacher is d=2
  --exp rank2      rank-2 centered pairwise (the shipped substrate): the
                   deep family learns it, LR cannot; raises unless SNN and
                   FNN beat LR by more than 0.02 AUC
  --exp all        everything

A run with ``mix`` routes a non-default ``ortho_mix`` through the CLI by
replacing ``deepctr_torch.data.synthetic.generate`` (the CLI reaches it as
a module attribute) for that run only; the original is put back when the
run ends, whether it ends well or not.

Usage:  python -m deepctr_torch.tools.substrate_lab --exp rank2 [--examples 120000]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import tempfile
import time

import torch

H = [200, 300, 100]
GATE = 0.02   # rank2: SNN and FNN above LR by more than this AUC


def _device_name(device: torch.device) -> str:
    if device.type != "cuda":
        return str(device)
    from .reproduce import card_line

    return f"{device} ({card_line() or torch.cuda.get_device_name(device)})"


def train(model_cfg, opt, slr, dlr, *, teacher, examples, device, epochs=8,
          pretrain=None, ckpt=None, mix=None, label=""):
    """One run through ``cli.run``, the reference lab's configuration; prints
    its row and returns its best AUC (rounded to 4 places, as the
    reference's)."""
    from .. import cli
    from ..config import RunConfig
    from ..data import synthetic

    cfg = {
        "data": {"synthetic_examples": examples, "synthetic_seed": 7,
                 "synthetic_teacher": teacher},
        "train": {"batch_size": 512, "epochs": epochs, "seed": 0,
                  "early_stop_patience": 99, "scan_steps": 8},
        "optim": {"sparse": opt, "sparse_lr": slr, "dense": opt,
                  "dense_lr": dlr, "l2": 0.0},
        "model": model_cfg,
    }
    if ckpt:
        cfg["train"]["checkpoint_path"] = ckpt
    if pretrain:
        cfg["train"]["pretrain"] = pretrain
        cfg["train"]["pretrain_m"] = 2
        cfg["train"]["pretrain_epochs"] = 1
    generate = synthetic.generate
    if mix is not None:   # route a non-default ortho mix through the CLI

        def mixed(*a, **kw):
            kw.setdefault("ortho_mix", mix)
            return generate(*a, **kw)

        synthetic.generate = mixed
    t0 = time.perf_counter()
    try:
        res = cli.run(RunConfig.from_dict(cfg), device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        synthetic.generate = generate
    row = {"label": label, "auc": round(float(res["best_auc"]), 4),
           "best_epoch": res.get("best_epoch"),
           "secs": round(time.perf_counter() - t0, 1), "device": _device_name(device)}
    print(json.dumps(row), flush=True)
    return row["auc"]


@contextlib.contextmanager
def _fm_checkpoint():
    """A path for FM's checkpoint, whose ``.fm_table`` seeds FNN; removed
    with its directory at the end."""
    workdir = tempfile.mkdtemp(prefix="slab_")
    try:
        yield os.path.join(workdir, "fm.ckpt")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def exp_leakage(examples, device) -> dict:
    """On the mlp teacher a tuned LR matches FNN: the deep tier's variance
    leaks into low-order ANOVA components and LR absorbs it."""
    print("== leakage: tuned LR vs FNN on teacher=mlp ==", flush=True)
    a_lr = train({"name": "lr"}, "adagrad", 0.05, 0.02,
                 teacher="mlp", examples=examples, device=device, label="lr ada")
    with _fm_checkpoint() as ck:
        train({"name": "fm", "k": 10}, "sgd", 0.3, 0.3, teacher="mlp",
              examples=examples, device=device, ckpt=ck, label="fm sgd.3")
        a_fnn = train({"name": "fnn", "k": 10, "hidden": H, "dropout": 0.0,
                       "init_from": ck + ".fm_table"}, "sgd", 0.3, 0.3,
                      teacher="mlp", examples=examples, device=device, label="fnn sgd.3")
    print(f"tuned LR {a_lr:.4f} vs FNN {a_fnn:.4f} — gap {a_fnn - a_lr:+.4f} "
          f"(the reference lab's measurement: +0.0003)")
    return {"lr": a_lr, "fnn": a_fnn}


def exp_rank8(examples, device) -> dict:
    """Rank-8 centered quadratic: the reference's historical numbers (the
    shipped teacher uses d=2 because of them); nothing trains."""
    print("== rank8 (the reference's historical record; shipped teacher is d=2) ==")
    print(json.dumps({
        "reference_historical_d8_mix_1.0_1.2_0.0": {
            "lr_ada": 0.6742, "fm_ada": 0.7598,
            "fnn_sgd.3@32": 0.6921, "fnn_best_then_overfits": True,
            "snn_ada@32": 0.6750,
            "also_tried": ["dropout .25/.5", "L2 1e-4", "64 epochs",
                           "1M rows", "hidden1 400", "sgd 0.3-1.0"],
            "conclusion": "no deep student learned the rank-8 tier",
        }
    }, indent=2))
    return {}


def exp_rank2(examples, device) -> dict:
    """The shipped substrate: rank-2 centered pairwise over small dense
    fields. LR is capped analytically; the deep family learns the
    interaction. Raises unless SNN and FNN beat LR by more than GATE."""
    print("== rank2: the shipped ortho substrate ==", flush=True)
    a_lr = train({"name": "lr"}, "sgd", 1.0, 1.0,
                 teacher="ortho", examples=examples, device=device, label="lr sgd1")
    with _fm_checkpoint() as ck:
        a_fm = train({"name": "fm", "k": 10}, "adagrad", 0.05, 0.02,
                     teacher="ortho", examples=examples, device=device, ckpt=ck,
                     label="fm ada")
        a_snn = train({"name": "snn", "hidden": H, "hidden1": 200},
                      "adagrad", 0.2, 0.1, teacher="ortho", examples=examples,
                      device=device, epochs=24, pretrain="rbm", label="snn_rbm ada.2/.1")
        a_fnn = train({"name": "fnn", "k": 10, "hidden": H, "dropout": 0.0,
                       "init_from": ck + ".fm_table"}, "sgd", 0.3, 0.3,
                      teacher="ortho", examples=examples, device=device, epochs=24,
                      label="fnn sgd.3")
    print(f"LR {a_lr:.4f} << SNN {a_snn:.4f} ~ FNN {a_fnn:.4f} < FM {a_fm:.4f}: the "
          f"deep family's gap over LR ({a_snn - a_lr:+.4f}) cannot come from "
          f"leakage — the pairwise tier's first-order ANOVA is zero under the "
          f"sampling marginals")
    if not (a_snn > a_lr + GATE and a_fnn > a_lr + GATE):
        raise AssertionError(f"rank2: SNN {a_snn} and FNN {a_fnn} must beat LR {a_lr} "
                             f"by more than {GATE} AUC")
    return {"lr": a_lr, "fm": a_fm, "snn": a_snn, "fnn": a_fnn}


EXPERIMENTS = {"leakage": exp_leakage, "rank8": exp_rank8, "rank2": exp_rank2}


def main(argv=None) -> dict:
    from ..cli import resolve_device

    ap = argparse.ArgumentParser(prog="python -m deepctr_torch.tools.substrate_lab",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--exp", default="rank2", choices=[*EXPERIMENTS, "all"])
    ap.add_argument("--examples", type=int, default=120_000)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every run (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    exps = list(EXPERIMENTS) if args.exp == "all" else [args.exp]
    return {e: EXPERIMENTS[e](args.examples, device) for e in exps}


if __name__ == "__main__":
    main()
