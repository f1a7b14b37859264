"""Parity of the PyTorch port with the NumPy reference reproduction, over seeds.

The counterpart of ``tools/parity_report.py`` (which writes ``PARITY.md`` for
the JAX package) under the same protocol: ``synthetic.generate(
ipinyou_like_schema(), k=4, seed=1234)`` through the port's copy of the data
layer, an 85/15 split, SGD 0.3 on both sides, k=10, batch 512, 8 epochs; FNN
(tower 200-300-100) from an FM of 3 epochs; SNN with ``hidden1`` 200 and
tower 300-100 after 2 pretraining epochs of m=2 at lr 0.1. The oracle,
``deepctr_tpu/reference_impl`` (``NumpyLR/FM/FNN/Dae/Rbm/Snn``), runs live
on the host beside the port (it imports numpy and the JAX package's data
schema, not JAX); the port trains through its own ``fit``, ``init_state``,
``init_fnn_from_fm``, ``make_pretrain_step(..., with_noise=True)`` and
``pretrain_snn`` on ``--device`` (the card unless ``--device cpu``; ``cuda``
without a card raises).

Nine rows: LR, FM, FNN, and for SNN_DAE and SNN_RBM three comparisons each,
as in ``PARITY.md``: 'supervised' (the port's fine-tune from the oracle's
pretrained table and tower init), 'pretrain-matched' (the port's pretraining
replays the oracle's exact uniform draws from the oracle's initial table,
then the port's fine-tune) and 'pretrain-swap' (the port's pretraining with
its own ``torch.Generator``). Bands: |Δ AUC| <= 0.002, and for the swap rows
the independent-difference envelope 2·sqrt(σ_ref² + σ_port²)/√seeds. Where
the JAX tool pins JAX's matmuls to full f32, this one sets
``torch.backends.cuda.matmul.allow_tf32`` and ``cudnn.allow_tf32`` to False,
so the port's plain ops run in f32; the tower kernels' 3xTF32 products are
their own arithmetic and stay. The last column is ``PARITY.md``'s JAX AUC of
the same row, read from the file. The artifact carries the card's name and
power limit (``nvidia-smi``) and a protocol stamp.

Usage:  python tools/parity_report_torch.py --seeds 6 --examples 40000
        [--device cuda|cpu] [--models lr,fm,...] [--epochs 8]
        [--out PARITY_TORCH.md]
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

TOOL = "tools/parity_report_torch.py"
MODELS = ("lr", "fm", "fnn", "snn_dae", "snn_rbm")


def jax_aucs(path: str) -> dict:
    """``PARITY.md``'s "ours AUC (±σ)" cell by model row."""
    from deepctr_torch.utils.artifacts import parse_md_table

    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return {r["model"]: r["ours AUC (±σ)"] for r in parse_md_table(f.read())}


def band_for(label: str, ref_sd: float, port_sd: float, seeds: int) -> float:
    """A matched comparison's band is 0.002; a pretrain-swap row compares two
    independent pretraining draws: 2·sqrt(σ_ref² + σ_port²)/√seeds."""
    if "pretrain-swap" in label:
        return max(0.002, 2.0 * float(np.hypot(ref_sd, port_sd)) / np.sqrt(seeds))
    return 0.002


def run(seeds: int, examples: int, out_path: str, models: tuple = MODELS,
        device: str = "cuda", epochs: int = 8) -> list:
    """Train both sides over ``seeds``, write ``out_path`` and return the
    rows ``(label, ref_mean, ref_sd, port_mean, port_sd, delta, ref_ll,
    port_ll, band, ok)``."""
    import torch

    from deepctr_torch.cli import resolve_device
    from deepctr_torch.data import ipinyou_like_schema, synthetic
    from deepctr_torch.models import (
        DaePretrainer,
        MlpSpec,
        RbmPretrainer,
        make_fm,
        make_fnn,
        make_lr,
        make_snn,
    )
    from deepctr_torch.models.snn import init_pretrain_dense
    from deepctr_torch.optim import SparseSgd, make_dense_optimizer
    from deepctr_torch.tools.reproduce import card_line
    from deepctr_torch.train import fit, init_state, pretrain_snn
    from deepctr_torch.train.step import make_pretrain_step
    from deepctr_torch.utils.artifacts import protocol_stamp
    from deepctr_torch.utils.checkpoint import init_fnn_from_fm, init_snn_from_pretrain
    from deepctr_torch.utils.metrics import exact_auc, logloss
    from deepctr_tpu.reference_impl import (
        NumpyDae,
        NumpyFM,
        NumpyFNN,
        NumpyLR,
        NumpyRbm,
        NumpySnn,
        train_numpy_model,
    )

    dev = resolve_device(device)
    # parity measures implementation semantics: the port's plain matmuls in
    # full f32, as the JAX tool pins jax_default_matmul_precision=highest
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    precision = (f"torch.backends.cuda.matmul.allow_tf32="
                 f"{torch.backends.cuda.matmul.allow_tf32}, "
                 f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    print(precision, flush=True)
    t_start = time.perf_counter()

    schema = ipinyou_like_schema()
    ds = synthetic.generate(schema, num_examples=examples, k=4, seed=1234)
    n = ds.ids.shape[0]
    tr, te = slice(0, int(0.85 * n)), slice(int(0.85 * n), n)
    bayes_auc = exact_auc(ds.labels[te], ds.bayes_logits[te])

    def sig(x):
        return 1.0 / (1.0 + np.exp(-np.clip(x, -30, 30)))

    lr_, k, B = 0.3, 10, 512
    h1, snn_hidden, pre_lr, pre_epochs, pre_m = 200, (300, 100), 0.1, 2, 2

    def opts():
        return SparseSgd(lr_), make_dense_optimizer("sgd", lr_)

    def fit_port(model, seed, fit_epochs=epochs, state=None):
        sopt, dopt = opts()
        return fit(model, schema, ds.ids[tr], ds.labels[tr], ds.ids[te],
                   ds.labels[te], sparse_opt=sopt, dense_opt=dopt, batch_size=B,
                   epochs=fit_epochs, seed=seed, prefetch=False,
                   early_stop_patience=99, state=state)

    def finetune_port_snn(table0, b10, init_layers, seed):
        """The port's supervised SNN phase from explicit (table, b1, tower
        init)."""
        model = make_snn(schema, hidden1=h1, mlp=MlpSpec(hidden=snn_hidden, dropout=0.0),
                         device=dev)
        state = init_state(model, schema, *opts(), seed=seed)
        with torch.no_grad():
            for layer, (W, bb) in zip(model.mlp.layers, init_layers):
                layer.w.copy_(torch.from_numpy(np.asarray(W, np.float32)))
                layer.b.copy_(torch.from_numpy(np.asarray(bb, np.float32)))
        init_snn_from_pretrain(model, torch.as_tensor(np.asarray(table0, np.float32)),
                               torch.as_tensor(np.asarray(b10, np.float32)))
        last = fit_port(model, seed, state=state).history[-1]
        return last["auc"], last["logloss"]

    def snn_rows(name):
        """supervised, pretrain-matched and pretrain-swap (module docstring)."""
        pre_cls = NumpyDae if name == "snn_dae" else NumpyRbm
        pretrainer = (DaePretrainer(m=pre_m) if name == "snn_dae"
                      else RbmPretrainer(m=pre_m))
        F = schema.num_fields
        acc = {key: ([], []) for key in ("ref", "sup", "mat", "swp")}
        for seed in range(seeds):
            pre = pre_cls(schema, hidden1=h1, m=pre_m, lr=pre_lr, seed=seed)
            table0_pre = pre.table.copy()
            noise_rng = np.random.default_rng(9000 + seed)
            batches = []  # (ids, noise), replayed into the port's pretrainer
            nb = (tr.stop // B) * B
            for ep in range(pre_epochs):
                order = np.random.default_rng(seed + ep).permutation(tr.stop)
                for s in range(0, nb, B):
                    ids_b = ds.ids[order[s : s + B]]
                    if name == "snn_dae":
                        noise = {
                            "u_keep": noise_rng.random(
                                (B, schema.num_slots), dtype=np.float32),
                            "u_neg": noise_rng.random(
                                (B, F, pre_m), dtype=np.float32),
                        }
                    else:
                        noise = {
                            "u_neg": noise_rng.random(
                                (B, F, pre_m), dtype=np.float32),
                            "u_h0": noise_rng.random(
                                (B, h1), dtype=np.float32),
                        }
                    batches.append((ids_b, noise))
                    pre.train_batch(ids_b, noise=noise)
            ref = NumpySnn(schema, hidden1=h1, hidden=snn_hidden, lr=lr_,
                           seed=seed, table=pre.table, b1=pre.b1)
            init_layers = [(W.copy(), b.copy()) for W, b in ref.layers]
            train_numpy_model(ref, ds.ids[tr], ds.labels[tr], batch_size=B,
                              epochs=epochs, seed=seed)
            p = sig(ref.forward(ds.ids[te]))
            acc["ref"][0].append(exact_auc(ds.labels[te], p))
            acc["ref"][1].append(logloss(ds.labels[te], p))

            # (1) supervised: the port's fine-tune from the oracle's output
            a, l = finetune_port_snn(pre.table, pre.b1, init_layers, seed)
            acc["sup"][0].append(a)
            acc["sup"][1].append(l)

            # (2) matched: the port's pretraining replays the oracle's exact
            # draws from the oracle's initial table, then the port's fine-tune
            sopt_pre = SparseSgd(pre_lr)
            tbl = torch.from_numpy(table0_pre).to(dev)
            dense_pre = init_pretrain_dense(schema, h1, dev)
            sstate = sopt_pre.init(tbl)
            pstep = make_pretrain_step(pretrainer, schema, sopt_pre,
                                       dense_lr=pre_lr, with_noise=True)
            for ids_b, noise in batches:
                tbl, sstate, dense_pre, _, _ = pstep(tbl, sstate, dense_pre, None,
                                                     ids_b, noise)
            a, l = finetune_port_snn(tbl.cpu().numpy(), dense_pre["b1"].cpu().numpy(),
                                     init_layers, seed)
            acc["mat"][0].append(a)
            acc["mat"][1].append(l)

            # (3) swap: the port's pretraining with its own generator
            t2, b12 = pretrain_snn(
                pretrainer, schema, h1, ds.ids[tr], sparse_opt=SparseSgd(pre_lr),
                dense_lr=pre_lr, batch_size=B, epochs=pre_epochs, seed=seed,
                device=dev)
            a, l = finetune_port_snn(t2.cpu().numpy(), b12.cpu().numpy(),
                                     init_layers, seed)
            acc["swp"][0].append(a)
            acc["swp"][1].append(l)
            print(f"{name} seed {seed}: ref {acc['ref'][0][-1]:.4f}, supervised "
                  f"{acc['sup'][0][-1]:.4f}, pretrain-matched {acc['mat'][0][-1]:.4f}, "
                  f"pretrain-swap {a:.4f}", flush=True)
        out = []
        ref_a, ref_l = acc["ref"]
        for label, key in ((f"{name} supervised", "sup"),
                           (f"{name} pretrain-matched", "mat"),
                           (f"{name} pretrain-swap", "swp")):
            oa, ol = acc[key]
            out.append((label, np.mean(ref_a), np.std(ref_a), np.mean(oa),
                        np.std(oa), np.mean(oa) - np.mean(ref_a),
                        np.mean(ref_l), np.mean(ol)))
        return out

    stats = []
    for name in models:
        t0 = time.perf_counter()
        if name in ("snn_dae", "snn_rbm"):
            stats.extend(snn_rows(name))
        else:
            port_auc, port_ll, ref_auc, ref_ll = [], [], [], []
            for seed in range(seeds):
                # ---- the reference reproduction
                if name == "lr":
                    ref = NumpyLR(schema, lr=lr_, seed=seed)
                elif name == "fm":
                    ref = NumpyFM(schema, k=k, lr=lr_, seed=seed)
                else:
                    fm0 = NumpyFM(schema, k=k, lr=lr_, seed=seed)
                    train_numpy_model(fm0, ds.ids[tr], ds.labels[tr], batch_size=B,
                                      epochs=3, seed=seed)
                    ref = NumpyFNN(schema, k=k, hidden=(200, 300, 100), lr=lr_,
                                   seed=seed, fm_table=fm0.table)
                train_numpy_model(ref, ds.ids[tr], ds.labels[tr], batch_size=B,
                                  epochs=epochs, seed=seed)
                p = sig(ref.forward(ds.ids[te]))
                ref_auc.append(exact_auc(ds.labels[te], p))
                ref_ll.append(logloss(ds.labels[te], p))

                # ---- the port, the same SGD on both sides
                state = None
                if name == "lr":
                    model = make_lr(schema, device=dev)
                elif name == "fm":
                    model = make_fm(schema, k=k, device=dev)
                else:
                    res_fm = fit_port(make_fm(schema, k=k, device=dev), seed, fit_epochs=3)
                    model = make_fnn(schema, k=k,
                                     mlp=MlpSpec(hidden=(200, 300, 100), dropout=0.0),
                                     device=dev)
                    state = init_state(model, schema, *opts(), seed=seed)
                    init_fnn_from_fm(model, res_fm.state.table.float().cpu().numpy())
                last = fit_port(model, seed, state=state).history[-1]
                port_auc.append(last["auc"])
                port_ll.append(last["logloss"])
            stats.append((name, np.mean(ref_auc), np.std(ref_auc), np.mean(port_auc),
                          np.std(port_auc), np.mean(port_auc) - np.mean(ref_auc),
                          np.mean(ref_ll), np.mean(port_ll)))
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    rows = []
    for r in stats:
        band = band_for(r[0], r[2], r[4], seeds)
        rows.append(r + (band, bool(abs(r[5]) <= band)))
        print(f"{r[0]}: ref {r[1]:.4f}±{r[2]:.4f}  port {r[3]:.4f}±{r[4]:.4f}  "
              f"Δ {r[5]:+.4f}  band {band:.4f}", flush=True)
    seconds = time.perf_counter() - t_start

    jax = jax_aucs(os.path.join(ROOT, "PARITY.md"))
    card = card_line()
    where = (f"{dev} ({torch.cuda.get_device_name(dev)}); nvidia-smi: "
             f"{card or 'not available'}; CUDA {torch.version.cuda}"
             if dev.type == "cuda" else "cpu (the kernels' plain versions)")
    with open(out_path, "w") as f:
        f.write("# PARITY_TORCH — deepctr_torch vs the NumPy reference reproduction\n\n")
        f.write(
            f"Protocol: `tools/parity_report.py`'s (its JAX run is `PARITY.md`), "
            f"with the port in place of the JAX package. The oracle is the "
            f"NumPy-faithful reproduction of the reference's training procedure "
            f"(`deepctr_tpu/reference_impl`), run live on the host. Synthetic "
            f"iPinYou-shaped data, {examples} examples, {seeds} seeds, "
            f"{epochs} epochs, SGD {lr_}, batch {B}, k={k}; FNN from an FM of 3 "
            f"epochs. SNN ({pre_epochs} pretrain epochs, m={pre_m}, lr={pre_lr}, "
            f"hidden1={h1}, tower {snn_hidden}) decomposes into three "
            f"comparisons: 'supervised' matches the pretrain output, the tower's "
            f"init and the batch order, so the fine-tune trainers must agree; "
            f"'pretrain-matched' replays the oracle's exact uniform draws through "
            f"the port's pretrainer (`make_pretrain_step(..., with_noise=True)`) "
            f"from the oracle's initial table, so the two full pipelines must "
            f"agree within 0.002; 'pretrain-swap' uses the port's own "
            f"`torch.Generator` draws under a shared trainer and init, so its "
            f"band is the independent-difference envelope "
            f"2·sqrt(σ_ref²+σ_port²)/√seeds. Bayes-ceiling AUC of the planted "
            f"model: {bayes_auc:.4f}. Target band: |Δ AUC| ≤ 0.002 "
            f"(BASELINE.json:5). The port's plain ops run in f32 ({precision}); "
            f"the tower kernels' products are 3xTF32, their own arithmetic. "
            f"`JAX AUC (PARITY.md)` is the JAX package's AUC of the same row "
            f"from `PARITY.md`.\n\n"
            f"Device: {where}. torch {torch.__version__}. Wall time "
            f"{seconds:.1f} s (oracle on the host and port, in turns).\n\n")
        f.write("| model | ref AUC (±σ) | port AUC (±σ) | Δ AUC | band | ok "
                "| ref logloss | port logloss | JAX AUC (PARITY.md) |\n"
                + "|---" * 9 + "|\n")
        for r in rows:
            label = r[0].upper()
            f.write(
                f"| {label} | {r[1]:.4f} ± {r[2]:.4f} | {r[3]:.4f} ± "
                f"{r[4]:.4f} | {r[5]:+.4f} | {r[8]:.4f} | "
                f"{'yes' if r[9] else 'NO'} | {r[6]:.4f} | {r[7]:.4f} | "
                f"{jax.get(label, '—')} |\n"
            )
        f.write(f"\nGenerated by {TOOL} at {time.ctime()}. {protocol_stamp(TOOL)}\n")
    n_bad = sum(not r[9] for r in rows)
    print(f"wrote {out_path}" + (f" ({n_bad} row(s) OUT OF BAND)" if n_bad
                                 else " (all rows in band)"))
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--examples", type=int, default=40_000)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--models", default=",".join(MODELS),
                    help="comma list (diagnostic runs on a subset)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the port's side (default: cuda)")
    ap.add_argument("--out", default=os.path.join(ROOT, "PARITY_TORCH.md"))
    args = ap.parse_args(argv)
    return run(args.seeds, args.examples, args.out,
               models=tuple(m.strip() for m in args.models.split(",") if m.strip()),
               device=args.device, epochs=args.epochs)


if __name__ == "__main__":
    main()
