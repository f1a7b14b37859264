"""Synthetic multi-field CTR data with a planted FM ground truth.

Copy of ``deepctr_tpu/data/synthetic.py``. The port imports nothing of the JAX
package, so it keeps this copy; its behaviour is meant to be
identical, and ``tests/test_torch_data.py`` holds it to the original.

The environment ships no iPinYou data and the reference mount was empty
(SURVEY.md §0), so parity targets are established by reproduction: this
module generates iPinYou-shaped data from a *known* factorization-machine
process, giving every model a learnable signal and a measurable AUC ceiling
(the Bayes-optimal score is the planted model itself).

Used by tests (overfit/learnability checks, SURVEY.md §4) and by bench.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .schema import Schema, ipinyou_like_schema


@dataclasses.dataclass
class SyntheticDataset:
    schema: Schema
    ids: np.ndarray        # int32[N, S]
    labels: np.ndarray     # float32[N]
    bayes_logits: np.ndarray  # float32[N] — planted-model logits (AUC ceiling)


def _zipf_probs(n: int, alpha: float, rng: np.random.Generator) -> np.ndarray:
    """Zipf-ish categorical distribution (CTR vocabularies are heavy-tailed)."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    rng.shuffle(p)
    return p / p.sum()


def generate(
    schema: Schema | None = None,
    num_examples: int = 100_000,
    k: int = 4,
    base_ctr: float = 0.08,
    noise: float = 0.5,
    zipf_alpha: float = 1.05,
    seed: int = 0,
    teacher: str = "fm",
    ortho_mix: tuple[float, float, float] = (1.0, 1.3, 0.0),
) -> SyntheticDataset:
    """Sample ids per field (Zipf marginals) and labels from a planted model.

    ``teacher`` selects the planted process:

    - ``"fm"`` (default): y ~ Bernoulli(sigmoid(b0 + Σ w_g + Σ <v_i,v_j> + ε)),
      the FM functional form of SURVEY.md §2.3.  LR underfits it; FM/FNN can
      close the gap — but by construction NO model can beat FM on it, so it
      anchors parity, not the paper's deep-beats-shallow claim.
    - ``"mlp"``: a standardized mix of linear + FM-pairwise + a random tanh-MLP
      over concatenated per-field teacher embeddings.  The MLP tier carries
      genuinely higher-order structure (any *pairwise* value function is
      rank-limited FM-representable — e.g. XOR parity h(v1)·h(v2) is rank 1 —
      so discriminating deep from shallow requires >2-way interactions).  On
      this process the reference paper's qualitative ordering (FNN/SNN above
      LR, FM in between; arXiv:1601.02376, SURVEY.md §6) is reproducible
      at MATCHED budget — but a tuned LR absorbs its low-order leakage
      (see "ortho"); library-level gate: tests/test_reproduce.py.
    - ``"ortho"`` (round 5): analytically leakage-free tiers, the
      tuned-per-model headline substrate — linear over all fields +
      ``ortho_mix``-weighted rank-2 centered pairwise over the small
      dense fields (+ optional deleaked MLP tier, off by default).  The
      paper's LR << SNN/FNN ordering holds under per-model tuning and
      persists at convergence; RESULTS.md's substrate note records the
      measured design eliminations behind it.
    """
    schema = schema or ipinyou_like_schema()
    rng = np.random.default_rng(seed)
    S = schema.num_slots
    V = schema.vocab_size

    slot_base = schema.slot_offsets
    offsets = schema.offsets
    probs_list: list[np.ndarray] = []

    def sample_ids(r: np.random.Generator, n: int,
                   draw_probs: bool) -> np.ndarray:
        """``draw_probs=True`` preserves the original rng draw order (probs
        interleaved with counts/values per field) so existing seeded
        datasets are bit-identical; ghost samples reuse the saved probs."""
        out = np.full((n, S), schema.pad_id, dtype=np.int32)
        for fi, field in enumerate(schema.fields):
            if draw_probs:
                probs_list.append(_zipf_probs(field.vocab_size, zipf_alpha, r))
            # multi-value fields: 1 + Binomial(max_len-1, 0.6) values, packed
            # contiguously from the field's first slot (canonical packed form)
            count = 1 + r.binomial(field.max_len - 1, 0.6, size=n)
            for j in range(field.max_len):
                col = slot_base[fi] + j
                vals = r.choice(field.vocab_size, size=n, p=probs_list[fi])
                gids = (offsets[fi] + vals).astype(np.int32)
                present = count > j
                out[present, col] = gids[present]
        return out

    ids = sample_ids(rng, num_examples, draw_probs=True)

    # Planted FM parameters over the global vocab.
    w = rng.normal(0.0, 0.35, size=V + 1).astype(np.float32)
    v = rng.normal(0.0, 0.35 / np.sqrt(k), size=(V + 1, k)).astype(np.float32)
    w[schema.pad_id] = 0.0
    v[schema.pad_id] = 0.0

    lin = w[ids].sum(axis=1)
    vv = v[ids]                      # [N, S, k]
    s = vv.sum(axis=1)               # [N, k]
    sq = (vv * vv).sum(axis=1)       # [N, k]
    inter = 0.5 * (s * s - sq).sum(axis=1)

    def std(x):
        return (x - x.mean()) / (x.std() + 1e-9)

    if teacher == "fm":
        logits = std(lin + inter)
    elif teacher == "mlp":
        # Higher-order tier: random 2-hidden-layer tanh MLP over concatenated
        # per-field teacher embeddings (field-pooled for multi-value fields).
        d, h1, h2 = 6, 64, 32
        F = schema.num_fields
        E = rng.normal(0.0, 1.0, size=(V + 1, d)).astype(np.float32)
        E[schema.pad_id] = 0.0
        emb = E[ids]                                   # [N, S, d]
        pooled = np.zeros((num_examples, F, d), np.float32)
        sf = schema.slot_field
        for col in range(S):
            pooled[:, sf[col], :] += emb[:, col, :]
        u = pooled.reshape(num_examples, F * d)
        W1 = rng.normal(0.0, np.sqrt(2.0 / (F * d)), size=(F * d, h1))
        b1 = rng.normal(0.0, 0.5, size=h1)
        W2 = rng.normal(0.0, np.sqrt(2.0 / h1), size=(h1, h2))
        b2 = rng.normal(0.0, 0.5, size=h2)
        W3 = rng.normal(0.0, np.sqrt(2.0 / h2), size=(h2,))
        deep = np.tanh(np.tanh(u @ W1 + b1) @ W2 + b2) @ W3
        # standardize each tier so the mix is controlled: enough linear for
        # LR to be clearly above chance, enough pairwise for FM to beat LR,
        # and a dominant deep tier only deep models can capture
        # mix tuned so the gaps are measurable under an 8-epoch SGD budget:
        # LR +0.004 below FM, FM +0.004 below FNN, ~0.008 LR->FNN (the paper
        # reports 0.5-2 AUC points LR->FNN on iPinYou; SURVEY.md §6)
        logits = std(0.4 * std(lin) + 0.5 * std(inter) + 1.5 * std(deep))
    elif teacher == "ortho":
        # Orthogonalized-tier teacher (round 5).  The "mlp" teacher's deep
        # tier leaks most of its variance into low-order ANOVA components,
        # so a TUNED LR converges to nearly the full learnable signal and
        # the paper's ordering (LR below FNN/SNN) only shows up at matched
        # budget (RESULTS.md round-4 convergence note).  Here every tier is
        # constructed so the next model class down provably cannot absorb
        # it, while staying GRADIENT-LEARNABLE by the class above (the
        # failure mode of a naive construction: a full-vocab quadratic or a
        # sparse 3-way over huge fields is information-theoretically there
        # but no MLP finds it at this data scale — measured, see git
        # history of this round):
        #
        # - linear tier: planted per-feature weights over ALL fields (the
        #   LR-learnable share);
        # - pairwise tier: sum of <u_i, u_j> over the SMALL single-valued
        #   fields (vocab <= 64: every pair cell is observed hundreds of
        #   times at 100k+ rows) with per-field MEAN-CENTERED teacher
        #   embeddings (E_p[u] = 0 under the actual sampling marginals) —
        #   its first-order ANOVA components are ZERO analytically, so no
        #   amount of LR training can extract it, while an FM with k >= d
        #   represents it exactly;
        # - deep tier: a random tanh-MLP over the same centered embeddings
        #   with its first-order leakage ghost-deleaked (below) — invisible
        #   to LR, partially visible to FM (its pairwise ANOVA leakage),
        #   fully learnable by MLP students.
        #
        # Result: the tuned-per-model ordering LR < FM < deep holds
        # asymptotically on this process, not just at matched budget.
        d = 2
        small = [fi for fi, f in enumerate(schema.fields)
                 if f.vocab_size <= 64 and f.max_len == 1]
        assert len(small) >= 3, "ortho teacher needs >=3 small fields"
        U = rng.normal(0.0, 1.0, size=(V + 1, d)).astype(np.float32)
        U[schema.pad_id] = 0.0
        for fi in small:
            sl = slice(int(offsets[fi]),
                       int(offsets[fi]) + schema.fields[fi].vocab_size)
            U[sl] -= (probs_list[fi][:, None] * U[sl]).sum(0, keepdims=True)
        cols = [int(slot_base[fi]) for fi in small]
        P = U[ids[:, cols]]                     # [N, |small|, d]
        tot = P.sum(axis=1)
        inter_c = 0.5 * (
            (tot * tot).sum(axis=-1) - (P * P).sum(axis=-1).sum(axis=-1)
        )

        # deep tier: random tanh-MLP over the centered small-field
        # embeddings — an MLP student's OWN function class, so FNN/SNN can
        # learn it by gradient (a dense random quadratic or a pure ANOVA
        # interaction tensor is not: measured this round, both leave every
        # deep model at the LR ceiling).  Its first-order ANOVA leakage is
        # removed empirically on an independent ghost sample (small-vocab
        # fields -> dense counts -> accurate conditional means), so LR
        # cannot reach it; its PAIRWISE leakage is deliberately kept — that
        # is FM's share of the deep tier, putting FM between LR and the
        # deep models exactly as the paper reports.
        a, b, c = ortho_mix
        if c != 0.0:
            nf = len(small)
            h1, h2 = 48, 24
            W1 = rng.normal(0.0, 2.2 / np.sqrt(nf * d), size=(nf * d, h1))
            b1 = rng.normal(0.0, 0.7, size=h1)
            W2 = rng.normal(0.0, 2.2 / np.sqrt(h1), size=(h1, h2))
            b2 = rng.normal(0.0, 0.7, size=h2)
            W3 = rng.normal(0.0, 1.0, size=(h2,))

            def deep_fn(id_mat: np.ndarray) -> np.ndarray:
                x = U[id_mat[:, cols]].reshape(id_mat.shape[0], nf * d)
                return np.tanh(np.tanh(x @ W1 + b1) @ W2 + b2) @ W3

            deep = deep_fn(ids)
            rng_g = np.random.default_rng(seed + 10_000_019)
            n_ghost = max(300_000, 2 * num_examples)
            gids = sample_ids(rng_g, n_ghost, draw_probs=False)
            gdeep = deep_fn(gids)
            gmean = float(gdeep.mean())
            sums = np.zeros(V + 1, np.float64)
            cnts = np.zeros(V + 1, np.float64)
            gsmall = gids[:, cols].reshape(-1)
            np.add.at(sums, gsmall, np.repeat(gdeep, nf))
            np.add.at(cnts, gsmall, 1.0)
            m = np.where(cnts > 0, sums / np.maximum(cnts, 1.0) - gmean, 0.0)
            m *= cnts / (cnts + 50.0)       # shrink rare-cell estimates
            m[schema.pad_id] = 0.0
            deep_c = deep - m[ids[:, cols]].sum(axis=1)
        else:
            # default mix: the deep tier is OFF — measured this round, NO
            # student (FNN/SNN at 8-64 epochs, 120k-1M rows, tuned grids)
            # learns a first-order-deleaked MLP tier, so a nonzero c only
            # dilutes the achievable share for every model equally.  The
            # rank-2 pairwise tier IS gradient-learnable by the deep
            # models (they reach 0.72-0.75 vs LR's 0.67 on it) while
            # staying analytically invisible to LR.
            deep_c = np.zeros_like(lin)

        logits = std(a * std(lin) + b * std(inter_c) + c * std(deep_c))
    else:
        raise ValueError(f"unknown teacher {teacher!r} (fm|mlp|ortho)")
    b0 = float(np.log(base_ctr / (1 - base_ctr)))
    bayes = (b0 + 1.5 * logits).astype(np.float32)
    noisy = bayes + rng.normal(0.0, noise, size=num_examples).astype(np.float32)
    labels = (rng.random(num_examples) < 1.0 / (1.0 + np.exp(-noisy))).astype(
        np.float32
    )
    return SyntheticDataset(schema=schema, ids=ids, labels=labels, bayes_logits=bayes)


def write_yx_file(ds: SyntheticDataset, path: str) -> None:
    """Serialise to the reference's yx text format (for parser round-trips)."""
    pad = ds.schema.pad_id
    with open(path, "w") as f:
        for y, row in zip(ds.labels, ds.ids):
            toks = [str(int(y))]
            toks += [f"{g}:1" for g in row if g != pad]
            f.write(" ".join(toks) + "\n")
