"""SNN, the sampling-based fully connected network, and its DAE and RBM
pretrainers.

Port of ``deepctr_tpu/models/snn.py``. The bottom layer is fully connected
over the whole one-hot vector, which is an embedding-bag sum: its weights
live as a ``[V+1, h1]`` table and take the gather and sparse-update path of
the other models, followed by a sigmoid and the tower. The tower is
``ops/kernels/mlp.py`` as for FNN: the fused CUDA kernels for CUDA tensors,
their plain versions for CPU tensors; the reference's ``use_pallas`` switch
has no counterpart, and the port's one dropout is the kernel's counter hash.

The table is pretrained without labels as a denoising auto-encoder
(:class:`DaePretrainer`) or an RBM by CD-1 (:class:`RbmPretrainer`), made
tractable by per-field negative sampling: a step touches each field's active
unit and ``m`` sampled units of the same field. Both are plain tensor code
(gathers, einsums, sigmoids), as the reference's are plain jnp. Their random
draws come from an explicit ``torch.Generator`` on the table's device, or
from uniforms the caller hands in (``noise=``, ``u=``), which is how the
tests feed the reference, the port and the NumPy oracle the same noise; the
reference's PRNG is not reproduced.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..data import Schema
from .base import MlpSpec, MlpTower, init_mlp, init_table, refuse_dense

_DEFAULT_MLP = MlpSpec(hidden=(300, 100), activation="tanh", dropout=0.5)


class SNNModel(nn.Module):
    """Supervised SNN: sigmoid bottom layer over one-hot x, then the tower.
    Construct via :func:`make_snn`."""

    name = "snn"

    def __init__(self, vocab_rows: int, hidden1: int = 200,
                 mlp: MlpSpec = _DEFAULT_MLP, init_sigma: float = 0.01, *,
                 device: torch.device | str):
        super().__init__()
        self.init_sigma = init_sigma
        self.table = nn.Parameter(torch.zeros(vocab_rows, hidden1, device=device))
        self.b1 = nn.Parameter(torch.zeros(hidden1, device=device))
        self.mlp = MlpTower(hidden1, mlp, device=device)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator, pad_id: int) -> None:
        """The reference's ``init_params``, in place: the table normal with
        ``init_sigma`` and its pad row zero, ``b1`` zero, the tower
        Glorot-uniform."""
        init_table(self.table, generator, self.init_sigma, pad_id)
        self.b1.zero_()
        init_mlp(self.mlp, generator)

    def bottom(self, rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """rows ``[B, S, h1]``, mask ``[B, S]`` -> ``sigmoid(sum of the active
        rows + b1)`` ``[B, h1]``, the tower's input."""
        return torch.sigmoid((rows * mask[..., None]).sum(dim=1) + self.b1)

    def apply_rows(self, rows: torch.Tensor, mask: torch.Tensor, *,
                   dense: torch.Tensor | None = None, train: bool = False,
                   seed: int | None = None) -> torch.Tensor:
        """rows ``[B, S, h1]``, mask ``[B, S]`` -> logits ``[B]``; the tower
        drops with the counter-hash mask of ``seed`` in train mode
        (:meth:`MlpTower.forward`)."""
        refuse_dense(self, dense)
        return self.mlp(self.bottom(rows, mask), train=train, seed=seed)

    forward = apply_rows


def make_snn(schema: Schema, hidden1: int = 200, mlp: MlpSpec | None = None,
             init_sigma: float = 0.01, *,
             device: torch.device | str) -> SNNModel:
    return SNNModel(schema.padded_vocab_size, hidden1=hidden1,
                    mlp=mlp or _DEFAULT_MLP, init_sigma=init_sigma, device=device)


# ---------------------------------------------------------------------------
# Per-field negative sampling (shared by the DAE and RBM pretrainers)
# ---------------------------------------------------------------------------


class FieldSampling(NamedTuple):
    """Per-schema tensors that drive negative sampling on the device."""

    field_offset: torch.Tensor  # int64[F] global-id offset of each field
    field_vocab: torch.Tensor   # int64[F] vocab size of each field


def field_sampling(schema: Schema, device: torch.device | str) -> FieldSampling:
    return FieldSampling(
        field_offset=torch.as_tensor(np.asarray(schema.offsets, np.int64),
                                     device=device),
        field_vocab=torch.as_tensor(
            np.asarray([f.vocab_size for f in schema.fields], np.int64),
            device=device),
    )


def sample_negatives(generator: torch.Generator | None, fs: FieldSampling,
                     batch: int, m: int, u=None) -> torch.Tensor:
    """Draw ``m`` uniform ids per field per example -> int64 ``[B, F*m]``.

    A draw may hit the active unit (probability 1/vocab); the unit then
    occurs as a positive and as a candidate, and the sparse optimizer's sum
    over duplicate ids sees both.

    ``u`` (float ``[B, F, m]`` uniforms) overrides the draw: the same
    uniforms give the reference's ids exactly. The product ``u * vocab`` is
    taken in f32 as the reference takes it, so that a ``u`` at a field's
    upper edge floors to the same id.
    """
    device = fs.field_offset.device
    num_fields = fs.field_offset.shape[0]
    if u is None:
        u = torch.rand((batch, num_fields, m), generator=generator, device=device,
                       dtype=torch.float32)
    u = torch.as_tensor(u, dtype=torch.float32, device=device)
    vocab = fs.field_vocab[None, :, None].to(torch.float32)
    ids = fs.field_offset[None, :, None] + torch.floor(u * vocab).long()
    return ids.reshape(batch, num_fields * m)


def _uniform(noise, key: str, shape, generator, device) -> torch.Tensor:
    """The uniforms ``noise[key]`` where noise is given, else a draw."""
    if noise is not None:
        return torch.as_tensor(noise[key], dtype=torch.float32, device=device)
    return torch.rand(shape, generator=generator, device=device, dtype=torch.float32)


# ---------------------------------------------------------------------------
# DAE pretraining
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DaePretrainer:
    """Denoising auto-encoder over sampled visible units, tied weights.

    Encoder: ``h = sigmoid(sum of the kept active rows + b1)``, inputs
    dropped at rate ``corruption``. Decoder: for each candidate unit j (the
    active slots as positives, ``m`` sampled negatives per field),
    ``x_j = sigmoid(h . W_j + c_j)``; the loss is the cross-entropy over the
    candidates. Gradients reach W through encoder and decoder; both flows
    come back as occurrence gradients for the sparse optimizer.
    """

    m: int = 2
    corruption: float = 0.3

    def loss_and_grads(self, table: torch.Tensor, dense: dict,
                       batch_ids: torch.Tensor, pad_id: int, fs: FieldSampling,
                       generator: torch.Generator | None, noise=None):
        """Returns ``(loss, occ_ids [B*(2S+Fm)], occ_rows, dense_grads)``:
        the encoder's occurrences first, then the candidates'.

        ``dense`` = ``{"b1": [h1], "vbias": [V+1]}``. ``noise`` =
        ``{"u_keep": [B, S], "u_neg": [B, F, m]}`` uniforms override the
        draws from ``generator``."""
        batch, slots = batch_ids.shape
        device = table.device
        mask = (batch_ids != pad_id).float()
        u_keep = _uniform(noise, "u_keep", (batch, slots), generator, device)
        keep = (u_keep < 1.0 - self.corruption).float() * mask
        neg_ids = sample_negatives(generator, fs, batch, self.m,
                                   u=None if noise is None else noise["u_neg"])
        cand_ids = torch.cat([batch_ids, neg_ids], dim=1)            # [B, S+Fm]
        # targets: active slots 1 (pad: weight 0), negatives 0
        zeros = torch.zeros(neg_ids.shape, device=device)
        targets = torch.cat([mask, zeros], dim=1)
        cweight = torch.cat([mask, zeros + 1.0], dim=1)

        enc_rows = table.detach()[batch_ids].float().requires_grad_(True)
        cand_rows = table.detach()[cand_ids].float().requires_grad_(True)
        b1 = dense["b1"].detach().requires_grad_(True)
        cand_vbias = dense["vbias"].detach()[cand_ids].requires_grad_(True)
        with torch.enable_grad():
            h = torch.sigmoid((enc_rows * keep[..., None]).sum(dim=1) + b1)
            logits = torch.einsum("bh,bch->bc", h, cand_rows) + cand_vbias
            per = -(targets * nn.functional.logsigmoid(logits)
                    + (1.0 - targets) * nn.functional.logsigmoid(-logits))
            loss = (per * cweight).sum() / torch.clamp(cweight.sum(), min=1.0)
        g_enc, g_cand, g_b1, g_vb = torch.autograd.grad(
            loss, [enc_rows, cand_rows, b1, cand_vbias])
        occ_ids = torch.cat([batch_ids.reshape(-1), cand_ids.reshape(-1)])
        occ_rows = torch.cat([g_enc.reshape(-1, g_enc.shape[-1]),
                              g_cand.reshape(-1, g_cand.shape[-1])])
        return loss.detach(), occ_ids, occ_rows, {
            "b1": g_b1,
            "vbias_ids": cand_ids.reshape(-1),
            "vbias_grads": g_vb.reshape(-1),
        }


# ---------------------------------------------------------------------------
# RBM CD-1 pretraining
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RbmPretrainer:
    """CD-1 contrastive divergence restricted to sampled visible units.

    ``v0`` over the candidate set (active 1, sampled negatives 0);
    ``h0 = sigmoid(W v0 + b1)``, sampled; ``v1 = sigmoid(W^T h0 + c)`` on the
    candidates; ``h1p = sigmoid(W v1 + b1)``. The CD-1 statistics (positive
    phase less negative phase) come back as occurrence "gradients" for the
    same sparse optimizer: descent gradients, the negative of the CD update
    direction.
    """

    m: int = 2

    @torch.no_grad()
    def loss_and_grads(self, table: torch.Tensor, dense: dict,
                       batch_ids: torch.Tensor, pad_id: int, fs: FieldSampling,
                       generator: torch.Generator | None, noise=None):
        """Returns ``(loss, occ_ids [B*(S+Fm)], occ_rows, dense_grads)``; the
        loss is the reconstruction error. ``noise`` = ``{"u_neg": [B, F, m],
        "u_h0": [B, h1]}`` uniforms override the draws from ``generator``."""
        batch = batch_ids.shape[0]
        device = table.device
        mask = (batch_ids != pad_id).float()
        neg_ids = sample_negatives(generator, fs, batch, self.m,
                                   u=None if noise is None else noise["u_neg"])
        cand_ids = torch.cat([batch_ids, neg_ids], dim=1)             # [B, C]
        zeros = torch.zeros(neg_ids.shape, device=device)
        v0 = torch.cat([mask, zeros], dim=1)
        cweight = torch.cat([mask, zeros + 1.0], dim=1)

        w_cand = table[cand_ids].float()                              # [B, C, h1]
        c_cand = dense["vbias"][cand_ids]                             # [B, C]
        b1 = dense["b1"]

        h0p = torch.sigmoid(torch.einsum("bc,bch->bh", v0 * cweight, w_cand) + b1)
        h0 = (_uniform(noise, "u_h0", h0p.shape, generator, device) < h0p).float()
        v1p = torch.sigmoid(torch.einsum("bh,bch->bc", h0, w_cand) + c_cand)
        v1p = v1p * cweight
        h1p = torch.sigmoid(torch.einsum("bc,bch->bh", v1p, w_cand) + b1)

        # CD-1 statistics per candidate row j: <v_j h>_data - <v_j h>_model
        pos = (v0 * cweight)[..., None] * h0p[:, None, :]             # [B, C, h1]
        neg = v1p[..., None] * h1p[:, None, :]
        g_w = -(pos - neg) / batch                                    # descent
        g_vb = -((v0 - v1p) * cweight) / batch
        g_b1 = -(h0p - h1p).mean(dim=0)
        # the reconstruction error is the monitored "loss"
        loss = ((v0 - v1p) ** 2 * cweight).sum() / torch.clamp(cweight.sum(), min=1.0)
        return loss, cand_ids.reshape(-1), g_w.reshape(-1, g_w.shape[-1]), {
            "b1": g_b1,
            "vbias_ids": cand_ids.reshape(-1),
            "vbias_grads": g_vb.reshape(-1),
        }


def init_pretrain_dense(schema: Schema, hidden1: int,
                        device: torch.device | str) -> dict:
    return {
        "b1": torch.zeros(hidden1, device=device),
        "vbias": torch.zeros(schema.padded_vocab_size, device=device),
    }
