"""Batch scoring: the port of ``deepctr_tpu/serving.py::Scorer``.

Load a checkpoint into a model, then stream scores for packed id batches or
yx text files. Batches have a fixed size; the last one is padded with
``pad_id`` rows whose scores are dropped, as in the JAX package.

``quantize`` stores the served table narrower, as the reference's does:
``"bf16"`` rounds it to bfloat16 (2 bytes an element); ``"int8"`` keeps an
int8 ``[V, D]`` table and an f32 ``[V]`` row scale, ``max(|row|, 1e-12) /
127``, with each element ``round(x / scale)`` (half to even) clipped to
±127, D + 4 bytes a row. Only the gathered rows are widened (bf16) or
dequantised (int8, ``q · scale``); the model's math stays f32. The model's
own f32 table is released, so the quantised one is the only copy on the
device. The reference packs each int8 row and its scale into 32-bit words,
a TPU gather device; the port's layout is the plain one, and its
dequantised rows equal the reference's bit for bit.

The JAX scorer reads small fields through a split plan of one-hot matmuls
(``ops/split_embed.py``), a TPU gather mechanism. Here one row gather on the
full table is the same math: pad slots are zeroed by the mask either way.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from .data import Schema, minibatches, stream_yx_batches
from .utils import prof
from .utils.checkpoint import (
    dense_structure,
    load_scoring_params,
    params_from_jax,
    read_manifest,
)


def _sigmoid(logits: np.ndarray) -> np.ndarray:
    x = np.clip(logits, -30, 30)
    return 1.0 / (1.0 + np.exp(-x))


QUANTIZE = (None, "bf16", "int8")


@torch.no_grad()
def quantize_int8(table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q int8[V, D], scale f32[V])`` of an f32 table, by the reference's
    rule: ``scale = max(|row|, 1e-12) / 127``, ``q = clip(round(x / scale),
    -127, 127)``."""
    table = table.float()
    scale = torch.clamp(table.abs().amax(dim=1, keepdim=True), min=1e-12) / 127.0
    q = torch.clamp(torch.round(table / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0].contiguous()


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    ids: torch.Tensor) -> torch.Tensor:
    """The f32 rows of ``ids`` from an int8 table: ``q[ids] · scale[ids]``."""
    return q[ids].float() * scale[ids][..., None]


class Scorer:
    """Batch scorer for a model whose parameters are loaded. It scores on
    the device the model's parameters lie on. ``quantize`` is None (f32),
    ``"bf16"`` or ``"int8"``; with either of the last two the model's table
    is replaced by the quantised one."""

    def __init__(self, model: torch.nn.Module, schema: Schema,
                 batch_size: int = 8192, quantize: str | None = None):
        if quantize not in QUANTIZE:
            raise ValueError(f"quantize {quantize!r} (None|bf16|int8)")
        self.model = model
        self.schema = schema
        self.batch_size = batch_size
        self.quantize = quantize
        self.device = model.table.device
        table = model.table.detach()
        if quantize == "int8":
            self._q, self._scale = quantize_int8(table)
        else:
            self._table = table.to(torch.bfloat16) if quantize == "bf16" else table
        if quantize is not None:   # the quantised table is the only copy
            model.table.data = model.table.data.new_empty((0, table.shape[1]))

    @property
    def table_bytes(self) -> int:
        """Device bytes of the served table: V·D·4 (f32), V·D·2 (bf16) or
        V·(D + 4) (int8)."""
        tables = (self._q, self._scale) if self.quantize == "int8" else (self._table,)
        return sum(t.numel() * t.element_size() for t in tables)

    def rows(self, ids: torch.Tensor) -> torch.Tensor:
        """The f32 rows ``[B, S, D]`` of ids on the scorer's device."""
        if self.quantize == "int8":
            return dequantize_rows(self._q, self._scale, ids)
        return self._table[ids].float()

    @staticmethod
    def from_checkpoint(path: str, model: torch.nn.Module,
                        schema: Schema | None = None,
                        batch_size: int = 8192,
                        quantize: str | None = None) -> "Scorer":
        """Load a checkpoint written by either package into ``model``.

        The manifest carries the training Schema (``schema_json``). A
        caller-supplied ``schema`` must match it; ``None`` uses the
        manifest's (an error if the checkpoint predates schema embedding).
        """
        manifest = read_manifest(path)
        if "schema_json" in manifest:
            ckpt_schema = Schema.from_json(manifest["schema_json"])
            if schema is None:
                schema = ckpt_schema
            elif schema.to_json() != ckpt_schema.to_json():
                raise ValueError(
                    f"schema mismatch: checkpoint {path} was trained with a "
                    f"different Schema ({ckpt_schema.num_fields} fields, "
                    f"vocab {ckpt_schema.vocab_size}) than the one supplied "
                    f"({schema.num_fields} fields, vocab {schema.vocab_size})"
                )
        elif schema is None:
            raise ValueError(
                f"checkpoint {path} has no embedded schema (pre-schema_json "
                f"format) — pass the training Schema explicitly"
            )
        table, dense = load_scoring_params(path, dense_structure(model))
        model.load_state_dict(params_from_jax(table, dense))
        return Scorer(model, schema, batch_size=batch_size, quantize=quantize)

    # ---- scoring ----------------------------------------------------------
    # Tracing (:mod:`.utils.prof`): a request to ``logits`` or ``predict`` is
    # the span ``score.request``; in it each batch's ``score.pad`` (cut and
    # padded on the host), ``score.h2d``, ``score.forward`` (gather, mask and
    # tower, enqueued) and ``score.fetch`` (the copy back, which waits for
    # the device), then ``score.sigmoid``. The counters ``score.rows`` and
    # ``score.padded_rows`` count the rows asked and the rows computed.

    def _batch_logits(self, ids: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            with prof.span("score.h2d"):
                ids_t = torch.from_numpy(ids).to(self.device).long()
            with prof.span("score.forward"):
                rows = self.rows(ids_t)
                mask = (ids_t != self.schema.pad_id).to(rows.dtype)
                logits = self.model.apply_rows(rows, mask)
            with prof.span("score.fetch"):
                return logits.cpu().numpy()

    def _logits(self, ids: np.ndarray) -> np.ndarray:
        out = []
        batches = minibatches(
            ids, np.zeros(len(ids), np.float32), self.batch_size,
            schema=self.schema, shuffle=False, drop_remainder=False,
        )
        prof.count("score.rows", len(ids))
        for _ in range(-(-len(ids) // self.batch_size)):
            with prof.span("score.pad"):
                b = next(batches)
            prof.count("score.padded_rows", len(b.ids))
            out.append(self._batch_logits(b.ids)[b.weights > 0])
        return np.concatenate(out) if out else np.empty(0, np.float32)

    def logits(self, ids: np.ndarray) -> np.ndarray:
        """Score packed ``int32[N, S]`` ids -> logit per row."""
        with prof.span("score.request", rows=len(ids)):
            return self._logits(ids)

    def predict(self, ids: np.ndarray) -> np.ndarray:
        """Click probabilities in [0, 1]."""
        with prof.span("score.request", rows=len(ids)):
            logits = self._logits(ids)
            with prof.span("score.sigmoid"):
                return _sigmoid(logits)

    def score_yx_file(self, path: str, use_native: bool = True) -> Iterator[np.ndarray]:
        """Stream a yx text file -> chunks of probabilities. Each batch of the
        file is a ``score.request`` of the tracing."""
        for b in stream_yx_batches(
            [path], self.schema, self.batch_size, use_native=use_native
        ):
            real = b.weights > 0
            rows = int(real.sum())
            with prof.span("score.request", rows=rows):
                prof.count("score.rows", rows)
                prof.count("score.padded_rows", len(b.ids))
                logits = self._batch_logits(b.ids)[real]
                with prof.span("score.sigmoid"):
                    probs = _sigmoid(logits)
            yield probs
