"""Batch scoring: the port of ``deepctr_tpu/serving.py::Scorer`` (f32).

Load a checkpoint into a model, then stream scores for packed id batches or
yx text files. Batches have a fixed size; the last one is padded with
``pad_id`` rows whose scores are dropped, as in the JAX package.

The JAX scorer reads small fields through a split plan of one-hot matmuls
(``ops/split_embed.py``), a TPU gather mechanism. Here one row gather on the
full table is the same math: pad slots are zeroed by the mask either way.
bf16 and int8 serving come later (ROADMAP.md).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from .models.base import apply_model
from .data import Schema, minibatches, stream_yx_batches
from .utils.checkpoint import (
    dense_structure,
    load_scoring_params,
    params_from_jax,
    read_manifest,
)


def _sigmoid(logits: np.ndarray) -> np.ndarray:
    x = np.clip(logits, -30, 30)
    return 1.0 / (1.0 + np.exp(-x))


class Scorer:
    """Batch scorer for a model whose parameters are loaded. It scores on
    the device the model's parameters lie on."""

    def __init__(self, model: torch.nn.Module, schema: Schema,
                 batch_size: int = 8192):
        self.model = model
        self.schema = schema
        self.batch_size = batch_size
        self.device = model.table.device

    @staticmethod
    def from_checkpoint(path: str, model: torch.nn.Module,
                        schema: Schema | None = None,
                        batch_size: int = 8192) -> "Scorer":
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
        return Scorer(model, schema, batch_size=batch_size)

    # ---- scoring ----------------------------------------------------------

    def _batch_logits(self, ids: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            ids_t = torch.from_numpy(ids).to(self.device).long()
            logits = apply_model(self.model, ids_t, self.schema.pad_id)
            return logits.cpu().numpy()

    def logits(self, ids: np.ndarray) -> np.ndarray:
        """Score packed ``int32[N, S]`` ids -> logit per row."""
        out = []
        for b in minibatches(
            ids, np.zeros(len(ids), np.float32), self.batch_size,
            schema=self.schema, shuffle=False, drop_remainder=False,
        ):
            out.append(self._batch_logits(b.ids)[b.weights > 0])
        return np.concatenate(out) if out else np.empty(0, np.float32)

    def predict(self, ids: np.ndarray) -> np.ndarray:
        """Click probabilities in [0, 1]."""
        return _sigmoid(self.logits(ids))

    def score_yx_file(self, path: str, use_native: bool = True) -> Iterator[np.ndarray]:
        """Stream a yx text file -> chunks of probabilities."""
        for b in stream_yx_batches(
            [path], self.schema, self.batch_size, use_native=use_native
        ):
            yield _sigmoid(self._batch_logits(b.ids)[b.weights > 0])
