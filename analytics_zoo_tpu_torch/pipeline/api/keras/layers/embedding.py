"""Embedding layers (port of
``analytics_zoo_tpu/pipeline/api/keras/layers/embedding.py``):
``Embedding`` and the pretrained, frozen-by-default ``WordEmbedding``.

The lookup keeps the reference's ``jnp.take(table, ids.astype(int32),
axis=0)``: float ids are truncated, an id in [-n, -1] wraps to n + id,
any other id outside [0, n) gives a row of NaN and passes no gradient,
and the table's gradient is dense. It runs without a host sync, and no
out-of-range id reaches the gather (on the card that is a device-side
assert, which ends the process's CUDA context).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.ops import initializers, regularizers
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    KerasLayer, Shape)


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids.astype(int32), axis=0)``: rows of ``table``
    by ``ids`` (any shape), negatives wrapped, other ids out of range
    NaN with no gradient."""
    n = table.shape[0]
    ids = ids.long()
    valid = (ids >= -n) & (ids < n)
    idx = torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)
    rows = F.embedding(idx, table)
    return torch.where(valid[..., None], rows, float("nan"))


class Embedding(KerasLayer):
    """Trainable id → vector lookup: ids of shape (seq,) give
    (seq, output_dim). ``pad_zero`` makes row 0 all zeros at build."""

    def __init__(self, input_dim: int, output_dim: int, init="uniform",
                 w_regularizer=None, input_shape=None, name=None,
                 pad_zero: bool = False, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.kernel_init = initializers.get(init)
        self.w_regularizer = regularizers.get(w_regularizer)
        self.pad_zero = pad_zero

    def build(self, generator, input_shape: Shape) -> dict:
        table = self.kernel_init(generator, (self.input_dim,
                                             self.output_dim))
        if self.pad_zero:
            table[0] = 0.0
        return {"embeddings": table}

    def call(self, params, x, *, training=False, rng=None):
        return take_rows(params["embeddings"], x)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return tuple(input_shape) + (self.output_dim,)

    def regularizers(self):
        if self.w_regularizer is not None:
            return [("embeddings", self.w_regularizer)]
        return []


class WordEmbedding(KerasLayer):
    """Pretrained word embeddings, frozen by default. Construct with a
    numpy table, or with :meth:`from_glove` from a GloVe text file and
    a word index."""

    def __init__(self, weights: np.ndarray, trainable: bool = False,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name,
                         trainable=trainable, **kwargs)
        # the module's own ``weights`` attribute holds its param tree
        self.table = np.asarray(weights, np.float32)
        self.input_dim, self.output_dim = self.table.shape

    @staticmethod
    def from_glove(glove_path: str, word_index: "dict[str, int]",
                   embedding_dim: Optional[int] = None,
                   trainable: bool = False, input_shape=None,
                   name=None) -> "WordEmbedding":
        """A table from a GloVe ``word v1 v2 ...`` text file: row
        ``word_index[word]`` holds the word's vector, every other row
        (row 0, the padding and out-of-vocabulary id, among them) is
        zero."""
        vectors: "dict[str, np.ndarray]" = {}
        dim = embedding_dim
        with open(glove_path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip().split(" ")
                word = parts[0]
                if word not in word_index:
                    continue
                vec = np.asarray(parts[1:], np.float32)
                if dim is None:
                    dim = vec.shape[0]
                vectors[word] = vec
        if dim is None:
            raise ValueError(f"no usable vectors found in {glove_path}")
        table = np.zeros((max(word_index.values()) + 1, dim), np.float32)
        for word, idx in word_index.items():
            if word in vectors:
                table[idx] = vectors[word]
        return WordEmbedding(table, trainable=trainable,
                             input_shape=input_shape, name=name)

    def build(self, generator, input_shape: Shape) -> dict:
        return {"embeddings": torch.from_numpy(self.table.copy())}

    def call(self, params, x, *, training=False, rng=None):
        return take_rows(params["embeddings"], x)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return tuple(input_shape) + (self.output_dim,)
