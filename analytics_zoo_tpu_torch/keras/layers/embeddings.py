"""Embedding layers (port of ``analytics_zoo_tpu.keras.layers.embeddings``).

Ref: keras/layers/Embedding.scala (a trainable lookup table) and
WordEmbedding.scala:49 (a frozen pretrained GloVe lookup). The lookup is
``F.embedding`` on int64 ids; integer or float input is truncated to ids
as the JAX package's ``astype(int32)`` does. A compute-dtype (bf16) table
accumulates its gradient in that dtype, as ``jnp.take``'s does. A
``W_regularizer`` penalises the table.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.keras.engine.base import KerasLayer, Shape


class Embedding(KerasLayer):
    """Lookup of ``(..., )`` ids into an ``(input_dim, output_dim)`` table
    (``weights=`` a pretrained one); ``pad_value`` ids look up zeros."""

    def __init__(self, input_dim: int, output_dim: int, init="uniform",
                 trainable=True, W_regularizer=None, input_shape=None,
                 input_length=None, name=None,
                 weights: Optional[np.ndarray] = None,
                 pad_value: Optional[int] = None):
        if input_length is not None and input_shape is None:
            input_shape = (input_length,)
        super().__init__(input_shape, name)
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.init = init
        self.trainable = trainable
        self.W_regularizer = W_regularizer
        self.pretrained = weights
        self.pad_value = pad_value

    def build(self, input_shape: Shape):
        if self.pretrained is not None:
            w = torch.tensor(np.asarray(self.pretrained, dtype=np.float32))
            self.add_weight("embeddings", tuple(w.shape),
                            lambda generator, shape, dtype=torch.float32:
                            w.to(dtype, copy=True),
                            regularizer=self.W_regularizer,
                            trainable=self.trainable)
        else:
            self.add_weight("embeddings", (self.input_dim, self.output_dim),
                            self.init, regularizer=self.W_regularizer,
                            trainable=self.trainable)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return tuple(input_shape) + (self.output_dim,)

    def call(self, params, x, **kw):
        idx = x.long()
        emb = F.embedding(idx, params["embeddings"])
        if self.pad_value is not None:
            emb = emb * (idx != self.pad_value)[..., None].to(emb.dtype)
        return emb


class WordEmbedding(Embedding):
    """Frozen pretrained word-vector lookup (ref WordEmbedding.scala:49):
    build it with :meth:`from_glove` and a word index, or from a matrix.
    The weights are not trainable, as in the reference."""

    def __init__(self, embedding_matrix: np.ndarray, input_length=None,
                 name=None):
        m = np.asarray(embedding_matrix, dtype=np.float32)
        super().__init__(m.shape[0], m.shape[1], trainable=False,
                         input_length=input_length, name=name, weights=m)

    @staticmethod
    def from_glove(glove_path: str, word_index: Dict[str, int],
                   input_length: Optional[int] = None) -> "WordEmbedding":
        """Build from a local GloVe text file; row 0 is padding and words
        the file lacks stay zero."""
        vectors: Dict[str, np.ndarray] = {}
        dim = None
        with open(glove_path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip().split(" ")
                if dim is None:
                    dim = len(parts) - 1
                vectors[parts[0]] = np.asarray(parts[1:], dtype=np.float32)
        matrix = np.zeros((max(word_index.values()) + 1, dim),
                          dtype=np.float32)
        for word, idx in word_index.items():
            if word in vectors:
                matrix[idx] = vectors[word]
        return WordEmbedding(matrix, input_length=input_length)

    @staticmethod
    def get_word_index(glove_path: str) -> Dict[str, int]:
        """The token -> id map of a GloVe text file (ids follow the
        file's line order from 1; ref WordEmbedding.getWordIndex)."""
        index = {}
        with open(glove_path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                index[line.split(" ", 1)[0]] = i + 1
        return index
