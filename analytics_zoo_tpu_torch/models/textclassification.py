"""Text classification (port of
``analytics_zoo_tpu.models.textclassification``): ref
models/textclassification/TextClassifier.scala:34 (buildModel:43-69):
embedding -> {CNN | LSTM | GRU} encoder -> Dropout(0.2) -> Dense(128,
relu) -> softmax head, built layer for layer as in the JAX package so the
weights map 1:1 (``interop``).

The embedding is a trainable ``Embedding`` of ``vocab_size`` rows, or a
frozen ``WordEmbedding`` over a given (vocab, dim) matrix (the reference's
GloVe route; any matrix works, no file is read).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
from analytics_zoo_tpu_torch.keras.layers import (
    GRU,
    LSTM,
    Convolution1D,
    Dense,
    Dropout,
    Embedding,
    GlobalMaxPooling1D,
    WordEmbedding,
)
from analytics_zoo_tpu_torch.models.common import ZooModel


class TextClassifier(ZooModel):
    def __init__(self, class_num: int,
                 embedding: Union[int, np.ndarray] = 200,
                 sequence_length: int = 500, encoder: str = "cnn",
                 encoder_output_dim: int = 256,
                 token_length: Optional[int] = None,
                 vocab_size: int = 20000):
        """``embedding`` is either a pretrained (vocab, dim) matrix (the
        WordEmbedding.scala:49 route) or an int dim for a trainable
        embedding."""
        super().__init__()
        self.class_num = class_num
        self.sequence_length = sequence_length
        self.encoder = encoder.lower()
        self.encoder_output_dim = encoder_output_dim
        self.vocab_size = vocab_size
        self._embedding = embedding
        self.token_length = token_length or (
            embedding if isinstance(embedding, int)
            else np.asarray(embedding).shape[1])
        self.model = self.build_model()

    def build_model(self) -> Sequential:
        m = Sequential(name="text_classifier")
        if isinstance(self._embedding, int):
            m.add(Embedding(self.vocab_size, self._embedding,
                            input_length=self.sequence_length))
        else:
            m.add(WordEmbedding(self._embedding,
                                input_length=self.sequence_length))
        if self.encoder == "cnn":
            m.add(Convolution1D(self.encoder_output_dim, 5,
                                activation="relu"))
            m.add(GlobalMaxPooling1D())
        elif self.encoder == "lstm":
            m.add(LSTM(self.encoder_output_dim))
        elif self.encoder == "gru":
            m.add(GRU(self.encoder_output_dim))
        else:
            raise ValueError(
                f"Unknown encoder '{self.encoder}' (cnn|lstm|gru)")
        m.add(Dropout(0.2))
        m.add(Dense(128, activation="relu"))
        m.add(Dense(self.class_num, activation="softmax"))
        return m

    def config(self):
        cfg = {"class_num": self.class_num,
               "sequence_length": self.sequence_length,
               "encoder": self.encoder,
               "encoder_output_dim": self.encoder_output_dim,
               "vocab_size": self.vocab_size}
        if isinstance(self._embedding, int):
            cfg["embedding"] = self._embedding
        else:
            # only the shape: the matrix lives in the weights, which
            # load_model restores after construction
            cfg["embedding"] = {"pretrained_shape":
                                list(np.asarray(self._embedding).shape)}
        return cfg

    @classmethod
    def _from_config(cls, cfg):
        emb = cfg.get("embedding")
        if isinstance(emb, dict):
            cfg = dict(cfg)
            cfg["embedding"] = np.zeros(emb["pretrained_shape"], np.float32)
        return cls(**cfg)
