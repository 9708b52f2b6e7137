"""Text matching (port of ``analytics_zoo_tpu.models.textmatching``; ref
models/textmatching/KNRM.scala:60, buildModel:75).

KNRM: one embedding shared by the query and the document ids (one leaf,
whose gradient sums both uses); the cosine translation matrix; RBF kernel
pooling (``kernel_num`` kernels with their means spaced over [-1, 1], the
exact-match kernel at ``exact_sigma``); log-sum pooling; a linear +
sigmoid score. It trains pairwise with RankHinge over interleaved (pos,
neg) batches (``TextSet.from_relation_pairs`` -> ``PairFeatureSet``) and
is evaluated with MAP/NDCG through ``Ranker``.

The exact-match kernel at sigma 0.001 turns a one-ulp change of a cosine
near 1 into about (m - mu) / sigma^2 ulps of its ``exp``, so the cosine
is formed as in the JAX package: ``x / (sqrt(sum(x * x)) + 1e-12)`` in the
embedding's dtype, an einsum (no TF32: ``init_nncontext`` turns it off),
and the kernel means and widths as float32 tensors, which promote a bf16
cosine to float32 as JAX's type promotion does.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from analytics_zoo_tpu_torch.keras.engine.base import Lambda
from analytics_zoo_tpu_torch.keras.engine.topology import Input, Model
from analytics_zoo_tpu_torch.keras.layers import (
    Dense,
    Embedding,
    WordEmbedding,
)
from analytics_zoo_tpu_torch.models.common import Ranker, ZooModel


class TextMatcher(ZooModel, Ranker):
    """Ref textmatching/text_matcher.py TextMatcher, the family base: a
    ZooModel ranked by the Ranker MAP/NDCG protocol."""


def _kernel_pooling(mu: np.ndarray, sigmas: np.ndarray):
    """(query (B,L1,E), doc (B,L2,E)) -> (B, K) log-sum kernel features.
    The kernel constants are copied to a device once, on its first call
    there (outside any CUDA graph capture: a capture is preceded by an
    eager run)."""
    on_device = {}

    def consts(device):
        key = str(device)
        if key not in on_device:
            on_device[key] = (torch.tensor(mu, dtype=torch.float32,
                                           device=device),
                              torch.tensor(sigmas, dtype=torch.float32,
                                           device=device))
        return on_device[key]

    def fn(qv, dv):
        mu_c, sig_c = consts(qv.device)
        qn = qv / (torch.sqrt(torch.sum(qv * qv, -1, keepdim=True)) + 1e-12)
        dn = dv / (torch.sqrt(torch.sum(dv * dv, -1, keepdim=True)) + 1e-12)
        m = torch.einsum("bqe,bde->bqd", qn, dn)  # cosine translation matrix
        k = torch.exp(-torch.square(m[..., None] - mu_c)
                      / (2.0 * torch.square(sig_c)))
        pooled = torch.sum(k, dim=2)              # sum over doc terms (B,q,K)
        log_pooled = torch.log(torch.clamp(pooled, min=1e-10)) * 0.01
        return torch.sum(log_pooled, dim=1)       # sum over query terms (B,K)

    return fn


class KNRM(TextMatcher):
    """Kernel-pooling neural ranking model (ref KNRM.scala:60).
    ``embedding``: the width of a trainable embedding, or a pretrained
    (vocab, width) matrix (a frozen ``WordEmbedding``)."""

    def __init__(self, text1_length: int, text2_length: int,
                 embedding: Union[int, np.ndarray] = 100,
                 vocab_size: int = 20000, train_embed: bool = True,
                 kernel_num: int = 21, sigma: float = 0.1,
                 exact_sigma: float = 0.001):
        super().__init__()
        self.text1_length = text1_length
        self.text2_length = text2_length
        self._embedding = embedding
        self.vocab_size = vocab_size
        self.train_embed = train_embed
        self.kernel_num = kernel_num
        self.sigma = sigma
        self.exact_sigma = exact_sigma
        self.model = self.build_model()

    def build_model(self) -> Model:
        q = Input(shape=(self.text1_length,), name="query")
        d = Input(shape=(self.text2_length,), name="doc")
        if isinstance(self._embedding, int):
            embed = Embedding(self.vocab_size, self._embedding,
                              trainable=self.train_embed,
                              name="shared_embed")
        else:
            embed = WordEmbedding(self._embedding, name="shared_embed")
        qe = embed(q)  # (B, L1, E): one layer object, one weight leaf
        de = embed(d)  # (B, L2, E)

        mu = np.linspace(-1.0, 1.0, self.kernel_num)
        mu[-1] = 1.0
        sigmas = np.full(self.kernel_num, self.sigma)
        sigmas[-1] = self.exact_sigma  # the exact-match kernel (KNRM.scala:75)
        feats = Lambda(_kernel_pooling(mu, sigmas), arity=2,
                       output_shape_fn=lambda s: (None, self.kernel_num),
                       name="kernel_pooling")([qe, de])
        score = Dense(1, activation="sigmoid", name="score")(feats)
        return Model([q, d], score, name="knrm")

    def config(self):
        cfg = {"text1_length": self.text1_length,
               "text2_length": self.text2_length,
               "vocab_size": self.vocab_size, "train_embed": self.train_embed,
               "kernel_num": self.kernel_num, "sigma": self.sigma,
               "exact_sigma": self.exact_sigma}
        if isinstance(self._embedding, int):
            cfg["embedding"] = self._embedding
        else:
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
