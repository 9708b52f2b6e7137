"""Attention layers (port of ``analytics_zoo_tpu.keras.layers.attention``):
MultiHeadAttention, TransformerBlock, TransformerLayer (GPT-style) and BERT.

Attention goes through ``ops.attention.scaled_dot_product_attention``: the
flash kernel on the card. The QKV, projection, FFN and pooler matmuls are
plain ``torch.matmul``. This slice serves: ``training=True`` raises, as do
sequence parallelism, pipeline parallelism and rematerialization, which
come with later slices.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.engine.base import (
    KerasLayer,
    Shape,
    unique_name,
)
from analytics_zoo_tpu_torch.keras.layers.core import get_activation
from analytics_zoo_tpu_torch.ops.attention import scaled_dot_product_attention


def _layer_norm(x, gamma, beta, eps: float):
    """Last-dim LayerNorm: f32 statistics (biased variance), output in
    x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma + beta).to(x.dtype)


def _inference_only(training: bool) -> None:
    if training:
        raise NotImplementedError(
            "training (dropout) comes with the training slice of the port")


def _not_yet(feature: str, value) -> None:
    if value:
        raise NotImplementedError(f"{feature} is not ported yet")


def _embed(table, ids):
    return F.embedding(ids.long(), table)


class MultiHeadAttention(KerasLayer):
    """Self-attention over (B, S, H); ``cross=True`` takes [query, kv]."""

    def __init__(self, n_head: int, hidden_size: Optional[int] = None,
                 attn_dropout: float = 0.0, resid_dropout: float = 0.0,
                 causal: bool = False, cross: bool = False,
                 sequence_parallel: Optional[str] = None, input_shape=None,
                 name=None):
        super().__init__(input_shape, name)
        _not_yet("sequence_parallel", sequence_parallel)
        self.n_head = n_head
        self.hidden_size = hidden_size
        self.attn_dropout = attn_dropout
        self.resid_dropout = resid_dropout
        self.causal = causal
        self.cross = cross

    @staticmethod
    def _norm_shape(input_shape: Shape) -> Shape:
        # wired as [x, mask] (padding-mask form): shapes key on x
        if input_shape and isinstance(input_shape[0], (list, tuple)):
            return tuple(input_shape[0])
        return input_shape

    def build(self, input_shape: Shape):
        if self.cross:
            if not (input_shape and isinstance(input_shape[0],
                                               (list, tuple))):
                raise ValueError(
                    f"{self.name}: cross=True needs [query, kv] inputs")
            q_shape, kv_shape = input_shape[0], input_shape[1]
            h = self.hidden_size or q_shape[-1]
            self.hidden_size = h
            if h % self.n_head:
                raise ValueError(f"hidden {h} not divisible by {self.n_head}")
            self.add_weight("q_kernel", (q_shape[-1], h), "glorot_uniform")
            self.add_weight("q_bias", (h,), "zeros")
            self.add_weight("kv_kernel", (kv_shape[-1], 2 * h),
                            "glorot_uniform")
            self.add_weight("kv_bias", (2 * h,), "zeros")
            self.add_weight("proj_kernel", (h, h), "glorot_uniform")
            self.add_weight("proj_bias", (h,), "zeros")
            return
        input_shape = self._norm_shape(input_shape)
        h = self.hidden_size or input_shape[-1]
        self.hidden_size = h
        if h % self.n_head:
            raise ValueError(f"hidden {h} not divisible by {self.n_head}")
        self.add_weight("qkv_kernel", (input_shape[-1], 3 * h),
                        "glorot_uniform")
        self.add_weight("qkv_bias", (3 * h,), "zeros")
        self.add_weight("proj_kernel", (h, h), "glorot_uniform")
        self.add_weight("proj_bias", (h,), "zeros")

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        if self.cross:
            return tuple(input_shape[0])[:-1] + (self.hidden_size,)
        input_shape = self._norm_shape(input_shape)
        return tuple(input_shape[:-1]) + (self.hidden_size,)

    def _heads(self, t, s):
        b, n = t.shape[0], self.n_head
        return t.reshape(b, s, n, self.hidden_size // n).transpose(1, 2)

    def _call_cross(self, params, x):
        if not isinstance(x, (list, tuple)) or len(x) != 2:
            raise ValueError(
                f"{self.name}: cross=True takes [query, kv] inputs")
        q_in, kv_in = x
        b, s_q, _ = q_in.shape
        s_kv = kv_in.shape[1]
        q = q_in @ params["q_kernel"] + params["q_bias"]
        kv = kv_in @ params["kv_kernel"] + params["kv_bias"]
        k, v = kv.chunk(2, dim=-1)
        out = scaled_dot_product_attention(
            self._heads(q, s_q), self._heads(k, s_kv), self._heads(v, s_kv),
            causal=self.causal)
        out = out.transpose(1, 2).reshape(b, s_q, self.hidden_size)
        return out @ params["proj_kernel"] + params["proj_bias"]

    def call(self, params, x, training=False, mask=None, **kw):
        _inference_only(training)
        if self.cross:
            return self._call_cross(params, x)
        if isinstance(x, (list, tuple)):
            if len(x) != 2 or mask is not None:
                raise ValueError(
                    "MultiHeadAttention takes x or [x, padding_mask]; got "
                    f"{len(x)} inputs")
            x, mask = x
        b, s, _ = x.shape
        h = self.hidden_size
        qkv = x @ params["qkv_kernel"] + params["qkv_bias"]
        q, k, v = qkv.chunk(3, dim=-1)
        bias = None
        if mask is not None:
            m = mask.float()
            if getattr(self, "_keras_mask_mode", False):
                # tf.keras auto-mask semantics: query AND key masks combine
                mm = m[:, None, :, None] * m[:, None, None, :]  # (B,1,S,S)
                bias = (1.0 - mm) * -1e9
            else:
                # standard padding-mask form: exclude pad KEYS (B, 1, 1, S)
                bias = (1.0 - m[:, None, None, :]) * -1e9
            bias = bias.to(x.dtype)
        out = scaled_dot_product_attention(
            self._heads(q, s), self._heads(k, s), self._heads(v, s),
            bias=bias, causal=self.causal)
        out = out.transpose(1, 2).reshape(b, s, h)
        return out @ params["proj_kernel"] + params["proj_bias"]


class TransformerBlock(KerasLayer):
    """Post-LN transformer block: MHA -> add&norm -> FFN -> add&norm."""

    def __init__(self, n_head: int, intermediate_size: Optional[int] = None,
                 hidden_drop: float = 0.0, attn_drop: float = 0.0,
                 causal: bool = False, activation: str = "gelu",
                 layer_norm_eps: float = 1e-5,
                 sequence_parallel: Optional[str] = None,
                 input_shape=None, name=None):
        super().__init__(input_shape,
                         name or unique_name("transformer_block"))
        self.n_head = n_head
        self.intermediate_size = intermediate_size
        self.hidden_drop = hidden_drop
        self.attn = MultiHeadAttention(n_head, attn_dropout=attn_drop,
                                       resid_dropout=hidden_drop,
                                       causal=causal,
                                       sequence_parallel=sequence_parallel,
                                       name=self.name + "_attn")
        self.activation = get_activation(activation)
        self.eps = layer_norm_eps

    def build(self, input_shape: Shape):
        h = input_shape[-1]
        m = self.intermediate_size or 4 * h
        self.intermediate_size = m
        self.attn.ensure_built(input_shape)
        self.weight_specs.extend(self.attn.weight_specs)  # MHA params inline
        self.add_weight("ln1_gamma", (h,), "ones")
        self.add_weight("ln1_beta", (h,), "zeros")
        self.add_weight("ffn_in_kernel", (h, m), "glorot_uniform")
        self.add_weight("ffn_in_bias", (m,), "zeros")
        self.add_weight("ffn_out_kernel", (m, h), "glorot_uniform")
        self.add_weight("ffn_out_bias", (h,), "zeros")
        self.add_weight("ln2_gamma", (h,), "ones")
        self.add_weight("ln2_beta", (h,), "zeros")

    def call(self, params, x, training=False, mask=None, **kw):
        _inference_only(training)
        a = self.attn.call(params, x, mask=mask)
        x = _layer_norm(x + a, params["ln1_gamma"], params["ln1_beta"],
                        self.eps)
        f = self.activation(x @ params["ffn_in_kernel"]
                            + params["ffn_in_bias"])
        f = f @ params["ffn_out_kernel"] + params["ffn_out_bias"]
        return _layer_norm(x + f, params["ln2_gamma"], params["ln2_beta"],
                           self.eps)


class TransformerLayer(KerasLayer):
    """GPT-style transformer over token ids: ids (B, S) or [ids, mask] ->
    (B, S, H); causal unless ``bidirectional``."""

    def __init__(self, vocab: int, seq_len: int, n_block: int = 12,
                 hidden_size: int = 768, n_head: int = 12,
                 embedding_drop: float = 0.1, hidden_drop: float = 0.1,
                 attn_drop: float = 0.1, bidirectional: bool = False,
                 activation: str = "gelu", remat: bool = False,
                 sequence_parallel: Optional[str] = None,
                 pipeline_parallel: bool = False,
                 input_shape=None, name=None):
        super().__init__(input_shape, name or unique_name("transformer"))
        _not_yet("remat", remat)
        _not_yet("pipeline_parallel", pipeline_parallel)
        _not_yet("sequence_parallel", sequence_parallel)
        self.vocab = vocab
        self.seq_len = seq_len
        self.n_block = n_block
        self.hidden_size = hidden_size
        self.n_head = n_head
        self.embedding_drop = embedding_drop
        self.blocks = nn.ModuleList(
            TransformerBlock(n_head, hidden_drop=hidden_drop,
                             attn_drop=attn_drop, causal=not bidirectional,
                             activation=activation,
                             name=f"{self.name}_block{i}")
            for i in range(n_block))

    def build(self, input_shape: Shape):
        h = self.hidden_size
        self.add_weight("word_embed", (self.vocab, h), "normal")
        self.add_weight("pos_embed", (self.seq_len, h), "normal")
        for blk in self.blocks:
            blk.ensure_built((None, self.seq_len, h))

    def param_specs(self):
        out = super().param_specs()
        for blk in self.blocks:
            out[blk.name] = blk.param_specs()
        return out

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        base = (input_shape[0] if isinstance(input_shape, list)
                else input_shape)
        return (base[0], base[1], self.hidden_size)

    def call(self, params, x, training=False, **kw):
        _inference_only(training)
        if isinstance(x, (list, tuple)):
            ids, mask = x[0], x[1]
        else:
            ids, mask = x, None
        h = (_embed(params["word_embed"], ids)
             + params["pos_embed"][None, :ids.shape[1]])
        for blk in self.blocks:
            h = blk.call(params[blk.name], h, mask=mask)
        return h


class BERT(KerasLayer):
    """BERT encoder. Input: [token_ids, token_type_ids, position_ids,
    attention_mask], each (B, S); output (B, S, H). ``pooled`` computes the
    [CLS] pooler."""

    def __init__(self, vocab: int = 40990, hidden_size: int = 768,
                 n_block: int = 12, n_head: int = 12, seq_len: int = 512,
                 intermediate_size: int = 3072, hidden_drop: float = 0.1,
                 attn_drop: float = 0.1, type_vocab: int = 2,
                 remat: bool = False, input_shape=None, name=None):
        super().__init__(input_shape, name or unique_name("bert"))
        _not_yet("remat", remat)
        self.vocab = vocab
        self.hidden_size = hidden_size
        self.seq_len = seq_len
        self.type_vocab = type_vocab
        self.hidden_drop = hidden_drop
        self.blocks = nn.ModuleList(
            TransformerBlock(n_head, intermediate_size=intermediate_size,
                             hidden_drop=hidden_drop, attn_drop=attn_drop,
                             causal=False, activation="gelu",
                             layer_norm_eps=1e-12,
                             name=f"{self.name}_block{i}")
            for i in range(n_block))

    def build(self, input_shape: Shape):
        h = self.hidden_size
        self.add_weight("word_embed", (self.vocab, h), "normal")
        self.add_weight("pos_embed", (self.seq_len, h), "normal")
        self.add_weight("type_embed", (self.type_vocab, h), "normal")
        self.add_weight("embed_ln_gamma", (h,), "ones")
        self.add_weight("embed_ln_beta", (h,), "zeros")
        self.add_weight("pooler_kernel", (h, h), "glorot_uniform")
        self.add_weight("pooler_bias", (h,), "zeros")
        for blk in self.blocks:
            blk.ensure_built((None, self.seq_len, h))

    def param_specs(self):
        out = super().param_specs()
        for blk in self.blocks:
            out[blk.name] = blk.param_specs()
        return out

    def compute_output_shape(self, input_shape) -> Shape:
        base = (input_shape[0] if isinstance(input_shape, list)
                else input_shape)
        return (base[0], base[1], self.hidden_size)

    def call(self, params, x, training=False, **kw):
        _inference_only(training)
        ids, type_ids, pos_ids, mask = x
        e = (_embed(params["word_embed"], ids)
             + _embed(params["type_embed"], type_ids)
             + _embed(params["pos_embed"], pos_ids))
        h = _layer_norm(e, params["embed_ln_gamma"], params["embed_ln_beta"],
                        1e-12)
        for blk in self.blocks:
            h = blk.call(params[blk.name], h, mask=mask)
        return h

    def pooled(self, params, seq_output):
        """[CLS] pooler: first-token dense + tanh."""
        first = seq_output[:, 0]
        return torch.tanh(first @ params["pooler_kernel"]
                          + params["pooler_bias"])
