"""Attention layers (port of ``analytics_zoo_tpu.keras.layers.attention``):
MultiHeadAttention, TransformerBlock, TransformerLayer (GPT-style) and BERT.

Attention goes through ``ops.attention.scaled_dot_product_attention``: the
flash kernels on the card, forward and backward. The QKV, projection, FFN
and pooler matmuls are plain ``torch.matmul``. With ``training=True`` and a
``torch.Generator`` as ``rng`` the layers apply the JAX package's dropout:
attention probabilities (which takes the reference path), the attention
output projection, the FFN output and the embeddings; the masks come from
that one generator in call order, not from ``jax.random.fold_in`` streams.
``remat=True`` recomputes each block's activations in the backward pass
(``torch.utils.checkpoint``, training only) and replays the block's
dropout draws from the generator's saved state, so loss and gradients are
bitwise those of ``remat=False``. ``sequence_parallel="ring"`` or
``"ulysses"`` runs the attention body through
:mod:`analytics_zoo_tpu_torch.parallel.ring_attention` when the context's
slot mesh has a ``seq`` axis longer than 1 (the standard path otherwise,
as in the JAX package). ``TransformerLayer(pipeline_parallel=True)`` runs
its block stack as GPipe stages over the context mesh's ``pipe`` axis
(:mod:`analytics_zoo_tpu_torch.parallel.pipeline`) when the mesh has one
longer than 1, and the sequential loop otherwise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from analytics_zoo_tpu_torch.keras.engine.base import (
    KerasLayer,
    Shape,
    unique_name,
)
from analytics_zoo_tpu_torch.keras.layers.core import get_activation
from analytics_zoo_tpu_torch.ops.attention import (
    dropout,
    scaled_dot_product_attention,
)


def _layer_norm(x, gamma, beta, eps: float):
    """Last-dim LayerNorm: f32 statistics (biased variance), output in
    x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma + beta).to(x.dtype)


def _maybe_dropout(x, rate: float, training: bool, rng):
    """The JAX package's ``training and rate > 0 and rng is not None``
    dropout, drawn from the generator ``rng``."""
    if training and rate > 0 and rng is not None:
        return dropout(x, rate, rng)
    return x


def _armed_mesh(axis_name: str):
    """The context's slot mesh, iff it carries ``axis_name`` with length
    > 1: the arming gate of the sequence-parallel dispatch (None: the
    standard path)."""
    from analytics_zoo_tpu_torch.common.nncontext import get_nncontext

    mesh = get_nncontext().mesh
    if axis_name not in mesh.axis_names:
        return None
    return mesh if mesh.shape[axis_name] > 1 else None


def _embed(table, ids):
    return F.embedding(ids.long(), table)


def _remat_block(blk, params, h, rng, mask):
    """``blk`` in training mode with its activations recomputed in the
    backward pass instead of saved (the JAX package's ``jax.checkpoint``
    per block): activation memory drops from one set per block to the
    block boundaries.

    The dropout masks come from the explicit generator ``rng``, which
    ``torch.utils.checkpoint``'s ``preserve_rng_state`` does not save (it
    saves only the default generators). So the block's generator state is
    snapshotted here before the forward; the recompute replays the same
    draws from that snapshot and then puts the generator back where it
    stood, which is where the whole forward left it: the next step draws
    what it would have drawn without remat."""
    start = None if rng is None else rng.get_state()
    ran = []

    def run(p, x):
        if rng is None or not ran:
            ran.append(True)
            return blk.call(p, x, training=True, rng=rng, mask=mask)
        after = rng.get_state()
        rng.set_state(start)
        try:
            return blk.call(p, x, training=True, rng=rng, mask=mask)
        finally:  # also when the recompute stops early
            rng.set_state(after)

    return checkpoint(run, params, h, use_reentrant=False,
                      preserve_rng_state=False)


def _fully_masked_rows(q, k, v, causal: bool):
    """The attention output (B, H, S, d) of queries whose every key is
    masked, as tf.keras's query mask makes a padded query's row: -1e9
    swamps its logits, so its softmax p is uniform over the keys it may
    see (every key, or the causal prefix) and its value is their mean of
    v. Its gradient is the softmax's at that row, ds = p (dp - delta),
    which reaches q and k too (as in the JAX package's (B,1,S,S) bias
    route): added as a term whose value is 0, sum_j p_j (u_j - mean_p u)
    v_j with u = scale q k^T - its detached value."""
    s_q, s_k = q.shape[2], k.shape[2]
    scale = q.shape[-1] ** -0.5
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad)
    vd = v.detach()
    if not causal:  # p = 1/S: the term is q (k^T (v - mean v)) scale / S
        out = v.mean(dim=2, keepdim=True)
        if grad:
            c = vd - vd.mean(dim=2, keepdim=True)
            t = q @ (k.transpose(-1, -2) @ c) * (scale / s_k)
            out = out + (t - t.detach())
        return out
    seen = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril(
        s_k - s_q)
    p = seen.to(v.dtype) / seen.sum(-1, keepdim=True).to(v.dtype)
    out = p @ v
    if grad:
        u = (q @ k.transpose(-1, -2)) * scale
        u = u - u.detach()
        out = out + (p * (u - (p * u).sum(-1, keepdim=True))) @ vd
    return out


def _run_blocks(blocks, params, h, training, rng, mask, remat):
    for blk in blocks:
        if training and remat:
            h = _remat_block(blk, params[blk.name], h, rng, mask)
        else:
            h = blk.call(params[blk.name], h, training=training, rng=rng,
                         mask=mask)
    return h


class MultiHeadAttention(KerasLayer):
    """Self-attention over (B, S, H); ``cross=True`` takes [query, kv].

    ``sequence_parallel``: "ring" or "ulysses" routes the attention body
    through the sequence-parallel engines when the context mesh carries a
    ``seq_mesh_axis`` of length > 1; on a mesh without one the layer runs
    the standard path. Key padding masks ride the engines; attention
    dropout, the Keras query-mask mode and cross-attention raise
    ``NotImplementedError`` once the engines engage, as in the JAX
    package."""

    def __init__(self, n_head: int, hidden_size: Optional[int] = None,
                 attn_dropout: float = 0.0, resid_dropout: float = 0.0,
                 causal: bool = False, cross: bool = False,
                 sequence_parallel: Optional[str] = None,
                 seq_mesh_axis: str = "seq", input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.n_head = n_head
        self.hidden_size = hidden_size
        self.attn_dropout = attn_dropout
        self.resid_dropout = resid_dropout
        self.causal = causal
        self.cross = cross
        if sequence_parallel not in (None, "ring", "ulysses"):
            raise ValueError(
                f"sequence_parallel must be None|'ring'|'ulysses', got "
                f"{sequence_parallel!r}")
        self.sequence_parallel = sequence_parallel
        self.seq_mesh_axis = seq_mesh_axis

    def _sp_mesh(self):
        """The context mesh, when sequence parallelism is armed and the
        mesh spans a seq axis (else None: the standard path)."""
        if self.sequence_parallel is None:
            return None
        return _armed_mesh(self.seq_mesh_axis)

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

    def _attend(self, q, k, v, bias, training, rng):
        drop = training and self.attn_dropout > 0 and rng is not None
        return scaled_dot_product_attention(
            q, k, v, bias=bias, causal=self.causal,
            dropout_rate=self.attn_dropout if drop else 0.0,
            dropout_generator=rng if drop else None)

    def _project(self, params, out, training, rng):
        y = out @ params["proj_kernel"] + params["proj_bias"]
        return _maybe_dropout(y, self.resid_dropout, training, rng)

    def _call_cross(self, params, x, training, rng):
        if not isinstance(x, (list, tuple)) or len(x) != 2:
            raise ValueError(
                f"{self.name}: cross=True takes [query, kv] inputs")
        if self._sp_mesh() is not None:
            raise NotImplementedError(
                "sequence-parallel cross-attention is not supported")
        q_in, kv_in = x
        b, s_q, _ = q_in.shape
        s_kv = kv_in.shape[1]
        q = q_in @ params["q_kernel"] + params["q_bias"]
        kv = kv_in @ params["kv_kernel"] + params["kv_bias"]
        k, v = kv.chunk(2, dim=-1)
        out = self._attend(self._heads(q, s_q), self._heads(k, s_kv),
                           self._heads(v, s_kv), None, training, rng)
        out = out.transpose(1, 2).reshape(b, s_q, self.hidden_size)
        return self._project(params, out, training, rng)

    def call(self, params, x, training=False, rng=None, mask=None, **kw):
        if self.cross:
            return self._call_cross(params, x, training, rng)
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
        q, k, v = self._heads(q, s), self._heads(k, s), self._heads(v, s)
        # tf.keras auto-mask semantics combine the query AND key masks
        # (B, 1, S, S). Without probability dropout (which takes the
        # reference path) a valid query sees only the key-padding bias
        # (B, 1, 1, S), the layout the flash kernels take, and a padded
        # query's row is _fully_masked_rows'.
        keras = mask is not None and getattr(self, "_keras_mask_mode", False)
        rows = keras and not (training and self.attn_dropout > 0
                              and rng is not None)
        bias = None
        if mask is not None:
            m = mask.float()
            mm = m[:, None, None, :]  # the padding-mask form: pad KEYS
            if keras and not rows:
                mm = m[:, None, :, None] * mm
            bias = ((1.0 - mm) * -1e9).to(x.dtype)
        sp_mesh = self._sp_mesh()
        if sp_mesh is not None:
            # raised at dispatch, not silently altered: on a mesh without a
            # seq axis the same config runs the standard path with dropout
            # and mask intact, so the conflict exists only when SP engages
            if (training and self.attn_dropout > 0) or keras:
                raise NotImplementedError(
                    "sequence-parallel attention supports causal + key "
                    "padding masks only — attention dropout and the keras "
                    "query-side mask mode don't fit the ring pass; set "
                    "attn dropout to 0, or run without sequence_parallel")
            from analytics_zoo_tpu_torch.parallel.ring_attention import (
                ring_attention,
                ulysses_attention,
            )

            sp_fn = (ring_attention if self.sequence_parallel == "ring"
                     else ulysses_attention)
            out = sp_fn(q, k, v, sp_mesh, seq_axis=self.seq_mesh_axis,
                        causal=self.causal, key_mask=mask)
            out = out.transpose(1, 2).reshape(b, s, h)
            return self._project(params, out, training, rng)
        out = self._attend(q, k, v, bias, training, rng)
        if rows:
            out = torch.where(m[:, None, :, None] > 0, out,
                              _fully_masked_rows(q, k, v, self.causal)
                              .to(out.dtype))
        out = out.transpose(1, 2).reshape(b, s, h)
        return self._project(params, out, training, rng)


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

    def call(self, params, x, training=False, rng=None, mask=None, **kw):
        a = self.attn.call(params, x, training=training, rng=rng, mask=mask)
        x = _layer_norm(x + a, params["ln1_gamma"], params["ln1_beta"],
                        self.eps)
        f = self.activation(x @ params["ffn_in_kernel"]
                            + params["ffn_in_bias"])
        f = f @ params["ffn_out_kernel"] + params["ffn_out_bias"]
        f = _maybe_dropout(f, self.hidden_drop, training, rng)
        return _layer_norm(x + f, params["ln2_gamma"], params["ln2_beta"],
                           self.eps)


class TransformerLayer(KerasLayer):
    """GPT-style transformer over token ids: ids (B, S) or [ids, mask] ->
    (B, S, H); causal unless ``bidirectional``.

    ``pipeline_parallel=True`` shards the BLOCK STACK over the context
    mesh's ``pipe_mesh_axis`` when it has one longer than 1 (GPipe
    fill-and-drain, :mod:`analytics_zoo_tpu_torch.parallel.pipeline`):
    n_block / p consecutive blocks a stage, ``pipe_microbatches``
    microbatches (default: the largest count up to 4 x p that keeps each
    microbatch's rows divisible over a ``data`` axis). On any other mesh
    the layer runs the sequential loop. Dropout cannot take a per-block
    generator through the stage ring, so training with dropout raises
    once the pipe engages, as in the JAX package."""

    def __init__(self, vocab: int, seq_len: int, n_block: int = 12,
                 hidden_size: int = 768, n_head: int = 12,
                 embedding_drop: float = 0.1, hidden_drop: float = 0.1,
                 attn_drop: float = 0.1, bidirectional: bool = False,
                 activation: str = "gelu", remat: bool = False,
                 sequence_parallel: Optional[str] = None,
                 pipeline_parallel: bool = False,
                 pipe_mesh_axis: str = "pipe",
                 pipe_microbatches: Optional[int] = None,
                 input_shape=None, name=None):
        super().__init__(input_shape, name or unique_name("transformer"))
        self.pipeline_parallel = bool(pipeline_parallel)
        self.pipe_mesh_axis = pipe_mesh_axis
        self.pipe_microbatches = pipe_microbatches
        self.hidden_drop = hidden_drop
        self.attn_drop = attn_drop
        self.vocab = vocab
        self.seq_len = seq_len
        self.n_block = n_block
        self.hidden_size = hidden_size
        self.n_head = n_head
        self.embedding_drop = embedding_drop
        self.remat = remat
        self.blocks = nn.ModuleList(
            TransformerBlock(n_head, hidden_drop=hidden_drop,
                             attn_drop=attn_drop, causal=not bidirectional,
                             activation=activation,
                             sequence_parallel=sequence_parallel,
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

    def _pipe_mesh(self):
        if not self.pipeline_parallel:
            return None
        return _armed_mesh(self.pipe_mesh_axis)

    def _call_pipelined(self, params, h, mesh, training, mask):
        """The blocks as GPipe stages over the mesh's pipe axis: stage i
        runs n_block / p consecutive blocks on pipe slot i; activations
        ride slot-to-slot copies, and gradients flow back through them
        (:func:`~analytics_zoo_tpu_torch.parallel.pipeline
        .pipeline_apply`)."""
        from analytics_zoo_tpu_torch.parallel.pipeline import (
            pipeline_apply,
            stack_stage_params,
        )

        p = mesh.shape[self.pipe_mesh_axis]
        n = len(self.blocks)
        if n % p != 0:
            raise ValueError(
                f"pipeline_parallel: n_block ({n}) must divide by the "
                f"'{self.pipe_mesh_axis}' mesh axis size ({p})")
        if mask is not None:
            raise NotImplementedError(
                "pipeline_parallel does not thread an attention mask "
                "through the stage ring; use causal attention")
        if training and (self.hidden_drop > 0 or self.attn_drop > 0):
            raise NotImplementedError(
                "pipeline_parallel cannot thread per-block dropout rngs "
                "through the stage ring — set hidden_drop/attn_drop to 0")
        if self.blocks[0].attn._sp_mesh() is not None:
            raise NotImplementedError(
                "pipeline_parallel + sequence_parallel on one mesh would "
                "nest shard_map inside shard_map — use one or the other "
                "(pp over layers, or sp over the sequence)")
        k = n // p
        template = self.blocks[0]
        # stage i holds blocks [i*k, (i+1)*k); all blocks share one
        # structure, so a stage's parameters are a k-list of block dicts
        stacked = stack_stage_params(
            [[params[self.blocks[i * k + j].name] for j in range(k)]
             for i in range(p)])

        def stage_fn(sp, t):
            for j in range(k):
                t = template.call(sp[j], t, training=training, rng=None)
            return t

        fn = stage_fn
        if training and self.remat:
            def fn(sp, t):
                return checkpoint(stage_fn, sp, t, use_reentrant=False)
        # GPipe's bubble is (S-1)/(M+S-1), so M >> S is the efficient
        # direction, but one-row microbatches starve the matmuls: target
        # M ~ 4*S without shrinking a microbatch below the data-sharded
        # rows; pipe_microbatches overrides
        b = h.shape[0]
        data_ax = "data" if ("data" in mesh.axis_names
                             and mesh.shape["data"] > 1) else None
        min_rows = mesh.shape[data_ax] if data_ax else 1
        want = self.pipe_microbatches or 4 * p
        m = 1
        for cand in range(min(want, b // min_rows or 1), 0, -1):
            if b % cand == 0 and (b // cand) % min_rows == 0:
                m = cand
                break
        return pipeline_apply(fn, stacked, h, mesh, n_microbatches=m,
                              pipe_axis=self.pipe_mesh_axis,
                              data_axis=data_ax)

    def call(self, params, x, training=False, rng=None, **kw):
        if isinstance(x, (list, tuple)):
            ids, mask = x[0], x[1]
        else:
            ids, mask = x, None
        h = (_embed(params["word_embed"], ids)
             + params["pos_embed"][None, :ids.shape[1]])
        h = _maybe_dropout(h, self.embedding_drop, training, rng)
        pipe_mesh = self._pipe_mesh()
        if pipe_mesh is not None:
            return self._call_pipelined(params, h, pipe_mesh, training, mask)
        return _run_blocks(self.blocks, params, h, training, rng, mask,
                           self.remat)


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
        self.remat = remat
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

    def call(self, params, x, training=False, rng=None, **kw):
        ids, type_ids, pos_ids, mask = x
        e = (_embed(params["word_embed"], ids)
             + _embed(params["type_embed"], type_ids)
             + _embed(params["pos_embed"], pos_ids))
        h = _layer_norm(e, params["embed_ln_gamma"], params["embed_ln_beta"],
                        1e-12)
        h = _maybe_dropout(h, self.hidden_drop, training, rng)
        return _run_blocks(self.blocks, params, h, training, rng, mask,
                           self.remat)

    def pooled(self, params, seq_output):
        """[CLS] pooler: first-token dense + tanh."""
        first = seq_output[:, 0]
        return torch.tanh(first @ params["pooler_kernel"]
                          + params["pooler_bias"])
