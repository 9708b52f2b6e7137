"""Seq2seq (port of ``analytics_zoo_tpu.models.seq2seq``): ref
models/seq2seq/Seq2seq.scala:50 (RNNEncoder/RNNDecoder with bridges,
greedy ``infer``:114 bounded by maxSeqLen), plus beam search.

The encoder and decoder are stacks of the recurrent layers' cells driven
through their ``run``/``step_once`` primitives; greedy decode embeds each
step's argmax and feeds it back, in a Python loop over the steps (the
JAX package's ``lax.scan``), with every token kept on the device.

The sequence tier (``serving/sequence.py``) splits greedy decode into
three pure functions: ``seq_init_carries`` (the decode slot array's zero
carries), ``seq_prefill`` (a masked encode of right-padded prompts to the
bridged decoder carries) and ``seq_step`` (one decode step over the slot
array). ``infer`` stays the single-request reference that the batcher's
token streams are held to.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.common.tree import tree_map
from analytics_zoo_tpu_torch.keras.engine.base import unique_name
from analytics_zoo_tpu_torch.keras.engine.topology import KerasNet
from analytics_zoo_tpu_torch.keras.layers import (
    GRU,
    LSTM,
    Dense,
    Embedding,
    SimpleRNN,
)
from analytics_zoo_tpu_torch.models.common import ZooModel

_CELLS = {"lstm": LSTM, "gru": GRU, "simplernn": SimpleRNN}

# the beam's "impossible" score, as in the JAX package
_NEG = -1e30


def _top_k(x, k: int):
    """``lax.top_k``: the k largest along the last dim, ties to the lower
    index (a stable descending sort)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class Seq2seqNet(KerasNet):
    """Encoder-decoder network implementing the engine's model protocol
    directly (the graph API has no state-passing edges; this does)."""

    def __init__(self, vocab_size: int, embed_dim: int,
                 hidden_sizes: Sequence[int], cell_type: str = "lstm",
                 bridge: str = "pass",
                 target_vocab_size: Optional[int] = None,
                 name: Optional[str] = None):
        super().__init__(name or unique_name("seq2seq"))
        self.vocab_size = vocab_size
        self.target_vocab_size = target_vocab_size or vocab_size
        self.embed_dim = embed_dim
        self.hidden_sizes = tuple(hidden_sizes)
        self.cell_type = cell_type.lower()
        if self.cell_type not in _CELLS:
            raise ValueError(f"cell_type must be one of {sorted(_CELLS)}")
        if bridge not in ("pass", "dense"):
            raise ValueError("bridge must be 'pass' or 'dense'")
        self.bridge = bridge

        cell = _CELLS[self.cell_type]
        self.src_embed = Embedding(vocab_size, embed_dim, name="src_embed")
        self.tgt_embed = Embedding(self.target_vocab_size, embed_dim,
                                   name="tgt_embed")
        self.encoder_cells = nn.ModuleList()
        self.decoder_cells = nn.ModuleList()
        d = embed_dim
        for i, h in enumerate(self.hidden_sizes):
            enc = cell(h, return_sequences=True, name=f"enc_{i}")
            enc.ensure_built((None, None, d))
            self.encoder_cells.append(enc)
            dec = cell(h, return_sequences=True, name=f"dec_{i}")
            dec.ensure_built((None, None, d))
            self.decoder_cells.append(dec)
            d = h
        self.bridge_layers = nn.ModuleList()
        if bridge == "dense":
            mult = 2 if self.cell_type == "lstm" else 1
            for i, h in enumerate(self.hidden_sizes):
                bl = Dense(h * mult, name=f"bridge_{i}")
                bl.ensure_built((None, h * mult))
                self.bridge_layers.append(bl)
        self.generator = Dense(self.target_vocab_size, name="generator")
        self.generator.ensure_built((None, self.hidden_sizes[-1]))
        self.src_embed.ensure_built((None, None))
        self.tgt_embed.ensure_built((None, None))

    def layers(self):
        return ([self.src_embed, self.tgt_embed] + list(self.encoder_cells)
                + list(self.decoder_cells) + list(self.bridge_layers)
                + [self.generator])

    def _bridge_carry(self, params, i, carry):
        if self.bridge == "pass":
            return carry
        bl = self.bridge_layers[i]
        p = params[bl.name]
        if self.cell_type == "lstm":
            h, c = carry
            u = h.shape[-1]
            out = bl.call(p, torch.cat([h, c], dim=-1))
            return out[:, :u], out[:, u:]
        return bl.call(p, carry)

    def encode(self, params, src_ids):
        """Run the encoder over source ids -> (outputs, final carries)."""
        x = self.src_embed.call(params[self.src_embed.name], src_ids)
        carries = []
        for cell in self.encoder_cells:
            x, carry = cell.run(params[cell.name], x)
            carries.append(carry)
        return x, carries

    def _bridged(self, params, carries):
        return [self._bridge_carry(params, i, c)
                for i, c in enumerate(carries)]

    def _decode_step(self, params, carries, tok):
        """Embed ``tok`` (batch,), advance every decoder cell, return
        (new carries, logits)."""
        y = self.tgt_embed.call(params[self.tgt_embed.name], tok)
        new_carries = []
        for i, cell in enumerate(self.decoder_cells):
            c_new, y = cell.step_once(params[cell.name], carries[i], y)
            new_carries.append(c_new)
        return new_carries, self.generator.call(
            params[self.generator.name], y)

    # -- sequence-serving primitives -------------------------------------

    def seq_init_carries(self, batch, device=None, dtype=torch.float32):
        """Zero decoder carries for ``batch`` rows — the decode slot
        array's initial (and post-restart) state."""
        return [cell.initial_carry(batch, device, dtype)
                for cell in self.decoder_cells]

    def seq_prefill(self, params, src_ids, mask):
        """Masked encode of right-padded prompts -> bridged decoder
        carries. ``mask`` (batch, len), 1.0 = real token: a masked step
        holds each row's carry, so a prompt padded out to its length
        bucket gives the carries of the unpadded encode."""
        x = self.src_embed.call(params[self.src_embed.name], src_ids)
        carries = []
        for cell in self.encoder_cells:
            x, carry = cell.run(params[cell.name], x, mask=mask)
            carries.append(carry)
        return self._bridged(params, carries)

    def seq_step(self, params, carries, tok):
        """One greedy decode step over a slot array: ``(new carries, next
        tokens (batch,) int32)`` — the body of :meth:`infer`'s loop."""
        new_carries, logits = self._decode_step(params, carries, tok)
        return new_carries, logits.argmax(dim=-1).to(torch.int32)

    # -- the model protocol ----------------------------------------------

    def apply(self, params, state, x, training=False, rng=None):
        """Teacher-forcing forward: x = (src_ids, tgt_ids) -> logits
        (batch, tgt_len, target_vocab)."""
        src_ids, tgt_ids = x
        _, carries = self.encode(params, src_ids)
        y = self.tgt_embed.call(params[self.tgt_embed.name], tgt_ids)
        for i, cell in enumerate(self.decoder_cells):
            carry0 = self._bridge_carry(params, i, carries[i])
            y, _ = cell.run(params[cell.name], y, carry0)
        logits = self.generator.call(params[self.generator.name], y)
        return logits, {}

    def infer(self, params, src_ids, start_token: int, max_seq_len: int = 30,
              stop_sign: Optional[int] = None):
        """Greedy decode (ref Seq2seq.infer:114) -> (batch, max_seq_len)
        int32 tokens; after the first ``stop_sign`` every token is
        ``stop_sign``."""
        batch = src_ids.shape[0]
        _, carries = self.encode(params, src_ids)
        carries = self._bridged(params, carries)
        tok = torch.full((batch,), start_token, dtype=torch.int32,
                         device=src_ids.device)
        toks = []
        for _ in range(max_seq_len):
            carries, tok = self.seq_step(params, carries, tok)
            toks.append(tok)
        out = torch.stack(toks, dim=1)
        if stop_sign is not None:
            hit = torch.cumsum((out == stop_sign).to(torch.int32), dim=1)
            out = torch.where(hit > 0, stop_sign, out).to(torch.int32)
        return out

    def infer_beam(self, params, src_ids, start_token: int, beam_size: int,
                   max_seq_len: int = 30, stop_sign: Optional[int] = None):
        """Beam-search decode: K beams per sample as rows. Returns (tokens
        (B, K, T), total log-probs (B, K)) in the last step's top-k order.
        Finished beams (emitted ``stop_sign``) extend only with
        ``stop_sign`` at zero added log-prob. When K exceeds the reachable
        candidates, "phantom" beams carry scores near -1e30."""
        B = src_ids.shape[0]
        K = int(beam_size)
        V = self.target_vocab_size
        dev = src_ids.device
        _, carries = self.encode(params, src_ids)
        carries = tree_map(lambda a: a.repeat_interleave(K, dim=0),
                           self._bridged(params, carries))
        tok = torch.full((B * K,), start_token, dtype=torch.int32,
                         device=dev)
        scores = torch.tensor([0.0] + [_NEG] * (K - 1), dtype=torch.float32,
                              device=dev).repeat(B, 1)
        finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
        frozen = None
        if stop_sign is not None:
            frozen = torch.full((V,), _NEG, dtype=torch.float32, device=dev)
            frozen[stop_sign] = 0.0
        base = (torch.arange(B, device=dev)[:, None] * K)
        parents, toks = [], []
        for _ in range(max_seq_len):
            carries, logits = self._decode_step(params, carries, tok)
            logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
            if frozen is not None:
                logp = torch.where(finished[..., None], frozen, logp)
            total = scores[..., None] + logp
            scores, top_idx = _top_k(total.reshape(B, K * V), K)
            parent = top_idx // V
            tok_next = (top_idx % V).to(torch.int32)
            gather = (base + parent).reshape(-1)
            carries = tree_map(lambda a: a[gather], carries)
            finished = torch.gather(finished, 1, parent)
            if stop_sign is not None:
                finished = finished | (tok_next == stop_sign)
            tok = tok_next.reshape(-1)
            parents.append(parent)
            toks.append(tok_next)
        # backtrack from the last step to the first
        beam_idx = torch.arange(K, device=dev).repeat(B, 1)
        rev = [None] * max_seq_len
        for t in range(max_seq_len - 1, -1, -1):
            rev[t] = torch.gather(toks[t], 1, beam_idx)
            beam_idx = torch.gather(parents[t], 1, beam_idx)
        return torch.stack(rev, dim=2), scores

    def infer_beam_with_scores(self, params, src_ids, start_token: int,
                               beam_size: int, max_seq_len: int = 30,
                               stop_sign: Optional[int] = None):
        """As :meth:`infer_beam`, sorted best-first (phantom beams
        last)."""
        seqs, scores = self.infer_beam(params, src_ids, start_token,
                                       int(beam_size), max_seq_len,
                                       stop_sign)
        order = torch.sort(-scores, dim=1, stable=True).indices
        seqs = torch.gather(seqs, 1, order[..., None].expand_as(seqs))
        return seqs, torch.gather(scores, 1, order)

    def score_sequences(self, params, src_ids, seqs, start_token: int,
                        stop_sign: Optional[int] = None):
        """Total log-prob of decoded sequences (B, K, T) under the model by
        teacher forcing; positions after the first ``stop_sign`` add
        zero."""
        B, K, T = seqs.shape
        flat = seqs.reshape(B * K, T).long()
        src_rep = src_ids.repeat_interleave(K, dim=0)
        inputs = torch.cat([torch.full((B * K, 1), start_token,
                                       dtype=flat.dtype, device=flat.device),
                            flat[:, :-1]], dim=1)
        logits, _ = self.apply(params, {}, (src_rep, inputs))
        logp = torch.log_softmax(logits.float(), dim=-1)
        tok_lp = logp.gather(-1, flat[..., None])[..., 0]
        if stop_sign is not None:
            is_stop = (flat == stop_sign).to(torch.int32)
            live = (torch.cumsum(is_stop, dim=1) - is_stop) == 0
            tok_lp = tok_lp * live.to(tok_lp.dtype)
        return tok_lp.sum(dim=-1).reshape(B, K)

    def get_output_shape(self):
        return (None, None, self.target_vocab_size)

    def get_input_shape(self):
        return [(None, None), (None, None)]


class RNNEncoder:
    """Encoder spec (ref RNNEncoder.scala):
    ``RNNEncoder.initialize(rnn_type, n_layers, hidden_size)``; composes
    into :class:`Seq2seq` via ``from_components``."""

    def __init__(self, rnn_type: str, n_layers: int, hidden_size: int):
        self.rnn_type = rnn_type.lower()
        self.n_layers = int(n_layers)
        self.hidden_size = int(hidden_size)

    @classmethod
    def initialize(cls, rnn_type: str, n_layers: int, hidden_size: int):
        """Reference-style factory."""
        return cls(rnn_type, n_layers, hidden_size)


class RNNDecoder(RNNEncoder):
    """Decoder spec (ref RNNDecoder.scala) — the same shape as the
    encoder's."""


class Bridge:
    """Bridge spec between encoder and decoder states (ref Bridge.scala):
    ``Bridge.initialize("dense"|"pass")``."""

    def __init__(self, bridge_type: str = "pass"):
        if bridge_type not in ("pass", "dense"):
            raise ValueError("bridge_type must be 'pass' or 'dense'")
        self.bridge_type = bridge_type

    @classmethod
    def initialize(cls, bridge_type: str = "pass",
                   bridge_hidden_size: int = None):
        """Reference-style factory. The dense bridge maps the encoder
        state onto the decoder's own state size; a custom
        ``bridge_hidden_size`` raises rather than building another
        model."""
        if bridge_hidden_size is not None:
            raise ValueError(
                "custom bridge_hidden_size is unsupported: the dense bridge "
                "maps encoder state to the decoder's own state size")
        return cls(bridge_type)


class Seq2seq(ZooModel):
    """Ref Seq2seq.scala:50 — the user-facing wrapper. ``fit`` takes
    ``x=[src_ids, tgt_in_ids]`` (teacher forcing), ``y=tgt_out_ids``."""

    def __init__(self, vocab_size: int, embed_dim: int = 64,
                 hidden_sizes: Sequence[int] = (64,),
                 cell_type: str = "lstm", bridge: str = "pass",
                 target_vocab_size: Optional[int] = None):
        super().__init__()
        self._cfg = dict(vocab_size=vocab_size, embed_dim=embed_dim,
                         hidden_sizes=list(hidden_sizes), cell_type=cell_type,
                         bridge=bridge, target_vocab_size=target_vocab_size)
        self.model = self.build_model()

    @classmethod
    def from_components(cls, encoder: RNNEncoder, decoder: RNNDecoder,
                        vocab_size: int, embed_dim: int = 64,
                        bridge: Optional[Bridge] = None,
                        target_vocab_size: int = None) -> "Seq2seq":
        """Reference-style composition; encoder and decoder must agree on
        cell type and depth."""
        if (encoder.rnn_type != decoder.rnn_type
                or encoder.n_layers != decoder.n_layers
                or encoder.hidden_size != decoder.hidden_size):
            raise ValueError("encoder and decoder specs must match "
                             "(cell type, layers, hidden size)")
        if bridge is None:
            bridge_type = "pass"
        elif isinstance(bridge, Bridge):
            bridge_type = bridge.bridge_type
        else:
            bridge_type = str(bridge)
        return cls(vocab_size=vocab_size, embed_dim=embed_dim,
                   hidden_sizes=[encoder.hidden_size] * encoder.n_layers,
                   cell_type=encoder.rnn_type, bridge=bridge_type,
                   target_vocab_size=target_vocab_size)

    def build_model(self):
        return Seq2seqNet(**self._cfg)

    def config(self):
        return dict(self._cfg)

    def _params_and_src(self, src_ids):
        est = self.model._get_estimator()
        est._ensure_state()
        return est.tstate.params, torch.as_tensor(
            np.asarray(src_ids, np.int32), device=est.ctx.device)

    def infer(self, src_ids: np.ndarray, start_token: int,
              max_seq_len: int = 30, stop_sign: Optional[int] = None,
              beam_size: int = 1) -> np.ndarray:
        """Greedy decode (ref Seq2seq.infer:114), or with ``beam_size >
        1`` the best beam per sample; :meth:`infer_beams` gives every
        beam with its score."""
        if beam_size > 1:
            seqs, _ = self.infer_beams(src_ids, start_token, beam_size,
                                       max_seq_len, stop_sign)
            return seqs[:, 0]
        params, src = self._params_and_src(src_ids)
        with torch.inference_mode():
            out = self.model.infer(params, src, start_token, max_seq_len,
                                   stop_sign)
        return out.cpu().numpy()

    def infer_beams(self, src_ids: np.ndarray, start_token: int,
                    beam_size: int, max_seq_len: int = 30,
                    stop_sign: Optional[int] = None):
        """Every beam, best first: (tokens (B, K, T), total log-probs
        (B, K))."""
        params, src = self._params_and_src(src_ids)
        with torch.inference_mode():
            seqs, scores = self.model.infer_beam_with_scores(
                params, src, start_token, beam_size, max_seq_len, stop_sign)
        return seqs.cpu().numpy(), scores.cpu().numpy()


__all__: List[str] = ["Seq2seqNet", "Seq2seq", "RNNEncoder", "RNNDecoder",
                      "Bridge"]
