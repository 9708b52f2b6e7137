"""tfpark text models (port of ``analytics_zoo_tpu.tfpark.text``; ref
pyzoo/zoo/tfpark/text/keras/{text_model,ner,pos_tagging,
intent_extraction}.py).

The architectures of nlp-architect's NERCRF, chunker SequenceTagger and
MultiTaskIntentModel, built layer for layer as in the JAX package (word
and char Bi-LSTM encoders, softmax or CRF heads) with the same layer names,
so ``interop.load_jax_params`` carries the JAX weights over leaf by leaf.

Shapes follow the reference docstrings:

- NER:            in (words (B,S), chars (B,S,W)[, seq_len (B,1)]) ->
  the CRF packed tensor (B, S+E, E[+1]);
- SequenceTagger: in words (B,S) [+ chars] -> (pos (B,S,P), chunk (B,S,C));
- IntentEntity:   in (words, chars) -> (intent (B,I), tags (B,S,E)).

``IntentEntity.default_loss`` is the JAX package's: cross-entropy on both
heads (its docstring there says the entity term is a CRF NLL, but the
entity head is a softmax and the loss a cross-entropy).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.autograd.variable import apply_layer
from analytics_zoo_tpu_torch.keras.engine.base import Lambda, unique_name
from analytics_zoo_tpu_torch.keras.engine.topology import Input, Model
from analytics_zoo_tpu_torch.keras.layers import (
    LSTM,
    Bidirectional,
    Dense,
    Dropout,
    Embedding,
    Merge,
)
from analytics_zoo_tpu_torch.keras.layers.crf import CRF, crf_decode, crf_nll
from analytics_zoo_tpu_torch.keras.objectives import (
    sparse_categorical_crossentropy as _ce,
)


def _char_encoder(chars, seq_len: int, word_len: int, char_vocab: int,
                  char_emb: int, lstm_dim: int, prefix: str):
    """Per-word character Bi-LSTM: (B, S, W) int -> (B, S, 2*lstm_dim).

    Words are flattened into the batch dim, so one shared Bi-LSTM runs
    over the characters of every word at once (B*S rows, W steps)."""
    flat = apply_layer(Lambda(
        lambda x: x.reshape((-1, word_len)),
        output_shape_fn=lambda s: (None, word_len),
        name=unique_name(f"{prefix}_flatten")), chars)
    emb = Embedding(char_vocab, char_emb, name=f"{prefix}_char_emb")(flat)
    enc = Bidirectional(LSTM(lstm_dim, return_sequences=False),
                        merge_mode="concat", name=f"{prefix}_char_lstm")(emb)
    return apply_layer(Lambda(
        lambda x: x.reshape((-1, seq_len, 2 * lstm_dim)),
        output_shape_fn=lambda s: (None, seq_len, 2 * lstm_dim),
        name=unique_name(f"{prefix}_unflatten")), enc)


def _concat(vars_, name):
    return Merge(mode="concat", concat_axis=-1, name=name)(list(vars_))


def _step_mask(sequence_length: int):
    """(B, 1) sequence lengths -> (B, S) float32 step mask, made on the
    lengths' device."""

    def fn(ln):
        steps = torch.arange(sequence_length, device=ln.device)
        return (steps[None, :] < ln.reshape((-1, 1))).float()

    return fn


class TextKerasModel:
    """Base wrapper (ref text_model.py:21): holds the built Model,
    delegates the training surface, and saves as config JSON + weights
    (the reference uses nlp-architect's parameter-dict save for the same
    reason: its CRF layer cannot round-trip through keras load_model)."""

    def __init__(self, model: Model, config: dict):
        self.model = model
        self._config = dict(config)

    def compile(self, *a, **kw):
        """Set optimizer/loss/metrics (default loss: ``default_loss()``)."""
        self.model.compile(*a, **kw)
        return self

    def fit(self, *a, **kw):
        """Train on arrays or a feature set (ref TextKerasModel.fit)."""
        self.model.fit(*a, **kw)
        return self

    def evaluate(self, *a, **kw):
        """Loss/metrics over a dataset (ref TextKerasModel.evaluate)."""
        return self.model.evaluate(*a, **kw)

    def predict(self, *a, **kw):
        """Forward pass; host ndarrays (ref TextKerasModel.predict)."""
        return self.model.predict(*a, **kw)

    def save_model(self, path: str):
        """``path/model.json`` (class and config) and ``path/weights``
        (ref save_model)."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "model.json"), "w") as f:
            json.dump({"class": type(self).__name__,
                       "config": self._config}, f)
        self.model.save_weights(os.path.join(path, "weights"))

    @classmethod
    def load_model(cls, path: str) -> "TextKerasModel":
        """Rebuild a saved text model and load its weights (ref
        load_model); reads what the JAX package's ``save_model`` wrote
        too."""
        with open(os.path.join(path, "model.json")) as f:
            meta = json.load(f)
        klasses = {c.__name__: c for c in (NER, SequenceTagger,
                                           IntentEntity)}
        inst = klasses[meta["class"]](**meta["config"])
        inst.model.load_weights(os.path.join(path, "weights"))
        return inst


def _decode_on_context(packed, num_tags: int, mask=None) -> np.ndarray:
    """Viterbi over a host packed output, on the context's device."""
    from analytics_zoo_tpu_torch.common.nncontext import get_nncontext

    dev = get_nncontext().device
    tags = crf_decode(torch.as_tensor(packed, device=dev), num_tags,
                      None if mask is None else torch.as_tensor(
                          np.asarray(mask), device=dev))
    return tags.cpu().numpy()


class NER(TextKerasModel):
    """Bi-LSTM + CRF named-entity tagger (ref ner.py:21-60; the
    architecture of nlp-architect's NERCRF: word embedding ++ char Bi-LSTM
    -> 2x Bi-LSTM tagger -> dense -> CRF).

    ``crf_mode`` follows the reference (ner.py:40-43): 'reg' treats every
    step as real; 'pad' adds a third input, the sequence lengths (B, 1),
    and masks padded steps out of both the CRF loss and Viterbi decoding
    (the mask is made on the device from the lengths).

    ``predict`` returns the CRF packed tensor; :meth:`predict_tags` the
    decoded entity indices (B, S). ``default_loss`` is the exact CRF NLL.
    """

    def __init__(self, num_entities: int, word_vocab_size: int,
                 char_vocab_size: int, sequence_length: int = 30,
                 word_length: int = 12, word_emb_dim: int = 100,
                 char_emb_dim: int = 30, tagger_lstm_dim: int = 100,
                 dropout: float = 0.5, crf_mode: str = "reg"):
        if crf_mode not in ("reg", "pad"):
            raise ValueError("crf_mode must be 'reg' or 'pad'")
        self.num_entities = int(num_entities)
        words = Input(shape=(sequence_length,), name="words")
        chars = Input(shape=(sequence_length, word_length), name="chars")
        w = Embedding(word_vocab_size, word_emb_dim, name="word_emb")(words)
        c = _char_encoder(chars, sequence_length, word_length,
                          char_vocab_size, char_emb_dim, char_emb_dim, "ner")
        h = _concat([w, c], "ner_concat")
        h = Dropout(dropout)(h)
        h = Bidirectional(LSTM(tagger_lstm_dim, return_sequences=True),
                          merge_mode="concat", name="tagger_lstm1")(h)
        h = Bidirectional(LSTM(tagger_lstm_dim, return_sequences=True),
                          merge_mode="concat", name="tagger_lstm2")(h)
        h = Dropout(dropout)(h)
        h = Dense(num_entities, name="emissions")(h)
        inputs = [words, chars]
        if crf_mode == "pad":
            seq_len = Input(shape=(1,), name="seq_len")
            inputs.append(seq_len)
            step_mask = apply_layer(Lambda(
                _step_mask(sequence_length),
                output_shape_fn=lambda s: (None, sequence_length),
                name=unique_name("ner_mask")), seq_len)
            out = CRF(num_entities, use_mask=True, name="crf")([h, step_mask])
        else:
            out = CRF(num_entities, name="crf")(h)
        super().__init__(Model(inputs, out, name="ner"),
                         dict(num_entities=num_entities,
                              word_vocab_size=word_vocab_size,
                              char_vocab_size=char_vocab_size,
                              sequence_length=sequence_length,
                              word_length=word_length,
                              word_emb_dim=word_emb_dim,
                              char_emb_dim=char_emb_dim,
                              tagger_lstm_dim=tagger_lstm_dim,
                              dropout=dropout, crf_mode=crf_mode))

    def default_loss(self):
        """CRF negative log-likelihood over entity tags."""
        return crf_nll(self.num_entities)

    def predict_tags(self, x, batch_size: int = 32,
                     mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Viterbi-decoded entity tag ids per token (B, S)."""
        packed = self.model.predict(x, batch_size=batch_size)
        return _decode_on_context(packed, self.num_entities, mask)


class SequenceTagger(TextKerasModel):
    """Joint POS + chunk tagger (ref pos_tagging.py:21-66): a shared
    Bi-LSTM stack and two heads, softmax or (for the chunks) CRF. ``fit``
    takes y = [pos_tags, chunk_tags]; ``default_loss`` sums the POS
    cross-entropy and the chunk cross-entropy or CRF NLL."""

    def __init__(self, num_pos_labels: int, num_chunk_labels: int,
                 word_vocab_size: int, char_vocab_size: Optional[int] = None,
                 sequence_length: int = 30, word_length: int = 12,
                 feature_size: int = 100, dropout: float = 0.2,
                 classifier: str = "softmax"):
        classifier = classifier.lower()
        if classifier not in ("softmax", "crf"):
            raise ValueError("classifier should be either softmax or crf")
        self.num_pos_labels = int(num_pos_labels)
        self.num_chunk_labels = int(num_chunk_labels)
        self.classifier = classifier
        words = Input(shape=(sequence_length,), name="words")
        inputs = [words]
        feats = Embedding(word_vocab_size, feature_size,
                          name="word_emb")(words)
        if char_vocab_size is not None:
            chars = Input(shape=(sequence_length, word_length), name="chars")
            inputs.append(chars)
            c = _char_encoder(chars, sequence_length, word_length,
                              char_vocab_size, feature_size // 2,
                              feature_size // 2, "st")
            feats = _concat([feats, c], "st_concat")
        h = feats
        for i in range(3):
            h = Bidirectional(LSTM(feature_size, return_sequences=True),
                              merge_mode="concat", name=f"st_lstm{i + 1}")(h)
        h = Dropout(dropout)(h)
        pos = Dense(num_pos_labels, activation="softmax", name="pos")(h)
        if classifier == "crf":
            chunk_em = Dense(num_chunk_labels, name="chunk_emissions")(h)
            chunk = CRF(num_chunk_labels, name="chunk_crf")(chunk_em)
        else:
            chunk = Dense(num_chunk_labels, activation="softmax",
                          name="chunk")(h)
        super().__init__(
            Model(inputs if len(inputs) > 1 else words, [pos, chunk],
                  name="sequence_tagger"),
            dict(num_pos_labels=num_pos_labels,
                 num_chunk_labels=num_chunk_labels,
                 word_vocab_size=word_vocab_size,
                 char_vocab_size=char_vocab_size,
                 sequence_length=sequence_length, word_length=word_length,
                 feature_size=feature_size, dropout=dropout,
                 classifier=classifier))

    def default_loss(self):
        """POS cross-entropy + chunk cross-entropy (softmax head) or CRF
        negative log-likelihood (CRF head)."""
        crf_loss = crf_nll(self.num_chunk_labels)
        use_crf = self.classifier == "crf"

        def loss(y_true, y_pred):
            y_pos, y_chunk = y_true
            p_pos, p_chunk = y_pred
            chunk_term = (crf_loss(y_chunk, p_chunk) if use_crf
                          else _ce(y_chunk, p_chunk))
            return _ce(y_pos, p_pos) + chunk_term

        return loss

    def predict_chunk_tags(self, x, batch_size: int = 32) -> np.ndarray:
        """Chunk tag ids per token (B, S): Viterbi-decoded (CRF head) or
        the argmax (softmax head)."""
        _, chunk = self.model.predict(x, batch_size=batch_size)
        if self.classifier == "crf":
            return _decode_on_context(chunk, self.num_chunk_labels)
        return np.argmax(chunk, axis=-1)


# The reference exposes the POS model under both names
POSTagger = SequenceTagger


class IntentEntity(TextKerasModel):
    """Joint intent classification + slot filling (ref
    intent_extraction.py:21-74; nlp-architect's MultiTaskIntentModel): a
    char Bi-LSTM and word embeddings, a shared tagger Bi-LSTM; the intent
    head summarises the sequence, the entity head tags every step."""

    def __init__(self, num_intents: int, num_entities: int,
                 word_vocab_size: int, char_vocab_size: int,
                 sequence_length: int = 30, word_length: int = 12,
                 word_emb_dim: int = 100, char_emb_dim: int = 30,
                 char_lstm_dim: int = 30, tagger_lstm_dim: int = 100,
                 dropout: float = 0.2):
        self.num_intents = int(num_intents)
        self.num_entities = int(num_entities)
        words = Input(shape=(sequence_length,), name="words")
        chars = Input(shape=(sequence_length, word_length), name="chars")
        w = Embedding(word_vocab_size, word_emb_dim, name="word_emb")(words)
        c = _char_encoder(chars, sequence_length, word_length,
                          char_vocab_size, char_emb_dim, char_lstm_dim, "ie")
        h = _concat([w, c], "ie_concat")
        h = Dropout(dropout)(h)
        shared = Bidirectional(LSTM(tagger_lstm_dim, return_sequences=True),
                               merge_mode="concat",
                               name="ie_shared_lstm")(h)
        # intent: the last-step summary of a second LSTM over the shared
        # features
        intent_feat = Bidirectional(LSTM(tagger_lstm_dim,
                                         return_sequences=False),
                                    merge_mode="concat",
                                    name="ie_intent_lstm")(shared)
        intent = Dense(num_intents, activation="softmax",
                       name="intent")(Dropout(dropout)(intent_feat))
        tags = Dense(num_entities, activation="softmax",
                     name="tags")(Dropout(dropout)(shared))
        super().__init__(
            Model([words, chars], [intent, tags], name="intent_entity"),
            dict(num_intents=num_intents, num_entities=num_entities,
                 word_vocab_size=word_vocab_size,
                 char_vocab_size=char_vocab_size,
                 sequence_length=sequence_length, word_length=word_length,
                 word_emb_dim=word_emb_dim, char_emb_dim=char_emb_dim,
                 char_lstm_dim=char_lstm_dim,
                 tagger_lstm_dim=tagger_lstm_dim, dropout=dropout))

    def default_loss(self):
        """Joint loss, as the JAX package computes it: intent
        cross-entropy + entity cross-entropy."""

        def loss(y_true, y_pred):
            y_intent, y_tags = y_true
            p_intent, p_tags = y_pred
            return _ce(y_intent, p_intent) + _ce(y_tags, p_tags)

        return loss
