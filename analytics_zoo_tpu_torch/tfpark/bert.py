"""BERT classifier (port of ``analytics_zoo_tpu.tfpark.bert``): the BERT
encoder with a dense softmax head on the pooled [CLS] output. Inputs:
input_ids, token_type_ids, input_mask (position ids are made here)."""

from __future__ import annotations

from typing import Optional

import torch

from analytics_zoo_tpu_torch.keras.engine.base import unique_name
from analytics_zoo_tpu_torch.keras.engine.topology import KerasNet
from analytics_zoo_tpu_torch.keras.layers import BERT, Dense


class BERTClassifierNet(KerasNet):
    """BERT encoder + pooled softmax head (model-protocol object)."""

    def __init__(self, num_classes: int, vocab: int = 30522,
                 hidden_size: int = 768, n_block: int = 12, n_head: int = 12,
                 seq_len: int = 128, intermediate_size: int = 3072,
                 hidden_drop: float = 0.1, attn_drop: float = 0.1,
                 remat: bool = False, name: Optional[str] = None):
        super().__init__(name or unique_name("bert_classifier"))
        self.num_classes = num_classes
        self.seq_len = seq_len
        self.bert = BERT(vocab=vocab, hidden_size=hidden_size,
                         n_block=n_block, n_head=n_head, seq_len=seq_len,
                         intermediate_size=intermediate_size,
                         hidden_drop=hidden_drop, attn_drop=attn_drop,
                         remat=remat, name=self.name + "_bert")
        self.bert.ensure_built([(None, seq_len)] * 4)
        self.head = Dense(num_classes, name=self.name + "_head")
        self.head.ensure_built((None, hidden_size))
        self.compute_dtype = "bfloat16"

    def layers(self):
        return [self.bert, self.head]

    def apply(self, params, state, x, training=False, rng=None):
        """x: [input_ids, token_type_ids, input_mask] (position ids auto);
        ``rng``: the ``torch.Generator`` of the training draws (dropout)."""
        ids, type_ids, mask = x
        pos = torch.arange(ids.shape[1], device=ids.device).expand(ids.shape)
        seq = self.bert.call(params[self.bert.name],
                             [ids, type_ids, pos, mask], training=training,
                             rng=rng)
        pooled = self.bert.pooled(params[self.bert.name], seq)
        logits = self.head.call(params[self.head.name], pooled)
        return torch.softmax(logits.float(), dim=-1), {}

    def get_output_shape(self):
        return (None, self.num_classes)

    def get_input_shape(self):
        return [(None, self.seq_len)] * 3
