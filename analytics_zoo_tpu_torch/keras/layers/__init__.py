"""Layer library: the layers of the serving slice."""

from analytics_zoo_tpu_torch.keras.engine.base import KerasLayer
from analytics_zoo_tpu_torch.keras.layers.attention import (
    BERT,
    MultiHeadAttention,
    TransformerBlock,
    TransformerLayer,
)
from analytics_zoo_tpu_torch.keras.layers.core import Dense, get_activation
