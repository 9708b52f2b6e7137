"""Keras-2-style API (port of ``analytics_zoo_tpu.keras2``): the
Keras-2 layer signatures over the Keras-1 layers, with ``Sequential``,
``Model`` and ``Input`` from the keras engine."""

from analytics_zoo_tpu_torch.keras.engine.topology import (
    Input,
    Model,
    Sequential,
)
from analytics_zoo_tpu_torch.keras2 import layers
from analytics_zoo_tpu_torch.keras2.layers import *  # noqa: F401,F403

__all__ = ["Input", "Model", "Sequential", "layers"] + list(layers.__all__)
