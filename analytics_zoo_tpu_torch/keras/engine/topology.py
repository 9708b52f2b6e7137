"""Model protocol (port of ``KerasNet`` in
``analytics_zoo_tpu.keras.engine.topology``).

Only the protocol the serving path needs: ``layers``, ``init``, ``apply``
and ``compute_dtype``. ``compile``/``fit`` and ``Sequential``/``Model`` come
with the training slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from analytics_zoo_tpu_torch.keras.engine.base import (
    KerasLayer,
    Shape,
    materialize,
    unique_name,
)


class KerasNet(nn.Module):
    """The model protocol InferenceModel serves.

    ``params`` holds the model's parameter dict once it has one: drawn by
    :meth:`ensure_params` from the context's generator, or carried over from
    the JAX package by ``interop.load_jax_params``.
    """

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name or unique_name(type(self).__name__.lower())
        # "bfloat16": InferenceModel casts float32 params and inputs to it
        # for the forward, and returns float outputs as float32.
        self.compute_dtype: Optional[str] = None
        self.params: Optional[Dict] = None
        self.model_state: Optional[Dict] = None

    def layers(self) -> List[KerasLayer]:
        """The layer objects, flattened in graph order."""
        raise NotImplementedError

    def param_specs(self) -> Dict:
        """``{layer name: layer.param_specs()}`` for layers with params."""
        out = {}
        for layer in self.layers():
            specs = layer.param_specs()
            if specs:
                out[layer.name] = specs
        return out

    def init(self, generator: torch.Generator) -> Tuple[Dict, Dict]:
        """Initialize ``(params, state)`` from a generator."""
        return materialize(self.param_specs(), generator), {}

    def ensure_params(self) -> None:
        """Draw ``params`` from the context's root generator if the model
        has none yet."""
        if self.params is None:
            from analytics_zoo_tpu_torch.common.nncontext import get_nncontext

            self.params, self.model_state = self.init(
                get_nncontext().generator)

    def apply(self, params, state, x, training=False, rng=None):
        """Forward: ``(params, state, x) -> (pred, new_state)``."""
        raise NotImplementedError

    def get_output_shape(self) -> Shape:
        """Batch-free output shape."""
        raise NotImplementedError

    def get_input_shape(self):
        """Batch-free input shape."""
        raise NotImplementedError
