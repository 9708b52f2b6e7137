"""Core layers (port of ``analytics_zoo_tpu.keras.layers.core``): the
activation table and ``Dense``."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.keras.engine.base import KerasLayer, Shape

_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": F.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    # jax.nn.gelu defaults to the tanh approximation; torch's default is
    # the exact erf form
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def get_activation(act) -> Callable:
    """Resolve an activation spec (name or callable) to the function;
    raises with the known-name list on a typo."""
    if act is None:
        return lambda x: x
    if callable(act):
        return act
    try:
        return _ACTIVATIONS[act]
    except KeyError:
        raise ValueError(
            f"Unknown activation '{act}'. Known: {sorted(_ACTIVATIONS)}"
        ) from None


class Dense(KerasLayer):
    """Fully connected over the last dim: ``x @ kernel + bias`` with the
    kernel in the JAX package's ``(in, out)`` layout."""

    def __init__(self, output_dim: int, init="glorot_uniform",
                 activation=None, bias=True, input_dim=None,
                 input_shape=None, name=None):
        if input_dim is not None and input_shape is None:
            input_shape = (input_dim,)
        super().__init__(input_shape, name)
        self.output_dim = int(output_dim)
        self.init = init
        self.activation = get_activation(activation)
        self.bias = bias

    def build(self, input_shape: Shape):
        self.add_weight("kernel", (input_shape[-1], self.output_dim),
                        self.init)
        if self.bias:
            self.add_weight("bias", (self.output_dim,), "zeros")

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return tuple(input_shape[:-1]) + (self.output_dim,)

    def call(self, params, x, **kw):
        y = x @ params["kernel"]
        if self.bias:
            y = y + params["bias"]
        return self.activation(y)
