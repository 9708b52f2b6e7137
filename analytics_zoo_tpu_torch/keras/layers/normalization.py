"""Normalization layers (port of
``analytics_zoo_tpu.keras.layers.normalization``: ``BatchNormalization``,
``LayerNorm`` and ``WithinChannelLRN2D``).

``BatchNormalization`` keeps Keras-1's conventions, which are not
``nn.BatchNorm2d``'s: epsilon 1e-3, ``momentum`` the retain factor of the
moving averages (0.99: ``m * old + (1 - m) * batch``), biased variance.
The moving mean and variance are f32 state, returned from ``call`` and
threaded by the engine. Training normalizes with the batch statistics over
the whole batch the call sees (``ops.batch_norm``); evaluation with the
moving statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.keras.engine.base import KerasLayer, Shape
from analytics_zoo_tpu_torch.ops.batch_norm import batch_norm_train


class BatchNormalization(KerasLayer):
    """Batch normalization over the feature axis (1 for "th" and 2-D
    inputs, the last for "tf")."""
    has_state = True

    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 beta_init="zeros", gamma_init="ones", dim_ordering="th",
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.epsilon = epsilon
        self.momentum = momentum
        self.beta_init = beta_init
        self.gamma_init = gamma_init
        self.dim_ordering = dim_ordering

    def _feature_axis(self, ndim: int) -> int:
        if ndim == 2:
            return 1
        return 1 if self.dim_ordering == "th" else ndim - 1

    def build(self, input_shape: Shape):
        n = input_shape[self._feature_axis(len(input_shape))]
        self.add_weight("gamma", (n,), self.gamma_init)
        self.add_weight("beta", (n,), self.beta_init)
        self.add_state("moving_mean", (n,), "zeros")
        self.add_state("moving_var", (n,), "ones")

    def call(self, params, x, state=None, training=False, **kw):
        state = state or self.init_state()
        ax = self._feature_axis(x.dim())
        if training:
            axes = tuple(i for i in range(x.dim()) if i != ax)
            y, mean, var = batch_norm_train(x, params["gamma"],
                                            params["beta"], axes,
                                            self.epsilon)
            m = self.momentum
            with torch.no_grad():
                new_state = {
                    "moving_mean": m * state["moving_mean"] + (1 - m) * mean,
                    "moving_var": m * state["moving_var"] + (1 - m) * var,
                }
            return y, new_state
        bshape = [1] * x.dim()
        bshape[ax] = -1
        gamma = params["gamma"].float()
        inv = torch.reciprocal(torch.sqrt(state["moving_var"]
                                          + self.epsilon))
        scale = (gamma * inv).to(x.dtype)
        shift = (params["beta"].float()
                 - state["moving_mean"] * gamma * inv).to(x.dtype)
        return x * scale.reshape(bshape) + shift.reshape(bshape), state


class LayerNorm(KerasLayer):
    """Last-dim layer norm, in the input's dtype."""

    def __init__(self, epsilon: float = 1e-5, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.epsilon = epsilon

    def build(self, input_shape: Shape):
        n = input_shape[-1]
        self.add_weight("gamma", (n,), "ones")
        self.add_weight("beta", (n,), "zeros")

    def call(self, params, x, **kw):
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, unbiased=False, keepdim=True)
        y = (x - mean) * torch.reciprocal(torch.sqrt(var + self.epsilon))
        return y * params["gamma"] + params["beta"]


class WithinChannelLRN2D(KerasLayer):
    """Local response normalisation within each channel of NCHW input:
    ``x / (1 + alpha * S / size^2) ** beta`` with ``S`` the sum of x^2
    over a size x size window, SAME (``(size - 1) // 2`` rows and columns
    before, the rest after), as the JAX layer's ``reduce_window``."""

    def __init__(self, size: int = 5, alpha: float = 1.0,
                 beta: float = 0.75, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.size, self.alpha, self.beta = size, alpha, beta

    def call(self, params, x, **kw):
        lo = (self.size - 1) // 2
        hi = self.size - 1 - lo
        sq = F.pad(torch.square(x), (lo, hi, lo, hi))
        summed = F.avg_pool2d(sq, self.size, stride=1, divisor_override=1)
        norm = (1.0 + self.alpha * summed / (self.size * self.size)
                ) ** self.beta
        return x / norm
