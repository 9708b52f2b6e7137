"""Core layers (port of ``analytics_zoo_tpu.keras.layers.core``): the
activation table, ``Activation``, ``Dense``, ``Dropout``, ``Flatten``,
``Reshape`` and ``Merge``/``merge``."""

from __future__ import annotations

import math
from typing import Callable, List, Sequence

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.keras.engine.base import KerasLayer, Shape
from analytics_zoo_tpu_torch.ops.attention import dropout


def hard_sigmoid(x):
    """Keras hard_sigmoid: clip(0.2*x + 0.5, 0, 1)."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": F.relu,
    "relu6": F.relu6,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": hard_sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
    "softplus": F.softplus,
    "softsign": F.softsign,
    "elu": F.elu,
    "selu": F.selu,
    # jax.nn.gelu defaults to the tanh approximation; torch's default is
    # the exact erf form
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "silu": F.silu,
    "exp": torch.exp,
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


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with the operands promoted to one dtype first, as
    ``jnp.matmul`` promotes them: a float32 operand times a bf16 one runs
    in float32 (torch's matmul takes one dtype)."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a @ b


class Activation(KerasLayer):
    """An activation from the table (or a callable) as a layer."""

    def __init__(self, activation, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.activation_name = activation
        self.activation = get_activation(activation)

    def call(self, params, x, **kw):
        return self.activation(x)


class Dense(KerasLayer):
    """Fully connected over the last dim: ``x @ kernel + bias`` with the
    kernel in the JAX package's ``(in, out)`` layout; operands of two
    dtypes are promoted first (:func:`matmul`)."""

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
        y = matmul(x, params["kernel"])
        if self.bias:
            y = y + params["bias"]
        return self.activation(y)


class Dropout(KerasLayer):
    """Inverted dropout in training, drawn from the generator passed as
    ``rng`` (the context's step generator); the identity otherwise."""

    def __init__(self, p: float, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.p = float(p)

    def call(self, params, x, training=False, rng=None, **kw):
        if not training or self.p <= 0.0 or rng is None:
            return x
        return dropout(x, self.p, rng)


class Flatten(KerasLayer):
    """Collapse every dim but the batch into one (in the layout the tensor
    has: NHWC for "tf" ordering)."""

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return (input_shape[0], math.prod(input_shape[1:]))

    def call(self, params, x, **kw):
        return x.reshape(x.shape[0], -1)


class Reshape(KerasLayer):
    """Ref keras/layers/Reshape.scala: ``target_shape`` excludes the batch;
    one dim may be -1 (inferred). It reshapes the logical tensor in its
    own layout (NHWC for "tf" ordering), row-major, so SSD's heads flatten
    (B, f, f, k * 4) into (B, f * f * k, 4) in (row, column, box) order."""

    def __init__(self, target_shape: Sequence[int], input_shape=None,
                 name=None):
        super().__init__(input_shape, name)
        self.target_shape = tuple(int(d) for d in target_shape)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        tgt = list(self.target_shape)
        if -1 in tgt:
            known = math.prod(d for d in tgt if d != -1)
            tgt[tgt.index(-1)] = math.prod(input_shape[1:]) // known
        return (input_shape[0],) + tuple(tgt)

    def call(self, params, x, **kw):
        return x.reshape((x.shape[0],) + self.compute_output_shape(
            (None,) + tuple(x.shape[1:]))[1:])


class Merge(KerasLayer):
    """Multi-input merge: sum, mul, max, min, ave, concat, dot or cosine."""

    def __init__(self, mode: str = "sum", concat_axis: int = -1,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.mode = mode
        self.concat_axis = concat_axis

    def compute_output_shape(self, input_shape) -> Shape:
        shapes: List[Shape] = list(input_shape)
        if self.mode == "concat":
            ax = (self.concat_axis if self.concat_axis >= 0
                  else len(shapes[0]) + self.concat_axis)
            out = list(shapes[0])
            out[ax] = sum(s[ax] for s in shapes)
            return tuple(out)
        if self.mode in ("dot", "cosine"):
            return (shapes[0][0], 1)
        return tuple(shapes[0])

    def call(self, params, xs, **kw):
        if self.mode in _FOLDS:
            out = xs[0]
            for x in xs[1:]:
                out = _FOLDS[self.mode](out, x)
            return out
        if self.mode == "ave":
            return sum(xs) / len(xs)
        if self.mode == "concat":
            return torch.cat(xs, dim=self.concat_axis)
        if self.mode in ("dot", "cosine"):
            a, b = xs
            if self.mode == "cosine":
                a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True)
                         + 1e-12)
                b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True)
                         + 1e-12)
            return torch.sum(a * b, dim=-1, keepdim=True)
        raise ValueError(f"Unknown merge mode {self.mode}")


_FOLDS = {"sum": torch.add, "mul": torch.mul, "max": torch.maximum,
          "min": torch.minimum}


def merge(inputs, mode="sum", concat_axis=-1, name=None):
    """Functional merge over Variables."""
    return Merge(mode=mode, concat_axis=concat_axis, name=name)(inputs)
