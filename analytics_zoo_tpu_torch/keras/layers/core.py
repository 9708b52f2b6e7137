"""Core layers (port of ``analytics_zoo_tpu.keras.layers.core``): the
activation table, ``Activation``, ``Dense``, ``Dropout``, ``Flatten``,
``Reshape``, the shape layers (``Permute``, ``RepeatVector``,
``Squeeze``, ``ExpandDim``, ``Select``, ``Narrow``), ``Masking``,
``Merge``/``merge``, the advanced activations (``LeakyReLU``, ``ELU``,
``ThresholdedReLU``, ``SReLU``, ``PReLU``) and the noise layers
(``GaussianNoise``, ``GaussianDropout``, ``SpatialDropout1D``/``2D``).

Dims follow the JAX package, Keras-1 style: ``Permute`` takes 1-based
dims over the non-batch axes; ``Squeeze``, ``ExpandDim``, ``Select`` and
``Narrow`` count the batch as dim 0 and take a negative dim or index as
the JAX call does (their output shapes are computed as the JAX layers
compute them). ``Masking`` multiplies by ``any(x != mask_value)`` over
the last axis and hands no mask object on, as in the JAX package.

The noise layers are the identity unless ``training`` and a generator
(``rng``, the context's step generator on the tensor's device) are given;
every draw comes from that generator, never from torch's global one.
"""

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


def promoted(a: torch.Tensor, b: torch.Tensor):
    """``(a, b)`` in one dtype, promoted as ``jnp`` promotes: a float32
    operand and a bf16 one meet in float32 (torch's matmul and
    convolutions take one dtype)."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        return a.to(dt), b.to(dt)
    return a, b


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with the operands :func:`promoted`, as ``jnp.matmul``
    promotes them."""
    a, b = promoted(a, b)
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
    dtypes are promoted first (:func:`matmul`). ``bias_init`` is "zeros"
    (keras2's ``Dense`` sets it from ``bias_initializer``)."""

    def __init__(self, output_dim: int, init="glorot_uniform",
                 activation=None, W_regularizer=None, b_regularizer=None,
                 bias=True, input_dim=None, input_shape=None, name=None):
        if input_dim is not None and input_shape is None:
            input_shape = (input_dim,)
        super().__init__(input_shape, name)
        self.output_dim = int(output_dim)
        self.init = init
        self.activation = get_activation(activation)
        self.W_regularizer = W_regularizer
        self.b_regularizer = b_regularizer
        self.bias = bias
        self.bias_init = "zeros"

    def build(self, input_shape: Shape):
        self.add_weight("kernel", (input_shape[-1], self.output_dim),
                        self.init, regularizer=self.W_regularizer)
        if self.bias:
            self.add_weight("bias", (self.output_dim,), self.bias_init,
                            regularizer=self.b_regularizer)

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


class Permute(KerasLayer):
    """Permute the non-batch axes; ``dims`` are 1-based (Keras-1)."""

    def __init__(self, dims: Sequence[int], input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.dims = tuple(dims)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return (input_shape[0],) + tuple(input_shape[d] for d in self.dims)

    def call(self, params, x, **kw):
        return x.permute((0,) + self.dims)


class RepeatVector(KerasLayer):
    """(B, D) -> (B, n, D)."""

    def __init__(self, n: int, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.n = int(n)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return (input_shape[0], self.n, input_shape[1])

    def call(self, params, x, **kw):
        return x[:, None, :].expand(-1, self.n, -1).contiguous()


class Squeeze(KerasLayer):
    """Drop the size-1 axis ``dim`` (dim 0 is the batch)."""

    def __init__(self, dim: int, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.dim = dim

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return tuple(d for i, d in enumerate(input_shape) if i != self.dim)

    def call(self, params, x, **kw):
        if x.shape[self.dim] != 1:
            raise ValueError(f"Squeeze: dim {self.dim} of {tuple(x.shape)} "
                             "is not of size 1")
        return x.squeeze(self.dim)


class ExpandDim(KerasLayer):
    """Insert a size-1 axis at ``dim`` (dim 0 is the batch)."""

    def __init__(self, dim: int, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.dim = dim

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        s = list(input_shape)
        s.insert(self.dim, 1)
        return tuple(s)

    def call(self, params, x, **kw):
        return x.unsqueeze(self.dim)


class Masking(KerasLayer):
    """Zero every step whose features all equal ``mask_value``."""

    def __init__(self, mask_value: float = 0.0, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.mask_value = mask_value

    def call(self, params, x, **kw):
        mask = torch.any(x != self.mask_value, dim=-1, keepdim=True)
        return x * mask.to(x.dtype)


class Select(KerasLayer):
    """Select one ``index`` of ``dim``, dropping the dim (dim 0 is the
    batch)."""

    def __init__(self, dim: int, index: int, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.dim, self.index = dim, index

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return tuple(d for i, d in enumerate(input_shape) if i != self.dim)

    def call(self, params, x, **kw):
        return x.select(self.dim, self.index)


class Narrow(KerasLayer):
    """``length`` entries of ``dim`` from ``offset`` (a negative offset
    counts from the end, as ``lax.slice_in_dim`` takes it)."""

    def __init__(self, dim: int, offset: int, length: int = 1,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.dim, self.offset, self.length = dim, offset, length

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        s = list(input_shape)
        s[self.dim] = self.length
        return tuple(s)

    def call(self, params, x, **kw):
        return x.narrow(self.dim, self.offset, self.length)


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


# ---------------------------------------------------------------------------
# Advanced activations
# ---------------------------------------------------------------------------


class LeakyReLU(KerasLayer):
    """``x`` where ``x >= 0``, else ``alpha * x`` (``jax.nn.leaky_relu``)."""

    def __init__(self, alpha: float = 0.3, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.alpha = alpha

    def call(self, params, x, **kw):
        return torch.where(x >= 0, x, self.alpha * x)


class ELU(KerasLayer):
    """``x`` where ``x > 0``, else ``alpha * (exp(x) - 1)``."""

    def __init__(self, alpha: float = 1.0, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.alpha = alpha

    def call(self, params, x, **kw):
        return F.elu(x, self.alpha)


class ThresholdedReLU(KerasLayer):
    """``x * (x > theta)``."""

    def __init__(self, theta: float = 1.0, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.theta = theta

    def call(self, params, x, **kw):
        return x * (x > self.theta).to(x.dtype)


class SReLU(KerasLayer):
    """S-shaped ReLU with four learnable per-feature tensors over the
    non-batch shape: ``t_left``, ``a_left``, ``t_right`` (the right
    threshold is ``t_left + |t_right|``) and ``a_right``."""

    def build(self, input_shape: Shape):
        feat = tuple(input_shape[1:])
        self.add_weight("t_left", feat, "zeros")
        self.add_weight("a_left", feat, "glorot_uniform")
        self.add_weight("t_right", feat, "glorot_uniform")
        self.add_weight("a_right", feat, "ones")

    def call(self, params, x, **kw):
        tl, al = params["t_left"], params["a_left"]
        tr, ar = params["t_right"], params["a_right"]
        tr_eff = tl + torch.abs(tr)
        y = torch.where(x < tl, tl + al * (x - tl), x)
        return torch.where(x > tr_eff, tr_eff + ar * (x - tr_eff), y)


class PReLU(KerasLayer):
    """``x`` where ``x >= 0``, else ``alpha * x`` with a learnable
    ``alpha`` over the non-batch shape (initialised to 0)."""

    def build(self, input_shape: Shape):
        self.add_weight("alpha", tuple(input_shape[1:]), "zeros")

    def call(self, params, x, **kw):
        return torch.where(x >= 0, x, params["alpha"] * x)


# ---------------------------------------------------------------------------
# Noise
# ---------------------------------------------------------------------------


def _normal_like(x, rng):
    return torch.randn(x.shape, generator=rng, device=x.device,
                       dtype=x.dtype)


def _keep_mask(x, shape, keep, rng):
    """Bernoulli(keep) over ``shape`` (broadcast against ``x``)."""
    return torch.rand(shape, generator=rng, device=x.device) < keep


class GaussianNoise(KerasLayer):
    """Additive N(0, sigma^2) noise in training."""

    def __init__(self, sigma: float, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.sigma = sigma

    def call(self, params, x, training=False, rng=None, **kw):
        if not training or rng is None:
            return x
        return x + self.sigma * _normal_like(x, rng)


class GaussianDropout(KerasLayer):
    """Multiplicative N(1, p / (1 - p)) noise in training."""

    def __init__(self, p: float, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.p = p

    def call(self, params, x, training=False, rng=None, **kw):
        if not training or rng is None or self.p <= 0:
            return x
        stddev = math.sqrt(self.p / (1.0 - self.p))
        return x * (1.0 + stddev * _normal_like(x, rng))


class SpatialDropout1D(KerasLayer):
    """Drops whole feature channels of (B, T, C), scaling the kept ones
    by ``1 / (1 - p)``."""

    def __init__(self, p: float = 0.5, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.p = p

    def call(self, params, x, training=False, rng=None, **kw):
        if not training or rng is None or self.p <= 0:
            return x
        keep = 1.0 - self.p
        mask = _keep_mask(x, (x.shape[0], 1, x.shape[2]), keep, rng)
        return torch.where(mask, x / keep, 0.0)


class SpatialDropout2D(KerasLayer):
    """Drops whole feature maps of NCHW ("th") or NHWC ("tf") input."""

    def __init__(self, p: float = 0.5, dim_ordering: str = "th",
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.p = p
        self.dim_ordering = dim_ordering

    def call(self, params, x, training=False, rng=None, **kw):
        if not training or rng is None or self.p <= 0:
            return x
        keep = 1.0 - self.p
        shape = ((x.shape[0], x.shape[1], 1, 1) if self.dim_ordering == "th"
                 else (x.shape[0], 1, 1, x.shape[3]))
        return torch.where(_keep_mask(x, shape, keep, rng), x / keep, 0.0)
