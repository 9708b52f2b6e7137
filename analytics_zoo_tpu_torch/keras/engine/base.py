"""Layer base (port of ``analytics_zoo_tpu.keras.engine.base``).

As in the JAX package, a layer records weight *specs* in ``build()``,
materialises a parameter dict in ``init_params``, and computes
``call(params, x)`` from that dict. The dict keeps the JAX package's leaf
names and layouts (a Dense ``kernel`` is ``(in, out)``), so the weight map
between the two packages is 1:1. A layer with non-trainable state (batch
norm's moving statistics) declares it with ``add_state``, sets
``has_state`` and returns ``(output, new_state)`` from ``call``; the engine
threads the state. Layers are ``nn.Module``s so that a model's sub-layers
register as its children; calling a layer on a symbolic ``Variable`` wires
it into a functional graph instead of running it.

Initializers draw from an explicit ``torch.Generator``. They cannot
reproduce ``jax.random`` draws; parity tests carry the JAX weights over
instead (``analytics_zoo_tpu_torch.interop``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

Shape = Tuple[Optional[int], ...]

# ---------------------------------------------------------------------------
# Initializers: fn(generator, shape, dtype) -> tensor
# ---------------------------------------------------------------------------


def _fans(shape: Sequence[int]) -> Tuple[int, int]:
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def _uniform(generator, shape, dtype, limit):
    return torch.empty(shape, dtype=dtype).uniform_(-limit, limit,
                                                    generator=generator)


def _normal(generator, shape, dtype):
    return torch.empty(shape, dtype=dtype).normal_(generator=generator)


def _truncated_normal(generator, shape, dtype):
    """A standard normal cut at -2 and 2, as
    ``jax.random.truncated_normal(key, -2.0, 2.0, ...)``."""
    t = torch.empty(shape, dtype=dtype)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                       generator=generator)


def glorot_uniform(generator, shape, dtype=torch.float32):
    """Glorot/Xavier uniform: U(-L, L), L = sqrt(6/(fan_in+fan_out))."""
    fan_in, fan_out = _fans(shape)
    return _uniform(generator, shape, dtype,
                    math.sqrt(6.0 / (fan_in + fan_out)))


def glorot_normal(generator, shape, dtype=torch.float32):
    """Glorot normal: N(0, 2/(fan_in+fan_out))."""
    fan_in, fan_out = _fans(shape)
    return math.sqrt(2.0 / (fan_in + fan_out)) * _normal(generator, shape,
                                                         dtype)


def he_normal(generator, shape, dtype=torch.float32):
    """He normal: N(0, 2/fan_in)."""
    fan_in, _ = _fans(shape)
    return math.sqrt(2.0 / fan_in) * _normal(generator, shape, dtype)


def he_uniform(generator, shape, dtype=torch.float32):
    """He uniform: U(-L, L), L = sqrt(6/fan_in)."""
    fan_in, _ = _fans(shape)
    return _uniform(generator, shape, dtype, math.sqrt(6.0 / fan_in))


def lecun_uniform(generator, shape, dtype=torch.float32):
    """LeCun uniform: U(-L, L), L = sqrt(3/fan_in)."""
    fan_in, _ = _fans(shape)
    return _uniform(generator, shape, dtype, math.sqrt(3.0 / fan_in))


def normal_init(stddev=0.05, mean=0.0):
    """Factory: N(mean, stddev) initializer (keras-1 "normal")."""
    def init(generator, shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype).normal_(mean, stddev,
                                                       generator=generator)

    return init


def uniform_init(scale=0.05):
    """Factory: U(-scale, scale) initializer (keras-1 "uniform")."""
    def init(generator, shape, dtype=torch.float32):
        return _uniform(generator, shape, dtype, scale)

    return init


def zeros_init(generator, shape, dtype=torch.float32):
    """All-zeros initializer."""
    return torch.zeros(shape, dtype=dtype)


def ones_init(generator, shape, dtype=torch.float32):
    """All-ones initializer."""
    return torch.ones(shape, dtype=dtype)


def orthogonal_init(generator, shape, dtype=torch.float32):
    """Orthogonal matrix initializer (recurrent kernels), as
    ``jax.nn.initializers.orthogonal()``: a normal draw of (rows, cols)
    with cols = the last dim, transposed when rows < cols, its QR factor Q
    with the signs of R's diagonal, transposed back."""
    cols = shape[-1]
    rows = math.prod(shape) // cols
    a = torch.empty(max(rows, cols), min(rows, cols)).normal_(
        generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    return q.reshape(shape).to(dtype)


def lecun_normal(generator, shape, dtype=torch.float32):
    """LeCun normal: ``variance_scaling_init(1.0, "fan_in",
    "truncated_normal")``, so Var = 1/fan_in after the truncation."""
    return variance_scaling_init(1.0, "fan_in", "truncated_normal")(
        generator, shape, dtype)


def truncated_normal_init(stddev=0.05, mean=0.0):
    """Factory: N(mean, stddev) cut at 2 sigma."""
    def init(generator, shape, dtype=torch.float32):
        return mean + stddev * _truncated_normal(generator, shape, dtype)

    return init


def constant_init(value=0.0):
    """Factory: constant-fill initializer."""
    def init(generator, shape, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype)

    return init


def identity_init(gain=1.0):
    """Factory: gain-scaled identity matrix (2-D shapes only)."""
    def init(generator, shape, dtype=torch.float32):
        if len(shape) != 2:
            raise ValueError("identity initializer requires a 2D shape")
        return gain * torch.eye(shape[0], shape[1], dtype=dtype)

    return init


def variance_scaling_init(scale=1.0, mode="fan_in", distribution="normal"):
    """Keras-2 VarianceScaling: s = scale / max(1, n) for n the fan_in,
    fan_out or their mean; "normal" and "truncated_normal" draw a normal
    cut at 2 sigma with the stddev sqrt(s) / 0.8796... that keeps the
    variance s, "untruncated_normal" N(0, s), "uniform" U(-L, L) with
    L = sqrt(3 s)."""
    def init(generator, shape, dtype=torch.float32):
        fan_in, fan_out = _fans(shape)
        n = {"fan_in": fan_in, "fan_out": fan_out,
             "fan_avg": (fan_in + fan_out) / 2.0}[mode]
        s = scale / max(1.0, n)
        if distribution in ("normal", "truncated_normal"):
            stddev = math.sqrt(s) / 0.87962566103423978
            return stddev * _truncated_normal(generator, shape, dtype)
        if distribution == "untruncated_normal":
            return math.sqrt(s) * _normal(generator, shape, dtype)
        if distribution != "uniform":
            raise ValueError(f"unknown distribution '{distribution}'")
        return _uniform(generator, shape, dtype, math.sqrt(3.0 * s))

    return init


_INITS: Dict[str, Callable] = {
    "glorot_uniform": glorot_uniform,
    "xavier": glorot_uniform,
    "glorot_normal": glorot_normal,
    "he_normal": he_normal,
    "he_uniform": he_uniform,
    "lecun_uniform": lecun_uniform,
    "uniform": uniform_init(),
    "normal": normal_init(),
    "gaussian": normal_init(),
    "zero": zeros_init,
    "zeros": zeros_init,
    "one": ones_init,
    "ones": ones_init,
    "orthogonal": orthogonal_init,
    "lecun_normal": lecun_normal,
    "truncated_normal": truncated_normal_init(),
    "constant": constant_init(),
    "identity": identity_init(),
    "variance_scaling": variance_scaling_init(),
}


def get_initializer(init) -> Callable:
    """Resolve an ``init`` spec (name or callable)."""
    if callable(init):
        return init
    try:
        return _INITS[init]
    except KeyError:
        raise ValueError(
            f"Unknown initializer '{init}'. Known: {sorted(_INITS)}") from None


# ---------------------------------------------------------------------------
# Regularizers
# ---------------------------------------------------------------------------


def abs_(x):
    """``|x|`` with the derivative 1 at 0, as ``jnp.abs`` has it (torch's
    ``abs`` has 0 there): an L1 penalty on zero-initialised biases moves
    them from the first step in both packages."""
    return torch.where(x >= 0, x, -x)


class Regularizer:
    """Weight penalty added to the training loss: ``l1 * sum|w| +
    l2 * sum(w^2)``. The train step adds it over the float32 master
    weights (the tensors the optimizer updates), as the JAX package's
    loss does, not over their compute-dtype cast."""

    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.l1, self.l2 = float(l1), float(l2)

    def __call__(self, w):
        out = 0.0
        if self.l1:
            out = out + self.l1 * torch.sum(abs_(w))
        if self.l2:
            out = out + self.l2 * torch.sum(torch.square(w))
        return out


def L1L2(l1=0.0, l2=0.0):
    """Combined L1+L2 penalty (keras-1 ``l1l2``)."""
    return Regularizer(l1, l2)


def L1(l1=0.01):
    """L1 (lasso) weight penalty."""
    return Regularizer(l1=l1)


def L2(l2=0.01):
    """L2 (ridge / weight-decay) penalty."""
    return Regularizer(l2=l2)


# ---------------------------------------------------------------------------
# Weight specs
# ---------------------------------------------------------------------------


def mask_pair_main_shape(input_shape):
    """Layers may be wired with an ``[x, mask]`` input pair (the keras
    converter's timestep-mask convention); shape logic keys on the
    sequence operand."""
    if input_shape and isinstance(input_shape[0], (list, tuple)):
        return tuple(input_shape[0])
    return input_shape



class WeightSpec:
    """One parameter declaration of a layer: name, shape, initializer,
    optional regularizer, trainability and dtype."""
    __slots__ = ("name", "shape", "init", "regularizer", "trainable",
                 "dtype")

    def __init__(self, name, shape, init, regularizer=None, trainable=True,
                 dtype=torch.float32):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.init = get_initializer(init)
        self.regularizer = regularizer
        self.trainable = trainable
        self.dtype = dtype


def materialize(specs: Dict, generator: torch.Generator) -> Dict:
    """Draw a (nested) ``{name: WeightSpec}`` tree into tensors, in the
    tree's order, from one generator."""
    out = {}
    for name, spec in specs.items():
        if isinstance(spec, dict):
            out[name] = materialize(spec, generator)
        else:
            out[name] = spec.init(generator, spec.shape, spec.dtype)
    return out


# ---------------------------------------------------------------------------
# Naming
# ---------------------------------------------------------------------------

_NAME_COUNTS: Dict[str, int] = {}


def unique_name(base: str) -> str:
    """Globally-counted layer naming (``dense_1``, ``dense_2``, ...)."""
    _NAME_COUNTS[base] = _NAME_COUNTS.get(base, 0) + 1
    return f"{base}_{_NAME_COUNTS[base]}"


def reset_name_counts() -> None:
    """Reset the global name counters."""
    _NAME_COUNTS.clear()


# ---------------------------------------------------------------------------
# KerasLayer
# ---------------------------------------------------------------------------


class KerasLayer(nn.Module):
    """Base class for all layers.

    Lifecycle:
      1. construct (records hyperparams; ``input_shape`` excludes batch)
      2. ``build(full_input_shape)`` registers :class:`WeightSpec`s
      3. ``init_params(generator)`` materialises the parameter dict
      4. ``call(params, x, state=, training=, rng=)`` computes the output
         from that dict (``(output, new_state)`` for stateful layers)
    """

    has_state = False  # subclasses with non-trainable state set True

    def __init__(self, input_shape: Optional[Sequence[int]] = None,
                 name: Optional[str] = None):
        super().__init__()
        self.name = name or unique_name(type(self).__name__.lower())
        self._user_input_shape = (tuple(input_shape)
                                  if input_shape is not None else None)
        self.built = False
        self.input_shape: Optional[Shape] = None
        self.output_shape: Optional[Shape] = None
        self.weight_specs: List[WeightSpec] = []
        self.state_specs: List[WeightSpec] = []
        self.trainable = True

    def add_weight(self, name, shape, init="glorot_uniform",
                   regularizer=None, trainable=True,
                   dtype=torch.float32) -> None:
        """Declare one parameter (shape, init, regularizer,
        trainability); called from ``build``."""
        self.weight_specs.append(
            WeightSpec(name, shape, init, regularizer, trainable, dtype))

    def add_state(self, name, shape, init="zeros",
                  dtype=torch.float32) -> None:
        """Declare one non-trainable state buffer (e.g. BN running stats);
        called from ``build``."""
        self.state_specs.append(
            WeightSpec(name, shape, init, None, False, dtype))

    def ensure_built(self, input_shape: Shape) -> Shape:
        """Build once for ``input_shape`` (no-op when already built)."""
        if not self.built:
            self.input_shape = tuple(input_shape)
            self.build(self.input_shape)
            self.built = True
            self.output_shape = self.compute_output_shape(self.input_shape)
        return self.output_shape

    def build(self, input_shape: Shape) -> None:  # override
        """Shape-dependent setup: declare weights for ``input_shape``."""

    def compute_output_shape(self, input_shape: Shape) -> Shape:  # override
        """Batch-free output shape for a batch-free input shape."""
        return tuple(input_shape)

    def param_specs(self) -> Dict:
        """``{name: WeightSpec}``, mirroring ``init_params``'s structure.
        Layers with nested parameter dicts override this."""
        return {spec.name: spec for spec in self.weight_specs}

    def init_params(self, generator: torch.Generator) -> Dict:
        """Initialize this layer's parameter dict from a generator."""
        return materialize(self.param_specs(), generator)

    def init_state(self) -> Dict:
        """Initial values of the layer's non-trainable state buffers."""
        return materialize({s.name: s for s in self.state_specs},
                           torch.Generator().manual_seed(0))

    def regularization_loss(self, params: Dict):
        """Sum of the layer's declared weight penalties for ``params``
        (0.0 when it declares none). Layers with nested parameter dicts
        override this."""
        loss = 0.0
        for spec in self.weight_specs:
            if spec.regularizer is not None and spec.name in params:
                loss = loss + spec.regularizer(params[spec.name])
        return loss

    def call(self, params, x, **kwargs):  # override
        """The layer computation: ``(params, x, ...) -> output``."""
        raise NotImplementedError

    def forward(self, params, x, **kwargs):
        return self.call(params, x, **kwargs)

    def __call__(self, *args, **kwargs):
        """On a ``Variable`` (or a list of them): wire this layer into a
        functional graph and return its output ``Variable``, as the JAX
        package's symbolic ``__call__`` does. On anything else: the
        ``nn.Module`` call, which runs ``forward``."""
        from analytics_zoo_tpu_torch.autograd.variable import (
            Variable,
            apply_layer,
        )

        if len(args) == 1 and not kwargs:
            v = args[0]
            if isinstance(v, Variable) or (
                    isinstance(v, (list, tuple)) and v
                    and all(isinstance(e, Variable) for e in v)):
                return apply_layer(self, v)
        return super().__call__(*args, **kwargs)

    def user_input_shape(self) -> Optional[Shape]:
        """The input_shape the user declared on construction, with the
        batch dim (or None)."""
        if self._user_input_shape is None:
            return None
        return (None,) + self._user_input_shape

    def __repr__(self):
        return f"<{type(self).__name__} {self.name} out={self.output_shape}>"


class Lambda(KerasLayer):
    """A torch function as a parameter-free layer (the graph op behind the
    ``Variable`` arithmetic). Without ``output_shape_fn`` the output shape
    is inferred by running the function on meta tensors with batch 1."""

    def __init__(self, function: Callable,
                 output_shape_fn: Optional[Callable] = None,
                 input_shape=None, name: Optional[str] = None,
                 arity: int = 1):
        super().__init__(input_shape=input_shape,
                         name=name or unique_name("lambda"))
        self.function = function
        self.output_shape_fn = output_shape_fn
        self.arity = arity

    def compute_output_shape(self, input_shape: Union[Shape, List[Shape]]
                             ) -> Shape:
        if self.output_shape_fn is not None:
            return tuple(self.output_shape_fn(input_shape))

        def sub(shape):
            return torch.zeros(tuple(1 if d is None else d for d in shape),
                               device="meta")

        if self.arity == 1:
            out = self.function(sub(input_shape))
        else:
            out = self.function(*(sub(s) for s in input_shape))
        return (None,) + tuple(out.shape[1:])

    def call(self, params, x, **kwargs):
        if self.arity == 1:
            return self.function(x)
        return self.function(*x)
