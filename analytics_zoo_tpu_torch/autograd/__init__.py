"""Define-by-expression API (port of ``analytics_zoo_tpu.autograd``):
``Variable`` expressions and ``Parameter`` (``variable.py``), the
``AutoGrad``-style math functions, and ``CustomLoss``.

Each math function takes a ``Variable`` (and wires a parameter-free
``Lambda`` node into the graph) or a plain tensor (and applies at once).
Keras-1 conventions, as in the JAX package: dim 0 is the batch, and the
reductions ``sum``/``mean`` default to ``axis=0``; ``l2_normalize`` and
``batch_dot(normalize=True)`` divide by ``norm + 1e-12``; ``batch_dot``
contracts per-sample axes ``axes[i] - 1``. Differentiation is autograd's.
"""

from __future__ import annotations

import builtins
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.autograd.variable import (
    Parameter,
    Variable,
    apply_layer,
    execute,
    graph_layers,
)
from analytics_zoo_tpu_torch.keras.engine.base import (
    Lambda,
    abs_,
    unique_name,
)

VarOrTensor = Union[Variable, torch.Tensor]


def _unary(fn: Callable, name: str):
    def op(x: VarOrTensor, **kw):
        f = (lambda a: fn(a, **kw)) if kw else fn
        if isinstance(x, Variable):
            return apply_layer(Lambda(f, name=unique_name(name)), x)
        return f(x)

    op.__name__ = name
    op.__doc__ = (f"``AutoGrad.{name}``: elementwise {name} of a "
                  f"``Variable`` (a graph node) or a tensor (at once).")
    return op


def _binary(fn: Callable, name: str):
    def op(a, b):
        if isinstance(a, Variable) and isinstance(b, Variable):
            return apply_layer(Lambda(fn, name=unique_name(name), arity=2),
                               [a, b])
        if isinstance(a, Variable):
            return apply_layer(Lambda(lambda x: fn(x, b),
                                      name=unique_name(name)), a)
        if isinstance(b, Variable):
            return apply_layer(Lambda(lambda x: fn(a, x),
                                      name=unique_name(name)), b)
        return fn(a, b)

    op.__name__ = name
    op.__doc__ = (f"``AutoGrad.{name}`` of two operands, either a "
                  f"``Variable`` or a tensor (or a number).")
    return op


def _pairwise(fn: Callable) -> Callable:
    """``fn`` of two tensors, a number taken as a 0-d tensor of the other
    operand's dtype and device."""
    def f(a, b):
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
        if not isinstance(b, torch.Tensor):
            b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
        return fn(a, b)
    return f


abs = _unary(abs_, "abs")  # derivative 1 at 0, as jnp.abs
square = _unary(torch.square, "square")
sqrt = _unary(torch.sqrt, "sqrt")
log = _unary(torch.log, "log")
exp = _unary(torch.exp, "exp")
erf = _unary(torch.erf, "erf")
softsign = _unary(F.softsign, "softsign")
softplus = _unary(F.softplus, "softplus")
maximum = _binary(_pairwise(torch.maximum), "maximum")
minimum = _binary(_pairwise(torch.minimum), "minimum")


def sum(x: VarOrTensor, axis: int = 0, keepdims: bool = False):
    """Reduce-sum over ``axis`` (dim 0 is the batch)."""
    return _unary(lambda a: torch.sum(a, dim=axis, keepdim=keepdims),
                  "sum")(x)


def mean(x: VarOrTensor, axis: int = 0, keepdims: bool = False):
    """Reduce-mean over ``axis`` (dim 0 is the batch)."""
    return _unary(lambda a: torch.mean(a, dim=axis, keepdim=keepdims),
                  "mean")(x)


def clip(x: VarOrTensor, min: float, max: float):
    """Clamp into ``[min, max]``."""
    return _unary(lambda a: torch.clamp(a, min, max), "clip")(x)


def pow(x: VarOrTensor, a: float):
    """Elementwise ``x ** a``."""
    return _unary(lambda v: v ** a, "pow")(x)


def neg(x: VarOrTensor):
    """Elementwise negation."""
    return _unary(lambda v: -v, "neg")(x)


def stack(inputs: Sequence[Variable], axis: int = 1) -> Variable:
    """Join Variables on a new axis (default 1, after the batch)."""
    lam = Lambda(lambda *xs: torch.stack(xs, dim=axis),
                 name=unique_name("stack"), arity=len(inputs))
    return apply_layer(lam, list(inputs))


def expand_dims(x: VarOrTensor, axis: int):
    """Insert a size-1 axis at ``axis``."""
    return _unary(lambda a: a.unsqueeze(axis), "expand_dims")(x)


def contiguous(x: VarOrTensor):
    """The same values in a contiguous tensor."""
    return _unary(lambda a: a.contiguous(), "contiguous")(x)


def mm(x, y, axes: Optional[Sequence[int]] = None):
    """Matrix product, or with ``axes`` the tensordot contracting
    ``axes[0]`` of ``x`` with ``axes[1]`` of ``y``."""
    if axes is None:
        return _binary(torch.matmul, "mm")(x, y)
    ax0, ax1 = axes
    return _binary(lambda a, b: torch.tensordot(a, b, dims=([ax0], [ax1])),
                   "mm")(x, y)


def _batch_dot(a, b, ax0: int, ax1: int):
    """Per-sample tensordot of per-sample axes ``ax0 - 1`` and ``ax1 - 1``
    (a negative one counted in the per-sample rank, as the JAX package's
    ``vmap`` takes it): (B, *rest_a, *rest_b)."""
    pa = (ax0 - 1) % (a.dim() - 1) + 1
    pb = (ax1 - 1) % (b.dim() - 1) + 1
    a = a.movedim(pa, -1)
    b = b.movedim(pb, 1)
    rest_a, rest_b = a.shape[1:-1], b.shape[2:]
    out = torch.bmm(a.reshape(a.shape[0], -1, a.shape[-1]),
                    b.reshape(b.shape[0], b.shape[1], -1))
    return out.reshape((a.shape[0],) + tuple(rest_a) + tuple(rest_b))


def batch_dot(x, y, axes: Sequence[int] = (1, 1), normalize: bool = False):
    """Per-sample dot over ``axes`` (Keras semantics, dim 0 the batch);
    ``normalize`` divides each operand by its L2 norm (+ 1e-12) along its
    axis first."""
    ax0, ax1 = axes

    def fn(a, b):
        if normalize:
            a = a / (torch.linalg.vector_norm(a, dim=ax0, keepdim=True)
                     + 1e-12)
            b = b / (torch.linalg.vector_norm(b, dim=ax1, keepdim=True)
                     + 1e-12)
        return _batch_dot(a, b, ax0, ax1)

    return _binary(fn, "batch_dot")(x, y)


def l2_normalize(x: VarOrTensor, axis: int = 1):
    """Scale to unit L2 norm along ``axis`` (dividing by norm + 1e-12)."""
    return _unary(
        lambda a: a / (torch.linalg.vector_norm(a, dim=axis, keepdim=True)
                       + 1e-12), "l2_normalize")(x)


class CustomLoss:
    """A user-defined loss: a function ``(y_true, y_pred) -> loss``
    (its result as it returns it: a per-row vector is reduced by the
    train step over the valid rows of the tail mask), or a parameter-free
    ``Variable`` expression over ``y_pred_var`` and ``y_true_var``, whose
    graph runs inline and whose mean is the loss (a scalar, as in the JAX
    package)."""

    def __init__(self, loss: Union[Callable, Variable],
                 y_pred_var: Optional[Variable] = None,
                 y_true_var: Optional[Variable] = None):
        if isinstance(loss, Variable):
            if y_pred_var is None or y_true_var is None:
                raise ValueError("Variable-based CustomLoss needs y_pred_var "
                                 "and y_true_var")
            out_var, pv, tv = loss, y_pred_var, y_true_var
            if builtins.any(l.weight_specs for l in graph_layers([out_var])):
                raise ValueError("CustomLoss expression must be "
                                 "parameter-free")

            def fn(y_true, y_pred):
                outs, _ = execute([out_var], {pv.name: y_pred,
                                              tv.name: y_true}, {})
                return torch.mean(outs[0])

            self.fn = fn
        else:
            self.fn = loss

    def __call__(self, y_true, y_pred):
        return self.fn(y_true, y_pred)


__all__ = [
    "Variable", "Parameter", "CustomLoss", "apply_layer",
    "abs", "square", "sqrt", "log", "exp", "erf", "softsign", "softplus",
    "maximum", "minimum", "sum", "mean", "clip", "pow", "neg", "stack",
    "expand_dims", "contiguous", "mm", "batch_dot", "l2_normalize",
]
