"""Training-mode batch normalization (port of
``analytics_zoo_tpu.ops.batch_norm``).

A ``torch.autograd.Function`` with the JAX package's arithmetic, not
``F.batch_norm``, which differs from it in the variance it returns (torch
keeps an unbiased running variance; Keras-1 and the JAX package use the
biased one, divided by N):

- forward: statistics in one pass in f32 (f64 for an f64 input), ``var =
  E[x^2] - E[x]^2`` clamped at 0; the output is ``x * scale + shift`` in
  ``x.dtype`` with ``scale`` and ``shift`` cast to it;
- backward: the two-pass form, ``dbeta = sum(dy)`` and ``dgamma =
  sum(dy * xhat)`` over one read of ``x`` and ``dy``, then ``dx = gamma *
  inv * (dy - dbeta / n - xhat * dgamma / n)``;
- ``mean`` and ``var`` are outputs without gradient: they feed the moving
  statistics, which are state.

``x`` is saved in its own dtype. The eager torch ops here make several
passes over ``x`` where XLA fused them into one; their cost on the card is
in ``PERF.md``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def _bcast(v: torch.Tensor, ndim: int, axes: Sequence[int]) -> torch.Tensor:
    """A per-feature vector shaped to broadcast against the input."""
    shape = [1] * ndim
    shape[next(i for i in range(ndim) if i not in axes)] = -1
    return v.reshape(shape)


class _BatchNormTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, gamma, beta, axes, eps):
        n = math.prod(x.shape[a] for a in axes)
        acc = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(acc)
        mean = xf.sum(dim=axes) / n
        var = torch.clamp_min(xf.square().sum(dim=axes) / n - mean * mean,
                              0.0)
        inv = torch.rsqrt(var + eps)
        scale = gamma.to(acc) * inv
        shift = beta.to(acc) - mean * scale
        y = (x * _bcast(scale.to(x.dtype), x.dim(), axes)
             + _bcast(shift.to(x.dtype), x.dim(), axes))
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.axes, ctx.beta_dtype = axes, beta.dtype
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        axes, nd = ctx.axes, x.dim()
        n = math.prod(x.shape[a] for a in axes)
        acc = mean.dtype
        dyf = dy.to(acc)
        xhat = (x.to(acc) - _bcast(mean, nd, axes)) * _bcast(inv, nd, axes)
        dbeta = dyf.sum(dim=axes)
        dgamma = (dyf * xhat).sum(dim=axes)
        k = _bcast(gamma.to(acc) * inv, nd, axes)
        dx = k * (dyf - _bcast(dbeta / n, nd, axes)
                  - xhat * _bcast(dgamma / n, nd, axes))
        return (dx.to(x.dtype), dgamma.to(gamma.dtype),
                dbeta.to(ctx.beta_dtype), None, None)


def batch_norm_train(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, axes: Sequence[int], eps: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalize ``x`` over ``axes`` with its batch statistics. Returns
    ``(y, mean, var)``: ``y`` in ``x.dtype``, ``mean``/``var`` the f32
    (f64 for an f64 input) biased batch statistics, without gradient."""
    return _BatchNormTrain.apply(x, gamma, beta, tuple(axes), float(eps))
