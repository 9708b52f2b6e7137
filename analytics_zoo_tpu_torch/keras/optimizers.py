"""Optimizers (port of ``analytics_zoo_tpu.keras.optimizers``: ``SGD``,
``Adam`` and ``get``).

The JAX package returns optax transformations; here each factory returns a
:class:`GradientTransformation`, a functional ``init(params) -> state`` /
``update(grads, state, params) -> (updates, state)`` pair over the
parameter dict, with optax's update arithmetic so that one step matches the
JAX package's to float32 rounding:

- ``SGD`` is ``optax.sgd``: ``trace = g + momentum * trace``, update
  ``-lr * trace`` (nesterov: ``-lr * (g + momentum * trace)``);
- ``Adam`` is ``optax.adam``: ``mu = (1 - b1) g + b1 mu``,
  ``nu = (1 - b2) g^2 + b2 nu``, bias correction ``1 - b^t`` from t = 1,
  update ``-lr * mu_hat / (sqrt(nu_hat) + eps)``;
- the keras ``decay`` schedule is ``lr / (1 + decay * count)`` in float32,
  the count starting at 0.

The step count lives on the host, so no update reads the device. The other
optimizers and schedules of the JAX package (RMSprop, Adagrad, Adadelta,
Adamax, AdamWeightDecay, PolyDecay, Warmup, SequentialSchedule) are not
ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from analytics_zoo_tpu_torch.common.tree import tree_map


class GradientTransformation(NamedTuple):
    """An optimizer: ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, new_state)``; the caller
    adds the updates to the parameters."""
    init: Callable
    update: Callable


def _keras_decay_schedule(lr: float, decay: float
                          ) -> Union[float, Callable]:
    if not decay:
        return lr
    return lambda step: lr / (1.0 + decay * step)


def _step_size(schedule, count: int) -> float:
    """optax's ``scale_by_learning_rate``: ``-lr``, with a schedule
    evaluated in float32 at the step count (0 on the first update)."""
    if callable(schedule):
        lr = torch.as_tensor(schedule(torch.tensor(count, dtype=torch.int32)),
                             dtype=torch.float32)
        return (-lr).item()
    return -schedule


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32, as optax computes it."""
    return (1 - torch.tensor(decay, dtype=torch.float32) ** count).item()


def SGD(lr: float = 0.01, momentum: float = 0.0, decay: float = 0.0,
        nesterov: bool = False, schedule: Optional[Callable] = None
        ) -> GradientTransformation:
    """Keras-1 SGD (optional momentum/nesterov) with the keras
    ``1/(1+decay*step)`` LR decay, or an explicit ``schedule``."""
    sched = schedule if schedule is not None else _keras_decay_schedule(
        lr, decay)

    def init(params):
        trace = tree_map(torch.zeros_like, params) if momentum else None
        return {"trace": trace, "count": 0}

    def update(grads, state, params=None):
        trace = None
        if momentum:
            trace = tree_map(lambda g, t: g + momentum * t, grads,
                             state["trace"])
            upd = (tree_map(lambda g, t: g + momentum * t, grads, trace)
                   if nesterov else trace)
        else:
            upd = grads
        step = _step_size(sched, state["count"])
        return (tree_map(lambda u: step * u, upd),
                {"trace": trace, "count": state["count"] + 1})

    return GradientTransformation(init, update)


def Adam(lr: float = 1e-3, beta_1: float = 0.9, beta_2: float = 0.999,
         epsilon: float = 1e-8, decay: float = 0.0,
         schedule: Optional[Callable] = None) -> GradientTransformation:
    """Keras-semantics Adam (ref keras/optimizers/Adam.scala)."""
    sched = schedule if schedule is not None else _keras_decay_schedule(
        lr, decay)

    def init(params):
        return {"mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params), "count": 0}

    def update(grads, state, params=None):
        mu = tree_map(lambda g, t: (1 - beta_1) * g + beta_1 * t, grads,
                      state["mu"])
        nu = tree_map(lambda g, t: (1 - beta_2) * (g ** 2) + beta_2 * t,
                      grads, state["nu"])
        count = state["count"] + 1
        bc1 = _bias_correction(beta_1, count)
        bc2 = _bias_correction(beta_2, count)
        step = _step_size(sched, state["count"])
        upd = tree_map(
            lambda m, v: step * ((m / bc1) / (torch.sqrt(v / bc2)
                                             + epsilon)), mu, nu)
        return upd, {"mu": mu, "nu": nu, "count": count}

    return GradientTransformation(init, update)


_OPTIMIZERS = {"adam": Adam, "sgd": SGD}


def get(opt) -> GradientTransformation:
    """Resolve a name, a factory or a transformation to a transformation."""
    if isinstance(opt, GradientTransformation):
        return opt
    if callable(opt):
        return opt()
    try:
        return _OPTIMIZERS[opt.lower()]()
    except KeyError:
        raise ValueError(f"Unknown optimizer '{opt}'. Known: "
                         f"{sorted(_OPTIMIZERS)}") from None
