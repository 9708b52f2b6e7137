"""Optimizers (port of ``analytics_zoo_tpu.keras.optimizers``).

The JAX package returns optax transformations; here each factory returns a
:class:`GradientTransformation`, a functional ``init(params) -> state`` /
``update(grads, state, params) -> (updates, state)`` pair over the
parameter dict, with optax's update arithmetic and operation order so that
a step matches the JAX package's to float32 rounding:

- ``SGD`` is ``optax.sgd``: ``trace = g + momentum * trace``, update
  ``-lr * trace`` (nesterov: ``-lr * (g + momentum * trace)``);
- ``Adam`` is ``optax.adam``: ``mu = (1 - b1) g + b1 mu``,
  ``nu = (1 - b2) g^2 + b2 nu``, bias correction ``1 - b^t`` from t = 1,
  update ``-lr * mu_hat / (sqrt(nu_hat) + eps)``;
- ``AdamWeightDecay`` is ``optax.adamw``: Adam's direction, then
  ``+ weight_decay * param``, then ``-lr`` from a linear warm-up/decay;
- ``RMSprop`` is ``optax.rmsprop``: ``nu = (1 - rho) g^2 + rho nu``,
  ``g * rsqrt(nu + eps)`` (centered: ``rsqrt(nu - mu^2 + eps)``), then
  ``-lr``, then a momentum trace (the JAX package always passes one,
  ``momentum=0.0`` by default, so the trace is always applied);
- ``Adagrad`` is ``optax.adagrad``: ``s = g^2 + s`` from 0.1,
  ``g * rsqrt(s + eps)`` where ``s > 0``, then ``-lr``;
- ``Adadelta`` is ``optax.adadelta``: ``+ 0 * param`` (its zero weight
  decay), ``e_g = (1 - rho) g^2 + rho e_g``,
  ``u = sqrt(e_x + eps) / sqrt(e_g + eps) * g``,
  ``e_x = (1 - rho) u^2 + rho e_x``, then ``-lr``;
- ``Adamax`` is ``optax.adamax``: ``mu`` as Adam,
  ``nu = max(|g| + eps, b2 nu)``, ``mu_hat / nu``, then ``-lr``;
- a schedule (the keras ``decay`` form ``lr / (1 + decay * count)``,
  ``PolyDecay``, ``Warmup``, ``SequentialSchedule``) is evaluated in
  float32 at the step count, which starts at 0.

**One update, two executions.** Every update is written once over the
list of leaves against an op table: :data:`FOREACH` runs each op as one
``torch._foreach_*`` call over all leaves (a few launches per optimizer
step on the card, whatever the number of parameters), :data:`PER_LEAF`
as one call per leaf, the plain version the tests hold it to. The ops and
their order are the same, so the two agree bitwise: on the CPU, where
a foreach op runs the per-tensor op on each leaf, and on the card, where
it runs multi-tensor kernels of the same elementwise arithmetic
(``chip_smoke.py`` phase 6 holds every optimizer so on an H100).
Factories take ``foreach=False`` for the per-leaf form. No fused op
(``addcmul``, ``lerp``, an ``alpha=``) is used: each one would round
differently from optax's separate multiply and add.

The step count lives on the host, so no update reads the device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from analytics_zoo_tpu_torch.common.tree import tree_leaves, tree_unflatten


class GradientTransformation(NamedTuple):
    """An optimizer: ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, new_state)``; the caller
    adds the updates to the parameters."""
    init: Callable
    update: Callable


def optax_leaves(tx: GradientTransformation) -> Optional[Tuple[str, ...]]:
    """The state entries of ``tx`` in the order of the leaves of optax's
    state for the JAX package's same optimizer (``"count"`` twice where
    optax keeps a second count for a schedule), or None for an optimizer
    that does not declare it. A sharded checkpoint stores the optimizer
    shards by that leaf index (``ft.distributed.opt_shard_key``), so both
    packages read each other's. Declared on the ``update`` function."""
    return getattr(tx.update, "optax_leaves", None)


def optax_paths(tx: GradientTransformation) -> Optional[Tuple[str, ...]]:
    """Where each of :func:`optax_leaves`' entries sits in optax's state
    tree for the JAX package's same optimizer: ``"<chain index>/.<field>"``
    (``"0/.mu"`` for Adam's first moment, ``"1/.count"`` for a schedule's
    count), the JAX package's checkpoint key of that entry below
    ``opt_state/``. None for an optimizer that does not declare it."""
    return getattr(tx.update, "optax_paths", None)


def _declare(update: Callable, *entries: str,
             chain: Sequence[int]) -> Callable:
    """Declare ``update``'s optax leaf layout: the entries in optax's leaf
    order and, per entry, the index of the optax chain element that holds
    it."""
    update.optax_leaves = tuple(entries)
    update.optax_paths = tuple(f"{c}/.{e}" for e, c in zip(entries, chain))
    return update


def _schedule_count(schedule) -> Tuple[str, ...]:
    """optax's ``scale_by_learning_rate`` keeps a count only for a
    schedule."""
    return ("count",) if callable(schedule) else ()


# ---------------------------------------------------------------------------
# The two op tables: a list of leaves in, a list out. ``b`` is a list of
# leaves or a host scalar.
# ---------------------------------------------------------------------------


def _pair(op):
    def run(a, b):
        if isinstance(b, (list, tuple)):
            return [op(x, y) for x, y in zip(a, b)]
        return [op(x, b) for x in a]
    return run


class _Ops(NamedTuple):
    add: Callable
    sub: Callable
    mul: Callable
    div: Callable
    maximum: Callable
    sqrt: Callable
    rsqrt: Callable
    abs: Callable


PER_LEAF = _Ops(
    add=_pair(torch.add), sub=_pair(torch.sub), mul=_pair(torch.mul),
    div=_pair(torch.div), maximum=_pair(torch.maximum),
    sqrt=lambda a: [torch.sqrt(x) for x in a],
    rsqrt=lambda a: [torch.rsqrt(x) for x in a],
    abs=lambda a: [torch.abs(x) for x in a])

FOREACH = _Ops(
    add=lambda a, b: list(torch._foreach_add(a, b)),
    sub=lambda a, b: list(torch._foreach_sub(a, b)),
    mul=lambda a, b: list(torch._foreach_mul(a, b)),
    div=lambda a, b: list(torch._foreach_div(a, b)),
    maximum=lambda a, b: list(torch._foreach_maximum(a, b)),
    sqrt=lambda a: list(torch._foreach_sqrt(a)),
    rsqrt=lambda a: list(torch._foreach_rsqrt(a)),
    abs=lambda a: list(torch._foreach_abs(a)))


def _ops(foreach: bool) -> _Ops:
    return FOREACH if foreach else PER_LEAF


def _moment(o: _Ops, g, t, decay: float, order: int):
    """optax ``update_moment``: ``(1 - decay) * g**order + decay * t``
    (``g**2`` as ``g * g``, which XLA emits for it)."""
    gp = g if order == 1 else o.mul(g, g)
    return o.add(o.mul(gp, 1 - decay), o.mul(t, decay))


# ---------------------------------------------------------------------------
# Schedules and scalars (host side)
# ---------------------------------------------------------------------------


def _keras_decay_schedule(lr: float, decay: float
                          ) -> Union[float, Callable]:
    if not decay:
        return lr
    return lambda step: lr / (1.0 + decay * step)


def _step_size(schedule, count: int) -> float:
    """optax's ``scale_by_learning_rate``: ``-lr``, with a schedule
    evaluated in float32 at the step count (0 on the first update)."""
    if callable(schedule):
        return -torch.as_tensor(
            schedule(torch.tensor(count, dtype=torch.int32)),
            dtype=torch.float32).item()
    return -schedule


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32, as optax computes it."""
    return (1 - torch.tensor(decay, dtype=torch.float32) ** count).item()


def _zeros(params):
    return [torch.zeros_like(p) for p in tree_leaves(params)]


def _tree(params, leaves):
    return None if leaves is None else tree_unflatten(params, leaves)


def _trace(o: _Ops, u, trace, momentum: float, nesterov: bool):
    """optax ``trace``: ``t = u + momentum * t``; the update is ``t``
    (nesterov: ``u + momentum * t``)."""
    trace = o.add(u, o.mul(trace, momentum))
    return (o.add(u, o.mul(trace, momentum)) if nesterov else trace), trace


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


def SGD(lr: float = 0.01, momentum: float = 0.0, decay: float = 0.0,
        nesterov: bool = False, schedule: Optional[Callable] = None,
        foreach: bool = True) -> GradientTransformation:
    """Keras-1 SGD (optional momentum/nesterov) with the keras
    ``1/(1+decay*step)`` LR decay, or an explicit ``schedule``."""
    sched = schedule if schedule is not None else _keras_decay_schedule(
        lr, decay)
    o = _ops(foreach)

    def init(params):
        return {"trace": _tree(params, _zeros(params)) if momentum else None,
                "count": 0}

    def update(grads, state, params=None):
        g = tree_leaves(grads)
        trace = None
        if momentum:
            u, trace = _trace(o, g, tree_leaves(state["trace"]), momentum,
                              nesterov)
        else:
            u = g
        u = o.mul(u, _step_size(sched, state["count"]))
        return (tree_unflatten(grads, u),
                {"trace": _tree(grads, trace), "count": state["count"] + 1})

    # optax.sgd: trace (or nothing), then the learning rate
    _declare(update, *(("trace",) if momentum else ()),
             *_schedule_count(sched),
             chain=(0,) * bool(momentum) + (1,))
    return GradientTransformation(init, update)


def _adam_direction(o: _Ops, g, state, b1: float, b2: float, eps: float):
    """optax ``scale_by_adam`` (``eps_root`` 0): the moments and
    ``mu_hat / (sqrt(nu_hat) + eps)``."""
    mu = _moment(o, g, tree_leaves(state["mu"]), b1, 1)
    nu = _moment(o, g, tree_leaves(state["nu"]), b2, 2)
    count = state["count"] + 1
    mu_hat = o.div(mu, _bias_correction(b1, count))
    nu_hat = o.div(nu, _bias_correction(b2, count))
    return o.div(mu_hat, o.add(o.sqrt(nu_hat), eps)), mu, nu, count


def _adam_state(params):
    return {"mu": _tree(params, _zeros(params)),
            "nu": _tree(params, _zeros(params)), "count": 0}


def Adam(lr: float = 1e-3, beta_1: float = 0.9, beta_2: float = 0.999,
         epsilon: float = 1e-8, decay: float = 0.0,
         schedule: Optional[Callable] = None,
         foreach: bool = True) -> GradientTransformation:
    """Keras-semantics Adam (ref keras/optimizers/Adam.scala)."""
    sched = schedule if schedule is not None else _keras_decay_schedule(
        lr, decay)
    o = _ops(foreach)

    def update(grads, state, params=None):
        u, mu, nu, count = _adam_direction(o, tree_leaves(grads), state,
                                           beta_1, beta_2, epsilon)
        u = o.mul(u, _step_size(sched, state["count"]))
        return tree_unflatten(grads, u), {"mu": _tree(grads, mu),
                                          "nu": _tree(grads, nu),
                                          "count": count}

    _declare(update, "count", "mu", "nu", *_schedule_count(sched),
             chain=(0, 0, 0, 1))
    return GradientTransformation(_adam_state, update)


def _linear(init: float, end: float, steps: int) -> Callable:
    """optax ``linear_schedule`` (``polynomial_schedule`` at power 1)."""
    def sched(count):
        c = torch.clamp(count, 0, steps)
        frac = 1 - c / steps
        return (init - end) * frac + end
    return sched


def AdamWeightDecay(lr: float = 1e-3, warmup_portion: float = -1.0,
                    total: int = -1, schedule_name: str = "linear",
                    beta_1: float = 0.9, beta_2: float = 0.999,
                    epsilon: float = 1e-6, weight_decay: float = 0.01,
                    foreach: bool = True) -> GradientTransformation:
    """BERT-style AdamW with linear warmup/decay (ref
    AdamWeightDecay.scala)."""
    if total > 0:
        warmup = int(max(warmup_portion, 0.0) * total)
        schedule = _linear(0.0, lr, max(warmup, 1))
        if warmup < total:
            schedule = SequentialSchedule(
                [schedule, _linear(lr, 0.0, total - warmup)], [warmup])
    else:
        schedule = lr
    o = _ops(foreach)

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("AdamWeightDecay needs the parameters")
        u, mu, nu, count = _adam_direction(o, tree_leaves(grads), state,
                                           beta_1, beta_2, epsilon)
        u = o.add(u, o.mul(tree_leaves(params), weight_decay))
        u = o.mul(u, _step_size(schedule, state["count"]))
        return tree_unflatten(grads, u), {"mu": _tree(grads, mu),
                                          "nu": _tree(grads, nu),
                                          "count": count}

    # optax.adamw: scale_by_adam, add_decayed_weights, the learning rate
    _declare(update, "count", "mu", "nu", *_schedule_count(schedule),
             chain=(0, 0, 0, 2))
    return GradientTransformation(_adam_state, update)


def RMSprop(lr: float = 0.001, rho: float = 0.9, epsilon: float = 1e-8,
            decay: float = 0.0, momentum: float = 0.0,
            centered: bool = False,
            foreach: bool = True) -> GradientTransformation:
    """Keras-1 RMSprop (``rho`` decay of the squared-grad average)."""
    sched = _keras_decay_schedule(lr, decay)
    o = _ops(foreach)

    def init(params):
        return {"mu": _tree(params, _zeros(params)) if centered else None,
                "nu": _tree(params, _zeros(params)),
                "trace": _tree(params, _zeros(params)), "count": 0}

    def update(grads, state, params=None):
        g = tree_leaves(grads)
        nu = _moment(o, g, tree_leaves(state["nu"]), rho, 2)
        mu = None
        if centered:
            mu = _moment(o, g, tree_leaves(state["mu"]), rho, 1)
            scale = o.rsqrt(o.add(o.sub(nu, o.mul(mu, mu)), epsilon))
        else:
            scale = o.rsqrt(o.add(nu, epsilon))
        u = o.mul(o.mul(scale, g), _step_size(sched, state["count"]))
        u, trace = _trace(o, u, tree_leaves(state["trace"]), momentum,
                          False)
        return tree_unflatten(grads, u), {
            "mu": _tree(grads, mu), "nu": _tree(grads, nu),
            "trace": _tree(grads, trace), "count": state["count"] + 1}

    # optax: scale_by_rms (nu) or scale_by_stddev (mu, nu), the learning
    # rate (a count for a schedule), then the momentum trace
    _declare(update, *(("mu", "nu") if centered else ("nu",)),
             *_schedule_count(sched), "trace",
             chain=(0,) * (1 + centered) + (1,) * callable(sched) + (2,))
    return GradientTransformation(init, update)


def Adagrad(lr: float = 0.01, epsilon: float = 1e-8, decay: float = 0.0,
            foreach: bool = True) -> GradientTransformation:
    """Keras-1 Adagrad (optax's accumulator starts at 0.1)."""
    sched = _keras_decay_schedule(lr, decay)
    o = _ops(foreach)

    def init(params):
        return {"sum_of_squares": _tree(params, [
            torch.full_like(p, 0.1) for p in tree_leaves(params)]),
            "count": 0}

    def update(grads, state, params=None):
        g = tree_leaves(grads)
        s = o.add(o.mul(g, g), tree_leaves(state["sum_of_squares"]))
        inv = o.rsqrt(o.add(s, epsilon))
        # optax's where(s > 0, ., 0): one select per leaf
        inv = [torch.where(t > 0, r, 0.0) for t, r in zip(s, inv)]
        u = o.mul(o.mul(inv, g), _step_size(sched, state["count"]))
        return tree_unflatten(grads, u), {
            "sum_of_squares": _tree(grads, s), "count": state["count"] + 1}

    _declare(update, "sum_of_squares", *_schedule_count(sched),
             chain=(0, 1))
    return GradientTransformation(init, update)


def Adadelta(lr: float = 1.0, rho: float = 0.95, epsilon: float = 1e-8,
             foreach: bool = True) -> GradientTransformation:
    """Keras-1 Adadelta."""
    o = _ops(foreach)

    def init(params):
        return {"e_g": _tree(params, _zeros(params)),
                "e_x": _tree(params, _zeros(params)), "count": 0}

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("Adadelta needs the parameters")
        # optax.adadelta chains add_decayed_weights(0.0) first
        g = o.add(tree_leaves(grads), o.mul(tree_leaves(params), 0.0))
        e_g = _moment(o, g, tree_leaves(state["e_g"]), rho, 2)
        e_x = tree_leaves(state["e_x"])
        u = o.mul(o.div(o.sqrt(o.add(e_x, epsilon)),
                        o.sqrt(o.add(e_g, epsilon))), g)
        e_x = _moment(o, u, e_x, rho, 2)
        u = o.mul(u, _step_size(lr, state["count"]))
        return tree_unflatten(grads, u), {
            "e_g": _tree(grads, e_g), "e_x": _tree(grads, e_x),
            "count": state["count"] + 1}

    # optax.adadelta: add_decayed_weights, then scale_by_adadelta
    _declare(update, "e_g", "e_x", chain=(1, 1))
    return GradientTransformation(init, update)


def Adamax(lr: float = 0.002, beta_1: float = 0.9, beta_2: float = 0.999,
           epsilon: float = 1e-8,
           foreach: bool = True) -> GradientTransformation:
    """Keras-1 Adamax (infinity-norm Adam variant)."""
    o = _ops(foreach)

    def update(grads, state, params=None):
        g = tree_leaves(grads)
        count = state["count"] + 1
        mu = _moment(o, g, tree_leaves(state["mu"]), beta_1, 1)
        nu = o.maximum(o.add(o.abs(g), epsilon),
                       o.mul(tree_leaves(state["nu"]), beta_2))
        mu_hat = o.div(mu, _bias_correction(beta_1, count))
        u = o.mul(o.div(mu_hat, nu), _step_size(lr, state["count"]))
        return tree_unflatten(grads, u), {"mu": _tree(grads, mu),
                                          "nu": _tree(grads, nu),
                                          "count": count}

    _declare(update, "count", "mu", "nu", chain=(0, 0, 0))
    return GradientTransformation(_adam_state, update)


# ---------------------------------------------------------------------------
# Schedules: step (an int32 tensor) -> learning rate
# ---------------------------------------------------------------------------


def PolyDecay(lr: float, power: float, max_iterations: int) -> Callable:
    """BigDL SGD.Poly schedule (the Inception recipe's poly decay)."""
    def sched(step):
        frac = 1.0 - step / float(max_iterations)
        return lr * (frac ** power)
    return sched


def Warmup(delta: float) -> Callable:
    """BigDL SGD.Warmup — the LR ramps by ``delta`` per step; compose with
    :func:`SequentialSchedule`."""
    def sched(step):
        return delta * step
    return sched


def SequentialSchedule(schedules: Sequence[Callable],
                       boundaries: Sequence[int]) -> Callable:
    """BigDL SGD.SequentialSchedule — chain schedules, switching at the
    given step boundaries (``optax.join_schedules``)."""
    def sched(step):
        out = torch.as_tensor(schedules[0](step))
        for boundary, s in zip(boundaries, schedules[1:]):
            out = torch.where(step < boundary, out,
                              torch.as_tensor(s(step - boundary)))
        return out
    return sched


_OPTIMIZERS = {
    "adam": Adam,
    "sgd": SGD,
    "rmsprop": RMSprop,
    "adagrad": Adagrad,
    "adadelta": Adadelta,
    "adamax": Adamax,
}


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
