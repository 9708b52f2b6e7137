"""Triggers (a copy of ``analytics_zoo_tpu.engine.triggers``, which imports
no jax; the port keeps its own copy rather than import the JAX package).
Ref BigDL ``Trigger`` semantics used throughout the Keras API
(Topology.scala:349-354 wires EveryEpoch validation and MaxEpoch end) and the
Estimator (Estimator.scala:64). A trigger is a predicate over the run state.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RunState:
    epoch: int = 0          # completed epochs
    iteration: int = 0      # completed iterations (global step)
    epoch_step: int = 0     # completed iterations WITHIN the current epoch
    # (the data-iterator offset a mid-epoch checkpoint records, so resume
    # skips exactly the batches the interrupted run already consumed)
    epoch_finished: bool = False  # true at epoch boundaries
    loss: float = float("inf")
    score: float = float("-inf")


class Trigger:
    """Predicate over :class:`RunState`.

    Custom subclasses that do NOT read ``state.loss`` should set a class
    attribute ``reads_loss = False`` — the training loop then reads the
    loss from the device only at epoch ends. Unknown triggers are
    conservatively treated as loss-reading and force a synchronous fetch
    each step. (Do not rely on ``state.loss`` being current otherwise.)
    """

    def __call__(self, state: RunState) -> bool:
        raise NotImplementedError

    @staticmethod
    def max_epoch(n):
        """Factory: MaxEpoch(n) (ref Trigger.maxEpoch)."""
        return MaxEpoch(n)

    @staticmethod
    def max_iteration(n):
        """Factory: MaxIteration(n) (ref Trigger.maxIteration)."""
        return MaxIteration(n)

    @staticmethod
    def every_epoch():
        """Factory: EveryEpoch() (ref Trigger.everyEpoch)."""
        return EveryEpoch()

    @staticmethod
    def several_iteration(n):
        """Factory: SeveralIteration(n) (ref Trigger.severalIteration)."""
        return SeveralIteration(n)


class MaxEpoch(Trigger):
    def __init__(self, max_epoch: int):
        self.max_epoch = int(max_epoch)

    def __call__(self, state: RunState) -> bool:
        return state.epoch >= self.max_epoch


class MaxIteration(Trigger):
    def __init__(self, max_iteration: int):
        self.max_iteration = int(max_iteration)

    def __call__(self, state: RunState) -> bool:
        return state.iteration >= self.max_iteration


class EveryEpoch(Trigger):
    def __call__(self, state: RunState) -> bool:
        return state.epoch_finished


class SeveralIteration(Trigger):
    def __init__(self, interval: int):
        self.interval = int(interval)

    def __call__(self, state: RunState) -> bool:
        return state.iteration > 0 and state.iteration % self.interval == 0


class MinLoss(Trigger):
    def __init__(self, min_loss: float):
        self.min_loss = float(min_loss)

    def __call__(self, state: RunState) -> bool:
        return state.loss <= self.min_loss


class MaxScore(Trigger):
    def __init__(self, max_score: float):
        self.max_score = float(max_score)

    def __call__(self, state: RunState) -> bool:
        return state.score >= self.max_score


class And(Trigger):
    def __init__(self, *triggers):
        self.triggers = triggers

    def __call__(self, state):
        return all(t(state) for t in self.triggers)


class Or(Trigger):
    def __init__(self, *triggers):
        self.triggers = triggers

    def __call__(self, state):
        return any(t(state) for t in self.triggers)
