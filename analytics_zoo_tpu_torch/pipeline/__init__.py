"""Pipeline-parallel stage subsystem — the MPMD ``stage`` axis (port of
``analytics_zoo_tpu.pipeline``).

The mesh layer's axes (``data``/``fsdp``/``tp``) partition *tensors*; this
package partitions the *layer graph*: a
:class:`~analytics_zoo_tpu_torch.pipeline.plan.StagePlan` splits a model's
layer stack into K sequential stages by layer-name regex rules (the
``ShardingPlan`` rule discipline applied to layers), a microbatch
scheduler (:mod:`~analytics_zoo_tpu_torch.pipeline.schedule`) runs 1F1B or
naive GPipe fill/drain through per-stage programs, activations ride
bounded per-(stage, microbatch-slot) pools
(:mod:`~analytics_zoo_tpu_torch.pipeline.buffers`), and
:func:`~analytics_zoo_tpu_torch.pipeline.trainer.train_pipelined` drives
the whole schedule with stage-owned two-phase sharded checkpoints in the
JAX package's format.

Each stage is its own program over its own layer segment, so stages may
be heterogeneous, unlike the stacked-stage GPipe of
:mod:`analytics_zoo_tpu_torch.parallel.pipeline`. ``plan``, ``schedule``
and ``buffers`` are the JAX package's modules as they are: they import no
framework.
"""

from analytics_zoo_tpu_torch.pipeline.buffers import ActivationSlots, SlotLease
from analytics_zoo_tpu_torch.pipeline.plan import (
    StageAssignmentError,
    StageLadderError,
    StagePlan,
    StageSegment,
)
from analytics_zoo_tpu_torch.pipeline.schedule import (
    MicrobatchSchedule,
    bubble_fraction,
    simulate_timeline,
)

__all__ = [
    "StagePlan", "StageSegment", "StageAssignmentError", "StageLadderError",
    "MicrobatchSchedule", "simulate_timeline", "bubble_fraction",
    "ActivationSlots", "SlotLease", "train_pipelined",
]


def __getattr__(name):
    # train_pipelined pulls in torch and the Estimator stack: load it on
    # first use so plan/schedule stay importable in light contexts
    # (schedulers, doc tooling) without the training engine
    if name == "train_pipelined":
        from analytics_zoo_tpu_torch.pipeline.trainer import train_pipelined
        return train_pipelined
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
