"""Per-(stage, microbatch-slot) activation buffers — lease discipline
(port of ``analytics_zoo_tpu.pipeline.buffers``: a copy).

The microbatch scheduler hands activations between stages through a
bounded, preallocated pool of slots per stage, reusing the serving
batcher's staging-lease discipline (checkout → fill → consume →
release; the pool is the backpressure). A slot stashes the stage's
INPUT activation for one in-flight microbatch — the backward op
rematerializes the forward from it (GPipe-style recompute), so slot
count IS the activation-memory footprint of the schedule:

- 1F1B keeps at most ``K - s`` microbatches in flight at stage ``s``;
- naive GPipe fill/drain wants all ``M`` — under an equal slot budget
  the scheduler chunks its flush into pool-sized waves instead
  (docs/pipeline-parallel.md "Bubble math").

Checkout of an exhausted pool raises: the schedule generator is
responsible for never exceeding the budget, so an empty pool is a
scheduler bug surfacing loudly, not a wait.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["ActivationSlots", "SlotLease"]


@dataclass
class SlotLease:
    """One checked-out activation slot: ``(stage, slot)`` plus the
    stashed payload. Invalid after release — the pool nulls the payload
    so a use-after-release is a visible None, not a stale activation."""

    stage: int
    slot: int
    payload: Any = None
    released: bool = field(default=False, repr=False)


class ActivationSlots:
    """Bounded per-stage slot pools for in-flight microbatch activations.

    ``slots_per_stage`` maps stage id → pool size (the schedule's peak
    in-flight count for that stage). All pools are allocated up front;
    steady state allocates nothing.
    """

    def __init__(self, slots_per_stage: Dict[int, int]):
        self._free: Dict[int, List[int]] = {}
        self._leases: Dict[Tuple[int, int], SlotLease] = {}
        self._capacity: Dict[int, int] = {}
        self._peak: Dict[int, int] = {}
        for stage, n in slots_per_stage.items():
            n = int(n)
            if n < 1:
                raise ValueError(
                    f"stage {stage} needs at least one activation slot, "
                    f"got {n}")
            self._free[int(stage)] = list(range(n))
            self._capacity[int(stage)] = n
            self._peak[int(stage)] = 0

    def capacity(self, stage: int) -> int:
        """Preallocated slot count for ``stage``."""
        return self._capacity[stage]

    def in_flight(self, stage: int) -> int:
        """Slots of ``stage`` currently leased (checked out, not released)."""
        return self._capacity[stage] - len(self._free[stage])

    def peak(self, stage: int) -> int:
        """High-water mark of concurrently leased slots — the measured
        activation footprint the parity tests pin per schedule."""
        return self._peak[stage]

    def checkout(self, stage: int, payload: Any = None) -> SlotLease:
        """Lease a free slot of ``stage``, stashing ``payload`` (the
        stage-input activation). An exhausted pool is a scheduler bug —
        raises instead of blocking."""
        free = self._free.get(stage)
        if free is None:
            raise KeyError(f"stage {stage} has no slot pool")
        if not free:
            raise RuntimeError(
                f"activation slot pool exhausted for stage {stage} "
                f"(capacity {self._capacity[stage]}) — the schedule "
                "exceeded its declared in-flight budget")
        slot = free.pop()
        lease = SlotLease(stage=stage, slot=slot, payload=payload)
        self._leases[(stage, slot)] = lease
        self._peak[stage] = max(self._peak[stage], self.in_flight(stage))
        return lease

    def release(self, lease: SlotLease) -> None:
        """Return a slot to its pool. Double release raises (it means
        two schedule events claimed the same microbatch's buffer)."""
        if lease.released:
            raise RuntimeError(
                f"slot ({lease.stage}, {lease.slot}) released twice")
        stored = self._leases.pop((lease.stage, lease.slot), None)
        if stored is not lease:
            raise RuntimeError(
                f"lease ({lease.stage}, {lease.slot}) is not checked out "
                "of this pool")
        lease.released = True
        lease.payload = None
        self._free[lease.stage].append(lease.slot)

    def assert_drained(self) -> None:
        """Every slot back in its pool — called after a schedule
        completes; a held lease means an F/B pair never closed."""
        held = sorted(self._leases)
        if held:
            raise RuntimeError(
                f"activation slots still leased after the schedule "
                f"drained: {held}")
