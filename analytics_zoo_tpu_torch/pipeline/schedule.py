"""Microbatch schedules — 1F1B and naive GPipe fill/drain, as data (port
of ``analytics_zoo_tpu.pipeline.schedule``: a copy; it imports no
framework).

A schedule is three things, all derived deterministically from
``(num_stages K, num_microbatches M, mode, slot budget)``:

- **per-stage op sequences** — the order each stage executes its ops:
  ``("F", s, m)`` forward, ``("B", s, m)`` backward (rematerializing
  the forward from the stashed stage input), and ``("L", K-1, m)`` the
  last stage's fused forward+loss+backward;
- **a global event order** — one topological interleaving of those
  sequences for the single-process driver (later stages drain first,
  so activation slots free as early as the real MPMD run's would);
- **a modeled MPMD timeline** — per-stage clocks advanced through the
  op sequences under the cross-stage dependencies, from measured
  per-op costs. :func:`bubble_fraction` is read off this timeline.

Schedules are compared at an EQUAL activation-slot budget (the
preallocated per-(stage, slot) buffers of
:mod:`~analytics_zoo_tpu_torch.pipeline.buffers`): 1F1B needs at most
``K - s`` slots at stage ``s``; naive GPipe wants all ``M``, so under
the same budget it flushes in pool-sized chunks — fill P, drain P —
and eats a (K-1)-deep bubble per chunk where 1F1B pays once. That is
the measured gap the JAX package's bench pins
(docs/pipeline-parallel.md
"Bubble math"); with unbounded memory the two schedules tie and the
difference is footprint only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["MicrobatchSchedule", "TimelineResult", "simulate_timeline",
           "bubble_fraction"]

#: One schedule op: ``(kind, stage, microbatch)`` with kind ``"F"``
#: (forward), ``"B"`` (backward) or ``"L"`` (last stage, fused F+B).
Op = Tuple[str, int, int]


@dataclass(frozen=True)
class TimelineResult:
    """The modeled MPMD timeline of one schedule run."""

    makespan: float
    per_stage_busy: Tuple[float, ...]
    per_stage_bubble: Tuple[float, ...]

    @property
    def bubble(self) -> float:
        """Aggregate idle fraction: 1 - Σ busy / (K × makespan)."""
        if self.makespan <= 0:
            return 0.0
        k = len(self.per_stage_busy)
        return 1.0 - sum(self.per_stage_busy) / (k * self.makespan)


class MicrobatchSchedule:
    """1F1B or naive GPipe fill/drain over K stages × M microbatches.

    ``mode`` is ``"1f1b"`` (default) or ``"gpipe"``; ``slots`` overrides
    the per-schedule activation budget (default: the 1F1B peak,
    ``min(K, M)`` — the equal-memory comparison point).
    """

    MODES = ("1f1b", "gpipe")

    def __init__(self, num_stages: int, num_microbatches: int,
                 mode: str = "1f1b", slots: Optional[int] = None):
        self.num_stages = int(num_stages)
        self.num_microbatches = int(num_microbatches)
        if self.num_stages < 1:
            raise ValueError(f"need >= 1 stage, got {num_stages}")
        if self.num_microbatches < 1:
            raise ValueError(
                f"need >= 1 microbatch, got {num_microbatches}")
        if mode not in self.MODES:
            raise ValueError(
                f"unknown schedule mode {mode!r}; known: {self.MODES}")
        self.mode = mode
        budget = min(self.num_stages, self.num_microbatches)
        self.slots = int(slots) if slots is not None else budget
        if self.slots < 1:
            raise ValueError(f"slot budget must be >= 1, got {slots}")

    # -- op sequences -----------------------------------------------------

    def slot_budget(self) -> Dict[int, int]:
        """Per-stage activation-slot pool sizes (the preallocation)."""
        k, m = self.num_stages, self.num_microbatches
        if self.mode == "1f1b":
            return {s: min(k - s, m, self.slots) for s in range(k)}
        return {s: min(self.slots, m) for s in range(k)}

    def per_stage_ops(self) -> List[List[Op]]:
        """Each stage's op sequence, in its execution order."""
        k, m = self.num_stages, self.num_microbatches
        if k == 1:
            return [[("L", 0, mb) for mb in range(m)]]
        if self.mode == "1f1b":
            return self._ops_1f1b(k, m)
        return self._ops_gpipe(k, m)

    def _ops_1f1b(self, k: int, m: int) -> List[List[Op]]:
        stages: List[List[Op]] = []
        for s in range(k - 1):
            warm = min(k - 1 - s, m)
            ops: List[Op] = [("F", s, mb) for mb in range(warm)]
            for i in range(m - warm):
                ops.append(("F", s, warm + i))
                ops.append(("B", s, i))
            for i in range(max(m - warm, 0), m):
                ops.append(("B", s, i))
            stages.append(ops)
        stages.append([("L", k - 1, mb) for mb in range(m)])
        return stages

    def _ops_gpipe(self, k: int, m: int) -> List[List[Op]]:
        # naive fill/drain under the slot budget: flush in pool-sized
        # chunks (fill P forwards, drain P backwards — reverse order,
        # the classic GPipe drain), chunk after chunk
        p = min(self.slots, m)
        chunks = [list(range(lo, min(lo + p, m))) for lo in range(0, m, p)]
        stages: List[List[Op]] = []
        for s in range(k - 1):
            ops: List[Op] = []
            for chunk in chunks:
                ops.extend(("F", s, mb) for mb in chunk)
                ops.extend(("B", s, mb) for mb in reversed(chunk))
            stages.append(ops)
        last: List[Op] = []
        for chunk in chunks:
            last.extend(("L", k - 1, mb) for mb in chunk)
        stages.append(last)
        return stages

    # -- dependencies -----------------------------------------------------

    def _deps(self, op: Op) -> List[Op]:
        kind, s, mb = op
        k = self.num_stages
        if kind == "F":
            return [] if s == 0 else [("F", s - 1, mb)]
        if kind == "L":
            return [] if k == 1 else [("F", s - 1, mb)]
        # "B" at stage s < K-1: the cotangent comes from the next stage
        nxt = ("L", s + 1, mb) if s + 1 == k - 1 else ("B", s + 1, mb)
        return [nxt]

    def events(self) -> List[Op]:
        """The single-process execution order: a deterministic
        topological interleaving of the per-stage sequences, draining
        later stages first so slots free as early as possible. Raises
        on a schedule that deadlocks (a generator bug, surfaced here
        rather than as a hang)."""
        queues = [list(ops) for ops in self.per_stage_ops()]
        done: set = set()
        order: List[Op] = []
        total = sum(len(q) for q in queues)
        while len(order) < total:
            progressed = False
            for s in range(self.num_stages - 1, -1, -1):
                while queues[s] and all(d in done
                                        for d in self._deps(queues[s][0])):
                    op = queues[s].pop(0)
                    order.append(op)
                    done.add(op)
                    progressed = True
            if not progressed:
                heads = [q[0] for q in queues if q]
                raise RuntimeError(
                    f"schedule deadlock: no stage head is ready "
                    f"(heads: {heads})")
        return order

    def measured_slots(self) -> Dict[int, int]:
        """Peak concurrently-held input slots per stage under the exact
        trainer lease protocol — checkout at producer completion (or at
        injection for stage 0), release at the owning backward — dry-run
        over :meth:`events`. This is what the trainer preallocates;
        tests pin it equal to :meth:`slot_budget` so the declared
        comparison budget is the real footprint."""
        k = self.num_stages
        held = {s: 0 for s in range(k)}
        peak = {s: 0 for s in range(k)}

        def checkout(s: int) -> None:
            held[s] += 1
            peak[s] = max(peak[s], held[s])

        for kind, s, _mb in self.events():
            if kind == "F":
                if s == 0:
                    checkout(0)
                checkout(s + 1)
            elif kind == "L":
                if k == 1:
                    checkout(0)
                held[s] -= 1
            else:
                held[s] -= 1
        leaked = {s: n for s, n in held.items() if n}
        if leaked:
            raise RuntimeError(
                f"schedule leaks activation slots: {leaked}")
        return peak

    # -- timeline ---------------------------------------------------------

    def simulate(self, costs: Optional[Dict[str, float]] = None
                 ) -> TimelineResult:
        """Model the MPMD timeline: every stage executes its op sequence
        on its own clock, each op starting when both the stage is free
        and its cross-stage dependency has finished. ``costs`` maps op
        kind → duration (default F=1, B=2, L=3 — backward ≈ 2× forward,
        the usual rule of thumb; the JAX package's bench feeds
        measured means)."""
        return simulate_timeline(self.per_stage_ops(), self._deps, costs)

    def describe(self) -> Dict[str, object]:
        """Human-readable summary (mode, sizes, per-stage slot budget)."""
        return {"mode": self.mode, "stages": self.num_stages,
                "microbatches": self.num_microbatches,
                "slots": self.slot_budget()}


def simulate_timeline(per_stage_ops: Sequence[Sequence[Op]], deps_fn,
                      costs: Optional[Dict[str, float]] = None
                      ) -> TimelineResult:
    """Per-stage clock simulation over fixed op sequences + deps."""
    costs = dict(costs or {"F": 1.0, "B": 2.0, "L": 3.0})
    k = len(per_stage_ops)
    finish: Dict[Op, float] = {}
    clock = [0.0] * k
    busy = [0.0] * k
    # process in a valid global order: next unfinished op per stage whose
    # deps all have finish times, looping until every sequence drains
    idx = [0] * k
    total = sum(len(ops) for ops in per_stage_ops)
    done = 0
    while done < total:
        progressed = False
        for s in range(k - 1, -1, -1):
            ops = per_stage_ops[s]
            while idx[s] < len(ops):
                op = ops[idx[s]]
                dep_times = []
                ready = True
                for d in deps_fn(op):
                    if d not in finish:
                        ready = False
                        break
                    dep_times.append(finish[d])
                if not ready:
                    break
                start = max([clock[s]] + dep_times)
                cost = float(costs.get(op[0], 1.0))
                clock[s] = start + cost
                busy[s] += cost
                finish[op] = clock[s]
                idx[s] += 1
                done += 1
                progressed = True
        if not progressed:
            raise RuntimeError("timeline deadlock: dependency cycle or "
                               "missing producer in the op sequences")
    makespan = max(clock) if clock else 0.0
    per_bubble = tuple(
        0.0 if makespan <= 0 else 1.0 - b / makespan for b in busy)
    return TimelineResult(makespan=makespan,
                          per_stage_busy=tuple(busy),
                          per_stage_bubble=per_bubble)


def bubble_fraction(num_stages: int, num_microbatches: int, mode: str,
                    slots: Optional[int] = None,
                    costs: Optional[Dict[str, float]] = None) -> float:
    """Aggregate bubble fraction of one schedule configuration — the
    number the JAX package's BENCH_PIPE.json records and CI gates (1F1B strictly below
    naive GPipe at >= 4 microbatches under the equal slot budget)."""
    sched = MicrobatchSchedule(num_stages, num_microbatches, mode=mode,
                               slots=slots)
    return sched.simulate(costs).bubble
