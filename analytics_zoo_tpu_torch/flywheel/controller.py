"""The flywheel's promotion loop — one cycle end to end.

:class:`FlywheelController` glues the pieces the rest of the package
provides into one closed loop::

      serving traffic
        │  CaptureTap (sampled, atomic segments)
        ▼
      rotate → FlywheelTrainer.run_once (warm-start, 1 epoch)
        │  candidate ckpt_<step>/ committed
        ▼
      CheckpointWatcher.poll_once → engine.register(version=str(step))
        │  auto-canary (engine has a RolloutConfig + an incumbent)
        ▼
      RolloutController ladder: 1% → 5% → 25% → 100%
        │  error-rate / p99 gates on live + shadow traffic
        ├─ promoted    → candidate is latest; incumbent retired draining
        └─ rolled back → incumbent keeps serving; the cycle's capture
                         segments are QUARANTINEd and the candidate's
                         checkpoints deleted — bad data cannot re-enter
                         the next cycle through either door

The controller owns the watcher it creates with
``poll_interval_s=3600`` and drives :meth:`poll_once` itself — the
promotion point must be *after* ``run_once`` returns, never at a
mid-epoch checkpoint a concurrent poll could see. ``run_cycle`` blocks
until the rollout resolves (caller-supplied ``traffic_fn`` keeps
requests flowing so the gates accumulate their ``min_requests``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from analytics_zoo_tpu_torch.common.observability import (
    flywheel_metrics,
    get_tracer,
    monotonic_s,
)
from analytics_zoo_tpu_torch.common.flight_recorder import get_flight_recorder
from analytics_zoo_tpu_torch.flywheel.capture import CaptureTap, quarantine_segment
from analytics_zoo_tpu_torch.flywheel.trainer import FlywheelTrainer

__all__ = ["CycleReport", "FlywheelController"]


@dataclass
class CycleReport:
    """What one :meth:`FlywheelController.run_cycle` did.

    ``outcome`` is one of ``"promoted"`` (candidate is latest),
    ``"rolled_back"`` (gates failed — capture quarantined, candidate
    checkpoints discarded), ``"no_data"`` (nothing new captured),
    ``"timeout"`` (rollout unresolved within ``timeout_s`` — nothing
    was quarantined; the rollout keeps running) or
    ``"register_failed"`` (the candidate trained and committed but
    never became a live version — nothing was quarantined, and a later
    healthy poll can still register the committed step)."""

    outcome: str
    candidate_step: Optional[int] = None
    rotated_segment: Optional[str] = None
    consumed_segments: List[str] = field(default_factory=list)
    quarantined: List[str] = field(default_factory=list)
    rollback_reason: Optional[str] = None
    duration_s: float = 0.0
    #: How the candidate was trained: "outcome" (joined ground-truth
    #: labels), "distill" (self-distillation fallback), or None when the
    #: lane has no outcome plane (``RetrainConfig.labels_dir`` unset).
    mode: Optional[str] = None


class FlywheelController:
    """One model's flywheel. Construct with a serving ``engine``, the
    model ``name``, the :class:`CaptureTap` feeding it, the
    :class:`FlywheelTrainer` for its retrain lane, and the
    ``build_model``/``example_input`` pair ``watch_checkpoints`` needs
    to turn committed checkpoints into servables. ``config`` (a
    ``BatcherConfig``) is passed through to registration; give the
    *engine* a ``RolloutConfig`` to make promotion go through the
    canary ladder rather than direct repoint."""

    def __init__(self, engine, name: str, tap: CaptureTap,
                 trainer: FlywheelTrainer,
                 build_model: Callable[[str], object], example_input,
                 config=None, keep_versions: int = 3,
                 tick_interval_s: float = 0.02,
                 fraction: Optional[float] = None):
        self.engine = engine
        self.name = name
        self.tap = tap
        self.trainer = trainer
        self.metrics = flywheel_metrics()
        self.tick_interval_s = float(tick_interval_s)
        # manual-poll watcher: a 1-hour interval makes the background
        # thread inert — promotion happens at our poll_once call, after
        # the cycle's FINAL checkpoint committed (a short interval could
        # canary a mid-epoch checkpoint)
        self.watcher = engine.watch_checkpoints(
            name, trainer.config.checkpoint_dir, build_model,
            example_input, config=config, poll_interval_s=3600.0,
            keep_versions=keep_versions)
        tap.enable(name, fraction=fraction)

    # -- cycle ------------------------------------------------------------

    def run_cycle(self, traffic_fn: Optional[Callable[[], None]] = None,
                  timeout_s: Optional[float] = 60.0) -> CycleReport:
        """One full cycle: rotate capture → retrain → promote. Blocks
        until the candidate's rollout resolves (or ``timeout_s``).
        ``traffic_fn`` is called between evaluation ticks to keep
        requests flowing through the gates."""
        t0 = time.perf_counter()
        span_t0 = monotonic_s()
        report = self._cycle(traffic_fn, timeout_s)
        report.duration_s = time.perf_counter() - t0
        self.metrics["cycles"].labels(outcome=report.outcome).inc()
        self.metrics["cycle_seconds"].observe(report.duration_s)
        tracer = get_tracer()
        if tracer.enabled:
            tracer.record_span(
                "flywheel.cycle", "flywheel", span_t0, monotonic_s(),
                model=self.name, outcome=report.outcome,
                candidate_step=report.candidate_step,
                rows=len(report.consumed_segments))
        return report

    def _cycle(self, traffic_fn, timeout_s) -> CycleReport:
        base_step = self.trainer.incumbent_step()
        self.tap.flush()
        rotated = self.tap.rotate(self.name)
        step = self.trainer.run_once()
        if step is None:
            return CycleReport(outcome="no_data", rotated_segment=rotated)
        consumed = list(self.trainer.last_consumed)
        self.watcher.poll_once()
        live = self.engine.stats().get(self.name, {}).get("versions", {})
        if str(step) not in live:
            # the watcher refused or failed to register the candidate
            # (structural skip, or a stale high-water mark) — with no
            # live version there is no rollout to await, and waiting
            # would misread a PREVIOUS candidate's terminal rollout
            # record under the same step number as this cycle's outcome
            return CycleReport(outcome="register_failed",
                               candidate_step=step,
                               rotated_segment=rotated,
                               consumed_segments=consumed,
                               mode=getattr(self.trainer, "last_mode",
                                            None))
        outcome, reason = self._await_rollout(str(step), traffic_fn,
                                              timeout_s)
        report = CycleReport(outcome=outcome, candidate_step=step,
                             rotated_segment=rotated,
                             consumed_segments=consumed,
                             rollback_reason=reason,
                             mode=getattr(self.trainer, "last_mode",
                                          None))
        if outcome == "rolled_back":
            # a rollback means live traffic hit a bad candidate — the
            # flight ring still holds those requests, so snapshot it
            get_flight_recorder().trigger("canary_rollback")
            for seg in consumed:
                quarantine_segment(
                    seg, reason=f"rollback of candidate {step} "
                                f"({reason})")
                self.metrics["quarantined"].inc()
            report.quarantined = list(consumed)
            # rows sampled while the bad canary served carry its
            # outputs — rotate the in-flight window and quarantine it
            # too, so they cannot seed the next cycle
            self.tap.flush()
            inflight = self.tap.rotate(self.name)
            if inflight is not None:
                quarantine_segment(
                    inflight, reason=f"captured during rolled-back "
                                     f"canary {step} ({reason})")
                self.metrics["quarantined"].inc()
                report.quarantined.append(inflight)
            self.trainer.discard_candidates_after(base_step)
            # the rejected candidate's checkpoints are gone and the next
            # cycle's retrain resumes from the incumbent — it can
            # re-mint the very same step number, and the watcher must
            # be willing to register it
            self.watcher.rewind(base_step)
        return report

    def _await_rollout(self, candidate: str, traffic_fn,
                       timeout_s) -> tuple:
        """Watch the rollout for ``candidate`` to resolve; drives
        evaluation ticks so resolution does not depend on the
        controller thread's own timing. Registration without a rollout
        (no RolloutConfig, or no incumbent to canary against) resolves
        by checking the engine repointed latest."""
        rc = self.engine.rollout_controller()
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        while True:
            desc = rc.describe(self.name) if rc is not None else None
            if (desc is not None and desc.get("canary") == candidate
                    and desc.get("done")):
                return desc.get("outcome"), desc.get("reason")
            if desc is None or desc.get("canary") != candidate:
                # no canary began for this candidate: direct-repoint
                # registration (first version, or engine without a
                # RolloutConfig)
                latest = self.engine.stats().get(self.name, {}) \
                    .get("latest")
                if latest == candidate:
                    return "promoted", None
            if traffic_fn is not None:
                traffic_fn()
            if rc is not None:
                rc.tick()
            if deadline is not None and time.monotonic() >= deadline:
                return "timeout", None
            time.sleep(self.tick_interval_s)

    def close(self) -> None:
        """Stop the watcher and the model's sampling (the tap itself —
        shared across models — stays up for its owner to close)."""
        self.tap.disable(self.name)
        self.watcher.stop()
