"""Canary rollouts: staged traffic ladders with metric-gated
auto-promote and auto-rollback.

This closes the loop the reference never had: hot-reload mints a
new version from every committed checkpoint, the breaker measures
per-version failure — but until now a new version instantly took 100% of
traffic via ``_latest``, so a bad checkpoint was caught only *after* it
had eaten real requests. The :class:`RolloutController` instead walks
each new version up a configurable weight ladder (default
1% → 5% → 25% → 100%), gated at every rung on live health:

- **Promote** to the next rung only after ``min_requests`` canary
  requests at the current rung AND canary error-rate/p99 within
  tolerance of the incumbent over the same sliding window (the breaker's
  window machinery, one deque per version — see :class:`VersionHealth`).
- **Rollback** — tolerance violated, or the canary's circuit breaker
  opens (the breaker listener fires the evaluator immediately; a broken
  canary does not wait out the evaluation interval): canary weight → 0,
  the version is retired draining, the incumbent keeps serving, and
  ``zoo_serving_rollbacks_total{model,reason}`` increments.
- **Finalize** — the last rung (weight 1.0) holds until its own gate
  passes, then ``_latest`` repoints to the canary, the policy is
  cleared (back to the zero-overhead no-policy path) and the old
  incumbent retires draining — exactly what hot-reload's repoint did,
  but only after the version earned it.

The controller is deliberately tick-driven: :meth:`tick` evaluates every
active rollout once and is safe to call from anywhere (tests drive it
directly for determinism); the optional evaluator thread just calls it
on an interval and on breaker-open events. All transitions emit
``serving.rollout_transition`` spans and Prometheus counters/gauges so a
rollout is fully reconstructable from the trace alone. Runbook and
ladder-tuning guidance: docs/rollouts.md.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch.common.observability import (
    get_tracer,
    monotonic_s,
    new_trace_id,
)

__all__ = ["DriftGateConfig", "RolloutConfig", "VersionHealth",
           "RolloutState", "RolloutController", "ROLLBACK_REASONS"]

#: The ``reason`` label values of ``zoo_serving_rollbacks_total``.
ROLLBACK_REASONS = ("error_rate", "latency", "breaker_open", "superseded",
                    "manual", "drift")


@dataclass(frozen=True)
class DriftGateConfig:
    """The rollout ladder's drift gate: roll a canary back
    when its prediction distribution diverges from the incumbent's on
    the same live traffic, even though neither errors nor latency moved.

    Defined here (not in :mod:`analytics_zoo_tpu_torch.flywheel.drift`) so the
    serving layer never imports the flywheel at module load; the engine
    bridges to whatever ``set_drift`` tracker is attached through the
    duck-typed ``engine.drift_scores(...)`` read path.

    Args:
      max_prediction_js: rollback when the canary-vs-incumbent
        prediction-histogram Jensen–Shannon divergence (base 2, in
        [0, 1]) exceeds this. 0.25 trips on a clear distribution shift
        while tolerating the sketch noise of small windows.
      min_count: predictions BOTH versions must have contributed before
        the gate evaluates — below it the gate abstains (holds neither
        against the canary), exactly like ``min_requests`` for the
        error/latency gates.
    """

    max_prediction_js: float = 0.25
    min_count: int = 30

    def __post_init__(self):
        if not 0.0 < self.max_prediction_js <= 1.0:
            raise ValueError(
                f"max_prediction_js must be in (0, 1], got "
                f"{self.max_prediction_js}")
        if self.min_count < 1:
            raise ValueError("min_count must be >= 1")


@dataclass(frozen=True)
class RolloutConfig:
    """Ladder shape and promotion gates.

    Args:
      ladder: ascending canary weights, last entry must be 1.0 (full
        traffic). The default climbs 1% → 5% → 25% → 100%.
      min_requests: canary requests that must complete at the current
        rung before its gate is evaluated (promotion OR metric rollback
        — with too few samples the rollout simply holds).
      error_rate_tolerance: absolute slack — canary error-rate may
        exceed the incumbent's by at most this much.
      p99_tolerance_ratio: relative gate — canary p99 must be ≤
        incumbent p99 × ratio + ``p99_slack_s``.
      p99_slack_s: absolute latency slack added to the p99 gate (keeps
        the ratio gate meaningful when the incumbent is microseconds
        fast).
      evaluate_interval_s: evaluator-thread wake period (ignored when
        ``auto_evaluate`` is False).
      auto_evaluate: spawn the background evaluator thread. Tests turn
        this off and call :meth:`RolloutController.tick` by hand.
      window_s / window_max: the per-version sliding health window
        (same shape as the breaker's).
      drift_gates: a :class:`DriftGateConfig` adds prediction-
        distribution divergence as a first-class rollback gate next to
        error-rate and p99 (requires a tracker attached via
        ``engine.set_drift``; without one — or with None here — the
        gate is inert).
    """

    ladder: Tuple[float, ...] = (0.01, 0.05, 0.25, 1.0)
    min_requests: int = 50
    error_rate_tolerance: float = 0.02
    p99_tolerance_ratio: float = 1.5
    p99_slack_s: float = 0.050
    evaluate_interval_s: float = 0.25
    auto_evaluate: bool = True
    window_s: float = 60.0
    window_max: int = 2048
    drift_gates: Optional[DriftGateConfig] = None

    def __post_init__(self):
        if not self.ladder:
            raise ValueError("ladder must have at least one rung")
        if abs(self.ladder[-1] - 1.0) > 1e-9:
            raise ValueError(
                f"last rung must be 1.0 (full traffic), got {self.ladder}")
        prev = 0.0
        for w in self.ladder:
            if not 0.0 < w <= 1.0 or w <= prev - 1e-12:
                raise ValueError(
                    f"ladder must be ascending weights in (0, 1], "
                    f"got {self.ladder}")
            prev = w
        if self.min_requests < 1:
            raise ValueError("min_requests must be >= 1")


class VersionHealth:
    """Sliding window of one version's request outcomes.

    The breaker's window machinery (timestamped deque, prune on read)
    extended with latency so one structure answers both gate questions:
    error-rate and p99 over the recent past. ``total`` is cumulative —
    the controller snapshots it at each rung transition to count
    per-rung requests without clearing the window."""

    def __init__(self, window_s: float = 60.0, window_max: int = 2048):
        self.window_s = window_s
        self._events: Deque[Tuple[float, bool, float]] = deque(
            maxlen=window_max)
        self._total = 0
        self._lock = threading.Lock()

    def record(self, ok: bool, latency_s: float,
               now: Optional[float] = None) -> None:
        """Record one completed request (called from the engine's
        done-callback; deadline expiries are not outcomes, matching
        breaker semantics)."""
        now = monotonic_s() if now is None else now
        with self._lock:
            self._events.append((now, ok, latency_s))
            self._total += 1

    @property
    def total(self) -> int:
        """Cumulative recorded requests (never pruned)."""
        with self._lock:
            return self._total

    def _pruned(self, now: Optional[float]) -> List[Tuple[float, bool,
                                                          float]]:
        now = monotonic_s() if now is None else now
        horizon = now - self.window_s
        with self._lock:
            while self._events and self._events[0][0] < horizon:
                self._events.popleft()
            return list(self._events)

    def snapshot(self, now: Optional[float] = None) -> Dict[str, float]:
        """``{count, error_rate, p99_s}`` over the window (count=0 ⇒
        rates are 0)."""
        events = self._pruned(now)
        if not events:
            return {"count": 0, "error_rate": 0.0, "p99_s": 0.0}
        errors = sum(1 for _, ok, _ in events if not ok)
        lat = sorted(l for _, _, l in events)
        p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
        return {"count": len(events),
                "error_rate": errors / len(events),
                "p99_s": p99}


class RolloutState:
    """One model's active rollout (internal; JSON via ``describe``)."""

    def __init__(self, name: str, canary: str, incumbent: str,
                 ladder: Tuple[float, ...]):
        self.name = name
        self.canary = canary
        self.incumbent = incumbent
        self.ladder = ladder
        self.stage = 0                     # index into ladder
        self.stage_started_total = 0       # canary health.total at entry
        self.stage_started_s = monotonic_s()
        self.done = False                  # promoted or rolled back
        self.outcome: Optional[str] = None  # "promoted" | "rolled_back"
        self.reason: Optional[str] = None   # rollback reason

    def describe(self) -> Dict[str, object]:
        """JSON view of the rollout (``GET /v1/models/<name>``)."""
        return {
            "canary": self.canary,
            "incumbent": self.incumbent,
            "ladder": list(self.ladder),
            "stage": self.stage,
            "weight": self.ladder[self.stage] if not self.done else (
                1.0 if self.outcome == "promoted" else 0.0),
            "done": self.done,
            "outcome": self.outcome,
            "reason": self.reason,
        }


class RolloutController:
    """Drives every active canary of one engine.

    Owned by :class:`~analytics_zoo_tpu_torch.serving.engine.ServingEngine`
    (constructed when the engine gets a :class:`RolloutConfig`, or
    lazily on first admin ``start``). The engine calls :meth:`begin`
    from ``register`` when a new version lands while an incumbent is
    serving; the controller owns the router policy for that model until
    the rollout resolves."""

    def __init__(self, engine, config: Optional[RolloutConfig] = None):
        self.engine = engine
        self.config = config or RolloutConfig()
        self._states: Dict[str, RolloutState] = {}
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if self.config.auto_evaluate:
            self._thread = threading.Thread(
                target=self._run, name="zoo-rollout-evaluator", daemon=True)
            self._thread.start()

    # -- lifecycle --------------------------------------------------------

    def close(self) -> None:
        """Stop the evaluator thread (engine shutdown). Active rollouts
        freeze in place — state survives for inspection."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def poke(self) -> None:
        """Wake the evaluator now (the breaker-open listener calls this
        so a broken canary doesn't wait out the interval)."""
        self._wake.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=self.config.evaluate_interval_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.tick()
            except Exception:  # pragma: no cover - keep evaluator alive
                pass

    # -- rollout lifecycle ------------------------------------------------

    def begin(self, name: str, canary: str, incumbent: str) -> RolloutState:
        """Start a rollout: canary enters the ladder's first rung.

        A rollout already active for ``name`` is superseded — its canary
        is rolled back (reason ``superseded``) before the new one
        starts, mirroring hot-reload's newest-wins semantics."""
        with self._lock:
            prior = self._states.get(name)
        if prior is not None and not prior.done:
            self._rollback(prior, reason="superseded")
        state = RolloutState(name, canary, incumbent, self.config.ladder)
        with self._lock:
            self._states[name] = state
        health = self.engine.version_health(name, canary)
        if health is not None:
            state.stage_started_total = health.total
        self._apply_weights(state)
        self._transition_span(state, "start")
        self.engine.metrics.rollout_stage(name).set(0)
        return state

    def promote(self, name: str) -> None:
        """Admin: force-advance one rung (finalizes from the last rung),
        skipping the health gate."""
        state = self._active(name)
        self._advance(state, forced=True)

    def rollback(self, name: str, reason: str = "manual") -> None:
        """Admin: roll the active canary back now."""
        state = self._active(name)
        self._rollback(state, reason=reason)

    def _active(self, name: str) -> RolloutState:
        with self._lock:
            state = self._states.get(name)
        if state is None or state.done:
            raise KeyError(f"no active rollout for model {name!r}")
        return state

    def active(self, name: str) -> Optional[RolloutState]:
        """The model's active rollout state, or None."""
        with self._lock:
            state = self._states.get(name)
        return state if state is not None and not state.done else None

    def describe(self, name: str) -> Optional[Dict[str, object]]:
        """JSON view of the model's rollout (active or last resolved)."""
        with self._lock:
            state = self._states.get(name)
        return state.describe() if state is not None else None

    def protects(self, name: str, version: str) -> bool:
        """True while ``version`` is the canary or incumbent of an
        active rollout — retention must not retire it."""
        state = self.active(name)
        return state is not None and version in (state.canary,
                                                 state.incumbent)

    # -- evaluation -------------------------------------------------------

    def tick(self) -> None:
        """Evaluate every active rollout once: rollback on breaker-open
        or tolerance violation, promote when the gate passes, else
        hold. Deterministic — tests call this directly."""
        with self._lock:
            states = [s for s in self._states.values() if not s.done]
        for state in states:
            try:
                self._evaluate(state)
            except Exception:  # pragma: no cover - one model's failure
                pass           # must not starve the others' evaluation

    def _evaluate(self, state: RolloutState) -> None:
        # a breaker-open canary rolls back regardless of sample count
        if self.engine.breaker_open(state.name, state.canary):
            self._rollback(state, reason="breaker_open")
            return
        health = self.engine.version_health(state.name, state.canary)
        if health is None:  # canary vanished (manual unregister)
            self._rollback(state, reason="manual")
            return
        seen = health.total - state.stage_started_total
        if seen < self.config.min_requests:
            return  # hold: not enough evidence either way
        canary = health.snapshot()
        incumbent_health = self.engine.version_health(
            state.name, state.incumbent)
        incumbent = (incumbent_health.snapshot()
                     if incumbent_health is not None
                     else {"count": 0, "error_rate": 0.0, "p99_s": 0.0})
        cfg = self.config
        if canary["error_rate"] > (incumbent["error_rate"]
                                   + cfg.error_rate_tolerance):
            self._rollback(state, reason="error_rate")
            return
        # p99 gate only when the incumbent has a comparable window
        if incumbent["count"] > 0 and canary["p99_s"] > (
                incumbent["p99_s"] * cfg.p99_tolerance_ratio
                + cfg.p99_slack_s):
            self._rollback(state, reason="latency")
            return
        # drift gate: prediction-distribution divergence
        # between canary and incumbent on the same traffic. The engine
        # returns None while either side is under the gate's min_count
        # (or no tracker is attached) — the gate abstains, it never
        # blocks promotion for lack of a drift plane.
        if cfg.drift_gates is not None:
            scores = self.engine.drift_scores(
                state.name, state.canary, state.incumbent,
                min_count=cfg.drift_gates.min_count)
            if scores is not None and (scores.get("prediction_js", 0.0)
                                       > cfg.drift_gates.max_prediction_js):
                self._rollback(state, reason="drift")
                return
        self._advance(state, forced=False)

    # -- transitions ------------------------------------------------------

    def _apply_weights(self, state: RolloutState) -> None:
        weight = state.ladder[state.stage]
        self.engine.router.set_policy(state.name, {
            state.incumbent: 1.0 - weight,
            state.canary: weight,
        })

    def _advance(self, state: RolloutState, forced: bool) -> None:
        if state.stage + 1 < len(state.ladder):
            state.stage += 1
            health = self.engine.version_health(state.name, state.canary)
            state.stage_started_total = (health.total
                                         if health is not None else 0)
            state.stage_started_s = monotonic_s()
            self._apply_weights(state)
            self._transition_span(
                state, "promote_forced" if forced else "promote")
            self.engine.metrics.rollout_stage(state.name).set(state.stage)
        else:
            self._finalize(state)

    def _finalize(self, state: RolloutState) -> None:
        state.done = True
        state.outcome = "promoted"
        self.engine.router.clear_policy(state.name)
        self._transition_span(state, "finalize")
        self.engine.metrics.promotions(state.name).inc()
        self.engine.metrics.rollout_stage(state.name).set(
            len(state.ladder))
        # repoint latest + retire the old incumbent draining — exactly
        # the repoint hot-reload used to do, now gated on ladder health
        self.engine._finalize_rollout(state.name, state.canary,
                                      state.incumbent)

    def _rollback(self, state: RolloutState, reason: str) -> None:
        state.done = True
        state.outcome = "rolled_back"
        state.reason = reason
        self.engine.router.clear_policy(state.name)
        self._transition_span(state, f"rollback:{reason}")
        self.engine.metrics.rollbacks(state.name, reason).inc()
        self.engine.metrics.rollout_stage(state.name).set(-1)
        self.engine._retire_canary(state.name, state.canary)

    def _transition_span(self, state: RolloutState, event: str) -> None:
        tracer = get_tracer()
        now = monotonic_s()
        tracer.record_span(
            "serving.rollout_transition", new_trace_id(), now, now,
            model=state.name, canary=state.canary,
            incumbent=state.incumbent, event=event, stage=state.stage)
