"""Serving resilience — admission control, circuit breakers, watchdog, drain.

The reference's production story is Cluster Serving surviving real
traffic; the ROADMAP north star is "heavy traffic from millions of
users". Static backpressure (queue-full 429) and per-request deadlines
(504 at flush time) are not enough for that: under sustained overload
every queued request times out *after* consuming a queue slot and a
flush cycle, a broken model version burns flush cycles failing batches
forever, a flush thread killed by an unexpected escape silences a model
permanently, and there is no way to take a server out of rotation
without dropping in-flight work. Production fleets treat preemption
and partial failure as routine (PAPERS.md, arXiv:2204.06514); this
module gives the serving path the same stance, in four pieces:

- **Deadline-aware admission control** (:class:`AdmissionController`):
  an EWMA of per-batch service time times the current queue depth
  estimates a request's queue wait at ``submit``. A request whose
  deadline is already unmeetable is shed immediately —
  :class:`ShedError`, HTTP 429 with ``Retry-After`` — so under overload
  the queue holds only requests that can still be served in time.
  Goodput stays near capacity instead of collapsing into 504s.
- **Per-model circuit breaker** (:class:`CircuitBreaker`): a sliding
  window of predict outcomes drives closed → open (fast-fail
  :class:`CircuitOpenError`, HTTP 503, without touching the queue) →
  half-open probe → closed. One broken model version fails fast instead
  of consuming flush cycles and poisoning co-batched traffic.
- **Flush-thread watchdog** (:class:`FlushWatchdog`): a supervisor
  thread monitors per-batcher heartbeats, detects a dead or wedged
  flush thread, fails *only the in-flight batch*
  (:class:`FlushThreadRestartedError`), restarts the thread and counts
  ``zoo_serving_watchdog_restarts_total`` — service self-heals instead
  of silently dropping a model.
- **Graceful drain** (:meth:`ServingEngine.drain
  <analytics_zoo_tpu_torch.serving.engine.ServingEngine.drain>` +
  :func:`install_drain_on_preemption`): ``/healthz`` flips non-200 so
  load balancers stop routing, new submits get :class:`DrainingError`
  (503 + ``Retry-After``), and every queued and in-flight request
  completes before shutdown. SIGTERM wires in through
  :class:`~analytics_zoo_tpu_torch.ft.preemption.PreemptionHandler`.

Every state transition emits spans and metrics through the shared
observability layer (``zoo_serving_shed_total{reason}``,
``zoo_serving_breaker_state``, drain gauges), and every behavior here is
exercised by the in-process chaos matrix
(:mod:`analytics_zoo_tpu_torch.ft.chaos` serving points ``predict_raises`` /
``predict_slow`` / ``flush_thread_dies`` —
tests/test_serving_resilience.py). See docs/resilience.md.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

from analytics_zoo_tpu_torch.common.observability import (
    get_tracer,
    monotonic_s,
    new_trace_id,
)

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = [
    "AdmissionController",
    "BreakerConfig",
    "CircuitBreaker",
    "CircuitOpenError",
    "DrainingError",
    "FlushThreadRestartedError",
    "FlushWatchdog",
    "ResilienceConfig",
    "RetryableError",
    "ShedError",
    "install_drain_on_preemption",
]


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------


class RetryableError(RuntimeError):
    """Base for rejections the client should retry later; carries the
    ``Retry-After`` hint the HTTP layer puts on the response."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class ShedError(RetryableError):
    """Raised at ``submit`` by admission control: the estimated queue
    wait already exceeds the request's deadline, so serving it would
    only produce a 504 after consuming a flush cycle. HTTP 429 +
    ``Retry-After`` — distinct from
    :class:`~analytics_zoo_tpu_torch.serving.batcher.QueueFullError`, which
    is the hard queue-capacity bound."""


class CircuitOpenError(RetryableError):
    """Raised at ``submit`` while the model's circuit breaker is open
    (or out of half-open probe slots): recent predicts are failing at or
    above the configured ratio, so the request fast-fails without
    touching the queue. HTTP 503 + ``Retry-After``."""


class DrainingError(RetryableError):
    """Raised at ``submit`` while the engine is draining: already-queued
    and in-flight requests complete, new ones go elsewhere. HTTP 503 +
    ``Retry-After``."""


class FlushThreadRestartedError(RuntimeError):
    """Set on the in-flight batch's futures when the watchdog restarts a
    dead or wedged flush thread — only that batch fails; queued requests
    are served by the replacement thread."""


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Circuit-breaker tuning (see docs/resilience.md for guidance).

    Attributes:
      window_s: sliding-window length over predict outcomes.
      min_samples: outcomes required in the window before the failure
        ratio is acted on (a single early failure must not open).
      failure_ratio: open when ``failures / outcomes`` in the window
        reaches this.
      cooldown_s: time the breaker stays open before letting half-open
        probes through (also the ``Retry-After`` hint).
      half_open_probes: predicts allowed through while half-open; one
        success re-closes, one failure re-opens.
    """

    window_s: float = 30.0
    min_samples: int = 8
    failure_ratio: float = 0.5
    cooldown_s: float = 2.0
    half_open_probes: int = 1


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Engine-level resilience knobs
    (``ServingEngine(resilience=ResilienceConfig(...))``).

    Attributes:
      admission: deadline-aware admission control — shed requests whose
        deadline the queue-wait estimate already breaks (429 instead of
        a guaranteed 504). Only requests WITH a deadline are ever shed.
      ewma_alpha: smoothing factor of the per-batch service-time EWMA
        behind the estimate (higher = adapts faster, noisier).
      breaker: per-model circuit breaker config, or ``None`` to disable.
      watchdog: supervise flush threads (restart dead/wedged ones).
      watchdog_interval_s: supervisor poll period.
      watchdog_stall_s: a busy batcher whose flush thread has not
        heartbeat for this long is declared wedged and restarted — set
        it well above the model's worst-case batch service time.
      drain_retry_after_s: ``Retry-After`` hint on draining rejections.
    """

    admission: bool = True
    ewma_alpha: float = 0.3
    breaker: Optional[BreakerConfig] = BreakerConfig()
    watchdog: bool = True
    watchdog_interval_s: float = 0.25
    watchdog_stall_s: float = 30.0
    drain_retry_after_s: float = 5.0


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------


class AdmissionController:
    """Queue-wait estimator behind deadline-aware admission control.

    The batcher reports each successful flush's service time via
    :meth:`observe`; :meth:`estimate_wait_s` multiplies the EWMA by how
    many batches stand between a new request and its result. Before the
    first observation there is no estimate (``None``) and nothing is
    shed — admission control only ever acts on measured behavior."""

    def __init__(self, alpha: float = 0.3):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self._ewma: Optional[float] = None
        self._lock = threading.Lock()

    def observe(self, batch_seconds: float) -> None:
        """Fold one flush's service time (assembly + predict) into the
        EWMA."""
        with self._lock:
            if self._ewma is None:
                self._ewma = float(batch_seconds)
            else:
                self._ewma += self.alpha * (batch_seconds - self._ewma)

    @property
    def batch_seconds(self) -> Optional[float]:
        """Current EWMA of per-batch service seconds (None before any
        flush)."""
        return self._ewma

    def estimate_wait_s(self, batches_ahead: int) -> Optional[float]:
        """Estimated seconds until a request behind ``batches_ahead``
        batches gets its result; ``None`` while there is no service-time
        estimate yet."""
        ewma = self._ewma
        if ewma is None:
            return None
        return max(0, batches_ahead) * ewma


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------

#: ``zoo_serving_breaker_state`` gauge encoding.
BREAKER_STATES: Dict[str, float] = {"closed": 0.0, "half_open": 1.0,
                                    "open": 2.0}


class CircuitBreaker:
    """Per-model predict-outcome circuit breaker.

    The batcher calls :meth:`allow` at submit (fast-fail before the
    queue) and :meth:`record` once per flush outcome. States:

    - **closed** — everything admitted; outcomes tracked in a sliding
      ``window_s`` window. Reaching ``failure_ratio`` over at least
      ``min_samples`` outcomes opens the breaker.
    - **open** — every submit raises :class:`CircuitOpenError`
      immediately (no queue slot, no flush cycle) until ``cooldown_s``
      elapses.
    - **half-open** — up to ``half_open_probes`` requests are admitted
      as probes; the first recorded success re-closes, a failure
      re-opens (fresh cooldown).

    Transitions update ``zoo_serving_breaker_state`` /
    ``zoo_serving_breaker_transitions_total`` and emit a
    ``serving.breaker_transition`` span when the tracer is on."""

    def __init__(self, config: Optional[BreakerConfig] = None,
                 name: str = "model", metrics=None, listener=None):
        self.config = config or BreakerConfig()
        self.name = name
        self.metrics = metrics          # ModelMetrics or None
        # listener(name, old_state, new_state) fires on every transition,
        # INSIDE the breaker lock — it must only set a flag/Event and
        # return (the rollout controller uses it to wake its evaluator
        # the instant a canary's breaker opens, instead of waiting out
        # the evaluation interval)
        self.listener = listener
        self._events: "deque[Tuple[float, bool]]" = deque()
        self._state = "closed"
        self._opened_at = 0.0
        self._probes = 0
        self._lock = threading.Lock()
        if metrics is not None:
            metrics.breaker_state.set(BREAKER_STATES["closed"])

    @property
    def state(self) -> str:
        """``"closed"`` / ``"open"`` / ``"half_open"``."""
        return self._state

    def allow(self) -> None:
        """Admit one submit or raise :class:`CircuitOpenError`. An open
        breaker past its cooldown flips to half-open here, so the next
        caller becomes the probe."""
        with self._lock:
            if self._state == "closed":
                return
            now = time.monotonic()
            if self._state == "open":
                waited = now - self._opened_at
                if waited < self.config.cooldown_s:
                    self._shed(self.config.cooldown_s - waited)
                self._transition("half_open")
                self._probes = 0
            if self._probes < self.config.half_open_probes:
                self._probes += 1
                return
            self._shed(self.config.cooldown_s)

    def record(self, ok: bool) -> None:
        """Fold one flush outcome in (the batcher calls this after every
        predict success/failure; deadline expiries are not outcomes)."""
        with self._lock:
            now = time.monotonic()
            if self._state == "half_open":
                self._probes = 0
                if ok:
                    self._events.clear()
                    self._transition("closed")
                else:
                    self._opened_at = now
                    self._transition("open")
                return
            if self._state == "open":
                return  # a batch queued before the trip finished late
            self._events.append((now, ok))
            horizon = now - self.config.window_s
            while self._events and self._events[0][0] < horizon:
                self._events.popleft()
            n = len(self._events)
            if n >= self.config.min_samples:
                failures = sum(1 for _, o in self._events if not o)
                if failures / n >= self.config.failure_ratio:
                    self._opened_at = now
                    self._transition("open")

    # -- internals (call with the lock held) ------------------------------

    def _shed(self, retry_after_s: float):
        if self.metrics is not None:
            self.metrics.shed("breaker_open").inc()
        raise CircuitOpenError(
            f"circuit breaker for '{self.name}' is {self._state} — "
            "recent predicts are failing; retry after "
            f"{retry_after_s:.1f}s", retry_after_s=retry_after_s)

    def _transition(self, new_state: str):
        old, self._state = self._state, new_state
        logger.warning("serving breaker '%s': %s -> %s", self.name, old,
                       new_state)
        if self.metrics is not None:
            self.metrics.breaker_state.set(BREAKER_STATES[new_state])
            self.metrics.breaker_transition(new_state).inc()
        tracer = get_tracer()
        if tracer.enabled:
            t = monotonic_s()
            tracer.record_span("serving.breaker_transition", new_trace_id(),
                               t, t, model=self.name, from_state=old,
                               to_state=new_state)
        if self.listener is not None:
            try:
                self.listener(self.name, old, new_state)
            except Exception:  # pragma: no cover — listener bugs must
                pass           # never wedge the breaker


# ---------------------------------------------------------------------------
# Flush-thread watchdog
# ---------------------------------------------------------------------------


class FlushWatchdog:
    """Supervisor for batcher flush threads.

    Every ``interval_s`` it asks each watched batcher to check its own
    flush thread (:meth:`DynamicBatcher.check_flush_thread
    <analytics_zoo_tpu_torch.serving.batcher.DynamicBatcher.check_flush_thread>`):
    a dead thread (killed by an unexpected escape) or a wedged one (busy
    with no heartbeat for ``stall_s``) gets its in-flight batch failed
    and a replacement thread started, counted in
    ``zoo_serving_watchdog_restarts_total``. The supervisor itself is a
    daemon thread started lazily on the first :meth:`watch` and stopped
    by :meth:`stop` (``ServingEngine.shutdown`` does this)."""

    def __init__(self, interval_s: float = 0.25, stall_s: float = 30.0):
        self.interval_s = float(interval_s)
        self.stall_s = float(stall_s)
        self._batchers: Dict[int, Any] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def watch(self, batcher) -> None:
        """Start supervising ``batcher`` (idempotent)."""
        with self._lock:
            self._batchers[id(batcher)] = batcher
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name="zoo-serving-watchdog")
                self._thread.start()

    def unwatch(self, batcher) -> None:
        """Stop supervising ``batcher`` (no-op if unknown)."""
        with self._lock:
            self._batchers.pop(id(batcher), None)

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the supervisor thread and forget every batcher."""
        self._stop.set()
        with self._lock:
            thread, self._thread = self._thread, None
            self._batchers.clear()
        if thread is not None:
            thread.join(timeout=timeout)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            with self._lock:
                batchers = list(self._batchers.values())
            for b in batchers:
                try:
                    reason = b.check_flush_thread(self.stall_s)
                except Exception:  # noqa: BLE001 — supervisor must survive
                    logger.exception("watchdog check failed for batcher %r",
                                     getattr(b, "name", b))
                    continue
                if reason:
                    logger.warning(
                        "watchdog restarted flush thread of '%s': %s",
                        getattr(b, "name", "?"), reason)


# ---------------------------------------------------------------------------
# Drain-on-preemption
# ---------------------------------------------------------------------------


def install_drain_on_preemption(engine, handler=None,
                                deadline_s: float = 30.0,
                                shutdown: bool = True):
    """Wire SIGTERM/SIGINT to a graceful serving drain.

    The serving counterpart of training's save-then-exit: when the
    scheduler's signal arrives, ``/healthz`` flips non-200 (load
    balancers stop routing), new submits get 503 + ``Retry-After``, and
    queued + in-flight requests complete (``engine.drain(deadline_s)``)
    before ``engine.shutdown()`` (skipped with ``shutdown=False``).

    ``handler``: a :class:`~analytics_zoo_tpu_torch.ft.preemption
    .PreemptionHandler` to reuse (e.g. one shared with a training loop);
    ``None`` installs a fresh one (main thread only — a ``signal``
    constraint). Returns ``(handler, waiter_thread)``; the daemon waiter
    blocks on the preemption flag, so a programmatic
    ``handler.request()`` drains too (how tests drive it)."""
    from analytics_zoo_tpu_torch.ft.preemption import PreemptionHandler

    if handler is None:
        handler = PreemptionHandler().install()

    def _wait_and_drain():
        handler.wait()
        logger.warning("preemption flagged: draining serving engine "
                       "(deadline %.1fs)", deadline_s)
        try:
            engine.drain(deadline_s=deadline_s)
        finally:
            if shutdown:
                engine.shutdown(drain=True)

    t = threading.Thread(target=_wait_and_drain, daemon=True,
                         name="zoo-serving-drain")
    t.start()
    return handler, t
