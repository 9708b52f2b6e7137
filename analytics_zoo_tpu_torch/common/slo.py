"""SLO burn-rate engine: declarative objectives, multi-window evaluation.

"Is the service healthy" must be a computed answer, not a human
eyeballing raw ``/metrics``. This module turns the existing Counter and
Summary families into that answer the way SRE practice does it
(multi-window multi-burn-rate alerting): each
:class:`SLOObjective` declares a target — availability (fraction of
requests that do not fail) or latency-threshold (fraction of requests
under a bound) — and the :class:`SLOEngine` accumulates per-request
good/bad outcomes into coarse time bins, then evaluates **burn rate**
(the rate at which the error budget ``1 - target`` is being consumed)
over paired fast/slow windows:

=========  =========  ==============  =======================================
fast       slow       alert at burn   meaning
=========  =========  ==============  =======================================
5m         1h         > 14.4          budget gone in ~2 days — page now
30m        6h         > 6.0           budget gone in ~5 days — page soon
=========  =========  ==============  =======================================

An alert fires only when *both* windows of a pair burn over threshold —
the fast window makes it prompt, the slow window makes it robust to
blips — and is edge-triggered into ``zoo_slo_alerts_total`` (one
increment per onset, re-armed when the condition clears).

The clock is injectable, so the whole engine is testable with a fake
clock and zero sleeps; production uses ``time.monotonic``. Evaluation
is pulled, not threaded: callers (``engine.metrics_text()``, the
``/v1/debug/slo`` endpoints) run :meth:`SLOEngine.evaluate` at read
time, which refreshes the ``zoo_slo_error_budget_remaining`` and
``zoo_slo_burn_rate`` gauges and returns the full report — including,
per objective, the last bad request's trace id, which resolves against
the cross-process trace collection (``/v1/debug/traces/<id>``) so a
burning SLO links to a concrete timeline.

See docs/observability.md ("SLO engine") for objective tuning and the
burn-rate table.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch.common.observability import (
    MetricsRegistry,
    get_registry,
)

__all__ = [
    "DEFAULT_PAIRS",
    "SLOEngine",
    "SLOObjective",
    "WindowPair",
]


class WindowPair:
    """One fast/slow window pair with its burn-rate alert threshold."""

    __slots__ = ("fast_s", "fast_label", "slow_s", "slow_label",
                 "threshold")

    def __init__(self, fast_s: float, fast_label: str, slow_s: float,
                 slow_label: str, threshold: float):
        self.fast_s = fast_s
        self.fast_label = fast_label
        self.slow_s = slow_s
        self.slow_label = slow_label
        self.threshold = threshold


#: The SRE-standard pairs: page-now (5m/1h @ 14.4x) and page-soon
#: (30m/6h @ 6x).
DEFAULT_PAIRS = (WindowPair(300.0, "5m", 3600.0, "1h", 14.4),
                 WindowPair(1800.0, "30m", 21600.0, "6h", 6.0))


class SLOObjective:
    """One declarative objective.

    ``kind`` is ``availability`` (good = the request did not fail) or
    ``latency`` (good = end-to-end latency <= ``latency_threshold_s``).
    The classification itself happens at the recording site — the engine
    only sees good/bad — so one finished request feeds both kinds.
    ``target`` is the good fraction promised (0.999 = "three nines");
    the error budget is ``1 - target``.
    """

    __slots__ = ("name", "kind", "target", "latency_threshold_s",
                 "description")

    def __init__(self, name: str, kind: str = "availability",
                 target: float = 0.999,
                 latency_threshold_s: Optional[float] = None,
                 description: str = ""):
        if kind not in ("availability", "latency"):
            raise ValueError(f"unknown objective kind {kind!r}")
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        if kind == "latency" and latency_threshold_s is None:
            raise ValueError(
                f"latency objective {name!r} needs latency_threshold_s")
        self.name = name
        self.kind = kind
        self.target = target
        self.latency_threshold_s = latency_threshold_s
        self.description = description


class _Bins:
    """Per-objective (good, bad) counts in coarse time bins keyed by
    ``int(now // bin_s)``, pruned past the horizon. Coarse bins make
    window queries O(window / bin_s) with bounded memory — the engine
    never stores per-request data."""

    __slots__ = ("bin_s", "horizon_s", "bins")

    def __init__(self, bin_s: float, horizon_s: float):
        self.bin_s = bin_s
        self.horizon_s = horizon_s
        self.bins: Dict[int, List[float]] = {}

    def add(self, now: float, good: bool) -> None:
        b = self.bins.setdefault(int(now // self.bin_s), [0.0, 0.0])
        b[0 if good else 1] += 1.0
        if len(self.bins) > (self.horizon_s / self.bin_s) + 2:
            floor = int((now - self.horizon_s) // self.bin_s)
            for k in [k for k in self.bins if k < floor]:
                del self.bins[k]

    def window(self, now: float, window_s: float) -> Tuple[float, float]:
        """(good, bad) totals over the trailing window. The bin holding
        the window edge is included whole — acceptable slack at bin
        granularity."""
        floor = int((now - window_s) // self.bin_s)
        ceil = int(now // self.bin_s)
        good = bad = 0.0
        for k, (g, b) in self.bins.items():
            if floor <= k <= ceil:
                good += g
                bad += b
        return good, bad


class SLOEngine:
    """Accumulates good/bad outcomes per objective and evaluates
    multi-window burn rates on demand.

    Args:
      registry: where the ``zoo_slo_*`` families live (default: the
        process-global registry; the front door passes its own).
      clock: monotonic-seconds callable — injectable so tests drive the
        windows with a fake clock and zero sleeps.
      pairs: the fast/slow window pairs to evaluate.
      bin_s: accumulation bin width; must be well under the fastest
        window (default 10s against a 5m fast window).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 clock: Optional[Callable[[], float]] = None,
                 pairs: Tuple[WindowPair, ...] = DEFAULT_PAIRS,
                 bin_s: float = 10.0):
        reg = registry if registry is not None else get_registry()
        self._clock = clock if clock is not None else time.monotonic
        self._pairs = tuple(pairs)
        self._bin_s = bin_s
        self._horizon_s = max(p.slow_s for p in self._pairs)
        self._lock = threading.Lock()
        self._objectives: Dict[str, SLOObjective] = {}
        self._bins: Dict[str, _Bins] = {}
        self._last_bad_trace: Dict[str, str] = {}
        self._alerting: Dict[Tuple[str, str], bool] = {}
        self._budget_fam = reg.gauge(
            "zoo_slo_error_budget_remaining",
            "Fraction of the error budget left over the longest window "
            "(1 = untouched, 0 = spent, negative = overspent).",
            labels=("objective",))
        self._burn_fam = reg.gauge(
            "zoo_slo_burn_rate",
            "Error-budget burn rate per evaluation window (1.0 = "
            "spending exactly the budget; the alert thresholds are "
            "14.4x fast / 6x slow).",
            labels=("objective", "window"))
        self._alerts_fam = reg.counter(
            "zoo_slo_alerts_total",
            "Burn-rate alert onsets (both windows of a pair over "
            "threshold; edge-triggered), labeled by the pair's fast "
            "window.",
            labels=("objective", "window"))

    def add_objective(self, obj: SLOObjective) -> SLOObjective:
        """Register an objective (idempotent by name; the first
        registration wins)."""
        with self._lock:
            existing = self._objectives.get(obj.name)
            if existing is not None:
                return existing
            self._objectives[obj.name] = obj
            self._bins[obj.name] = _Bins(self._bin_s, self._horizon_s)
            return obj

    def objectives(self) -> List[SLOObjective]:
        """Registered objectives, registration-ordered."""
        with self._lock:
            return list(self._objectives.values())

    def record(self, name: str, good: bool,
               trace_id: Optional[str] = None) -> None:
        """Record one finished request against objective ``name``
        (unknown names are ignored — recording sites must not need the
        objective list). A bad outcome's ``trace_id`` is remembered as
        the objective's exemplar link into trace collection."""
        now = self._clock()
        with self._lock:
            bins = self._bins.get(name)
            if bins is None:
                return
            bins.add(now, good)
            if not good and trace_id is not None:
                self._last_bad_trace[name] = trace_id

    def record_outcome(self, model: str, ok: bool,
                       latency_s: Optional[float] = None,
                       trace_id: Optional[str] = None,
                       prefix: str = "") -> None:
        """Convenience for serving recording sites: feeds
        ``{prefix}availability:{model}`` with ``ok`` and, when a latency
        objective with that naming exists and the request succeeded,
        ``{prefix}latency:{model}`` with the threshold comparison."""
        self.record(f"{prefix}availability:{model}", ok, trace_id=trace_id)
        if latency_s is None or not ok:
            return
        lname = f"{prefix}latency:{model}"
        with self._lock:
            obj = self._objectives.get(lname)
        if obj is not None and obj.latency_threshold_s is not None:
            self.record(lname, latency_s <= obj.latency_threshold_s,
                        trace_id=trace_id)

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Evaluate every objective over every window NOW: refresh the
        burn/budget gauges, fire edge-triggered alert increments, and
        return the full report (the ``/v1/debug/slo`` body)."""
        t = self._clock() if now is None else now
        with self._lock:
            objs = list(self._objectives.values())
        report: List[Dict[str, Any]] = []
        for obj in objs:
            budget = 1.0 - obj.target
            with self._lock:
                bins = self._bins[obj.name]
                windows: Dict[str, Tuple[float, float]] = {}
                for p in self._pairs:
                    for label, w in ((p.fast_label, p.fast_s),
                                     (p.slow_label, p.slow_s)):
                        if label not in windows:
                            windows[label] = bins.window(t, w)
                last_bad = self._last_bad_trace.get(obj.name)
            win_report: Dict[str, Dict[str, float]] = {}
            burns: Dict[str, float] = {}
            for label, (good, bad) in windows.items():
                total = good + bad
                bad_frac = (bad / total) if total else 0.0
                burn = bad_frac / budget
                burns[label] = burn
                self._burn_fam.labels(objective=obj.name,
                                      window=label).set(burn)
                win_report[label] = {"total": total, "bad": bad,
                                     "burn_rate": burn}
            alerting: List[str] = []
            for p in self._pairs:
                over = (burns[p.fast_label] > p.threshold
                        and burns[p.slow_label] > p.threshold)
                key = (obj.name, p.fast_label)
                was = self._alerting.get(key, False)
                if over and not was:
                    self._alerts_fam.labels(objective=obj.name,
                                            window=p.fast_label).inc()
                self._alerting[key] = over
                if over:
                    alerting.append(p.fast_label)
            # budget remaining over the longest (slowest) window
            slow_label = max(self._pairs, key=lambda p: p.slow_s).slow_label
            good, bad = windows[slow_label]
            total = good + bad
            bad_frac = (bad / total) if total else 0.0
            remaining = 1.0 - bad_frac / budget
            self._budget_fam.labels(objective=obj.name).set(remaining)
            report.append({
                "name": obj.name,
                "kind": obj.kind,
                "target": obj.target,
                "latency_threshold_s": obj.latency_threshold_s,
                "error_budget_remaining": remaining,
                "windows": win_report,
                "alerting": alerting,
                "last_bad_trace_id": last_bad,
            })
        return {"objectives": report, "evaluated_at": t,
                "pairs": [{"fast": p.fast_label, "slow": p.slow_label,
                           "threshold": p.threshold}
                          for p in self._pairs]}
