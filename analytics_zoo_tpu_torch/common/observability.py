"""Unified observability (port of ``analytics_zoo_tpu.common.observability``):
span tracing, a global metrics registry, and compile-event accounting.

- **Span tracing** (:class:`Tracer`): hierarchical wall-clock spans with
  ``contextvars`` propagation and per-request trace IDs, exported as
  Chrome trace-event JSON (open in Perfetto / ``chrome://tracing``).
  Host-side and cross-thread — the complement of ``torch.profiler`` device
  traces, which cannot see queue waits, batch assembly or Python-side
  dispatch. Disabled by default; a disabled tracer's ``span()`` is one
  attribute check and a shared no-op context manager, so instrumented
  hot paths (the serving request lifecycle) pay nothing measurable.
- **Metrics** (:class:`MetricsRegistry`): labeled ``Counter`` /
  ``Gauge`` / ``Summary`` families with Prometheus text exposition
  (label values escaped per the text-format grammar). The process-global
  registry (:func:`get_registry`) carries the inference executable-cache
  counters (``zoo_inference_cache_events_total``), the compile accounting
  below, ``zoo_build_info`` and the ``zoo_process_*`` gauges; the serving
  layer keeps its families in a per-engine registry (see
  :mod:`analytics_zoo_tpu_torch.serving.metrics`) and one HTTP
  ``/metrics`` scrape renders both.
- **Compile accounting** (:func:`install_compile_listener`): feeds
  ``zoo_compile_total`` / ``zoo_compile_seconds_total`` from the port's
  own compiles — each ``nvcc`` build of a CUDA kernel source
  (:func:`analytics_zoo_tpu_torch.ops._kernels.build`) and each CUDA graph
  capture of an ``InferenceModel`` bucket — so a serve-time recompile is
  observable process-wide.

- **Tier families** in the global registry, one call per owner:
  :func:`checkpoint_metrics` (``CheckpointManager``),
  :func:`training_metrics` (``Estimator.train``) and
  :func:`hot_reload_metrics` (``CheckpointWatcher``).

- :func:`data_metrics` (``zoo_data_*``, one call per streaming
  :class:`~analytics_zoo_tpu_torch.data.pipeline.Pipeline` epoch) and
  :func:`batch_metrics` (``zoo_batch_*``, one call per
  :class:`~analytics_zoo_tpu_torch.batch.runner.BatchJobRunner`, whose
  job and shards are the ``batch.job`` and ``batch.shard`` spans).

- The online-learning flywheel's families, one call per owner:
  :func:`capture_metrics` (``zoo_capture_*``, ``CaptureTap``),
  :func:`flywheel_metrics` (``zoo_flywheel_*``, ``FlywheelTrainer`` and
  ``FlywheelController``), :func:`label_metrics` (``zoo_label_*``,
  ``LabelStore``) and :func:`drift_metrics` (``zoo_drift_*``,
  ``DriftDetector`` and ``PredictionTracker``).

- :func:`distributed_metrics` (``zoo_dist_*``, one call per
  ``Estimator.train_distributed``); the two-phase sharded commit also
  counts ``zoo_checkpoint_sweeps_total{kind="orphan_shard"|"dist_abort"}``.

The JAX package's persistent AOT cache counters
(``zoo_serving_aot_cache_events_total``) have no port: the port keeps no
persistent executable cache (``inference.inference_model.NO_AOT_CACHE``).
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import re
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from analytics_zoo_tpu_torch.common.profiling import StepTimer

__all__ = [
    "Counter",
    "Gauge",
    "Summary",
    "MetricFamily",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "get_registry",
    "get_tracer",
    "span",
    "current_trace_id",
    "new_trace_id",
    "install_compile_listener",
    "process_metrics",
    "refresh_process_metrics",
    "build_info",
    "wall_anchor",
    "parse_traceparent",
    "format_traceparent",
    "inference_cache_counters",
    "data_metrics",
    "batch_metrics",
    "capture_metrics",
    "flywheel_metrics",
    "label_metrics",
    "drift_metrics",
]


# ---------------------------------------------------------------------------
# Metric primitives (promoted out of serving/metrics.py — serving keeps its
# public surface as an adapter over these)
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic event counter (thread-safe). Values are floats so the
    same primitive counts events and accumulates seconds
    (``zoo_compile_seconds_total``)."""

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1):
        """Add ``n`` (default 1); negative increments are rejected —
        counters only go up (reset means process restart)."""
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        """Current count."""
        return self._value


class Gauge:
    """Point-in-time value, e.g. current queue depth (thread-safe)."""

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float):
        """Replace the current value."""
        with self._lock:
            self._value = float(value)

    def inc(self, n: float = 1):
        """Adjust the current value by ``n`` (may be negative)."""
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        """Current value."""
        return self._value


class Summary:
    """Streaming distribution: count, sum, and p50/p95/p99 over a bounded
    reservoir of the newest ``max_samples`` observations. The percentile
    math is :class:`~analytics_zoo_tpu_torch.common.profiling.StepTimer`'s
    (``warmup=0`` — every observation counts).

    Observations may carry a **trace id exemplar** — the exposition then
    annotates each quantile sample with the most recent trace at or above
    that quantile, so a burning latency SLO links straight to a concrete
    collected trace instead of an anonymous percentile."""

    #: Recent (value, trace_id) pairs kept for exemplar selection — small
    #: because an exemplar only needs to be *recent and representative*,
    #: not a reservoir.
    EXEMPLAR_RING = 64

    def __init__(self, max_samples: int = 8192):
        self._timer = StepTimer(warmup=0, max_samples=max_samples)
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._exemplars: "deque[Tuple[float, str]]" = \
            deque(maxlen=self.EXEMPLAR_RING)

    def observe(self, value: float, trace_id: Optional[str] = None):
        """Record one observation (seconds for latencies, a ratio for
        fill); ``trace_id`` attaches an exemplar."""
        with self._lock:
            self._count += 1
            self._sum += value
            self._timer.record(value)
            if trace_id is not None:
                self._exemplars.append((value, trace_id))

    def observe_many(self, values, trace_ids=None) -> None:
        """Record a batch of observations under one lock acquisition —
        the hot-path form for per-request samples recorded once per
        batcher flush. ``trace_ids`` (parallel to ``values``, entries may
        be None) attaches exemplars."""
        with self._lock:
            for i, v in enumerate(values):
                self._count += 1
                self._sum += v
                self._timer.record(v)
                if trace_ids is not None and trace_ids[i] is not None:
                    self._exemplars.append((v, trace_ids[i]))

    def exemplar_for(self, threshold: float) -> Optional[Tuple[float, str]]:
        """The most recent ``(value, trace_id)`` exemplar at or above
        ``threshold`` (a quantile value at render time); falls back to the
        largest recent exemplar when none reaches it, and None when no
        traced observation was ever recorded."""
        with self._lock:
            pairs = list(self._exemplars)
        best: Optional[Tuple[float, str]] = None
        for v, tid in reversed(pairs):
            if v >= threshold:
                return (v, tid)
            if best is None or v > best[0]:
                best = (v, tid)
        return best

    @property
    def count(self) -> int:
        """Total observations (including any aged out of the reservoir)."""
        return self._count

    @property
    def sum(self) -> float:
        """Sum of all observations (including aged-out ones)."""
        return self._sum

    @property
    def mean(self) -> float:
        """sum/count over the full stream; 0.0 before any observation."""
        return self._sum / self._count if self._count else 0.0

    def percentiles(self) -> Dict[str, float]:
        """``{"mean_s", "p50_s", "p95_s", "p99_s"}`` over the reservoir
        (StepTimer's summary keys); empty dict before any observation."""
        with self._lock:
            return self._timer.summary()


def _escape_label_value(value: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote and newline (exposition format spec) — model names are
    user-controlled strings and MUST NOT break the scrape."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


_KIND_CLASSES = {"counter": Counter, "gauge": Gauge, "summary": Summary}


class MetricFamily:
    """One named metric family (``zoo_serving_requests_total``): a HELP
    string, a TYPE, fixed label names, and one child metric per distinct
    label-value tuple. Created via :class:`MetricsRegistry`, not
    directly."""

    def __init__(self, name: str, help_text: str, kind: str,
                 label_names: Sequence[str]):
        if kind not in _KIND_CLASSES:
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = name
        self.help = help_text
        self.kind = kind
        self.label_names = tuple(label_names)
        self._children: "Dict[Tuple[str, ...], Any]" = {}
        self._lock = threading.Lock()

    def labels(self, **label_values: str):
        """The child metric for this label-value combination (lazily
        created). Label names must match the family's exactly::

            registry.counter("reqs", "...", labels=("model",))
                    .labels(model="ncf").inc()
        """
        if tuple(sorted(label_values)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"family '{self.name}' takes labels {self.label_names}, "
                f"got {tuple(sorted(label_values))}")
        key = tuple(str(label_values[n]) for n in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _KIND_CLASSES[self.kind]()
                self._children[key] = child
            return child

    def child(self):
        """The single unlabeled child (families declared with no labels)."""
        if self.label_names:
            raise ValueError(
                f"family '{self.name}' is labeled {self.label_names} — "
                "use .labels(...)")
        return self.labels()

    def _label_str(self, key: Tuple[str, ...], extra: str = "") -> str:
        parts = [f'{n}="{_escape_label_value(v)}"'
                 for n, v in zip(self.label_names, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render(self) -> List[str]:
        """This family's exposition block: ``# HELP`` / ``# TYPE`` then one
        sample line per child (summaries add quantile/_sum/_count samples;
        quantile samples of summaries that recorded traced observations
        carry an OpenMetrics-style exemplar suffix,
        ``... # {trace_id="<id>"} <value>``)."""
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            items = sorted(self._children.items())
        for key, child in items:
            if self.kind == "summary":
                pct = child.percentiles()
                for q, k in (("0.5", "p50_s"), ("0.95", "p95_s"),
                             ("0.99", "p99_s")):
                    quantile = 'quantile="%s"' % q
                    qv = pct.get(k, 0.0)
                    line = (f'{self.name}{self._label_str(key, quantile)} '
                            f'{qv:g}')
                    ex = child.exemplar_for(qv)
                    if ex is not None:
                        line += (f' # {{trace_id="'
                                 f'{_escape_label_value(ex[1])}"}} {ex[0]:g}')
                    lines.append(line)
                lines.append(
                    f"{self.name}_sum{self._label_str(key)} {child.sum:g}")
                lines.append(
                    f"{self.name}_count{self._label_str(key)} {child.count}")
            else:
                lines.append(
                    f"{self.name}{self._label_str(key)} {child.value:g}")
        return lines

    def snapshot(self) -> Dict[Tuple[str, ...], float]:
        """``{label-value tuple: value}`` (summaries report the mean) —
        the JSON-side view."""
        with self._lock:
            items = list(self._children.items())
        return {key: (c.mean if self.kind == "summary" else c.value)
                for key, c in items}


class MetricsRegistry:
    """An ordered collection of :class:`MetricFamily` with one Prometheus
    text exposition. Registration is idempotent by name (the same family
    is returned), but re-registering under a different kind or label set
    is an error — two writers disagreeing on a family's schema is a bug,
    not a merge."""

    def __init__(self):
        self._families: "Dict[str, MetricFamily]" = {}
        self._lock = threading.Lock()

    def _family(self, name: str, help_text: str, kind: str,
                labels: Sequence[str]) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_names != tuple(labels):
                    raise ValueError(
                        f"family '{name}' already registered as {fam.kind}"
                        f"{fam.label_names}, not {kind}{tuple(labels)}")
                return fam
            fam = MetricFamily(name, help_text, kind, labels)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_text: str,
                labels: Sequence[str] = ()) -> MetricFamily:
        """Register (or fetch) a counter family."""
        return self._family(name, help_text, "counter", labels)

    def gauge(self, name: str, help_text: str,
              labels: Sequence[str] = ()) -> MetricFamily:
        """Register (or fetch) a gauge family."""
        return self._family(name, help_text, "gauge", labels)

    def summary(self, name: str, help_text: str,
                labels: Sequence[str] = ()) -> MetricFamily:
        """Register (or fetch) a summary family."""
        return self._family(name, help_text, "summary", labels)

    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4) of every family, in
        registration order — each family's HELP/TYPE header precedes all
        of its samples, as the text-format grammar requires."""
        with self._lock:
            fams = list(self._families.values())
        lines: List[str] = []
        for fam in fams:
            lines.extend(fam.render())
        return "\n".join(lines) + "\n" if lines else ""

    def snapshot(self) -> Dict[str, Dict[Tuple[str, ...], float]]:
        """``{family name: {label tuple: value}}`` for JSON consumers."""
        with self._lock:
            fams = list(self._families.items())
        return {name: fam.snapshot() for name, fam in fams}


_global_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-global registry (training / inference-cache / compile
    families live here; serving engines keep per-instance registries).
    First call also installs the compile-event listener."""
    global _global_registry
    with _registry_lock:
        if _global_registry is None:
            _global_registry = MetricsRegistry()
    install_compile_listener(_global_registry)
    return _global_registry


# ---------------------------------------------------------------------------
# Compile-event accounting (nvcc builds and CUDA graph captures)
# ---------------------------------------------------------------------------

_compile_listener_installed = False


def install_compile_listener(
        registry: Optional[MetricsRegistry] = None) -> bool:
    """Feed ``zoo_compile_total`` (compiles) and
    ``zoo_compile_seconds_total`` (wall seconds spent compiling) in
    ``registry`` (default: the global one) from the port's compile hook
    (:func:`analytics_zoo_tpu_torch.ops._kernels.add_compile_listener`):
    every fresh ``nvcc`` build of a kernel source and every CUDA graph
    capture. Idempotent — the listener is process-global and installs
    once; returns True when this call installed it. Compiles that
    happened before installation are not back-counted."""
    global _compile_listener_installed
    from analytics_zoo_tpu_torch.ops import _kernels

    reg = registry if registry is not None else get_registry()
    compiles = reg.counter(
        "zoo_compile_total",
        "Compiles observed process-wide (nvcc kernel builds and CUDA "
        "graph captures).").labels()
    seconds = reg.counter(
        "zoo_compile_seconds_total",
        "Wall seconds spent compiling (nvcc builds and CUDA graph "
        "captures) process-wide.").labels()
    with _registry_lock:
        if _compile_listener_installed:
            return False
        _compile_listener_installed = True

    def _on_compile(duration_secs: float) -> None:
        compiles.inc(1)
        seconds.inc(duration_secs)

    _kernels.add_compile_listener(_on_compile)
    return True


# ---------------------------------------------------------------------------
# Span tracing
# ---------------------------------------------------------------------------

# One process-wide monotonic origin so every span (any thread, any
# tracer) shares a time base; chrome ts is microseconds from this origin.
_T0 = time.perf_counter()
_id_counter = itertools.count(1)
_id_lock = threading.Lock()


def new_trace_id() -> str:
    """A fresh 16-hex-char trace id (random, collision-safe enough for
    in-process correlation; returned to HTTP clients as
    ``X-Zoo-Trace-Id``)."""
    return os.urandom(8).hex()


# W3C trace-context interop: external proxies and load balancers speak
# `traceparent: 00-<32 hex trace-id>-<16 hex parent-id>-<2 hex flags>`.
# Our ids are 64-bit (16 hex); the W3C convention for shorter ids is
# zero-extension on the left, so outgoing we pad and incoming we take the
# low 64 bits.
_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def parse_traceparent(header: str) -> Optional[str]:
    """Extract our 16-hex trace id from a W3C ``traceparent`` header
    value (the low 64 bits of its 128-bit trace-id field), or None when
    the header is malformed or carries an all-zero id (invalid per the
    spec)."""
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if not m:
        return None
    trace_id = m.group(1)[16:]
    if trace_id == "0" * 16 or m.group(1) == "0" * 32:
        return None
    return trace_id


def format_traceparent(trace_id: str) -> str:
    """Render our 16-hex trace id as an outgoing W3C ``traceparent``
    value: version 00, the id zero-extended to 128 bits, the id itself
    as the parent-id field (deterministic — we do not track a distinct
    span id at the HTTP boundary), and the sampled flag."""
    return f"00-{'0' * 16}{trace_id}-{trace_id}-01"


def _new_span_id() -> int:
    with _id_lock:
        return next(_id_counter)


class Span:
    """One timed operation: name, trace/span/parent ids, start/duration
    (seconds from the process origin) and free-form ``attrs``. Create via
    :meth:`Tracer.span`; mutate ``attrs`` inside the ``with`` block to
    annotate (cache hit/miss, batch size, status code)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "duration", "attrs", "thread")

    def __init__(self, name: str, trace_id: str,
                 parent_id: Optional[int] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.start = time.perf_counter() - _T0
        self.duration = 0.0
        self.attrs: Dict[str, Any] = attrs or {}
        self.thread = threading.get_ident()

    @property
    def end(self) -> float:
        """Span end, seconds from the process origin."""
        return self.start + self.duration

    def to_event(self) -> Dict[str, Any]:
        """This span as one Chrome trace-event (``ph: "X"`` complete
        event, microsecond timestamps)."""
        args = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id is not None:
            args["parent_id"] = self.parent_id
        args.update(self.attrs)
        return {"name": self.name, "ph": "X", "cat": "zoo",
                "ts": round(self.start * 1e6, 3),
                "dur": round(self.duration * 1e6, 3),
                "pid": os.getpid(), "tid": self.thread, "args": args}

    def to_dict(self) -> Dict[str, Any]:
        """Plain-JSON view for the ``/v1/debug/traces`` endpoints —
        timestamps stay on this process's monotonic base (seconds from
        its origin; pair with :func:`wall_anchor` to align across
        processes)."""
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start": self.start, "duration": self.duration,
                "thread": self.thread, "attrs": dict(self.attrs)}


class _NullSpanCtx:
    """The shared no-op context manager a disabled tracer hands out —
    allocation-free, so `with tracer.span(...)` costs one attribute check
    plus two trivial calls when tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullSpanCtx()


class _SpanCtx:
    """Context manager for one live span: installs the span as the
    contextvar current on enter, records duration and retires it on
    exit."""

    __slots__ = ("_tracer", "_span", "_token", "_t0")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._token = self._tracer._current.set(self._span)
        # re-anchor start to the same instant the duration clock starts,
        # so end == the real exit time (construction may precede enter)
        self._t0 = time.perf_counter()
        self._span.start = self._t0 - _T0
        return self._span

    def __exit__(self, exc_type, exc, tb):
        self._span.duration = time.perf_counter() - self._t0
        if exc_type is not None:
            self._span.attrs.setdefault("error", exc_type.__name__)
        self._tracer._current.reset(self._token)
        self._tracer._retire(self._span)
        return False


class Tracer:
    """Span collector: hierarchical ``with tracer.span("name"):`` blocks
    with ``contextvars`` parent propagation, a bounded ring buffer of
    finished spans, and Chrome trace-event export.

    Disabled by default — production serving should only pay for tracing
    while an operator is looking. ``enable()`` before the traffic/run of
    interest, ``export_chrome_trace(path)`` after, open in Perfetto.

    Cross-thread work (the serving flush thread finishing spans for
    requests submitted elsewhere) uses :meth:`record_span` with explicit
    timestamps instead of the context manager.
    """

    def __init__(self, max_spans: int = 65536):
        self.max_spans = max_spans
        self._spans: "deque[Span]" = deque(maxlen=max_spans)
        self._lock = threading.Lock()
        self._current: "contextvars.ContextVar[Optional[Span]]" = \
            contextvars.ContextVar("zoo_current_span", default=None)
        self.enabled = False

    def enable(self) -> "Tracer":
        """Start collecting spans."""
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        """Stop collecting (already-collected spans stay exportable)."""
        self.enabled = False
        return self

    def clear(self):
        """Drop every collected span."""
        with self._lock:
            self._spans.clear()

    def current(self) -> Optional[Span]:
        """The innermost live span on this thread/context (None outside
        any ``span()`` block or when tracing never started one)."""
        return self._current.get()

    def current_trace_id(self) -> Optional[str]:
        """Trace id of the innermost live span, or None."""
        cur = self._current.get()
        return cur.trace_id if cur is not None else None

    def span(self, name: str, trace_id: Optional[str] = None,
             parent_id: Optional[int] = None, **attrs):
        """Context manager timing one operation. Nests: inside another
        ``span()`` block the new span inherits that trace id and parents
        to it; at top level it starts a fresh trace (or the explicit
        ``trace_id`` — how HTTP hands its request id down). An explicit
        ``trace_id``/``parent_id`` pair grafts the span onto another
        thread's trace (the serving flush thread parenting its predict
        onto the submitting request) while still propagating to children
        via the contextvar. Yields the :class:`Span` (annotate via
        ``span.attrs``), or None when disabled."""
        if not self.enabled:
            return _NULL_CTX
        parent = self._current.get()
        if trace_id is None:
            trace_id = parent.trace_id if parent is not None \
                else new_trace_id()
        if parent_id is None and parent is not None:
            parent_id = parent.span_id
        s = Span(name, trace_id, parent_id, attrs)
        return _SpanCtx(self, s)

    def record_span(self, name: str, trace_id: str, start: float,
                    end: float, parent_id: Optional[int] = None,
                    **attrs) -> Optional[Span]:
        """Record an already-measured span with explicit timestamps
        (seconds from ``time.perf_counter() - tracer origin``; use
        :func:`monotonic_s` for 'now'). The cross-thread path: the
        serving flush thread emits queue-wait/predict/scatter spans for
        requests whose root span lives in the submitting thread. Returns
        the span, or None when disabled."""
        if not self.enabled:
            return None
        s = Span(name, trace_id, parent_id, attrs)
        s.start = start
        s.duration = max(0.0, end - start)
        self._retire(s)
        return s

    def _retire(self, s: Span):
        with self._lock:
            self._spans.append(s)

    def spans(self) -> List[Span]:
        """Finished spans, oldest first (bounded by ``max_spans``)."""
        with self._lock:
            return list(self._spans)

    def spans_for(self, trace_id: str) -> List[Span]:
        """Finished spans of one trace, oldest first — what the
        ``/v1/debug/traces/<id>`` endpoint serves from this process's
        ring."""
        with self._lock:
            return [s for s in self._spans if s.trace_id == trace_id]

    def trace_rollup(self) -> Dict[str, Dict[str, Any]]:
        """Per-trace summary of the ring, ``{trace_id: {spans, start,
        end}}`` — the index view of ``GET /v1/debug/traces``."""
        out: Dict[str, Dict[str, Any]] = {}
        for s in self.spans():
            agg = out.get(s.trace_id)
            if agg is None:
                out[s.trace_id] = {"spans": 1, "start": s.start,
                                   "end": s.end}
            else:
                agg["spans"] += 1
                agg["start"] = min(agg["start"], s.start)
                agg["end"] = max(agg["end"], s.end)
        return out

    def export_chrome_trace(self, path: Optional[str] = None) -> str:
        """Serialize collected spans as Chrome trace-event JSON
        (``{"traceEvents": [...]}``) — loadable in Perfetto
        (ui.perfetto.dev) or ``chrome://tracing``. Writes to ``path``
        when given; always returns the JSON string."""
        doc = {"traceEvents": [s.to_event() for s in self.spans()],
               "displayTimeUnit": "ms"}
        text = json.dumps(doc)
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text


def monotonic_s() -> float:
    """'Now' on the tracer time base (seconds since the process origin) —
    pair with :meth:`Tracer.record_span` explicit timestamps."""
    return time.perf_counter() - _T0


def wall_anchor() -> float:
    """The wall-clock time (``time.time()``) corresponding to this
    process's tracer origin. Each process has its own monotonic origin,
    so merging spans across processes needs each process's anchor:
    ``anchor + span.start`` puts a span on the shared wall clock. The
    anchor is *sampled now*, not cached — the residual skew between two
    processes' anchors is real measurement noise, which the front door's
    trace merge reports alongside the spans rather than hiding."""
    return time.time() - monotonic_s()


_global_tracer = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer every built-in instrumentation point
    (serving, Estimator, InferenceModel) reports to."""
    return _global_tracer


def span(name: str, **attrs):
    """Shorthand for ``get_tracer().span(name, **attrs)``."""
    return _global_tracer.span(name, **attrs)


def current_trace_id() -> Optional[str]:
    """Shorthand for ``get_tracer().current_trace_id()``."""
    return _global_tracer.current_trace_id()


# Lazily-created global cache-event children (hot path: do_predict must
# not pay a registry dict lookup per call).
_cache_children: Optional[Dict[str, Counter]] = None


def inference_cache_counters() -> Dict[str, Counter]:
    """The process-global ``zoo_inference_cache_events_total`` children
    keyed by event (``hits``/``misses``/``evictions``/
    ``warmup_overflow``) — shared by every
    :class:`~analytics_zoo_tpu_torch.inference.inference_model.InferenceModel`
    (each instance also keeps its own ``cache_stats`` dict).
    ``warmup_overflow`` counts warmups that registered more shapes than
    ``executable_cache_size`` — the LRU is silently evicting just-warmed
    executables and serve-time recompiles are back."""
    global _cache_children
    if _cache_children is None:
        fam = get_registry().counter(
            "zoo_inference_cache_events_total",
            "InferenceModel executable-cache events process-wide.",
            labels=("event",))
        _cache_children = {e: fam.labels(event=e)
                           for e in ("hits", "misses", "evictions",
                                     "warmup_overflow")}
    return _cache_children


# Lazily-created process-resource gauges in the global registry; per-call
# registries (the front door keeps its own) create theirs on demand.
_process_children: Optional[Dict[str, Gauge]] = None


def _register_process_gauges(reg: MetricsRegistry) -> Dict[str, Gauge]:
    return {
        "rss_bytes": reg.gauge(
            "zoo_process_rss_bytes",
            "Resident set size of this process in bytes "
            "(/proc/self/statm; 0 where /proc is unavailable).").labels(),
        "open_fds": reg.gauge(
            "zoo_process_open_fds",
            "Open file descriptors of this process "
            "(/proc/self/fd; 0 where /proc is unavailable).").labels(),
    }


def process_metrics(
        registry: Optional[MetricsRegistry] = None) -> Dict[str, Gauge]:
    """The ``zoo_process_{rss_bytes,open_fds}`` gauge children, keyed
    ``rss_bytes`` / ``open_fds`` — per-worker resource pressure for the
    front door's merged scrape. Registered in ``registry``
    (default: the global one, children cached module-level). Values are
    point-in-time samples; call :func:`refresh_process_metrics` before
    rendering."""
    if registry is not None:
        return _register_process_gauges(registry)
    global _process_children
    if _process_children is None:
        _process_children = _register_process_gauges(get_registry())
    return _process_children


def refresh_process_metrics(
        registry: Optional[MetricsRegistry] = None) -> Dict[str, float]:
    """Sample ``/proc/self`` into the process gauges — no psutil, just
    two reads — and, where ``registry`` holds ``zoo_build_info``, its
    device label as it reads now. On platforms without ``/proc`` the
    gauges keep their last value (0 initially) and this is a cheap no-op.
    Returns the sampled ``{name: value}`` for callers that want the
    numbers directly."""
    gauges = process_metrics(registry)
    reg = registry if registry is not None else get_registry()
    if "zoo_build_info" in reg._families:
        build_info(reg)  # the device label as it reads now
    out: Dict[str, float] = {}
    try:
        with open("/proc/self/statm", "rb") as f:
            rss_pages = int(f.read().split()[1])
        out["rss_bytes"] = float(rss_pages * os.sysconf("SC_PAGE_SIZE"))
        gauges["rss_bytes"].set(out["rss_bytes"])
    except (OSError, IndexError, ValueError):
        pass
    try:
        out["open_fds"] = float(len(os.listdir("/proc/self/fd")))
        gauges["open_fds"].set(out["open_fds"])
    except OSError:
        pass
    return out


# Build-info label values are computed once — they cannot change within
# a process — except the device label while it reads "no-context": a
# process that initialises CUDA after its first call (an engine built
# before its card model) gets the card's name at its next scrape.
_build_info_labels: Optional[Dict[str, str]] = None


def _device_label() -> str:
    """The card's name where this process already holds a CUDA context;
    ``no-context`` where a card is visible but this process has not
    initialised CUDA (asking for the name would create a context, and a
    process that never computes on the card, such as the front door or
    the fleet door, must not hold one); ``cpu`` without a card."""
    try:
        import torch

        if torch.cuda.is_initialized():
            return torch.cuda.get_device_name(0)
        return "no-context" if torch.cuda.is_available() else "cpu"
    except Exception:  # pragma: no cover - torch is a dependency
        return "unavailable"


def _build_info_values() -> Dict[str, str]:
    global _build_info_labels
    if _build_info_labels is None:
        try:
            from analytics_zoo_tpu_torch import __version__ as version
        except Exception:  # pragma: no cover - defensive
            version = "unknown"
        torch_v = cuda_v = "unavailable"
        try:
            import torch

            torch_v = torch.__version__
            cuda_v = torch.version.cuda or "none"
        except Exception:  # pragma: no cover - torch is a dependency
            pass
        _build_info_labels = {"version": version, "torch": torch_v,
                              "cuda": cuda_v, "device": _device_label()}
    elif _build_info_labels["device"] == "no-context":
        device = _device_label()
        if device != "no-context":
            _build_info_labels = dict(_build_info_labels, device=device)
    return _build_info_labels


def build_info(registry: Optional[MetricsRegistry] = None) -> Gauge:
    """Register the ``zoo_build_info{version,torch,cuda,device}``
    info-gauge (value pinned to 1) in ``registry`` (default: the global
    one) so every scrape identifies exactly what is running — package
    version, the torch and CUDA versions, and the card's name (``cpu``
    without a card, ``no-context`` in a process that has not initialised
    CUDA yet). Idempotent; :func:`refresh_process_metrics` calls it again
    at every scrape, so the one sample carries the labels as they read
    then. Returns the gauge child."""
    reg = registry if registry is not None else get_registry()
    fam = reg.gauge(
        "zoo_build_info",
        "Build/runtime identity of this process (value is always 1; the "
        "information is in the labels).",
        labels=("version", "torch", "cuda", "device"),
    )
    values = _build_info_values()
    key = tuple(values[n] for n in fam.label_names)
    with fam._lock:
        for stale in [k for k in fam._children if k != key]:
            del fam._children[stale]
    g = fam.labels(**values)
    g.set(1)
    return g


def checkpoint_metrics() -> Dict[str, Any]:
    """The fault-tolerance metric families in the global registry:
    ``saves`` (counter ``zoo_checkpoint_saves_total``), ``save_seconds``
    (summary ``zoo_checkpoint_save_seconds``), ``bytes`` (counter
    ``zoo_checkpoint_bytes_total``) and ``restores`` (the labeled family
    ``zoo_checkpoint_restores_total{outcome=...}``: call
    ``.labels(outcome=...)`` with ``ok``/``corrupt``/``mismatch``/
    ``missing``). One call per CheckpointManager, which holds the
    children."""
    reg = get_registry()
    return {
        "saves": reg.counter(
            "zoo_checkpoint_saves_total",
            "Checkpoints durably committed (tmp-dir + rename + COMMIT "
            "marker).").labels(),
        "save_seconds": reg.summary(
            "zoo_checkpoint_save_seconds",
            "Wall seconds per checkpoint serialize+commit (writer "
            "thread — the train step is not blocked for this).").labels(),
        "bytes": reg.counter(
            "zoo_checkpoint_bytes_total",
            "Array payload bytes committed across all "
            "checkpoints.").labels(),
        "restores": reg.counter(
            "zoo_checkpoint_restores_total",
            "Checkpoint restore attempts by outcome "
            "(ok/corrupt/mismatch/missing).", labels=("outcome",)),
    }


_sweep_children: Optional[Dict[str, Counter]] = None


def checkpoint_sweep_counters() -> Dict[str, Counter]:
    """The process-global ``zoo_checkpoint_sweeps_total`` children keyed by
    debris kind, which :func:`analytics_zoo_tpu_torch.ft.atomic.sweep_stale`
    counts instead of deleting silently: ``staging`` (``ckpt_N.tmp``
    directories from a crash mid-commit), ``uncommitted`` (``ckpt_N``
    husks whose COMMIT marker never landed), ``retention`` (committed
    checkpoints removed by a ``keep_steps`` sweep), ``orphan_shard``
    (undeclared ``host_K/`` directories scrubbed from a committed sharded
    checkpoint) and ``dist_abort`` (sharded-commit staging swept by the
    coordinator of :mod:`analytics_zoo_tpu_torch.ft.distributed`)."""
    global _sweep_children
    if _sweep_children is None:
        fam = get_registry().counter(
            "zoo_checkpoint_sweeps_total",
            "Checkpoint debris removed by sweep_stale / the sharded-commit "
            "abort path, by kind.",
            labels=("kind",))
        _sweep_children = {k: fam.labels(kind=k)
                           for k in ("staging", "uncommitted", "retention",
                                     "orphan_shard", "dist_abort")}
    return _sweep_children


def distributed_metrics() -> Dict[str, Any]:
    """The multi-host training metric children in the global registry
    (:mod:`analytics_zoo_tpu_torch.ft.distributed` and
    ``Estimator.train_distributed``): ``steps`` (counter
    ``zoo_dist_steps_total``: sharded-update optimizer steps completed by
    this host), ``exchange_seconds`` (summary ``zoo_dist_exchange_seconds``:
    wall seconds blocked in the cross-host rendezvous per round),
    ``commits`` (labelled counter ``zoo_dist_commits_total{outcome}``:
    ``committed``, ``aborted``, ``timeout``) and ``hosts`` (gauge
    ``zoo_dist_hosts``: the host count of the current run). One call per
    ``train_distributed``, whose loop holds the children."""
    reg = get_registry()
    return {
        "steps": reg.counter(
            "zoo_dist_steps_total",
            "Sharded-update optimizer steps completed by this host in "
            "multi-host training.").labels(),
        "exchange_seconds": reg.summary(
            "zoo_dist_exchange_seconds",
            "Wall seconds this host spent blocked in the cross-host "
            "exchange per round.").labels(),
        "commits": reg.counter(
            "zoo_dist_commits_total",
            "Two-phase sharded checkpoint commits by outcome "
            "(committed/aborted/timeout).", labels=("outcome",)),
        "hosts": reg.gauge(
            "zoo_dist_hosts",
            "Host count of the current multi-host training run.").labels(),
    }


def hot_reload_metrics() -> Dict[str, Any]:
    """The serving hot-reload metric children in the global registry:
    ``retries`` (counter ``zoo_hot_reload_retries_total``: transient
    ``build_model``/register failures scheduled for another attempt) and
    ``skips`` (counter ``zoo_hot_reload_skips_total``: checkpoint steps
    abandoned as structurally bad, or after exhausting retries). One call
    per :class:`~analytics_zoo_tpu_torch.ft.hot_reload.CheckpointWatcher`,
    which holds the children."""
    reg = get_registry()
    return {
        "retries": reg.counter(
            "zoo_hot_reload_retries_total",
            "Transient hot-reload failures that will be retried with "
            "backoff.").labels(),
        "skips": reg.counter(
            "zoo_hot_reload_skips_total",
            "Checkpoint steps the hot-reload watcher gave up on "
            "(structural failure, or retries exhausted).").labels(),
    }


def training_metrics() -> Dict[str, Any]:
    """The training metric children in the global registry: ``steps``
    (counter ``zoo_train_steps_total``), ``step_seconds`` (summary
    ``zoo_train_step_seconds``) and ``items_per_sec`` (gauge
    ``zoo_train_items_per_sec``). One call per ``train()``, whose loop
    holds the children."""
    reg = get_registry()
    return {
        "steps": reg.counter(
            "zoo_train_steps_total",
            "Optimizer steps completed by Estimator.train.").labels(),
        "step_seconds": reg.summary(
            "zoo_train_step_seconds",
            "Wall seconds per training step (drain granularity: a "
            "drain observes its mean per-step time).").labels(),
        "items_per_sec": reg.gauge(
            "zoo_train_items_per_sec",
            "Training throughput over the most recent drain "
            "window.").labels(),
    }


def data_metrics() -> Dict[str, Any]:
    """The streaming-input-pipeline metric children in the global
    registry: ``samples`` (counter ``zoo_data_samples_total``),
    ``batches`` (counter ``zoo_data_batches_total``), ``wait_seconds``
    (summary ``zoo_data_wait_seconds`` — consumer time blocked on the
    iterator per batch), ``queue_depth`` (gauge ``zoo_data_queue_depth``
    — ready prefetched batches), ``samples_per_sec`` (gauge) and
    ``starvation_ratio`` (gauge ``zoo_data_starvation_ratio`` — the
    fraction of recent step wall-time spent waiting on the input
    iterator; near 1.0 means training is input-bound, near 0.0 means the
    prefetcher keeps the device fed). One call per pipeline/epoch, whose
    caller holds the children."""
    reg = get_registry()
    return {
        "samples": reg.counter(
            "zoo_data_samples_total",
            "Samples produced by streaming input pipelines (wrap-padding "
            "excluded).").labels(),
        "batches": reg.counter(
            "zoo_data_batches_total",
            "Batches assembled by streaming input pipelines.").labels(),
        "wait_seconds": reg.summary(
            "zoo_data_wait_seconds",
            "Seconds the consumer spent blocked on the input iterator, "
            "per batch.").labels(),
        "queue_depth": reg.gauge(
            "zoo_data_queue_depth",
            "Device-prefetch queue depth (ready batches) at the last "
            "dequeue.").labels(),
        "samples_per_sec": reg.gauge(
            "zoo_data_samples_per_sec",
            "Input-pipeline throughput over the most recent "
            "epoch.").labels(),
        "starvation_ratio": reg.gauge(
            "zoo_data_starvation_ratio",
            "Fraction of step wall-time spent waiting on the input "
            "iterator (1.0 = fully input-bound).").labels(),
    }


def batch_metrics() -> Dict[str, Any]:
    """The offline batch-scoring metric children in the global registry:
    ``rows`` (counter ``zoo_batch_rows_total`` — scored rows durably
    committed, pad rows excluded), ``shards`` (counter
    ``zoo_batch_shards_committed_total``), ``rows_per_sec`` (gauge
    ``zoo_batch_rows_per_sec`` — throughput over the most recent job),
    ``write_seconds`` (summary ``zoo_batch_write_seconds`` — wall seconds
    per shard stage+fsync+rename+manifest commit) and ``resume_skipped``
    (counter ``zoo_batch_resume_skipped_shards_total`` — shards a resumed
    job found already committed and did not re-score). One call per
    :class:`~analytics_zoo_tpu_torch.batch.runner.BatchJobRunner`, which
    holds the children."""
    reg = get_registry()
    return {
        "rows": reg.counter(
            "zoo_batch_rows_total",
            "Rows scored and durably committed by batch-predict jobs "
            "(pad rows excluded).").labels(),
        "shards": reg.counter(
            "zoo_batch_shards_committed_total",
            "Output shards committed through the atomic "
            "stage/fsync/rename/manifest protocol.").labels(),
        "rows_per_sec": reg.gauge(
            "zoo_batch_rows_per_sec",
            "Batch-predict throughput over the most recent job "
            "segment.").labels(),
        "write_seconds": reg.summary(
            "zoo_batch_write_seconds",
            "Wall seconds per shard commit (stage + fsync + rename + "
            "manifest update).").labels(),
        "resume_skipped": reg.counter(
            "zoo_batch_resume_skipped_shards_total",
            "Already-committed shards a resumed batch job skipped "
            "instead of re-scoring.").labels(),
    }


def capture_metrics() -> Dict[str, Any]:
    """The serving capture tap's metric children in the global registry
    (:mod:`analytics_zoo_tpu_torch.flywheel.capture`): ``sampled`` (counter
    ``zoo_capture_sampled_total`` — requests the error-diffusion sampler
    selected), ``dropped`` (labeled counter
    ``zoo_capture_dropped_total{reason=...}`` with reasons
    ``queue_full``/``predict_failed``/``encode_error``), ``rows`` (counter
    ``zoo_capture_rows_total`` — rows durably committed to capture
    shards), ``shards`` (counter ``zoo_capture_shards_committed_total``)
    and ``queue_depth`` (gauge ``zoo_capture_queue_depth``). One call per
    :class:`~analytics_zoo_tpu_torch.flywheel.capture.CaptureTap` — the tap
    holds the children."""
    reg = get_registry()
    return {
        "sampled": reg.counter(
            "zoo_capture_sampled_total",
            "Serving requests selected by the capture tap's "
            "error-diffusion sampler.").labels(),
        "dropped": reg.counter(
            "zoo_capture_dropped_total",
            "Sampled requests the tap could not capture, by reason "
            "(queue_full/predict_failed/encode_error).",
            labels=("reason",)),
        "rows": reg.counter(
            "zoo_capture_rows_total",
            "Request rows durably committed to capture shards.").labels(),
        "shards": reg.counter(
            "zoo_capture_shards_committed_total",
            "Capture shards committed through the atomic "
            "stage/fsync/rename/manifest protocol (time-rolled partial "
            "shards included).").labels(),
        "queue_depth": reg.gauge(
            "zoo_capture_queue_depth",
            "Pending records in the capture tap's hand-off queue "
            "(sampled on the writer thread).").labels(),
    }


def flywheel_metrics() -> Dict[str, Any]:
    """The online-learning flywheel's metric children in the global
    registry (:mod:`analytics_zoo_tpu_torch.flywheel`): ``cycles`` (labeled
    counter ``zoo_flywheel_cycles_total{outcome=...}`` with outcomes
    ``promoted``/``rolled_back``/``no_data``/``timeout``),
    ``cycle_seconds`` (summary ``zoo_flywheel_cycle_seconds`` — wall
    seconds per capture→retrain→promote cycle), ``rows_trained``
    (counter ``zoo_flywheel_rows_trained_total`` — captured rows consumed
    by incremental retrains), ``quarantined`` (counter
    ``zoo_flywheel_quarantined_segments_total`` — capture segments
    quarantined after a rollback) and ``candidate_step`` (gauge
    ``zoo_flywheel_candidate_step`` — the checkpoint step of the most
    recent retrain candidate). One call per
    :class:`~analytics_zoo_tpu_torch.flywheel.controller.FlywheelController` —
    the controller holds the children."""
    reg = get_registry()
    return {
        "cycles": reg.counter(
            "zoo_flywheel_cycles_total",
            "Flywheel cycles by outcome "
            "(promoted/rolled_back/no_data/timeout).",
            labels=("outcome",)),
        "cycle_seconds": reg.summary(
            "zoo_flywheel_cycle_seconds",
            "Wall seconds per capture-rotate + retrain + promotion "
            "cycle.").labels(),
        "rows_trained": reg.counter(
            "zoo_flywheel_rows_trained_total",
            "Captured rows consumed by incremental retrains.").labels(),
        "quarantined": reg.counter(
            "zoo_flywheel_quarantined_segments_total",
            "Capture segments quarantined after a canary "
            "rollback.").labels(),
        "candidate_step": reg.gauge(
            "zoo_flywheel_candidate_step",
            "Checkpoint step of the most recent retrain "
            "candidate.").labels(),
    }


def label_metrics() -> Dict[str, Any]:
    """The outcome plane's label-side metric children in the global
    registry (:mod:`analytics_zoo_tpu_torch.flywheel.labels`): ``received``
    (counter ``zoo_label_received_total`` — outcome records accepted by
    ingest), ``rows`` (counter ``zoo_label_rows_total`` — label rows
    durably committed to label shards), ``shards`` (counter
    ``zoo_label_shards_committed_total``), ``duplicates`` (counter
    ``zoo_label_duplicates_total`` — labels superseded by a
    later/winning record for the same trace), ``watermark`` (labeled
    gauge ``zoo_label_watermark_ts{model=...}``), ``unmatched``
    (labeled gauge ``zoo_label_unmatched{model=...}`` — labels whose
    trace matches no captured row yet) and ``join_lag`` (labeled gauge
    ``zoo_label_join_lag_s{model=...}`` — how far the newest captured
    request is ahead of the label watermark; 0 when every window is
    closed). One call per :class:`~analytics_zoo_tpu_torch.flywheel.labels
    .LabelStore` — the store holds the children."""
    reg = get_registry()
    return {
        "received": reg.counter(
            "zoo_label_received_total",
            "Outcome label records accepted by ingest.").labels(),
        "rows": reg.counter(
            "zoo_label_rows_total",
            "Label rows durably committed to label shards.").labels(),
        "shards": reg.counter(
            "zoo_label_shards_committed_total",
            "Label shards committed through the atomic "
            "stage/fsync/rename/manifest protocol.").labels(),
        "duplicates": reg.counter(
            "zoo_label_duplicates_total",
            "Duplicate labels resolved last-write-wins during "
            "joins.").labels(),
        "watermark": reg.gauge(
            "zoo_label_watermark_ts",
            "Max label timestamp across committed label segments (the "
            "join watermark).", labels=("model",)),
        "unmatched": reg.gauge(
            "zoo_label_unmatched",
            "Labels whose trace id matches no captured request row.",
            labels=("model",)),
        "join_lag": reg.gauge(
            "zoo_label_join_lag_s",
            "Seconds the newest captured request is ahead of the label "
            "watermark (0 = all capture windows closed).",
            labels=("model",)),
    }


def drift_metrics() -> Dict[str, Any]:
    """The drift detectors' metric children in the global registry
    (:mod:`analytics_zoo_tpu_torch.flywheel.drift`): ``feature_psi`` (labeled
    gauge ``zoo_drift_feature_psi{model,feature}`` — per-feature
    population stability index between the pinned reference window and
    the live capture window), ``prediction_js`` (labeled gauge
    ``zoo_drift_prediction_js{model}`` — Jensen–Shannon divergence
    between the canary's and incumbent's prediction distributions) and
    ``evaluations`` (labeled counter
    ``zoo_drift_evaluations_total{model}``). One call per detector —
    the detector holds the children."""
    reg = get_registry()
    return {
        "feature_psi": reg.gauge(
            "zoo_drift_feature_psi",
            "Per-feature PSI between the pinned reference window and "
            "the live capture window.", labels=("model", "feature")),
        "prediction_js": reg.gauge(
            "zoo_drift_prediction_js",
            "Jensen-Shannon divergence between canary and incumbent "
            "prediction distributions.", labels=("model",)),
        "evaluations": reg.counter(
            "zoo_drift_evaluations_total",
            "Drift score evaluations performed.", labels=("model",)),
    }
