"""Dynamic micro-batching (port of ``analytics_zoo_tpu.serving.batcher``) —
the Cluster Serving streaming-batch analogue.

The reference's online path (Cluster Serving) pops up to ``batchSize``
requests off a Redis stream per tick and runs one predict; on the card the
win is larger and the machinery smaller: per-request dispatch leaves the
card idle between small launches, and a fixed bucket ladder of warmed
shapes (one captured CUDA graph each, see
:class:`~analytics_zoo_tpu_torch.inference.InferenceModel`) means every
flush is a cache hit. So the queue is an in-process
``deque`` of futures, the "streaming engine" is two host threads, and the
batch geometry is pinned to a pre-compiled ladder:

1. ``submit(x)`` validates the request, enqueues it (bounded queue —
   a full queue raises :class:`QueueFullError` immediately, backpressure
   instead of unbounded buffering) and returns a
   ``concurrent.futures.Future``.
2. The dispatch thread gathers requests until ``max_batch_size`` rows are
   waiting or ``max_wait_ms`` has elapsed since the oldest request
   arrived, whichever is first.
3. The gathered rows are copied into a preallocated staging buffer for
   the next size in the bucket ladder (zeros in the pad rows — dropped
   before scatter), so the predict always hits one of the warmed
   executables and assembly never allocates on the steady-state path.
4. One predict is *dispatched*; the in-flight batch is handed to a
   bounded completion stage that blocks on the device result and
   scatters per-request slices onto the futures. Padded rows never
   leave the batcher.

**Pipelined flush**: dispatch and completion are separate
stages so the dispatch thread never blocks on results — a graph replay is
enqueued on the card's stream and returns at once, so batch N+1 is gathered and staged while batch N computes
on the device. ``BatcherConfig.pipeline_depth`` bounds the number of
dispatched-but-unscattered batches (``0`` restores the fully synchronous
single-thread flush). When the batcher is given a split
``dispatch_fn``/``fetch_fn`` pair (the engine wires
``InferenceModel.do_dispatch``/``do_fetch``), the dispatch stage pays
only the host-side enqueue cost and the completion stage pays the
device wait; with only a blocking ``predict_fn`` the completion stage
still overlaps result scatter with the next gather. Scatter always
returns *copies* — a caller mutating its result array can never corrupt
a batchmate's result or the reused staging buffer.

Requests larger than ``max_batch_size`` are transparently SPLIT into
``max_batch_size``-row chunks that ride the normal queue; the returned
future concatenates the chunk results in order (the documented choice
over rejecting — see docs/serving.md). Per-request deadlines fail the
future with :class:`DeadlineExceededError` at flush time instead of
wedging the flush loop; any fault during a flush — batch assembly,
the model itself, or the result scatter — fails only the in-flight
batch and the loop continues.

With the global tracer enabled
(:func:`analytics_zoo_tpu_torch.common.observability.get_tracer`), each
request's lifecycle — queue wait, batch assembly, predict, result
scatter — is recorded as spans under the trace captured at submit; a
disabled tracer costs one boolean check per request. A batch containing
a traced request runs the synchronous (non-pipelined) flush path so its
queue_wait/assembly/predict/scatter spans stay truthful — tracing a
request serializes its batch, which is exactly what makes the exported
timeline honest.

Because one batch mixes arbitrary requests, a request whose trailing
dims or input arity disagree with its batchmates would otherwise take
the whole batch down. Pass an :class:`InputSignature` (the engine
derives one from ``example_input`` at register time) and ``submit``
rejects such requests at the boundary — a synchronous ``ValueError``
the HTTP layer maps to 400 — before they can reach a flush. The
signature is also what enables staging buffers: with per-input trailing
shapes pinned, each bucket gets a standing host buffer reused across
flushes instead of ``np.concatenate`` allocating per flush.

Resilience hooks (wired by the engine from its
:class:`~analytics_zoo_tpu_torch.serving.resilience.ResilienceConfig`):

- ``admission``: an :class:`~analytics_zoo_tpu_torch.serving.resilience
  .AdmissionController` fed each flush's service time; ``submit`` sheds
  a deadline-carrying request with
  :class:`~analytics_zoo_tpu_torch.serving.resilience.ShedError` when the
  estimated queue wait already breaks its deadline (batches ahead now
  include the completion stage's backlog).
- ``breaker``: a :class:`~analytics_zoo_tpu_torch.serving.resilience
  .CircuitBreaker` consulted first thing in ``submit`` (fast-fail
  before the queue) and fed every flush outcome.
- Both worker threads maintain a shared heartbeat, and the in-flight
  work of *both* stages is recorded under the queue lock, so
  :class:`~analytics_zoo_tpu_torch.serving.resilience.FlushWatchdog` can call
  :meth:`DynamicBatcher.check_flush_thread` to detect a dead or wedged
  worker and :meth:`DynamicBatcher.restart_worker` to replace the pair
  — failing only the batches in flight. A *generation token* makes this
  safe without killing threads (Python can't): each worker carries the
  generation it was started with, a restart bumps it, and a superseded
  worker exits at its next queue interaction while its late result
  scatter no-ops against already-failed futures.
- Chaos points from :mod:`analytics_zoo_tpu_torch.ft.chaos`
  (``predict_raises`` / ``predict_slow`` / ``flush_thread_dies``) fire
  inside the dispatch stage so tests can drive all of the above
  in-process.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.common.flight_recorder import get_flight_recorder
from analytics_zoo_tpu_torch.common.tree import tree_map
from analytics_zoo_tpu_torch.common.observability import (
    get_tracer,
    monotonic_s,
    new_trace_id,
)
from analytics_zoo_tpu_torch.ft import chaos as _chaos
from analytics_zoo_tpu_torch.serving.resilience import (
    FlushThreadRestartedError,
    ShedError,
)

__all__ = ["BatcherConfig", "DynamicBatcher", "InputSignature",
           "QueueFullError", "DeadlineExceededError"]


class QueueFullError(RuntimeError):
    """Raised by ``submit`` when the bounded request queue is at capacity —
    explicit backpressure: the caller sheds load (HTTP 429) instead of the
    engine queueing unboundedly."""


class DeadlineExceededError(TimeoutError):
    """Set on a request's future when its deadline passed before its batch
    ran; the flush loop itself keeps going."""


def _power_ladder(max_batch_size: int) -> Tuple[int, ...]:
    sizes = []
    b = 1
    while b < max_batch_size:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch_size)
    return tuple(sizes)


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    """Per-model batching knobs.

    Attributes:
      max_batch_size: flush as soon as this many rows are queued; also the
        largest bucket, so it bounds every compiled shape.
      max_wait_ms: a partial batch flushes this many ms after its oldest
        request arrived — the latency cost a request pays, at most, for
        batching (a lone straggler still flushes).
      max_queue_size: bound on queued *requests*; beyond it ``submit``
        raises :class:`QueueFullError`.
      buckets: ascending pad-target sizes. ``None`` → powers of two up to
        ``max_batch_size``. Entries above ``max_batch_size`` are dropped
        and ``max_batch_size`` is always included, so every flush has a
        bucket.
      timeout_ms: default per-request deadline (``None`` → no deadline);
        ``submit(..., timeout_ms=)`` overrides per request.
      pipeline_depth: bound on batches dispatched but not yet scattered
        (the completion stage's backlog). ``2`` lets batch N+1 assemble
        and dispatch while batch N's result lands; raise it only if the
        model's service time is very spiky. ``0`` disables pipelining —
        the dispatch thread completes each batch synchronously (the
        earlier fully synchronous behavior; useful when debugging timing).
      eager_flush_quiesce_ms: when set, a partial batch flushes early —
        before ``max_wait_ms`` — once the device pipeline is idle (no
        batch dispatched or completing) AND no request has arrived for
        this many ms. Holding a ready batch while the device sits idle
        buys batch fill only if more requests are still arriving; once
        the queue goes quiet, the wait is pure added latency (under
        closed-loop load — every client blocked on a response — the
        stalled batch flushes with exactly the rows it would have had
        at the timer anyway). ``None`` (default) keeps the strict
        ``max_wait_ms`` window.
    """

    max_batch_size: int = 32
    max_wait_ms: float = 5.0
    max_queue_size: int = 256
    buckets: Optional[Sequence[int]] = None
    timeout_ms: Optional[float] = None
    pipeline_depth: int = 2
    eager_flush_quiesce_ms: Optional[float] = None

    def ladder(self) -> Tuple[int, ...]:
        """The normalized ascending bucket ladder (ends at
        ``max_batch_size``)."""
        if self.buckets is None:
            return _power_ladder(self.max_batch_size)
        sizes = sorted({int(b) for b in self.buckets
                        if 0 < int(b) <= self.max_batch_size})
        if not sizes or sizes[-1] != self.max_batch_size:
            sizes.append(self.max_batch_size)
        return tuple(sizes)


def _is_numeric(dtype: np.dtype) -> bool:
    return (np.issubdtype(dtype, np.number)
            or np.issubdtype(dtype, np.bool_))


class InputSignature:
    """The model's per-input ``(trailing shape, dtype)`` contract.

    Batching concatenates arbitrary requests along the leading axis, so a
    request whose trailing dims or arity disagree with its batchmates
    would fail the whole batch at flush time. With a signature, ``submit``
    validates each request up front instead: arity and trailing shapes
    must match exactly (``ValueError`` otherwise — HTTP 400), and numeric
    dtypes are coerced to the model's (so e.g. JSON integers still hit
    the float32 bucket executables warmed at register time).

    A trailing dim declared as ``None`` is a wildcard: any
    length validates there, while arity, the fixed dims and the dtype
    contract stay enforced — how the sequence path admits ragged prompts
    at the boundary without giving up submit-time rejection. Signatures
    with a wildcard report ``fixed == False`` and opt the batcher out of
    preallocated staging buffers (a buffer needs every dim pinned);
    all-fixed signatures behave bitwise as before.
    """

    __slots__ = ("specs", "multi", "fixed")

    def __init__(self, specs: Sequence[Tuple[Tuple[Optional[int], ...],
                                             Any]],
                 multi: bool):
        self.specs: Tuple[Tuple[Tuple[Optional[int], ...], np.dtype],
                          ...] = tuple(
            (tuple(None if d is None else int(d) for d in shape),
             np.dtype(dtype))
            for shape, dtype in specs)
        self.multi = bool(multi)
        #: True when every trailing dim of every input is pinned — the
        #: precondition for the staging-buffer fast path.
        self.fixed = all(d is not None
                         for shape, _dtype in self.specs for d in shape)

    @classmethod
    def from_example(cls, example_input) -> "InputSignature":
        """Derive the signature from a representative batch (array or
        list/tuple of arrays, leading axis = batch)."""
        multi = isinstance(example_input, (list, tuple))
        xs = [np.asarray(a)
              for a in (example_input if multi else [example_input])]
        if not xs or any(a.ndim < 1 for a in xs):
            raise ValueError("example input must be batched: every array "
                             "needs a leading batch axis")
        return cls([(a.shape[1:], a.dtype) for a in xs], multi)

    def validate(self, xs: List[np.ndarray]) -> List[np.ndarray]:
        """Check ``xs`` against the contract; returns the (possibly
        dtype-coerced) arrays, raises ``ValueError`` on any mismatch."""
        if len(xs) != len(self.specs):
            raise ValueError(
                f"request has {len(xs)} input array(s), model expects "
                f"{len(self.specs)}")
        out = []
        for i, (a, (shape, dtype)) in enumerate(zip(xs, self.specs)):
            if None not in shape:
                if a.shape[1:] != shape:
                    raise ValueError(
                        f"input {i}: rows have shape {tuple(a.shape[1:])}, "
                        f"model expects {shape}")
            else:
                got = tuple(a.shape[1:])
                if len(got) != len(shape) or any(
                        s is not None and g != s
                        for g, s in zip(got, shape)):
                    raise ValueError(
                        f"input {i}: rows have shape {got}, model expects "
                        f"{shape} (None = any length)")
            if a.dtype != dtype:
                if not (_is_numeric(a.dtype) and _is_numeric(dtype)):
                    raise ValueError(
                        f"input {i}: dtype {a.dtype} incompatible with "
                        f"model dtype {dtype}")
                a = a.astype(dtype)
            out.append(a)
        return out


class _Request:
    __slots__ = ("xs", "multi", "rows", "future", "deadline", "t_enqueue",
                 "trace", "fr")

    def __init__(self, xs, multi, rows, deadline, trace=None, fr=None):
        self.xs = xs                    # list of per-input arrays
        self.multi = multi              # caller passed a list/tuple
        self.rows = rows
        self.future: Future = Future()
        self.deadline = deadline        # absolute monotonic seconds or None
        self.t_enqueue = time.monotonic()
        # (trace_id, parent span id, enqueue time on the tracer time base)
        # captured in the SUBMITTING thread — the flush thread emits this
        # request's queue-wait/predict/scatter spans against it
        self.trace = trace
        # flight-recorder RequestRecord (or None): the flush and
        # completion stages stamp lifecycle timestamps straight onto it;
        # each field has a single writer, so no lock is needed
        self.fr = fr


class _Flight:
    """One dispatched batch in the completion stage: the requests it
    serves, the (possibly still-computing) model output, and the staging
    lease to return once the result has landed."""

    __slots__ = ("requests", "out", "rows", "bucket", "lease", "t0")

    def __init__(self, requests, out, rows, bucket, lease, t0):
        self.requests = requests
        self.out = out
        self.rows = rows
        self.bucket = bucket
        self.lease = lease
        self.t0 = t0


def _resolve(future: Future, result=None, error=None):
    # a client may have cancelled the future; never let that kill the loop
    try:
        if error is not None:
            future.set_exception(error)
        else:
            future.set_result(result)
    except InvalidStateError:
        pass


def _copy_slice(a, lo, hi):
    # numpy outputs are slices of a shared batch output; a request's
    # result must be privately owned and writable — copy (a tensor leaf
    # of a duck-typed model is cloned for the same reason).
    if isinstance(a, np.ndarray):
        return np.array(a[lo:hi])
    part = a[lo:hi]
    return part.clone() if hasattr(part, "clone") else part


def _tree_slice(out, lo, hi):
    return tree_map(lambda a: _copy_slice(a, lo, hi), out)


def _tree_concat(parts):
    return tree_map(lambda *xs: np.concatenate(xs, axis=0), *parts)


class DynamicBatcher:
    """Bounded request queue + a dispatch/completion thread pair in front
    of a batched ``predict_fn`` (normally ``InferenceModel.do_predict``).

    ``predict_fn`` must be a pure batch function: ``f(x)`` where ``x`` is
    an array (or list of arrays for multi-input models) whose leading axis
    is the batch, returning an array/pytree with the same leading axis.
    Row results must not depend on batchmates — true of any standard
    feed-forward network, and what makes scatter/gather exact.

    ``dispatch_fn``/``fetch_fn`` (optional, wired by the engine from
    ``InferenceModel.do_dispatch``/``do_fetch``) split the predict into
    an asynchronous device dispatch and a blocking result fetch so the
    pipeline actually overlaps host assembly with device compute; without
    them ``predict_fn`` runs (blocking) in the dispatch stage and only
    scatter is overlapped.
    """

    def __init__(self, predict_fn: Callable[[Any], Any],
                 config: Optional[BatcherConfig] = None,
                 metrics=None, name: str = "model",
                 signature: Optional[InputSignature] = None,
                 admission=None, breaker=None,
                 dispatch_fn: Optional[Callable[[Any], Any]] = None,
                 fetch_fn: Optional[Callable[[Any], Any]] = None,
                 chaos_tag: Optional[str] = None):
        self.predict_fn = predict_fn
        self.config = config or BatcherConfig()
        self.metrics = metrics          # ModelMetrics or None
        self.name = name
        self.signature = signature      # validated at submit when set
        self.admission = admission      # AdmissionController or None
        self.breaker = breaker          # CircuitBreaker or None
        self.dispatch_fn = dispatch_fn  # async device dispatch, or None
        self.fetch_fn = fetch_fn        # blocking result fetch, or None
        # identifies this batcher to tag-filtered chaos points (the
        # engine passes "name@version" so rollout tests can break
        # exactly one version's flush path)
        self.chaos_tag = chaos_tag
        self._ladder = self.config.ladder()
        self._depth = max(0, int(self.config.pipeline_depth))
        self._queue: "collections.deque[_Request]" = collections.deque()
        self._queued_rows = 0
        # One lock guards all batcher state; three condition variables
        # over it keep wakeups targeted — a submit must not wake the
        # completion worker, and a completion-pop must not wake the
        # gather. (With a single Condition every notify_all paid 2-3
        # spurious thread wakeups per request on the hot path.)
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)   # gather waits
        self._done = threading.Condition(self._lock)   # completion waits
        self._space = threading.Condition(self._lock)  # handoff waits
        self._last_enqueue = time.monotonic()
        self._stopped = False
        # per-(bucket) pools of reusable host staging buffers (signature
        # batchers only): a flush leases one, the completion stage returns
        # it once the device result has landed — steady-state assembly
        # never allocates
        self._staging: Dict[int, List[List[np.ndarray]]] = {}
        self._staging_lock = threading.Lock()
        self._staging_cap = self._depth + 2
        # watchdog bookkeeping, all under _lock: the workers' generation
        # token (bumped by restart_worker; a superseded worker exits at
        # its next queue interaction), the batch currently being staged or
        # dispatched, the completion stage's backlog and current flight,
        # and the last time either worker touched the queue
        self._gen = 0
        self._inflight: Optional[List[_Request]] = None
        self._completion: "collections.deque[_Flight]" = collections.deque()
        self._completion_current: Optional[_Flight] = None
        self._dispatch_done = False
        self._heartbeat = time.monotonic()
        self._worker = threading.Thread(
            target=self._loop, args=(0,), daemon=True,
            name=f"zoo-batcher-{name}")
        self._completion_worker = threading.Thread(
            target=self._completion_loop, args=(0,), daemon=True,
            name=f"zoo-batcher-{name}-c")
        self._worker.start()
        self._completion_worker.start()

    # -- submit side ------------------------------------------------------

    def submit(self, x, timeout_ms: Optional[float] = None,
               fr=None) -> Future:
        """Enqueue one request; returns a Future resolving to exactly what
        ``predict_fn`` would return for ``x`` alone (result arrays are
        private copies — mutating them cannot affect other requests).

        ``x``: array (leading axis = rows) or list/tuple of arrays with
        equal leading axes. Raises :class:`QueueFullError` when the queue
        is at ``max_queue_size``; a ``timeout_ms`` deadline (default
        ``config.timeout_ms``) fails the future with
        :class:`DeadlineExceededError` if the flush hasn't started by
        then. Requests with more than ``max_batch_size`` rows are split
        into chunks and reassembled in order. When the batcher has a
        :class:`InputSignature`, arity/trailing-shape mismatches raise
        ``ValueError`` here — before the request can poison a batch.

        With resilience wired in (engine default), an open circuit
        breaker raises
        :class:`~analytics_zoo_tpu_torch.serving.resilience.CircuitOpenError`
        before anything else, and admission control sheds a
        deadline-carrying request with
        :class:`~analytics_zoo_tpu_torch.serving.resilience.ShedError` when
        the estimated queue wait already exceeds its deadline.

        ``fr`` (optional) is a flight-recorder
        :class:`~analytics_zoo_tpu_torch.common.flight_recorder.RequestRecord`;
        the flush and completion stages stamp their lifecycle
        timestamps onto it (a split request's chunks share one record —
        the last chunk's stamps win, which keeps the record's latency
        honest end to end).
        """
        if self.breaker is not None:
            self.breaker.allow()
        xs, multi, rows = self._normalize(x)
        if self.signature is not None:
            xs = self.signature.validate(xs)
            multi = self.signature.multi
        if timeout_ms is None:
            timeout_ms = self.config.timeout_ms
        deadline = (None if timeout_ms is None
                    else time.monotonic() + timeout_ms / 1e3)
        trace = None
        tracer = get_tracer()
        if tracer.enabled:
            cur = tracer.current()
            if cur is not None:
                trace = (cur.trace_id, cur.span_id, monotonic_s())
        max_b = self.config.max_batch_size
        if rows <= max_b:
            return self._enqueue_all(
                [_Request(xs, multi, rows, deadline, trace, fr)])[0]
        # split: every chunk rides the normal queue; the parent future
        # concatenates in order once the last chunk lands
        reqs = [_Request([a[i:i + max_b] for a in xs], multi,
                         min(max_b, rows - i), deadline, trace, fr)
                for i in range(0, rows, max_b)]
        futures = self._enqueue_all(reqs)
        parent: Future = Future()
        remaining = [len(futures)]
        agg_lock = threading.Lock()

        def _on_done(_f):
            with agg_lock:
                remaining[0] -= 1
                if remaining[0]:
                    return
            errs = [f.exception() for f in futures if f.exception()]
            if errs:
                _resolve(parent, error=errs[0])
            else:
                _resolve(parent,
                         result=_tree_concat([f.result() for f in futures]))

        for f in futures:
            f.add_done_callback(_on_done)
        return parent

    @staticmethod
    def _normalize(x) -> Tuple[List[np.ndarray], bool, int]:
        multi = isinstance(x, (list, tuple))
        xs = [np.asarray(a) for a in (x if multi else [x])]
        if not xs or any(a.ndim < 1 for a in xs):
            raise ValueError("submit expects batched input: every array "
                             "needs a leading batch axis")
        rows = xs[0].shape[0]
        if rows < 1:
            raise ValueError("submit got an empty batch")
        if any(a.shape[0] != rows for a in xs):
            raise ValueError("multi-input request with mismatched leading "
                             f"axes: {[a.shape[0] for a in xs]}")
        return xs, multi, rows

    def _enqueue_all(self, reqs: List[_Request]) -> List[Future]:
        with self._lock:
            if self._stopped:
                raise RuntimeError(f"batcher '{self.name}' is stopped")
            if len(self._queue) + len(reqs) > self.config.max_queue_size:
                if self.metrics:
                    self.metrics.rejected.inc(len(reqs))
                raise QueueFullError(
                    f"serving queue for '{self.name}' is full "
                    f"({self.config.max_queue_size} requests) — retry "
                    "later or scale out")
            deadline = reqs[-1].deadline  # split chunks share one deadline
            if self.admission is not None and deadline is not None:
                # estimated wait = batches that must flush before this
                # request's result, at the EWMA per-batch service time
                # (None until the first flush has been measured — never
                # shed on guesswork); dispatched-but-unscattered batches
                # in the completion stage count as batches ahead too
                total = self._queued_rows + sum(r.rows for r in reqs)
                max_b = self.config.max_batch_size
                ahead = (-(-total // max_b)
                         + (1 if self._inflight else 0)
                         + len(self._completion)
                         + (1 if self._completion_current is not None
                            else 0))
                est = self.admission.estimate_wait_s(ahead)
                now = time.monotonic()
                if est is not None and now + est > deadline:
                    if self.metrics:
                        self.metrics.shed("deadline_unmeetable").inc(
                            len(reqs))
                    raise ShedError(
                        f"'{self.name}': estimated queue wait "
                        f"{est * 1e3:.0f}ms exceeds the request deadline "
                        f"({(deadline - now) * 1e3:.0f}ms away) — shed "
                        "instead of queueing a guaranteed timeout",
                        retry_after_s=est)
            for r in reqs:
                self._queue.append(r)
                self._queued_rows += r.rows
            self._last_enqueue = time.monotonic()
            if self.metrics:
                self.metrics.requests.inc(len(reqs))
                self.metrics.queue_depth.set(len(self._queue))
            self._work.notify()
        return [r.future for r in reqs]

    # -- dispatch stage ---------------------------------------------------

    def _loop(self, gen: int = 0):
        while True:
            batch = self._gather(gen)
            if batch is None:
                # stopped-and-drained (or superseded): tell the completion
                # stage no more flights are coming so it can exit once its
                # backlog is scattered
                with self._lock:
                    if self._gen == gen and self._stopped:
                        self._dispatch_done = True
                        self._done.notify_all()
                return
            try:
                self._flush(batch, gen)
            except _chaos.FlushThreadDeath:
                # injected thread death (chaos matrix): exit with the
                # in-flight batch still recorded and its futures
                # unresolved — the exact silent-death state
                # check_flush_thread() exists to detect
                return
            except Exception as e:  # noqa: BLE001 — backstop: _flush fails
                # its own batch on assembly/model/scatter faults; anything
                # that still escapes (a metrics bug, say) must not kill the
                # worker with unresolved futures in hand
                for r in batch:
                    _resolve(r.future, error=e)
            with self._lock:
                if self._gen != gen:
                    return  # superseded by a watchdog restart mid-flush
                self._inflight = None
                self._heartbeat = time.monotonic()

    def _gather(self, gen: int = 0) -> Optional[List[_Request]]:
        cfg = self.config
        quiesce_s = (None if cfg.eager_flush_quiesce_ms is None
                     else cfg.eager_flush_quiesce_ms / 1e3)
        with self._lock:
            while not self._queue and not self._stopped:
                if self._gen != gen:
                    # pass the baton: a notify this superseded worker
                    # consumed must reach the replacement worker
                    self._work.notify()
                    return None
                self._work.wait()
            if self._gen != gen or not self._queue:
                self._work.notify()
                return None  # superseded, or stopped and drained
            self._heartbeat = time.monotonic()
            flush_at = self._queue[0].t_enqueue + cfg.max_wait_ms / 1e3
            while (self._queued_rows < cfg.max_batch_size
                   and not self._stopped):
                now = time.monotonic()
                remaining = flush_at - now
                if remaining <= 0:
                    break
                wait = remaining
                if (quiesce_s is not None
                        and not self._completion
                        and self._completion_current is None):
                    # eager flush: the device pipeline is idle, so
                    # holding this partial batch buys fill only while
                    # requests are still arriving — once the queue has
                    # been quiet for the quiesce window, flush what we
                    # have instead of idling out the max_wait timer
                    quiet_for = now - self._last_enqueue
                    if quiet_for >= quiesce_s:
                        break
                    wait = min(wait, quiesce_s - quiet_for)
                self._work.wait(wait)
                if self._gen != gen:
                    self._work.notify()
                    return None
                self._heartbeat = time.monotonic()
            if self._gen != gen:
                self._work.notify()
                return None
            take: List[_Request] = []
            rows = 0
            while self._queue and \
                    rows + self._queue[0].rows <= cfg.max_batch_size:
                r = self._queue.popleft()
                self._queued_rows -= r.rows
                take.append(r)
                rows += r.rows
            # record the in-flight batch under the same lock as the pop,
            # so restart_worker can fail exactly these futures
            self._inflight = take or None
            self._heartbeat = time.monotonic()
            if self.metrics:
                self.metrics.queue_depth.set(len(self._queue))
            return take

    def _bucket(self, rows: int) -> int:
        for b in self._ladder:
            if b >= rows:
                return b
        return self._ladder[-1]  # unreachable: rows <= max_batch_size

    # -- staging-buffer pool ----------------------------------------------

    def _staging_checkout(self, bucket: int) -> List[np.ndarray]:
        with self._staging_lock:
            pool = self._staging.get(bucket)
            if pool:
                return pool.pop()
        return [np.empty((bucket,) + shape, dtype)
                for shape, dtype in self.signature.specs]

    def _staging_release(self, bucket: int, lease: List[np.ndarray]):
        with self._staging_lock:
            pool = self._staging.setdefault(bucket, [])
            if len(pool) < self._staging_cap:
                pool.append(lease)

    # -- flush ------------------------------------------------------------

    def _flush(self, take: List[_Request], gen: int):
        m = self.metrics
        now = time.monotonic()
        live: List[_Request] = []
        for r in take:
            if r.deadline is not None and now > r.deadline:
                _resolve(r.future, error=DeadlineExceededError(
                    f"deadline exceeded after "
                    f"{(now - r.t_enqueue) * 1e3:.1f}ms in queue for "
                    f"'{self.name}'"))
                if m:
                    m.timeouts.inc()
            else:
                live.append(r)
        if not live:
            return
        for r in live:
            if r.fr is not None:
                r.fr.t_flush = now
        if m:
            m.queue_wait.observe_many(
                [now - r.t_enqueue for r in live],
                trace_ids=[r.fr.trace_id if r.fr is not None else None
                           for r in live])
        tracer = get_tracer()
        traced = [r for r in live if r.trace is not None] \
            if tracer.enabled else []
        if traced:
            # spans must attribute queue_wait/assembly/predict/scatter to
            # real wall intervals of THIS batch — run it synchronously
            self._flush_traced(live, traced, now, tracer)
            return
        lease = None
        try:
            # Assembly, dispatch and handoff all fail the batch, never the
            # loop: mixed arity / trailing dims are reachable here only on
            # signature-less batchers (the engine validates at submit), and
            # np.concatenate raising must not strand the live futures.
            arity = len(live[0].xs)
            for r in live[1:]:
                if len(r.xs) != arity:
                    raise ValueError(
                        f"batch mixes requests with {arity} and "
                        f"{len(r.xs)} input arrays — construct the "
                        "batcher with an InputSignature to reject these "
                        "at submit")
            n = sum(r.rows for r in live)
            bucket = self._bucket(n)
            batch, lease = self._assemble(live, n, bucket)
            arg = batch if live[0].multi else batch[0]
            # chaos points (no-ops unless armed): predict_raises fails
            # this batch inside the try; predict_slow stretches service
            # time; flush_thread_dies raises a BaseException that escapes
            # every Exception backstop and kills this worker; the canary_*
            # variants are the same faults gated on this batcher's tag
            _chaos.serving_chaos("flush_thread_dies")
            _chaos.serving_chaos("predict_slow")
            _chaos.serving_chaos("predict_raises")
            _chaos.serving_chaos("canary_slow", tag=self.chaos_tag)
            _chaos.serving_chaos("canary_errors", tag=self.chaos_tag)
            fn = self.dispatch_fn or self.predict_fn
            out = fn(arg)
            t_dispatch = time.monotonic()
            for r in live:
                if r.fr is not None:
                    r.fr.t_dispatch = t_dispatch
        except Exception as e:  # noqa: BLE001 — fail the batch, not the loop
            if lease is not None:
                # dispatch never happened; the buffer is free immediately
                self._staging_release(self._bucket(sum(r.rows
                                                       for r in live)),
                                      lease)
            if self.breaker is not None:
                self.breaker.record(False)
            for r in live:
                _resolve(r.future, error=e)
            if m:
                m.errors.inc(len(live))
            return
        flight = _Flight(live, out, n, bucket, lease, now)
        if self._depth < 1:
            # pipelining disabled: complete synchronously in this thread
            self._complete(flight)
            if lease is not None:
                self._staging_release(bucket, lease)
            return
        with self._lock:
            while (self._gen == gen
                   and len(self._completion)
                   + (1 if self._completion_current is not None else 0)
                   >= self._depth):
                self._space.wait()
            if self._gen != gen:
                self._space.notify()
                return  # restarted mid-flush: futures already failed
            self._completion.append(flight)
            self._inflight = None
            self._heartbeat = time.monotonic()
            if m:
                m.pipeline_inflight.set(
                    len(self._completion)
                    + (1 if self._completion_current is not None else 0))
            self._done.notify()

    def _assemble(self, live, n, bucket):
        """Build the bucket-shaped input list: a leased staging buffer
        when the signature pins trailing shapes, a fresh concatenation
        otherwise (including wildcard signatures — a wildcard dim cannot
        preallocate). Returns ``(batch arrays, lease-or-None)``."""
        if self.signature is not None and self.signature.fixed:
            lease = self._staging_checkout(bucket)
            off = 0
            for r in live:
                for buf, a in zip(lease, r.xs):
                    buf[off:off + r.rows] = a
                off += r.rows
            if bucket > n:
                for buf in lease:
                    buf[n:bucket] = 0
            return lease, lease
        batch = [np.concatenate(parts, axis=0)
                 for parts in zip(*[r.xs for r in live])]
        if bucket > n:
            batch = [np.concatenate(
                [a, np.zeros((bucket - n,) + a.shape[1:], a.dtype)],
                axis=0) for a in batch]
        return batch, None

    def _flush_traced(self, live, traced, now, tracer):
        """The synchronous flush used when the batch carries traced
        requests — identical observable semantics to the fast path, plus
        the per-request span set the observability contract pins."""
        m = self.metrics
        t_flush0 = monotonic_s()
        for r in live:
            if r.fr is not None:
                r.fr.t_flush = t_flush0
        for r in traced:
            tid, parent, t_sub = r.trace
            tracer.record_span("serving.queue_wait", tid, t_sub, t_flush0,
                               parent_id=parent, rows=r.rows)
        try:
            arity = len(live[0].xs)
            for r in live[1:]:
                if len(r.xs) != arity:
                    raise ValueError(
                        f"batch mixes requests with {arity} and "
                        f"{len(r.xs)} input arrays — construct the "
                        "batcher with an InputSignature to reject these "
                        "at submit")
            n = sum(r.rows for r in live)
            bucket = self._bucket(n)
            batch = [np.concatenate(parts, axis=0)
                     for parts in zip(*[r.xs for r in live])]
            if bucket > n:
                batch = [np.concatenate(
                    [a, np.zeros((bucket - n,) + a.shape[1:], a.dtype)],
                    axis=0) for a in batch]
            arg = batch if live[0].multi else batch[0]
            _chaos.serving_chaos("flush_thread_dies")
            _chaos.serving_chaos("predict_slow")
            _chaos.serving_chaos("predict_raises")
            _chaos.serving_chaos("canary_slow", tag=self.chaos_tag)
            _chaos.serving_chaos("canary_errors", tag=self.chaos_tag)
            t_assembled = monotonic_s()
            # a live context span grafted onto the FIRST traced request's
            # trace: the model's own spans (the inference.predict /
            # inference.compile pair) nest under it via the contextvar, so
            # at least one trace per batch carries the full depth; the
            # other members get a record_span copy below
            tid0, parent0, _ = traced[0].trace
            with tracer.span("serving.predict", trace_id=tid0,
                             parent_id=parent0, rows=n, bucket=bucket):
                out = self.predict_fn(arg)
            t_predicted = monotonic_s()
            for r in live:
                if r.fr is not None:
                    # synchronous path: dispatch and fetch coincide
                    r.fr.t_dispatch = t_predicted
                    r.fr.t_fetch = t_predicted
            for r in traced:
                tid, parent, _ = r.trace
                tracer.record_span("serving.batch_assembly", tid,
                                   t_flush0, t_assembled, parent_id=parent,
                                   rows=n, bucket=bucket)
                if r is not traced[0]:
                    tracer.record_span("serving.predict", tid,
                                       t_assembled, t_predicted,
                                       parent_id=parent, rows=n,
                                       bucket=bucket)
            if m:
                m.flushes.inc()
                m.rows.inc(n)
                m.padded_rows.inc(bucket - n)
                m.batch_fill.observe(n / bucket)
            done = time.monotonic()
            if self.breaker is not None:
                self.breaker.record(True)
            if self.admission is not None:
                # service time of this flush (assembly + predict), the
                # signal behind the submit-side queue-wait estimate
                self.admission.observe(done - now)
            off = 0
            for r in live:
                _resolve(r.future,
                         result=_tree_slice(out, off, off + r.rows))
                off += r.rows
                if m:
                    m.latency.observe(
                        done - r.t_enqueue,
                        trace_id=(r.fr.trace_id if r.fr is not None
                                  else None))
            t_done = monotonic_s()
            for r in live:
                if r.fr is not None:
                    r.fr.t_scatter = t_done
            for r in traced:
                tid, parent, _ = r.trace
                tracer.record_span("serving.result_scatter", tid,
                                   t_predicted, t_done,
                                   parent_id=parent)
        except Exception as e:  # noqa: BLE001 — fail the batch, not the loop
            if self.breaker is not None:
                self.breaker.record(False)
            for r in live:
                _resolve(r.future, error=e)
            if m:
                m.errors.inc(len(live))

    # -- completion stage -------------------------------------------------

    def _completion_loop(self, gen: int):
        while True:
            with self._lock:
                while True:
                    if self._gen != gen:
                        self._done.notify()  # baton to the replacement
                        return
                    if self._completion:
                        flight = self._completion.popleft()
                        self._completion_current = flight
                        self._heartbeat = time.monotonic()
                        self._space.notify()  # free dispatch capacity
                        break
                    if self._stopped and self._dispatch_done:
                        return
                    self._done.wait()
            self._complete(flight)
            with self._lock:
                if self._gen == gen:
                    if self._completion_current is flight:
                        self._completion_current = None
                    self._heartbeat = time.monotonic()
                    if flight.lease is not None:
                        # only a current-generation flight's device work is
                        # known finished; a superseded flight's buffer may
                        # still back an in-flight computation — drop it
                        self._staging_release(flight.bucket, flight.lease)
                    if self.metrics:
                        self.metrics.pipeline_inflight.set(
                            len(self._completion))
                    self._space.notify()

    def _complete(self, flight: _Flight):
        """Block on the flight's device output, record the flush outcome
        and scatter per-request result copies."""
        m = self.metrics
        live = flight.requests
        try:
            out = flight.out
            if self.fetch_fn is not None and self.dispatch_fn is not None:
                out = self.fetch_fn(out)
            t_fetch = time.monotonic()
            for r in live:
                if r.fr is not None:
                    r.fr.t_fetch = t_fetch
            if m:
                m.flushes.inc()
                m.rows.inc(flight.rows)
                m.padded_rows.inc(flight.bucket - flight.rows)
                m.batch_fill.observe(flight.rows / flight.bucket)
            done = time.monotonic()
            if self.breaker is not None:
                self.breaker.record(True)
            if self.admission is not None:
                # dispatch-to-scatter service time of this flush — with
                # the pipeline this includes completion queueing, which is
                # exactly what a new request would wait behind
                self.admission.observe(done - flight.t0)
            off = 0
            if isinstance(out, np.ndarray):
                # single-array output (the overwhelmingly common case):
                # skip the tree_map machinery, one private copy per row
                # range
                for r in live:
                    _resolve(r.future,
                             result=np.array(out[off:off + r.rows]))
                    off += r.rows
            else:
                for r in live:
                    _resolve(r.future,
                             result=_tree_slice(out, off, off + r.rows))
                    off += r.rows
            t_scatter = time.monotonic()
            for r in live:
                if r.fr is not None:
                    r.fr.t_scatter = t_scatter
            if m:
                m.latency.observe_many(
                    [done - r.t_enqueue for r in live],
                    trace_ids=[r.fr.trace_id if r.fr is not None else None
                               for r in live])
        except Exception as e:  # noqa: BLE001 — fail the batch, not the loop
            if self.breaker is not None:
                self.breaker.record(False)
            for r in live:
                _resolve(r.future, error=e)
            if m:
                m.errors.inc(len(live))

    # -- lifecycle --------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        """Requests currently waiting (not yet gathered into a flush)."""
        with self._lock:
            return len(self._queue)

    @property
    def pending_requests(self) -> int:
        """Requests queued, being dispatched, or dispatched and awaiting
        their result in the completion stage — what a drain waits to
        reach zero."""
        with self._lock:
            n = len(self._queue) + len(self._inflight or ())
            for fl in self._completion:
                n += len(fl.requests)
            if self._completion_current is not None:
                n += len(self._completion_current.requests)
            return n

    def check_flush_thread(self, stall_s: float = 30.0) -> Optional[str]:
        """Watchdog probe: restart the flush workers if either is dead
        (an escape killed it) or the pair is wedged (busy with no
        heartbeat for ``stall_s``). Returns the restart reason
        (``"died"`` / ``"wedged"``) or None when healthy. Called
        periodically by
        :class:`~analytics_zoo_tpu_torch.serving.resilience.FlushWatchdog`;
        safe to call directly."""
        with self._lock:
            if self._stopped:
                return None
            if not (self._worker.is_alive()
                    and self._completion_worker.is_alive()):
                reason = "died"
            else:
                busy = (bool(self._queue) or self._inflight is not None
                        or bool(self._completion)
                        or self._completion_current is not None)
                stale = time.monotonic() - self._heartbeat > stall_s
                if not (busy and stale):
                    return None
                reason = "wedged"
        self.restart_worker(reason)
        return reason

    def restart_worker(self, reason: str = "manual") -> None:
        """Replace the dispatch/completion thread pair, failing only the
        batches in flight (being dispatched, or dispatched and awaiting
        completion).

        The old threads cannot be killed; instead the generation token is
        bumped so each exits at its next queue interaction, and every
        batch they held is failed with
        :class:`~analytics_zoo_tpu_torch.serving.resilience
        .FlushThreadRestartedError` — a wedged thread's eventual late
        scatter then no-ops against the already-failed futures. Queued
        requests are untouched; the replacement threads serve them.
        No-op on a stopped batcher."""
        with self._lock:
            if self._stopped:
                return
            self._gen += 1
            gen = self._gen
            doomed: List[_Request] = list(self._inflight or ())
            self._inflight = None
            for fl in self._completion:
                doomed.extend(fl.requests)
            self._completion.clear()
            if self._completion_current is not None:
                doomed.extend(self._completion_current.requests)
                self._completion_current = None
            self._heartbeat = time.monotonic()
            if doomed:
                err = FlushThreadRestartedError(
                    f"flush thread of '{self.name}' restarted ({reason}) "
                    "with this batch in flight")
                for r in doomed:
                    _resolve(r.future, error=err)
            if self.metrics:
                if doomed:
                    self.metrics.errors.inc(len(doomed))
                self.metrics.watchdog_restarts.inc()
                self.metrics.pipeline_inflight.set(0)
            self._worker = threading.Thread(
                target=self._loop, args=(gen,), daemon=True,
                name=f"zoo-batcher-{self.name}-g{gen}")
            self._completion_worker = threading.Thread(
                target=self._completion_loop, args=(gen,), daemon=True,
                name=f"zoo-batcher-{self.name}-c-g{gen}")
            self._worker.start()
            self._completion_worker.start()
            self._work.notify_all()
            self._done.notify_all()
            self._space.notify_all()
        tracer = get_tracer()
        if tracer.enabled:
            t = monotonic_s()
            tracer.record_span("serving.watchdog_restart",
                               new_trace_id(), t, t,
                               model=self.name, reason=reason)
        # a restart is exactly the anomaly the flight recorder exists
        # for: snapshot the ring so the doomed requests' records (with
        # their last stamped stage) survive on disk
        get_flight_recorder().trigger("watchdog_restart")

    def stop(self, drain: bool = True, timeout: Optional[float] = 30.0):
        """Stop both flush workers. ``drain=True`` (default) serves what
        is already queued or in flight first; ``drain=False`` fails queued
        futures with ``RuntimeError`` immediately (dispatched batches
        still complete)."""
        with self._lock:
            self._stopped = True
            if not drain:
                while self._queue:
                    r = self._queue.popleft()
                    self._queued_rows -= r.rows
                    _resolve(r.future, error=RuntimeError(
                        f"batcher '{self.name}' stopped"))
            self._work.notify_all()
            self._done.notify_all()
            self._space.notify_all()
        self._worker.join(timeout=timeout)
        self._completion_worker.join(timeout=timeout)
