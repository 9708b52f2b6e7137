"""Sampled request/response capture on the serving engine.

The flywheel's intake: a :class:`CaptureTap` attached via
:meth:`ServingEngine.set_capture` samples live predict traffic with the
same error-diffusion discipline as shadow mirroring (a deterministic
``floor(f·N)±1`` of N requests at fraction ``f``, no RNG) and writes
post-``_normalize`` canonical inputs plus the model's predictions —
with the routed version, trace id and wall timestamp — through the
batch layer's atomic shard/manifest/COMMIT protocol.

Hot-path budget: the sampling decision and the pending-record
allocation happen on the *submit* thread (where the engine already
takes locks); the prediction's done-callback — which runs on the
batcher's flush thread — does exactly one ``Queue.put_nowait``. No
allocation, no lock, no serialization on the flush thread; a full queue
drops the sample (counted) rather than ever blocking it.

On-disk layout, per model::

    <root>/<model>/segment_00000/   shard_00000.jsonl, MANIFEST.json, …
    <root>/<model>/segment_00001/   …

A *segment* is one batch-output directory. The open segment accumulates
shards (cut every ``rows_per_shard`` rows, or by the time-based roll
after ``roll_interval_s`` of quiet — low-traffic capture still commits
within bounded delay); :meth:`CaptureTap.rotate` finalizes it (COMMIT
marker) and opens the next, which is how the retrain driver gets an
immutable, replayable snapshot while capture continues. A segment a
rollback implicates is quarantined in place (:func:`quarantine_segment`
drops a ``QUARANTINE`` marker) and skipped by replay forever after.

A tap restarted over a crashed predecessor's directory resumes the
unfinalized tail segment through :class:`ShardWriter`'s manifest-resume
path — committed shards stay, ``.tmp`` debris (the
``capture_writer_torn`` chaos drill) is swept.
"""

from __future__ import annotations

import json
import os
import queue
import re
import threading
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from analytics_zoo_tpu_torch.batch.writers import (
    JsonlShardWriter,
    job_complete,
)
from analytics_zoo_tpu_torch.common.observability import (
    capture_metrics,
    get_tracer,
    monotonic_s,
    new_trace_id,
)

__all__ = [
    "CAPTURE_FORMAT",
    "QUARANTINE",
    "CaptureConfig",
    "CaptureShardWriter",
    "CaptureTap",
    "committed_segments",
    "is_quarantined",
    "quarantine_segment",
    "segment_dirs",
]

#: Capture row schema version, recorded in every segment's job metadata.
CAPTURE_FORMAT = "azoo-capture-v1"

#: Marker file excluding a segment from replay (rollback quarantine).
QUARANTINE = "QUARANTINE"

_SEGMENT_PAT = re.compile(r"segment_(\d{5})$")


@dataclass(frozen=True)
class CaptureConfig:
    """Capture tap settings.

    Args:
      directory: capture root; each model gets ``<directory>/<model>/``.
      fraction: default sampling fraction (error-diffusion — exactly
        ``floor(f·N)±1`` of N requests), overridable per model in
        :meth:`CaptureTap.enable`.
      rows_per_shard: shard size inside a segment.
      roll_interval_s: commit a partial shard after this long with no
        appended row (the bounded-delay guarantee for quiet models).
      queue_capacity: submit→writer hand-off queue bound; a full queue
        drops samples (``zoo_capture_dropped_total{reason=queue_full}``)
        instead of ever blocking the flush thread.
      idle_poll_s: writer-thread wakeup used to evaluate time rolls when
        no records arrive.
    """

    directory: str
    fraction: float = 0.01
    rows_per_shard: int = 256
    roll_interval_s: Optional[float] = 2.0
    queue_capacity: int = 4096
    idle_poll_s: float = 0.2

    def __post_init__(self):
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(
                f"fraction must be in (0, 1], got {self.fraction}")
        if self.queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")


class _Sampler:
    """Error-diffusion sampler (the shadow-traffic discipline): a
    running accumulator gains ``fraction`` per request and fires on
    overflow, so N requests yield exactly ``floor(f·N)±1`` captures in
    any interleaving — the lock serializes the accumulator, making the
    count insensitive to concurrency.

    Sticky-routed traffic gets its own diffusion: a request carrying a
    route key accumulates in a *per-key* accumulator seeded with a
    deterministic hash phase, so each sticky tenant independently
    contributes ``floor(f·N_k)±1`` of its own N_k requests. Without
    this, interleaving patterns correlated with the route key (exactly
    what sticky routing produces) could systematically over- or
    under-sample a tenant — the "flywheel sticky-routing sampling bias"
    known issue. Keyless traffic keeps the single global accumulator;
    per-key state is a bounded LRU so a key churn can't grow memory."""

    __slots__ = ("fraction", "_acc", "_keyed", "_lock")

    #: Per-key accumulator cap — beyond this, the least-recently-seen
    #: key's phase is dropped (and deterministically re-derived from the
    #: key hash if it ever returns).
    MAX_KEYS = 4096

    def __init__(self, fraction: float):
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        self.fraction = float(fraction)
        self._acc = 0.0
        self._keyed: "OrderedDict[str, float]" = OrderedDict()
        self._lock = threading.Lock()

    @staticmethod
    def _phase(key: str) -> float:
        """A key's deterministic starting phase in [0, 1): spreads the
        first fire across keys (no thundering first-request capture of
        every tenant) while keeping per-key counts exact —
        ``floor(f·N_k + phase)`` is always ``floor(f·N_k)`` or one more."""
        return (zlib.crc32(key.encode("utf-8", "replace"))
                & 0xFFFFFFFF) / 2.0 ** 32

    def fire(self, key: Optional[str] = None) -> bool:
        with self._lock:
            if key is None:
                self._acc += self.fraction
                if self._acc >= 1.0 - 1e-12:
                    self._acc -= 1.0
                    return True
                return False
            acc = self._keyed.pop(key, None)
            if acc is None:
                acc = self._phase(key)
            acc += self.fraction
            fired = acc >= 1.0 - 1e-12
            if fired:
                acc -= 1.0
            self._keyed[key] = acc  # reinsert = most-recently-seen
            while len(self._keyed) > self.MAX_KEYS:
                self._keyed.popitem(last=False)
            return fired


class _Pending:
    """A sampled request awaiting its prediction. Allocated on the
    submit thread; the flush-thread done-callback only assigns ``y`` and
    enqueues the object."""

    __slots__ = ("model", "version", "x", "trace", "ts", "y")

    def __init__(self, model: str, version: str, x: Any, trace: str,
                 ts: float):
        self.model = model
        self.version = version
        self.x = x
        self.trace = trace
        self.ts = ts
        self.y = None


class CaptureShardWriter(JsonlShardWriter):
    """Jsonl shard writer for capture rows: blocks are lists of
    already-encoded row dicts, and the torn-write chaos drill is the
    capture-specific ``capture_writer_torn`` point."""

    torn_point = "capture_writer_torn"

    def _push(self, block: Any) -> None:
        if not isinstance(block, list):
            raise TypeError("CaptureShardWriter takes a list of row dicts")
        for row in block:
            self._buf.append(json.dumps(row))


def segment_dirs(model_dir: str) -> List[str]:
    """Every ``segment_NNNNN`` directory under a model's capture dir,
    in index order (committed or not)."""
    if not os.path.isdir(model_dir):
        return []
    out = []
    for name in os.listdir(model_dir):
        m = _SEGMENT_PAT.match(name)
        if m and os.path.isdir(os.path.join(model_dir, name)):
            out.append((int(m.group(1)), os.path.join(model_dir, name)))
    return [p for _, p in sorted(out)]


def is_quarantined(segment: str) -> bool:
    """True when a rollback excluded this segment from replay."""
    return os.path.isfile(os.path.join(segment, QUARANTINE))


def quarantine_segment(segment: str, reason: str = "") -> None:
    """Exclude ``segment`` from every future replay/retrain by dropping
    the ``QUARANTINE`` marker (idempotent). The data stays on disk for
    forensics — quarantine is a read-side filter, not a delete."""
    path = os.path.join(segment, QUARANTINE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps({"reason": reason, "ts": time.time()}))
    os.replace(tmp, path)


def committed_segments(model_dir: str) -> List[str]:
    """The replayable segments of a model: COMMIT marker present,
    QUARANTINE absent, in segment order — the only directories the
    flywheel's replay/retrain side ever reads."""
    return [s for s in segment_dirs(model_dir)
            if job_complete(s) and not is_quarantined(s)]


class CaptureTap:
    """The engine-side capture tap. Attach with
    ``engine.set_capture(tap)``, then :meth:`enable` per model.

    One background writer thread owns all filesystem work: it drains the
    hand-off queue, canonicalizes each sampled request
    (``DynamicBatcher._normalize`` — the same form the result cache
    keys), encodes per-row capture records and appends them to the
    model's open segment, evaluating time-based rolls between arrivals.
    """

    def __init__(self, config: CaptureConfig,
                 clock: Callable[[], float] = time.time):
        self.config = config
        self._clock = clock
        self._samplers: Dict[str, _Sampler] = {}
        self._q: "queue.Queue" = queue.Queue(maxsize=config.queue_capacity)
        self.metrics = capture_metrics()
        self._writers: Dict[str, CaptureShardWriter] = {}
        self._segments: Dict[str, str] = {}
        self._wlock = threading.RLock()
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="zoo-capture-writer", daemon=True)
        self._thread.start()

    # -- control plane ----------------------------------------------------

    def enable(self, model: str, fraction: Optional[float] = None) -> None:
        """Start sampling ``model`` at ``fraction`` (default: the
        config's). Re-enabling replaces the sampler (fresh accumulator)."""
        self._samplers[model] = _Sampler(
            self.config.fraction if fraction is None else fraction)

    def disable(self, model: str) -> None:
        """Stop sampling ``model`` (already-queued records still land)."""
        self._samplers.pop(model, None)

    def enabled(self, model: str) -> bool:
        """True when capture is active for ``model``."""
        return model in self._samplers

    def model_dir(self, model: str) -> str:
        """The model's capture root (segments live one level below)."""
        return os.path.join(self.config.directory, model)

    # -- hot path ---------------------------------------------------------

    def offer(self, model: str, version: str, x: Any, fut,
              trace: Optional[str] = None,
              route_key: Optional[str] = None) -> bool:
        """The engine's per-request hook (submit thread). Returns True
        iff the request was sampled. ``route_key`` (the sticky-routing
        key, when the request carried one) selects the per-key
        error-diffusion accumulator so sticky tenants are sampled
        exactly. The future's done-callback — flush thread — performs
        exactly one ``put_nowait``."""
        sampler = self._samplers.get(model)
        if sampler is None or self._closed or not sampler.fire(route_key):
            return False
        pending = _Pending(model, version, x, trace or new_trace_id(),
                           self._clock())
        q = self._q
        dropped = self.metrics["dropped"]

        def _done(f) -> None:
            try:
                if f.exception() is not None:
                    dropped.labels(reason="predict_failed").inc()
                    return
            except BaseException:  # noqa: BLE001 — cancelled future
                return
            pending.y = f.result()
            try:
                q.put_nowait(pending)
            except queue.Full:
                dropped.labels(reason="queue_full").inc()

        fut.add_done_callback(_done)
        self.metrics["sampled"].inc()
        return True

    # -- segment lifecycle ------------------------------------------------

    def rotate(self, model: str) -> Optional[str]:
        """Finalize the model's open segment (COMMIT marker — it becomes
        replayable) and let the next append open a fresh one. Returns
        the finalized segment's path, or None when nothing was open.
        Call :meth:`flush` first when queued records must be included."""
        with self._wlock:
            writer = self._writers.pop(model, None)
            segment = self._segments.pop(model, None)
            if writer is None:
                return None
            writer.finalize()
            return segment

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block until every record enqueued before this call has been
        written (not necessarily committed — see :meth:`rotate`)."""
        ev = threading.Event()
        self._q.put(("flush", ev))
        return ev.wait(timeout_s)

    def close(self, finalize: bool = True) -> None:
        """Stop the writer thread (draining the queue first); with
        ``finalize`` commit every open segment."""
        if self._closed:
            return
        self._closed = True
        self._q.put(("stop", None))
        self._thread.join(timeout=10.0)
        if finalize:
            with self._wlock:
                for model in list(self._writers):
                    writer = self._writers.pop(model)
                    self._segments.pop(model, None)
                    writer.finalize()

    # -- writer thread ----------------------------------------------------

    def _run(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=self.config.idle_poll_s)
            except queue.Empty:
                if self._closed:
                    return
                self._poll_rolls()
                continue
            if isinstance(item, tuple):
                kind, ev = item
                if kind == "stop":
                    return
                ev.set()
                continue
            self._write_one(item)
            self.metrics["queue_depth"].set(self._q.qsize())

    def _poll_rolls(self) -> None:
        with self._wlock:
            for writer in self._writers.values():
                writer.maybe_roll()

    def _writer_for(self, model: str) -> CaptureShardWriter:
        writer = self._writers.get(model)
        if writer is not None:
            return writer
        mdir = self.model_dir(model)
        os.makedirs(mdir, exist_ok=True)
        existing = segment_dirs(mdir)
        segment = None
        if existing:
            tail = existing[-1]
            if not job_complete(tail) and not is_quarantined(tail):
                segment = tail  # resume a crashed tap's open segment
        if segment is None:
            nxt = 0
            if existing:
                nxt = 1 + int(_SEGMENT_PAT.match(
                    os.path.basename(existing[-1])).group(1))
            segment = os.path.join(mdir, f"segment_{nxt:05d}")
        try:
            writer = CaptureShardWriter(
                segment, rows_per_shard=self.config.rows_per_shard,
                roll_interval_s=self.config.roll_interval_s,
                job_meta={"kind": "capture", "model": model,
                          "capture_format": CAPTURE_FORMAT},
                on_shard=self._make_on_shard(model))
        except ValueError:
            # resumable-looking tail with incompatible settings: leave it
            # (it stays uncommitted, replay ignores it) and start fresh
            nxt = 1 + int(_SEGMENT_PAT.match(
                os.path.basename(segment)).group(1))
            segment = os.path.join(mdir, f"segment_{nxt:05d}")
            writer = CaptureShardWriter(
                segment, rows_per_shard=self.config.rows_per_shard,
                roll_interval_s=self.config.roll_interval_s,
                job_meta={"kind": "capture", "model": model,
                          "capture_format": CAPTURE_FORMAT},
                on_shard=self._make_on_shard(model))
        self._writers[model] = writer
        self._segments[model] = segment
        return writer

    def _make_on_shard(self, model: str):
        shards = self.metrics["shards"]
        rows = self.metrics["rows"]

        def _on_shard(rec: Dict) -> None:
            shards.inc()
            rows.inc(rec["rows"])
            tracer = get_tracer()
            if tracer.enabled:
                t1 = monotonic_s()
                tracer.record_span(
                    "capture.shard", "capture",
                    t1 - rec.get("write_seconds", 0.0), t1,
                    model=model, shard=rec["index"], rows=rec["rows"])

        return _on_shard

    def _write_one(self, pending: _Pending) -> None:
        try:
            rows = _encode_rows(pending)
        except (ValueError, TypeError, IndexError):
            self.metrics["dropped"].labels(reason="encode_error").inc()
            return
        with self._wlock:
            self._writer_for(pending.model).append(rows)


def _encode_rows(pending: _Pending) -> List[Dict]:
    """Per-row capture records for one sampled request: canonical
    (post-``_normalize``) inputs with dtype strings, the prediction row,
    routed version, trace id and wall timestamp. Keys are terse — a
    capture dir holds millions of these.

    The engine hands the tap host numpy arrays (a served model's outputs
    are host float32, its bf16 compute included), so the dtype strings
    are numpy's and equal what the JAX package's tap records for the same
    model; a card tensor is not encodable and counts as
    ``encode_error``."""
    # imported here: capture must not pull the serving stack in for
    # readers (replay/inspect) that only touch the on-disk format
    from analytics_zoo_tpu_torch.serving.batcher import DynamicBatcher

    xs, xmulti, n = DynamicBatcher._normalize(pending.x)
    y = pending.y
    ymulti = isinstance(y, (list, tuple))
    ys = [np.asarray(a) for a in (y if ymulti else [y])]
    for a in ys:
        if a.ndim < 1 or a.shape[0] != n:
            raise ValueError(
                f"prediction rows ({a.shape[0] if a.ndim else 0}) do not "
                f"match request rows ({n})")
    out = []
    for i in range(n):
        out.append({
            "x": [a[i].tolist() for a in xs],
            "xd": [a.dtype.str for a in xs],
            "xm": xmulti,
            "y": [a[i].tolist() for a in ys],
            "yd": [a.dtype.str for a in ys],
            "ym": ymulti,
            "v": pending.version,
            "t": pending.trace,
            "ts": pending.ts,
        })
    return out
