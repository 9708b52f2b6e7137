"""The outcome plane's label side: ingest, watermark join, replay.

Without labels the flywheel retrains on its own predictions
(self-distillation). This module closes the real loop: delayed ground-truth *outcomes* —
``{trace_id, label, ts}`` records POSTed to
``/v1/models/<name>:outcome`` — are buffered through a
:class:`LabelStore` into the same atomic shard/manifest/COMMIT protocol
the capture tap uses (:mod:`analytics_zoo_tpu_torch.batch.writers`), joined
back onto capture segments by the trace id every captured row already
carries (the ``"t"`` field), and replayed as a
:class:`LabeledSource` whose targets are outcomes, not predictions.

On-disk layout, beside the capture segments::

    <root>/<model>/segment_00000/          capture (the tap's output)
    <root>/<model>/labels/segment_00000/   labels  (this module's)

A label segment is one batch-output directory: jsonl shards of
``{"t": trace_id, "y": label, "ts": wall_ts}`` rows, manifest-listed,
COMMIT-marked on rotate, quarantinable, resumable after a crash — the
``label_writer_torn`` chaos point drills the torn-write geometry
exactly like ``capture_writer_torn``.

Late and out-of-order labels are the normal case, not the exception:
ingestion order is irrelevant because the join is keyed and the
duplicate rule is order-free. :class:`LabelJoiner` maintains a
*watermark* (the max label ``ts`` across committed label segments);
``labels_closed(segment)`` means the watermark passed the capture
segment's max request timestamp plus a grace window — only then does
the retrain trust the join as complete and train against outcomes
(:class:`~analytics_zoo_tpu_torch.flywheel.trainer.FlywheelTrainer` falls
back to self-distillation otherwise). Unmatched labels are counted and
retained in their segments (quarantine/retention is a read-side filter,
never a delete); duplicate labels resolve last-write-wins by ``ts``
(ties by the serialized label, so the winner is a pure function of the
record *set*, independent of arrival or shard order — what makes a
shuffled ingest bitwise identical to an in-order one).
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.batch.writers import (
    JsonlShardWriter,
    iter_output_rows,
    job_complete,
)
from analytics_zoo_tpu_torch.common.observability import label_metrics
from analytics_zoo_tpu_torch.flywheel.capture import (
    _SEGMENT_PAT,
    committed_segments,
    is_quarantined,
    segment_dirs,
)
from analytics_zoo_tpu_torch.flywheel.replay import CaptureSource

__all__ = [
    "LABEL_FORMAT",
    "LABELS_DIRNAME",
    "LabelShardWriter",
    "LabelStore",
    "LabelJoiner",
    "LabeledSource",
    "labels_dir_for",
]

#: Label row schema version, recorded in every label segment's job meta.
LABEL_FORMAT = "azoo-labels-v1"

#: Subdirectory of a model's capture dir holding its label segments.
LABELS_DIRNAME = "labels"


def labels_dir_for(model_dir: str) -> str:
    """The label-segment root beside a model's capture segments."""
    return os.path.join(model_dir, LABELS_DIRNAME)


class LabelShardWriter(JsonlShardWriter):
    """Jsonl shard writer for label rows: blocks are lists of
    already-encoded row dicts, and the torn-write chaos drill is the
    label-specific ``label_writer_torn`` point."""

    torn_point = "label_writer_torn"

    def _push(self, block: Any) -> None:
        if not isinstance(block, list):
            raise TypeError("LabelShardWriter takes a list of row dicts")
        for row in block:
            self._buf.append(json.dumps(row))


def _label_key(label: Any) -> str:
    """Order-free duplicate tiebreak: the canonical JSON of the label
    (sorted keys), so 'larger' is a deterministic total order over
    values, never over arrival positions."""
    return json.dumps(label, sort_keys=True)


def _validate_record(rec: Any, clock: Callable[[], float]
                     ) -> Tuple[str, Any, float]:
    if not isinstance(rec, dict):
        raise ValueError("an outcome record must be a JSON object with "
                         "'trace_id' and 'label' fields")
    trace = rec.get("trace_id")
    if not isinstance(trace, str) or not trace:
        raise ValueError("outcome record needs a non-empty string "
                         "'trace_id'")
    if "label" not in rec:
        raise ValueError(f"outcome record for trace {trace!r} has no "
                         "'label'")
    label = rec["label"]
    try:
        json.dumps(label)
    except (TypeError, ValueError):
        raise ValueError(
            f"label for trace {trace!r} is not JSON-encodable") from None
    ts = rec.get("ts")
    if ts is None:
        ts = clock()
    try:
        ts = float(ts)
    except (TypeError, ValueError):
        raise ValueError(
            f"outcome record for trace {trace!r} has a non-numeric "
            f"'ts': {rec.get('ts')!r}") from None
    return trace, label, ts


class LabelStore:
    """The ingestion side: buffers outcome records into the model's
    open label segment through the atomic commit protocol.

    Shares the capture tap's root (``directory`` is the capture root;
    model ``m``'s labels land in ``<directory>/m/labels/``). Writes are
    synchronous under a lock — outcome ingestion is off the predict hot
    path entirely (its own HTTP route), so the simple discipline wins:
    a record accepted by :meth:`ingest` is buffered in the writer, and
    durable at the next shard cut, roll, or :meth:`rotate`. A store
    reopened over a crashed predecessor's directory resumes the
    unfinalized tail segment exactly like the tap does; ``.tmp`` debris
    from the ``label_writer_torn`` drill is swept by the writer."""

    def __init__(self, directory: str, rows_per_shard: int = 512,
                 roll_interval_s: Optional[float] = 2.0,
                 clock: Callable[[], float] = time.time):
        if rows_per_shard < 1:
            raise ValueError(
                f"rows_per_shard must be >= 1, got {rows_per_shard}")
        self.directory = str(directory)
        self.rows_per_shard = int(rows_per_shard)
        self.roll_interval_s = roll_interval_s
        self._clock = clock
        self.metrics = label_metrics()
        self._writers: Dict[str, LabelShardWriter] = {}
        self._segments: Dict[str, str] = {}
        self._received: Dict[str, int] = {}
        self._dup_seen: Dict[str, int] = {}
        self._lock = threading.RLock()
        self._closed = False

    # -- layout -----------------------------------------------------------

    def model_dir(self, model: str) -> str:
        """The model's capture root (labels live one level below)."""
        return os.path.join(self.directory, model)

    def labels_dir(self, model: str) -> str:
        """The model's label-segment root."""
        return labels_dir_for(self.model_dir(model))

    # -- ingest -----------------------------------------------------------

    def ingest(self, model: str, records: Sequence[Any]) -> Dict[str, Any]:
        """Buffer a batch of validated ``{trace_id, label, ts}`` records
        into the model's open label segment. Invalid records raise
        ``ValueError`` (HTTP 400) with nothing buffered — a batch is
        accepted whole or not at all. Returns ``{"accepted": n}``."""
        if self._closed:
            raise RuntimeError("label store is closed")
        if not isinstance(model, str) or not model:
            raise ValueError("model name must be a non-empty string")
        rows = []
        for rec in records:
            trace, label, ts = _validate_record(rec, self._clock)
            rows.append({"t": trace, "y": label, "ts": ts})
        if not rows:
            raise ValueError("no outcome records in request")
        with self._lock:
            writer = self._writer_for(model)
            writer.append(rows)
            self._received[model] = self._received.get(model, 0) + len(rows)
        self.metrics["received"].inc(len(rows))
        return {"accepted": len(rows)}

    # -- segment lifecycle ------------------------------------------------

    def rotate(self, model: str) -> Optional[str]:
        """Finalize the model's open label segment (COMMIT marker — the
        joiner starts trusting it) and let the next ingest open a fresh
        one. Returns the finalized segment's path, or None."""
        with self._lock:
            writer = self._writers.pop(model, None)
            segment = self._segments.pop(model, None)
            if writer is None:
                return None
            writer.finalize()
            return segment

    def flush(self, model: Optional[str] = None) -> None:
        """Commit buffered partial shards now (without finalizing the
        segment) — the bounded-delay lever for quiet models."""
        with self._lock:
            writers = ([self._writers[model]] if model is not None
                       and model in self._writers
                       else list(self._writers.values()))
            for w in writers:
                w.roll()

    def poll(self) -> None:
        """Evaluate time-based partial-shard rolls for every open
        segment (callers own the clock, like the capture tap's writer
        thread does for capture)."""
        with self._lock:
            for w in self._writers.values():
                w.maybe_roll()

    def close(self, finalize: bool = True) -> None:
        """Stop ingesting; with ``finalize`` commit every open segment."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for model in list(self._writers):
                writer = self._writers.pop(model)
                self._segments.pop(model, None)
                if finalize:
                    writer.finalize()
                else:
                    writer.roll()

    def _writer_for(self, model: str) -> LabelShardWriter:
        writer = self._writers.get(model)
        if writer is not None:
            return writer
        ldir = self.labels_dir(model)
        os.makedirs(ldir, exist_ok=True)
        existing = segment_dirs(ldir)
        segment = None
        if existing:
            tail = existing[-1]
            if not job_complete(tail) and not is_quarantined(tail):
                segment = tail  # resume a crashed store's open segment
        if segment is None:
            nxt = 0
            if existing:
                nxt = 1 + int(_SEGMENT_PAT.match(
                    os.path.basename(existing[-1])).group(1))
            segment = os.path.join(ldir, f"segment_{nxt:05d}")
        meta = {"kind": "labels", "model": model,
                "label_format": LABEL_FORMAT}
        try:
            writer = LabelShardWriter(
                segment, rows_per_shard=self.rows_per_shard,
                roll_interval_s=self.roll_interval_s, job_meta=meta,
                on_shard=self._on_shard)
        except ValueError:
            # resumable-looking tail with incompatible settings: leave
            # it (uncommitted — the joiner ignores it) and start fresh
            nxt = 1 + int(_SEGMENT_PAT.match(
                os.path.basename(segment)).group(1))
            segment = os.path.join(ldir, f"segment_{nxt:05d}")
            writer = LabelShardWriter(
                segment, rows_per_shard=self.rows_per_shard,
                roll_interval_s=self.roll_interval_s, job_meta=meta,
                on_shard=self._on_shard)
        self._writers[model] = writer
        self._segments[model] = segment
        return writer

    def _on_shard(self, rec: Dict) -> None:
        self.metrics["shards"].inc()
        self.metrics["rows"].inc(rec["rows"])

    # -- status -----------------------------------------------------------

    def describe(self, model: str, grace_s: float = 0.0) -> Dict[str, Any]:
        """The model's outcome-plane status (the ``GET
        /v1/models/<name>`` block): labels received this process, rows
        durably committed, watermark, join lag and match counts against
        the model's committed capture segments."""
        joiner = self.joiner(model, grace_s=grace_s)
        stats = joiner.stats()
        with self._lock:
            stats["received"] = self._received.get(model, 0)
            stats["open_segment"] = (
                os.path.basename(self._segments[model])
                if model in self._segments else None)
        if stats["watermark"] is not None:
            self.metrics["watermark"].labels(model=model).set(
                stats["watermark"])
        self.metrics["unmatched"].labels(model=model).set(
            stats["unmatched_labels"])
        self.metrics["join_lag"].labels(model=model).set(
            stats["join_lag_s"])
        delta = stats["duplicates"] - self._dup_seen.get(model, 0)
        if delta > 0:
            self.metrics["duplicates"].inc(delta)
            self._dup_seen[model] = stats["duplicates"]
        return stats

    def joiner(self, model: str, grace_s: float = 0.0) -> "LabelJoiner":
        """A :class:`LabelJoiner` over this model's capture + label
        trees."""
        return LabelJoiner(self.model_dir(model), self.labels_dir(model),
                           grace_s=grace_s)


class _LabelScan:
    """One pass over committed label segments: the keyed last-write-wins
    map, the duplicate count, and the watermark."""

    __slots__ = ("by_trace", "total", "duplicates", "watermark",
                 "segments")

    def __init__(self, label_segments: Sequence[str]):
        self.by_trace: Dict[str, Tuple[float, str, Any]] = {}
        self.total = 0
        self.duplicates = 0
        self.watermark: Optional[float] = None
        self.segments = list(label_segments)
        for seg in self.segments:
            for row in iter_output_rows(seg):
                trace, label, ts = row["t"], row["y"], float(row["ts"])
                self.total += 1
                if self.watermark is None or ts > self.watermark:
                    self.watermark = ts
                cur = self.by_trace.get(trace)
                if cur is None:
                    self.by_trace[trace] = (ts, _label_key(label), label)
                    continue
                self.duplicates += 1
                key = _label_key(label)
                # last-write-wins by ts; ties resolved by the canonical
                # label JSON — a total order over the record SET, so the
                # winner is independent of ingest/shard order
                if (ts, key) > (cur[0], cur[1]):
                    self.by_trace[trace] = (ts, key, label)


class LabelJoiner:
    """Streaming join of label segments onto capture segments.

    ``capture_dir`` is the model's capture root
    (``<root>/<model>/``) and ``labels_dir`` its label root
    (``<root>/<model>/labels/``). Only *committed*, non-quarantined
    segments on either side participate — the same trust boundary as
    every other reader of the shard protocol.

    The watermark is the max label ``ts`` across committed label rows.
    ``labels_closed(segment)`` — watermark ≥ the capture segment's max
    request ``ts`` + ``grace_s`` — is the retrain's green light: any
    label for that window that will ever arrive in order-bounded
    lateness has arrived. Labels matching no capture row are *orphans*:
    counted, never dropped (their segments stay on disk until an
    operator expires them), so a capture segment that shows up late
    still finds them."""

    def __init__(self, capture_dir: str, labels_dir: str,
                 grace_s: float = 0.0):
        if grace_s < 0:
            raise ValueError(f"grace_s must be >= 0, got {grace_s}")
        self.capture_dir = str(capture_dir)
        self.labels_dir = str(labels_dir)
        self.grace_s = float(grace_s)
        self._scan_cache: Optional[Tuple[Tuple[str, ...], _LabelScan]] = None
        self._seg_ts: Dict[str, Tuple[Optional[float], Optional[float]]] = {}

    # -- label side -------------------------------------------------------

    def label_segments(self) -> List[str]:
        """Committed, non-quarantined label segments, in index order."""
        return committed_segments(self.labels_dir)

    def _scan(self, label_segments: Optional[Sequence[str]] = None
              ) -> _LabelScan:
        segs = (list(label_segments) if label_segments is not None
                else self.label_segments())
        key = tuple(segs)
        cached = self._scan_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        scan = _LabelScan(segs)
        self._scan_cache = (key, scan)
        return scan

    def watermark(self, label_segments: Optional[Sequence[str]] = None
                  ) -> Optional[float]:
        """Max label ``ts`` across committed label rows (None when no
        labels have been committed)."""
        return self._scan(label_segments).watermark

    # -- capture side -----------------------------------------------------

    def capture_segments(self) -> List[str]:
        """Committed, non-quarantined capture segments of the model."""
        return committed_segments(self.capture_dir)

    def segment_ts_range(self, segment: str
                         ) -> Tuple[Optional[float], Optional[float]]:
        """(min, max) request ``ts`` of a committed capture segment
        (cached — segments are immutable once committed)."""
        segment = str(segment)
        got = self._seg_ts.get(segment)
        if got is not None:
            return got
        lo: Optional[float] = None
        hi: Optional[float] = None
        for row in iter_output_rows(segment):
            ts = float(row["ts"])
            lo = ts if lo is None or ts < lo else lo
            hi = ts if hi is None or ts > hi else hi
        self._seg_ts[segment] = (lo, hi)
        return lo, hi

    def labels_closed(self, segment: str,
                      label_segments: Optional[Sequence[str]] = None
                      ) -> bool:
        """True when the watermark passed the capture segment's max
        request ts + grace — the join over this segment is complete."""
        _, hi = self.segment_ts_range(segment)
        if hi is None:
            return True  # an empty segment has nothing left to join
        wm = self.watermark(label_segments)
        return wm is not None and wm >= hi + self.grace_s

    # -- the join ---------------------------------------------------------

    def join(self, segments: Optional[Sequence[str]] = None,
             label_segments: Optional[Sequence[str]] = None
             ) -> "LabeledSource":
        """The joined, replayable source over ``segments`` (default:
        every committed capture segment)."""
        segs = (list(segments) if segments is not None
                else self.capture_segments())
        scan = self._scan(label_segments)
        return LabeledSource(segs, label_map=scan.by_trace)

    def stats(self, segments: Optional[Sequence[str]] = None,
              now: Optional[float] = None) -> Dict[str, Any]:
        """The outcome plane's health snapshot: label totals, duplicate
        and orphan counts, watermark, per-window match coverage and the
        join lag (how far the newest capture data is ahead of the
        watermark; 0 when every segment is closed)."""
        segs = (list(segments) if segments is not None
                else self.capture_segments())
        scan = self._scan()
        matched = 0
        captured = 0
        matched_traces: set = set()
        open_segments = []
        newest_capture: Optional[float] = None
        for seg in segs:
            _, hi = self.segment_ts_range(seg)
            if hi is not None and (newest_capture is None
                                   or hi > newest_capture):
                newest_capture = hi
            closed = (hi is None or (scan.watermark is not None
                                     and scan.watermark >= hi
                                     + self.grace_s))
            if not closed:
                open_segments.append(os.path.basename(seg))
            for row in iter_output_rows(seg):
                captured += 1
                if row["t"] in scan.by_trace:
                    matched += 1
                    matched_traces.add(row["t"])
        unmatched = len(scan.by_trace) - len(matched_traces)
        join_lag = 0.0
        if newest_capture is not None:
            wm = scan.watermark if scan.watermark is not None \
                else float("-inf")
            join_lag = max(0.0, newest_capture + self.grace_s - wm)
        return {
            "labels_total": scan.total,
            "labels_unique": len(scan.by_trace),
            "duplicates": scan.duplicates,
            "matched_rows": matched,
            "captured_rows": captured,
            "completeness": (matched / captured) if captured else 1.0,
            "unmatched_labels": unmatched,
            "watermark": scan.watermark,
            "join_lag_s": join_lag,
            "open_segments": open_segments,
            "label_segments": len(scan.segments),
        }


class LabeledSource(CaptureSource):
    """Committed capture segments joined with outcome labels: ``(x,
    outcome)`` samples — the target is the ground truth a client
    reported for the trace, not the incumbent's prediction. Rows
    without a label are skipped (they exist in the capture stream but
    never reach the pipeline), so length equals the matched-row count.

    Ordering is the capture stream's (segment → shard → row), and the
    label map is a pure function of the committed label record set —
    two constructions over the same committed data yield the same byte
    stream whatever order the labels arrived in.
    """

    def __init__(self, dirs, label_map: Optional[Dict] = None,
                 label_dirs=None):
        super().__init__(dirs)
        if label_map is None:
            if label_dirs is None:
                raise ValueError(
                    "LabeledSource needs label_map or label_dirs")
            if isinstance(label_dirs, (str, os.PathLike)):
                label_dirs = [label_dirs]
            segs: List[str] = []
            for d in map(str, label_dirs):
                if os.path.isfile(os.path.join(d, "MANIFEST.json")):
                    segs.append(d)
                else:
                    segs.extend(committed_segments(d))
            label_map = _LabelScan(segs).by_trace
        self._labels = label_map
        # the joined index: capture row i participates iff its trace
        # has a winning label — built once, stable forever
        index: List[int] = []
        pos = 0
        for k in range(len(self._shards)):
            for row in self._shard_rows(k):
                if row["t"] in label_map:
                    index.append(pos)
                pos += 1
        self._joined = index

    def __len__(self) -> int:
        return len(self._joined)

    def fetch(self, j: int):
        if not 0 <= j < len(self._joined):
            raise IndexError(j)
        i = self._joined[j]
        k = bisect.bisect_right(self._offsets, i) - 1
        row = self._shard_rows(k)[i - self._offsets[k]]
        x, _pred = _decode_capture_row(row)
        _ts, _key, label = self._labels[row["t"]]
        return x, np.asarray(label, dtype=np.float32)


def _decode_capture_row(row: Dict):
    from analytics_zoo_tpu_torch.flywheel.replay import _decode_row

    return _decode_row(row)
