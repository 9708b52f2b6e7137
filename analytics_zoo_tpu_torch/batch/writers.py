"""Sharded batch-scoring output with an atomic per-shard commit protocol
(port of ``analytics_zoo_tpu.batch.writers``; the on-disk format is the
JAX package's, byte for byte).

A batch-predict job's output is a *directory* of fixed-size row shards
plus a manifest — the nnframes analogue of ``NNModel.transform`` writing
a scored DataFrame back to distributed storage, rebuilt on the ft commit
protocol (:mod:`analytics_zoo_tpu_torch.ft.atomic`) so a crashed or preempted
job can never leave output a reader mistakes for complete:

1. every shard stages as ``<name>.tmp``, is fsynced, then atomically
   renamed into place (``os.replace``);
2. only then does ``MANIFEST.json`` record it — and the manifest itself
   updates through the same ``tmp``/fsync/replace dance, so a reader
   either sees the previous manifest or the new one, never a torn file;
3. a ``COMMIT`` marker lands LAST, when the final shard (the partial
   tail) is recorded — its absence means "job in progress or dead",
   exactly like an uncommitted checkpoint directory.

The manifest carries, per shard, the absolute row range
``[start_row, end_row)`` and a CRC32 over the shard file's bytes:
:func:`verify_output` recomputes both (contiguity + checksums) and
raises :class:`ShardCorruptError` — a
:class:`~analytics_zoo_tpu_torch.ft.atomic.CheckpointCorruptError` subclass,
the same loud-failure contract — on any damage. A shard file on disk
that the manifest does not list is crash debris (death between rename
and manifest update), reported as UNCOMMITTED and safely overwritten by
the resumed job when it re-cuts that shard.

Formats: ``npy`` (one ``np.save`` array per shard — single-output
models) and ``jsonl`` (one JSON row per line — anything nested,
multi-output included). Kill sites ``batch_writer_torn`` /
``batch_before_manifest`` (:data:`analytics_zoo_tpu_torch.ft.chaos
.BATCH_POINTS`) live inside :meth:`ShardWriter._commit_shard`.
"""

from __future__ import annotations

import io
import json
import os
import re
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from analytics_zoo_tpu_torch.common.observability import get_tracer, monotonic_s
from analytics_zoo_tpu_torch.ft import chaos
from analytics_zoo_tpu_torch.ft.atomic import (
    CheckpointCorruptError,
    _fsync_dir,
    _fsync_file,
)

__all__ = [
    "FORMAT",
    "MANIFEST",
    "COMMIT",
    "OutputSpec",
    "ShardWriter",
    "NpyShardWriter",
    "JsonlShardWriter",
    "ShardCorruptError",
    "read_manifest",
    "read_commit",
    "job_complete",
    "committed_rows",
    "verify_output",
    "load_shard_rows",
    "iter_output_rows",
]

FORMAT = "azoo-batch-v1"
MANIFEST = "MANIFEST.json"
COMMIT = "COMMIT"

_SHARD_PAT = re.compile(r"shard_(\d{5})\.(npy|jsonl)$")


class ShardCorruptError(CheckpointCorruptError):
    """A committed shard failed integrity checks (CRC mismatch, missing
    file, or a non-contiguous row range) — external damage, since the
    commit protocol cannot produce this state."""


def _shard_name(index: int, suffix: str) -> str:
    return f"shard_{index:05d}.{suffix}"


def _atomic_write(directory: str, name: str, payload: bytes,
                  torn_point: Optional[str] = None) -> None:
    """Stage ``payload`` as ``<name>.tmp``, fsync, atomically replace
    ``<name>``, fsync the directory. ``torn_point`` names the chaos kill
    site that leaves half the bytes staged (the torn-write drill)."""
    tmp = os.path.join(directory, name + ".tmp")
    with open(tmp, "wb") as f:
        if torn_point is not None and chaos.should_fail(torn_point):
            f.write(payload[: max(1, len(payload) // 2)])
            _fsync_file(f)
            chaos.fail(torn_point)
        f.write(payload)
        _fsync_file(f)
    os.replace(tmp, os.path.join(directory, name))
    _fsync_dir(directory)


class OutputSpec:
    """Where and how a batch-predict job writes: output ``directory``,
    shard ``fmt`` (``"npy"`` or ``"jsonl"``) and ``rows_per_shard``.
    :meth:`writer` opens the matching :class:`ShardWriter` (appending to
    an existing manifest when the directory holds a resumable job)."""

    def __init__(self, directory: str, fmt: str = "npy",
                 rows_per_shard: int = 4096,
                 roll_interval_s: Optional[float] = None):
        if fmt not in ("npy", "jsonl"):
            raise ValueError(f"fmt must be 'npy' or 'jsonl', got {fmt!r}")
        if rows_per_shard < 1:
            raise ValueError(
                f"rows_per_shard must be >= 1, got {rows_per_shard}")
        self.directory = str(directory)
        self.fmt = fmt
        self.rows_per_shard = int(rows_per_shard)
        self.roll_interval_s = roll_interval_s

    def writer(self, job_meta: Optional[Dict] = None,
               on_shard: Optional[Callable[[Dict], None]] = None
               ) -> "ShardWriter":
        """The :class:`ShardWriter` for this spec (``on_shard`` fires
        after every durable shard commit with the manifest record)."""
        cls = NpyShardWriter if self.fmt == "npy" else JsonlShardWriter
        return cls(self.directory, rows_per_shard=self.rows_per_shard,
                   job_meta=job_meta, on_shard=on_shard,
                   roll_interval_s=self.roll_interval_s)


class ShardWriter:
    """Accumulate scored row blocks and commit fixed-size shards through
    the atomic protocol. Opening a directory that already holds a
    (COMMIT-less) manifest resumes it: committed shards stay, the next
    shard index and absolute row offset continue from the manifest, and
    ``*.tmp`` staging debris is swept. ``finalize()`` flushes the partial
    tail shard and drops the COMMIT marker — only then is the output
    complete for :func:`job_complete` readers.

    With ``roll_interval_s`` set, :meth:`maybe_roll` commits the buffered
    partial shard once that many seconds pass with no append — the
    time-based roll that bounds commit delay for trickle producers
    (capture taps on low-traffic models) whose buffers might otherwise
    sit below ``rows_per_shard`` forever. Rolled shards go through the
    identical commit protocol and counters; only their row count is
    smaller. The caller owns the clock: nothing rolls unless something
    periodically calls :meth:`maybe_roll` (or :meth:`roll` to force)."""

    suffix = ""
    fmt = ""
    # chaos kill sites used by _commit_shard — subclass-overridable so
    # capture shards drill their own torn-write point
    torn_point = "batch_writer_torn"
    manifest_point = "batch_before_manifest"

    def __init__(self, directory: str, rows_per_shard: int = 4096,
                 job_meta: Optional[Dict] = None,
                 on_shard: Optional[Callable[[Dict], None]] = None,
                 roll_interval_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if rows_per_shard < 1:
            raise ValueError(
                f"rows_per_shard must be >= 1, got {rows_per_shard}")
        if roll_interval_s is not None and roll_interval_s <= 0:
            raise ValueError(
                f"roll_interval_s must be > 0, got {roll_interval_s}")
        self.directory = str(directory)
        self.rows_per_shard = int(rows_per_shard)
        self.on_shard = on_shard
        self.roll_interval_s = roll_interval_s
        self._clock = clock
        self._last_activity = clock()
        self._finalized = False
        os.makedirs(self.directory, exist_ok=True)
        for fname in os.listdir(self.directory):
            if fname.endswith(".tmp"):  # staging debris from a crash
                os.unlink(os.path.join(self.directory, fname))
        existing = read_manifest(self.directory)
        if existing is not None:
            if existing.get("output_format") != self.fmt:
                raise ValueError(
                    f"existing manifest in {self.directory!r} is "
                    f"{existing.get('output_format')!r}, this writer "
                    f"writes {self.fmt!r}")
            if int(existing.get("rows_per_shard", -1)) != self.rows_per_shard:
                raise ValueError(
                    f"existing manifest has rows_per_shard="
                    f"{existing.get('rows_per_shard')}, this writer was "
                    f"opened with {self.rows_per_shard} — shard ranges "
                    "would not line up")
            self._shards: List[Dict] = list(existing["shards"])
            self._job_meta = dict(existing.get("job", {}))
            if job_meta:
                self._job_meta.update(job_meta)
        else:
            self._shards = []
            self._job_meta = dict(job_meta or {})

    # -- resume surface ---------------------------------------------------

    @property
    def shards_committed(self) -> int:
        """Shards durably recorded in the manifest."""
        return len(self._shards)

    @property
    def rows_committed(self) -> int:
        """Rows durably recorded (the resumed job's start offset)."""
        return self._shards[-1]["end_row"] if self._shards else 0

    # -- append path ------------------------------------------------------

    def _buffered(self) -> int:
        raise NotImplementedError

    def _push(self, block: Any) -> None:
        raise NotImplementedError

    def _take(self, n: int) -> bytes:
        """Serialize and consume the oldest ``n`` buffered rows."""
        raise NotImplementedError

    def append(self, block: Any) -> None:
        """Buffer a block of scored rows (pad rows already stripped);
        commits one shard per ``rows_per_shard`` rows accumulated."""
        if self._finalized:
            raise RuntimeError("writer is finalized")
        self._push(block)
        while self._buffered() >= self.rows_per_shard:
            self._commit_shard(self._take(self.rows_per_shard),
                               self.rows_per_shard)
        self._last_activity = self._clock()

    def roll(self) -> bool:
        """Commit the buffered partial shard now (no-op when the buffer
        is empty). Returns True iff a shard was committed. The job stays
        open — this is an early cut, not :meth:`finalize`."""
        if self._finalized:
            raise RuntimeError("writer is finalized")
        n = self._buffered()
        if not n:
            return False
        self._commit_shard(self._take(n), n)
        self._last_activity = self._clock()
        return True

    def maybe_roll(self, now: Optional[float] = None) -> bool:
        """Commit the buffered partial shard iff ``roll_interval_s`` is
        set and that long has passed since the last append or commit.
        Returns True iff a shard was committed."""
        if (self._finalized or self.roll_interval_s is None
                or not self._buffered()):
            return False
        now = self._clock() if now is None else now
        if now - self._last_activity < self.roll_interval_s:
            return False
        return self.roll()

    def finalize(self, extra_meta: Optional[Dict] = None) -> Dict:
        """Flush the partial tail shard, then write the COMMIT marker —
        the job is complete only after this returns. Returns the COMMIT
        record. Idempotent once finalized."""
        if self._finalized:
            return read_commit(self.directory) or {}
        n = self._buffered()
        if n:
            self._commit_shard(self._take(n), n)
        commit = {"format": FORMAT, "output_format": self.fmt,
                  "total_rows": self.rows_committed,
                  "shards": self.shards_committed}
        if extra_meta:
            commit.update(extra_meta)
        _atomic_write(self.directory, COMMIT,
                      json.dumps(commit).encode())
        self._finalized = True
        return commit

    def _commit_shard(self, payload: bytes, n_rows: int) -> None:
        """One shard through the full protocol: stage + fsync + rename
        (kill site ``batch_writer_torn`` mid-write), then the manifest
        update (kill site ``batch_before_manifest`` between the two — the
        renamed shard exists but is not yet committed)."""
        t0 = time.perf_counter()
        span_t0 = monotonic_s()
        index = self.shards_committed
        start = self.rows_committed
        name = _shard_name(index, self.suffix)
        _atomic_write(self.directory, name, payload,
                      torn_point=self.torn_point)
        chaos.maybe_fail(self.manifest_point)
        rec = {"index": index, "file": name, "rows": int(n_rows),
               "start_row": int(start), "end_row": int(start + n_rows),
               "bytes": len(payload), "crc32": zlib.crc32(payload)}
        self._shards.append(rec)
        self._write_manifest()
        rec = dict(rec, write_seconds=time.perf_counter() - t0)
        tracer = get_tracer()
        if tracer.enabled:
            tracer.record_span("batch.write", "batch", span_t0,
                               monotonic_s(), shard=index, rows=int(n_rows),
                               bytes=len(payload))
        if self.on_shard is not None:
            self.on_shard(rec)

    def _write_manifest(self) -> None:
        doc = {"format": FORMAT, "output_format": self.fmt,
               "rows_per_shard": self.rows_per_shard,
               "job": self._job_meta, "shards": self._shards}
        _atomic_write(self.directory, MANIFEST,
                      json.dumps(doc, indent=1).encode())


class NpyShardWriter(ShardWriter):
    """Shards as ``np.save`` arrays — the fast path for single-output
    models (one ``(rows, ...)`` array per shard, dtype preserved).
    Multi-output blocks need :class:`JsonlShardWriter`."""

    suffix = "npy"
    fmt = "npy"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._buf: List[np.ndarray] = []
        self._buf_rows = 0

    def _buffered(self) -> int:
        return self._buf_rows

    def _push(self, block: Any) -> None:
        if isinstance(block, (list, tuple)):
            raise TypeError(
                "NpyShardWriter takes a single output array per block; "
                "multi-output models write through the jsonl format "
                "(OutputSpec(fmt='jsonl'))")
        arr = np.asarray(block)
        if arr.ndim < 1:
            raise ValueError("a block must have a leading row axis")
        if arr.shape[0]:
            self._buf.append(arr)
            self._buf_rows += arr.shape[0]

    def _take(self, n: int) -> bytes:
        rows = np.concatenate(self._buf) if len(self._buf) > 1 \
            else self._buf[0]
        out, rest = rows[:n], rows[n:]
        self._buf = [rest] if rest.shape[0] else []
        self._buf_rows -= n
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(out))
        return buf.getvalue()


class JsonlShardWriter(ShardWriter):
    """Shards as JSON-lines — one row per line, nested lists for arrays;
    a block may be a single array (row ``i`` → ``arr[i].tolist()``) or a
    list of arrays (row ``i`` → ``[a[i].tolist() for a in block]``, the
    multi-output layout)."""

    suffix = "jsonl"
    fmt = "jsonl"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._buf: List[str] = []

    def _buffered(self) -> int:
        return len(self._buf)

    @staticmethod
    def _jsonable(v: Any) -> Any:
        a = np.asarray(v)
        return a.tolist() if a.ndim else a.item()

    def _push(self, block: Any) -> None:
        if isinstance(block, (list, tuple)):
            arrs = [np.asarray(a) for a in block]
            n = arrs[0].shape[0]
            for a in arrs:
                if a.shape[0] != n:
                    raise ValueError(
                        "multi-output block components disagree on row "
                        f"count ({a.shape[0]} vs {n})")
            for i in range(n):
                self._buf.append(json.dumps(
                    [self._jsonable(a[i]) for a in arrs]))
        else:
            arr = np.asarray(block)
            for i in range(arr.shape[0]):
                self._buf.append(json.dumps(self._jsonable(arr[i])))

    def _take(self, n: int) -> bytes:
        out, self._buf = self._buf[:n], self._buf[n:]
        return ("\n".join(out) + "\n").encode()


# -- readers --------------------------------------------------------------


def read_manifest(directory: str, _retries: int = 3) -> Optional[Dict]:
    """The output manifest, or None when the directory holds no batch
    job. Safe against a live writer: ``os.replace`` guarantees a reader
    opens either the old or the new manifest, but the open itself can
    race the rename (ENOENT between the existence probe and ``open``, or
    a short read on filesystems whose replace visibility is weaker than
    POSIX). Those transient shapes are retried a few times before being
    treated as what a *stable* failure means: external damage, raised as
    :class:`ShardCorruptError` — the atomic replace protocol cannot
    produce a persistently unreadable manifest."""
    path = os.path.join(directory, MANIFEST)
    last_err: Optional[Exception] = None
    for attempt in range(max(1, _retries)):
        if not os.path.isfile(path):
            if last_err is None:
                return None  # genuinely no job here
            time.sleep(0.002)  # mid-replace: old gone, new not yet visible
            continue
        try:
            with open(path) as f:
                doc = json.load(f)
            break
        except FileNotFoundError:
            last_err = None  # lost the race to a rename — plain retry
            continue
        except (OSError, ValueError) as e:
            last_err = e
            time.sleep(0.002)
            continue
    else:
        if last_err is None:
            return None
        raise ShardCorruptError(
            f"batch output {directory!r}: manifest unreadable "
            f"({last_err})") from last_err
    if doc.get("format") != FORMAT:
        raise ShardCorruptError(
            f"batch output {directory!r}: manifest format "
            f"{doc.get('format')!r} (this build speaks {FORMAT!r})")
    return doc


def read_commit(directory: str) -> Optional[Dict]:
    """The COMMIT record, or None while the job is incomplete."""
    path = os.path.join(directory, COMMIT)
    if not os.path.isfile(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise ShardCorruptError(
            f"batch output {directory!r}: COMMIT unreadable ({e})") from e


def job_complete(directory: str) -> bool:
    """True iff the job's COMMIT marker landed (every shard committed and
    the manifest final) — the only state a consumer may treat as a full
    scoring of the input."""
    return (os.path.isfile(os.path.join(directory, COMMIT))
            and os.path.isfile(os.path.join(directory, MANIFEST)))


def committed_rows(directory: str) -> int:
    """Rows durably committed so far (0 for an empty/absent manifest) —
    the resume offset."""
    doc = read_manifest(directory)
    if doc is None or not doc["shards"]:
        return 0
    return int(doc["shards"][-1]["end_row"])


def verify_output(directory: str) -> Dict[str, Any]:
    """Integrity-check a batch output directory: per-shard CRC32 against
    the manifest, row-range contiguity (no duplicate rows, no holes),
    COMMIT totals when present. Returns ``{"shards", "rows", "complete",
    "uncommitted"}`` (``uncommitted`` lists shard files on disk the
    manifest does not record — crash debris a resumed job overwrites).
    Raises :class:`ShardCorruptError` naming the first damaged shard."""
    doc = read_manifest(directory)
    if doc is None:
        raise ShardCorruptError(f"{directory!r} has no {MANIFEST}")
    expect_start = 0
    listed = set()
    for rec in doc["shards"]:
        if rec["index"] != len(listed):
            raise ShardCorruptError(
                f"batch output {directory!r}: shard indices not "
                f"contiguous at index {rec['index']}")
        if rec["start_row"] != expect_start:
            raise ShardCorruptError(
                f"batch output {directory!r}: shard {rec['index']} starts "
                f"at row {rec['start_row']}, expected {expect_start} — "
                "row ranges must be contiguous (no holes, no duplicates)")
        if rec["end_row"] - rec["start_row"] != rec["rows"]:
            raise ShardCorruptError(
                f"batch output {directory!r}: shard {rec['index']} range "
                "disagrees with its row count")
        path = os.path.join(directory, rec["file"])
        if not os.path.isfile(path):
            raise ShardCorruptError(
                f"batch output {directory!r}: committed shard file "
                f"{rec['file']!r} is missing")
        with open(path, "rb") as f:
            got = zlib.crc32(f.read())
        if got != rec["crc32"]:
            raise ShardCorruptError(
                f"batch output {directory!r}: shard {rec['file']!r} "
                f"checksum mismatch (stored {rec['crc32']}, computed "
                f"{got}) — the shard payload is damaged")
        expect_start = rec["end_row"]
        listed.add(rec["file"])
    uncommitted = sorted(
        f for f in os.listdir(directory)
        if _SHARD_PAT.match(f) and f not in listed)
    commit = read_commit(directory)
    if commit is not None:
        if (commit.get("total_rows") != expect_start
                or commit.get("shards") != len(doc["shards"])):
            raise ShardCorruptError(
                f"batch output {directory!r}: COMMIT totals "
                f"({commit.get('shards')} shards / "
                f"{commit.get('total_rows')} rows) disagree with the "
                f"manifest ({len(doc['shards'])} / {expect_start})")
    return {"shards": len(doc["shards"]), "rows": expect_start,
            "complete": commit is not None, "uncommitted": uncommitted}


def load_shard_rows(path: str) -> Any:
    """One shard's rows: an array for ``.npy``, a list of parsed JSON
    rows for ``.jsonl``."""
    if path.endswith(".npy"):
        return np.load(path)
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def iter_output_rows(directory: str):
    """Yield every committed row in order, across shards — the reader
    contract the atomic protocol protects: the manifest is snapshotted
    once, only shards it lists are touched, and ``.tmp`` staging debris
    or a shard renamed-but-not-yet-recorded is never observed. Reading
    concurrently with a live writer therefore yields a consistent prefix
    of the output (everything committed as of the snapshot). A listed
    shard that is missing or short is loud
    (:class:`ShardCorruptError`)."""
    doc = read_manifest(directory)
    if doc is None:
        return
    for rec in doc["shards"]:
        path = os.path.join(directory, rec["file"])
        try:
            rows = load_shard_rows(path)
        except (OSError, ValueError) as e:
            raise ShardCorruptError(
                f"batch output {directory!r}: committed shard "
                f"{rec['file']!r} unreadable ({e})") from e
        if len(rows) < rec["rows"]:
            raise ShardCorruptError(
                f"batch output {directory!r}: committed shard "
                f"{rec['file']!r} holds {len(rows)} rows, manifest "
                f"records {rec['rows']}")
        for i in range(rec["rows"]):
            yield rows[i]
