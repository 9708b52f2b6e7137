"""CheckpointManager: asynchronous atomic checkpoints with retention (port
of ``analytics_zoo_tpu.ft.manager``).

The train step never waits for serialization or disk. ``save()`` does the
only work that needs the live state on the caller's thread: a host
snapshot, a copy of every leaf (``engine.checkpoint.flatten``; never a
view that a later step could change). A background writer thread then
serializes, runs the :mod:`~analytics_zoo_tpu_torch.ft.atomic` commit
protocol and sweeps retention. ``wait()`` (or the next ``save``) raises
any writer failure.

Backpressure: the writer queue is bounded (``max_pending``); when the
disk falls behind, ``save`` blocks rather than piling up host snapshots,
each a full copy of the state.

Retention: ``keep_last=N`` keeps the N newest committed checkpoints;
``keep_every=M`` also keeps every checkpoint whose step is a multiple of
M. Sweeps remove crash debris too.

Observability, as in the JAX package: the checkpoint metric families
(:func:`~analytics_zoo_tpu_torch.common.observability.checkpoint_metrics`:
saves, save seconds, bytes, restores by outcome) and, with the global
tracer enabled, a ``ckpt.snapshot`` span around the host snapshot, a
``ckpt.commit`` span per commit on the writer thread (step, bytes) and a
``ckpt.restore`` span per restore attempt. The writer also logs each
commit's bytes and seconds.
"""

from __future__ import annotations

import logging
import os
import queue as queue_lib
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.common.observability import (
    checkpoint_metrics,
    get_tracer,
    monotonic_s,
)
from analytics_zoo_tpu_torch.engine.checkpoint import flatten
from analytics_zoo_tpu_torch.ft import atomic

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = ["CheckpointManager"]


class _SaveJob(NamedTuple):
    step: int
    flat: List[Tuple[str, np.ndarray]]
    metadata: Dict[str, Any]
    path: str


class CheckpointManager:
    """Asynchronous atomic checkpoints under one directory.

    ::

        mgr = CheckpointManager("/ckpts/run1", keep_last=3, keep_every=1000)
        mgr.save(step, tstate, metadata={"epoch": 2})   # returns at once
        ...
        mgr.wait()                                      # durable + errors
        state, meta = mgr.restore(like=tstate)          # newest committed

    ``asynchronous=False`` makes every ``save`` a blocking write.
    """

    def __init__(self, directory: str, keep_last: Optional[int] = None,
                 keep_every: Optional[int] = None, prefix: str = "ckpt",
                 asynchronous: bool = True, max_pending: int = 2,
                 overwrite: bool = True):
        if keep_last is not None and keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        if keep_every is not None and keep_every < 1:
            raise ValueError(f"keep_every must be >= 1, got {keep_every}")
        self.directory = directory
        self.keep_last = keep_last
        self.keep_every = keep_every
        self.prefix = prefix
        self.asynchronous = asynchronous
        self.overwrite = overwrite
        self._queue: "queue_lib.Queue[Optional[_SaveJob]]" = queue_lib.Queue(
            maxsize=max(1, max_pending))
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()
        self._closed = False
        self._metrics = checkpoint_metrics()

    # -- save -------------------------------------------------------------

    def step_path(self, step: int) -> str:
        """The committed directory path checkpoint ``step`` lands at."""
        return os.path.join(self.directory, f"{self.prefix}_{int(step)}")

    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None,
             blocking: Optional[bool] = None) -> str:
        """Snapshot ``tree`` to the host now (on the caller's thread) and
        commit it as ``<prefix>_<step>/``, asynchronously unless
        ``blocking`` or the manager is synchronous. Returns the target
        path; the write may be in flight until :meth:`wait`. Raises any
        failure of a previous asynchronous write."""
        if self._closed:
            raise RuntimeError("CheckpointManager is closed")
        self._raise_pending()
        with get_tracer().span("ckpt.snapshot", step=int(step)):
            flat = flatten(tree)
        job = _SaveJob(int(step), flat, dict(metadata or {}),
                       self.step_path(step))
        if blocking or not self.asynchronous:
            self._write_job(job)
            return job.path
        self._ensure_thread()
        self._queue.put(job)  # bounded: blocks when the disk lags
        return job.path

    def wait(self) -> None:
        """Block until every queued save is committed; raise the first
        writer error if one failed."""
        self._queue.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain pending saves and stop the writer thread."""
        if self._closed:
            return
        self.wait()
        self._closed = True
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=10.0)
            self._thread = None

    def _raise_pending(self) -> None:
        with self._error_lock:
            err, self._error = self._error, None
        if err is not None:
            raise atomic.CheckpointError(
                f"async checkpoint write failed: {err}") from err

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer_loop, daemon=True,
                name="azoo-ckpt-writer")
            self._thread.start()

    def _writer_loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                self._queue.task_done()
                return
            try:
                self._write_job(job)
            except Exception as e:  # noqa: BLE001 - raised at wait/save
                logger.exception("checkpoint write for step %d failed",
                                 job.step)
                with self._error_lock:
                    if self._error is None:
                        self._error = e
            finally:
                self._queue.task_done()

    def _write_job(self, job: _SaveJob) -> None:
        t0 = time.perf_counter()
        span_t0 = monotonic_s()
        atomic.commit_checkpoint(job.path, job.flat, job.metadata,
                                 overwrite=self.overwrite)
        self.sweep(current_step=job.step)
        dt = time.perf_counter() - t0
        nbytes = sum(a.nbytes for _, a in job.flat)
        self._metrics["saves"].inc()
        self._metrics["save_seconds"].observe(dt)
        self._metrics["bytes"].inc(nbytes)
        tracer = get_tracer()
        if tracer.enabled:
            tracer.record_span("ckpt.commit", "ckpt", span_t0, monotonic_s(),
                               step=job.step, bytes=nbytes)
        logger.info("Checkpoint committed: %s (%.1f MB in %.2fs)", job.path,
                    nbytes / 2**20, dt)

    # -- retention --------------------------------------------------------

    def sweep(self, current_step: int) -> None:
        """Apply the retention policy after ``current_step`` committed
        (also for checkpoints another writer committed: a sharded save)."""
        steps = [s for s, _ in self.all_checkpoints()]
        keep: Optional[set] = None
        if self.keep_last is not None:
            keep = set(steps[-self.keep_last:])
            keep.add(current_step)
            if self.keep_every is not None:
                keep.update(s for s in steps if s % self.keep_every == 0)
        # keep=None sweeps only crash debris, never data
        atomic.sweep_stale(self.directory, self.prefix, keep_steps=keep)

    # -- restore ----------------------------------------------------------

    def all_checkpoints(self) -> List[Tuple[int, str]]:
        """``[(step, path)]`` of committed checkpoints, ascending."""
        return atomic.committed_checkpoints(self.directory, self.prefix)

    def latest(self) -> Optional[str]:
        """Path of the newest committed checkpoint (or None)."""
        committed = self.all_checkpoints()
        return committed[-1][1] if committed else None

    def latest_step(self) -> Optional[int]:
        """Step of the newest committed checkpoint (or None)."""
        committed = self.all_checkpoints()
        return committed[-1][0] if committed else None

    def restore(self, like: Any, path: Optional[str] = None
                ) -> Tuple[Any, Dict]:
        """Restore ``path`` (default: the committed checkpoints newest
        first, skipping corrupt ones) into ``like``'s structure as host
        arrays, checksums and shapes validated. Raises
        :class:`~analytics_zoo_tpu_torch.ft.atomic.CheckpointError` when
        nothing restorable exists."""
        tracer = get_tracer()
        restores = self._metrics["restores"]
        candidates = ([path] if path is not None else
                      [p for _, p in reversed(self.all_checkpoints())])
        if not candidates:
            restores.labels(outcome="missing").inc()
            raise atomic.CheckpointError(
                f"no committed checkpoint under {self.directory!r}")
        last_err: Optional[BaseException] = None
        for cand in candidates:
            try:
                with tracer.span("ckpt.restore", path=cand):
                    tree, meta = atomic.read_checkpoint(cand, like=like)
                restores.labels(outcome="ok").inc()
                return tree, meta
            except atomic.CheckpointCorruptError as e:
                restores.labels(outcome="corrupt").inc()
                logger.warning("checkpoint %s is corrupt (%s): falling "
                               "back to the previous committed one", cand, e)
                last_err = e
            except ValueError:
                restores.labels(outcome="mismatch").inc()
                raise
        raise atomic.CheckpointError(
            f"every committed checkpoint under {self.directory!r} is "
            f"corrupt") from last_err
