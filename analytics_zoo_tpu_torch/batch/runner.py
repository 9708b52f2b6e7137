"""Resumable batch-predict execution: score → shard → checkpoint → die
anywhere → resume bitwise (port of ``analytics_zoo_tpu.batch.runner``).

:class:`BatchJobRunner` drives a
:class:`~analytics_zoo_tpu_torch.batch.job.BatchPredictJob` into a
:class:`~analytics_zoo_tpu_torch.batch.writers.ShardWriter` and owns every
piece of durability bookkeeping:

- the **output manifest is the authoritative resume ledger**: on
  ``run(resume=True)`` the committed row high-water mark comes straight
  from ``MANIFEST.json`` (each shard commit is atomic, so the mark is
  exact), the scored stream restarts at that absolute row, and committed
  shards are skipped — never re-scored, never rewritten. Because the
  job's row stream is deterministic and shards are re-cut at fixed
  ``rows_per_shard`` boundaries, the resumed output is **bitwise
  identical** to an uninterrupted run's (the invariant
  tests/test_batch_scoring.py's subprocess kill matrix pins at every
  :data:`~analytics_zoo_tpu_torch.ft.chaos.BATCH_POINTS` site);
- **job state checkpoints** ride :class:`~analytics_zoo_tpu_torch.ft.manager
  .CheckpointManager` every ``checkpoint_every_shards`` commits, storing
  the pipeline's ``state_dict()`` and the shard high-water mark in
  checkpoint *metadata* (the tree itself is one counter leaf). They are
  advisory — resume works from the manifest alone — but restoring one
  routes the saved stream config through
  :meth:`~analytics_zoo_tpu_torch.data.pipeline.Pipeline.load_state_dict`'s
  loud mismatch validation, catching a resume against a different
  dataset or batch geometry before any row is scored;
- a **job fingerprint** (batch geometry + row count + shard size +
  format) is stamped into the manifest and re-checked on resume, so a
  changed config fails fast instead of producing interleaved garbage;
- ``zoo_batch_*`` metrics and ``batch.job`` / ``batch.shard`` spans
  (:func:`~analytics_zoo_tpu_torch.common.observability.batch_metrics`) make
  throughput and resume behaviour observable, and the
  ``batch_mid_job_kill`` chaos site after each shard commit gives the
  kill matrix its plain-preemption geometry.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np

from analytics_zoo_tpu_torch.batch.job import BatchPredictJob
from analytics_zoo_tpu_torch.batch.writers import (
    OutputSpec,
    job_complete,
    read_commit,
    read_manifest,
)
from analytics_zoo_tpu_torch.common.flight_recorder import get_flight_recorder
from analytics_zoo_tpu_torch.common.observability import (
    batch_metrics,
    get_tracer,
    monotonic_s,
)
from analytics_zoo_tpu_torch.ft import atomic, chaos
from analytics_zoo_tpu_torch.ft.manager import CheckpointManager

__all__ = ["BatchJobRunner"]

#: metadata/fingerprint keys that must match between the manifest's
#: recorded job and the resuming job — anything else is a config drift
#: that would interleave two different streams into one output.
_FINGERPRINT_KEYS = ("batch_size", "num_rows", "rows_per_shard",
                     "output_format", "buckets")


class BatchJobRunner:
    """Run a batch-predict job to durable, resumable, sharded output.

    Args:
      job: the :class:`BatchPredictJob` to drive.
      output_spec: where/how to write
        (:class:`~analytics_zoo_tpu_torch.batch.writers.OutputSpec`).
      checkpoint_every_shards: job-state checkpoint cadence (shards).
      state_dir: CheckpointManager directory; default
        ``<output>/_job_state``.
    """

    def __init__(self, job: BatchPredictJob, output_spec: OutputSpec,
                 checkpoint_every_shards: int = 8,
                 state_dir: Optional[str] = None):
        if checkpoint_every_shards < 1:
            raise ValueError("checkpoint_every_shards must be >= 1, got "
                             f"{checkpoint_every_shards}")
        self.job = job
        self.spec = output_spec
        self.checkpoint_every_shards = int(checkpoint_every_shards)
        self.state_dir = state_dir or os.path.join(output_spec.directory,
                                                   "_job_state")
        self._metrics = batch_metrics()

    # -- fingerprint ------------------------------------------------------

    def fingerprint(self) -> Dict[str, Any]:
        """The config identity stamped into the manifest and validated
        on resume."""
        buckets = self.job.pipeline._batch_cfg[2] if \
            self.job.pipeline._batch_cfg else None
        return {
            "batch_size": self.job.batch_size,
            "num_rows": self.job.num_rows,
            "rows_per_shard": self.spec.rows_per_shard,
            "output_format": self.spec.fmt,
            "buckets": list(buckets) if buckets else None,
        }

    def _check_fingerprint(self, recorded: Dict[str, Any]) -> None:
        mine = self.fingerprint()
        for key in _FINGERPRINT_KEYS:
            if key in recorded and recorded[key] != mine[key]:
                raise ValueError(
                    f"resume fingerprint mismatch on {key!r}: output at "
                    f"{self.spec.directory!r} was written with "
                    f"{recorded[key]!r}, this job has {mine[key]!r} — "
                    "resuming would interleave two different streams")

    # -- job-state checkpoints -------------------------------------------

    def _restore_state(self) -> None:
        """Route the latest job-state checkpoint (if any) through the
        pipeline's config validation. The manifest stays authoritative
        for the resume offset — this exists to fail loudly when the
        pipeline behind a resumed job is not the one that was running."""
        if not os.path.isdir(self.state_dir):
            return
        mgr = CheckpointManager(self.state_dir, asynchronous=False)
        try:
            latest = mgr.latest()
            if latest is None:
                return
            _, meta = atomic.read_checkpoint(latest)
            pipe_state = meta.get("pipeline")
            if pipe_state:
                # validates batch size / sample count / shuffle config;
                # the armed position is irrelevant — scored_blocks
                # passes an explicit start_step, which wins
                self.job.pipeline.load_state_dict(pipe_state)
        finally:
            mgr.close()

    # -- the run ----------------------------------------------------------

    def run(self, resume: bool = False, overwrite: bool = False
            ) -> Dict[str, Any]:
        """Score the job into the output directory.

        - Fresh directory: runs start to finish.
        - ``resume=True``: skips the manifest's committed shards,
          continues at the committed row offset, and no-ops (returning
          the COMMIT totals) when the job already finished.
        - An existing *complete* output without ``resume`` raises unless
          ``overwrite=True`` (which discards it); an *incomplete* one
          without ``resume`` also raises — silently restarting over a
          half-written job is exactly the torn-output mistake the
          protocol exists to prevent.

        Returns a report: ``{"rows", "shards", "resumed_at_row",
        "skipped_shards", "rows_per_sec", "complete"}``.
        """
        out_dir = self.spec.directory
        manifest = read_manifest(out_dir)
        if job_complete(out_dir):
            if resume:
                commit = read_commit(out_dir) or {}
                return {"rows": commit.get("total_rows", 0),
                        "shards": commit.get("shards", 0),
                        "resumed_at_row": commit.get("total_rows", 0),
                        "skipped_shards": commit.get("shards", 0),
                        "rows_per_sec": 0.0, "complete": True}
            if not overwrite:
                raise FileExistsError(
                    f"{out_dir!r} already holds a completed batch output "
                    "(COMMIT present); pass overwrite=True to discard it "
                    "or resume=True to no-op")
            self._discard_output()
            manifest = None
        elif manifest is not None and manifest["shards"] and not resume:
            if not overwrite:
                raise FileExistsError(
                    f"{out_dir!r} holds a partially-written batch output "
                    f"({len(manifest['shards'])} committed shards, no "
                    "COMMIT); pass resume=True to continue it or "
                    "overwrite=True to discard it")
            self._discard_output()
            manifest = None

        if resume and manifest is not None:
            self._check_fingerprint(manifest.get("job", {}))
            self._restore_state()

        writer = self.spec.writer(job_meta=self.fingerprint(),
                                  on_shard=self._on_shard)
        start_row = writer.rows_committed
        skipped = writer.shards_committed
        if skipped:
            self._metrics["resume_skipped"].inc(skipped)
        self._shards_since_ckpt = 0
        self._rows_hwm = start_row
        self._ckpt_mgr: Optional[CheckpointManager] = None

        tracer = get_tracer()
        fr = get_flight_recorder()
        rec = fr.begin(os.path.basename(out_dir.rstrip(os.sep)) or "batch",
                       kind="batch")
        rec.t_route = monotonic_s()
        t0 = time.perf_counter()
        rows_scored = 0
        try:
            with tracer.span("batch.job", rows=self.job.num_rows,
                             start_row=start_row,
                             fmt=self.spec.fmt) as _span:
                for block in self.job.scored_blocks(start_row=start_row):
                    writer.append(block)
                    rows_scored += _rows_of(block)
                commit = writer.finalize()
        except BaseException as exc:
            # a dying batch job snapshots the ring so the dump carries
            # the committed-shard high-water mark alongside the error
            fr.finish(rec, "error", error=type(exc).__name__)
            raise
        finally:
            if self._ckpt_mgr is not None:
                self._ckpt_mgr.close()
                self._ckpt_mgr = None
        fr.finish(rec, "ok")

        dt = time.perf_counter() - t0
        rps = rows_scored / dt if dt > 0 and rows_scored else 0.0
        self._metrics["rows_per_sec"].set(rps)
        return {"rows": commit["total_rows"], "shards": commit["shards"],
                "resumed_at_row": start_row, "skipped_shards": skipped,
                "rows_per_sec": rps, "complete": True}

    def _discard_output(self) -> None:
        import shutil
        for entry in os.listdir(self.spec.directory):
            path = os.path.join(self.spec.directory, entry)
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.unlink(path)

    # -- per-shard hook ---------------------------------------------------

    def _on_shard(self, rec: Dict[str, Any]) -> None:
        """Runs after every durable shard commit: metrics, the
        ``batch.shard`` span, the periodic job-state checkpoint, then
        the ``batch_mid_job_kill`` chaos site (so an injected death
        lands exactly between committed shards)."""
        m = self._metrics
        m["shards"].inc()
        m["rows"].inc(rec["rows"])
        m["write_seconds"].observe(rec["write_seconds"])
        self._rows_hwm = rec["end_row"]
        tracer = get_tracer()
        if tracer.enabled:
            now = monotonic_s()
            tracer.record_span("batch.shard", "batch",
                               now - rec["write_seconds"], now,
                               shard=rec["index"], rows=rec["rows"],
                               end_row=rec["end_row"])
        self._shards_since_ckpt += 1
        if self._shards_since_ckpt >= self.checkpoint_every_shards:
            self._shards_since_ckpt = 0
            self._save_state(rec)
        chaos.maybe_fail("batch_mid_job_kill")

    def _save_state(self, rec: Dict[str, Any]) -> None:
        if self._ckpt_mgr is None:
            self._ckpt_mgr = CheckpointManager(
                self.state_dir, keep_last=2, asynchronous=False)
        self._ckpt_mgr.save(
            step=rec["index"],
            tree={"batch": {"rows_committed": np.int64(rec["end_row"])}},
            metadata={"pipeline": self.job.state_dict(rec["end_row"]),
                      "shard_hwm": rec["index"],
                      "job": self.fingerprint()})


def _rows_of(block: Any) -> int:
    if isinstance(block, (list, tuple)):
        return int(np.asarray(block[0]).shape[0])
    return int(np.asarray(block).shape[0])
