"""The pipelined batch score loop: stream → bucketed batches → model
(port of ``analytics_zoo_tpu.batch.job``).

A :class:`BatchPredictJob` is the offline analogue of
``nnframes.NNModel.transform`` — score an entire dataset through a
loaded model:

- **input** streams through :class:`~analytics_zoo_tpu_torch.data.pipeline
  .Pipeline` with ``.batch(b, pad_to_bucket=ladder)``, so every step
  lands on one of ``len(ladder)`` static shapes (the serving bucket
  idea) and the tail batch pads to the smallest fitting bucket with a
  validity mask; ``.prefetch(k)`` assembles batches on a background
  thread so host decode overlaps device compute;
- **capture cost**: on the card each bucket of the ladder is one CUDA
  graph of the model, captured once per process (the port keeps no
  persistent executable cache);
- **dispatch/fetch overlap** like the serving fast path: with
  ``pipeline_depth`` > 0 the loop keeps that many batches enqueued on
  the device (``do_dispatch``: a graph replay and the copy-out of its
  outputs, on the model's stream) before blocking on the oldest result
  (``do_fetch``), so the host assembles batch *k+1* while the device
  scores batch *k*. A replay copies its outputs out before the next
  replay may write the graph's buffers, so an overlapped job is bitwise
  the synchronous one;
- **pad rows are stripped** from every output block using the batch's
  valid-row count, so downstream writers see exactly the input's rows.

The job itself is stateless about output — it yields scored row blocks
(:meth:`scored_blocks`); durability, sharding, resume bookkeeping and
metrics live in :class:`~analytics_zoo_tpu_torch.batch.runner.BatchJobRunner`
and :mod:`~analytics_zoo_tpu_torch.batch.writers`.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Iterator, List, Optional, Sequence, Union

import numpy as np

from analytics_zoo_tpu_torch.data import sources as sources_lib
from analytics_zoo_tpu_torch.data.pipeline import Pipeline

__all__ = ["BatchPredictJob"]


def _strip_pads(out: Any, valid: int) -> Any:
    """Drop pad rows from a model output block (list outputs row-sliced
    component-wise) and land it on the host as NumPy."""
    if isinstance(out, (list, tuple)):
        return [np.asarray(a)[:valid] for a in out]
    return np.asarray(out)[:valid]


def _block_rows(block: Any) -> int:
    if isinstance(block, (list, tuple)):
        return int(np.asarray(block[0]).shape[0])
    return int(np.asarray(block).shape[0])


def _slice_block(block: Any, start: int) -> Any:
    if isinstance(block, (list, tuple)):
        return [a[start:] for a in block]
    return block[start:]


class BatchPredictJob:
    """Score every row of a source/pipeline through a loaded model.

    Args:
      model: anything with ``do_predict(x)`` (NumPy in/out). When it
        also exposes the serving fast-path split — ``do_dispatch(x)`` /
        ``do_fetch(out)`` — and ``pipeline_depth`` > 0, dispatch and
        fetch are overlapped.
      source_or_pipeline: a :class:`~analytics_zoo_tpu_torch.data.sources
        .Source` (wrapped in a fresh :class:`Pipeline`) or a pipeline.
        A pipeline without a ``batch`` stage gets ``.batch(batch_size,
        pad_to_bucket=pad_to_bucket)``; one without a ``prefetch`` stage
        gets ``.prefetch(prefetch)`` (``prefetch=0`` leaves the feed
        synchronous). A pipeline that already has those stages is used
        as given — its batch geometry then defines the row math.
      batch_size: rows per full batch (when this ctor adds the stage).
      pad_to_bucket: ascending bucket ladder for the tail batch; None
        pads the tail to ``batch_size`` (one shape total). Every shape
        in the ladder is captured once per process.
      prefetch: background host-batch depth (when adding the stage).
      pipeline_depth: device batches kept in flight before the loop
        blocks on the oldest fetch. 0 = fully synchronous scoring.
      aot_cache_dir: the JAX package's persistent executable cache. The
        port keeps none (``inference.inference_model.NO_AOT_CACHE``):
        anything but ``None`` raises ``NotImplementedError`` (through
        the model's ``set_aot_cache`` where it has one).
      sharding_plan: a :class:`~analytics_zoo_tpu_torch.mesh.plan
        .ShardingPlan` partitioning every bucket over its ``data`` slots.
        Every static batch shape (the ladder, or ``batch_size`` without
        one) is validated against the plan's ``data`` axis before a row
        is read and before the model is touched
        (:class:`~analytics_zoo_tpu_torch.mesh.plan.BucketShardingError`);
        then the plan is attached to the model
        (``model.set_sharding_plan``; a model without it raises
        ``TypeError``).

    The scored stream is deterministic: shuffle off, epoch seed 0, so
    output row ``i`` is always source row ``i`` — the invariant that
    lets resume-by-row-offset produce bitwise identical output.
    """

    def __init__(self, model: Any,
                 source_or_pipeline: Union[Pipeline, sources_lib.Source],
                 batch_size: int = 32,
                 pad_to_bucket: Optional[Sequence[int]] = None,
                 prefetch: int = 2,
                 pipeline_depth: int = 2,
                 aot_cache_dir: Optional[str] = None,
                 sharding_plan=None):
        if pipeline_depth < 0:
            raise ValueError(
                f"pipeline_depth must be >= 0, got {pipeline_depth}")
        self.model = model
        if isinstance(source_or_pipeline, Pipeline):
            pipe = source_or_pipeline
        else:
            pipe = Pipeline(source_or_pipeline)
        if pipe.batch_size is None:
            pipe = pipe.batch(batch_size, pad_to_bucket=pad_to_bucket)
        if pipe.prefetch_depth == 0 and prefetch > 0:
            pipe = pipe.prefetch(prefetch)
        self.pipeline = pipe
        self.batch_size = int(pipe.batch_size)
        self.pipeline_depth = int(pipeline_depth)
        if aot_cache_dir is not None:
            if hasattr(model, "set_aot_cache"):
                model.set_aot_cache(aot_cache_dir)
            from analytics_zoo_tpu_torch.inference.inference_model import (
                refuse_aot_cache,
            )

            refuse_aot_cache(f"BatchPredictJob(aot_cache_dir="
                             f"{aot_cache_dir!r})")
        if sharding_plan is not None and not hasattr(
                model, "set_sharding_plan"):
            raise TypeError(
                "model does not accept a sharding plan (no "
                "set_sharding_plan) — duck-typed models must handle "
                "their own device placement")
        plan = (sharding_plan if sharding_plan is not None
                else getattr(model, "sharding_plan", None))
        if plan is not None:
            # every static shape the batch stage can emit must split
            # evenly over the data axis: the bucket ladder when one is
            # configured, otherwise the single padded batch_size.
            # Validated BEFORE attaching, so a rejected job leaves the
            # model untouched.
            _, _, buckets = pipe._batch_cfg
            plan.validate_ladder(
                tuple(buckets) if buckets else (self.batch_size,),
                context="batch job bucket ladder")
        if sharding_plan is not None:
            model.set_sharding_plan(sharding_plan)

    # -- geometry ---------------------------------------------------------

    @property
    def num_rows(self) -> int:
        """Rows the full job scores (the source's length)."""
        return self.pipeline.num_samples

    def state_dict(self, rows_done: int) -> dict:
        """The pipeline's resumable position at an absolute row offset —
        what the runner checkpoints. Uses the pipeline's own
        ``state_dict`` schema so restore goes through its loud
        config-mismatch validation."""
        b = self.batch_size
        step = min(rows_done // b, self._steps())
        return self.pipeline.state_dict(
            epoch_seed=0, position=step,
            samples_seen=min(rows_done, self.num_rows))

    def _steps(self) -> int:
        return self.pipeline.steps_per_epoch(self.batch_size)

    # -- the score loop ---------------------------------------------------

    def scored_blocks(self, start_row: int = 0) -> Iterator[Any]:
        """Yield scored row blocks, pads stripped, starting at absolute
        row ``start_row`` (the resume path: whole consumed batches are
        skipped in integer time, and a mid-batch offset drops the first
        block's leading rows). Block boundaries are NOT stable across
        different ``start_row`` values — only the concatenated row
        stream is, which is why the writer re-cuts rows into fixed-size
        shards."""
        n = self.num_rows
        if start_row < 0 or start_row > n:
            raise ValueError(
                f"start_row {start_row} outside [0, {n}]")
        if start_row == n:
            return
        b = self.batch_size
        # every non-tail batch holds exactly b valid rows (shuffle off,
        # pads only ever on the tail), so batch k starts at row k*b
        start_step, skip = divmod(start_row, b)
        feed = self.pipeline.host_batches(start_step=start_step)
        model = self.model
        overlapped = (self.pipeline_depth > 0
                      and hasattr(model, "do_dispatch")
                      and hasattr(model, "do_fetch"))
        inflight: deque = deque()  # (device_out, valid)
        try:
            for x, _y, mask in feed:
                valid = int(round(float(np.sum(mask))))
                if valid == 0:
                    continue
                if overlapped:
                    inflight.append((model.do_dispatch(x), valid))
                    if len(inflight) > self.pipeline_depth:
                        out, v = inflight.popleft()
                        block = _strip_pads(model.do_fetch(out), v)
                        skip = yield from self._emit(block, skip)
                else:
                    block = _strip_pads(model.do_predict(x), valid)
                    skip = yield from self._emit(block, skip)
            while inflight:
                out, v = inflight.popleft()
                block = _strip_pads(model.do_fetch(out), v)
                skip = yield from self._emit(block, skip)
        finally:
            feed.close()

    @staticmethod
    def _emit(block: Any, skip: int):
        """Yield ``block`` minus the first ``skip`` rows (the mid-batch
        part of a resume offset); returns the remaining skip."""
        if skip:
            rows = _block_rows(block)
            if skip >= rows:
                return skip - rows
            block = _slice_block(block, skip)
        yield block
        return 0
