"""Streaming input pipeline: parallel transform workers, asynchronous
device prefetch, and checkpointable iterators (port of
``analytics_zoo_tpu.data.pipeline``).

The reference runs its feature-engineering chains (ImageSet/TextSet
``Preprocessing``) in parallel on Spark executors and overlaps data prep
with training through task pipelining. This module is the host-side
streaming subsystem:

::

    pipe = (Pipeline.from_files("/data/train", with_label=True)
            .map(ImageRead() | ImageResize(40, 40) | ImageRandomCrop(32, 32)
                 | ImageChannelNormalize(128, 128, 128) | ImageSetToSample(),
                 num_workers=8)
            .shuffle(1024, seed=7)
            .batch(128)
            .prefetch(2))
    Estimator(...).train(pipe, criterion, ...)   # accepted directly

Stage semantics:

- ``map(fn, num_workers=N)`` — per-sample transforms on a worker pool.
  Each sample gets an RNG seeded from ``(pipeline seed, epoch, sample
  index)`` (injected as ``feature["rng"]`` for ImageFeature records, or
  passed as ``fn(record, rng)`` when the fn takes two arguments), and
  results are reassembled in submission order — so the stream is
  **bitwise identical for any worker count**, augmentations included.
- ``shuffle(buffer, seed)`` — a streaming buffer shuffle whose emitted
  index order is a pure function of ``(seed, epoch, n, buffer)``.
  Without a shuffle stage, ``train_batches(shuffle=True)`` uses the same
  full epoch permutation as ``FeatureSet`` (bit-identical order).
- ``batch(b, drop_remainder=..., pad_to_bucket=...)`` — static-shape
  batches with a validity mask: the tail batch is wrap-padded to ``b``
  (mask 0 on pads) by default, dropped with ``drop_remainder=True``, or
  padded up to the smallest bucket of an explicit ladder with
  ``pad_to_bucket=(8, 16, 32)`` (the serving bucket idea, so tail
  batches hit smaller captured shapes instead of full-size pads).
- ``prefetch(k)`` — a background thread assembling batches ``k`` deep
  ahead of the consumer and, for :meth:`Pipeline.device_batches`,
  starting their copy to the device (the Estimator adopts the depth for
  its infeed); :meth:`Pipeline.host_batches` keeps them on the host.

Every stream is bitwise the JAX package's for the same source, seed,
worker count and ladder, ``state_dict`` included. The flywheel's capture
and label sources (:meth:`Pipeline.from_capture`,
:meth:`Pipeline.from_labeled_capture`) replay the serving tap's segments.

Checkpointing: iterators expose ``state_dict()`` /
``load_state_dict()`` (source position, shuffle stream seed, prefetch
high-water mark). Because every stage is a pure function of
``(seed, epoch, position)``, restore is O(1) in sample work: the integer
order is re-derived and the stream continues at the recorded batch —
no consumed sample is ever re-decoded. ``Estimator`` stores this state
in its checkpoint metadata, so a streamed run's kill and ``auto_resume``
continue the stream bitwise.

Observability: ``zoo_data_*`` metric families (samples/batches
throughput, consumer wait seconds, prefetch queue depth, and an
input-starvation ratio gauge — the fraction of wall time the consumer
spent waiting on the iterator) plus the ``data.epoch`` span on the
global tracer.
"""

from __future__ import annotations

import copy
import inspect
import logging
import queue as queue_lib
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from analytics_zoo_tpu_torch.common.observability import (
    data_metrics,
    get_tracer,
    monotonic_s,
)
from analytics_zoo_tpu_torch.data import sources as sources_lib

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = ["Pipeline", "PipelineIterator"]

#: state_dict schema version — bump on incompatible changes.
_STATE_VERSION = 1


def _buffered_shuffle(n: int, buffer_size: int, rng) -> List[int]:
    """The emitted index order of a streaming buffer shuffle: fill a
    ``buffer_size`` window, repeatedly emit a uniformly-chosen element and
    refill from the (sequential) source. A pure function of
    ``(n, buffer_size, rng seed)`` — which is what makes a shuffled
    stream checkpointable without persisting buffer contents."""
    buf = list(range(min(buffer_size, n)))
    nxt = len(buf)
    out: List[int] = []
    while buf:
        j = int(rng.integers(0, len(buf)))
        out.append(buf[j])
        if nxt < n:
            buf[j] = nxt
            nxt += 1
        else:
            buf[j] = buf[-1]
            buf.pop()
    return out


def _accepts_rng(fn: Callable) -> bool:
    """True when ``fn`` takes a second positional argument — the map stage
    then calls ``fn(record, rng)`` with the per-sample generator."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):  # builtins / C callables
        return False
    params = [p for p in sig.parameters.values()
              if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(params) >= 2


def _record_xy(rec) -> Tuple[Any, Any]:
    """Extract ``(x, y)`` from a pipeline record: ImageFeature dicts use
    ``sample`` (falling back to ``image``) + ``label``; 2-tuples pass
    through; anything else is an unlabeled x."""
    if isinstance(rec, dict):
        x = rec.get("sample", rec.get("image"))
        if x is None:
            raise ValueError(
                "record has neither 'sample' nor 'image' — did the map "
                "chain decode it (ImageRead/ImageBytesToMat)?")
        return x, rec.get("label")
    if isinstance(rec, tuple) and len(rec) == 2:
        return rec
    return rec, None


def _stack(vals: List[Any]):
    """Stack per-sample values into a batch; list/tuple samples (multi
    input) stack component-wise."""
    if isinstance(vals[0], (list, tuple)):
        return [np.stack([np.asarray(v[k]) for v in vals])
                for k in range(len(vals[0]))]
    return np.stack([np.asarray(v) for v in vals])


class PipelineIterator:
    """One epoch's batch stream — ``(x, y, mask)`` triples — with
    checkpointable position. Create via :meth:`Pipeline.train_batches` /
    :meth:`Pipeline.eval_batches`; pass to ``state_dict()`` consumers via
    :meth:`Pipeline.state_dict` (the pipeline tracks its live
    iterator)."""

    def __init__(self, pipeline: "Pipeline", gen, epoch_seed: int,
                 batch_size: int, start_step: int):
        self._pipeline = pipeline
        self._gen = gen
        self.epoch_seed = int(epoch_seed)
        self.batch_size = int(batch_size)
        #: batches emitted so far THIS epoch (start_step included — the
        #: checkpoint position is absolute within the epoch stream)
        self.position_batches = int(start_step)
        #: valid (non-pad) samples emitted this epoch, start offset included
        self.samples_seen = 0
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self):
        x, y, mask, valid = next(self._gen)
        self.position_batches += 1
        self.samples_seen += valid
        return x, y, mask

    def close(self):
        """Tear the worker pool down now (also runs on GC / generator
        close — but an explicit close makes teardown deterministic)."""
        if not self._closed:
            self._closed = True
            self._gen.close()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    def state_dict(self) -> dict:
        """This iterator's resumable position (see
        :meth:`Pipeline.state_dict`)."""
        return self._pipeline.state_dict(epoch_seed=self.epoch_seed,
                                         position=self.position_batches,
                                         samples_seen=self.samples_seen)


def _map_batch(fn: Callable, item):
    """``fn`` over every array of an ``(x, y, mask)`` batch (``x`` and
    ``y`` may be lists of arrays; ``y`` may be None)."""
    def one(a):
        if a is None:
            return None
        if isinstance(a, (list, tuple)):
            return [fn(v) for v in a]
        return fn(a)

    return tuple(one(a) for a in item)


class _HostTransfer:
    """The CPU device's transfer: a synchronous copy (never an alias of
    the pipeline's buffers)."""

    def __init__(self, device):
        from analytics_zoo_tpu_torch.common.nncontext import host_to_device

        self._copy = lambda a: host_to_device(a, device)

    def __call__(self, item):
        return _map_batch(self._copy, item)

    @staticmethod
    def ready(item):
        return item


class _CudaTransfer:
    """The CUDA transfer, run on the prefetch thread: each array is
    copied into pinned host memory, then to the card with
    ``non_blocking=True`` on a side stream, and the stream's event is
    recorded behind the copies. :meth:`ready` runs on the consumer's
    thread: its current stream waits on the event, and every tensor is
    ``record_stream``-ed on it. The pinned staging tensors stay
    referenced until then (the copies read them asynchronously)."""

    def __init__(self, device):
        import torch

        self._torch = torch
        self.device = device
        self.stream = torch.cuda.Stream(device=device)

    def _pinned(self, a):
        torch = self._torch
        arr = np.asarray(a)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        # pin_memory copies: the staging buffer is ours, not the pipeline's
        return torch.from_numpy(np.ascontiguousarray(arr)).pin_memory()

    def __call__(self, item):
        torch = self._torch
        pinned = _map_batch(self._pinned, item)
        with torch.cuda.stream(self.stream):
            dev = _map_batch(
                lambda t: t.to(self.device, non_blocking=True), pinned)
            event = torch.cuda.Event()
            event.record(self.stream)
        return dev, event, pinned

    def ready(self, payload):
        dev, event, _pinned = payload
        compute = self._torch.cuda.current_stream(self.device)
        compute.wait_event(event)
        _map_batch(lambda t: t.record_stream(compute), dev)
        return dev


class Pipeline:
    """Composable streaming input pipeline over an indexable
    :class:`~analytics_zoo_tpu_torch.data.sources.Source`.

    Stage calls (``map``/``shuffle``/``batch``/``prefetch``) return NEW
    pipelines (the source and stage list are shared structurally), so a
    base pipeline can fan out into train/eval variants. The object also
    speaks the ``FeatureSet`` batch-iterator protocol (``num_samples``,
    ``train_batches``, ``eval_batches``, ``steps_per_epoch``; multi-host
    windows and mid-epoch ``start_step`` resume included), and
    ``Estimator.train`` takes it directly.
    """

    def __init__(self, source: sources_lib.Source, seed: int = 0):
        if not hasattr(source, "fetch") or not hasattr(source, "__len__"):
            raise TypeError(
                f"source must expose __len__ and fetch(i); got {type(source)}")
        self._source = source
        self._rng_seed = int(seed)
        self._maps: List[Tuple[Callable, bool]] = []  # (fn, accepts_rng)
        self._num_workers = 0
        self._shuffle_cfg: Optional[Tuple[int, int]] = None  # (buffer, seed)
        self._batch_cfg: Optional[Tuple[int, bool, Optional[Tuple[int, ...]]]] = None
        self.prefetch_depth = 0
        self._resume: Optional[dict] = None
        self._live_iter: Optional[Callable] = None  # weakref to PipelineIterator
        self._prefetch_hwm = 0
        self._metrics = None  # lazy data_metrics()

    # -- constructors ----------------------------------------------------

    @staticmethod
    def from_feature_set(feature_set, seed: int = 0) -> "Pipeline":
        """Stream any FeatureSet sample-by-sample (its attached transforms
        run on the map workers via per-sample ``take``)."""
        return Pipeline(sources_lib.FeatureSetSource(feature_set), seed=seed)

    @staticmethod
    def from_image_set(image_set, seed: int = 0) -> "Pipeline":
        """Stream an ImageSet; its accumulated transform chain becomes the
        pipeline's first map stage (run per-sample on the workers, not
        materialized up front like ``to_feature_set``)."""
        src = sources_lib.ImageSetSource(image_set)
        pipe = Pipeline(src, seed=seed)
        for t in src.chain:
            pipe = pipe.map(t)
        return pipe

    @staticmethod
    def from_text_set(text_set, seed: int = 0) -> "Pipeline":
        """Stream a processed TextSet's (token, label) rows."""
        return Pipeline(sources_lib.TextSetSource(text_set), seed=seed)

    @staticmethod
    def from_files(path: Union[str, Sequence[str]], with_label: bool = False,
                   one_based_label: bool = False, seed: int = 0) -> "Pipeline":
        """Stream a directory (class subdirs become labels, like
        ``ImageSet.read``) or file list as undecoded ImageFeatures — chain
        a ``map(ImageRead() | ...)`` to decode on the worker pool."""
        return Pipeline(sources_lib.FileSource(
            path, with_label=with_label, one_based_label=one_based_label),
            seed=seed)

    @staticmethod
    def from_capture(dirs, seed: int = 0) -> "Pipeline":
        """Stream committed capture segments (the serving tap's output —
        :mod:`analytics_zoo_tpu_torch.flywheel.capture`) as ``(x, y)``
        samples with the captured prediction as the target. ``dirs`` may
        be segment directories or model capture roots; ordering is
        stable, corruption is loud — the flywheel retrain's input path."""
        from analytics_zoo_tpu_torch.flywheel.replay import CaptureSource

        return Pipeline(CaptureSource(dirs), seed=seed)

    @staticmethod
    def from_labeled_capture(dirs, label_dirs, seed: int = 0) -> "Pipeline":
        """Stream committed capture segments joined with outcome labels
        (:mod:`analytics_zoo_tpu_torch.flywheel.labels`) as ``(x,
        outcome)`` samples — the target is the ground truth a client
        reported for the trace, not the incumbent's prediction. Rows
        without a matching label are skipped; duplicate labels resolve
        last-write-wins by timestamp, independent of arrival order. The
        outcome-mode retrain's input path."""
        from analytics_zoo_tpu_torch.flywheel.labels import LabeledSource

        return Pipeline(LabeledSource(dirs, label_dirs=label_dirs),
                        seed=seed)

    # -- stages ----------------------------------------------------------

    def _clone(self) -> "Pipeline":
        c = copy.copy(self)
        c._maps = list(self._maps)
        c._resume = None
        c._live_iter = None
        return c

    def map(self, fn: Callable, num_workers: int = 0) -> "Pipeline":
        """Append a per-sample transform (an ``ImageProcessing`` chain, a
        plain ``record -> record`` fn, or ``(record, rng) -> record`` for
        explicit per-sample randomness). ``num_workers`` > 0 runs the
        whole composed map chain on a thread pool of that size (the max
        across stages wins); results are reassembled in order, so the
        stream is bitwise identical for any worker count."""
        if num_workers < 0:
            raise ValueError(f"num_workers must be >= 0, got {num_workers}")
        c = self._clone()
        c._maps.append((fn, _accepts_rng(fn)))
        c._num_workers = max(self._num_workers, int(num_workers))
        return c

    def shuffle(self, buffer_size: int, seed: int = 0) -> "Pipeline":
        """Streaming buffer shuffle (window of ``buffer_size`` samples);
        the emitted order is a pure function of ``(seed, epoch)`` — which
        keeps a shuffled stream checkpointable and resume bitwise."""
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        c = self._clone()
        c._shuffle_cfg = (int(buffer_size), int(seed))
        return c

    def batch(self, batch_size: int, drop_remainder: bool = False,
              pad_to_bucket: Optional[Sequence[int]] = None) -> "Pipeline":
        """Assemble ``(x, y, mask)`` batches of ``batch_size`` rows. The
        tail: wrap-padded to ``batch_size`` with mask 0 (default — the
        static-shape contract a captured step needs), dropped
        (``drop_remainder=True``), or padded to the smallest bucket of
        ``pad_to_bucket`` that fits (ascending ladder; batches then come
        in at most ``len(ladder)`` shapes, each a warmed bucket)."""
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        buckets = None
        if pad_to_bucket is not None:
            buckets = tuple(sorted(int(b) for b in pad_to_bucket))
            if drop_remainder:
                raise ValueError("drop_remainder and pad_to_bucket are "
                                 "mutually exclusive tail policies")
            if not buckets or buckets[-1] < batch_size:
                raise ValueError(
                    f"pad_to_bucket ladder {buckets} must top out at >= "
                    f"batch_size {batch_size}")
        c = self._clone()
        c._batch_cfg = (int(batch_size), bool(drop_remainder), buckets)
        return c

    def prefetch(self, depth: int = 2) -> "Pipeline":
        """Keep up to ``depth`` host batches assembled ahead of the
        consumer on a background thread (:meth:`host_batches`)."""
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        c = self._clone()
        c.prefetch_depth = int(depth)
        return c

    # -- FeatureSet-protocol surface -------------------------------------

    @property
    def num_samples(self) -> int:
        """Samples per epoch (the source's length)."""
        return len(self._source)

    @property
    def batch_size(self) -> Optional[int]:
        """The ``batch()`` stage's size (None when un-batched — the
        iterator calls then require an explicit ``batch_size``)."""
        return self._batch_cfg[0] if self._batch_cfg else None

    def steps_per_epoch(self, batch_size: Optional[int] = None) -> int:
        """Batches one epoch yields at ``batch_size`` (default: the batch
        stage's)."""
        b, drop, _ = self._resolve_batch(batch_size)
        n = self.num_samples
        return n // b if drop else -(-n // b)

    def _resolve_batch(self, batch_size: Optional[int]
                       ) -> Tuple[int, bool, Optional[Tuple[int, ...]]]:
        if self._batch_cfg is not None:
            b, drop, buckets = self._batch_cfg
            if batch_size is not None and int(batch_size) != b:
                logger.warning(
                    "pipeline batch stage is %d but the caller asked for "
                    "%d — using the caller's (set them equal, or drop one)",
                    b, batch_size)
                return int(batch_size), drop, None
            return b, drop, buckets
        if batch_size is None:
            raise ValueError(
                "no batch size: add a .batch(b) stage or pass batch_size")
        return int(batch_size), False, None

    # -- epoch order -----------------------------------------------------

    def _epoch_order(self, epoch_seed: int, shuffle: bool) -> List[int]:
        """The epoch's sample-index order — a pure function of
        ``(epoch_seed, n, shuffle stage)``: resume re-derives it in
        integer time and skips consumed positions without fetching."""
        n = self.num_samples
        if not shuffle:
            return list(range(n))
        if self._shuffle_cfg is None:
            # bit-identical to FeatureSet.train_batches' epoch order
            order = np.arange(n)
            np.random.default_rng(epoch_seed).shuffle(order)
            return order.tolist()
        buf, sseed = self._shuffle_cfg
        rng = np.random.default_rng(
            np.random.SeedSequence((sseed, int(epoch_seed) & 0xFFFFFFFF)))
        return _buffered_shuffle(n, buf, rng)

    # -- the mapped sample stream ----------------------------------------

    def _sample_task(self, epoch_seed: int):
        """The per-sample work unit the map workers run: fetch + seeded
        transform chain. Seeding from ``(pipeline seed, epoch, index)``
        makes each sample's randomness independent of every other
        sample's — the worker-count-independence contract."""
        source, maps = self._source, self._maps
        pipe_seed = self._rng_seed

        def task(idx: int):
            rec = source.fetch(idx)
            if maps:
                rng = np.random.default_rng(np.random.SeedSequence(
                    (pipe_seed, int(epoch_seed) & 0xFFFFFFFF, int(idx))))
                if isinstance(rec, dict):
                    rec["rng"] = rng
                for fn, wants_rng in maps:
                    rec = fn(rec, rng) if wants_rng else fn(rec)
                if isinstance(rec, dict):
                    rec.pop("rng", None)
            return rec

        return task

    def _mapped_stream(self, order: Sequence[int], epoch_seed: int):
        """Records for ``order``, in order — through the worker pool when
        the map stage asked for one. The pool is torn down (futures
        cancelled, threads joined) when the generator closes, finishes,
        or raises: pytest must never hang on an orphaned worker."""
        task = self._sample_task(epoch_seed)
        workers = self._num_workers
        if workers <= 1:
            for i in order:
                yield task(i)
            return
        # bounded in-flight window: workers stay busy, memory stays capped
        inflight = max(2 * workers, workers + 1)
        pool = ThreadPoolExecutor(max_workers=workers,
                                  thread_name_prefix="zoo-data-worker")
        try:
            from collections import deque

            pending: "deque" = deque()
            it = iter(order)
            for i in it:
                pending.append(pool.submit(task, i))
                if len(pending) >= inflight:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    # -- batch assembly --------------------------------------------------

    def _batches(self, epoch_seed: int, shuffle: bool, batch_size: int,
                 drop_remainder: bool, buckets, start_step: int,
                 window: Optional[Tuple[int, int]]):
        """Yield ``(x, y, mask, valid)`` per batch. ``start_step`` skips
        whole batches without fetching a sample (O(order) ints — the
        mid-epoch resume path); ``window`` keeps only this process's rows
        of each global batch (multi-host)."""
        metrics = self._metrics or data_metrics()
        self._metrics = metrics
        tracer = get_tracer()
        # the epoch order re-derives in integer time; slicing it IS the
        # O(1)-in-sample-work resume (no consumed sample is fetched)
        full_order = self._epoch_order(epoch_seed, shuffle)
        order = full_order[start_step * batch_size:]
        t_epoch0 = monotonic_s()
        emitted_samples = 0
        task = self._sample_task(epoch_seed)
        stream = self._mapped_stream(order, epoch_seed)
        try:
            recs: List[Any] = []
            for rec in stream:
                recs.append(rec)
                if len(recs) < batch_size:
                    continue
                yield self._assemble(recs, batch_size, window)
                metrics["batches"].inc()
                metrics["samples"].inc(batch_size)
                emitted_samples += batch_size
                recs = []
            if recs and not drop_remainder:
                valid = len(recs)
                target = batch_size
                if buckets is not None:
                    target = next(b for b in buckets if b >= valid)
                # wrap-pad from the epoch order's head — the exact
                # FeatureSet.train_batches tail contract (mask 0 rows
                # included), re-derived through the same seeded task so
                # pads are bitwise their original occurrence
                n = len(full_order)
                recs += [task(full_order[j % n])
                         for j in range(target - valid)]
                yield self._assemble(recs, valid, window)
                metrics["batches"].inc()
                metrics["samples"].inc(valid)
                emitted_samples += valid
        finally:
            stream.close()
            dt = monotonic_s() - t_epoch0
            if emitted_samples and dt > 0:
                metrics["samples_per_sec"].set(emitted_samples / dt)
            if tracer.enabled:
                # record_span, not a `with` block: a span held open across
                # generator yields would contextvar-parent the CONSUMER's
                # spans (train.dispatch...) under data.epoch
                tracer.record_span(
                    "data.epoch", tracer.current_trace_id() or "data",
                    t_epoch0, monotonic_s(), seed=int(epoch_seed),
                    batch=batch_size, workers=self._num_workers,
                    skipped=start_step, samples=emitted_samples)

    @staticmethod
    def _assemble(recs: List[Any], valid: int,
                  window: Optional[Tuple[int, int]]):
        xs, ys = zip(*(_record_xy(r) for r in recs))
        x = _stack(list(xs))
        y = None if ys[0] is None else _stack(list(ys))
        mask = np.zeros(len(recs), np.float32)
        mask[:valid] = 1.0
        if window is not None:
            lo, hi = window
            x = ([a[lo:hi] for a in x] if isinstance(x, list) else x[lo:hi])
            if y is not None:
                y = ([a[lo:hi] for a in y] if isinstance(y, list)
                     else y[lo:hi])
            mask = mask[lo:hi]
        return x, y, mask, valid

    # -- iterator API (the Estimator protocol) ---------------------------

    def train_batches(self, batch_size: Optional[int] = None,
                      shuffle: bool = True, seed: int = 0,
                      window: Optional[Tuple[int, int]] = None,
                      start_step: int = 0) -> PipelineIterator:
        """One training epoch of ``(x, y, mask)`` batches. ``seed`` is the
        epoch seed (the JAX package's Estimator passes its epoch — the
        same contract as ``FeatureSet``); ``start_step`` resumes mid-epoch without
        re-executing consumed work. A pending :meth:`load_state_dict`
        position applies when ``start_step`` is 0 and the epoch seed
        matches the saved one."""
        resume, self._resume = self._resume, None
        if resume is not None and start_step == 0:
            if int(resume.get("epoch_seed", -1)) == int(seed):
                start_step = int(resume.get("position_batches", 0))
            else:
                logger.warning(
                    "pipeline state_dict was saved at epoch seed %s but this "
                    "epoch runs seed %s — starting the epoch from step 0",
                    resume.get("epoch_seed"), seed)
        b, drop, buckets = self._resolve_batch(batch_size)
        it = PipelineIterator(
            self, self._batches(int(seed), shuffle, b, drop, buckets,
                                int(start_step), window),
            epoch_seed=int(seed), batch_size=b, start_step=int(start_step))
        it.samples_seen = min(self.num_samples, int(start_step) * b)
        self._live_iter = weakref.ref(it)
        return it

    def eval_batches(self, batch_size: Optional[int] = None,
                     window: Optional[Tuple[int, int]] = None
                     ) -> PipelineIterator:
        """Deterministic dataset-order epoch (no shuffle; per-sample RNG
        seeded from epoch seed 0, so randomized transforms — if any are
        left in an eval chain — are at least reproducible)."""
        b, drop, buckets = self._resolve_batch(batch_size)
        it = PipelineIterator(
            self, self._batches(0, False, b, drop, buckets, 0, window),
            epoch_seed=0, batch_size=b, start_step=0)
        self._live_iter = weakref.ref(it)
        return it

    def host_batches(self, batch_size: Optional[int] = None,
                     start_step: int = 0):
        """Deterministic dataset-order ``(x, y, mask)`` stream that stays
        on the host (NumPy in, NumPy out): the feed
        for consumers that manage their own device transfer, like the
        batch scoring engine's dispatch/fetch loop. Epoch seed is pinned
        to 0 and shuffle off, so the stream is a pure function of
        ``(source, stages, start_step)`` — the property batch-job resume
        leans on. With a ``.prefetch(k)`` stage the batches are assembled
        ``k`` deep on a background thread (identity transfer through
        :meth:`_prefetched`, so the wait/starvation metrics still
        apply); close the returned generator to tear that thread down."""
        host_iter = self.train_batches(batch_size, shuffle=False, seed=0,
                                       start_step=start_step)
        if not self.prefetch_depth:
            def _plain():
                try:
                    for item in host_iter:
                        yield item
                finally:
                    host_iter.close()
            return _plain()
        return self._prefetched(host_iter, lambda item: item,
                                self.prefetch_depth)

    def device_batches(self, batch_size: Optional[int] = None,
                       shuffle: bool = True, seed: int = 0,
                       start_step: int = 0):
        """Device-resident ``(x, y, mask)`` stream: a background thread
        assembles host batches and starts their copy to the context's
        device, keeping up to ``prefetch_depth or 2``
        batches in flight, so host decode and the copy overlap device
        compute. Consumer wait time feeds ``zoo_data_wait_seconds`` /
        ``zoo_data_starvation_ratio``.

        On a CUDA device each array is staged in pinned host memory (a
        copy: the pipeline's own buffer is never aliased) and copied with
        ``non_blocking=True`` on a side stream; the consumer's stream
        waits on that copy's event before it sees the batch, and each
        tensor is ``record_stream``-ed on it, so the allocator never hands
        the memory out while the consumer's kernels may still read it. On
        the CPU the copy is :func:`host_to_device`'s. Arrays arrive as
        ``host_to_device`` makes them: float64 as float32, integers as
        they are. One process drives one device, so the JAX package's
        data-axis sharded placement (``shard_batch``) is the identity
        here."""
        from analytics_zoo_tpu_torch.common.nncontext import get_nncontext

        dev = get_nncontext().device
        transfer = (_CudaTransfer(dev) if dev.type == "cuda"
                    else _HostTransfer(dev))
        host_iter = self.train_batches(batch_size, shuffle=shuffle,
                                       seed=seed, start_step=start_step)
        for item in self._prefetched(host_iter, transfer,
                                     self.prefetch_depth or 2):
            yield transfer.ready(item)

    def _prefetched(self, host_iter, transfer: Callable, depth: int):
        """The async double-buffer behind :meth:`host_batches` and
        :meth:`device_batches`, instrumented: queue depth gauge +
        high-water mark, per-batch consumer wait, starvation ratio."""
        metrics = self._metrics or data_metrics()
        self._metrics = metrics
        q: queue_lib.Queue = queue_lib.Queue(maxsize=depth)
        stop = threading.Event()
        _SENTINEL = object()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_lib.Full:
                    continue
            return False

        def worker():
            try:
                for item in host_iter:
                    if not _put(("ok", transfer(item))):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised below
                _put(("err", e))
                return
            _put((_SENTINEL, None))

        t = threading.Thread(target=worker, daemon=True,
                             name="zoo-data-prefetch")
        t.start()
        waited = 0.0
        t0 = time.perf_counter()
        try:
            while True:
                w0 = time.perf_counter()
                item = q.get()
                wd = time.perf_counter() - w0
                waited += wd
                depth_now = q.qsize()
                self._prefetch_hwm = max(self._prefetch_hwm, depth_now + 1)
                metrics["queue_depth"].set(depth_now)
                metrics["wait_seconds"].observe(wd)
                tag, payload = item
                if tag is _SENTINEL:
                    return
                if tag == "err":
                    raise payload
                elapsed = time.perf_counter() - t0
                if elapsed > 0:
                    metrics["starvation_ratio"].set(
                        min(1.0, waited / elapsed))
                yield payload
        finally:
            stop.set()
            # join BEFORE closing: the worker may be mid-next() on the host
            # iterator, and closing a generator another thread is executing
            # raises "generator already executing"
            t.join(timeout=5.0)
            if hasattr(host_iter, "close"):
                host_iter.close()

    # -- checkpointable-iterator state -----------------------------------

    def note_queue_depth(self, depth: int) -> None:
        """Record an externally observed prefetch depth (a consumer's own
        infeed thread reports here so the checkpointed high-water mark
        reflects the active run)."""
        self._prefetch_hwm = max(self._prefetch_hwm, int(depth))

    def state_dict(self, epoch_seed: Optional[int] = None,
                   position: Optional[int] = None,
                   samples_seen: Optional[int] = None) -> dict:
        """The resumable stream position: epoch seed, batches emitted
        (``position``), source samples consumed, shuffle/batch config and
        the prefetch high-water mark. Defaults come from the live
        iterator; the Estimator overrides ``epoch_seed``/``position``
        with its authoritative counters at checkpoint time (the iterator
        may already be a few prefetched batches ahead of the optimizer).

        O(1) restore: everything needed to continue the stream is here —
        the integer order re-derives from the seeds; no consumed sample
        is re-fetched."""
        live = self._live_iter() if self._live_iter is not None else None
        if epoch_seed is None:
            epoch_seed = live.epoch_seed if live is not None else 0
        if position is None:
            position = live.position_batches if live is not None else 0
        b = (live.batch_size if live is not None else self.batch_size) or 0
        if samples_seen is None:
            samples_seen = (live.samples_seen if live is not None
                            else min(self.num_samples, int(position) * b))
        return {
            "version": _STATE_VERSION,
            "rng_seed": self._rng_seed,
            "epoch_seed": int(epoch_seed),
            "position_batches": int(position),
            "samples_seen": int(samples_seen),
            "batch_size": int(b),
            "num_samples": self.num_samples,
            "shuffle_buffer": (self._shuffle_cfg[0]
                               if self._shuffle_cfg else None),
            "shuffle_seed": (self._shuffle_cfg[1]
                             if self._shuffle_cfg else None),
            "num_workers": self._num_workers,
            "prefetch_depth": self.prefetch_depth,
            "prefetch_high_water": self._prefetch_hwm,
        }

    def load_state_dict(self, state: dict) -> "Pipeline":
        """Arm this pipeline to resume at a :meth:`state_dict` position:
        the next ``train_batches`` call with the matching epoch seed (and
        no explicit ``start_step``) continues at the recorded batch.
        Validates the stream-shape config — a mismatched batch size,
        sample count or shuffle stage would silently change the stream
        the position indexes into."""
        if int(state.get("version", -1)) != _STATE_VERSION:
            raise ValueError(
                f"unsupported pipeline state version {state.get('version')!r}"
                f" (this build speaks {_STATE_VERSION})")
        for key, mine in (
                ("batch_size", self.batch_size),
                ("num_samples", self.num_samples),
                ("rng_seed", self._rng_seed),
                ("shuffle_buffer",
                 self._shuffle_cfg[0] if self._shuffle_cfg else None),
                ("shuffle_seed",
                 self._shuffle_cfg[1] if self._shuffle_cfg else None)):
            theirs = state.get(key)
            if mine is not None and theirs is not None and mine != theirs:
                raise ValueError(
                    f"pipeline state mismatch on {key}: checkpoint has "
                    f"{theirs!r}, this pipeline has {mine!r} — the saved "
                    "position indexes a different stream")
        self._resume = dict(state)
        self._prefetch_hwm = max(self._prefetch_hwm,
                                 int(state.get("prefetch_high_water", 0)))
        return self

    def __repr__(self) -> str:
        stages = []
        if self._maps:
            stages.append(f"map(x{len(self._maps)}, "
                          f"workers={self._num_workers})")
        if self._shuffle_cfg:
            stages.append(f"shuffle({self._shuffle_cfg[0]})")
        if self._batch_cfg:
            b, drop, buckets = self._batch_cfg
            tail = ("drop" if drop else
                    f"buckets={list(buckets)}" if buckets else "wrap-pad")
            stages.append(f"batch({b}, {tail})")
        if self.prefetch_depth:
            stages.append(f"prefetch({self.prefetch_depth})")
        return (f"Pipeline({type(self._source).__name__}[{self.num_samples}]"
                + ("".join(" -> " + s for s in stages)) + ")")
