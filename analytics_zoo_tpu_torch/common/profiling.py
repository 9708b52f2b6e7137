"""Tracing / profiling (port of ``analytics_zoo_tpu.common.profiling``).

The reference has only ad-hoc ``timing(...)`` log blocks
(InferenceSupportive.scala, TFNet.scala:601-631) and per-module time lists
inside the BigDL optimizer cache (Topology.scala:1036). Here profiling is
first-class:

- :func:`timing` — the reference's log-block helper, as a context manager /
  decorator.
- :class:`StepTimer` — per-iteration wall-time stats (mean/p50/p95,
  throughput), the Perf.scala imgs/sec loop generalized.
- :func:`profile_trace` — wraps ``torch.profiler`` (host and, on the card,
  CUDA activity); the Chrome trace it writes opens in Perfetto /
  ``chrome://tracing`` and shows per-kernel device time.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger("analytics_zoo_tpu_torch")


@contextlib.contextmanager
def timing(name: str, log: bool = True):
    """Ref InferenceSupportive.timing — ``with timing("load model"):``.
    Yields a dict whose "elapsed" key holds seconds after the block."""
    out: Dict[str, float] = {}
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        out["elapsed"] = time.perf_counter() - t0
        if log:
            logger.info("%s took %.4fs", name, out["elapsed"])


def timed(fn: Callable) -> Callable:
    """Decorator: logs wall-clock of each call at DEBUG (host-side
    coarse timing; use set_profile for device traces)."""
    @functools.wraps(fn)
    def wrapper(*a, **kw):
        with timing(fn.__qualname__):
            return fn(*a, **kw)
    return wrapper


class StepTimer:
    """Collects per-step durations; reports throughput percentiles.

    The generalized form of the reference's perf loop
    (examples/vnni/bigdl/Perf.scala:61-68 prints imgs/sec per iteration).
    """

    def __init__(self, items_per_step: Optional[int] = None,
                 warmup: int = 1, max_samples: Optional[int] = None):
        self.items_per_step = items_per_step
        self.warmup = warmup
        # Bounded reservoir: long-lived collectors (the serving metrics
        # histograms) cap memory by keeping only the newest max_samples.
        self.max_samples = max_samples
        self._durations: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        """Begin timing a step window."""
        self._t0 = time.perf_counter()

    def stop(self):
        """End the window; records the elapsed step time."""
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() without start()")
        self.record(time.perf_counter() - self._t0)
        self._t0 = None

    def record(self, seconds: float):
        """Record an externally measured duration (no start/stop window) —
        lets other subsystems (e.g. the serving metrics summaries,
        serving/metrics.py) reuse this class's percentile math."""
        self._durations.append(float(seconds))
        if self.max_samples is not None and \
                len(self._durations) > self.max_samples:
            del self._durations[:len(self._durations) - self.max_samples]

    @contextlib.contextmanager
    def step(self):
        """Context manager timing one step: ``with timer.step(): ...``."""
        self.start()
        try:
            yield
        finally:
            self.stop()

    @property
    def steps(self) -> int:
        """Number of completed timed windows."""
        return len(self._durations)

    def summary(self) -> Dict[str, float]:
        """mean/p50/p95/p99 step seconds (+ items/sec if configured),
        excluding warmup steps (first-step compile time would swamp the
        stats)."""
        d = np.asarray(self._durations[self.warmup:] or self._durations,
                       dtype=np.float64)
        if d.size == 0:
            return {}
        out = {
            "steps": float(d.size),
            "mean_s": float(d.mean()),
            "p50_s": float(np.percentile(d, 50)),
            "p95_s": float(np.percentile(d, 95)),
            "p99_s": float(np.percentile(d, 99)),
        }
        if self.items_per_step:
            out["items_per_sec"] = self.items_per_step / out["mean_s"]
        return out


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Collect a trace of the enclosed block with ``torch.profiler`` (CPU
    activity, plus CUDA activity when a card is present) and write it to
    ``log_dir/trace.json`` as Chrome trace-event JSON (open it in Perfetto
    or ``chrome://tracing``). Yields the profiler, so the caller can read
    ``key_averages()`` too."""
    import os

    import torch.profiler as tp

    acts = [tp.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(tp.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with tp.profile(activities=acts) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("Profiler trace written to %s", path)
