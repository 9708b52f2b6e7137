"""Queue-depth-driven worker autoscaling for one front door (port of
``analytics_zoo_tpu.serving.fabric.autoscaler``).

The backpressure signal already exists: every worker's batcher exports
``zoo_serving_queue_depth`` and reports it per model version in its
``/healthz`` body. :meth:`~analytics_zoo_tpu_torch.serving.frontdoor
.FrontDoor.queue_depths` reads it at the source, and
:meth:`~analytics_zoo_tpu_torch.serving.frontdoor.FrontDoor.scale_to` already
knows how to grow (spawn + health-gate + ring join) and shrink (ring
eject + engine drain + SIGTERM) the prefork set — this module is only
the *policy* connecting the two.

The policy is deliberately boring and fully deterministic:

- **Scale up fast**: one tick with mean queue depth per live worker
  above ``high_queue_depth`` adds one worker (queue growth compounds —
  waiting to be sure costs latency SLO budget).
- **Scale down slow**: ``scale_down_ticks`` *consecutive* ticks below
  ``low_queue_depth`` remove one worker (a worker boot is expensive;
  flapping around a burst is worse than briefly overprovisioning).
- **Cooldown**: after any action, ``cooldown_ticks`` ticks of
  observation-only — the just-changed fleet needs time to show its new
  steady state before the controller reacts again.

:meth:`Autoscaler.observe` is a pure decision step (counters in, target
out, no I/O), so the hysteresis is unit-testable with plain lists of
depths; :meth:`Autoscaler.start` runs the production loop that feeds it
from the front door.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = ["Autoscaler", "AutoscalerConfig"]


@dataclass
class AutoscalerConfig:
    """Scaling policy knobs (see the module docstring for the shape).

    Args:
      min_workers / max_workers: the allowed prefork-set size range.
      high_queue_depth: mean queued requests per live worker above
        which one worker is added (scale up on a single tick).
      low_queue_depth: mean below which a scale-down tick accrues.
      scale_down_ticks: consecutive low ticks required to remove one
        worker.
      cooldown_ticks: observation-only ticks after any scaling action.
      interval_s: production loop cadence (:meth:`Autoscaler.start`).
    """

    min_workers: int = 1
    max_workers: int = 4
    high_queue_depth: float = 4.0
    low_queue_depth: float = 0.5
    scale_down_ticks: int = 4
    cooldown_ticks: int = 2
    interval_s: float = 0.5

    def __post_init__(self):
        if self.min_workers < 1:
            raise ValueError("min_workers must be >= 1")
        if self.max_workers < self.min_workers:
            raise ValueError("max_workers must be >= min_workers")
        if self.low_queue_depth >= self.high_queue_depth:
            raise ValueError("low_queue_depth must be < "
                             "high_queue_depth (hysteresis band)")
        if self.scale_down_ticks < 1 or self.cooldown_ticks < 0:
            raise ValueError("scale_down_ticks must be >= 1 and "
                             "cooldown_ticks >= 0")


class Autoscaler:
    """The controller: observes queue depths, decides a target size,
    and (in the production loop) applies it via ``FrontDoor.scale_to``.

    ``events`` counts applied actions per direction — the fleet door
    exports them as ``zoo_fleet_autoscale_events_total``."""

    def __init__(self, frontdoor=None,
                 config: Optional[AutoscalerConfig] = None):
        self.config = config or AutoscalerConfig()
        self._fd = frontdoor
        self._low_ticks = 0
        self._cooldown = 0
        self.events = {"up": 0, "down": 0}
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    def observe(self, depths: Dict[str, float], current: int) -> int:
        """One pure decision step: the target worker count given this
        tick's per-worker queue depths and the current live count.

        No I/O and no clock — tests drive the whole hysteresis state
        machine (up-fast, down-slow, cooldown) with plain dicts."""
        c = self.config
        if self._cooldown > 0:
            self._cooldown -= 1
            return current
        mean = (sum(depths.values()) / len(depths)) if depths else 0.0
        if mean > c.high_queue_depth and current < c.max_workers:
            self._low_ticks = 0
            self._cooldown = c.cooldown_ticks
            return current + 1
        if mean < c.low_queue_depth and current > c.min_workers:
            self._low_ticks += 1
            if self._low_ticks >= c.scale_down_ticks:
                self._low_ticks = 0
                self._cooldown = c.cooldown_ticks
                return current - 1
        else:
            self._low_ticks = 0
        return current

    def tick(self) -> int:
        """One production step: read depths from the front door, decide,
        apply. Returns the (possibly unchanged) live worker count."""
        fd = self._fd
        if fd is None:
            raise RuntimeError("no front door attached to this "
                               "autoscaler")
        depths = fd.queue_depths()
        current = len(depths)
        if current == 0:
            return 0        # ring empty or unreachable: never act blind
        target = self.observe(depths, current)
        if target != current:
            direction = "up" if target > current else "down"
            fd.scale_to(target)
            self.events[direction] += 1
        return target

    def start(self) -> None:
        """Run :meth:`tick` every ``interval_s`` on a daemon thread.
        Idempotent."""
        if self._thread is not None:
            return
        self._stop = threading.Event()

        def _loop():
            while not self._stop.wait(self.config.interval_s):
                try:
                    self.tick()
                except Exception:   # noqa: BLE001 — keep the loop alive
                    pass

        self._thread = threading.Thread(target=_loop,
                                        name="fleet-autoscaler",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the production loop (no effect on the worker count)."""
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
            self._stop = None
