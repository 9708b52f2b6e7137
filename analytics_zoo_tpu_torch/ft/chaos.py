"""Fault injection for the checkpoint commit protocol and the serving path
(port of ``analytics_zoo_tpu.ft.chaos``: its checkpoint and serving failure
points).

The commit protocol of :mod:`analytics_zoo_tpu_torch.ft.atomic` has named
failure points where an environment variable makes the process die hard
(``os._exit``: no ``finally`` blocks, no atexit, as a preemption or an
out-of-memory kill does). A kill test dies at each one and checks that
``auto_resume`` reproduces the uninterrupted run bitwise.

- ``AZOO_FT_CHAOS``: the failure point to trigger (:data:`FAILURE_POINTS`).
- ``AZOO_FT_CHAOS_SKIP``: optional int: survive that many hits of the
  point first (kill at the N+1th checkpoint, not the first).

With the variable unset every hook is an environment lookup and a compare.

Serving failure points (:data:`SERVING_POINTS`) are *in-process* faults in
the batcher's predict path: the process survives; what dies or degrades is
a flush, a batch, or the flush thread itself. They are armed
programmatically (:func:`arm_serving`) or through ``AZOO_SERVING_CHAOS``
for subprocess or manual drills, and exercise the resilience layer:
``predict_raises`` drives the circuit breaker, ``predict_slow`` the
admission EWMA and wedge detection, ``flush_thread_dies`` the watchdog.

The JAX package's batch, distributed, front-door, flywheel, fleet and
pipeline points belong to tiers the port does not have yet (ROADMAP A8).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

__all__ = ["FAILURE_POINTS", "EXIT_CODE", "active_point", "should_fail",
           "fail", "maybe_fail", "reset",
           "SERVING_POINTS", "ChaosPredictError", "FlushThreadDeath",
           "arm_serving", "disarm_serving", "serving_chaos", "serving_hits"]

#: The commit protocol's kill sites, in write order:
#:
#: - ``torn_arrays``: half the array file's bytes hit disk, then death.
#: - ``after_arrays``: the array file is complete, the manifest was never
#:   written.
#: - ``before_rename``: everything staged and fsynced in ``ckpt_N.tmp/``,
#:   death before the atomic rename.
#: - ``before_commit``: renamed to ``ckpt_N/``, death before the COMMIT
#:   marker lands.
FAILURE_POINTS = ("torn_arrays", "after_arrays", "before_rename",
                  "before_commit")

#: Exit status of a chaos kill, distinguishable from a real crash.
EXIT_CODE = 43

#: The batcher's in-process serving faults:
#:
#: - ``predict_raises``: the model raises :class:`ChaosPredictError` (a
#:   plain predict failure: the batch fails, the flush thread survives).
#:   Feeds the circuit breaker.
#: - ``predict_slow``: the flush sleeps before predicting (a slow model or
#:   a contended card). Feeds the admission EWMA and, with a long enough
#:   sleep, the watchdog's wedge detection.
#: - ``flush_thread_dies``: :class:`FlushThreadDeath` (a BaseException)
#:   escapes every ``except Exception`` backstop and kills the flush
#:   thread, leaving its in-flight batch unresolved: the silent death the
#:   watchdog exists for.
#: - ``canary_errors`` / ``canary_slow``: *targetable* variants of
#:   ``predict_raises`` / ``predict_slow``: armed with a ``tag`` (the
#:   batcher's ``name@version``), only that version's flush path fires, so
#:   rollout tests can break exactly the canary.
SERVING_POINTS = ("predict_raises", "predict_slow", "flush_thread_dies",
                  "canary_errors", "canary_slow")


class ChaosPredictError(RuntimeError):
    """The injected model failure behind ``predict_raises``."""


class FlushThreadDeath(BaseException):
    """Injected thread-killer behind ``flush_thread_dies``.

    A ``BaseException`` on purpose: the batcher's flush loop backstops
    ``except Exception`` so a model fault fails one batch, not the thread;
    simulating a *dead thread* needs something those backstops miss."""


_hits = 0

# point -> {"remaining": Optional[int], "sleep_s": float, "hits": int,
# "tag": Optional[str]}; guarded by _serving_lock.
_serving_armed: Dict[str, Dict] = {}
_serving_lock = threading.Lock()
_serving_env_hits = 0


def reset() -> None:
    """Zero the hit counters and disarm serving chaos (test isolation)."""
    global _hits, _serving_env_hits
    _hits = 0
    _serving_env_hits = 0
    disarm_serving()


def arm_serving(point: str, times: Optional[int] = None,
                sleep_s: float = 0.05,
                tag: Optional[str] = None) -> None:
    """Arm a serving failure point in-process.

    Args:
      point: one of :data:`SERVING_POINTS`.
      times: fire on this many hits then stop (None = every hit until
        :func:`disarm_serving`).
      sleep_s: sleep of ``predict_slow`` / ``canary_slow`` (ignored
        otherwise).
      tag: fire only at call sites carrying this tag (the batcher passes
        ``name@version``, so ``tag="m@2"`` breaks only version 2 of model
        ``m``); None fires everywhere.
    """
    if point not in SERVING_POINTS:
        raise ValueError(f"{point!r} is not a serving failure point; "
                         f"known: {SERVING_POINTS}")
    with _serving_lock:
        _serving_armed[point] = {"remaining": times, "sleep_s": sleep_s,
                                 "hits": 0, "tag": tag}


def disarm_serving(point: Optional[str] = None) -> None:
    """Disarm one serving point (or all of them with ``point=None``)."""
    with _serving_lock:
        if point is None:
            _serving_armed.clear()
        else:
            _serving_armed.pop(point, None)


def serving_hits(point: str) -> int:
    """How many times ``point`` fired since it was armed (0 if never
    armed)."""
    with _serving_lock:
        entry = _serving_armed.get(point)
        return entry["hits"] if entry else 0


def serving_chaos(point: str, tag: Optional[str] = None) -> None:
    """The batcher-side hook: fire ``point`` if armed, else no-op.

    ``tag`` identifies the call site; an arming with a tag fires only at
    the matching site. Programmatic arming is checked first, then
    ``AZOO_SERVING_CHAOS`` (with ``AZOO_SERVING_CHAOS_TIMES`` /
    ``AZOO_SERVING_CHAOS_SLEEP_S`` / ``AZOO_SERVING_CHAOS_TAG``), so
    subprocess drills need no code."""
    global _serving_env_hits
    with _serving_lock:
        entry = _serving_armed.get(point)
        if entry is not None:
            armed_tag = entry.get("tag")
            if armed_tag is not None and armed_tag != tag:
                return
            remaining = entry["remaining"]
            if remaining is not None:
                if remaining <= 0:
                    return
                entry["remaining"] = remaining - 1
            entry["hits"] += 1
            sleep_s = entry["sleep_s"]
        else:
            if os.environ.get("AZOO_SERVING_CHAOS") != point:
                return
            env_tag = os.environ.get("AZOO_SERVING_CHAOS_TAG")
            if env_tag is not None and env_tag != tag:
                return
            times = os.environ.get("AZOO_SERVING_CHAOS_TIMES")
            if times is not None:
                if _serving_env_hits >= int(times):
                    return
                _serving_env_hits += 1
            sleep_s = float(os.environ.get("AZOO_SERVING_CHAOS_SLEEP_S",
                                           "0.05"))
    if point in ("predict_raises", "canary_errors"):
        raise ChaosPredictError(f"chaos: injected predict failure "
                                f"({point})")
    if point in ("predict_slow", "canary_slow"):
        time.sleep(sleep_s)
        return
    if point == "flush_thread_dies":
        raise FlushThreadDeath("chaos: injected flush-thread death")


def active_point() -> Optional[str]:
    """The failure point armed via ``AZOO_FT_CHAOS`` (None = chaos off)."""
    point = os.environ.get("AZOO_FT_CHAOS")
    if point and point not in FAILURE_POINTS:
        raise ValueError(f"AZOO_FT_CHAOS={point!r} is not a failure point; "
                         f"known: {FAILURE_POINTS}")
    return point or None


def should_fail(point: str) -> bool:
    """True when this hit of ``point`` is the one that must die; counts
    hits of the armed point so ``AZOO_FT_CHAOS_SKIP=N`` lets N
    checkpoints commit before the kill."""
    global _hits
    if active_point() != point:
        return False
    _hits += 1
    return _hits > int(os.environ.get("AZOO_FT_CHAOS_SKIP", "0"))


def fail(point: str) -> None:
    """Die now, the way a preemption does: ``os._exit`` skips ``finally``
    blocks, flushes nothing and runs no atexit hooks."""
    try:
        os.write(2, f"[ft.chaos] killing process at '{point}'\n".encode())
    except OSError:  # pragma: no cover - best effort only
        pass
    os._exit(EXIT_CODE)


def maybe_fail(point: str) -> None:
    """``fail(point)`` iff this hit should (the call-site hook)."""
    if should_fail(point):
        fail(point)
