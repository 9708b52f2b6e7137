"""Fault injection for the checkpoint commit protocol (port of
``analytics_zoo_tpu.ft.chaos``, its checkpoint failure points).

The commit protocol of :mod:`analytics_zoo_tpu_torch.ft.atomic` has named
failure points where an environment variable makes the process die hard
(``os._exit``: no ``finally`` blocks, no atexit, as a preemption or an
out-of-memory kill does). A kill test dies at each one and checks that
``auto_resume`` reproduces the uninterrupted run bitwise.

- ``AZOO_FT_CHAOS``: the failure point to trigger (:data:`FAILURE_POINTS`).
- ``AZOO_FT_CHAOS_SKIP``: optional int: survive that many hits of the
  point first (kill at the N+1th checkpoint, not the first).

With the variable unset every hook is an environment lookup and a compare.
The JAX package's serving, batch, distributed, front-door, flywheel, fleet
and pipeline points belong to tiers the port does not have yet.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["FAILURE_POINTS", "EXIT_CODE", "active_point", "should_fail",
           "fail", "maybe_fail", "reset"]

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

_hits = 0


def reset() -> None:
    """Zero the hit counter (test isolation)."""
    global _hits
    _hits = 0


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
