"""Preemption handling (port of ``analytics_zoo_tpu.ft.preemption``):
SIGTERM/SIGINT → save-then-exit.

Cloud reservations are routinely preempted; the scheduler sends SIGTERM
and gives the process a grace window. A signal handler must not touch
the device (it may interrupt arbitrary Python, including a native call
mid-dispatch) — so the handler here only FLAGS the request, and the
training loop acts on it at the next safe boundary: write a checkpoint,
wait for durability, raise :class:`PreemptedError`. The process restarts
under its supervisor and ``Estimator.train(..., auto_resume=True)``
continues from the committed checkpoint — the trajectory is bitwise the
one an uninterrupted run would have taken.

::

    handler = PreemptionHandler().install()
    est.set_preemption_handler(handler)
    try:
        est.train(fs, loss, end_trigger=MaxEpoch(90), auto_resume=True)
    except PreemptedError:
        sys.exit(0)   # clean exit: the checkpoint is already durable
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Iterable, Optional

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = ["PreemptedError", "PreemptionHandler"]


class PreemptedError(RuntimeError):
    """Raised by ``Estimator.train`` after the save-then-exit checkpoint
    of a flagged preemption is durably committed."""

    def __init__(self, message: str, checkpoint_path: Optional[str] = None):
        super().__init__(message)
        self.checkpoint_path = checkpoint_path


class PreemptionHandler:
    """Installable SIGTERM/SIGINT flag. Signal-safe by construction: the
    handler body sets a ``threading.Event`` and returns — all real work
    (device sync, serialization, I/O) happens later on the training
    thread. A second signal while flagged falls through to the previously
    installed handler (so a double Ctrl-C still kills a hung run)."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,
                                                 signal.SIGINT)):
        self.signals = tuple(signals)
        self._flag = threading.Event()
        self._previous = {}
        self._installed = False
        self._listeners = []

    @property
    def requested(self) -> bool:
        """True once a preemption signal arrived."""
        return self._flag.is_set()

    def request(self) -> None:
        """Flag a preemption programmatically (tests, custom schedulers)."""
        self._flag.set()
        self._notify()

    def add_listener(self, callback) -> "PreemptionHandler":
        """Register a zero-arg callback fired once when the preemption flag
        is first set (immediately if it already is). Listeners must be
        signal-safe-ish: keep them tiny and non-blocking."""
        self._listeners.append(callback)
        if self._flag.is_set():
            self._safe_call(callback)
        return self

    def _notify(self) -> None:
        for cb in self._listeners:
            self._safe_call(cb)

    @staticmethod
    def _safe_call(cb) -> None:
        try:
            cb()
        except Exception:  # noqa: BLE001 - a listener never masks the flag
            logger.exception("preemption listener failed")

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until a preemption is flagged (or ``timeout`` seconds
        pass); returns :attr:`requested`. Lets a waiter thread react to
        the signal without polling."""
        return self._flag.wait(timeout)

    def clear(self) -> None:
        """Reset the flag (after a handled preemption in a long-lived
        process)."""
        self._flag.clear()

    def install(self) -> "PreemptionHandler":
        """Install the signal hooks (main thread only — a Python
        constraint on ``signal.signal``). Idempotent."""
        if self._installed:
            return self
        for sig in self.signals:
            self._previous[sig] = signal.signal(sig, self._on_signal)
        self._installed = True
        return self

    def uninstall(self) -> None:
        """Restore the previously installed handlers."""
        if not self._installed:
            return
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
        self._installed = False

    def _on_signal(self, signum, frame) -> None:
        if self._flag.is_set():
            # second signal: escalate to whatever was installed before us
            prev = self._previous.get(signum)
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:  # pragma: no cover - re-raise path
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)
            return
        logger.warning("signal %d received: preemption flagged — will "
                       "checkpoint and exit at the next step boundary",
                       signum)
        self._flag.set()
        self._notify()

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False
