"""Serving hot reload (port of ``analytics_zoo_tpu.ft.hot_reload``):
training output flows into serving with no downtime.

The contract is the commit protocol (:mod:`analytics_zoo_tpu_torch.ft
.atomic`): a checkpoint directory is visible if and only if it is
committed, so a watcher can poll a training run's checkpoint directory
and register every new committed step as a new model version in the
:class:`~analytics_zoo_tpu_torch.serving.engine.ServingEngine`. In-flight
requests keep draining through the old version's batcher; new requests
route to the new version the moment ``register`` returns (warm-up
included), and a torn or in-progress checkpoint is never loaded because
it is never visible.

On the card ``register`` captures the new version's CUDA graphs (one per
bucket) while the old version's graphs keep replaying on other threads:
each model has its own graph pool, side stream and replay lock, and a
capture runs under ``capture_error_mode="thread_local"``, so another
thread's replay neither joins nor invalidates it.

::

    watcher = engine.watch_checkpoints(
        "ncf", ckpt_dir, build_model=lambda path: load_ncf(path),
        example_input=example, poll_interval_s=2.0)
    ...
    watcher.stop()
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Optional

from analytics_zoo_tpu_torch.common.observability import hot_reload_metrics
from analytics_zoo_tpu_torch.ft import atomic

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = ["CheckpointWatcher"]


class CheckpointWatcher:
    """Poll ``directory`` for new committed checkpoints; register each as
    model version ``str(step)`` under ``name`` in ``engine``.

    ``build_model(path)`` maps a committed checkpoint directory to a
    servable model (anything with a batched ``do_predict``). Numeric
    versions mean the engine's "latest" routing follows the training
    step. ``keep_versions`` bounds the registry: older versions are
    unregistered (draining their queued requests first) once newer ones
    are live. A ``build_model``/``register`` failure is logged and the
    watcher keeps serving the previous version — a bad checkpoint must
    not take down traffic.

    Failures are triaged: a *transient* error (any ``OSError`` — NFS
    blips, files still landing on shared storage) is retried with
    exponential backoff (``retry_backoff_s`` doubling per attempt) up to
    ``max_retries`` times before the step is skipped; a *structural*
    failure (wrong shapes, corrupt payload — anything else) skips the
    step immediately and forever, since retrying a deterministic failure
    would just hot-loop the poller. Counted in
    ``zoo_hot_reload_retries_total`` / ``zoo_hot_reload_skips_total``.

    ``clock`` (default ``time.monotonic``) is the watcher's time source
    for retry backoff — tests inject a fake clock so backoff expiry is
    driven deterministically instead of with real sleeps.

    ``aot_cache_dir`` other than ``None`` raises ``NotImplementedError``:
    the persistent executable cache is not ported.

    With the engine's rollout control plane active, a reloaded
    version enters the canary ladder instead of instantly repointing
    "latest" — that is ``ServingEngine.register``'s behavior, nothing
    here changes — and trimming asks the engine which versions are
    *protected* (latest, rollout canary/incumbent, policy members,
    shadows) so retention can never retire a version the control plane
    still routes to.
    """

    def __init__(self, engine, name: str, directory: str,
                 build_model: Callable[[str], Any], example_input,
                 config=None, poll_interval_s: float = 1.0,
                 keep_versions: int = 2, prefix: str = "ckpt",
                 max_retries: int = 3, retry_backoff_s: float = 0.5,
                 aot_cache_dir: Optional[str] = None,
                 clock: Optional[Callable[[], float]] = None):
        if aot_cache_dir is not None:
            raise NotImplementedError(
                "aot_cache_dir: the persistent executable cache is not "
                "ported (ROADMAP A4): a CUDA graph cannot be saved, so "
                "every reloaded version captures its graphs at register")
        if keep_versions < 1:
            raise ValueError(
                f"keep_versions must be >= 1, got {keep_versions}")
        self.engine = engine
        self.name = name
        self.directory = directory
        self.build_model = build_model
        self.example_input = example_input
        self.config = config
        self.poll_interval_s = float(poll_interval_s)
        self.keep_versions = int(keep_versions)
        self.prefix = prefix
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.clock = clock or time.monotonic
        self.last_step: Optional[int] = None
        self.reloads = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._metrics = hot_reload_metrics()
        # transient-failure retry state for the step being backed off
        self._retry_step: Optional[int] = None
        self._retry_attempts = 0
        self._retry_at = 0.0

    def start(self, register_existing: bool = True) -> "CheckpointWatcher":
        """Start polling. ``register_existing=True`` registers the newest
        already-committed checkpoint synchronously before the thread
        starts, so a restarted server is immediately serviceable."""
        if register_existing:
            self.poll_once()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"azoo-ckpt-watch-{self.name}")
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the polling thread (registered versions stay live)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def poll_once(self) -> Optional[int]:
        """One poll: register the newest committed step if it is new.
        Returns the newly registered step, or None (nothing new, still
        backing off a transient failure, or the step was skipped)."""
        committed = atomic.committed_checkpoints(self.directory, self.prefix)
        if not committed:
            return None
        step, path = committed[-1]
        if self.last_step is not None and step <= self.last_step:
            return None
        now = self.clock()
        if self._retry_step == step and now < self._retry_at:
            return None  # backing off this step's transient failure
        try:
            model = self.build_model(path)
            self.engine.register(self.name, model, self.example_input,
                                 config=self.config, version=str(step))
        except OSError as e:
            # transient (NFS blip, file still landing on shared storage):
            # retry with exponential backoff before giving up on the step
            attempts = (self._retry_attempts + 1
                        if self._retry_step == step else 1)
            if attempts <= self.max_retries:
                self._retry_step = step
                self._retry_attempts = attempts
                backoff = self.retry_backoff_s * 2 ** (attempts - 1)
                self._retry_at = now + backoff
                self._metrics["retries"].inc()
                logger.warning(
                    "hot-reload of %s step %d hit a transient error (%s); "
                    "retry %d/%d in %.2fs", self.name, step, e, attempts,
                    self.max_retries, backoff)
                return None
            self._skip(step, f"retries exhausted ({self.max_retries})")
            return None
        except Exception:  # noqa: BLE001 — keep serving the old version
            # structural (bad shapes, corrupt payload): retrying a
            # deterministic failure would hot-loop the poller — skip the
            # step immediately and forever, wait for the next one
            self._skip(step, "structural failure")
            return None
        self._retry_step = None
        self._retry_attempts = 0
        self.last_step = step
        self.reloads += 1
        logger.info("hot-reloaded model '%s' version %d from %s",
                    self.name, step, path)
        self._trim_versions()
        return step

    def rewind(self, step: Optional[int]) -> None:
        """Lower the registration high-water mark to ``step`` (None =
        back to "nothing registered"). A rolled-back candidate's
        checkpoints are deleted, and the next retrain cycle can
        legitimately re-mint the *same* step number — without the
        rewind, :meth:`poll_once` would silently refuse the re-minted
        step as "not newer", leaving the caller staring at the dead
        rollout's terminal record. Any retry backoff state belongs to
        the abandoned step and is dropped with it."""
        self.last_step = step
        self._retry_step = None
        self._retry_attempts = 0

    def _skip(self, step: int, why: str) -> None:
        logger.exception(
            "hot-reload of %s step %d failed (%s); skipping this step — "
            "still serving version %s", self.name, step, why,
            self.last_step)
        self._metrics["skips"].inc()
        self.last_step = step
        self._retry_step = None
        self._retry_attempts = 0

    def _trim_versions(self) -> None:
        try:
            entry_map = self.engine.stats().get(self.name, {})
            versions = sorted((int(v) for v in entry_map.get("versions", {})
                               if str(v).isdigit()))
            # the control plane still routes to protected versions
            # (latest, an active rollout's canary/incumbent, policy
            # members, shadows) — retention must leave them alone even
            # when they fall outside the keep window
            protected = set(getattr(self.engine, "protected_versions",
                                    lambda _name: ())(self.name))
        except Exception:  # noqa: BLE001 — trimming is best-effort
            return
        for v in versions[:-self.keep_versions]:
            if str(v) in protected:
                continue
            try:
                self.engine.unregister(self.name, str(v), drain=True)
                logger.info("hot-reload retired model '%s' version %d",
                            self.name, v)
            except Exception:  # noqa: BLE001
                logger.exception("failed to retire %s version %d",
                                 self.name, v)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the watcher must survive
                logger.exception("checkpoint watcher poll failed")
