"""ServingEngine (port of ``analytics_zoo_tpu.serving.engine``) — named,
versioned models behind dynamic batchers.

The in-process analogue of the reference's Cluster Serving manager: where
that system wires Redis streams into a Flink job feeding ``InferenceModel``
replicas, here the registry maps ``(name, version)`` to one
:class:`~analytics_zoo_tpu_torch.inference.inference_model.InferenceModel`
(its per-bucket executables take concurrent callers — no replica pool)
fronted by one :class:`~analytics_zoo_tpu_torch.serving.batcher.DynamicBatcher`.
Registration warms every bucket shape in the ladder via ``do_optimize``
(on the card: one CUDA graph captured per bucket), so after ``register``
returns, steady-state traffic never compiles — asserted via the model's
``cache_stats`` counters.

Keep orchestration in plain host code around fixed-shape device work: the
engine owns threads, queues and deadlines; the device only ever sees
fixed-shape batches.

Generation: ``register(sequence=SequenceConfig(...))`` adds a
:class:`~analytics_zoo_tpu_torch.serving.sequence.ContinuousBatcher` to the
version and warms its whole program grid (on the card, one CUDA graph per
prefill cell, admission width and the decode step);
:meth:`ServingEngine.generate` and :meth:`ServingEngine.generate_async`
serve it.

Hot reload: :meth:`ServingEngine.watch_checkpoints` registers every
committed checkpoint of a training run as a new version
(:class:`~analytics_zoo_tpu_torch.ft.hot_reload.CheckpointWatcher`).

Not ported yet, and raising ``NotImplementedError`` that names the
ROADMAP item: ``register(sharding_plan=..., stage_plan=...)`` (A7).

Resilience is on by default: a
:class:`~analytics_zoo_tpu_torch.serving.resilience.ResilienceConfig` gives
every registered model deadline-aware admission control and a circuit
breaker, a shared :class:`~analytics_zoo_tpu_torch.serving.resilience
.FlushWatchdog` supervises every batcher's flush thread, and
:meth:`ServingEngine.drain` implements the graceful out-of-rotation
lifecycle (``serving`` → ``draining`` → ``drained``) that
:func:`~analytics_zoo_tpu_torch.serving.resilience.install_drain_on_preemption`
ties to SIGTERM. Individual pieces are switched off through the config's
flags (``ResilienceConfig(admission=False, breaker=None, ...)``); see
docs/resilience.md.

The deployment control plane sits between ``predict`` and the
batchers: every engine owns a
:class:`~analytics_zoo_tpu_torch.serving.router.Router` (weighted version
routing + shadow sampling; with no policy installed, routing is the
pre-existing ``_latest`` dispatch) and a
:class:`~analytics_zoo_tpu_torch.serving.quota.QuotaManager` (per-tenant token
buckets, checked before admission control; unconfigured = admit all).
Constructing the engine with a
:class:`~analytics_zoo_tpu_torch.serving.rollout.RolloutConfig` turns every
``register`` of a new version *while an incumbent is serving* into a
staged canary instead of an instant ``_latest`` repoint — the
:class:`~analytics_zoo_tpu_torch.serving.rollout.RolloutController` walks the
ladder on live health and either finalizes (repoint + retire incumbent,
what hot-reload's repoint used to do unconditionally) or rolls back.
See docs/rollouts.md.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, List, Optional, Union

import numpy as np

from analytics_zoo_tpu_torch.common.flight_recorder import get_flight_recorder
from analytics_zoo_tpu_torch.common.observability import (
    build_info,
    get_tracer,
    monotonic_s,
    new_trace_id,
)
from analytics_zoo_tpu_torch.common.profiling import timing
from analytics_zoo_tpu_torch.common.slo import SLOEngine, SLOObjective
from analytics_zoo_tpu_torch.serving.batcher import (
    BatcherConfig,
    DeadlineExceededError,
    DynamicBatcher,
    InputSignature,
    QueueFullError,
)
from analytics_zoo_tpu_torch.serving.metrics import ServingMetrics
from analytics_zoo_tpu_torch.serving.quota import (
    QuotaConfig,
    QuotaExceededError,
    QuotaManager,
    TenantQuota,
)
from analytics_zoo_tpu_torch.serving.result_cache import (
    ResultCache,
    ResultCacheConfig,
    tree_cow_view,
)
from analytics_zoo_tpu_torch.serving.resilience import (
    AdmissionController,
    CircuitBreaker,
    CircuitOpenError,
    DrainingError,
    FlushWatchdog,
    ResilienceConfig,
    ShedError,
)
from analytics_zoo_tpu_torch.serving.rollout import (
    ROLLBACK_REASONS,
    RolloutConfig,
    RolloutController,
    VersionHealth,
)
from analytics_zoo_tpu_torch.serving.router import Router

__all__ = ["ServingEngine", "ModelEntry", "ModelNotFoundError"]


class ModelNotFoundError(KeyError):
    """Unknown model name or version in the registry — the only KeyError
    the HTTP layer maps to 404. A KeyError raised inside a model's predict
    path stays a 500 (it is a server fault, not a routing miss)."""


def _version_key(v: str):
    # numeric version strings compare numerically ('10' > '9'); anything
    # non-numeric falls back to string order above the numerics
    try:
        return (0, int(v), "")
    except ValueError:
        return (1, 0, v)


class ModelEntry:
    """One registered ``(name, version)``: the model, its batcher, and its
    warmup record."""

    def __init__(self, name: str, version: str, model, config: BatcherConfig,
                 batcher: DynamicBatcher):
        self.name = name
        self.version = version
        self.model = model
        self.config = config
        self.batcher = batcher
        # set when the model is registered with sequence=SequenceConfig:
        # the continuous batcher that serves :generate
        self.seq_batcher = None
        self.warmup_seconds = 0.0
        self.registered_at = time.time()
        # set by the engine when resilience is on
        self.admission = None           # AdmissionController or None
        self.breaker = None             # CircuitBreaker or None
        # sliding window of routed-request outcomes — the rollout
        # controller's promotion/rollback signal (the engine sizes it
        # from its RolloutConfig when one is set)
        self.health = VersionHealth()

    def info(self) -> Dict[str, Any]:
        """JSON-friendly summary (``/healthz`` body)."""
        out = {
            "version": self.version,
            "max_batch_size": self.config.max_batch_size,
            "max_wait_ms": self.config.max_wait_ms,
            "buckets": list(self.config.ladder()),
            "queue_depth": self.batcher.queue_depth,
            "warmup_seconds": round(self.warmup_seconds, 4),
        }
        sig = self.batcher.signature
        if sig is not None:
            # what a sequence client needs to pick prompt lengths
            # without trial 400s: fixed dims, wildcard axes (null) and
            # dtypes, exactly as validate() will enforce them
            out["input_signature"] = {
                "inputs": [{"shape": [None if d is None else int(d)
                                      for d in shape],
                            "dtype": np.dtype(dtype).name}
                           for shape, dtype in sig.specs],
                "multi": sig.multi,
            }
        seq = self.seq_batcher
        if seq is not None:
            scfg = seq.config
            out["sequence"] = {
                "slots": scfg.slots,
                "max_prompt_len": scfg.max_prompt_len,
                "max_new_tokens": scfg.max_new_tokens,
                "start_token": scfg.start_token,
                "eos_token": scfg.eos_token,
                "prompt_buckets": list(scfg.length_ladder()),
                "prefill_batch_buckets": list(scfg.batch_ladder()),
                "queue_depth": seq.queue_depth,
            }
        cache = getattr(self.model, "cache_stats", None)
        if cache is not None:
            out["executable_cache"] = dict(cache)
        return out


def _example_rows(example_input) -> List[np.ndarray]:
    xs = (list(example_input)
          if isinstance(example_input, (list, tuple)) else [example_input])
    xs = [np.asarray(a) for a in xs]
    if any(a.ndim < 1 or a.shape[0] < 1 for a in xs):
        raise ValueError("example_input must be a representative batch "
                         "(leading axis = batch, at least one row)")
    return xs


class ServingEngine:
    """In-process online serving: register models, predict through the
    batcher, observe through Prometheus-style metrics.

    ::

        engine = ServingEngine()
        engine.register("ncf", inference_model, example_input=batch,
                        config=BatcherConfig(max_batch_size=128,
                                             buckets=(1, 8, 32, 128)))
        y = engine.predict("ncf", x)            # blocking
        fut = engine.predict_async("ncf", x)    # Future

    Any object with a batched ``do_predict`` duck-types as a model;
    ``do_optimize``/``cache_stats`` are used when present (warmup,
    metrics). Versions are strings; omitted versions auto-increment
    ("1", "2", …) and ``predict`` without a version routes to the newest.
    """

    def __init__(self, metrics: Optional[ServingMetrics] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 quota: Optional[QuotaConfig] = None,
                 rollout: Optional[RolloutConfig] = None,
                 result_cache: Optional[Union[ResultCache,
                                              ResultCacheConfig]] = None,
                 slo: Optional[SLOEngine] = None,
                 slo_latency_threshold_s: Optional[float] = None):
        self.metrics = metrics or ServingMetrics()
        self.resilience = resilience or ResilienceConfig()
        # ops plane: the process-global flight recorder backs
        # every request's compact lifecycle record, and the SLO engine
        # (per-engine registry, so its gauges ride this engine's scrape)
        # gets a per-model availability objective at 99.9% on first
        # traffic, plus a latency objective at 99% under
        # ``slo_latency_threshold_s`` when one is set. Pass a prebuilt
        # SLOEngine to inject a clock (tests) or custom objectives.
        self.flight = get_flight_recorder()
        self.slo = slo if slo is not None else SLOEngine(
            registry=self.metrics.registry)
        self._slo_latency_threshold_s = slo_latency_threshold_s
        self._slo_models: set = set()
        build_info()
        self._models: Dict[str, Dict[str, ModelEntry]] = {}
        self._latest: Dict[str, str] = {}
        # per-name high-water mark of numeric versions: auto-versioning
        # never reuses a number, even after an unregister freed it
        self._version_hwm: Dict[str, int] = {}
        self._watchers: List[Any] = []
        self._lock = threading.Lock()
        self._state = "serving"         # -> "draining" -> "drained"
        self._watchdog = (
            FlushWatchdog(self.resilience.watchdog_interval_s,
                          self.resilience.watchdog_stall_s)
            if self.resilience.watchdog else None)
        # control plane: router + quota always exist (both no-ops until
        # configured); the rollout controller exists when a RolloutConfig
        # was given — only then does register() start canaries instead of
        # repointing _latest (full backward compatibility otherwise)
        self.router = Router()
        self.quota = QuotaManager(quota)
        self._rollout_cfg = rollout
        self._auto_rollout = rollout is not None
        self._rollout: Optional[RolloutController] = (
            RolloutController(self, rollout) if rollout is not None
            else None)
        # content-addressed result cache — opt-in: pass a
        # ResultCacheConfig (or a prebuilt ResultCache) to serve repeats
        # of (name, routed version, input bytes) without a device
        # execution. None (the default) keeps the pre-existing submit
        # path untouched. Hits still pay quota and still count toward
        # rollout health windows; see docs/result-cache.md.
        self.result_cache: Optional[ResultCache] = (
            result_cache if isinstance(result_cache, (ResultCache,
                                                      type(None)))
            else ResultCache(result_cache))
        # flywheel capture tap — opt-in via set_capture().
        # Hooked on the real-submit path only: cache hits, coalesced
        # followers and shadow mirrors never reach it, so a request is
        # sampled at most once and mirrors are never double-captured.
        self._capture = None
        # outcome plane — opt-in via set_label_store() /
        # set_drift(): ground-truth label ingestion and prediction-
        # distribution drift tracking for the rollout's drift gates.
        self._labels = None
        self._drift = None

    # -- registry ---------------------------------------------------------

    def register(self, name: str, model, example_input,
                 config: Optional[BatcherConfig] = None,
                 version: Optional[str] = None,
                 warmup: bool = True,
                 shadow: bool = False,
                 shadow_fraction: float = 0.01,
                 sharding_plan=None,
                 stage_plan=None,
                 sequence=None) -> ModelEntry:
        """Register ``model`` under ``name`` (and ``version``), warming one
        executable per bucket size (on the card, a captured CUDA graph) so
        no request ever pays a compile.

        ``example_input``: a representative batch (array or list of arrays,
        leading axis = batch; any row count ≥ 1) — rows beyond the first
        are ignored, only shape[1:]/dtype matter. It doubles as the
        model's :class:`~analytics_zoo_tpu_torch.serving.batcher.InputSignature`:
        every submitted request must match its arity and trailing shapes
        (400 over HTTP otherwise), and numeric dtypes are coerced to it so
        traffic keeps hitting the warmed bucket executables.
        ``warmup=False`` skips the warm-up (the first request of each
        bucket then captures its executable inline).

        Auto-assigned versions ("1", "2", …) count up monotonically per
        name and never reuse a number freed by ``unregister``.

        ``shadow=True`` registers the version as a shadow: it never
        becomes ``_latest`` and takes no primary traffic — instead
        ``shadow_fraction`` of the model's version-less requests are
        duplicated into its batcher (responses discarded, outcomes in
        ``zoo_serving_shadow_*`` metrics only).

        When the engine has a
        :class:`~analytics_zoo_tpu_torch.serving.rollout.RolloutConfig` and an
        incumbent version is already serving, a non-shadow register does
        NOT repoint ``_latest``; the new version starts a canary rollout
        at the ladder's first rung instead (finalization repoints).

        ``sequence``: a
        :class:`~analytics_zoo_tpu_torch.serving.sequence.SequenceConfig`
        to also serve autoregressive generation for this model through a
        :class:`~analytics_zoo_tpu_torch.serving.sequence.ContinuousBatcher`
        (the ``:generate`` HTTP endpoint / :meth:`generate`). The model
        must expose the sequence primitives (``seq_prefill`` /
        ``seq_step`` — see models/seq2seq.py); warmup then also builds
        the whole (batch × length) prefill grid plus the decode-step and
        admission programs, so generation never builds one at serve
        time.

        ``sharding_plan`` and ``stage_plan`` are not ported yet: passing
        one raises ``NotImplementedError`` (ROADMAP A7) before anything is
        touched.
        """
        if sharding_plan is not None or stage_plan is not None:
            raise NotImplementedError(
                "sharding and stage plans are not ported yet (ROADMAP A7)")
        cfg = config or BatcherConfig()
        rows = _example_rows(example_input)
        multi = isinstance(example_input, (list, tuple))
        entry_t0 = time.perf_counter()
        if warmup and hasattr(model, "do_optimize"):
            from analytics_zoo_tpu_torch.common.observability import get_tracer

            with timing(f"serving warmup '{name}' buckets={cfg.ladder()}",
                        log=True), \
                    get_tracer().span("serving.warmup", model=name,
                                      buckets=str(cfg.ladder())):
                for b in cfg.ladder():
                    ex = [np.zeros((b,) + a.shape[1:], a.dtype)
                          for a in rows]
                    model.do_optimize(ex if multi else ex[0])
        signature = InputSignature([(a.shape[1:], a.dtype) for a in rows],
                                   multi)
        with self._lock:
            versions = self._models.setdefault(name, {})
            if version is None:
                version = str(self._version_hwm.get(name, 0) + 1)
            if version in versions:
                raise ValueError(
                    f"model '{name}' version '{version}' already registered")
            if version.isdigit():
                self._version_hwm[name] = max(
                    self._version_hwm.get(name, 0), int(version))
            res = self.resilience
            model_metrics = self.metrics.for_model(name)
            admission = (AdmissionController(res.ewma_alpha)
                         if res.admission else None)
            breaker = (CircuitBreaker(res.breaker,
                                      name=f"{name}@{version}",
                                      metrics=model_metrics,
                                      listener=self._on_breaker_transition)
                       if res.breaker is not None else None)
            # the split dispatch/fetch pair (when the model offers it —
            # InferenceModel does) lets the batcher's pipelined flush
            # overlap host assembly with device compute; duck-typed
            # models without it run blocking predicts in the dispatch
            # stage and still overlap result scatter
            batcher = DynamicBatcher(
                model.do_predict, cfg,
                metrics=model_metrics, name=name,
                signature=signature, admission=admission, breaker=breaker,
                dispatch_fn=getattr(model, "do_dispatch", None),
                fetch_fn=getattr(model, "do_fetch", None),
                chaos_tag=f"{name}@{version}")
            seq_batcher = None
            if sequence is not None:
                from analytics_zoo_tpu_torch.serving.sequence import (
                    ContinuousBatcher,
                )

                # built before the registry insert, so that a model
                # without the decode contract (TypeError here) leaves the
                # engine untouched; it shares the predict path's breaker
                try:
                    seq_batcher = ContinuousBatcher(
                        model, sequence, metrics=model_metrics, name=name,
                        breaker=breaker, chaos_tag=f"{name}@{version}")
                except BaseException:
                    batcher.stop(drain=False, timeout=5.0)
                    if not versions:  # setdefault above made it
                        self._models.pop(name, None)
                    raise
            entry = ModelEntry(name, version, model, cfg, batcher)
            entry.seq_batcher = seq_batcher
            entry.admission = admission
            entry.breaker = breaker
            entry.warmup_seconds = time.perf_counter() - entry_t0
            if self._rollout_cfg is not None:
                entry.health = VersionHealth(self._rollout_cfg.window_s,
                                             self._rollout_cfg.window_max)
            prev_latest = self._latest.get(name)
            # a new version canaries (instead of instantly repointing
            # _latest) only when rollouts are on AND an incumbent is
            # already serving; shadows never touch _latest at all
            start_canary = (not shadow and self._auto_rollout
                            and prev_latest is not None
                            and prev_latest in versions)
            versions[version] = entry
            if not shadow and not start_canary:
                self._latest[name] = version
            if self._drift is not None:
                reset = getattr(self._drift, "reset", None)
                if reset is not None and start_canary:
                    # the drift gate compares canary vs incumbent "over
                    # the same live traffic" — that only holds if both
                    # sketches START at the rollout. The incumbent's
                    # cumulative pre-rollout history (possibly a
                    # different traffic mix) must not be what the canary
                    # is judged against.
                    reset(name)
                elif reset is not None:
                    # a version id can recur (a rolled-back candidate's
                    # checkpoints are deleted and the next retrain cycle
                    # can re-reach the same step) — the dead model's
                    # sketch must not judge the new one
                    reset(name, version)
        if seq_batcher is not None and warmup:
            try:
                with timing(f"sequence warmup '{name}' "
                            f"grid={sequence.grid()}", log=True), \
                        get_tracer().span("serving.warmup", model=name,
                                          grid=str(sequence.grid())):
                    seq_batcher.warmup()
            except BaseException:
                # a failed sequence warmup (a capture that raised) must not
                # leave a half-registered version serving predict traffic
                seq_batcher.stop(drain=False, timeout=5.0)
                batcher.stop(drain=False, timeout=5.0)
                with self._lock:
                    live = self._models.get(name)
                    if live is not None:
                        live.pop(version, None)
                        if not live:
                            self._models.pop(name, None)
                            self._latest.pop(name, None)
                        elif self._latest.get(name) == version:
                            self._latest[name] = max(live,
                                                     key=_version_key)
                raise
            entry.warmup_seconds = time.perf_counter() - entry_t0
        if self._watchdog is not None:
            self._watchdog.watch(batcher)
            if seq_batcher is not None:
                self._watchdog.watch(seq_batcher)
        if shadow:
            self.router.set_shadow(name, version, shadow_fraction)
        elif start_canary:
            self.rollout_controller().begin(name, canary=version,
                                            incumbent=prev_latest)
        return entry

    def unregister(self, name: str, version: Optional[str] = None,
                   drain: bool = True):
        """Remove one version (or every version when ``version`` is None),
        stopping its batcher (``drain=True`` serves queued requests
        first)."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise ModelNotFoundError(f"no model '{name}' registered")
            doomed = (list(versions.values()) if version is None
                      else [versions.pop(version)]
                      if version in versions else None)
            if doomed is None:
                raise ModelNotFoundError(
                    f"no version '{version}' of model '{name}'")
            if version is None:
                versions.clear()
            model_gone = not versions
            if model_gone:
                self._models.pop(name, None)
                self._latest.pop(name, None)
                self._version_hwm.pop(name, None)
            elif self._latest.get(name) not in versions:
                self._latest[name] = max(versions, key=_version_key)
        if model_gone:
            self.router.clear_model(name)
        else:
            # a removed version must stop receiving shadow mirrors; a
            # policy still naming it is harmless (predict falls back to
            # latest on the resulting registry miss)
            for entry in doomed:
                self.router.clear_shadow(name, entry.version)
        # invalidation rides the control plane: every retirement path —
        # hot-reload trim, rollout rollback (_retire_canary), rollout
        # finalize (_finalize_rollout), manual unregister — funnels
        # through here, so dropping the version's keys here guarantees
        # no stale hit can outlive a repoint
        if self.result_cache is not None:
            for entry in doomed:
                self.result_cache.invalidate_version(name, entry.version)
        for entry in doomed:
            if self._watchdog is not None:
                self._watchdog.unwatch(entry.batcher)
                if entry.seq_batcher is not None:
                    self._watchdog.unwatch(entry.seq_batcher)
            entry.batcher.stop(drain=drain)
            if entry.seq_batcher is not None:
                entry.seq_batcher.stop(drain=drain)

    def entry(self, name: str, version: Optional[str] = None) -> ModelEntry:
        """Resolve ``(name, version)``; ``version=None`` → newest. Raises
        :class:`ModelNotFoundError` (a ``KeyError`` subclass) for unknown
        names/versions — the 404 the HTTP layer keys on."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise ModelNotFoundError(f"no model '{name}' registered")
            v = version or self._latest[name]
            if v not in versions:
                raise ModelNotFoundError(
                    f"no version '{v}' of model '{name}'")
            return versions[v]

    def model_names(self) -> List[str]:
        """Registered model names, sorted."""
        with self._lock:
            return sorted(self._models)

    def watch_checkpoints(self, name: str, directory: str, build_model,
                          example_input, config: Optional[BatcherConfig] = None,
                          poll_interval_s: float = 1.0,
                          keep_versions: int = 2,
                          register_existing: bool = True,
                          max_retries: int = 3,
                          retry_backoff_s: float = 0.5,
                          aot_cache_dir: Optional[str] = None):
        """Hot reload: watch a training run's checkpoint ``directory`` and
        register every new committed checkpoint as model version
        ``str(step)`` under ``name``, so training output flows into
        serving without downtime (``predict`` without a version routes to
        the newest, or with a rollout configured the new version enters
        the canary ladder). ``build_model(ckpt_dir)`` maps a committed
        checkpoint directory to a servable model (a batched
        ``do_predict``); versions beyond ``keep_versions`` are retired
        (draining first), except those the control plane still routes to.
        Returns the started
        :class:`~analytics_zoo_tpu_torch.ft.hot_reload.CheckpointWatcher`
        (``.stop()`` stops watching; ``shutdown`` stops it too).

        The atomic commit protocol is what makes this safe: a checkpoint
        directory is visible if and only if its COMMIT marker landed, so
        the watcher never loads a torn or in-progress save.
        ``aot_cache_dir`` other than ``None`` raises
        ``NotImplementedError``: the persistent executable cache is not
        ported."""
        from analytics_zoo_tpu_torch.ft.hot_reload import CheckpointWatcher

        watcher = CheckpointWatcher(
            self, name, directory, build_model, example_input,
            config=config, poll_interval_s=poll_interval_s,
            keep_versions=keep_versions, max_retries=max_retries,
            retry_backoff_s=retry_backoff_s, aot_cache_dir=aot_cache_dir)
        watcher.start(register_existing=register_existing)
        with self._lock:
            self._watchers.append(watcher)
        return watcher

    def set_capture(self, tap) -> None:
        """Attach (or with ``None`` detach) a flywheel
        :class:`~analytics_zoo_tpu_torch.flywheel.capture.CaptureTap`. The tap
        samples the real-submit path only — cache hits, coalesced
        followers and shadow mirrors are structurally invisible to it —
        and costs an unsampled request one dict lookup. Per-model
        sampling is the tap's own ``enable``/``disable``; the tap's
        lifecycle (``close``) stays with its owner."""
        self._capture = tap

    def set_label_store(self, store) -> None:
        """Attach (or with ``None`` detach) an outcome-plane
        :class:`~analytics_zoo_tpu_torch.flywheel.labels.LabelStore`. With a
        store attached, ``POST /v1/models/<name>:outcome`` records land
        in the model's label segments and ``GET /v1/models/<name>``
        grows an ``outcome`` status block. Lifecycle (``close``) stays
        with the owner."""
        self._labels = store

    def set_drift(self, tracker) -> None:
        """Attach (or with ``None`` detach) a
        :class:`~analytics_zoo_tpu_torch.flywheel.drift.PredictionTracker`.
        Every successful prediction folds into the serving version's
        distribution sketch, which is what the rollout ladder's drift
        gate (``RolloutConfig.drift_gates``) compares canary-vs-
        incumbent on."""
        self._drift = tracker

    # -- outcome plane -----------------------------------------------------

    def ingest_outcomes(self, name: str,
                        records: List[Dict]) -> Dict[str, Any]:
        """Record ground-truth outcome labels for ``name`` (the ``POST
        /v1/models/<name>:outcome`` body — one record or a batch of
        ``{trace_id, label, ts}``). Requires an attached label store
        (404 otherwise: this worker has no outcome plane) and a
        registered model — labels for models this engine does not serve
        are refused rather than silently spooled."""
        store = self._labels
        if store is None:
            raise ModelNotFoundError(
                f"no outcome plane on this worker — cannot record "
                f"labels for model '{name}'")
        with self._lock:
            if name not in self._models:
                raise ModelNotFoundError(f"no model '{name}' registered")
        return store.ingest(name, records)

    def drift_scores(self, name: str, canary: str, incumbent: str,
                     min_count: int = 30) -> Optional[Dict[str, float]]:
        """The rollout drift gate's read path: Jensen–Shannon divergence
        between the canary's and incumbent's live prediction
        distributions, or None while either side holds fewer than
        ``min_count`` predictions (or no tracker is attached) — a gate
        must never fire on noise."""
        tracker = self._drift
        if tracker is None:
            return None
        js = tracker.js(name, canary, incumbent, min_count=min_count)
        return None if js is None else {"prediction_js": js}

    def outcome_status(self, name: str) -> Optional[Dict[str, Any]]:
        """The ``outcome`` block of ``GET /v1/models/<name>``: labels
        received, join lag, watermark and per-version drift sketch
        counts. None when no outcome plane is attached (the key stays
        present so operators can tell 'no plane' from 'no labels')."""
        store = self._labels
        tracker = self._drift
        if store is None and tracker is None:
            return None
        out: Dict[str, Any] = {}
        if store is None:
            out["labels"] = None
        else:
            try:
                out["labels"] = store.describe(name)
            except Exception as e:  # noqa: BLE001 — status must not 500
                out["labels"] = {"error": type(e).__name__}
        if tracker is not None:
            out["drift"] = {"predictions": tracker.describe(name)}
        return out

    def outcome_debug(self) -> Dict[str, Any]:
        """The ``GET /v1/debug/outcomes`` body: every registered
        model's outcome-plane status."""
        return {"models": {n: self.outcome_status(n)
                           for n in self.model_names()}}

    # -- predict ----------------------------------------------------------

    def predict_async(self, name: str, x,
                      timeout_ms: Optional[float] = None,
                      version: Optional[str] = None,
                      tenant: Optional[str] = None,
                      route_key: Optional[str] = None,
                      bypass_cache: bool = False,
                      trace_id: Optional[str] = None) -> Future:
        """Submit through the model's batcher; returns the request Future
        (resolves to exactly what direct ``do_predict(x)`` would return).
        While the engine is draining, raises
        :class:`~analytics_zoo_tpu_torch.serving.resilience.DrainingError`
        (HTTP 503 + ``Retry-After``) — already-accepted requests keep
        completing.

        Control plane: ``tenant`` (from ``X-Zoo-Tenant``) is
        checked against its token bucket *before* admission control —
        over quota raises
        :class:`~analytics_zoo_tpu_torch.serving.quota.QuotaExceededError`
        (HTTP 429 + ``Retry-After``). A version-less request is routed
        through the engine's
        :class:`~analytics_zoo_tpu_torch.serving.router.Router` when a traffic
        policy is installed (``route_key``, from ``X-Zoo-Route-Key``,
        pins a caller to one version); an explicit ``version`` always
        bypasses the policy. Shadow versions receive their sampled
        mirror of the request after the primary submit — mirror
        failures and sheds never surface here.

        Result cache (engines built with ``result_cache=``):
        after quota and routing, the request's
        ``(name, routed version, canonical input bytes)`` SHA-256 key is
        looked up *before* admission control — a hit costs no EWMA
        sample, no breaker sample and no batcher slot, but has already
        paid quota (cached traffic cannot starve tenants) and still
        records into the version's health window (hot-key traffic must
        not starve a canary of ``min_requests``). A miss becomes the
        single-flight leader; concurrent identical requests coalesce
        onto it, and the leader's failure fails the whole flight with
        nothing cached. Explicit ``version`` requests and
        ``bypass_cache=True`` (HTTP ``Cache-Control: no-cache``) skip
        the cache entirely. The returned future carries the disposition
        in ``.cache_status`` (``"hit"`` / ``"miss"`` / ``"coalesced"`` /
        ``"bypass"``; absent when no cache is configured) — the HTTP
        layer's ``X-Zoo-Cache`` header. Hit and coalesced results are
        zero-copy read-only
        :class:`~analytics_zoo_tpu_torch.serving.result_cache.CowView` trees
        (take ``.copy()`` to mutate); miss results stay private writable
        copies.

        ``trace_id`` pins the flight-recorder record (and any spans) to
        the caller's trace — the HTTP layer passes its adopted/minted
        ``X-Zoo-Trace-Id`` so recorder forensics correlate with the
        cross-process trace collection even while the tracer is off."""
        if self._state != "serving":
            self.metrics.for_model(name).shed("draining").inc()
            raise DrainingError(
                f"serving engine is {self._state} — send this request to "
                "another replica",
                retry_after_s=self.resilience.drain_retry_after_s)
        try:
            tenant_id = self.quota.check(tenant)
        except QuotaExceededError as e:
            self.metrics.quota_rejections(
                self.quota.label_for(e.tenant)).inc()
            raise
        tlabel = self.quota.label_for(tenant_id)
        tracer = get_tracer()
        rec = self.flight.begin(
            name,
            trace_id=(trace_id if trace_id is not None
                      else tracer.current_trace_id()),
            tenant=tlabel)
        self._ensure_slo(name)
        routed = version
        if version is None:
            picked = self.router.route(name, route_key)
            if picked is not None:
                routed = picked
                if tracer.enabled:
                    t = monotonic_s()
                    tracer.record_span(
                        "serving.route",
                        rec.trace_id or new_trace_id(), t, t,
                        model=name, version=picked,
                        sticky=route_key is not None)
        try:
            entry = self.entry(name, routed)
        except ModelNotFoundError:
            if routed is None or version is not None:
                raise
            # the policy named a version that raced a rollback/retire;
            # fall back to latest rather than failing the request
            entry = self.entry(name)
        rec.t_route = monotonic_s()
        rec.version = entry.version
        cache = self.result_cache
        if cache is not None:
            # explicit versions bypass the router, so they bypass the
            # cache too (they are debugging/pinning traffic, not the
            # hot path); Cache-Control: no-cache is the per-request
            # opt-out. Both still pay quota above — the bypass skips
            # only the cache, never admission control.
            if version is not None or bypass_cache:
                rec.cache = "bypass"
                fut = self._submit_observed(entry, name, x, timeout_ms,
                                            tlabel, rec=rec,
                                            route_key=route_key)
                fut.cache_status = "bypass"
                return fut
            key = self._cache_key(name, entry, x)
            if key is None:
                # malformed input: fall through so submit raises the
                # same ValueError (HTTP 400) it always did
                rec.cache = "bypass"
                fut = self._submit_observed(entry, name, x, timeout_ms,
                                            tlabel, rec=rec,
                                            route_key=route_key)
                fut.cache_status = "bypass"
                return fut
            got = cache.get(key)
            if got is not None:
                rec.cache = "hit"
                fut: Future = Future()
                fut.set_result(got)
                fut.cache_status = "hit"
                self.metrics.tenant_requests(tlabel).inc()
                # explicit, test-pinned choice: a hit still records
                # into the version's health window and per-version
                # metrics — under hot-key traffic a canary would
                # otherwise never reach min_requests
                self._observe_outcome(fut, name, entry, tlabel, rec=rec)
                for sv in self.router.shadow_picks(name):
                    self._mirror(name, sv, x, timeout_ms)
                return fut
            leader, waiter = cache.begin_flight(key)
            if not leader:
                rec.cache = "coalesced"
                waiter.cache_status = "coalesced"
                self.metrics.tenant_requests(tlabel).inc()
                self._observe_outcome(waiter, name, entry, tlabel, rec=rec)
                for sv in self.router.shadow_picks(name):
                    self._mirror(name, sv, x, timeout_ms)
                return waiter
            # leader: before paying a device execution, ask the fleet —
            # content-addressed keys are host-agnostic, so a hit on any
            # replica is a hit here (fleet fabric). The fetch
            # is best-effort and bounded by the peer client's timeout;
            # it installs the result through complete_flight, so any
            # followers coalesced onto this flight resolve from it too.
            if cache.peer_client is not None:
                fetched = cache.peer_fetch(key)
                if fetched is not None:
                    cache.complete_flight(key, name, entry.version,
                                          fetched)
                    rec.cache = "hit"
                    fut = Future()
                    fut.set_result(tree_cow_view(fetched))
                    fut.cache_status = "hit"
                    self.metrics.tenant_requests(tlabel).inc()
                    self._observe_outcome(fut, name, entry, tlabel,
                                          rec=rec)
                    for sv in self.router.shadow_picks(name):
                        self._mirror(name, sv, x, timeout_ms)
                    return fut
            # leader: one real execution settles the whole flight. A
            # synchronous submit failure (queue full, shed, breaker)
            # must fail the followers too, or they would hang forever.
            rec.cache = "miss"
            try:
                inner = self._submit_observed(entry, name, x, timeout_ms,
                                              tlabel, rec=rec,
                                              route_key=route_key)
            except BaseException as e:
                cache.fail_flight(key, e)
                raise
            outer: Future = Future()
            outer.cache_status = "miss"
            ver = entry.version

            def _settle(f: Future) -> None:
                try:
                    exc = f.exception()
                except BaseException as e:  # noqa: BLE001 — cancelled
                    exc = e
                if exc is None:
                    result = f.result()
                    # the immutable master is copied inside
                    # complete_flight BEFORE the leader's caller can
                    # see (and mutate) its own private result
                    cache.complete_flight(key, name, ver, result)
                    try:
                        outer.set_result(result)
                    except InvalidStateError:
                        pass
                else:
                    # errors are never cached: the flight fails as one
                    cache.fail_flight(key, exc)
                    try:
                        outer.set_exception(exc)
                    except InvalidStateError:
                        pass

            inner.add_done_callback(_settle)
            return outer
        fut = self._submit_observed(entry, name, x, timeout_ms, tlabel,
                                    rec=rec, route_key=route_key)
        return fut

    def _ensure_slo(self, name: str) -> None:
        # lazily declare the model's objectives on first traffic; the
        # local set keeps the steady state to one membership check
        if name in self._slo_models:
            return
        self._slo_models.add(name)
        self.slo.add_objective(SLOObjective(
            f"availability:{name}", kind="availability", target=0.999,
            description=f"non-failing request fraction for '{name}'"))
        thr = self._slo_latency_threshold_s
        if thr is not None:
            self.slo.add_objective(SLOObjective(
                f"latency:{name}", kind="latency", target=0.99,
                latency_threshold_s=thr,
                description=f"requests under {thr}s for '{name}'"))

    def _submit_observed(self, entry: ModelEntry, name: str, x,
                         timeout_ms: Optional[float], tlabel: str,
                         rec=None, route_key: Optional[str] = None
                         ) -> Future:
        # the pre-cache submit path, verbatim: batcher submit +
        # per-tenant/version accounting + shadow mirrors. A synchronous
        # rejection (queue full / shed / open breaker) closes the flight
        # record here — it never reaches a future.
        try:
            fut = entry.batcher.submit(x, timeout_ms=timeout_ms, fr=rec)
        except BaseException as e:
            if rec is not None:
                # client-input faults are "invalid", not anomalies — a
                # stream of 400s must not write forensic dumps
                outcome = ("rejected" if isinstance(e, CircuitOpenError)
                           else "shed" if isinstance(e, (QueueFullError,
                                                         ShedError))
                           else "invalid" if isinstance(e, (ValueError,
                                                            TypeError))
                           else "error")
                self.flight.finish(rec, outcome, error=type(e).__name__)
            raise
        self.metrics.tenant_requests(tlabel).inc()
        cap = self._capture
        if cap is not None:
            # flywheel tap: sampling decision + record allocation happen
            # here on the submit thread; the future's callback costs the
            # flush thread one queue put. The route key selects the
            # per-key error-diffusion accumulator so sticky tenants are
            # sampled exactly (known-issue: sticky-routing sampling bias).
            # The capture row carries the request's trace id — the same
            # X-Zoo-Trace-Id the client saw — so a later outcome POST
            # joins back onto this exact row.
            cap.offer(name, entry.version, x, fut,
                      trace=(rec.trace_id if rec is not None else None),
                      route_key=route_key)
        self._observe_outcome(fut, name, entry, tlabel, rec=rec)
        for sv in self.router.shadow_picks(name):
            self._mirror(name, sv, x, timeout_ms)
        return fut

    def _cache_key(self, name: str, entry: ModelEntry, x) -> Optional[str]:
        # canonical key bytes: normalized + signature-coerced arrays —
        # what the batcher would actually batch — so a JSON int payload
        # and its float32 twin hash identically. None = not keyable
        # (malformed input; the submit path raises the client error).
        try:
            xs, _multi, _rows = DynamicBatcher._normalize(x)
            sig = entry.batcher.signature
            if sig is not None:
                xs = sig.validate(xs)
        except (ValueError, TypeError):
            return None
        return ResultCache.key(name, entry.version, xs)

    def _observe_outcome(self, fut: Future, name: str, entry: ModelEntry,
                         tlabel: str, rec=None) -> None:
        # per-version + per-tenant accounting on completion: the rollout
        # gate's raw signal. Deadline expiries are not outcomes (the
        # batch never judged the version), matching breaker semantics.
        t0 = time.perf_counter()
        mm = self.metrics.for_model(name)
        health = entry.health
        ver = entry.version
        tid = rec.trace_id if rec is not None else None

        def _done(f: Future) -> None:
            try:
                exc = f.exception()
            except BaseException:  # noqa: BLE001 — cancelled future
                return
            latency = time.perf_counter() - t0
            # ops plane: close the flight record (which fires the
            # error/deadline/latency anomaly triggers) and feed the SLO
            # engine. Deadlines are user-visible failures, so they burn
            # availability budget; queue-full/shed/breaker rejections
            # are overload policy doing its job and burn nothing.
            if rec is not None:
                outcome = ("ok" if exc is None
                           else "deadline" if isinstance(
                               exc, DeadlineExceededError)
                           else "shed" if isinstance(exc, (QueueFullError,
                                                           ShedError))
                           else "rejected" if isinstance(
                               exc, CircuitOpenError)
                           else "error")
                self.flight.finish(
                    rec, outcome,
                    error=None if exc is None else type(exc).__name__)
            if not isinstance(exc, (QueueFullError, ShedError,
                                    CircuitOpenError)):
                self.slo.record_outcome(name, ok=exc is None,
                                        latency_s=latency, trace_id=tid)
            # admission-type failures are not outcomes: on the direct
            # path they raise synchronously (never reach a future); a
            # coalesced follower inheriting its leader's shed must not
            # be judged differently
            if isinstance(exc, (DeadlineExceededError, QueueFullError,
                                ShedError, CircuitOpenError)):
                return
            health.record(exc is None, latency)
            mm.version_requests(ver).inc()
            if exc is None:
                mm.version_latency(ver).observe(latency, trace_id=tid)
                self.metrics.tenant_latency(tlabel).observe(latency)
                drift = self._drift
                if drift is not None:
                    # prediction-distribution sketch for the rollout's
                    # drift gate; never allowed to fail a request
                    try:
                        drift.observe(name, ver, f.result())
                    except Exception:  # noqa: BLE001
                        pass
            else:
                mm.version_errors(ver).inc()

        fut.add_done_callback(_done)

    def _mirror(self, name: str, version: str, x,
                timeout_ms: Optional[float]) -> None:
        # duplicate one primary request into a shadow version's batcher.
        # Nothing a shadow does is allowed to surface: a full queue,
        # shed, open breaker, or predict fault becomes a metric, never
        # an exception — which is also what makes shadows shed first
        # under load (their mirrors fail the same admission checks and
        # are simply dropped)
        mm = self.metrics.for_model(name)
        try:
            entry = self.entry(name, version)
            fut = entry.batcher.submit(x, timeout_ms=timeout_ms)
        except Exception:  # noqa: BLE001 — shadows never surface
            mm.shadow_dropped(version).inc()
            return
        mm.shadow_requests(version).inc()
        t0 = time.perf_counter()
        health = entry.health

        def _done(f: Future) -> None:
            try:
                exc = f.exception()
            except BaseException:  # noqa: BLE001
                return
            latency = time.perf_counter() - t0
            if isinstance(exc, DeadlineExceededError):
                mm.shadow_dropped(version).inc()
                return
            health.record(exc is None, latency)
            if exc is None:
                mm.shadow_latency(version).observe(latency)
            else:
                mm.shadow_failures(version).inc()

        fut.add_done_callback(_done)

    def predict(self, name: str, x, timeout_ms: Optional[float] = None,
                version: Optional[str] = None,
                tenant: Optional[str] = None,
                route_key: Optional[str] = None,
                bypass_cache: bool = False):
        """Blocking :meth:`predict_async`; re-raises
        :class:`~analytics_zoo_tpu_torch.serving.batcher.QueueFullError` /
        :class:`~analytics_zoo_tpu_torch.serving.batcher.DeadlineExceededError`
        / model faults."""
        return self.predict_async(
            name, x, timeout_ms=timeout_ms, version=version,
            tenant=tenant, route_key=route_key,
            bypass_cache=bypass_cache).result()

    # -- generate (sequence serving) --------------------------------------

    def generate_async(self, name: str, prompt,
                       max_new_tokens: Optional[int] = None,
                       eos: Any = "__config__",
                       timeout_ms: Optional[float] = None,
                       version: Optional[str] = None,
                       tenant: Optional[str] = None,
                       route_key: Optional[str] = None,
                       trace_id: Optional[str] = None) -> Future:
        """Submit one generation request through the model's
        :class:`~analytics_zoo_tpu_torch.serving.sequence.ContinuousBatcher`;
        the Future resolves to a 1-D int32 array of generated tokens (eos
        inclusive when hit).

        The control plane matches :meth:`predict_async` — drain state,
        tenant quota, router/version resolution, per-version health and
        tenant accounting all apply — with two deliberate exceptions: the
        **result cache never sees generate traffic** (a response depends
        on max_new_tokens/eos) and **shadow versions receive no generate
        mirrors** (a mirrored generation would hold a decode slot for its
        whole sequence). Raises ``ValueError`` (HTTP 400) when the resolved
        version was not registered with ``sequence=``."""
        if self._state != "serving":
            self.metrics.for_model(name).shed("draining").inc()
            raise DrainingError(
                f"serving engine is {self._state} — send this request to "
                "another replica",
                retry_after_s=self.resilience.drain_retry_after_s)
        try:
            tenant_id = self.quota.check(tenant)
        except QuotaExceededError as e:
            self.metrics.quota_rejections(
                self.quota.label_for(e.tenant)).inc()
            raise
        routed = version
        if version is None:
            picked = self.router.route(name, route_key)
            if picked is not None:
                routed = picked
        try:
            entry = self.entry(name, routed)
        except ModelNotFoundError:
            if routed is None or version is not None:
                raise
            entry = self.entry(name)
        if entry.seq_batcher is None:
            raise ValueError(
                f"model '{name}' (version '{entry.version}') is not "
                "registered for sequence serving — register with "
                "sequence=SequenceConfig(...) to enable :generate")
        tlabel = self.quota.label_for(tenant_id)
        rec = self.flight.begin(
            name,
            trace_id=(trace_id if trace_id is not None
                      else get_tracer().current_trace_id()),
            kind="generate", tenant=tlabel)
        rec.t_route = monotonic_s()
        rec.version = entry.version
        self._ensure_slo(name)
        try:
            fut = entry.seq_batcher.submit(
                prompt, max_new_tokens=max_new_tokens, eos=eos,
                timeout_ms=timeout_ms)
        except BaseException as e:
            outcome = ("rejected" if isinstance(e, CircuitOpenError)
                       else "shed" if isinstance(e, (QueueFullError,
                                                     ShedError))
                       else "invalid" if isinstance(e, (ValueError,
                                                        TypeError))
                       else "error")
            self.flight.finish(rec, outcome, error=type(e).__name__)
            raise
        self.metrics.tenant_requests(tlabel).inc()
        self._observe_outcome(fut, name, entry, tlabel, rec=rec)
        return fut

    def generate(self, name: str, prompt,
                 max_new_tokens: Optional[int] = None,
                 eos: Any = "__config__",
                 timeout_ms: Optional[float] = None,
                 version: Optional[str] = None,
                 tenant: Optional[str] = None,
                 route_key: Optional[str] = None) -> np.ndarray:
        """Blocking :meth:`generate_async`."""
        return self.generate_async(
            name, prompt, max_new_tokens=max_new_tokens, eos=eos,
            timeout_ms=timeout_ms, version=version, tenant=tenant,
            route_key=route_key).result()

    # -- control plane: rollouts, routing, quotas -------------------------

    def rollout_controller(self) -> RolloutController:
        """The engine's rollout controller, created on first use when the
        engine was built without a
        :class:`~analytics_zoo_tpu_torch.serving.rollout.RolloutConfig` (manual
        admin-driven rollouts get a non-evaluating controller — drive it
        with explicit ``promote``/``rollback`` or its ``tick()``)."""
        with self._lock:
            if self._rollout is None:
                self._rollout = RolloutController(
                    self, RolloutConfig(auto_evaluate=False))
            return self._rollout

    def _on_breaker_transition(self, breaker_name: str, old: str,
                               new: str) -> None:
        # breaker listener (called INSIDE the breaker lock): every
        # transition is an anomaly worth forensics — the flight recorder
        # snapshots the requests that led here (rate-limited, and its
        # lock never touches the breaker's, so no ordering hazard); an
        # *opened* breaker additionally wakes the rollout evaluator
        # (only sets an Event) so a broken canary rolls back immediately
        self.flight.trigger("breaker_transition")
        if new != "open":
            return
        ctrl = self._rollout
        if ctrl is not None:
            ctrl.poke()

    def version_health(self, name: str,
                       version: str) -> Optional[VersionHealth]:
        """The sliding outcome window of ``(name, version)``, or None
        when not registered (the rollout controller's read path)."""
        with self._lock:
            entry = (self._models.get(name) or {}).get(version)
        return entry.health if entry is not None else None

    def breaker_open(self, name: str, version: str) -> bool:
        """True when the version's circuit breaker is currently open."""
        with self._lock:
            entry = (self._models.get(name) or {}).get(version)
        return (entry is not None and entry.breaker is not None
                and entry.breaker.state == "open")

    def protected_versions(self, name: str) -> List[str]:
        """Versions retention (hot-reload trimming) must not retire:
        ``_latest``, everything a traffic policy or shadow registration
        references, and an active rollout's canary + incumbent."""
        out = set(self.router.protected_versions(name))
        ctrl = self._rollout
        if ctrl is not None:
            state = ctrl.active(name)
            if state is not None:
                out.update((state.canary, state.incumbent))
        with self._lock:
            latest = self._latest.get(name)
        if latest is not None:
            out.add(latest)
        return sorted(out, key=_version_key)

    def _finalize_rollout(self, name: str, canary: str,
                          incumbent: str) -> None:
        # the controller finalized: the canary earned 100% — repoint
        # _latest and retire the old incumbent draining (exactly the
        # swap hot-reload's repoint used to do unconditionally)
        with self._lock:
            versions = self._models.get(name) or {}
            if canary in versions:
                self._latest[name] = canary
        if incumbent != canary:
            try:
                self.unregister(name, incumbent, drain=True)
            except ModelNotFoundError:
                pass

    def _retire_canary(self, name: str, version: str) -> None:
        # rollback path: drop the canary draining. The incumbent keeps
        # serving; never remove the model's only remaining version.
        with self._lock:
            versions = self._models.get(name) or {}
            if version not in versions or len(versions) <= 1:
                return
        try:
            self.unregister(name, version, drain=True)
        except ModelNotFoundError:
            pass

    def describe_model(self, name: str) -> Dict[str, Any]:
        """The ``GET /v1/models/<name>`` body: versions + latest +
        routing policy + shadows + rollout state."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise ModelNotFoundError(f"no model '{name}' registered")
            info = {v: e.info() for v, e in versions.items()}
            latest = self._latest.get(name)
        routing = self.router.describe(name)
        ctrl = self._rollout
        return {
            "latest": latest,
            "versions": info,
            "policy": routing["policy"],
            "shadows": routing["shadows"],
            "rollout": ctrl.describe(name) if ctrl is not None else None,
            "outcome": self.outcome_status(name),
        }

    def describe_models(self) -> Dict[str, Any]:
        """The ``GET /v1/models`` body: every model's description plus
        the engine's quota config."""
        return {
            "models": {n: self.describe_model(n)
                       for n in self.model_names()},
            "quota": self.quota.describe(),
        }

    def admin_action(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Execute one ``POST /v1/admin/rollout`` action and return the
        resulting model description.

        Actions (``payload["action"]``): ``start`` (begin a rollout for
        ``model`` with optional explicit ``canary``/``incumbent``),
        ``promote`` (force-advance one rung), ``rollback`` (retire the
        canary now), ``weights`` (install a manual traffic policy),
        ``clear_policy``, ``shadow`` (set ``version`` + ``fraction``;
        fraction ≤ 0 clears), ``quota`` (set ``tenant`` + ``rate`` /
        ``burst``; omitted rate removes the tenant's limit), ``drain``
        (take the whole engine out of rotation: :meth:`drain` with
        optional ``deadline_s`` — the front door's rolling-drain
        primitive; returns the drain report, no ``model``
        needed).

        Raises ``ValueError`` for malformed payloads (HTTP 400) and
        :class:`ModelNotFoundError` for unknown models/versions (404).
        """
        action = payload.get("action")
        name = payload.get("model")
        if action == "quota":
            tenant = payload.get("tenant")
            if not tenant:
                raise ValueError("'quota' needs a 'tenant'")
            rate = payload.get("rate")
            self.quota.set_quota(
                str(tenant),
                None if rate is None else TenantQuota(
                    rate=float(rate),
                    burst=float(payload.get("burst", 1.0))))
            return {"quota": self.quota.describe()}
        if action == "drain":
            report = self.drain(float(payload.get("deadline_s", 30.0)))
            report["state"] = self._state
            return {"drain": report}
        if not name:
            raise ValueError(f"action {action!r} needs a 'model'")
        if action == "start":
            with self._lock:
                versions = self._models.get(name)
                if not versions:
                    raise ModelNotFoundError(
                        f"no model '{name}' registered")
                canary = str(payload.get("canary")
                             or max(versions, key=_version_key))
                incumbent = str(payload.get("incumbent")
                                or self._latest.get(name))
                for v in (canary, incumbent):
                    if v not in versions:
                        raise ModelNotFoundError(
                            f"no version '{v}' of model '{name}'")
            if canary == incumbent:
                raise ValueError(
                    "canary and incumbent must be different versions")
            self.rollout_controller().begin(name, canary=canary,
                                            incumbent=incumbent)
        elif action in ("promote", "rollback"):
            ctrl = self._rollout
            if ctrl is None or ctrl.active(name) is None:
                raise ModelNotFoundError(
                    f"no active rollout for model '{name}'")
            if action == "promote":
                ctrl.promote(name)
            else:
                reason = str(payload.get("reason", "manual"))
                if reason not in ROLLBACK_REASONS:
                    reason = "manual"  # keep the metric label set bounded
                ctrl.rollback(name, reason=reason)
        elif action == "weights":
            weights = payload.get("weights")
            if not isinstance(weights, dict) or not weights:
                raise ValueError("'weights' must be a non-empty "
                                 "{version: weight} object")
            with self._lock:
                versions = self._models.get(name)
                if not versions:
                    raise ModelNotFoundError(
                        f"no model '{name}' registered")
                for v in weights:
                    if str(v) not in versions:
                        raise ModelNotFoundError(
                            f"no version '{v}' of model '{name}'")
            self.router.set_policy(
                name, {str(v): float(w) for v, w in weights.items()})
        elif action == "clear_policy":
            self.router.clear_policy(name)
        elif action == "shadow":
            version = payload.get("version")
            if not version:
                raise ValueError("'shadow' needs a 'version'")
            fraction = float(payload.get("fraction", 0.01))
            if fraction <= 0:
                self.router.clear_shadow(name, str(version))
            else:
                self.entry(name, str(version))  # 404 on unknown
                self.router.set_shadow(name, str(version), fraction)
        else:
            raise ValueError(f"unknown admin action {action!r}")
        return self.describe_model(name)

    # -- lifecycle: drain -------------------------------------------------

    @property
    def state(self) -> str:
        """``"serving"`` / ``"draining"`` / ``"drained"`` — ``/healthz``
        returns non-200 whenever this is not ``"serving"``."""
        return self._state

    @property
    def pending_requests(self) -> int:
        """Requests queued or in flight across every registered batcher."""
        with self._lock:
            entries = [e for versions in self._models.values()
                       for e in versions.values()]
        return sum(e.batcher.pending_requests
                   + (e.seq_batcher.pending_requests
                      if e.seq_batcher is not None else 0)
                   for e in entries)

    def drain(self, deadline_s: float = 30.0) -> Dict[str, Any]:
        """Take the engine out of rotation without dropping work.

        Flips state to ``draining`` (new submits raise
        :class:`~analytics_zoo_tpu_torch.serving.resilience.DrainingError`,
        ``/healthz`` goes non-200 so load balancers stop routing), then
        waits until every queued and in-flight request has completed or
        ``deadline_s`` elapses. On a complete drain the state becomes
        ``drained``; on deadline it stays ``draining`` with work still
        pending (the report says how much). Batchers keep running either
        way — call :meth:`shutdown` to stop them. Idempotent; normally
        invoked by :func:`~analytics_zoo_tpu_torch.serving.resilience
        .install_drain_on_preemption` on SIGTERM.

        Returns ``{"complete", "pending", "elapsed_s"}``.
        """
        with self._lock:
            if self._state == "serving":
                self._state = "draining"
        self.metrics.draining.set(1)
        t0 = time.monotonic()
        with get_tracer().span("serving.drain", deadline_s=deadline_s):
            while True:
                pending = self.pending_requests
                self.metrics.drain_pending.set(pending)
                if pending == 0 or time.monotonic() - t0 >= deadline_s:
                    break
                time.sleep(0.005)
        if pending == 0:
            with self._lock:
                if self._state == "draining":
                    self._state = "drained"
        return {"complete": pending == 0, "pending": pending,
                "elapsed_s": time.monotonic() - t0}

    # -- observability ----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Per-model info + metric snapshot (the ``/healthz`` payload)."""
        with self._lock:
            entries = {name: {v: e for v, e in versions.items()}
                       for name, versions in self._models.items()}
        snap = self.metrics.snapshot()
        return {
            name: {
                "versions": {v: e.info() for v, e in versions.items()},
                "latest": self._latest.get(name),
                "metrics": snap.get(name, {}),
            }
            for name, versions in entries.items()
        }

    def metrics_text(self) -> str:
        """Prometheus text exposition: the serving families, the
        ``zoo_serving_result_cache_*`` families (zeros when no result
        cache is configured — scrapers see a stable family set), one
        ``zoo_serving_executable_cache`` gauge per model/event from the
        models' ``cache_stats`` counters, and the process-global registry
        (training, inference-cache, compile and ``zoo_process_*``
        families — the process gauges are freshly sampled from /proc on
        every scrape) — a single scrape of this text is the whole
        process's metric surface."""
        from analytics_zoo_tpu_torch.common.observability import (
            get_registry,
            refresh_process_metrics,
        )
        from analytics_zoo_tpu_torch.serving.metrics import render_result_cache

        refresh_process_metrics()
        # SLO evaluation is pulled at scrape time: the burn-rate/budget
        # gauges in this engine's registry are refreshed (and alert
        # onsets counted) by the same read that exposes them
        self.slo.evaluate()
        text = (self.metrics.render() + get_registry().render()
                + render_result_cache(
                    self.result_cache.stats()
                    if self.result_cache is not None else None))
        lines = ["# HELP zoo_serving_executable_cache Compiled-executable "
                 "cache events (hits/misses/evictions) per model.",
                 "# TYPE zoo_serving_executable_cache gauge"]
        with self._lock:
            entries = [(n, self._latest.get(n), versions)
                       for n, versions in sorted(self._models.items())]
        for name, latest, versions in entries:
            entry = versions.get(latest)
            cache = getattr(entry.model, "cache_stats", None) if entry else None
            for event in ("hits", "misses", "evictions"):
                v = (cache or {}).get(event, 0)
                lines.append(
                    f'zoo_serving_executable_cache{{model="{name}",'
                    f'event="{event}"}} {v}')
        return text + "\n".join(lines) + "\n"

    def shutdown(self, drain: bool = True):
        """Stop the watchdog, the rollout evaluator, every checkpoint
        watcher and every batcher (draining by default) and clear the
        registry."""
        if self._watchdog is not None:
            self._watchdog.stop()
        if self._rollout is not None:
            self._rollout.close()
        with self._lock:
            watchers, self._watchers = self._watchers, []
            doomed = [e for versions in self._models.values()
                      for e in versions.values()]
            self._models.clear()
            self._latest.clear()
        for w in watchers:
            w.stop()
        for entry in doomed:
            entry.batcher.stop(drain=drain)
            if entry.seq_batcher is not None:
                entry.seq_batcher.stop(drain=drain)
