"""Online serving engine (port of ``analytics_zoo_tpu.serving``) — the
Cluster Serving analogue.

The reference serves online traffic with Cluster Serving: a Redis request
queue feeding a Flink job that dynamically batches into ``InferenceModel``
replicas, monitored via Prometheus. Here the same architecture is one
process: an ``InferenceModel`` keeps one executable per bucket shape (on
the card, a captured CUDA graph) that takes concurrent callers, so
batching is a host-side concern. The modules:

- :mod:`~analytics_zoo_tpu_torch.serving.batcher` — bounded future queue
  and a dispatch/completion thread pair: dynamic micro-batching onto a
  warmed bucket ladder, backpressure, per-request deadlines.
- :mod:`~analytics_zoo_tpu_torch.serving.engine` — named/versioned model
  registry with per-bucket warm-up at register time.
- :mod:`~analytics_zoo_tpu_torch.serving.metrics` — counters, gauges and
  summaries with a Prometheus text exposition.
- :mod:`~analytics_zoo_tpu_torch.serving.http` — stdlib HTTP frontend
  (``POST /v1/models/<name>:predict``, ``GET /metrics``, ``GET /healthz``,
  the control-plane and debug routes).
- :mod:`~analytics_zoo_tpu_torch.serving.resilience` — deadline-aware
  admission control, per-model circuit breakers, the flush-thread
  watchdog, and the graceful drain lifecycle (on by default).
- :mod:`~analytics_zoo_tpu_torch.serving.router` /
  :mod:`~analytics_zoo_tpu_torch.serving.rollout` /
  :mod:`~analytics_zoo_tpu_torch.serving.quota` — the deployment control
  plane: weighted version routing with sticky keys, staged canary
  rollouts with metric-gated auto-promote/auto-rollback, shadow traffic,
  and per-tenant token-bucket quotas.
- :mod:`~analytics_zoo_tpu_torch.serving.result_cache` — the
  content-addressed inference result cache with single-flight coalescing
  and copy-on-write hit views.

- :mod:`~analytics_zoo_tpu_torch.serving.sequence` /
  :mod:`~analytics_zoo_tpu_torch.serving.decode_state` — sequence serving:
  length-bucketed prefill and continuous decode batching over a slot
  array (``register(sequence=...)``, ``generate``, HTTP ``:generate``).
- :mod:`~analytics_zoo_tpu_torch.serving.frontdoor` /
  :mod:`~analytics_zoo_tpu_torch.serving.worker` — the preforked
  multi-process front door and its engine workers (``python -m
  analytics_zoo_tpu_torch.serving.worker``), and
  :mod:`~analytics_zoo_tpu_torch.serving.fabric` — the multi-host fleet
  door, membership, cooperative cache and autoscaler.
"""

from analytics_zoo_tpu_torch.serving.batcher import (
    BatcherConfig,
    DeadlineExceededError,
    DynamicBatcher,
    InputSignature,
    QueueFullError,
)
from analytics_zoo_tpu_torch.serving.engine import (
    ModelEntry,
    ModelNotFoundError,
    ServingEngine,
)
from analytics_zoo_tpu_torch.serving.frontdoor import (
    FrontDoor,
    FrontDoorConfig,
    NoLiveWorkersError,
    WorkerBootError,
)
from analytics_zoo_tpu_torch.serving.http import serve as serve_http
from analytics_zoo_tpu_torch.serving.metrics import ServingMetrics
from analytics_zoo_tpu_torch.serving.quota import (
    QuotaConfig,
    QuotaExceededError,
    QuotaManager,
    TenantQuota,
)
from analytics_zoo_tpu_torch.serving.resilience import (
    AdmissionController,
    BreakerConfig,
    CircuitBreaker,
    CircuitOpenError,
    DrainingError,
    FlushThreadRestartedError,
    FlushWatchdog,
    ResilienceConfig,
    RetryableError,
    ShedError,
    install_drain_on_preemption,
)
from analytics_zoo_tpu_torch.serving.result_cache import (
    CowView,
    ResultCache,
    ResultCacheConfig,
)
from analytics_zoo_tpu_torch.serving.rollout import (
    DriftGateConfig,
    RolloutConfig,
    RolloutController,
    VersionHealth,
)
from analytics_zoo_tpu_torch.serving.router import Router, TrafficPolicy
from analytics_zoo_tpu_torch.serving.sequence import (
    ContinuousBatcher,
    SequenceConfig,
)

__all__ = [
    "AdmissionController",
    "BatcherConfig",
    "BreakerConfig",
    "CircuitBreaker",
    "CircuitOpenError",
    "ContinuousBatcher",
    "CowView",
    "DeadlineExceededError",
    "DrainingError",
    "DriftGateConfig",
    "DynamicBatcher",
    "FlushThreadRestartedError",
    "FlushWatchdog",
    "FrontDoor",
    "FrontDoorConfig",
    "InputSignature",
    "ModelEntry",
    "ModelNotFoundError",
    "NoLiveWorkersError",
    "QueueFullError",
    "QuotaConfig",
    "QuotaExceededError",
    "QuotaManager",
    "ResilienceConfig",
    "ResultCache",
    "ResultCacheConfig",
    "RetryableError",
    "RolloutConfig",
    "RolloutController",
    "Router",
    "SequenceConfig",
    "ServingEngine",
    "ServingMetrics",
    "ShedError",
    "TenantQuota",
    "TrafficPolicy",
    "VersionHealth",
    "WorkerBootError",
    "install_drain_on_preemption",
    "serve_http",
]
