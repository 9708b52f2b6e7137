"""Online-learning flywheel: capture → replay → retrain → promote (port
of ``analytics_zoo_tpu.flywheel``; capture and label directories are the
JAX package's format, row for row).

The subsystem that connects every existing layer into one automated
cycle — it operates a model, not just serves one:

- :mod:`.capture` — a sampled request/response tap on the serving
  engine, writing canonical inputs + predictions through the batch
  layer's atomic shard/manifest/COMMIT protocol.
- :mod:`.replay`  — a :class:`~analytics_zoo_tpu_torch.data.sources.Source`
  over committed capture segments, feeding the training pipeline
  (``Estimator.train`` over a streaming ``Pipeline``) with the full
  determinism/resume contract.
- :mod:`.trainer` — the incremental retrain driver: warm-starts from
  the incumbent's checkpoint, trains on newly captured segments, tracks
  the consumption high-water mark through ``ft.CheckpointManager``.
- :mod:`.controller` — the promotion loop gluing checkpoint watching,
  shadow scoring and the canary ladder; rollback quarantines the
  cycle's capture data.
- :mod:`.labels`  — the outcome plane's label side: HTTP-
  ingested ground-truth outcomes through the same atomic shard
  protocol, watermark-joined back onto capture by trace id, replayable
  as a :class:`~analytics_zoo_tpu_torch.flywheel.labels.LabeledSource` whose
  targets are outcomes, not predictions.
- :mod:`.drift`   — bounded-memory drift sketches: per-feature PSI and
  the prediction-histogram Jensen–Shannon divergence behind the rollout
  ladder's drift gate (``RolloutConfig.drift_gates``).
"""

from analytics_zoo_tpu_torch.flywheel.capture import (
    CAPTURE_FORMAT,
    CaptureConfig,
    CaptureShardWriter,
    CaptureTap,
    committed_segments,
    is_quarantined,
    quarantine_segment,
    segment_dirs,
)
from analytics_zoo_tpu_torch.flywheel.replay import CaptureSource
from analytics_zoo_tpu_torch.flywheel.trainer import FlywheelTrainer, RetrainConfig
from analytics_zoo_tpu_torch.flywheel.controller import (
    CycleReport,
    FlywheelController,
)
from analytics_zoo_tpu_torch.flywheel.labels import (
    LABEL_FORMAT,
    LabeledSource,
    LabelJoiner,
    LabelShardWriter,
    LabelStore,
)
from analytics_zoo_tpu_torch.flywheel.drift import (
    DriftDetector,
    PredictionTracker,
    StreamingHistogram,
)

__all__ = [
    "CAPTURE_FORMAT",
    "LABEL_FORMAT",
    "CaptureConfig",
    "CaptureShardWriter",
    "CaptureTap",
    "CaptureSource",
    "CycleReport",
    "DriftDetector",
    "FlywheelController",
    "FlywheelTrainer",
    "LabeledSource",
    "LabelJoiner",
    "LabelShardWriter",
    "LabelStore",
    "PredictionTracker",
    "RetrainConfig",
    "StreamingHistogram",
    "committed_segments",
    "is_quarantined",
    "quarantine_segment",
    "segment_dirs",
]
