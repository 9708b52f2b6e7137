"""Offline batch scoring: resumable sharded batch-predict jobs with
atomic output commit (port of ``analytics_zoo_tpu.batch``).

The offline half of the serving story — ``nnframes.NNModel.transform``
over a whole dataset — composed from the streaming input pipeline
(bucketed static shapes + a host prefetch thread), the inference fast
path (dispatch/fetch overlap over the captured bucket graphs) and the ft
commit protocol (atomic shards, manifest, COMMIT marker, kill→resume
bitwise). The on-disk format is the JAX package's: each package's
:func:`~analytics_zoo_tpu_torch.batch.writers.verify_output` accepts the
other's output.

- :class:`~analytics_zoo_tpu_torch.batch.job.BatchPredictJob` — the pipelined
  score loop (yields scored row blocks, pads stripped).
- :mod:`~analytics_zoo_tpu_torch.batch.writers` — sharded ``.npy``/JSONL
  output with per-shard CRC32 + row ranges, committed atomically.
- :class:`~analytics_zoo_tpu_torch.batch.runner.BatchJobRunner` — resume
  bookkeeping, job-state checkpoints, metrics/spans, chaos sites.
"""

from analytics_zoo_tpu_torch.batch.job import BatchPredictJob
from analytics_zoo_tpu_torch.batch.runner import BatchJobRunner
from analytics_zoo_tpu_torch.batch.writers import (
    JsonlShardWriter,
    NpyShardWriter,
    OutputSpec,
    ShardCorruptError,
    ShardWriter,
    iter_output_rows,
    job_complete,
    load_shard_rows,
    read_commit,
    read_manifest,
    verify_output,
)

__all__ = [
    "BatchPredictJob",
    "BatchJobRunner",
    "OutputSpec",
    "ShardWriter",
    "NpyShardWriter",
    "JsonlShardWriter",
    "ShardCorruptError",
    "read_manifest",
    "read_commit",
    "job_complete",
    "verify_output",
    "load_shard_rows",
    "iter_output_rows",
]
