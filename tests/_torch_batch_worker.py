"""The port's batch-scoring crash worker (launched by
test_torch_batch_scoring.py; the port's copy of tests/_batch_worker.py).

One REAL batch-predict process of the kill/resume drill: score a
deterministic dataset through a deterministic model into sharded output,
checkpointing job state every 2 shards. Under ``AZOO_FT_CHAOS=<point>``
(one of chaos.BATCH_POINTS) the shard commit protocol hard-kills the
process (``os._exit(43)``) at that site. Restarted with
``BATCH_RESUME=1`` the job continues from the manifest's committed
shards and must finish with output bitwise identical to an
uninterrupted run's — no duplicate rows, no holes.

The model is pure NumPy (a fixed-seed linear map with the serving
fast-path dispatch/fetch split, so the overlapped loop is the one under
the kill): determinism across processes without a device in the loop.
The port's card geometry is chip_smoke.py's phase 12.

Usage: python _torch_batch_worker.py <out_dir> <report.json>
Env: AZOO_FT_CHAOS / AZOO_FT_CHAOS_SKIP (chaos.py), BATCH_RESUME=1.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from analytics_zoo_tpu_torch.batch import (  # noqa: E402
    BatchJobRunner,
    BatchPredictJob,
    OutputSpec,
)
from analytics_zoo_tpu_torch.data.sources import ArraySource  # noqa: E402

OUT_DIR = sys.argv[1]
REPORT = sys.argv[2]

N_ROWS = 157
FEATURES = 6
BATCH = 16
BUCKETS = (4, 8, 16)
ROWS_PER_SHARD = 20


class LinearModel:
    """Deterministic x @ W with the dispatch/fetch split."""

    def __init__(self):
        self.w = np.random.default_rng(9).standard_normal(
            (FEATURES, 3)).astype(np.float32)

    def do_dispatch(self, x):
        return np.asarray(x) @ self.w

    def do_fetch(self, out):
        return out

    def do_predict(self, x):
        return np.asarray(x) @ self.w


def main() -> None:
    x = np.random.default_rng(5).standard_normal(
        (N_ROWS, FEATURES)).astype(np.float32)
    job = BatchPredictJob(LinearModel(), ArraySource(x), batch_size=BATCH,
                          pad_to_bucket=BUCKETS, pipeline_depth=2)
    runner = BatchJobRunner(
        job, OutputSpec(OUT_DIR, fmt="npy", rows_per_shard=ROWS_PER_SHARD),
        checkpoint_every_shards=2)
    report = runner.run(resume=os.environ.get("BATCH_RESUME") == "1")
    with open(REPORT, "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main()
