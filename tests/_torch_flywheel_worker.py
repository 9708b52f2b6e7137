"""The port's flywheel kill/resume worker (launched by
test_torch_flywheel.py and test_torch_outcome_plane.py), on the CPU.

The modes of tests/_flywheel_worker.py, over one shared root directory:

``seed <root> <out.json>``
    Create the incumbent: one conventional training pass committing
    checkpoints under ``<root>/ckpts``, then a deterministic committed
    capture segment under ``<root>/capture/m`` (the tap driven offline
    with pre-resolved futures and a fixed clock, so two copies of the
    root are byte-for-byte comparable starting states).

``retrain <root> <out.json>``
    One :meth:`FlywheelTrainer.run_once` cycle. Under
    ``AZOO_FT_CHAOS=flywheel_mid_retrain_kill`` the checkpoint-trigger
    chaos point hard-kills the process (``os._exit(43)``) mid-epoch;
    rerun without the variable to resume. The output records the
    candidate step and a CRC32 per checkpoint leaf's raw bytes.

``seed_outcome <root> <out.json>``
    ``seed`` plus a committed label segment: an outcome for every
    captured trace, ingested in a shuffled order with fixed timestamps.

``retrain_outcome <root> <out.json>``
    ``retrain`` with the outcome plane on: the cycle pins mode
    ``outcome`` and trains on the joined labels.

Usage: python _torch_flywheel_worker.py <mode> <root> <out.json>
Env: AZOO_FT_CHAOS / AZOO_FT_CHAOS_SKIP (ft/chaos.py).
"""

import json
import os
import sys
import zlib
from concurrent.futures import Future

MODE, ROOT, OUT = sys.argv[1], sys.argv[2], sys.argv[3]

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import analytics_zoo_tpu_torch as port  # noqa: E402
from analytics_zoo_tpu_torch.data.feature_set import (  # noqa: E402
    ArrayFeatureSet,
)
from analytics_zoo_tpu_torch.engine.estimator import Estimator  # noqa: E402
from analytics_zoo_tpu_torch.flywheel import (  # noqa: E402
    CaptureConfig,
    CaptureTap,
    FlywheelTrainer,
    RetrainConfig,
)
from analytics_zoo_tpu_torch.ft import atomic  # noqa: E402
from analytics_zoo_tpu_torch.keras import objectives  # noqa: E402
from analytics_zoo_tpu_torch.keras.engine.base import (  # noqa: E402
    reset_name_counts,
)
from analytics_zoo_tpu_torch.keras.engine.topology import (  # noqa: E402
    Sequential,
)
from analytics_zoo_tpu_torch.keras.layers import Dense  # noqa: E402
from analytics_zoo_tpu_torch.keras.optimizers import SGD  # noqa: E402

IN_DIM, OUT_DIM = 4, 2
CKPT_DIR = os.path.join(ROOT, "ckpts")
CAP_DIR = os.path.join(ROOT, "capture", "m")

port.init_nncontext(device="cpu", seed=0)


def build_est():
    reset_name_counts()
    return Estimator(Sequential([Dense(OUT_DIM, input_shape=(IN_DIM,))]),
                     SGD(0.05))


def leaf_crcs(path):
    """CRC32 of every leaf's raw array bytes in a committed checkpoint."""
    flat, _ = atomic.read_checkpoint(path)
    return {key: zlib.crc32(np.ascontiguousarray(value).tobytes())
            for key, value in flat}


def seed():
    rng = np.random.default_rng(7)
    est = build_est()
    est.set_checkpoint(CKPT_DIR, keep_last=8, asynchronous=False)
    est.train(ArrayFeatureSet(
        rng.normal(size=(32, IN_DIM)).astype(np.float32),
        rng.normal(size=(32, OUT_DIM)).astype(np.float32)),
        objectives.mean_squared_error, batch_size=8)
    tap = CaptureTap(CaptureConfig(directory=os.path.join(ROOT, "capture"),
                                   fraction=1.0, rows_per_shard=16,
                                   idle_poll_s=0.01),
                     clock=lambda: 1700000000.0)
    tap.enable("m")
    for i in range(40):
        fut = Future()
        x = (np.arange(IN_DIM, dtype=np.float32) * 0.1 + i)[None, :]
        tap.offer("m", "4", x, fut, trace=f"t{i:03d}")
        fut.set_result(np.full((1, OUT_DIM), float(i), np.float32))
    tap.flush()
    segment = tap.rotate("m")
    tap.close()
    with open(OUT, "w") as f:
        json.dump({"incumbent": atomic.committed_checkpoints(CKPT_DIR)[-1][0],
                   "segment": os.path.basename(segment)}, f)


def retrain(labels: bool = False):
    kw = {}
    if labels:
        kw["labels_dir"] = os.path.join(CAP_DIR, "labels")
    trainer = FlywheelTrainer(
        build_est, objectives.mean_squared_error,
        RetrainConfig(capture_dir=CAP_DIR, checkpoint_dir=CKPT_DIR,
                      batch_size=8, checkpoint_every=2, keep_last=8,
                      min_rows=8, **kw))
    step = trainer.run_once()
    assert step is not None, "seeded root must have pending capture data"
    if labels:
        assert trainer.last_mode == "outcome", trainer.last_mode
    path = dict(atomic.committed_checkpoints(CKPT_DIR))[step]
    with open(OUT, "w") as f:
        json.dump({"step": step, "mode": trainer.last_mode,
                   "leaves": leaf_crcs(path),
                   "consumed": sorted(trainer.consumed_segments())}, f)


def seed_outcome():
    seed()
    from analytics_zoo_tpu_torch.flywheel.labels import LabelStore

    store = LabelStore(os.path.join(ROOT, "capture"), rows_per_shard=8,
                       clock=lambda: 1700000500.0)
    order = list(range(40))
    np.random.default_rng(11).shuffle(order)  # out of order on purpose
    store.ingest("m", [{"trace_id": f"t{i:03d}",
                        "label": [float(i) * 0.5, float(i) * -0.25],
                        "ts": 1700000100.0 + i} for i in order])
    store.rotate("m")
    store.close()


if __name__ == "__main__":
    {"seed": seed, "retrain": retrain, "seed_outcome": seed_outcome,
     "retrain_outcome": lambda: retrain(labels=True)}[MODE]()
