"""The port's pipelined-training worker (launched by
``tests/test_torch_pipeline.py``), the counterpart of
``tests/_pipeline_worker.py``.

One process running ``Estimator.train_pipelined`` on the CPU over a
K-stage StagePlan with M microbatches, committing stage-owned sharded
checkpoints. Under ``AZOO_FT_CHAOS=pipeline_mid_schedule_kill`` the
process hard-kills itself (``os._exit(43)``) between two microbatch
schedule events; ``AZOO_FT_CHAOS_SKIP=N`` lets N events (so at least one
checkpoint) land first. Restarted with chaos disarmed and
``auto_resume=True``, the run picks up the newest COMMITTED stage-sharded
checkpoint and must finish with final parameters bitwise an
uninterrupted run's.

Usage: python _torch_pipeline_worker.py <ckpt_dir> <out.json>
Env: PIPE_STAGES (default 2), PIPE_MICROBATCHES (default 2),
PIPE_SCHEDULE (1f1b|gpipe, default 1f1b), PIPE_EPOCHS (default 2),
PIPE_CKPT_EVERY (iterations, default 2),
AZOO_FT_CHAOS / AZOO_FT_CHAOS_SKIP (ft/chaos.py).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import analytics_zoo_tpu_torch as port  # noqa: E402
from analytics_zoo_tpu_torch.data.feature_set import (  # noqa: E402
    ArrayFeatureSet,
)
from analytics_zoo_tpu_torch.engine import checkpoint as ck  # noqa: E402
from analytics_zoo_tpu_torch.engine.estimator import Estimator  # noqa: E402
from analytics_zoo_tpu_torch.engine.triggers import (  # noqa: E402
    MaxEpoch,
    SeveralIteration,
)
from analytics_zoo_tpu_torch.keras import objectives  # noqa: E402
from analytics_zoo_tpu_torch.keras.engine.topology import (  # noqa: E402
    Sequential,
)
from analytics_zoo_tpu_torch.keras.layers import Dense  # noqa: E402
from analytics_zoo_tpu_torch.keras.optimizers import Adam  # noqa: E402
from analytics_zoo_tpu_torch.pipeline import StagePlan  # noqa: E402

STAGES = int(os.environ.get("PIPE_STAGES", "2"))
MICROBATCHES = int(os.environ.get("PIPE_MICROBATCHES", "2"))
SCHEDULE = os.environ.get("PIPE_SCHEDULE", "1f1b")
EPOCHS = int(os.environ.get("PIPE_EPOCHS", "2"))
CKPT_EVERY = int(os.environ.get("PIPE_CKPT_EVERY", "2"))


def make_plan(num_stages: int) -> StagePlan:
    rules = {
        1: ((r".", 0),),
        2: ((r"^stage0_", 0), (r".", 1)),
        3: ((r"^stage0_", 0), (r"^stage1_", 1), (r".", 2)),
    }[num_stages]
    return StagePlan(num_stages, rules=rules)


def main() -> None:
    ckpt_dir, out = sys.argv[1:3]
    port.init_nncontext(device="cpu")
    rng = np.random.default_rng(7)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    y = rng.integers(0, 3, 32).astype(np.int32)
    model = Sequential([
        Dense(10, activation="relu", input_shape=(6,), name="stage0_in"),
        Dense(10, activation="relu", name="stage1_mid"),
        Dense(3, name="stage2_out"),
    ])
    est = Estimator(model, Adam(0.02))
    est.set_checkpoint(ckpt_dir, keep_last=3)
    est.train_pipelined(
        ArrayFeatureSet(x, y),
        objectives.sparse_categorical_crossentropy_from_logits,
        make_plan(STAGES), num_microbatches=MICROBATCHES, schedule=SCHEDULE,
        end_trigger=MaxEpoch(EPOCHS),
        checkpoint_trigger=SeveralIteration(CKPT_EVERY), batch_size=16,
        auto_resume=True)
    flat = {k: v.ravel().tolist() for k, v in ck.flatten(est.tstate.params)}
    with open(out, "w") as f:
        json.dump({"params": flat, "iteration": est.run_state.iteration,
                   "epoch": est.run_state.epoch,
                   "loss": est.run_state.loss}, f)


if __name__ == "__main__":
    main()
