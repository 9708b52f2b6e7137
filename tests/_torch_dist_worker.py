"""One host of the port's multi-host kill tests (launched by
``tests/test_torch_dist_training.py``), the counterpart of
``tests/_dist_worker.py``.

Every host trains the same small model through
``Estimator.train_distributed`` on the CPU, meeting its peers in a
filesystem rendezvous directory and committing sharded checkpoints
through the two-phase protocol. Under ``AZOO_FT_CHAOS=<dist point>`` the
commit hard-kills THIS process (``os._exit(43)``) at that point; its peers
time out and fail. Restarted with a fresh ``AZOO_DIST_RUN_ID``,
``auto_resume=True`` picks up the last committed checkpoint, and the run
must end with final parameters bitwise those of an uninterrupted run.

Under ``DIST_PREEMPT_AT=<iteration>`` host 0 flags a preemption at that
iteration; the flag rides the next gradient exchange, every host saves
coordinately and raises ``PreemptedError``, and the worker exits 41 with
the checkpoint path in its output.

Usage: python _torch_dist_worker.py <ckpt_dir> <rdv_dir> <out.json>
Env: AZOO_DIST_HOST / AZOO_DIST_NHOSTS / AZOO_DIST_RUN_ID /
AZOO_DIST_TIMEOUT_S, AZOO_FT_CHAOS / AZOO_FT_CHAOS_SKIP, DIST_EPOCHS
(default 3), DIST_PREEMPT_AT.
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
    Trigger,
)
from analytics_zoo_tpu_torch.ft.distributed import DistContext  # noqa: E402
from analytics_zoo_tpu_torch.ft.preemption import (  # noqa: E402
    PreemptedError,
    PreemptionHandler,
)
from analytics_zoo_tpu_torch.keras import objectives  # noqa: E402
from analytics_zoo_tpu_torch.keras.optimizers import Adam  # noqa: E402
from analytics_zoo_tpu_torch.keras.engine.topology import (  # noqa: E402
    Sequential,
)
from analytics_zoo_tpu_torch.keras.layers import Dense, Dropout  # noqa: E402


class _PreemptAt(Trigger):
    """An end trigger that flags the handler once the run reaches an
    iteration (a deterministic stand-in for SIGTERM), then asks the real
    trigger."""

    reads_loss = False

    def __init__(self, handler, iteration, inner):
        self.handler, self.iteration, self.inner = handler, iteration, inner

    def __call__(self, rs):
        if self.iteration and rs.iteration >= self.iteration:
            self.handler.request()
        return self.inner(rs)


def main() -> None:
    ckpt_dir, rdv_dir, out = sys.argv[1:4]
    host = int(os.environ.get("AZOO_DIST_HOST", "0"))
    nhosts = int(os.environ.get("AZOO_DIST_NHOSTS", "2"))
    epochs = int(os.environ.get("DIST_EPOCHS", "3"))
    preempt_at = int(os.environ.get("DIST_PREEMPT_AT", "0"))
    port.init_nncontext(device="cpu")
    rng = np.random.default_rng(11)
    x = rng.normal(size=(24, 8)).astype(np.float32)
    y = rng.integers(0, 3, 24).astype(np.int32)
    model = Sequential([Dense(8, activation="relu", input_shape=(8,)),
                        Dropout(0.4), Dense(3)])
    est = Estimator(model, Adam(0.02))
    est.set_checkpoint(ckpt_dir, keep_last=3)
    handler = PreemptionHandler().install()
    est.set_preemption_handler(handler)
    end = MaxEpoch(epochs)
    if preempt_at and host == 0:
        end = _PreemptAt(handler, preempt_at, end)
    preempted = None
    try:
        est.train_distributed(
            ArrayFeatureSet(x, y),
            objectives.sparse_categorical_crossentropy_from_logits,
            end_trigger=end, checkpoint_trigger=SeveralIteration(4),
            batch_size=8, auto_resume=True,
            dist=DistContext(host, nhosts, rdv_dir))
    except PreemptedError as e:
        preempted = e.checkpoint_path
    with open(out, "w") as f:
        json.dump({"host": host,
                   "params": {k: v.ravel().tolist()
                              for k, v in ck.flatten(est.tstate.params)},
                   "iteration": est.run_state.iteration,
                   "epoch": est.run_state.epoch,
                   "preempted": preempted is not None,
                   "checkpoint_path": preempted}, f)
    if preempted is not None:
        sys.exit(41)


if __name__ == "__main__":
    main()
