"""The flywheel's incremental retrain driver.

:class:`FlywheelTrainer` runs one retrain *cycle* at a time
(:meth:`run_once`): discover capture segments committed since the last
cycle, replay them through ``Pipeline.from_capture``, and fit for one
epoch warm-started from the incumbent's committed checkpoint — the
Estimator's ``auto_resume`` path restores params, optimizer state, RNG
and the mid-epoch data-iterator position, so a cycle killed anywhere
(the ``flywheel_mid_retrain_kill`` chaos point fires at
checkpoint-trigger evaluations) resumes to a candidate checkpoint
bitwise identical to an uninterrupted run's.

Two durable artifacts per cycle, committed in a deliberate order:

1. the candidate checkpoint — ``Estimator.train`` returns only after
   the end-of-epoch checkpoint is durably committed (``ckpt_<step>/``
   under ``checkpoint_dir``, where the promotion loop's
   ``watch_checkpoints`` finds it);
2. the capture high-water mark — which segments this cycle consumed,
   written *after* (1) through a second
   :class:`~analytics_zoo_tpu_torch.ft.manager.CheckpointManager`
   (``flywheel_state/state_<step>/``). A crash between the two replays
   the same segments into the same warm-start state — same candidate,
   no data skipped, no data double-counted into a *different* model.

The segment set is stable across a kill→resume because only
:meth:`CaptureTap.rotate` commits segments: whatever the tap captures
*during* a retrain accumulates in its open (uncommitted) segment and
becomes visible to the next cycle only.
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass
from typing import Callable, List, Optional, Set

import numpy as np

from analytics_zoo_tpu_torch.common.observability import flywheel_metrics
from analytics_zoo_tpu_torch.engine.triggers import (
    EveryEpoch,
    Or,
    SeveralIteration,
    Trigger,
)
from analytics_zoo_tpu_torch.flywheel.capture import committed_segments
from analytics_zoo_tpu_torch.ft import atomic, chaos
from analytics_zoo_tpu_torch.ft.manager import CheckpointManager

__all__ = ["RetrainConfig", "FlywheelTrainer"]

#: Subdirectory of ``checkpoint_dir`` holding the consumption
#: high-water-mark state (``state_<step>/`` checkpoints — a name shape
#: ``committed_checkpoints(prefix="ckpt")`` scanners never match, so the
#: promotion watcher ignores it).
STATE_DIR = "flywheel_state"

#: Durable per-cycle plan (inside the state dir): the mode decision and
#: label-segment pin, written BEFORE training starts so a cycle killed
#: mid-retrain resumes with the identical join — labels that arrived
#: between kill and resume can neither flip the mode nor grow the
#: joined stream. Removed when the cycle's high-water mark commits.
CYCLE_PLAN = "CYCLE_PLAN.json"


class _MidRetrainKill(Trigger):
    """Checkpoint-trigger wrapper hosting the ``flywheel_mid_retrain_kill``
    chaos point: every trigger evaluation is a potential kill site, so
    ``AZOO_FT_CHAOS_SKIP=N`` dials death to a specific mid-epoch
    iteration."""

    reads_loss = False

    def __init__(self, inner: Trigger):
        self.inner = inner

    def __call__(self, state) -> bool:
        chaos.maybe_fail("flywheel_mid_retrain_kill")
        return self.inner(state)


@dataclass(frozen=True)
class RetrainConfig:
    """One flywheel retrain lane.

    Args:
      capture_dir: the model's capture directory
        (``<capture_root>/<model>`` — where rotated segments land).
      checkpoint_dir: where candidate checkpoints commit; also the
        incumbent's checkpoint home (warm-start source) and the
        directory the promotion loop watches.
      batch_size: replay batch size.
      checkpoint_every: mid-epoch checkpoint cadence, in iterations
        (the kill→resume granularity).
      keep_last: checkpoint retention (must cover the incumbent while a
        candidate is canarying — the watcher's ``protected_versions``
        guards the serving side; this guards the warm-start side).
      min_rows: skip the cycle (return None) below this many new rows.
      seed: pipeline seed — fixed, so a resumed cycle re-derives the
        identical sample order.
      labels_dir: the model's label-segment root
        (``<capture_dir>/labels`` — see
        :mod:`analytics_zoo_tpu_torch.flywheel.labels`). When set, a cycle
        whose capture window is *closed* under the label watermark
        trains against joined ground-truth outcomes
        (``Pipeline.from_labeled_capture``) instead of the incumbent's
        own predictions; an open window falls back to self-distillation.
        None keeps the pre-outcome-plane behaviour exactly.
      label_grace_s: watermark grace window — a capture segment counts
        as closed only once the label watermark passes its max request
        timestamp plus this slack (late-label headroom).
    """

    capture_dir: str
    checkpoint_dir: str
    batch_size: int = 16
    checkpoint_every: int = 4
    keep_last: int = 4
    min_rows: int = 1
    seed: int = 0
    labels_dir: Optional[str] = None
    label_grace_s: float = 0.0


class FlywheelTrainer:
    """Drives incremental retrains. ``build_estimator`` must return a
    *fresh* :class:`~analytics_zoo_tpu_torch.engine.estimator.Estimator` whose
    model/optimizer match the incumbent checkpoint's structure — every
    cycle builds one, points it at ``checkpoint_dir`` and lets
    ``auto_resume`` warm-start it from the newest committed step."""

    def __init__(self, build_estimator: Callable[[], object], criterion,
                 config: RetrainConfig):
        self.build_estimator = build_estimator
        self.criterion = criterion
        self.config = config
        self.metrics = flywheel_metrics()
        self._state_dir = os.path.join(config.checkpoint_dir, STATE_DIR)
        self.last_consumed: List[str] = []
        #: Mode of the most recent cycle: "outcome" (trained against
        #: joined ground-truth labels), "distill" (self-distillation),
        #: or None before any cycle / when the cycle produced nothing.
        self.last_mode: Optional[str] = None

    # -- high-water mark --------------------------------------------------

    def consumed_segments(self) -> Set[str]:
        """Segment basenames every prior cycle already trained on (from
        the newest committed state checkpoint)."""
        steps = atomic.committed_checkpoints(self._state_dir,
                                             prefix="state")
        if not steps:
            return set()
        _, meta = atomic.read_checkpoint(steps[-1][1])
        return set(meta.get("consumed", []))

    def _commit_state(self, consumed: Set[str], step: int,
                      mode: Optional[str] = None) -> None:
        meta = {"consumed": sorted(consumed)}
        if mode is not None:
            # recorded so a kill→resume (and the ops plane) can see HOW
            # the candidate was trained, not just on what
            meta["mode"] = mode
        mgr = CheckpointManager(self._state_dir, keep_last=2,
                                prefix="state", asynchronous=False)
        try:
            mgr.save(step, {"hwm": np.asarray(step, dtype=np.int64)},
                     metadata=meta, blocking=True)
        finally:
            mgr.close()

    # -- cycle plan (outcome mode) -----------------------------------------

    def _plan_path(self) -> str:
        return os.path.join(self._state_dir, CYCLE_PLAN)

    def _read_plan(self) -> Optional[dict]:
        try:
            with open(self._plan_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _write_plan(self, plan: dict) -> None:
        os.makedirs(self._state_dir, exist_ok=True)
        tmp = self._plan_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(plan, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._plan_path())

    def _clear_plan(self) -> None:
        try:
            os.unlink(self._plan_path())
        except OSError:
            pass

    def _cycle_plan(self, segments: List[str]) -> dict:
        """The cycle's pinned plan: mode + the exact label segments the
        join may read. Reused verbatim when a plan for the same capture
        window already exists (a killed cycle resuming), decided and
        durably written otherwise — BEFORE any training, so the decision
        can never drift mid-cycle."""
        from analytics_zoo_tpu_torch.flywheel.labels import LabelJoiner

        basenames = sorted(os.path.basename(s) for s in segments)
        plan = self._read_plan()
        if plan is not None and sorted(plan.get("segments", [])) \
                == basenames:
            return plan
        cfg = self.config
        joiner = LabelJoiner(cfg.capture_dir, cfg.labels_dir,
                             grace_s=cfg.label_grace_s)
        label_segments = joiner.label_segments()
        closed = all(joiner.labels_closed(s, label_segments)
                     for s in segments)
        mode = "distill"
        if closed and label_segments:
            joined = joiner.join(segments, label_segments)
            if len(joined) >= cfg.min_rows:
                mode = "outcome"
        plan = {"segments": basenames, "mode": mode,
                "label_segments": [os.path.basename(s)
                                   for s in label_segments],
                "incumbent": self.incumbent_step()}
        self._write_plan(plan)
        return plan

    def pending_segments(self) -> List[str]:
        """Committed, non-quarantined segments no cycle has consumed."""
        done = self.consumed_segments()
        return [s for s in committed_segments(self.config.capture_dir)
                if os.path.basename(s) not in done]

    # -- retrain ----------------------------------------------------------

    def incumbent_step(self) -> Optional[int]:
        """The newest committed candidate/incumbent checkpoint step."""
        steps = atomic.committed_checkpoints(self.config.checkpoint_dir)
        return steps[-1][0] if steps else None

    def run_once(self) -> Optional[int]:
        """One retrain cycle. Returns the candidate checkpoint's step,
        or None when there is no (or not enough) new capture data.

        One epoch over the new segments: ``auto_resume`` restores the
        incumbent's state *before* the default end trigger is computed,
        so the run always ends at ``incumbent_epoch + 1`` — a killed and
        resumed cycle finishes the *same* epoch, not an extra one."""
        from analytics_zoo_tpu_torch.data.pipeline import Pipeline

        cfg = self.config
        segments = self.pending_segments()
        mode: Optional[str] = None
        rows = 0
        if segments and cfg.labels_dir is not None:
            # outcome plane: pin the mode + label-segment set durably
            # before training — the decision survives a mid-retrain kill
            plan = self._cycle_plan(segments)
            mode = plan["mode"]
            if mode == "outcome":
                label_dirs = [os.path.join(cfg.labels_dir, b)
                              for b in plan["label_segments"]]
                pipe = Pipeline.from_labeled_capture(
                    segments, label_dirs, seed=cfg.seed)
            else:
                pipe = Pipeline.from_capture(segments, seed=cfg.seed)
            rows = pipe.num_samples
        elif segments:
            pipe = Pipeline.from_capture(segments, seed=cfg.seed)
            rows = pipe.num_samples
        if not segments or rows < cfg.min_rows:
            self.last_consumed = []
            self.last_mode = None
            return None
        est = self.build_estimator()
        est.set_checkpoint(cfg.checkpoint_dir, keep_last=cfg.keep_last,
                           asynchronous=False)
        # mid-epoch cadence for kill→resume granularity, plus the
        # epoch-end save — the candidate must include the final
        # iteration's update, not stop at the last cadence boundary
        trigger = _MidRetrainKill(Or(SeveralIteration(cfg.checkpoint_every),
                                     EveryEpoch()))
        est.train(pipe, self.criterion, checkpoint_trigger=trigger,
                  batch_size=cfg.batch_size, auto_resume=True)
        # the candidate is the newest COMMITTED step — train() drained
        # its checkpoint queue, so this is the epoch-end save
        step = self.incumbent_step()
        if step is None:  # pragma: no cover — set_checkpoint guarantees one
            raise RuntimeError("retrain committed no checkpoint")
        consumed = self.consumed_segments()
        consumed.update(os.path.basename(s) for s in segments)
        self._commit_state(consumed, step, mode=mode)
        if cfg.labels_dir is not None:
            self._clear_plan()
        self.last_consumed = list(segments)
        self.last_mode = mode if cfg.labels_dir is not None else None
        self.metrics["rows_trained"].inc(rows)
        self.metrics["candidate_step"].set(step)
        return step

    def discard_candidates_after(self, step: Optional[int]) -> List[str]:
        """Delete committed checkpoints newer than ``step`` (rollback
        cleanup: the next cycle must warm-start from the incumbent, not
        the rejected candidate). ``None`` keeps nothing. Returns the
        removed paths."""
        removed = []
        for s, path in atomic.committed_checkpoints(
                self.config.checkpoint_dir):
            if step is None or s > step:
                shutil.rmtree(path, ignore_errors=True)
                removed.append(path)
        return removed
