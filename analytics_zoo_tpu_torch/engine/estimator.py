"""The training engine (port of ``analytics_zoo_tpu.engine.estimator``, the
per-step path with checkpoints, summaries and gradient accumulation).

    train step = grad(masked per-sample loss + regularization)
                 -> zero frozen grads -> clip -> optimizer -> add updates

Master weights stay float32 on the device. With a model ``compute_dtype``
("bfloat16") the forward casts them inside the autograd graph, so the
gradients that reach the optimizer are float32, as the JAX package's
``_cast_for_compute`` inside ``grad`` gives. The loop is the JAX package's
per-step path: the epoch order comes from ``seed=epoch``, the wrap-padded
tail batch is masked out of the loss, triggers see the same ``RunState``
bookkeeping, and validation runs at each epoch end. PyTorch runs eagerly,
so there is no jit, no step cache and no fused epoch or scan dispatch.

Losses stay on the device: the host reads them once per epoch (or every
step when a trigger reads the loss, as ``MinLoss`` does), so the loop adds
no host sync per step; that read is the drain at which the train summary
records each step's ``Loss`` and the ``Throughput`` since the last drain.
Host batches are copied to the device (``host_to_device``: float64 made
float32, never an alias of the caller's arrays); a feature set's
``device_transform`` runs on the device batch before the cast. The model
state (batch norm's moving statistics) threads through the steps, and
whenever the trained state changes hands (the end of ``train``, a loaded
checkpoint or weights) it is written back to ``model.params`` and
``model.model_state``, where ``InferenceModel.do_load_keras`` and a later
``Estimator`` find them. The state is built outside inference mode, even
when ``evaluate`` or ``predict`` builds it, so that it trains later.

Checkpoints (``set_checkpoint``, ``model_dir``) go through
:class:`~analytics_zoo_tpu_torch.ft.manager.CheckpointManager` at the
``checkpoint_trigger`` (every epoch by default; a mid-epoch trigger fires
after its step) and carry the whole TrainState, the epoch, iteration and
in-epoch step, and the position of the step generator (the dropout
stream), so that ``train(..., auto_resume=True)`` replays the epoch order,
skips the batches already taken and continues bitwise. A flagged
preemption saves, then raises ``PreemptedError``.

A streaming :class:`~analytics_zoo_tpu_torch.data.pipeline.Pipeline` is
taken directly: its batches come from ``device_batches`` (the infeed
thread is its ``.prefetch(k)`` depth, consumer waits feed the
``zoo_data_*`` gauges), a resumed epoch starts the stream at its O(1)
position (``start_step``, no skipped batch is assembled), and every
checkpoint carries the stream position (``metadata["pipeline"]``).

Observability: each drain feeds the training metric families
(``zoo_train_steps_total``, ``zoo_train_step_seconds``,
``zoo_train_items_per_sec``). ``set_profile`` traces a window of steps of
the next ``train`` with ``torch.profiler`` (CUDA activity on the card, CPU
activity on the CPU) into ``log_dir`` and records the window as a
``train.profiler_window`` host span. ``set_step_watchdog`` arms a stall
detector over the iteration counter. Steps are launched asynchronously,
so the counter advances when a step is enqueued, not when it finishes: a
hung card stalls the loop at its next host read, which is the epoch's
loss read (``torch.stack(losses).tolist()``), a loss-reading trigger's
``loss.item()`` every step, a checkpoint's host snapshot, a device-cached
set's index upload, or a launch once CUDA's launch queue is full. The
watchdog is paused around the epoch-end checkpoint and validation, and
around a preemption's save.

Multi-host data-parallel training (``train_distributed``) runs N host
processes in lockstep through :mod:`analytics_zoo_tpu_torch.ft.distributed`:
each host takes its rows of every global batch, the hosts exchange
gradient sums through a filesystem rendezvous, each updates its window of
the flat parameter vector and the windows are exchanged back; checkpoints
are two-phase sharded commits. ``zero1=True`` is accepted: a step runs
on the context's device, with nothing to shard, so its trajectory is the
plain one, as the JAX package's is on a one-device mesh. A context mesh
(``init_nncontext(mesh_shape=...)``) reaches training through the layers
(``sequence_parallel`` attention over its ``seq`` slots).

Pipeline-parallel training (``train_pipelined``) splits the layer stack
into stages by a :class:`~analytics_zoo_tpu_torch.pipeline.plan.StagePlan`
and streams microbatches through them on a 1F1B or GPipe schedule
(:mod:`analytics_zoo_tpu_torch.pipeline.trainer`), with stage-owned
two-phase sharded checkpoints.

Not ported yet: data and tensor parallelism of ``train`` over the slots of
an in-process mesh (ROADMAP A7).
"""

from __future__ import annotations

import itertools
import logging
import os
import sys
import threading
import time
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.nncontext import (
    get_nncontext,
    host_to_device,
)
from analytics_zoo_tpu_torch.common.observability import (
    get_tracer,
    monotonic_s,
    training_metrics,
)
from analytics_zoo_tpu_torch.common.tree import (
    jax_leaf_order,
    tree_leaves,
    tree_map,
    tree_paths,
    tree_unflatten,
)
from analytics_zoo_tpu_torch.engine import checkpoint as ckpt_lib
from analytics_zoo_tpu_torch.engine import triggers as trig
from analytics_zoo_tpu_torch.engine.summary import (
    TrainSummary,
    ValidationSummary,
)
from analytics_zoo_tpu_torch.ft.atomic import (
    CheckpointCorruptError,
    CheckpointError,
)
from analytics_zoo_tpu_torch.keras import metrics as metrics_lib
from analytics_zoo_tpu_torch.keras import objectives as objectives_lib
from analytics_zoo_tpu_torch.keras.optimizers import GradientTransformation

logger = logging.getLogger("analytics_zoo_tpu_torch")


def _uses_loss(trigger) -> bool:
    """True if the trigger may read RunState.loss — those runs need the loss
    fetched synchronously each step. Built-in iteration/epoch triggers are
    known loss-free; unknown custom triggers count as loss-reading unless
    they set ``reads_loss = False``."""
    reads = getattr(trigger, "reads_loss", None)
    if reads is not None:
        return bool(reads)
    if isinstance(trigger, trig.MinLoss):
        return True
    subs = getattr(trigger, "triggers", None)
    if subs is not None:
        return any(_uses_loss(t) for t in subs)
    return not isinstance(trigger, (trig.MaxEpoch, trig.MaxIteration,
                                    trig.EveryEpoch, trig.SeveralIteration,
                                    trig.MaxScore))


def _closing(stream, batches):
    """Iterate ``batches`` and close ``stream`` however the loop ends (a
    trigger's break, a raise): a pipeline's prefetch thread and worker
    pool stop at once instead of at garbage collection."""
    try:
        yield from batches
    finally:
        stream.close()


def _round_batch(batch_size: int, n_data: int) -> int:
    """The sharded-batch contract: the global batch divides across the
    data axis; rounded up (the wrap-padded rows are masked)."""
    rounded = -(-batch_size // n_data) * n_data
    if rounded != batch_size:
        logger.info("batch_size %d rounded up to %d (data axis = %d shards)",
                    batch_size, rounded, n_data)
    return rounded


def _jax_flatten(tree) -> list:
    """``engine.checkpoint.flatten`` in JAX's leaf order (dict keys
    sorted): the order in which the JAX package assigns a sharded
    checkpoint's leaves to hosts."""
    flat = ckpt_lib.flatten(tree)
    return [flat[i] for i in jax_leaf_order(tree)]


def _host_stat(t):
    """A metric's summed statistic on the host: a float, or an array
    for a metric with a vector of partial sums (AUC's bins)."""
    if t is None:
        return 0.0
    return t.item() if t.numel() == 1 else t.cpu().numpy()


def _masked_mean(ps, mask):
    """Mean of a per-sample loss over the valid (mask 1) rows, and the
    number of rows it averages (the accumulation weight)."""
    if mask is None:
        return ps.mean(), torch.tensor(float(ps.shape[0]), device=ps.device)
    count = mask.sum()
    return (ps * mask).sum() / torch.clamp_min(count, 1.0), count


def _loss_sum(losses, y, mask):
    """The distributed and pipelined steps' loss contract: ``(sum of the
    valid rows' per-sample losses, valid-row count)``; a scalar-only
    criterion's batch mean counts as exact over every row."""
    if losses.dim():
        return (losses * mask).sum(), mask.sum().float()
    rows = float(tree_leaves(y)[0].shape[0])
    return losses * rows, torch.tensor(rows, device=losses.device)


def _dense_grads(grads, leaves, trainable):
    """``torch.autograd.grad``'s list with an unused leaf's None as zeros
    and, where ``trainable`` (a bool per leaf) is given, frozen leaves'
    grads zeroed: BEFORE the transform, so they neither inflate the clip
    norm nor feed moments."""
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    if trainable is not None:
        grads = [g if t else torch.zeros_like(g)
                 for g, t in zip(grads, trainable)]
    return grads


def _clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm: scale every gradient by
    ``max_norm / norm`` when the global L2 norm is at least ``max_norm``
    (decided on the device, no host read)."""
    norm = torch.sqrt(sum((g * g).sum() for g in tree_leaves(grads)))
    return tree_map(lambda g: torch.where(norm < max_norm, g,
                                          (g / norm) * max_norm), grads)


class _AccumTx(NamedTuple):
    """init/update pair of count-weighted gradient accumulation: the
    ``update`` takes the micro-batch's valid-sample count as an extra
    argument, and returns None updates on the micro-steps that apply
    nothing."""
    init: Callable
    update: Callable


def count_weighted_accumulation(tx: GradientTransformation,
                                k: int) -> _AccumTx:
    """Gradient accumulation over K micro-batches, each micro-batch
    gradient weighted by its number of valid (non-wrap-pad) samples, so
    every window, the masked tail of an epoch included, applies exactly
    ``sum_i(n_i * g_i) / sum_i(n_i)``: the gradient of the concatenated
    big batch. The state is the JAX package's tuple (inner state,
    accumulator, f32 sample count, micro-step); the micro-step is a host
    int, so deciding to apply reads nothing from the device."""
    def init(params):
        acc = tree_map(torch.zeros_like, params)
        device = tree_leaves(params)[0].device
        return (tx.init(params), acc, torch.zeros((), device=device), 0)

    def update(grads, state, params, count):
        inner, acc, acc_n, mini = state
        acc = tree_map(lambda a, g: a + count * g, acc, grads)
        acc_n = acc_n + count
        if mini + 1 < k:
            return None, (inner, acc, acc_n, mini + 1)
        mean = tree_map(lambda a: a / torch.clamp_min(acc_n, 1.0), acc)
        updates, inner = tx.update(mean, inner, params)
        return updates, (inner, tree_map(torch.zeros_like, acc),
                         torch.zeros_like(acc_n), 0)

    return _AccumTx(init, update)


def _generator_state(gen: torch.Generator) -> str:
    """A generator's position as JSON-safe text (hex of ``get_state()``:
    16 bytes on a CUDA generator, the Mersenne Twister's 5056 on the
    CPU)."""
    return gen.get_state().numpy().tobytes().hex()


class _StepWatchdog:
    """Daemon thread asserting that the train loop's iteration counter
    advances at least every ``timeout_s``: the stall detector behind
    ``Estimator.set_step_watchdog``. Fires once per stall episode (re-arms
    when progress resumes): a CRITICAL log, a faulthandler thread dump
    (it shows the Python frame blocked on the hung call) and the optional
    callback."""

    def __init__(self, run_state, timeout_s: float,
                 on_stall: Optional[Callable], clock=time.monotonic):
        self.run_state = run_state
        self.timeout_s = timeout_s
        self.on_stall = on_stall
        self._clock = clock
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_it, self._last_t = run_state.iteration, clock()
        self._fired = False

    def start(self):
        self._last_it, self._last_t = self.run_state.iteration, self._clock()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="azoo-step-watchdog")
        self._thread.start()
        return self

    def pause(self):
        """Suspend stall detection around phases that take no step
        (validation, checkpoint writes): the counter does not advance
        there and must not alarm."""
        self._paused.set()

    def resume(self):
        self._paused.clear()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _run(self):
        poll = max(0.5, self.timeout_s / 4.0)
        while not self._stop.wait(poll):
            self.poll_once()

    def poll_once(self) -> bool:
        """One look at the counter, at ``clock()``: re-arms the window on
        progress (and while paused), fires once per stall episode. Returns
        whether it fired."""
        now = self._clock()
        if self._paused.is_set():
            self._last_t = now  # re-arm the window on resume
            return False
        it = self.run_state.iteration
        if it != self._last_it:
            self._last_it, self._last_t, self._fired = it, now, False
            return False
        if self._fired or now - self._last_t < self.timeout_s:
            return False
        self._fired = True
        logger.critical(
            "training stalled: no step completed for %.0fs (iteration "
            "stuck at %d) — likely a hung device call; thread dump "
            "follows", self.timeout_s, it)
        try:
            import faulthandler

            faulthandler.dump_traceback(file=sys.stderr)
        except Exception:  # noqa: BLE001 - diagnostics only
            pass
        if self.on_stall is not None:
            try:
                self.on_stall(self.run_state)
            except Exception:  # noqa: BLE001 - the detector must live
                logger.exception("step-watchdog on_stall callback failed")
        return True


class _ProfileWindow:
    """``set_profile``'s window: a ``torch.profiler`` trace of steps
    ``[start, start + num)`` of one ``train`` call (counted from 0 in that
    call), written under ``log_dir`` as a ``*.pt.trace.json`` that
    :mod:`~analytics_zoo_tpu_torch.common.trace_tools` reads. CUDA
    activity on the card (the card is synchronised before the trace
    stops, so the window's kernels are in it), CPU activity on the CPU."""

    def __init__(self, log_dir: str, start: int, num: int, device):
        self.log_dir, self.start, self.num = log_dir, start, num
        self.device = device
        self.started = self.done = False
        self._prof = None
        self._t0 = 0.0

    def tick(self, steps: int) -> None:
        """Called before each step with the steps this call has taken."""
        if self.done:
            return
        if not self.started and steps >= self.start:
            from torch.profiler import (
                ProfilerActivity,
                profile,
                tensorboard_trace_handler,
            )

            acts = ([ProfilerActivity.CUDA] if self.device.type == "cuda"
                    else [ProfilerActivity.CPU])
            self._prof = profile(
                activities=acts,
                on_trace_ready=tensorboard_trace_handler(self.log_dir))
            self._prof.start()
            self.started = True
            self._t0 = monotonic_s()
        elif self.started and steps >= self.start + self.num:
            self.stop()

    def stop(self) -> None:
        """End the trace (also when a step raised inside the window)."""
        if not self.started or self.done:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        self.done = True
        tracer = get_tracer()
        if tracer.enabled:
            # the device-trace window as one host span, so the Perfetto
            # view shows where the profiler dump sits in the run
            tracer.record_span("train.profiler_window",
                               tracer.current_trace_id() or "train",
                               self._t0, monotonic_s(), log_dir=self.log_dir)
        logger.info("Profiler trace written to %s", self.log_dir)
        try:  # diagnostics only: never fail training over a parse
            from analytics_zoo_tpu_torch.common.trace_tools import top_ops

            plane = "GPU" if self.device.type == "cuda" else "CPU"
            for name, ms, count in top_ops(self.log_dir, line="",
                                           plane_substr=plane, n=5):
                logger.info("  top op %8.2f ms x%-5d %s", ms, count,
                            name[:80])
        except Exception as e:  # noqa: BLE001
            logger.debug("trace summary unavailable: %s", e)


class TrainState(NamedTuple):
    params: Any
    model_state: Any
    opt_state: Any
    step: int


class Estimator:
    """Uniform train/evaluate/predict facade over a model that implements
    ``ensure_params``/``params``, ``apply(params, state, x, training, rng)``,
    ``layers()`` and ``regularization(params)`` (``KerasNet`` does).

    ``zero1=True`` (ZeRO-1: optimizer moments sharded over the data axis)
    is accepted and shards nothing: the port's data axis is one device, so
    the trajectory is the plain one, as the JAX package's is on a
    one-device mesh; ``train_distributed`` refuses it, its sharded update
    already keeping 1/N of the optimizer state per host."""

    # True: each train step also records the host seconds spent producing
    # its batch (``batch_seconds``) and, on the card, a CUDA event after
    # the step's launch (``step_events``), without a host sync. Set on the
    # class, it reaches the estimators that nnframes, tfpark and
    # ``KerasNet`` create.
    time_steps = False

    def __init__(self, model, optim_method: Optional[
                     GradientTransformation] = None,
                 model_dir: Optional[str] = None, zero1: bool = False,
                 gradient_accumulation: int = 1):
        self.model = model
        self.zero1 = bool(zero1)  # see the class docstring
        self.optim_method = optim_method
        # K > 1: apply the optimizer every Kth micro-batch on the
        # count-weighted mean of the K gradients (count_weighted_accumulation);
        # each micro-batch still counts as one iteration
        self.gradient_accumulation = int(gradient_accumulation)
        if self.gradient_accumulation < 1:
            raise ValueError(f"gradient_accumulation must be >= 1, got "
                             f"{gradient_accumulation}")
        self.ctx = get_nncontext()
        self._clip_constant = None
        self._clip_l2norm: Optional[float] = None
        self._checkpoint_path: Optional[str] = model_dir
        self._checkpoint_overwrite = True
        self._ckpt_keep_last: Optional[int] = None
        self._ckpt_keep_every: Optional[int] = None
        self._ckpt_async = True
        self._ckpt_manager = None  # lazy ft.manager.CheckpointManager
        self._preemption = None    # armed ft.preemption.PreemptionHandler
        # streaming-pipeline state: the Pipeline train() is consuming (its
        # stream position rides along in checkpoint metadata), and a
        # restored position waiting for the next train() to validate
        self._active_train_set = None
        self._restored_data_state = None
        self.train_summary: Optional[TrainSummary] = None
        self.val_summary: Optional[ValidationSummary] = None
        self.tstate: Optional[TrainState] = None
        self.run_state = trig.RunState()
        # every step's loss, in order (read at epoch ends): the series the
        # train summary records as "Loss"
        self.train_losses: List[float] = []
        self.batch_seconds: List[float] = []
        self.step_events: List[Any] = []
        self._profile: Optional[tuple] = None
        self._watchdog: Optional[tuple] = None
        # with time_steps, train_distributed's per-step host seconds on a
        # multi-host run: {"compute", "exchange", "update"}
        self.dist_timings: List[dict] = []

    # -- configuration ---------------------------------------------------

    def set_constant_gradient_clipping(self, min_value: float,
                                       max_value: float):
        """Clip every gradient coordinate to [min_value, max_value]."""
        self._clip_constant = (float(min_value), float(max_value))
        self._clip_l2norm = None
        return self

    def set_l2_norm_gradient_clipping(self, clip_norm: float):
        """Scale gradients so the global L2 norm stays under ``clip_norm``."""
        self._clip_l2norm = float(clip_norm)
        self._clip_constant = None
        return self

    def clear_gradient_clipping(self):
        """Remove any configured gradient clipping."""
        self._clip_constant = None
        self._clip_l2norm = None
        return self

    def set_checkpoint(self, path: str, overwrite: bool = True,
                       keep_last: Optional[int] = None,
                       keep_every: Optional[int] = None,
                       asynchronous: bool = True):
        """Write ``ckpt_N`` checkpoints under ``path`` (N the iteration)
        at the ``checkpoint_trigger`` of ``train`` (every epoch by
        default). The host snapshot is taken at the trigger; the
        serialization and the atomic commit run on a background writer
        (``asynchronous=False`` blocks instead). ``keep_last`` and
        ``keep_every`` sweep old checkpoints (keep the N newest, and every
        one whose iteration is a multiple of M); the default keeps all."""
        if self._ckpt_manager is not None:
            self._ckpt_manager.close()
            self._ckpt_manager = None
        self._checkpoint_path = path
        self._checkpoint_overwrite = overwrite
        self._ckpt_keep_last = keep_last
        self._ckpt_keep_every = keep_every
        self._ckpt_async = asynchronous
        return self

    def set_preemption_handler(self, handler=None):
        """Arm save-then-exit preemption: ``train`` checks the handler's
        flag at every step boundary and, once flagged, writes a checkpoint
        (when ``set_checkpoint`` is configured), waits until it is
        committed and raises
        :class:`~analytics_zoo_tpu_torch.ft.preemption.PreemptedError`.
        ``handler=None`` creates and installs one (main thread only)."""
        from analytics_zoo_tpu_torch.ft.preemption import PreemptionHandler

        if handler is None:
            handler = PreemptionHandler().install()
        self._preemption = handler
        return self

    def set_tensorboard(self, log_dir: str, app_name: str):
        """Attach TrainSummary/ValidationSummary writers under
        ``log_dir/app_name``."""
        self.train_summary = TrainSummary(log_dir, app_name)
        self.val_summary = ValidationSummary(log_dir, app_name)
        return self

    def set_step_watchdog(self, timeout_s: float,
                          on_stall: Optional[Callable] = None):
        """Arm a training-loop stall detector. While ``train()`` runs, a
        daemon thread checks that the iteration counter advances at least
        every ``timeout_s`` seconds; on a stall it logs CRITICAL with a
        thread dump (faulthandler) showing the Python frame the loop is
        blocked in, and calls ``on_stall(run_state)`` if given (to alert,
        checkpoint elsewhere, or ``os._exit`` for a supervisor restart).
        It fires once per stall and re-arms when steps resume. Steps are
        launched asynchronously, so a hung card stalls the loop at its
        next host read (see the module docstring). Detection only: the
        stuck native call cannot be interrupted from Python.
        ``timeout_s=0`` disarms."""
        self._watchdog = (float(timeout_s), on_stall) if timeout_s else None
        return self

    def set_profile(self, log_dir: str, start_iteration: int = 2,
                    num_iterations: int = 3):
        """Trace ``num_iterations`` steps of the next ``train()``,
        beginning at its step ``start_iteration`` (the first steps, which
        build kernels and the cuBLAS workspace, are skipped by default),
        with ``torch.profiler`` into ``log_dir`` (a ``*.pt.trace.json``
        that TensorBoard, Perfetto and
        :mod:`~analytics_zoo_tpu_torch.common.trace_tools` read). One-shot:
        call again for another trace."""
        self._profile = (log_dir, int(start_iteration), int(num_iterations))
        return self

    def train_pipelined(self, train_set, criterion: Callable, stage_plan,
                        num_microbatches: int = 1, schedule: str = "1f1b",
                        end_trigger: Optional[trig.Trigger] = None,
                        checkpoint_trigger: Optional[trig.Trigger] = None,
                        batch_size: int = 32,
                        auto_resume: bool = False) -> "Estimator":
        """Pipeline-parallel training: ``stage_plan`` (a
        :class:`~analytics_zoo_tpu_torch.pipeline.plan.StagePlan`)
        partitions the layer stack into K stages, each run as its own
        program, and a microbatch schedule (``"1f1b"`` or ``"gpipe"``)
        streams ``num_microbatches`` slices of every global batch through
        them. Checkpoints are stage-owned two-phase sharded commits in the
        JAX package's format; ``auto_resume=True`` restores the newest
        committed one bitwise, also after a mid-schedule kill. See
        :mod:`analytics_zoo_tpu_torch.pipeline.trainer` for the parity
        contract."""
        from analytics_zoo_tpu_torch.pipeline import trainer

        return trainer.train_pipelined(
            self, train_set, criterion, stage_plan,
            num_microbatches=num_microbatches, schedule=schedule,
            end_trigger=end_trigger, checkpoint_trigger=checkpoint_trigger,
            batch_size=batch_size, auto_resume=auto_resume)

    def _tx(self):
        if self.optim_method is None:
            raise RuntimeError("No optimizer set — call compile(optimizer, "
                               "loss) before training")
        tx = self.optim_method
        if self._clip_constant is not None:
            lo, hi = self._clip_constant

            def clip(grads):
                return tree_map(lambda g: torch.clamp(g, lo, hi), grads)
        elif self._clip_l2norm is not None:
            max_norm = self._clip_l2norm

            def clip(grads):
                return _clip_by_global_norm(grads, max_norm)
        else:
            clip = None
        if clip is not None:
            opt = tx

            def clipped(grads, state, params=None):
                return opt.update(clip(grads), state, params)

            if hasattr(opt.update, "optax_leaves"):
                # optax's clip transforms keep no state; the JAX package
                # chains the clip first, so the optimizer's own state sits
                # at chain index 1
                clipped.optax_leaves = opt.update.optax_leaves
                clipped.optax_paths = tuple(
                    "1/" + p for p in opt.update.optax_paths)
            tx = GradientTransformation(opt.init, clipped)
        if self.gradient_accumulation > 1:
            # clipping applies to the window's mean gradient, as in the
            # big-batch run
            tx = count_weighted_accumulation(tx, self.gradient_accumulation)
        return tx

    # -- state -----------------------------------------------------------

    def _init_opt_state(self, params):
        # outside inference mode, as in _ensure_state
        with torch.inference_mode(False):
            return self._tx().init(params)

    def _ensure_state(self):
        """The train state from the model's parameters (drawn from the
        context's generator if it has none), copied to the device as
        float32 master weights. Built outside inference mode even when
        ``evaluate`` or ``predict`` builds it: inference tensors could
        never be trained."""
        if self.tstate is None:
            with torch.inference_mode(False):
                self.model.ensure_params()
                dev = self.ctx.device
                params, state = (
                    tree_map(lambda t: t.detach().to(dev, copy=True), tree)
                    for tree in (self.model.params,
                                 self.model.model_state or {}))
                opt_state = (self._init_opt_state(params)
                             if self.optim_method is not None else None)
                self.tstate = TrainState(params, state, opt_state, 0)

    def _write_back(self) -> None:
        """Hand the estimator's parameters and state to the model."""
        self.model.params = self.tstate.params
        self.model.model_state = self.tstate.model_state

    def reset_optimizer(self, optim_method: GradientTransformation) -> None:
        """Swap the optimizer, rebuilding its state for the current params
        (a compile() after training)."""
        if self.run_state.iteration > 0:
            logger.warning(
                "reset_optimizer after %d iterations: the optimizer state is "
                "reinitialized (compile first, then resume)",
                self.run_state.iteration)
        self.optim_method = optim_method
        if self.tstate is not None:
            self.tstate = self.tstate._replace(
                opt_state=self._init_opt_state(self.tstate.params))

    def resume_from_checkpoint(self, directory: Optional[str] = None) -> bool:
        """Restore the newest committed checkpoint under ``directory``
        (default: the ``set_checkpoint`` directory), falling back past a
        corrupt one; False when there is none. Training then continues at
        the recorded epoch, iteration and in-epoch step."""
        d = directory or self._checkpoint_path
        if not d:
            raise ValueError(
                "no checkpoint directory: pass one or call set_checkpoint")
        if self.optim_method is None:
            # a later compile() would reinitialize the restored moments
            raise RuntimeError(
                "resume_from_checkpoint before an optimizer is set: call "
                "compile()/set the optimizer FIRST, then resume (compiling "
                "afterwards would reinitialize the restored optimizer state)")
        candidates = ckpt_lib.committed_checkpoints(d)
        if not candidates:
            return False
        last_err = None
        for _step, path in reversed(candidates):
            try:
                self.load_checkpoint(path)
            except CheckpointCorruptError as e:
                logger.warning("checkpoint %s is corrupt (%s): trying the "
                               "previous committed one", path, e)
                last_err = e
                continue
            logger.info("Resumed from %s (epoch %d, iteration %d, "
                        "epoch_step %d)", path, self.run_state.epoch,
                        self.run_state.iteration, self.run_state.epoch_step)
            return True
        raise CheckpointError(
            f"every checkpoint under {d!r} is corrupt") from last_err

    def load_checkpoint(self, path: str):
        """Restore the params, model state, optimizer state, step, run
        counters and step-generator position from a ``ckpt_N``
        checkpoint."""
        saved_k = ckpt_lib.peek_metadata(path).get("gradient_accumulation")
        if saved_k is not None and int(saved_k) != self.gradient_accumulation:
            raise ValueError(
                f"Checkpoint at {path!r} was saved with "
                f"gradient_accumulation={saved_k}, but this Estimator was "
                f"built with gradient_accumulation="
                f"{self.gradient_accumulation}; the optimizer states are "
                f"incompatible. Rebuild the Estimator with "
                f"gradient_accumulation={saved_k} to restore it.")
        self._ensure_state()
        restored, meta = ckpt_lib.load_checkpoint(path, self.tstate)
        dev = self.ctx.device
        with torch.inference_mode(False):
            self.tstate = tree_map(
                lambda a, cur: int(a) if isinstance(cur, int)
                else torch.tensor(a, device=dev), restored, self.tstate)
        self._write_back()
        rs = self.run_state
        rs.epoch = int(meta.get("epoch", 0))
        rs.iteration = int(meta.get("iteration", 0))
        # the in-epoch offset and the dropout stream: with both, the resumed
        # run takes the uninterrupted run's batches and draws
        rs.epoch_step = int(meta.get("epoch_step", 0))
        self._restore_step_generator(meta, path)
        # a streamed run's checkpoint carries the pipeline's stream
        # position, held until the next train() has the Pipeline object to
        # validate it against (load_state_dict rejects a stream-shape
        # mismatch)
        self._restored_data_state = meta.get("pipeline")
        return self

    def _restore_step_generator(self, meta: dict, path: str) -> None:
        """Put the step generator (the dropout stream) where checkpoint
        ``path`` saved it, when it did."""
        if "step_generator" not in meta:
            return
        state = torch.tensor(list(bytes.fromhex(meta["step_generator"])),
                             dtype=torch.uint8)
        try:
            self.ctx.step_generator.set_state(state)
        except RuntimeError as e:
            logger.warning("checkpoint %s: the step generator's position "
                           "was saved on another device type (%s); the "
                           "dropout stream restarts", path, e)

    def _cast_for_compute(self, tree):
        """Mixed precision: float32 leaves cast to the model's compute
        dtype. Called on the graph's leaves, so gradients come back
        float32."""
        cd = getattr(self.model, "compute_dtype", None)
        if not cd:
            return tree
        dt = getattr(torch, cd)
        return tree_map(lambda t: t.to(dt) if isinstance(t, torch.Tensor)
                        and t.dtype == torch.float32 else t, tree)

    def _update_mask(self, params):
        """Tree of bools matching ``params``: False = frozen (layer- or
        weight-level ``trainable``). None when everything is trainable."""
        if not hasattr(self.model, "layers"):
            return None
        layer_by_name = {l.name: l for l in self.model.layers()}

        def mask_layer(lname, sub):
            layer = layer_by_name.get(lname)
            if layer is None:
                return tree_map(lambda _: True, sub)
            if not getattr(layer, "trainable", True):
                return tree_map(lambda _: False, sub)
            spec_tr = {s.name: s.trainable for s in layer.weight_specs}
            return {k: (tree_map(lambda _, t=spec_tr.get(k, True): t, v)
                        if isinstance(v, dict) else spec_tr.get(k, True))
                    for k, v in sub.items()}

        mask = {lname: mask_layer(lname, sub) for lname, sub in params.items()}
        if all(tree_leaves(mask)):
            return None
        return mask

    # -- the train step --------------------------------------------------

    def _make_forward(self, criterion: Callable,
                      device_transform: Optional[Callable] = None,
                      apply: Optional[Callable] = None) -> Callable:
        """``forward(params, model_state, xs, y, per_sample, rng) ->
        (losses, new_model_state)``: the training forward
        (``device_transform`` first) and the criterion, the one loss
        contract of the plain, the distributed and the pipelined step.
        ``losses`` is a per-sample vector when ``per_sample`` and the
        criterion has a per-sample form, or when the criterion returns rows
        (each averaged to one value); else the criterion's scalar.
        ``apply(params, model_state, xs, rng) -> (pred, new_state)``
        replaces the whole model's cast forward (the pipelined trainer's
        last stage)."""
        model, cast = self.model, self._cast_for_compute
        ps_criterion = objectives_lib.get_per_sample(criterion)
        if apply is None:
            def apply(params, model_state, xs, rng):
                return model.apply(cast(params), model_state, cast(xs),
                                   training=True, rng=rng)

        def forward(params, model_state, xs, y, per_sample, rng):
            if device_transform is not None:
                xs = device_transform(xs)
            pred, new_state = apply(params, model_state, xs, rng)
            if isinstance(pred, torch.Tensor):
                # a multi-output model's list stays as it is, as in the
                # JAX package
                pred = pred.float()
            if per_sample and ps_criterion is not None:
                return ps_criterion(y, pred), new_state
            raw = criterion(y, pred)
            if raw.dim():
                return raw.reshape(raw.shape[0], -1).mean(dim=-1), new_state
            return raw, new_state

        return forward

    def _make_train_step(self, criterion: Callable,
                         device_transform: Optional[Callable] = None
                         ) -> Callable:
        """``step(tstate, xs, y, mask) -> (tstate, device loss)``: forward
        (``device_transform`` first), backward and update."""
        tx = self._tx()
        accumulate = self.gradient_accumulation > 1
        model = self.model
        generator = self.ctx.step_generator
        forward = self._make_forward(criterion, device_transform)
        update_mask = self._update_mask(self.tstate.params)
        trainable = (None if update_mask is None
                     else tree_leaves(update_mask))

        def loss_fn(params, model_state, xs, y, mask):
            # wrap-pad duplicates get zero loss weight
            losses, new_state = forward(params, model_state, xs, y,
                                        mask is not None, generator)
            if losses.dim():
                loss, count = _masked_mean(losses, mask)
            else:
                loss, count = losses, torch.tensor(
                    float(tree_leaves(y)[0].shape[0]), device=losses.device)
            return loss + model.regularization(params), new_state, loss, count

        def step(tstate: TrainState, xs, y, mask):
            leaves = [t.detach().requires_grad_(True)
                      for t in tree_leaves(tstate.params)]
            with torch.enable_grad():
                total, new_mstate, loss, count = loss_fn(
                    tree_unflatten(tstate.params, leaves),
                    tstate.model_state, xs, y, mask)
                grads = torch.autograd.grad(total, leaves, allow_unused=True)
            with torch.no_grad():
                grads = tree_unflatten(tstate.params,
                                       _dense_grads(grads, leaves, trainable))
                if accumulate:
                    updates, new_opt = tx.update(grads, tstate.opt_state,
                                                 tstate.params, count)
                else:
                    updates, new_opt = tx.update(grads, tstate.opt_state,
                                                 tstate.params)
                new_params = tstate.params
                if updates is not None:  # None: a micro-step of a window
                    updates = tree_leaves(updates)
                    if trainable is not None:
                        updates = [u if t else torch.zeros_like(u)
                                   for u, t in zip(updates, trainable)]
                    # one multi-tensor add over every leaf, the
                    # arithmetic of p + u per leaf
                    new_params = tree_unflatten(tstate.params, list(
                        torch._foreach_add(tree_leaves(tstate.params),
                                           updates)))
            return (TrainState(new_params, new_mstate, new_opt,
                               tstate.step + 1), loss.detach())

        return step

    # -- batches ---------------------------------------------------------

    def _to_device(self, tree):
        dev = self.ctx.device
        return tree_map(lambda a: host_to_device(a, dev), tree)

    def _batches(self, data, batch_size: int, epoch: Optional[int],
                 skip: int = 0):
        """Device (x, y, mask) batches: training order for ``epoch``, or
        dataset order when ``epoch`` is None, without the first ``skip``
        (a resumed epoch's batches already taken). A device-cached set
        gathers on the device from the host's index vector; a streaming
        pipeline's training epoch comes from its ``device_batches``,
        started at the stream position ``skip``."""
        dev = self.ctx.device
        if epoch is not None and hasattr(data, "device_batches"):
            yield from data.device_batches(batch_size, shuffle=True,
                                           seed=epoch, start_step=skip)
            return
        gather = getattr(data, "gather", None)
        if gather is not None:
            index_batches = (data.eval_index_batches(batch_size)
                             if epoch is None else data.train_index_batches(
                                 batch_size, shuffle=True, seed=epoch))
            for idx, mask in itertools.islice(index_batches, skip, None):
                x, y = gather(torch.tensor(idx, device=dev))
                yield x, y, torch.tensor(mask, device=dev)
            return
        host = (data.eval_batches(batch_size) if epoch is None
                else data.train_batches(batch_size, shuffle=True, seed=epoch))
        for x, y, mask in itertools.islice(host, skip, None):
            yield self._to_device(x), self._to_device(y), torch.tensor(
                mask, device=dev)

    def _timed(self, batches):
        """``batches``, recording the host seconds each took to produce."""
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                return
            self.batch_seconds.append(time.perf_counter() - t0)
            yield batch

    # -- training loop ---------------------------------------------------

    def train(self, train_set, criterion: Callable,
              end_trigger: Optional[trig.Trigger] = None,
              checkpoint_trigger: Optional[trig.Trigger] = None,
              validation_set=None,
              validation_method: Optional[Sequence] = None,
              batch_size: int = 32,
              validation_batch_size: Optional[int] = None,
              auto_resume: bool = False) -> "Estimator":
        """Train until ``end_trigger`` (default: one more epoch) over a
        :class:`~analytics_zoo_tpu_torch.data.feature_set.FeatureSet`
        (host arrays, or a device-cached set), checkpointing at
        ``checkpoint_trigger`` (default: every epoch) when
        ``set_checkpoint`` is configured, then write the trained
        parameters and state back to ``model.params`` and
        ``model.model_state``.

        ``auto_resume=True`` first restores the newest committed
        checkpoint under the ``set_checkpoint`` directory (nothing when
        there is none, or when this estimator has already trained), so a
        restarted process continues bitwise where the last one stopped.
        A streaming :class:`~analytics_zoo_tpu_torch.data.pipeline.Pipeline`
        is accepted directly: the infeed adopts its ``.prefetch(k)`` depth,
        consumer waits feed the ``zoo_data_*`` gauges, and checkpoints
        carry its resumable stream position."""
        from analytics_zoo_tpu_torch.data.pipeline import Pipeline

        rs = self.run_state
        if (auto_resume and self._checkpoint_path is not None
                and rs.iteration == 0):
            self.resume_from_checkpoint()
        self._ensure_state()
        restored, self._restored_data_state = self._restored_data_state, None
        if restored is not None:
            if int(restored.get("position_batches", 0)) == 0:
                # an epoch-boundary position has no offset to restore and
                # the next epoch's order is a pure function of rs.epoch:
                # a DIFFERENT stream here is a warm start on new data
                # (the flywheel's incremental retrain), not a bad resume
                pass
            elif isinstance(train_set, Pipeline):
                # raises on a stream-shape mismatch: a saved position must
                # never silently index into a different stream
                train_set.load_state_dict(restored)
            else:
                logger.warning(
                    "checkpoint carries a streaming-pipeline position but "
                    "this train_set (%s) is not a Pipeline — the position "
                    "is ignored (epoch_step still resumes the batch "
                    "offset)", type(train_set).__name__)
        self._active_train_set = (train_set if isinstance(train_set, Pipeline)
                                  else None)
        end_trigger = end_trigger or trig.MaxEpoch(rs.epoch + 1)
        checkpoint_trigger = checkpoint_trigger or trig.EveryEpoch()
        mid_epoch_ckpt = not isinstance(checkpoint_trigger, trig.EveryEpoch)
        step = self._make_train_step(
            criterion, getattr(train_set, "device_transform", None))
        sync_loss = _uses_loss(end_trigger)
        if (objectives_lib.get_per_sample(criterion) is None
                and train_set.num_samples % batch_size != 0):
            logger.warning(
                "criterion %s has no per-sample form: the wrap-padded tail "
                "batch weights duplicated samples twice",
                getattr(criterion, "__name__", criterion))
        obs = training_metrics()
        profile = (None if self._profile is None else
                   _ProfileWindow(*self._profile, self.ctx.device))
        steps_this_call = 0
        watchdog = None
        try:
            # started inside the try so that any raise reaches the stop in
            # the finally (a leaked daemon would alarm on a dead run)
            if self._watchdog:
                watchdog = _StepWatchdog(rs, *self._watchdog).start()
            while not end_trigger(rs):
                rs.epoch_finished = False
                epoch_start = last_drain = time.time()
                first_it = rs.iteration + 1
                losses = []  # device scalars, read once at the epoch's end
                # > 0 only right after a mid-epoch resume: the batches of
                # this epoch (order fixed by seed=epoch) already taken
                stream = self._batches(train_set, batch_size, rs.epoch,
                                       rs.epoch_step)
                batches = self._timed(stream) if self.time_steps else stream
                for xs, y, mask in _closing(stream, batches):
                    if profile is not None:
                        profile.tick(steps_this_call)
                    self.tstate, loss = step(self.tstate, xs, y, mask)
                    if self.time_steps and self.ctx.device.type == "cuda":
                        self.step_events.append(
                            torch.cuda.Event(enable_timing=True))
                        self.step_events[-1].record()
                    rs.iteration += 1
                    rs.epoch_step += 1
                    steps_this_call += 1
                    losses.append(loss)
                    if sync_loss:
                        rs.loss = loss.item()
                    self._check_preemption(watchdog)
                    if end_trigger(rs):
                        break
                    if mid_epoch_ckpt and checkpoint_trigger(rs):
                        self._maybe_checkpoint()
                if losses:
                    vals = torch.stack(losses).tolist()
                    dt = time.time() - last_drain
                    rs.loss = vals[-1]
                    self.train_losses.extend(vals)
                    obs["steps"].inc(len(vals))
                    if dt > 0:
                        obs["step_seconds"].observe(dt / len(vals))
                        obs["items_per_sec"].set(len(vals) * batch_size / dt)
                    if self.train_summary is not None:
                        for j, v in enumerate(vals):
                            self.train_summary.add_scalar("Loss", v,
                                                          first_it + j)
                        if dt > 0:
                            self.train_summary.add_scalar(
                                "Throughput", len(vals) * batch_size / dt,
                                first_it + len(vals) - 1)
                    logger.info("Epoch %d done in %.2fs — mean loss %.5f",
                                rs.epoch + 1, time.time() - epoch_start,
                                sum(vals) / len(vals))
                rs.epoch += 1
                rs.epoch_step = 0
                rs.epoch_finished = True
                # phases that take no step: the iteration counter stalls
                # here (a checkpoint's snapshot, a validation epoch), so
                # the watchdog must not alarm
                if watchdog is not None:
                    watchdog.pause()
                if checkpoint_trigger(rs):
                    self._maybe_checkpoint()
                if validation_set is not None and validation_method:
                    results = self.evaluate(
                        validation_set, validation_method,
                        validation_batch_size or batch_size)
                    for name, value in results.items():
                        rs.score = value
                        if self.val_summary is not None:
                            self.val_summary.add_scalar(name, value,
                                                        rs.iteration)
                    logger.info("Validation @ epoch %d: %s", rs.epoch,
                                results)
                if watchdog is not None:
                    watchdog.resume()
                self._check_preemption(watchdog)
            # raise writer failures, and make every triggered save durable
            # before returning
            self._drain_checkpoints()
        finally:
            if watchdog is not None:
                watchdog.stop()
            self._drain_checkpoints(raising=False)
            # close an open trace even when a step raised
            if profile is not None:
                profile.stop()
                if profile.started:
                    self._profile = None  # one-shot: the next train()
            self._write_back()
        return self

    # -- multi-host data-parallel training (ft/distributed.py) -----------

    def _make_dist_grad(self, criterion: Callable,
                        device_transform: Optional[Callable] = None):
        """The N > 1 gradient step on this host's device: the gradient of
        the SUM of the window's per-sample losses plus the valid-sample
        count, so the cross-host combine is ``(sum of gsum) / (sum of
        count) + greg`` in fixed host order, the same on every host. The
        regularization's gradient ``greg`` is computed apart, on the
        (replicated) parameters, so every host holds the whole of it and
        adds it once, as ``train()`` does. (The JAX package adds
        ``greg / num_hosts`` on each host, which applies 1/N of the
        penalty's gradient; the port does not copy that.)
        Returns ``(fn, update_mask)``; ``fn(params, model_state, xs, y,
        mask, generator)`` gives ``(gsum_vec, greg_vec or None, loss_sum,
        count, new_model_state)``, the vectors in JAX's flat order on the
        device."""
        model = self.model
        forward = self._make_forward(criterion, device_transform)
        update_mask = self._update_mask(self.tstate.params)
        trainable = (None if update_mask is None
                     else tree_leaves(update_mask))
        order = jax_leaf_order(self.tstate.params)

        def flat(grads, leaves):
            grads = _dense_grads(grads, leaves, trainable)
            return torch.cat([grads[i].reshape(-1) for i in order])

        def grad_step(params, model_state, xs, y, mask, generator):
            leaves = [t.detach().requires_grad_(True)
                      for t in tree_leaves(params)]
            tree = tree_unflatten(params, leaves)
            with torch.enable_grad():
                losses, new_state = forward(tree, model_state, xs, y, True,
                                            generator)
                loss_sum, count = _loss_sum(losses, y, mask)
                grads = torch.autograd.grad(loss_sum, leaves,
                                            allow_unused=True)
                reg = model.regularization(tree)
                greg = (torch.autograd.grad(reg, leaves, allow_unused=True)
                        if isinstance(reg, torch.Tensor) and reg.requires_grad
                        else None)
            with torch.no_grad():
                gvec = flat(grads, leaves)
                rvec = None if greg is None else flat(greg, leaves)
            return gvec, rvec, loss_sum.detach(), count, new_state

        return grad_step, update_mask

    def _host_generator(self, iteration: int, host_id: int):
        """Host ``host_id``'s dropout stream at ``iteration`` of a
        multi-host run: a generator on the device seeded from the
        context's seed, the iteration and the host, so each host draws its
        own masks (the JAX package folds the device index into the step's
        key) and a resumed run draws what the uninterrupted one drew."""
        seed = (int(self.ctx.conf.seed) * 1_000_003 + int(iteration)) \
            * 1_009 + int(host_id)
        gen = torch.Generator(device=self.ctx.device)
        return gen.manual_seed(seed % (1 << 63))

    def _dist_batches(self, data, global_batch: int, epoch: int, skip: int,
                      window):
        """This host's device (x, y, mask) rows ``window`` of every global
        training batch of ``epoch``, without the first ``skip`` batches;
        the whole batch when ``window`` is None."""
        if window is None:
            yield from self._batches(data, global_batch, epoch, skip)
            return
        if not hasattr(data, "train_index_batches"):
            raise TypeError(
                f"train_distributed over several hosts needs a feature set "
                f"with train_index_batches, not {type(data).__name__}")
        lo, hi = window
        dev = self.ctx.device
        gather = getattr(data, "gather", None)
        batches = data.train_index_batches(global_batch, shuffle=True,
                                           seed=epoch)
        for idx, mask in itertools.islice(batches, skip, None):
            idx, mask = idx[lo:hi], mask[lo:hi]
            if gather is not None:
                x, y = gather(torch.tensor(idx, device=dev))
            else:
                x, y = data.take(idx)
                x, y = self._to_device(x), self._to_device(y)
            yield x, y, torch.tensor(mask, device=dev)

    def _write_dist_checkpoint(self, dist, updater, opt_shard) -> str:
        """Synchronous two-phase sharded save of the current state: every
        host stages its round-robin share of the flattened
        params/model_state/step tree (JAX's leaf order) plus its own
        optimizer shard; the coordinator validates, merges and commits
        (:func:`~analytics_zoo_tpu_torch.ft.distributed
        .commit_sharded_checkpoint`). Raises DistTimeoutError or
        DistCommitError on failure; the caller decides whether that is
        fatal."""
        from analytics_zoo_tpu_torch.ft import distributed as dist_lib

        rs = self.run_state
        shared_flat = _jax_flatten({"params": self.tstate.params,
                                    "model_state": self.tstate.model_state,
                                    "step": self.tstate.step})
        if dist.num_hosts == 1:
            # the single host trains the per-leaf state: checkpoint the
            # flat layout, which any host count restores
            opt_shard = updater.tree_to_flat(opt_shard)
        mine = (dist_lib.split_round_robin(shared_flat, dist.host_id,
                                           dist.num_hosts)
                + updater.opt_flat(opt_shard))
        expected = ({k for k, _ in shared_flat}
                    | updater.expected_opt_keys())
        metadata = {"epoch": rs.epoch, "iteration": rs.iteration,
                    "epoch_step": rs.epoch_step,
                    "gradient_accumulation": self.gradient_accumulation,
                    "step_generator": _generator_state(
                        self.ctx.step_generator),
                    "dist": {"num_hosts": dist.num_hosts,
                             "flat_size": updater.flat_size,
                             "slice_len": updater.slice_len,
                             "opt_leaves": updater.opt_leaf_count}}
        path = os.path.join(self._checkpoint_path, f"ckpt_{rs.iteration}")
        with get_tracer().span("train.checkpoint", iteration=rs.iteration,
                               dist=True):
            dist_lib.commit_sharded_checkpoint(
                path, mine, host_id=dist.host_id,
                num_hosts=dist.num_hosts, expected_keys=expected,
                metadata=metadata, commit_id=dist.commit_id(rs.iteration),
                timeout_s=dist.timeout_s,
                overwrite=self._checkpoint_overwrite)
        if dist.is_coordinator:
            self._checkpoint_manager().sweep(rs.iteration)
        return path

    def _resume_distributed(self, dist, updater):
        """Restore the newest committed checkpoint for a distributed run:
        the params/model_state/step tree by KEY (a sharded manifest orders
        leaves by owning host), the optimizer shards resliced for this
        run's host count, the counters and the step generator. Falls back
        over corrupt checkpoints as :meth:`resume_from_checkpoint` does.
        Returns ``(opt_shard or None, resumed)``."""
        from analytics_zoo_tpu_torch.ft import atomic

        if dist.is_coordinator:
            atomic.sweep_stale(self._checkpoint_path)
        dist.barrier()  # nobody lists the directory until the sweep is done
        candidates = atomic.committed_checkpoints(self._checkpoint_path)
        if not candidates:
            return None, False
        shared = {"params": self.tstate.params,
                  "model_state": self.tstate.model_state,
                  "step": self.tstate.step}
        dev = self.ctx.device
        last_err = None
        for _step, path in reversed(candidates):
            try:
                flat, meta = atomic.read_checkpoint(path)
                fm = dict(flat)
                leaves = []
                for key, like in zip(tree_paths(shared),
                                     tree_leaves(shared)):
                    if key not in fm:
                        raise CheckpointCorruptError(
                            f"checkpoint {path!r}: leaf {key!r} missing")
                    arr = fm[key]
                    want = tuple(getattr(like, "shape", ()))
                    if tuple(arr.shape) != want:
                        raise ValueError(
                            f"Checkpoint {path!r}: leaf {key!r} has shape "
                            f"{tuple(arr.shape)}, target expects {want}")
                    leaves.append(arr)
                dist_meta = (meta or {}).get("dist")
                if dist_meta is None:
                    raise CheckpointCorruptError(
                        f"checkpoint {path!r} carries no 'dist' metadata: "
                        "not a distributed checkpoint")
                restored = tree_unflatten(shared, leaves)
                opt_shard = updater.restore_opt(
                    fm, dist_meta, device=dev, step=int(restored["step"]))
            except CheckpointCorruptError as e:
                logger.warning("checkpoint %s is corrupt (%s): trying the "
                               "previous committed one", path, e)
                last_err = e
                continue
            with torch.inference_mode(False):
                params, mstate = (
                    tree_map(lambda a: torch.tensor(a, device=dev), tree)
                    for tree in (restored["params"],
                                 restored["model_state"]))
            self.tstate = TrainState(params, mstate, None,
                                     int(restored["step"]))
            self._write_back()
            rs = self.run_state
            rs.epoch = int(meta.get("epoch", 0))
            rs.iteration = int(meta.get("iteration", 0))
            rs.epoch_step = int(meta.get("epoch_step", 0))
            self._restore_step_generator(meta, path)
            logger.info("host %d resumed from %s (epoch %d, iteration %d, "
                        "written by %d host(s))", dist.host_id, path,
                        rs.epoch, rs.iteration, int(dist_meta["num_hosts"]))
            return opt_shard, True
        raise CheckpointError(
            f"every checkpoint under {self._checkpoint_path!r} is corrupt"
        ) from last_err

    def train_distributed(self, train_set, criterion: Callable,
                          end_trigger: Optional[trig.Trigger] = None,
                          checkpoint_trigger: Optional[trig.Trigger] = None,
                          batch_size: int = 32,
                          auto_resume: bool = False,
                          dist=None, mesh_config=None) -> "Estimator":
        """Multi-host data-parallel training with sharded optimizer
        updates and two-phase sharded checkpoints.

        ``dist`` is this host's
        :class:`~analytics_zoo_tpu_torch.ft.distributed.DistContext`
        (default: a single-host context, whose trajectory is bitwise
        :meth:`train`'s). ``batch_size`` is the GLOBAL batch, rounded up to
        divide ``num_hosts x`` the local data axis (one device); each host
        takes its contiguous row window of every batch. Per step each host
        computes the gradient of the sum of its window's per-sample losses
        on its device, the hosts all-gather ``(grad-sum, loss-sum,
        count)`` through the rendezvous and combine them in fixed host
        order, and the optimizer update runs sharded: host k updates the
        k-th window of the flattened parameter vector
        (:class:`~analytics_zoo_tpu_torch.ft.distributed.ShardedUpdater`,
        1/N of the optimizer state per host), then the updated windows
        are exchanged and reassembled. Each host draws its own dropout
        masks (:meth:`_host_generator`).

        Checkpoints (``set_checkpoint``) are synchronous two-phase sharded
        commits; a failed save (a peer's death, a validation abort) is
        recorded and re-raised at the next save attempt or at the end of
        training, which itself continues. A preemption flagged on ANY host
        (``set_preemption_handler``) travels with the next gradient
        exchange: every host then saves coordinately and raises
        :class:`~analytics_zoo_tpu_torch.ft.preemption.PreemptedError`.
        ``auto_resume=True`` restores the newest committed checkpoint, one
        written by another host count too (the optimizer shards reshard).

        Not supported here: ``gradient_accumulation > 1``, L2-norm
        clipping (it needs the global norm before the update is sliced)
        and ``zero1`` (superseded by the sharded update). ``model_state``
        stays each host's own (no cross-host batch-norm statistics)."""
        from analytics_zoo_tpu_torch.common.observability import (
            distributed_metrics,
        )
        from analytics_zoo_tpu_torch.ft import distributed as dist_lib
        from analytics_zoo_tpu_torch.ft.preemption import PreemptedError
        from analytics_zoo_tpu_torch.mesh.config import MeshConfig

        if self.gradient_accumulation > 1:
            raise NotImplementedError(
                "train_distributed does not support gradient_accumulation "
                "> 1 (the accumulator state is not shard-partitionable)")
        if self._clip_l2norm is not None:
            raise NotImplementedError(
                "train_distributed does not support L2-norm clipping: the "
                "global norm needs every gradient before the update is "
                "sliced; use constant clipping")
        if self.zero1:
            raise NotImplementedError(
                "zero1 is superseded by the sharded update in "
                "train_distributed (optimizer state is already 1/N per "
                "host)")
        if dist is None:
            dist = dist_lib.DistContext(0, 1)
        self._ensure_state()
        single = dist.num_hosts == 1
        mesh_cfg = mesh_config or MeshConfig.host_local_data()
        global_batch = _round_batch(
            batch_size, dist.num_hosts * mesh_cfg.axis_length("data"))
        per_host = global_batch // dist.num_hosts
        tx = self._tx()
        updater = dist_lib.ShardedUpdater(
            tx, self.tstate.params, dist.host_id, dist.num_hosts, mesh_cfg)
        # the full optimizer state is dead weight on several hosts: the
        # updater's shard (1/N) is the live state
        self.tstate = self.tstate._replace(opt_state=None)
        opt_shard, resumed = None, False
        if (auto_resume and self._checkpoint_path is not None
                and self.run_state.iteration == 0):
            opt_shard, resumed = self._resume_distributed(dist, updater)
            if opt_shard is not None and single:
                # the single host runs the plain per-leaf step: keep its
                # state in the tree layout it trains with
                opt_shard = updater.to_tree_state(opt_shard)
        if opt_shard is None:
            opt_shard = (self._init_opt_state(self.tstate.params) if single
                         else updater.init_opt(self.tstate.params))

        rs = self.run_state
        end_trigger = end_trigger or trig.MaxEpoch(rs.epoch + 1)
        checkpoint_trigger = checkpoint_trigger or trig.EveryEpoch()
        transform = getattr(train_set, "device_transform", None)
        if single:
            plain_step = self._make_train_step(criterion, transform)
            mask_vec = None
        else:
            grad_fn, update_mask = self._make_dist_grad(criterion,
                                                        transform)
            mask_vec = updater.mask_vector(self.tstate.params, update_mask)
        window = (None if single else
                  (dist.host_id * per_host, (dist.host_id + 1) * per_host))
        dm = distributed_metrics()
        dm["hosts"].set(dist.num_hosts)
        obs = training_metrics()
        tracer = get_tracer()
        save_error: List[Optional[BaseException]] = [None]
        # the just-resumed iteration is already committed: a trigger firing
        # at the same step must not commit over the checkpoint restored from
        last_saved = [rs.iteration if resumed else -1]
        # the in-band preemption bit, exchanged with the gradients so that
        # ALL hosts save and exit at the same step
        preempt_flag = [False]
        if self._preemption is not None:
            self._preemption.add_listener(
                lambda: preempt_flag.__setitem__(0, True))

        def _save(coordinated_exit=False):
            if save_error[0] is not None:
                err, save_error[0] = save_error[0], None
                raise err
            if self._checkpoint_path is None:
                return None
            if last_saved[0] == rs.iteration:
                return os.path.join(self._checkpoint_path,
                                    f"ckpt_{rs.iteration}")
            try:
                path = self._write_dist_checkpoint(
                    dist, updater,
                    self.tstate.opt_state if single else opt_shard)
            except (dist_lib.DistTimeoutError,
                    dist_lib.DistCommitError) as e:
                if coordinated_exit:
                    raise
                logger.error("distributed checkpoint at iteration %d "
                             "failed (%s): training continues; the error "
                             "re-raises at the next save attempt",
                             rs.iteration, e)
                save_error[0] = e
                return None
            last_saved[0] = rs.iteration
            return path

        def _coordinated_preempt():
            path = _save(coordinated_exit=True)
            logger.warning("preemption: distributed checkpoint %s committed "
                           "at iteration %d: exiting", path, rs.iteration)
            raise PreemptedError(
                f"training preempted at iteration {rs.iteration}"
                + (f"; checkpoint committed at {path}" if path else
                   " (no checkpoint directory configured: state NOT "
                   "saved)"),
                checkpoint_path=path)

        if single:
            self.tstate = self.tstate._replace(opt_state=opt_shard)
        try:
            while not end_trigger(rs):
                rs.epoch_finished = False
                epoch_start = time.time()
                epoch_loss, epoch_batches = 0.0, 0
                stream = self._dist_batches(train_set, global_batch,
                                            rs.epoch, rs.epoch_step, window)
                for xs, y, mask in _closing(stream, stream):
                    if single:
                        with tracer.span("train.dispatch", kind="dist_step"):
                            self.tstate, loss = plain_step(self.tstate, xs,
                                                           y, mask)
                        loss_val = loss.item()
                    else:
                        t0 = time.perf_counter()
                        gvec, greg, ls, cnt, new_mstate = grad_fn(
                            self.tstate.params, self.tstate.model_state,
                            xs, y, mask,
                            self._host_generator(rs.iteration, dist.host_id))
                        payload = {"g": gvec.cpu().numpy(),
                                   "ls": ls.cpu().numpy(),
                                   "c": cnt.cpu().numpy(),
                                   "flag": np.asarray(
                                       1.0 if preempt_flag[0] else 0.0,
                                       np.float32)}
                        t1 = time.perf_counter()
                        red = dist.allreduce_sum(payload)
                        t2 = time.perf_counter()
                        dm["exchange_seconds"].observe(t2 - t1)
                        count_total = float(red["c"])
                        g = red["g"] / max(count_total, 1.0)
                        if greg is not None:
                            g = g + greg.cpu().numpy()
                        g_full = np.zeros((updater.padded_size,), np.float32)
                        g_full[: updater.flat_size] = g
                        loss_val = float(red["ls"]) / max(count_total, 1.0)
                        if float(red["flag"]) > 0:
                            preempt_flag[0] = True
                        with tracer.span("train.dispatch", kind="dist_step"):
                            new_slice, opt_shard = updater.step(
                                self.tstate.params, g_full, opt_shard,
                                mask_vec)
                            new_slice = new_slice.cpu().numpy()
                        t3 = time.perf_counter()
                        parts = dist.exchange({"s": new_slice})
                        t4 = time.perf_counter()
                        dm["exchange_seconds"].observe(t4 - t3)
                        with torch.inference_mode(False):
                            new_params = updater.assemble(
                                [p["s"] for p in parts], self.ctx.device)
                        self.tstate = TrainState(new_params, new_mstate,
                                                 None, self.tstate.step + 1)
                        if self.time_steps:
                            self.dist_timings.append({
                                "compute": t1 - t0,
                                "exchange": (t2 - t1) + (t4 - t3),
                                "update": (t3 - t2)
                                + (time.perf_counter() - t4)})
                    rs.iteration += 1
                    rs.epoch_step += 1
                    rs.loss = loss_val
                    self.train_losses.append(loss_val)
                    epoch_loss += loss_val
                    epoch_batches += 1
                    dm["steps"].inc()
                    obs["steps"].inc()
                    if self.train_summary is not None:
                        self.train_summary.add_scalar("Loss", loss_val,
                                                      rs.iteration)
                    if preempt_flag[0] or (self._preemption is not None
                                           and self._preemption.requested):
                        _coordinated_preempt()
                    if end_trigger(rs):
                        break
                    if (checkpoint_trigger(rs) and not isinstance(
                            checkpoint_trigger, trig.EveryEpoch)):
                        _save()
                rs.epoch += 1
                rs.epoch_step = 0
                rs.epoch_finished = True
                logger.info("Epoch %d done in %.2fs: mean loss %.5f (host %d "
                            "of %d)", rs.epoch, time.time() - epoch_start,
                            epoch_loss / max(epoch_batches, 1),
                            dist.host_id, dist.num_hosts)
                if checkpoint_trigger(rs):
                    _save()
                if preempt_flag[0] or (self._preemption is not None
                                       and self._preemption.requested):
                    _coordinated_preempt()
            if save_error[0] is not None:
                err, save_error[0] = save_error[0], None
                raise err
        finally:
            self._write_back()
        return self

    # -- checkpoints and preemption --------------------------------------

    def _checkpoint_manager(self):
        """The lazily created asynchronous checkpoint manager for the
        ``set_checkpoint`` directory."""
        if self._ckpt_manager is None:
            from analytics_zoo_tpu_torch.ft.manager import CheckpointManager

            self._ckpt_manager = CheckpointManager(
                self._checkpoint_path, keep_last=self._ckpt_keep_last,
                keep_every=self._ckpt_keep_every,
                asynchronous=self._ckpt_async,
                overwrite=self._checkpoint_overwrite)
        return self._ckpt_manager

    def _maybe_checkpoint(self) -> Optional[str]:
        if self._checkpoint_path is None:
            return None
        return self._write_checkpoint()

    def _write_checkpoint(self) -> str:
        """Snapshot the TrainState on this thread; the writer commits."""
        rs = self.run_state
        metadata = {"epoch": rs.epoch, "iteration": rs.iteration,
                    "epoch_step": rs.epoch_step,
                    "gradient_accumulation": self.gradient_accumulation,
                    "step_generator": _generator_state(
                        self.ctx.step_generator)}
        ds = self._active_train_set
        if ds is not None:
            # the resumable stream position under the ESTIMATOR's counters:
            # the prefetch thread may sit a few batches ahead of the step
            # this checkpoint captures, and rs.epoch / rs.epoch_step are
            # what a resume replays with
            metadata["pipeline"] = ds.state_dict(epoch_seed=rs.epoch,
                                                 position=rs.epoch_step)
        return self._checkpoint_manager().save(rs.iteration, self.tstate,
                                               metadata=metadata)

    def _drain_checkpoints(self, raising: bool = True) -> None:
        """Wait for pending asynchronous writes and raise a writer error
        (``raising=False`` logs it: an unwinding exception must not be
        masked)."""
        if self._ckpt_manager is None:
            return
        try:
            self._ckpt_manager.wait()
        except CheckpointError:
            if raising:
                raise
            logger.exception("async checkpoint write failed during unwind")

    def _check_preemption(self, watchdog=None) -> None:
        """Act on a flagged SIGTERM/SIGINT at a step boundary: checkpoint
        (if configured), wait until it is committed, raise
        PreemptedError."""
        h = self._preemption
        if h is None or not h.requested:
            return
        from analytics_zoo_tpu_torch.ft.preemption import PreemptedError

        if watchdog is not None:
            watchdog.pause()
        self._drain_checkpoints()
        it = self.run_state.iteration
        if (self._ckpt_manager is not None
                and self._ckpt_manager.latest_step() == it):
            # the trigger checkpointed this very iteration already
            path = self._ckpt_manager.step_path(it)
        else:
            path = self._maybe_checkpoint()
            self._drain_checkpoints()
        logger.warning("preemption: checkpoint %s committed at iteration %d "
                       "— exiting train loop", path, it)
        raise PreemptedError(
            f"training preempted at iteration {it}"
            + (f"; checkpoint committed at {path}" if path else
               " (no checkpoint directory configured — state NOT saved)"),
            checkpoint_path=path)

    # -- evaluation and prediction ---------------------------------------

    def _forward_batches(self, data, batch_size: int):
        """(device prediction, y, mask) per dataset-order batch, on the
        compute-dtype cast of the current params (``data``'s
        ``device_transform`` first). The caller runs it to its end under
        ``torch.inference_mode()``."""
        self._ensure_state()
        params = self._cast_for_compute(self.tstate.params)
        transform = getattr(data, "device_transform", None)
        for x, y, mask in self._batches(data, batch_size, None):
            if transform is not None:
                x = transform(x)
            pred, _ = self.model.apply(params, self.tstate.model_state,
                                       self._cast_for_compute(x),
                                       training=False, rng=None)
            yield tree_map(lambda p: p.float(), pred), y, mask

    def evaluate(self, validation_set, validation_method: Sequence,
                 batch_size: int = 32) -> dict:
        """Run metrics over a dataset; the mask excludes the wrap-padding
        from the statistics."""
        metric_objs = [metrics_lib.get(m) for m in validation_method]
        totals = [None] * len(metric_objs)
        counts = [None] * len(metric_objs)
        with torch.inference_mode():
            for pred, y, mask in self._forward_batches(validation_set,
                                                       batch_size):
                for i, m in enumerate(metric_objs):
                    s, c = m.batch_stats(y, pred, mask=mask)
                    totals[i] = s if totals[i] is None else totals[i] + s
                    counts[i] = c if counts[i] is None else counts[i] + c
        return {m.name: m.finalize(_host_stat(t), _host_stat(c))
                for m, t, c in zip(metric_objs, totals, counts)}

    def predict(self, data_set, batch_size: int = 32):
        """Batched inference over a feature set -> host float32 ndarray
        (wrap-padded tail trimmed)."""
        outs = []
        with torch.inference_mode():
            for pred, _, mask in self._forward_batches(data_set, batch_size):
                valid = mask > 0
                outs.append(tree_map(lambda p: p[valid], pred))
        if outs and isinstance(outs[0], (list, tuple)):
            return tuple(torch.cat([o[i] for o in outs]).cpu().numpy()
                         for i in range(len(outs[0])))
        return torch.cat(outs).cpu().numpy()
