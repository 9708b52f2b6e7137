"""train_pipelined — the MPMD microbatch pipeline training driver (port of
``analytics_zoo_tpu.pipeline.trainer``).

One training step runs the whole microbatch schedule (1F1B or naive
GPipe fill/drain, :mod:`~analytics_zoo_tpu_torch.pipeline.schedule`)
through per-stage programs:

- ``fwd[s]``: stage ``s < K-1``'s forward over its layer segment, with no
  autograd graph;
- ``last``: the last stage fused: forward, the masked loss SUM and
  backward (the distributed step's loss contract,
  ``Estimator._make_forward`` and ``estimator._loss_sum``);
- ``bwd[s]``: stage ``s < K-1``'s backward, which re-runs the segment's
  forward from the stashed stage input under autograd: slots hold
  inputs, never an activation tape across events;
- ``combine``: the optimizer update over the whole tree,
  ``g = sum_m grads / max(count, 1) + d(regularization)`` (the L1/L2
  gradient added once), with the frozen-leaf mask applied before and
  after the transform.

Activations ride the bounded per-(stage, slot) pools of
:mod:`~analytics_zoo_tpu_torch.pipeline.buffers`, sized by a dry run of
the event order (:meth:`MicrobatchSchedule.measured_slots`).

Parity contract (held by ``tests/test_torch_pipeline.py`` and
``chip_smoke.py`` phase 18b):

- GPipe and 1F1B give BITWISE the same losses and parameters: both fold
  the per-microbatch gradient sums in a fixed ascending-microbatch order,
  and each (stage, microbatch) cell runs the same computation; only the
  event order differs.
- A stage split alone (K > 1, M = 1) is bitwise the K = 1 run: the same
  operations in the same order, the boundary activations and their
  gradients handed over as they are.
- M > 1 against M = 1 is within a rounding bound: M microbatch products
  and their sums reassociate the batch reduction.
- Dropout: each layer draws from its own generator, seeded from the
  context's seed, the iteration and the layer's ABSOLUTE index in the
  model (``StageSegment.indices``), and made anew for every program
  call. So the stage split moves no stream, a ``bwd`` re-run draws the
  masks its ``fwd`` drew, a resumed run draws what the uninterrupted run
  drew, and every microbatch of a step draws the same masks (the JAX
  package shares the step key across microbatches the same way). The
  masks are not those of ``Estimator.train``, whose layers share one
  stream in call order.
- ``model_state`` (batch-norm moments): every microbatch runs on the
  step-start state; the committed state is the LAST microbatch's.

Checkpoints are stage-owned two-phase sharded commits in the JAX
package's format (stage k's thread commits shard k through
:func:`~analytics_zoo_tpu_torch.ft.distributed.commit_sharded_checkpoint`
with ``shard_meta={"stage": k}``; keys ``params/...``, ``model_state/...``,
optax's ``opt_state/<chain>/.<field>/...`` and ``step``), so either package
resumes the other's. Every schedule event is a
``pipeline_mid_schedule_kill`` chaos site: a step publishes state only at
its end, so a kill mid-schedule resumes bitwise from the last commit.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.tree import (
    tree_leaves,
    tree_map,
    tree_paths,
    tree_unflatten,
)
from analytics_zoo_tpu_torch.pipeline.buffers import ActivationSlots
from analytics_zoo_tpu_torch.pipeline.plan import StagePlan, StageSegment
from analytics_zoo_tpu_torch.pipeline.schedule import MicrobatchSchedule

__all__ = ["train_pipelined"]

logger = logging.getLogger("analytics_zoo_tpu_torch")

#: Wall-clock bound on one stage-sharded checkpoint gang commit. The
#: committers are threads of ONE process, so a peer cannot die without
#: us: the timeout only turns a filesystem wedge into an error.
_COMMIT_TIMEOUT_S = 120.0


def _slice(tree, lo: int, hi: int):
    """Rows ``[lo, hi)`` of every leaf of a batch element."""
    return tree_map(lambda a: a[lo:hi], tree)


def _layer_seed(seed: int, iteration: int, index: int) -> int:
    """The seed of layer ``index``'s dropout generator at ``iteration``."""
    return (((int(seed) * 1_000_003 + int(iteration)) * 1_000_033
             + int(index)) % (1 << 63))


def _make_segment_apply(segment: StageSegment, cast: Callable,
                        cast_input: bool, device):
    """The stage-local mirror of ``Sequential.apply``: the same per-layer
    call protocol, each layer's dropout generator made from the step's
    ``rng = (seed, iteration)`` and the layer's ABSOLUTE index. The
    compute-dtype cast applies to the stage input only where
    ``cast_input`` (stage 0), as the unsplit forward casts its input."""
    layers, indices = segment.layers, segment.indices

    def seg_apply(params_s, state_s, x, rng):
        if cast_input:
            x = cast(x)
        p_all = cast(params_s)
        new_state: Dict[str, Any] = {}
        for i, layer in zip(indices, layers):
            gen = torch.Generator(device=device).manual_seed(
                _layer_seed(*rng, i))
            p = p_all.get(layer.name, {})
            if layer.has_state:
                x, new_state[layer.name] = layer.call(
                    p, x, state=state_s.get(layer.name, {}), training=True,
                    rng=gen)
            else:
                x = layer.call(p, x, training=True, rng=gen)
        return x, new_state

    return seg_apply


def _grad_args(params_s, x, need_dx: bool):
    """Leaves to differentiate: the stage's parameters and, where
    ``need_dx``, the floating leaves of its input."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params_s)]
    if need_dx:
        x = tree_map(lambda t: t.detach().requires_grad_(True)
                     if t.is_floating_point() else t, x)
    xl = [t for t in tree_leaves(x) if t.requires_grad] if need_dx else []
    return tree_unflatten(params_s, leaves), leaves, x, xl


def _split_grads(grads, params_s, leaves, x, xl):
    """``(dx, dp)`` from ``torch.autograd.grad``'s list over ``leaves +
    xl``: an unused leaf's None as zeros; ``dx`` None without ``xl``."""
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, leaves + xl)]
    dp = tree_unflatten(params_s, grads[:len(leaves)])
    if not xl:
        return None, dp
    it = iter(grads[len(leaves):])
    return tree_map(lambda t: next(it) if t.requires_grad else None, x), dp


def _build_programs(est, criterion: Callable,
                    segments: List[StageSegment]) -> Dict[str, Any]:
    """The per-stage programs and the combine/accumulate programs."""
    from analytics_zoo_tpu_torch.engine.estimator import _loss_sum

    model, cast, device = est.model, est._cast_for_compute, est.ctx.device
    update_mask = est._update_mask(est.tstate.params)
    trainable = None if update_mask is None else tree_leaves(update_mask)
    tx = est._tx()
    k = len(segments)

    def detached(tree):
        return tree_map(lambda t: t.detach()
                        if isinstance(t, torch.Tensor) else t, tree)

    fwd: List[Optional[Callable]] = [None] * k
    bwd: List[Optional[Callable]] = [None] * k
    for s in range(k - 1):
        seg_apply = _make_segment_apply(segments[s], cast, s == 0, device)

        def fwd_fn(params_s, state_s, x, rng, _apply=seg_apply):
            with torch.no_grad():
                return _apply(params_s, state_s, x, rng)

        def bwd_fn(params_s, state_s, x, dy, rng, _apply=seg_apply,
                   _need_dx=s > 0):
            tree, leaves, x, xl = _grad_args(params_s, x, _need_dx)
            with torch.enable_grad():
                y, _ = _apply(tree, state_s, x, rng)
                grads = torch.autograd.grad(
                    tree_leaves(y), leaves + xl,
                    grad_outputs=tree_leaves(dy), allow_unused=True)
            return _split_grads(grads, params_s, leaves, x, xl)

        fwd[s], bwd[s] = fwd_fn, bwd_fn

    forward = est._make_forward(
        criterion, apply=_make_segment_apply(segments[k - 1], cast, k == 1,
                                             device))

    def last_fn(params_s, state_s, x, y, mask, rng):
        tree, leaves, x, xl = _grad_args(params_s, x, k > 1)
        with torch.enable_grad():
            losses, new_state = forward(tree, state_s, x, y, True, rng)
            loss_sum, count = _loss_sum(losses, y, mask)
            grads = torch.autograd.grad(loss_sum, leaves + xl,
                                        allow_unused=True)
        dx, dp = _split_grads(grads, params_s, leaves, x, xl)
        return dx, dp, loss_sum.detach(), count, detached(new_state)

    def combine_fn(params, gsum, count, opt_state):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        with torch.enable_grad():
            reg = model.regularization(tree_unflatten(params, leaves))
            greg = (torch.autograd.grad(reg, leaves, allow_unused=True)
                    if isinstance(reg, torch.Tensor) and reg.requires_grad
                    else None)
        with torch.no_grad():
            # the gradient tree in the parameters' own leaf order
            g = tree_leaves({name: gsum[name] for name in params})
            denom = torch.clamp_min(count, 1.0)
            g = [a / denom for a in g]
            if greg is not None:  # added once, whole
                g = [a if b is None else a + b for a, b in zip(g, greg)]
            if trainable is not None:
                g = [a if t else torch.zeros_like(a)
                     for a, t in zip(g, trainable)]
            updates, new_opt = tx.update(tree_unflatten(params, g),
                                         opt_state, params)
            updates = tree_leaves(updates)
            if trainable is not None:
                updates = [u if t else torch.zeros_like(u)
                           for u, t in zip(updates, trainable)]
            new_params = tree_unflatten(params, list(torch._foreach_add(
                tree_leaves(params), updates)))
        return new_params, new_opt

    def acc_fn(a, b):
        return tree_map(torch.add, a, b)

    return {"fwd": fwd, "bwd": bwd, "last": last_fn, "combine": combine_fn,
            "acc": acc_fn, "tx": tx}


def _run_schedule(programs, stage_params, stage_state, events, slots,
                  num_stages: int, num_microbatches: int, mb_rows: int,
                  xs, y, mask, rng):
    """Execute one step's schedule: every event goes through the chaos
    hook, activations ride slot leases, per-microbatch gradient pieces
    fold in FIXED ascending-microbatch order (the GPipe-vs-1F1B bitwise
    invariant)."""
    from analytics_zoo_tpu_torch.ft import chaos

    k, m_total = num_stages, num_microbatches
    leases: Dict[Tuple[int, int], Any] = {}
    cot: Dict[Tuple[int, int], Any] = {}
    gparts: List[Dict[str, Any]] = [dict() for _ in range(m_total)]
    ls_parts: List[Any] = [None] * m_total
    cnt_parts: List[Any] = [None] * m_total
    state_out: Dict[int, Any] = {}

    for kind, s, m in events:
        chaos.maybe_fail("pipeline_mid_schedule_kill")
        lo, hi = m * mb_rows, (m + 1) * mb_rows
        if kind == "F":
            if s == 0:
                leases[(0, m)] = slots.checkout(0, _slice(xs, lo, hi))
            x = leases[(s, m)].payload
            yv, new_ss = programs["fwd"][s](
                stage_params[s], stage_state[s], x, rng)
            state_out[s] = new_ss
            leases[(s + 1, m)] = slots.checkout(s + 1, yv)
        elif kind == "L":
            if k == 1:
                leases[(s, m)] = slots.checkout(s, _slice(xs, lo, hi))
            x = leases[(s, m)].payload
            dx, dp, ls, cnt, new_ss = programs["last"](
                stage_params[s], stage_state[s], x,
                _slice(y, lo, hi), mask[lo:hi], rng)
            state_out[s] = new_ss
            gparts[m].update(dp)
            ls_parts[m], cnt_parts[m] = ls, cnt
            if s > 0:
                cot[(s - 1, m)] = dx
            slots.release(leases.pop((s, m)))
        else:  # "B"
            x = leases[(s, m)].payload
            dy = cot.pop((s, m))
            dx, dp = programs["bwd"][s](
                stage_params[s], stage_state[s], x, dy, rng)
            gparts[m].update(dp)
            if s > 0:
                cot[(s - 1, m)] = dx
            slots.release(leases.pop((s, m)))

    slots.assert_drained()
    if cot:
        raise RuntimeError(
            f"cotangents never consumed after the schedule drained: "
            f"{sorted(cot)}")

    gsum = gparts[0]
    ls_tot, cnt_tot = ls_parts[0], cnt_parts[0]
    for m in range(1, m_total):
        gsum = programs["acc"](gsum, gparts[m])
        ls_tot, cnt_tot = programs["acc"]((ls_tot, cnt_tot),
                                          (ls_parts[m], cnt_parts[m]))
    new_mstate: Dict[str, Any] = {}
    for s in range(k):
        new_mstate.update(state_out.get(s, {}))
    return gsum, ls_tot, cnt_tot, new_mstate


# -- stage-sharded checkpoints in the JAX package's format -----------------


def _opt_layout(tx):
    """``[(entry, optax path), ...]`` of the optimizer state: the JAX
    package's ``opt_state/`` keys of each entry of the port's state."""
    from analytics_zoo_tpu_torch.keras.optimizers import (
        optax_leaves,
        optax_paths,
    )

    names = optax_leaves(tx)
    if names is None:
        raise NotImplementedError(
            "train_pipelined checkpoints store the optimizer state under "
            "the JAX package's optax keys, and this optimizer declares no "
            "optax layout (keras.optimizers.optax_paths)")
    return list(zip(names, optax_paths(tx)))


def _checkpoint_tree(tx, params, model_state, opt_state, step: int):
    """A pipelined checkpoint's tree, keyed as the JAX package keys it:
    ``params/...``, ``model_state/...``, the optimizer's entries at their
    optax paths (``opt_state/0/.mu/...``, ``opt_state/1/.count``) and
    ``step``; JAX's leaf order (dict keys sorted) is optax's here too."""
    opt: Dict[str, Dict[str, Any]] = {}
    for name, path in _opt_layout(tx):
        chain, field = path.split("/")
        opt.setdefault(chain, {})[field] = opt_state[name]
    return {"model_state": model_state, "opt_state": opt, "params": params,
            "step": int(step)}


def _commit_stage_gang(path: str, shards: List[List[Tuple[str, Any]]], *,
                       expected_keys, metadata, commit_id: str,
                       overwrite: bool) -> None:
    """All K stage shards through the two-phase sharded commit protocol:
    stage k plays host k (``shard_meta={"stage": k}`` rides in its shard
    manifest), stages 1..K-1 commit on threads while stage 0, the
    coordinator that validates and publishes, runs in the caller's
    thread, so its exceptions surface directly."""
    from analytics_zoo_tpu_torch.ft import distributed as dist_lib

    k = len(shards)
    errors: List[Optional[BaseException]] = [None] * k

    def commit(stage: int) -> None:
        try:
            dist_lib.commit_sharded_checkpoint(
                path, shards[stage], host_id=stage, num_hosts=k,
                expected_keys=expected_keys if stage == 0 else None,
                metadata=metadata if stage == 0 else None,
                commit_id=commit_id, timeout_s=_COMMIT_TIMEOUT_S,
                overwrite=overwrite, shard_meta={"stage": stage})
        except BaseException as e:  # re-raised below, per stage
            errors[stage] = e

    threads = [threading.Thread(target=commit, args=(stage,), daemon=True,
                                name=f"pipeline-ckpt-stage{stage}")
               for stage in range(1, k)]
    for t in threads:
        t.start()
    commit(0)
    for t in threads:
        t.join(_COMMIT_TIMEOUT_S)
    for err in errors:
        if err is not None:
            raise err


def _write_pipelined_checkpoint(est, stage_plan: StagePlan,
                                layer_stages: Dict[str, int], tx, opt_state,
                                sched: MicrobatchSchedule) -> str:
    from analytics_zoo_tpu_torch.common.observability import get_tracer

    from analytics_zoo_tpu_torch.engine.estimator import _jax_flatten

    rs = est.run_state
    flat = _jax_flatten(_checkpoint_tree(
        tx, est.tstate.params, est.tstate.model_state, opt_state,
        est.tstate.step))
    shards = stage_plan.partition_flat(flat, layer_stages)
    metadata = {"epoch": rs.epoch,
                "iteration": rs.iteration,
                "epoch_step": rs.epoch_step,
                "pipeline": {"num_stages": stage_plan.num_stages,
                             "schedule": sched.mode,
                             "num_microbatches": sched.num_microbatches,
                             "plan": stage_plan.fingerprint()}}
    path = os.path.join(est._checkpoint_path, f"ckpt_{rs.iteration}")
    with get_tracer().span("train.checkpoint", iteration=rs.iteration,
                           pipeline=True):
        _commit_stage_gang(path, shards,
                           expected_keys={key for key, _ in flat},
                           metadata=metadata,
                           commit_id=f"pipeline-{rs.iteration}",
                           overwrite=est._checkpoint_overwrite)
    est._checkpoint_manager().sweep(rs.iteration)
    return path


def _restore_opt(tx, template, fm: Dict[str, np.ndarray], step: int,
                 device):
    """The optimizer state from a checkpoint's ``opt_state/`` leaves, by
    key; a count optax does not keep (no schedule) is ``step``, as
    ``ft.distributed`` restores it."""
    state = dict(template)
    if "count" in state:
        state["count"] = int(step)
    for name, path in _opt_layout(tx):
        if name == "count":
            state["count"] = int(fm[f"opt_state/{path}"])
        else:
            keys = [f"opt_state/{path}/{k}" for k in
                    tree_paths(template[name])]
            state[name] = tree_unflatten(template[name], [
                torch.tensor(fm[k], device=device) for k in keys])
    return state


def _resume_pipelined(est, tx, opt_template):
    """Restore the newest committed stage-sharded checkpoint BY KEY (a
    stage-sharded manifest orders leaves by owning stage), falling back
    from a corrupt checkpoint to the one before it. Returns
    ``(opt_state or None, resumed)``."""
    from analytics_zoo_tpu_torch.engine.estimator import TrainState
    from analytics_zoo_tpu_torch.ft import atomic
    from analytics_zoo_tpu_torch.ft.atomic import (
        CheckpointCorruptError,
        CheckpointError,
    )

    atomic.sweep_stale(est._checkpoint_path)
    candidates = atomic.committed_checkpoints(est._checkpoint_path, "ckpt")
    if not candidates:
        return None, False
    tstate = est.tstate
    template = _checkpoint_tree(tx, tstate.params, tstate.model_state,
                                opt_template, tstate.step)
    wanted = [(key, tuple(getattr(leaf, "shape", ())))
              for key, leaf in zip(tree_paths(template),
                                   tree_leaves(template))]
    dev = est.ctx.device
    last_err = None
    for _step, path in reversed(candidates):
        try:
            flat, meta = atomic.read_checkpoint(path)
            fm = dict(flat)
            for key, shape in wanted:
                if key not in fm:
                    raise CheckpointCorruptError(
                        f"checkpoint {path!r}: leaf {key!r} missing")
                if tuple(fm[key].shape) != shape:
                    raise ValueError(
                        f"Checkpoint {path!r}: leaf {key!r} has shape "
                        f"{tuple(fm[key].shape)}, target expects {shape}")
            if (meta or {}).get("pipeline") is None:
                raise CheckpointCorruptError(
                    f"checkpoint {path!r} carries no 'pipeline' metadata "
                    "— not a pipelined checkpoint")
        except CheckpointCorruptError as e:
            logger.warning("checkpoint %s is corrupt (%s) — trying the "
                           "previous committed one", path, e)
            last_err = e
            continue
        step = int(fm["step"])
        with torch.inference_mode(False):
            params, mstate = (
                tree_unflatten(tree, [
                    torch.tensor(fm[f"{prefix}/{k}"], device=dev)
                    for k in tree_paths(tree)])
                for prefix, tree in (("params", tstate.params),
                                     ("model_state", tstate.model_state)))
            opt_state = _restore_opt(tx, opt_template, fm, step, dev)
        est.tstate = TrainState(params, mstate, None, step)
        est._write_back()
        rs = est.run_state
        rs.epoch = int(meta.get("epoch", 0))
        rs.iteration = int(meta.get("iteration", 0))
        rs.epoch_step = int(meta.get("epoch_step", 0))
        logger.info(
            "pipeline resumed from %s (epoch %d, iteration %d, %d "
            "stage shard(s))", path, rs.epoch, rs.iteration,
            int(meta["pipeline"].get("num_stages", 0)))
        return opt_state, True
    raise CheckpointError(
        f"every checkpoint under {est._checkpoint_path!r} is corrupt"
    ) from last_err


def _batches(est, train_set, global_batch: int, epoch: int, skip: int):
    """Device ``(x, y, mask)`` training batches of ``epoch`` without the
    first ``skip``: a feature set through ``Estimator._batches``; a
    duck-typed set's host ``batches(...)`` (mask None: every row valid)."""
    if any(hasattr(train_set, a) for a in ("train_batches", "gather",
                                           "device_batches")):
        yield from est._batches(train_set, global_batch, epoch, skip)
        return
    try:
        host = train_set.batches(global_batch, shuffle=True, seed=epoch,
                                 start_step=skip)
    except TypeError:  # no start_step: produce and discard
        host = itertools.islice(train_set.batches(
            global_batch, shuffle=True, seed=epoch), skip, None)
    for x, y, *rest in host:
        yield (est._to_device(x), est._to_device(y),
               est._to_device(rest[0]) if rest else None)


# -- the driver -----------------------------------------------------------


def train_pipelined(est, train_set, criterion: Callable,
                    stage_plan: StagePlan, *,
                    num_microbatches: int = 1, schedule: str = "1f1b",
                    end_trigger=None, checkpoint_trigger=None,
                    batch_size: int = 32, auto_resume: bool = False):
    """Pipeline-parallel training over ``stage_plan``'s K stages.

    ``batch_size`` is the GLOBAL batch, rounded up to divide
    ``num_microbatches``, then split into M contiguous row slices that
    flow through the schedule. With ``K=1, M=1`` the step is one fused
    program: the unpipelined baseline of the parity contract (the module
    docstring). The optimizer state starts fresh on every call, unless
    ``auto_resume`` restores one, as in the JAX package; it is left in
    ``est.tstate`` at the end."""
    from analytics_zoo_tpu_torch.common.observability import (
        get_tracer,
        training_metrics,
    )
    from analytics_zoo_tpu_torch.engine import triggers as trig
    from analytics_zoo_tpu_torch.engine.estimator import (
        TrainState,
        _round_batch,
    )
    from analytics_zoo_tpu_torch.ft import distributed as dist_lib
    from analytics_zoo_tpu_torch.ft.preemption import PreemptedError

    if not isinstance(stage_plan, StagePlan):
        raise TypeError(
            f"stage_plan must be a StagePlan, got "
            f"{type(stage_plan).__name__}")
    if est.gradient_accumulation > 1:
        raise NotImplementedError(
            "train_pipelined does not support gradient_accumulation > 1 "
            "— the schedule already accumulates over its microbatches; "
            "raise num_microbatches instead")
    if est.zero1:
        raise NotImplementedError(
            "zero1 is not supported under train_pipelined (optimizer "
            "state is stage-partitioned at checkpoint time instead)")

    est._ensure_state()
    segments = stage_plan.split(est.model)
    layer_stages = {layer.name: seg.stage
                    for seg in segments for layer in seg.layers}
    covered = {name for seg in segments for name in seg.names}
    orphaned = sorted(set(est.tstate.params) - covered)
    if orphaned:
        raise ValueError(
            f"params exist for layer(s) {orphaned} that the StagePlan "
            "did not assign — stage split would silently drop their "
            "gradients")

    k = stage_plan.num_stages
    m_total = int(num_microbatches)
    if m_total < 1:
        raise ValueError(
            f"num_microbatches must be >= 1, got {num_microbatches}")
    sched = MicrobatchSchedule(k, m_total, mode=schedule)
    events = sched.events()
    pool_sizes = sched.measured_slots()
    global_batch = _round_batch(batch_size, m_total)
    mb_rows = global_batch // m_total

    programs = _build_programs(est, criterion, segments)
    tx = programs["tx"]
    opt_state = None
    resumed = False
    if (auto_resume and est._checkpoint_path is not None
            and est.run_state.iteration == 0):
        opt_state, resumed = _resume_pipelined(
            est, tx, est._init_opt_state(est.tstate.params))
    if opt_state is None:
        opt_state = est._init_opt_state(est.tstate.params)
    # the loop carries the live optimizer state itself
    est.tstate = est.tstate._replace(opt_state=None)

    rs = est.run_state
    end_trigger = end_trigger or trig.MaxEpoch(rs.epoch + 1)
    checkpoint_trigger = checkpoint_trigger or trig.EveryEpoch()
    transform = getattr(train_set, "device_transform", None)
    seed = int(est.ctx.conf.seed)
    obs = training_metrics()
    tracer = get_tracer()
    save_error: List[Optional[BaseException]] = [None]
    last_saved = [rs.iteration if resumed else -1]

    def _save(coordinated_exit: bool = False):
        if save_error[0] is not None:
            err, save_error[0] = save_error[0], None
            raise err
        if est._checkpoint_path is None:
            return None
        if last_saved[0] == rs.iteration:
            return os.path.join(est._checkpoint_path,
                                f"ckpt_{rs.iteration}")
        try:
            path = _write_pipelined_checkpoint(
                est, stage_plan, layer_stages, tx, opt_state, sched)
        except (dist_lib.DistTimeoutError, dist_lib.DistCommitError) as e:
            if coordinated_exit:
                raise
            logger.error("pipelined checkpoint at iteration %d failed "
                         "(%s) — training continues; the error re-raises "
                         "at the next save attempt", rs.iteration, e)
            save_error[0] = e
            return None
        last_saved[0] = rs.iteration
        return path

    def _preempt_exit():
        path = _save(coordinated_exit=True)
        raise PreemptedError(
            f"training preempted at iteration {rs.iteration}"
            + (f"; checkpoint committed at {path}" if path else
               " (no checkpoint directory configured — state NOT saved)"),
            checkpoint_path=path)

    try:
        while not end_trigger(rs):
            rs.epoch_finished = False
            epoch_start = time.time()
            epoch_loss, epoch_batches = 0.0, 0
            for xs, y, mask in _batches(est, train_set, global_batch,
                                        rs.epoch, rs.epoch_step):
                if transform is not None:
                    xs = transform(xs)
                if mask is None:
                    rows = tree_leaves(y)[0].shape[0]
                    mask = torch.ones((rows,), dtype=torch.float32,
                                      device=est.ctx.device)
                mask = mask.float()
                params = est.tstate.params
                stage_params = [
                    {name: params[name] for name in seg.names
                     if name in params} for seg in segments]
                stage_state = [
                    {name: est.tstate.model_state.get(name, {})
                     for name in seg.names
                     if name in est.tstate.model_state}
                    for seg in segments]
                slots = ActivationSlots(pool_sizes)
                with tracer.span("train.dispatch", kind="pipeline_step",
                                 stages=k, microbatches=m_total):
                    gsum, ls_tot, cnt_tot, new_mstate = _run_schedule(
                        programs, stage_params, stage_state, events, slots,
                        k, m_total, mb_rows, xs, y, mask,
                        (seed, rs.iteration))
                    with torch.inference_mode(False):
                        new_params, opt_state = programs["combine"](
                            params, gsum, cnt_tot, opt_state)
                loss_val = float(ls_tot) / max(float(cnt_tot), 1.0)
                est.tstate = TrainState(new_params, new_mstate, None,
                                        est.tstate.step + 1)
                if est.time_steps and est.ctx.device.type == "cuda":
                    est.step_events.append(
                        torch.cuda.Event(enable_timing=True))
                    est.step_events[-1].record()
                rs.iteration += 1
                rs.epoch_step += 1
                rs.loss = loss_val
                est.train_losses.append(loss_val)
                epoch_loss += loss_val
                epoch_batches += 1
                obs["steps"].inc()
                if est.train_summary is not None:
                    est.train_summary.add_scalar("Loss", loss_val,
                                                 rs.iteration)
                if est._preemption is not None and est._preemption.requested:
                    _preempt_exit()
                if end_trigger(rs):
                    break
                if (checkpoint_trigger(rs) and not isinstance(
                        checkpoint_trigger, trig.EveryEpoch)):
                    _save()
            rs.epoch += 1
            rs.epoch_step = 0
            rs.epoch_finished = True
            logger.info("Epoch %d done in %.2fs — mean loss %.5f (%d "
                        "stages, %d microbatches, %s)", rs.epoch,
                        time.time() - epoch_start,
                        epoch_loss / max(epoch_batches, 1), k, m_total,
                        sched.mode)
            if checkpoint_trigger(rs):
                _save()
            if est._preemption is not None and est._preemption.requested:
                _preempt_exit()
        if save_error[0] is not None:
            err, save_error[0] = save_error[0], None
            raise err
    finally:
        est.tstate = est.tstate._replace(opt_state=opt_state)
        est._write_back()
    return est
