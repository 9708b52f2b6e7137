"""The training engine (port of ``analytics_zoo_tpu.engine.estimator``, the
subset the training slice needs).

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
no host sync per step. Host batches are copied to the device
(``torch.tensor``, never ``torch.from_numpy``, which would alias arrays the
caller may reuse); a feature set's ``device_transform`` runs on the device
batch before the cast. The model state (batch norm's moving statistics)
threads through the steps, and at the end of ``train`` the trained
parameters and state are written back to ``model.params`` and
``model.model_state``, where ``InferenceModel.do_load_keras`` and a later
``Estimator`` find them.

Not ported yet, and raising ``NotImplementedError`` where the JAX package
has a setter or an entry point: checkpoints and resume, summaries,
profiling, the step watchdog, preemption, gradient accumulation, ZeRO-1,
``train_distributed`` and ``train_pipelined``.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.nncontext import get_nncontext
from analytics_zoo_tpu_torch.common.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from analytics_zoo_tpu_torch.engine import triggers as trig
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


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet")


def _masked_mean(ps, mask):
    """Mean of a per-sample loss over the valid (mask 1) rows."""
    if mask is None:
        return ps.mean()
    return (ps * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def _clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm: scale every gradient by
    ``max_norm / norm`` when the global L2 norm is at least ``max_norm``
    (decided on the device, no host read)."""
    norm = torch.sqrt(sum((g * g).sum() for g in tree_leaves(grads)))
    return tree_map(lambda g: torch.where(norm < max_norm, g,
                                          (g / norm) * max_norm), grads)


class TrainState(NamedTuple):
    params: Any
    model_state: Any
    opt_state: Any
    step: int


class Estimator:
    """Uniform train/evaluate/predict facade over a model that implements
    ``ensure_params``/``params``, ``apply(params, state, x, training, rng)``,
    ``layers()`` and ``regularization(params)`` (``KerasNet`` does)."""

    def __init__(self, model, optim_method: Optional[
                     GradientTransformation] = None,
                 model_dir: Optional[str] = None, zero1: bool = False,
                 gradient_accumulation: int = 1):
        if model_dir is not None:
            _not_ported("checkpointing (model_dir)")
        if zero1:
            _not_ported("ZeRO-1")
        if int(gradient_accumulation) != 1:
            _not_ported("gradient accumulation")
        self.model = model
        self.optim_method = optim_method
        self.ctx = get_nncontext()
        self._clip_constant = None
        self._clip_l2norm: Optional[float] = None
        self.tstate: Optional[TrainState] = None
        self.run_state = trig.RunState()
        # every step's loss, in order (read at epoch ends): the series the
        # JAX package's train summary records as "Loss"
        self.train_losses: List[float] = []

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

    def set_checkpoint(self, *args, **kwargs):
        _not_ported("checkpointing")

    def resume_from_checkpoint(self, *args, **kwargs):
        _not_ported("checkpointing")

    def load_checkpoint(self, *args, **kwargs):
        _not_ported("checkpointing")

    def set_tensorboard(self, *args, **kwargs):
        _not_ported("training summaries")

    def set_profile(self, *args, **kwargs):
        _not_ported("profiling")

    def set_step_watchdog(self, *args, **kwargs):
        _not_ported("the step watchdog")

    def set_preemption_handler(self, *args, **kwargs):
        _not_ported("preemption handling")

    def train_distributed(self, *args, **kwargs):
        _not_ported("train_distributed")

    def train_pipelined(self, *args, **kwargs):
        _not_ported("train_pipelined")

    def _tx(self) -> GradientTransformation:
        if self.optim_method is None:
            raise RuntimeError("No optimizer set — call compile(optimizer, "
                               "loss) before training")
        opt = self.optim_method
        if self._clip_constant is not None:
            lo, hi = self._clip_constant

            def clip(grads):
                return tree_map(lambda g: torch.clamp(g, lo, hi), grads)
        elif self._clip_l2norm is not None:
            max_norm = self._clip_l2norm

            def clip(grads):
                return _clip_by_global_norm(grads, max_norm)
        else:
            return opt
        return GradientTransformation(
            opt.init, lambda grads, state, params=None: opt.update(
                clip(grads), state, params))

    # -- state -----------------------------------------------------------

    def _ensure_state(self):
        """The train state from the model's parameters (drawn from the
        context's generator if it has none), copied to the device as
        float32 master weights."""
        if self.tstate is None:
            self.model.ensure_params()
            dev = self.ctx.device
            params, state = (
                tree_map(lambda t: t.detach().to(dev, copy=True), tree)
                for tree in (self.model.params, self.model.model_state or {}))
            opt_state = (self._tx().init(params)
                         if self.optim_method is not None else None)
            self.tstate = TrainState(params, state, opt_state, 0)

    def reset_optimizer(self, optim_method: GradientTransformation) -> None:
        """Swap the optimizer, rebuilding its state for the current params
        (a compile() after training)."""
        self.optim_method = optim_method
        if self.tstate is not None:
            self.tstate = self.tstate._replace(
                opt_state=self._tx().init(self.tstate.params))

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

    def _make_train_step(self, criterion: Callable,
                         device_transform: Optional[Callable] = None
                         ) -> Callable:
        """``step(tstate, xs, y, mask) -> (tstate, device loss)``: forward
        (``device_transform`` first), backward and update."""
        tx = self._tx()
        model, cast = self.model, self._cast_for_compute
        generator = self.ctx.step_generator
        ps_criterion = objectives_lib.get_per_sample(criterion)
        update_mask = self._update_mask(self.tstate.params)
        trainable = (None if update_mask is None
                     else tree_leaves(update_mask))

        def loss_fn(params, model_state, xs, y, mask):
            if device_transform is not None:
                xs = device_transform(xs)
            pred, new_state = model.apply(cast(params), model_state,
                                          cast(xs), training=True,
                                          rng=generator)
            pred = pred.float()
            if mask is not None and ps_criterion is not None:
                # wrap-pad duplicates get zero loss weight
                loss = _masked_mean(ps_criterion(y, pred), mask)
            else:
                raw = criterion(y, pred)
                loss = (_masked_mean(raw.reshape(raw.shape[0], -1)
                                     .mean(dim=-1), mask)
                        if raw.dim() else raw)
            return loss + model.regularization(params), new_state, loss

        def step(tstate: TrainState, xs, y, mask):
            leaves = [t.detach().requires_grad_(True)
                      for t in tree_leaves(tstate.params)]
            with torch.enable_grad():
                total, new_mstate, loss = loss_fn(
                    tree_unflatten(tstate.params, leaves),
                    tstate.model_state, xs, y, mask)
                grads = torch.autograd.grad(total, leaves, allow_unused=True)
            with torch.no_grad():
                grads = [torch.zeros_like(p) if g is None else g
                         for g, p in zip(grads, leaves)]
                if trainable is not None:
                    # frozen grads are zeroed BEFORE the transform, so they
                    # neither inflate the clip norm nor feed moments
                    grads = [g if t else torch.zeros_like(g)
                             for g, t in zip(grads, trainable)]
                updates, new_opt = tx.update(
                    tree_unflatten(tstate.params, grads), tstate.opt_state,
                    tstate.params)
                updates = tree_leaves(updates)
                if trainable is not None:
                    updates = [u if t else torch.zeros_like(u)
                               for u, t in zip(updates, trainable)]
                new_params = tree_unflatten(
                    tstate.params, [p + u for p, u in zip(
                        tree_leaves(tstate.params), updates)])
            return (TrainState(new_params, new_mstate, new_opt,
                               tstate.step + 1), loss.detach())

        return step

    # -- batches ---------------------------------------------------------

    def _to_device(self, tree):
        dev = self.ctx.device
        # torch.tensor copies: the caller may reuse its arrays at once
        return tree_map(lambda a: None if a is None else torch.tensor(
            np.asarray(a), device=dev), tree)

    def _batches(self, data, batch_size: int, epoch: Optional[int]):
        """Device (x, y, mask) batches: training order for ``epoch``, or
        dataset order when ``epoch`` is None. A device-cached set gathers
        on the device from the host's index vector."""
        dev = self.ctx.device
        gather = getattr(data, "gather", None)
        if gather is not None:
            index_batches = (data.eval_index_batches(batch_size)
                             if epoch is None else data.train_index_batches(
                                 batch_size, shuffle=True, seed=epoch))
            for idx, mask in index_batches:
                x, y = gather(torch.tensor(idx, device=dev))
                yield x, y, torch.tensor(mask, device=dev)
            return
        host = (data.eval_batches(batch_size) if epoch is None
                else data.train_batches(batch_size, shuffle=True, seed=epoch))
        for x, y, mask in host:
            yield self._to_device(x), self._to_device(y), torch.tensor(
                mask, device=dev)

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
        (host arrays, or a device-cached set), then write the trained
        parameters and state back to ``model.params`` and
        ``model.model_state``."""
        if checkpoint_trigger is not None or auto_resume:
            _not_ported("checkpointing")
        self._ensure_state()
        rs = self.run_state
        end_trigger = end_trigger or trig.MaxEpoch(rs.epoch + 1)
        step = self._make_train_step(
            criterion, getattr(train_set, "device_transform", None))
        sync_loss = _uses_loss(end_trigger)
        if (objectives_lib.get_per_sample(criterion) is None
                and train_set.num_samples % batch_size != 0):
            logger.warning(
                "criterion %s has no per-sample form: the wrap-padded tail "
                "batch weights duplicated samples twice",
                getattr(criterion, "__name__", criterion))
        while not end_trigger(rs):
            rs.epoch_finished = False
            epoch_start = time.time()
            losses = []  # device scalars, read once at the epoch's end
            for xs, y, mask in self._batches(train_set, batch_size, rs.epoch):
                self.tstate, loss = step(self.tstate, xs, y, mask)
                rs.iteration += 1
                rs.epoch_step += 1
                losses.append(loss)
                if sync_loss:
                    rs.loss = loss.item()
                if end_trigger(rs):
                    break
            if losses:
                vals = torch.stack(losses).tolist()
                rs.loss = vals[-1]
                self.train_losses.extend(vals)
                logger.info("Epoch %d done in %.2fs — mean loss %.5f",
                            rs.epoch + 1, time.time() - epoch_start,
                            sum(vals) / len(vals))
            rs.epoch += 1
            rs.epoch_step = 0
            rs.epoch_finished = True
            if validation_set is not None and validation_method:
                results = self.evaluate(validation_set, validation_method,
                                        validation_batch_size or batch_size)
                for value in results.values():
                    rs.score = value
                logger.info("Validation @ epoch %d: %s", rs.epoch, results)
        self.model.params = self.tstate.params
        self.model.model_state = self.tstate.model_state
        return self

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
        return {m.name: m.finalize(0.0 if t is None else t.item(),
                                   0.0 if c is None else c.item())
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
