"""TFOptimizer (port of ``analytics_zoo_tpu.tfpark.tf_optimizer``; ref
pyzoo/zoo/pipeline/api/net/tf_optimizer.py:57).

The reference freezes the user's TF graph, extracts the loss and its
gradients (from_loss:229 off a loss tensor, from_keras:238 off a compiled
tf.keras model), translates the TF optimizer to a BigDL OptimMethod
(to_bigdl_optim_method:276-373) and drives BigDL's DistriOptimizer
(optimize:388). As in the JAX package, autodiff is the engine's own
(``torch.autograd`` in the port), so what remains is a facade binding
(model, criterion, optimizer, dataset) to the ``Estimator``: the
optimizer table is :func:`to_optax_optim_method` (kept under the JAX
package's name, an alias of the port's ``optimizers.get``), and
``from_loss`` takes the model explicitly beside the criterion.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.engine.triggers import MaxEpoch, Trigger
from analytics_zoo_tpu_torch.tfpark.tf_dataset import TFDataset


def to_optax_optim_method(optim):
    """The to_bigdl_optim_method analogue (tf_optimizer.py:276-373): an
    optimizer given as a name string, a factory or an optimizer object, as
    the ``GradientTransformation`` the engine consumes (the port's
    ``optimizers.get``; the name is the JAX package's)."""
    from analytics_zoo_tpu_torch.keras import optimizers as kopt

    if optim is None:
        return None
    return kopt.get(optim)


def _split_feature_set(fs, val_split: float):
    """Tail-split a dataset into (train, val) by row index — the
    ``val_spilt`` semantics of the reference's from_keras."""
    from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet

    n = fs.num_samples
    n_val = max(1, int(n * val_split))
    if not hasattr(fs, "take"):
        raise NotImplementedError(
            "val_spilt needs an indexable dataset (take); pass an explicit "
            "val_dataset instead")
    tr_x, tr_y = fs.take(np.arange(0, n - n_val))
    va_x, va_y = fs.take(np.arange(n - n_val, n))
    train_fs = ArrayFeatureSet(tr_x, tr_y)
    val_fs = ArrayFeatureSet(va_x, va_y)
    # the splits must see the same pixels the original set fed the model
    # (uint8 + on-device normalize etc.) — carry the transform over
    train_fs.device_transform = getattr(fs, "device_transform", None)
    val_fs.device_transform = train_fs.device_transform
    return train_fs, val_fs


class TFOptimizer:
    """Binds a model + criterion + optimizer + dataset and drives the
    engine (the DistriOptimizer-loop stand-in). Build via
    :meth:`from_keras` (compiled zoo KerasNet) or :meth:`from_loss`."""

    def __init__(self, model, criterion, optim_method, dataset,
                 metrics: Optional[Sequence] = None,
                 val_dataset=None, val_split: float = 0.0):
        self.model = model
        self.criterion = criterion
        self.optim_method = to_optax_optim_method(optim_method)
        self.dataset = dataset
        self.metrics = list(metrics or [])
        self.val_dataset = val_dataset
        self.val_split = float(val_split)
        self._estimator = None

    # -- constructors (ref from_loss:229 / from_keras:238) ----------------

    @classmethod
    def from_keras(cls, keras_model, dataset, val_spilt: float = 0.0,
                   **kwargs) -> "TFOptimizer":
        """From a COMPILED zoo KerasNet (or tfpark.KerasModel): optimizer,
        loss and metrics come off the compile call, the way the reference
        reads them off tf.keras (``val_spilt`` [sic] keeps the reference's
        misspelled kwarg for drop-in compatibility)."""
        net = getattr(keras_model, "model", keras_model)  # unwrap KerasModel
        if getattr(net, "optim_method", None) is None or \
                getattr(net, "criterion", None) is None:
            raise ValueError(
                "from_keras needs a compiled model — call "
                "model.compile(optimizer, loss) first (ref reads the "
                "compiled tf.keras attributes the same way)")
        return cls(net, net.criterion, net.optim_method, dataset,
                   metrics=getattr(net, "validation_metrics", None),
                   val_split=val_spilt, **kwargs)

    @classmethod
    def from_loss(cls, loss, optim_method, *, model, dataset,
                  metrics: Optional[Sequence] = None,
                  **kwargs) -> "TFOptimizer":
        """Reference from_loss extracts the graph FROM the loss tensor; the
        engine's step needs the model itself, so ``model`` is a required
        keyword here. ``loss`` is a criterion callable
        (y_true, y_pred) -> scalar — e.g. an objectives.* function or an
        autograd CustomLoss."""
        return cls(model, loss, optim_method, dataset, metrics=metrics,
                   **kwargs)

    # -- training (ref optimize:388) --------------------------------------

    def set_train_summary(self, log_dir: str, app_name: str) -> "TFOptimizer":
        self._ensure_estimator().set_tensorboard(log_dir, app_name)
        return self

    def set_constant_gradient_clipping(self, min_value: float,
                                       max_value: float) -> "TFOptimizer":
        self._ensure_estimator().set_constant_gradient_clipping(
            min_value, max_value)
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float
                                         ) -> "TFOptimizer":
        self._ensure_estimator().set_l2_norm_gradient_clipping(clip_norm)
        return self

    def _ensure_estimator(self):
        if self._estimator is None:
            from analytics_zoo_tpu_torch.engine.estimator import Estimator

            if hasattr(self.model, "_get_estimator"):
                est = self.model._get_estimator()
            else:
                est = Estimator(self.model, self.optim_method)
            self._estimator = est
        return self._estimator

    def _arm_optimizer(self, est):
        """Install this TFOptimizer's optimizer right before training —
        reset (not assign), because the estimator may already hold state
        whose opt_state was built for another optimizer (or none, after a
        bare predict). Runs after the clipping setters so the rebuilt
        opt_state matches the full transform chain."""
        if self.optim_method is not None and \
                est.optim_method is not self.optim_method:
            est.reset_optimizer(self.optim_method)

    def optimize(self, end_trigger: Optional[Trigger] = None,
                 batch_size: Optional[int] = None) -> "TFOptimizer":
        """Train until ``end_trigger`` (default: one more epoch, the
        reference default)."""
        from analytics_zoo_tpu_torch.keras import objectives as objectives_lib

        est = self._ensure_estimator()
        self._arm_optimizer(est)
        ds = self.dataset
        if isinstance(ds, TFDataset):
            fs, bs = ds.feature_set, ds.batch_size
        else:
            fs, bs = ds, batch_size or 32
        criterion = (objectives_lib.get(self.criterion)
                     if isinstance(self.criterion, str) else self.criterion)
        val_set = self.val_dataset
        val_batch = None
        if isinstance(val_set, TFDataset):
            val_batch = val_set.batch_size
            val_set = val_set.feature_set
        if val_set is None and self.val_split > 0:
            fs, val_set = _split_feature_set(fs, self.val_split)
        est.train(fs, criterion,
                  end_trigger=end_trigger or MaxEpoch(est.run_state.epoch + 1),
                  batch_size=batch_size or bs,
                  validation_set=val_set,
                  validation_method=self.metrics if val_set is not None
                  else None,
                  validation_batch_size=val_batch)
        return self
