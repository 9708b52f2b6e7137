"""Model protocol and the compile/fit surface (port of ``KerasNet`` in
``analytics_zoo_tpu.keras.engine.topology``).

The protocol the engines use (``layers``, ``init``, ``apply``,
``regularization``, ``compute_dtype``) and the Keras-style training surface
over :class:`~analytics_zoo_tpu_torch.engine.estimator.Estimator`:
``compile``, ``fit`` (epochs continue across calls), ``evaluate``,
``predict``, ``predict_classes`` and the gradient-clipping setters.
``Sequential``/``Model``, ``InputLayer``/``Input``, weights persistence and
the summary/checkpoint/profile setters are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.data.feature_set import (
    ArrayFeatureSet,
    FeatureSet,
)
from analytics_zoo_tpu_torch.engine.triggers import MaxEpoch
from analytics_zoo_tpu_torch.keras import metrics as metrics_lib
from analytics_zoo_tpu_torch.keras import objectives as objectives_lib
from analytics_zoo_tpu_torch.keras import optimizers as optimizers_lib
from analytics_zoo_tpu_torch.keras.engine.base import (
    KerasLayer,
    Shape,
    materialize,
    unique_name,
)


class KerasNet(nn.Module):
    """The model protocol the Estimator trains and InferenceModel serves,
    with the compile/fit surface.

    ``params`` holds the model's parameter dict once it has one: drawn by
    :meth:`ensure_params` from the context's generator, carried over from
    the JAX package by ``interop.load_jax_params``, or written back by
    ``Estimator.train``.
    """

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name or unique_name(type(self).__name__.lower())
        # "bfloat16": InferenceModel casts float32 params and inputs to it
        # for the forward, and returns float outputs as float32.
        self.compute_dtype: Optional[str] = None
        self.params: Optional[Dict] = None
        self.model_state: Optional[Dict] = None
        self.optim_method = None
        self.criterion = None
        self.validation_metrics: List = []
        self._estimator = None
        self._clipping: Optional[Tuple[str, Tuple]] = None

    def layers(self) -> List[KerasLayer]:
        """The layer objects, flattened in graph order."""
        raise NotImplementedError

    def param_specs(self) -> Dict:
        """``{layer name: layer.param_specs()}`` for layers with params."""
        out = {}
        for layer in self.layers():
            specs = layer.param_specs()
            if specs:
                out[layer.name] = specs
        return out

    def init(self, generator: torch.Generator) -> Tuple[Dict, Dict]:
        """Initialize ``(params, state)`` from a generator."""
        return materialize(self.param_specs(), generator), {}

    def ensure_params(self) -> None:
        """Draw ``params`` from the context's root generator if the model
        has none yet."""
        if self.params is None:
            from analytics_zoo_tpu_torch.common.nncontext import get_nncontext

            self.params, self.model_state = self.init(
                get_nncontext().generator)

    def apply(self, params, state, x, training=False, rng=None):
        """Forward: ``(params, state, x) -> (pred, new_state)``."""
        raise NotImplementedError

    def regularization(self, params):
        """Total weight-penalty term added to the training loss: 0, since
        no layer of the port has a regularizer yet."""
        return 0.0

    def get_output_shape(self) -> Shape:
        """Batch-free output shape."""
        raise NotImplementedError

    def get_input_shape(self):
        """Batch-free input shape."""
        raise NotImplementedError

    # -- configuration ---------------------------------------------------

    def set_constant_gradient_clipping(self, min_value: float,
                                       max_value: float):
        """Clip every gradient to [min, max] (ref
        setConstantGradientClipping)."""
        self._clipping = ("constant", (min_value, max_value))
        if self._estimator is not None:
            self._estimator.set_constant_gradient_clipping(min_value,
                                                           max_value)
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float):
        """Global-norm gradient clipping (ref setGradientClippingByL2Norm)."""
        self._clipping = ("l2norm", (clip_norm,))
        if self._estimator is not None:
            self._estimator.set_l2_norm_gradient_clipping(clip_norm)
        return self

    # -- compile/fit/evaluate/predict ------------------------------------

    def compile(self, optimizer, loss, metrics: Optional[Sequence] = None,
                gradient_accumulation: int = 1):
        """Ref Topology.scala:128. Recompiling keeps the parameters and
        rebuilds only the optimizer state."""
        if int(gradient_accumulation) != 1:
            raise NotImplementedError("gradient accumulation is not ported "
                                      "yet")
        self.optim_method = optimizers_lib.get(optimizer)
        self.criterion = objectives_lib.get(loss)
        self.validation_metrics = list(metrics or [])
        if self._estimator is not None:
            self._estimator.reset_optimizer(self.optim_method)
        return self

    def _get_estimator(self):
        if self._estimator is None:
            from analytics_zoo_tpu_torch.engine.estimator import Estimator

            # optim_method may be None: a model predicts without compile;
            # training raises a friendly error via Estimator._tx
            est = Estimator(self, self.optim_method)
            if self._clipping:
                kind, args = self._clipping
                if kind == "constant":
                    est.set_constant_gradient_clipping(*args)
                else:
                    est.set_l2_norm_gradient_clipping(*args)
            self._estimator = est
        return self._estimator

    @staticmethod
    def _to_feature_set(x, y=None) -> FeatureSet:
        if isinstance(x, FeatureSet):
            return x
        return ArrayFeatureSet(x, y)

    def _metric_objs(self) -> List:
        objs = [metrics_lib.get(m) for m in self.validation_metrics]
        if self.criterion is not None:
            objs = [metrics_lib.Loss(self.criterion)] + objs
        return objs

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 10,
            validation_data=None, distributed: bool = True,
            validation_batch_size: Optional[int] = None):
        """Ref Topology.scala:336/411 — epochs continue across calls."""
        if self.criterion is None:
            raise RuntimeError("Call compile(optimizer, loss) before fit")
        train_set = self._to_feature_set(x, y)
        est = self._get_estimator()
        val_set = None
        if validation_data is not None:
            val_set = (validation_data
                       if isinstance(validation_data, FeatureSet)
                       else ArrayFeatureSet(validation_data[0],
                                            validation_data[1]))
        est.train(train_set, self.criterion,
                  end_trigger=MaxEpoch(est.run_state.epoch + nb_epoch),
                  validation_set=val_set,
                  validation_method=(self._metric_objs()
                                     if val_set is not None else None),
                  batch_size=batch_size,
                  validation_batch_size=validation_batch_size)
        return self

    def evaluate(self, x, y=None, batch_size: int = 32) -> Dict[str, float]:
        """Ref Topology.scala:489."""
        metric_objs = self._metric_objs()
        if not metric_objs:
            raise RuntimeError("Nothing to evaluate: call compile(optimizer, "
                               "loss[, metrics]) first")
        return self._get_estimator().evaluate(
            self._to_feature_set(x, y), metric_objs, batch_size)

    def predict(self, x, batch_size: int = 32,
                distributed: bool = True) -> np.ndarray:
        """Batched inference -> host ndarray; partial tail batches are
        wrap-padded and trimmed (output length == input length)."""
        return self._get_estimator().predict(self._to_feature_set(x),
                                             batch_size)

    def predict_classes(self, x, batch_size: int = 32,
                        zero_based_label: bool = True) -> np.ndarray:
        """Ref KerasNet.predictClasses — argmax over the class axis."""
        cls = np.argmax(self.predict(x, batch_size), axis=-1)
        return cls if zero_based_label else cls + 1
