"""TFEstimator (port of ``analytics_zoo_tpu.tfpark.estimator``; ref
pyzoo/zoo/tfpark/estimator.py:82, the model_fn protocol :87-117).

``model_fn(mode, params)`` returns an :class:`EstimatorSpec` naming a
model-protocol object, a loss and an optimizer; train, evaluate and
predict drive the port's ``Estimator``. The reference's TF freeze/export
machinery has no counterpart: the engine differentiates the model itself.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet
from analytics_zoo_tpu_torch.engine.estimator import Estimator
from analytics_zoo_tpu_torch.engine.triggers import MaxIteration
from analytics_zoo_tpu_torch.keras import metrics as metrics_lib
from analytics_zoo_tpu_torch.keras import objectives as objectives_lib
from analytics_zoo_tpu_torch.keras import optimizers as optimizers_lib
from analytics_zoo_tpu_torch.tfpark.tf_dataset import TFDataset

TRAIN, EVAL, PREDICT = "train", "eval", "infer"


@dataclasses.dataclass
class EstimatorSpec:
    """Ref tf.estimator.EstimatorSpec analogue."""

    mode: str
    model: Any = None                  # model-protocol object (KerasNet, ...)
    loss: Any = None                   # loss name or callable
    optimizer: Any = None              # optimizer name/factory/transform
    eval_metrics: Sequence = ()


class TFEstimator:
    """tf.estimator-style train/evaluate/predict over a ``model_fn``
    returning TFEstimatorSpec (ref TFEstimator,
    APIGuide/TFPark/estimator)."""
    def __init__(self, model_fn: Callable, params: Optional[Dict] = None,
                 model_dir: Optional[str] = None):
        self.model_fn = model_fn
        self.params = params or {}
        self.model_dir = model_dir
        self._estimator: Optional[Estimator] = None
        self._specs: Dict[str, EstimatorSpec] = {}
        self._model = None  # one model instance shared across modes

    def _build(self, mode: str) -> EstimatorSpec:
        """Per-mode spec cache (model_fn may branch on mode, ref protocol);
        the MODEL instance is shared so weights persist across modes."""
        spec = self._specs.get(mode)
        if spec is None:
            spec = self.model_fn(mode=mode, params=self.params)
            if spec.model is None:
                raise ValueError("model_fn must set EstimatorSpec.model")
            if self._model is None:
                self._model = spec.model
            else:
                spec = dataclasses.replace(spec, model=self._model)
            self._specs[mode] = spec
        return spec

    def _engine(self) -> Estimator:
        if self._estimator is None:
            spec = self._build(TRAIN)
            opt = optimizers_lib.get(spec.optimizer or "adam")
            self._estimator = Estimator(spec.model, opt, model_dir=self.model_dir)
            if self.model_dir:
                self._estimator.set_checkpoint(self.model_dir)
        return self._estimator

    def train(self, input_fn: Callable, steps: Optional[int] = None) -> "TFEstimator":
        """Ref TFEstimator.train — input_fn returns a TFDataset."""
        dataset: TFDataset = input_fn()
        spec = self._build(TRAIN)
        est = self._engine()
        end = MaxIteration(est.run_state.iteration + steps) if steps else None
        est.train(dataset.feature_set, objectives_lib.get(spec.loss),
                  end_trigger=end, batch_size=dataset.batch_size)
        return self

    def evaluate(self, input_fn: Callable, eval_methods: Sequence = ("loss",)
                 ) -> Dict[str, float]:
        """EVAL-mode metrics over input_fn batches (ref TFEstimator.evaluate).
        """
        dataset: TFDataset = input_fn()
        spec = self._build(EVAL)
        est = self._engine()
        metric_objs = []
        for m in eval_methods:
            if m == "loss":
                metric_objs.append(metrics_lib.Loss(objectives_lib.get(spec.loss)))
            else:
                metric_objs.append(metrics_lib.get(m))
        return est.evaluate(dataset.feature_set, metric_objs,
                            batch_size=dataset.batch_size)

    def predict(self, input_fn: Callable) -> np.ndarray:
        """PREDICT-mode outputs over input_fn batches (ref TFEstimator.predict).
        """
        dataset: TFDataset = input_fn()
        self._build(PREDICT)
        est = self._engine()
        return est.predict(dataset.feature_set, batch_size=dataset.batch_size)
