"""nnframes: the DataFrame ML pipeline over the training engine (port of
``analytics_zoo_tpu.nnframes.nn_estimator``).

Ref pipeline/nnframes: ``NNEstimator.fit(df)`` (NNEstimator.scala:183,
internalFit:392) turns a DataFrame's columns into samples, trains, and
wraps the result in an ``NNModel`` transformer; ``NNClassifier`` adds
classification sugar (NNClassifier.scala:42); ``NNImageReader`` builds an
image DataFrame (NNImageReader.scala:144).

The frame is duck-typed as in the JAX package: anything with ``toPandas``
(a Spark DataFrame) is converted, and anything else is used as it is if it
has ``__getitem__`` by column name, ``columns``, ``copy`` and
``__setitem__`` (a pandas DataFrame, or a minimal column object). pandas is
imported only by ``NNImageReader.read_images``, which returns a pandas
frame; nothing else needs it. ``fit`` materializes the feature column as a
float32 host array (``_col_to_array``) and trains through the port's
``Estimator`` from host batches.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np

from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet
from analytics_zoo_tpu_torch.engine.estimator import Estimator
from analytics_zoo_tpu_torch.engine.triggers import MaxEpoch
from analytics_zoo_tpu_torch.keras import metrics as metrics_lib
from analytics_zoo_tpu_torch.keras import objectives as objectives_lib
from analytics_zoo_tpu_torch.keras import optimizers as optimizers_lib


def _col_to_array(col) -> np.ndarray:
    vals = list(col)
    first = vals[0]
    if isinstance(first, (list, tuple, np.ndarray)):
        return np.asarray([np.asarray(v, np.float32) for v in vals])
    return np.asarray(vals)


def _to_pandas(df):
    if hasattr(df, "toPandas"):  # pyspark duck-typing
        return df.toPandas()
    return df


class _Params:
    """Spark-ML-style setter/getter params (ref NNEstimator's Params)."""

    def __init__(self):
        self.batch_size = 32
        self.max_epoch = 10
        self.features_col = "features"
        self.label_col = "label"
        self.prediction_col = "prediction"
        self.optim_method = None
        self.learning_rate = None
        self.validation = None  # (df, metrics, batch)
        self.checkpoint_path = None
        self.tensorboard = None
        self.clip = None

    def set_batch_size(self, v):
        self.batch_size = int(v)
        return self

    setBatchSize = set_batch_size

    def set_max_epoch(self, v):
        self.max_epoch = int(v)
        return self

    setMaxEpoch = set_max_epoch

    def set_features_col(self, v):
        self.features_col = v
        return self

    setFeaturesCol = set_features_col

    def set_label_col(self, v):
        self.label_col = v
        return self

    setLabelCol = set_label_col

    def set_prediction_col(self, v):
        self.prediction_col = v
        return self

    setPredictionCol = set_prediction_col

    def set_optim_method(self, opt):
        self.optim_method = opt
        return self

    setOptimMethod = set_optim_method

    def set_learning_rate(self, lr):
        self.learning_rate = float(lr)
        return self

    setLearningRate = set_learning_rate

    def set_validation(self, trigger, df, metrics, batch_size):
        """Ref setValidation — trigger accepted for parity (per-epoch here)."""
        self.validation = (df, metrics, batch_size)
        return self

    setValidation = set_validation

    def set_checkpoint(self, path):
        self.checkpoint_path = path
        return self

    setCheckpoint = set_checkpoint

    def set_tensorboard(self, log_dir, app_name):
        self.tensorboard = (log_dir, app_name)
        return self

    setTensorBoard = set_tensorboard

    def set_constant_gradient_clipping(self, lo, hi):
        self.clip = ("constant", (lo, hi))
        return self

    setConstantGradientClipping = set_constant_gradient_clipping

    def set_gradient_clipping_by_l2_norm(self, norm):
        self.clip = ("l2norm", (norm,))
        return self

    setGradientClippingByL2Norm = set_gradient_clipping_by_l2_norm


class NNEstimator(_Params):
    """Ref NNEstimator.scala:183. ``model`` is a KerasNet (or any engine
    model-protocol object); ``criterion`` a loss name/callable;
    ``feature_preprocessing`` an optional fn(row_features) -> ndarray."""

    def __init__(self, model, criterion,
                 feature_preprocessing: Optional[Callable] = None,
                 label_preprocessing: Optional[Callable] = None):
        super().__init__()
        self.model = model
        self.criterion = objectives_lib.get(criterion)
        self.feature_preprocessing = feature_preprocessing
        self.label_preprocessing = label_preprocessing

    def _extract(self, df, with_label=True):
        pdf = _to_pandas(df)
        x = _col_to_array(pdf[self.features_col])
        if self.feature_preprocessing is not None:
            x = np.asarray([self.feature_preprocessing(v) for v in x])
        y = None
        if with_label and self.label_col in pdf.columns:
            y = _col_to_array(pdf[self.label_col])
            if self.label_preprocessing is not None:
                y = np.asarray([self.label_preprocessing(v) for v in y])
        return x, y

    def _optimizer(self):
        if self.optim_method is not None:
            return optimizers_lib.get(self.optim_method)
        return optimizers_lib.Adam(lr=self.learning_rate or 1e-3)

    def _cast_labels(self, y):
        return y

    _model_cls = None  # set to NNModel below (forward reference)

    def fit(self, df):
        """Train on the frame's feature and label columns (host batches
        through ``Estimator.train``) and return the fitted ``NNModel``."""
        x, y = self._extract(df)
        y = self._cast_labels(y)
        est = Estimator(self.model, self._optimizer())
        if self.checkpoint_path:
            est.set_checkpoint(self.checkpoint_path)
        if self.tensorboard:
            est.set_tensorboard(*self.tensorboard)
        if self.clip:
            kind, args = self.clip
            (est.set_constant_gradient_clipping(*args) if kind == "constant"
             else est.set_l2_norm_gradient_clipping(*args))
        val_set = val_metrics = None
        val_batch = None
        if self.validation is not None:
            vdf, vmetrics, val_batch = self.validation
            vx, vy = self._extract(vdf)
            val_set = ArrayFeatureSet(vx, self._cast_labels(vy))
            val_metrics = [metrics_lib.get(m) for m in vmetrics]
        est.train(ArrayFeatureSet(x, y), self.criterion,
                  end_trigger=MaxEpoch(self.max_epoch),
                  validation_set=val_set, validation_method=val_metrics,
                  batch_size=self.batch_size,
                  validation_batch_size=val_batch)
        return self._wrap(est)

    def _wrap(self, est):
        m = self._model_cls(self.model, estimator=est)
        m.features_col = self.features_col
        m.prediction_col = self.prediction_col
        m.batch_size = self.batch_size
        m.feature_preprocessing = self.feature_preprocessing
        return m


class NNModel(_Params):
    """Transformer wrapping a trained model (ref NNModel, NNEstimator.scala:571):
    ``transform`` appends the prediction column."""

    def __init__(self, model, estimator: Optional[Estimator] = None):
        super().__init__()
        self.model = model
        self.estimator = estimator or Estimator(model, None)
        self.feature_preprocessing = None

    def _predict(self, df):
        pdf = _to_pandas(df).copy()
        x = _col_to_array(pdf[self.features_col])
        if self.feature_preprocessing is not None:
            x = np.asarray([self.feature_preprocessing(v) for v in x])
        preds = self.estimator.predict(ArrayFeatureSet(x), self.batch_size)
        return pdf, preds

    def transform(self, df):
        """Append the prediction column to a (pandas or Spark) DataFrame
        (ref NNModel.transform).
        """
        pdf, preds = self._predict(df)
        pdf[self.prediction_col] = [p.tolist() if np.ndim(p) else float(p)
                                    for p in preds]
        return pdf

    def save(self, path: str):
        """Write the wrapped model's weights (ref NNModel.save)."""
        self.model.save_weights(path)

    def load(self, path: str):
        """Load weights written by save (ref NNModel.load)."""
        self.model.load_weights(path)
        return self


class NNClassifier(NNEstimator):
    """Ref NNClassifier.scala:42 — int labels + sparse CE default."""

    def __init__(self, model, criterion="sparse_categorical_crossentropy",
                 feature_preprocessing=None):
        super().__init__(model, criterion, feature_preprocessing)

    def _cast_labels(self, y):
        return np.asarray(y).astype(np.int32) if y is not None else None


class NNClassifierModel(NNModel):
    """Ref NNClassifierModel:140 — prediction column is the argmax class."""

    def transform(self, df):
        pdf, probs = self._predict(df)
        pdf[self.prediction_col] = np.argmax(probs, axis=-1)
        return pdf


class NNImageReader:
    """Ref NNImageReader.scala:144 — read images into a DataFrame with
    columns (image, height, width, n_channels, mode, origin [, label])."""

    @staticmethod
    def read_images(path: str, with_label: bool = False,
                    resize_h: Optional[int] = None,
                    resize_w: Optional[int] = None):
        """Read an image directory/glob into a DataFrame with the reference's
        (image, height, width, n_channels, mode, origin) columns.
        """
        import pandas as pd

        from analytics_zoo_tpu_torch.data.image_set import (
            ImageResize,
            ImageSet,
        )

        iset = ImageSet.read(path, with_label=with_label)
        if resize_h and resize_w:
            iset.transform(ImageResize(resize_h, resize_w))
        rows = []
        for f, img in zip(iset.features, iset.get_image()):
            row = {"origin": f.get("uri"), "image": img,
                   "height": img.shape[0], "width": img.shape[1],
                   "n_channels": img.shape[2] if img.ndim == 3 else 1,
                   "mode": "BGR"}
            if "label" in f:
                row["label"] = f["label"]
            rows.append(row)
        return pd.DataFrame(rows)

    readImages = read_images


# forward references for the Estimator->Model factory
NNEstimator._model_cls = NNModel
NNClassifier._model_cls = NNClassifierModel
