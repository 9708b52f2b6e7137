"""TFPredictor (port of ``analytics_zoo_tpu.tfpark.tf_predictor``; ref
pyzoo/zoo/pipeline/api/net/tf_predictor.py:28): batch prediction of a model
over a :class:`TFDataset`.

The model is a zoo net (anything with ``predict(feature_set,
batch_size)``) or a batch function ``f(x) -> y`` over the dataset's host
arrays. An imported TF graph (``from_tfnet``) waits for the foreign-model
importers (ROADMAP A6) and raises.
"""

from __future__ import annotations

import numpy as np


class TFPredictor:
    """Feed every element of a :class:`TFDataset` through a model's
    outputs."""

    def __init__(self, model, dataset):
        self.model = model
        self.dataset = dataset

    @classmethod
    def from_keras(cls, keras_model, dataset) -> "TFPredictor":
        """Ref tf_predictor.py:66: a predictor over a Keras-style model."""
        return cls(keras_model, dataset)

    @classmethod
    def from_tfnet(cls, tfnet, dataset) -> "TFPredictor":
        """A predictor over an imported TF graph: not ported yet."""
        raise NotImplementedError(
            "TFPredictor.from_tfnet: imported TF graphs (TFNet, Net.load_tf) "
            "wait for the foreign-model importers (ROADMAP A6)")

    def predict(self) -> np.ndarray:
        """The model's outputs over the dataset, in dataset order, as a
        host ndarray (a multi-output function's first head)."""
        ds = self.dataset
        if hasattr(self.model, "predict"):
            return self.model.predict(ds.feature_set,
                                      batch_size=ds.batch_size)
        outs = []
        for idx, mask in ds.feature_set.eval_index_batches(ds.batch_size):
            x, _ = ds.feature_set.take(idx)
            y = self.model(*x) if isinstance(x, (list, tuple)) else \
                self.model(x)
            if isinstance(y, (tuple, list)):
                y = y[0]
            outs.append(np.asarray(y)[np.asarray(mask).astype(bool)])
        return np.concatenate(outs, axis=0)
