"""TFPredictor (port of ``analytics_zoo_tpu.tfpark.tf_predictor``; ref
pyzoo/zoo/pipeline/api/net/tf_predictor.py:28): batch prediction of a model
over a :class:`TFDataset`.

The model is a zoo net (anything with ``predict(feature_set,
batch_size)``), a ``TFNet`` from ``Net.load_tf`` (its interpreted graph,
``.fn``, runs on the context's device), or a batch function ``f(x) -> y``
over the dataset's host arrays. A multi-input graph takes the dataset's
feature arrays as positional inputs; of a multi-output graph the first
head is returned.
"""

from __future__ import annotations

import numpy as np
import torch


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
        """A predictor over an imported foreign graph (``Net.load_tf``, a
        ``TFNet``, or its ``GraphFunction``)."""
        return cls(tfnet, dataset)

    def predict(self) -> np.ndarray:
        """The model's outputs over the dataset, in dataset order, as a
        host ndarray (a multi-output function's first head)."""
        ds = self.dataset
        if hasattr(self.model, "predict"):
            return self.model.predict(ds.feature_set,
                                      batch_size=ds.batch_size)
        # a TFNet is a layer (symbolic __call__, no predict): its numeric
        # forward is the interpreted GraphFunction at .fn
        fn = getattr(self.model, "fn", None) or self.model
        outs = []
        for idx, mask in ds.feature_set.eval_index_batches(ds.batch_size):
            x, _ = ds.feature_set.take(idx)
            with torch.inference_mode():
                y = fn(*x) if isinstance(x, (list, tuple)) else fn(x)
            if isinstance(y, (tuple, list)):
                y = y[0]
            if isinstance(y, torch.Tensor):
                y = y.detach().float().cpu().numpy() \
                    if y.is_floating_point() else y.cpu().numpy()
            outs.append(np.asarray(y)[np.asarray(mask).astype(bool)])
        return np.concatenate(outs, axis=0)
