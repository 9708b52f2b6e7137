"""Prediction facade (port of ``analytics_zoo_tpu.predictor``): ref
pipeline/api/Predictor.scala:37 (``predictImage``:119, ``predict``:154,
``predictClass``:187) and the ``Predictable`` trait (:203).

``Predictor`` predicts with any KerasNet (or a ``ZooModel`` wrapping one)
over arrays, FeatureSets and ImageSets (materialised through their
transform chain), extracts classes, and writes results back into the
ImageSet's features; ``output_layer`` cuts a functional ``Model`` at an
interior layer through ``Model.new_graph``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _as_data(data):
    from analytics_zoo_tpu_torch.data.image_set import ImageSet

    return data.to_feature_set() if isinstance(data, ImageSet) else data


class Predictor:
    """Wraps any KerasNet-protocol model for batched prediction."""

    def __init__(self, model):
        # a ZooModel wrapper or a bare KerasNet: only a missing or None
        # ``.model`` falls back to the object itself
        inner = getattr(model, "model", None)
        self.model = model if inner is None else inner

    def predict(self, data, batch_size: int = 32) -> np.ndarray:
        """Ref Predictor.predict:154: ``data`` an ndarray (or a list of
        them), a FeatureSet or an ImageSet."""
        return self.model.predict(_as_data(data), batch_size=batch_size)

    def predict_classes(self, data, batch_size: int = 32,
                        zero_based_label: bool = True) -> np.ndarray:
        """Ref Predictor.predictClass:187, through the model's
        ``predict_classes`` (ImageSets materialised first)."""
        return self.model.predict_classes(_as_data(data),
                                          batch_size=batch_size,
                                          zero_based_label=zero_based_label)

    def predict_image(self, image_set, output_layer: Optional[str] = None,
                      batch_size: int = 32, predict_key: str = "predict"):
        """Ref Predictor.predictImage:119: run the model (or, with
        ``output_layer``, the graph cut at that layer) over an ImageSet
        and attach each row of the result to its ImageFeature under
        ``predict_key``; returns the same ImageSet."""
        model = self.model
        if output_layer is not None:
            if not hasattr(model, "new_graph"):
                raise ValueError(
                    "output_layer requires a functional Model (GraphNet)")
            model = model.new_graph(output_layer)
        preds = model.predict(image_set.to_feature_set(),
                              batch_size=batch_size)
        if isinstance(preds, (list, tuple)):
            raise ValueError(
                "predict_image expects a single-output model (got "
                f"{len(preds)} outputs); cut the graph with output_layer "
                "or attach outputs manually")
        for feature, p in zip(image_set.features, preds):
            feature[predict_key] = np.asarray(p)
        return image_set


class Predictable:
    """Mixin (ref Predictable trait, Predictor.scala:203): the
    image-prediction surface of a model wrapper."""

    def predict_image(self, image_set, output_layer: Optional[str] = None,
                      batch_size: int = 32, predict_key: str = "predict"):
        return Predictor(self).predict_image(
            image_set, output_layer=output_layer, batch_size=batch_size,
            predict_key=predict_key)
