"""Prediction facade (port of ``analytics_zoo_tpu.predictor``): ref
pipeline/api/Predictor.scala:37 (``predict``:154, ``predictClass``:187)
and the ``Predictable`` trait (:203).

``Predictor`` predicts over arrays and FeatureSets with any KerasNet (or a
``ZooModel`` wrapping one). The ImageSet branches (``predict_image`` and
ImageSet input) wait for the image-data port (ROADMAP A6) and raise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _no_image_sets(what: str):
    raise NotImplementedError(
        f"{what}: ImageSet prediction waits for the image-data port "
        "(data/image_set.py)")


class Predictor:
    """Wraps any KerasNet-protocol model for batched prediction."""

    def __init__(self, model):
        # a ZooModel wrapper or a bare KerasNet: only a missing or None
        # ``.model`` falls back to the object itself
        inner = getattr(model, "model", None)
        self.model = model if inner is None else inner

    def predict(self, data, batch_size: int = 32) -> np.ndarray:
        """Ref Predictor.predict:154: ``data`` an ndarray (or a list of
        them) or a FeatureSet."""
        return self.model.predict(data, batch_size=batch_size)

    def predict_classes(self, data, batch_size: int = 32,
                        zero_based_label: bool = True) -> np.ndarray:
        """Ref Predictor.predictClass:187, through the model's
        ``predict_classes``."""
        return self.model.predict_classes(data, batch_size=batch_size,
                                          zero_based_label=zero_based_label)

    def predict_image(self, image_set, output_layer: Optional[str] = None,
                      batch_size: int = 32, predict_key: str = "predict"):
        """Ref Predictor.predictImage:119."""
        _no_image_sets("predict_image")


class Predictable:
    """Mixin (ref Predictable trait, Predictor.scala:203): the
    image-prediction surface of a model wrapper."""

    def predict_image(self, image_set, output_layer: Optional[str] = None,
                      batch_size: int = 32, predict_key: str = "predict"):
        return Predictor(self).predict_image(
            image_set, output_layer=output_layer, batch_size=batch_size,
            predict_key=predict_key)
