"""Data: feature sets (port of ``analytics_zoo_tpu.data``); ``text_set``,
``image_set`` and ``roi`` are imported by module."""

from analytics_zoo_tpu_torch.data.feature_set import (
    ArrayFeatureSet,
    FeatureSet,
    PairFeatureSet,
    TransformedFeatureSet,
)

__all__ = ["FeatureSet", "ArrayFeatureSet", "PairFeatureSet",
           "TransformedFeatureSet"]
