"""Data: feature sets and the streaming pipeline (port of
``analytics_zoo_tpu.data``); ``sources``, ``text_set``, ``image_set`` and
``roi`` are imported by module."""

from analytics_zoo_tpu_torch.data.feature_set import (
    ArrayFeatureSet,
    FeatureSet,
    PairFeatureSet,
    TransformedFeatureSet,
)
from analytics_zoo_tpu_torch.data.pipeline import Pipeline, PipelineIterator

__all__ = ["FeatureSet", "ArrayFeatureSet", "PairFeatureSet",
           "TransformedFeatureSet", "Pipeline", "PipelineIterator"]
