"""Data: feature sets, the streaming pipeline and the 3D image transforms
(port of ``analytics_zoo_tpu.data``); ``sources``, ``text_set``,
``image_set`` and ``roi`` are imported by module."""

from analytics_zoo_tpu_torch.data.feature_set import (
    ArrayFeatureSet,
    FeatureSet,
    PairFeatureSet,
    TransformedFeatureSet,
)
from analytics_zoo_tpu_torch.data.image3d import (
    AffineTransform3D,
    CenterCrop3D,
    Crop3D,
    RandomCrop3D,
    Rotate3D,
)
from analytics_zoo_tpu_torch.data.pipeline import Pipeline, PipelineIterator

__all__ = ["FeatureSet", "ArrayFeatureSet", "PairFeatureSet",
           "TransformedFeatureSet", "Pipeline", "PipelineIterator",
           "AffineTransform3D", "CenterCrop3D", "Crop3D", "RandomCrop3D",
           "Rotate3D"]
