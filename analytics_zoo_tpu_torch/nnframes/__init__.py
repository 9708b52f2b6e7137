"""nnframes (port of ``analytics_zoo_tpu.nnframes``)."""

from analytics_zoo_tpu_torch.nnframes.nn_estimator import (
    NNClassifier,
    NNClassifierModel,
    NNEstimator,
    NNImageReader,
    NNModel,
)

__all__ = ["NNEstimator", "NNModel", "NNClassifier", "NNClassifierModel",
           "NNImageReader"]
