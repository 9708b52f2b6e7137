"""TFPark surfaces (port of ``analytics_zoo_tpu.tfpark``): ``TFDataset``,
``TFOptimizer`` (with ``to_optax_optim_method``), ``TFEstimator`` and
``EstimatorSpec``, ``TFPredictor``, ``KerasModel`` for zoo nets,
``BERTClassifier`` (a ``TFEstimator`` over ``tfpark.bert``'s
``BERTClassifierNet``) and the text models of ``tfpark.text`` (NER,
SequenceTagger/POSTagger, IntentEntity)."""

from analytics_zoo_tpu_torch.tfpark.bert import BERTClassifier
from analytics_zoo_tpu_torch.tfpark.estimator import EstimatorSpec, TFEstimator
from analytics_zoo_tpu_torch.tfpark.model import KerasModel
from analytics_zoo_tpu_torch.tfpark.text import (
    NER,
    IntentEntity,
    POSTagger,
    SequenceTagger,
    TextKerasModel,
)
from analytics_zoo_tpu_torch.tfpark.tf_dataset import TFDataset
from analytics_zoo_tpu_torch.tfpark.tf_optimizer import (
    TFOptimizer,
    to_optax_optim_method,
)
from analytics_zoo_tpu_torch.tfpark.tf_predictor import TFPredictor

TFEstimatorSpec = EstimatorSpec  # the reference's name (zoo.tfpark)

__all__ = ["TFDataset", "KerasModel", "TFEstimator", "EstimatorSpec",
           "TFEstimatorSpec", "TFPredictor", "TFOptimizer",
           "to_optax_optim_method", "BERTClassifier", "NER", "POSTagger",
           "SequenceTagger", "IntentEntity", "TextKerasModel"]
