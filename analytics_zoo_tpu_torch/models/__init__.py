"""Model zoo (port of ``analytics_zoo_tpu.models``): the ``ZooModel`` base
and ``Ranker``, ``TextClassifier``, the recommenders (NeuralCF, Wide & Deep,
SessionRecommender), ``AnomalyDetector``, ``Seq2seq`` and ``KNRM``; the
image classifiers and detectors are in ``models.image``."""

from analytics_zoo_tpu_torch.models.anomalydetection import AnomalyDetector
from analytics_zoo_tpu_torch.models.common import Ranker, ZooModel
from analytics_zoo_tpu_torch.models.recommendation import (
    ColumnFeatureInfo,
    NeuralCF,
    Recommender,
    SessionRecommender,
    WideAndDeep,
)
from analytics_zoo_tpu_torch.models.seq2seq import Seq2seq
from analytics_zoo_tpu_torch.models.textclassification import TextClassifier
from analytics_zoo_tpu_torch.models.textmatching import KNRM

__all__ = [
    "ZooModel", "Ranker", "TextClassifier", "NeuralCF", "WideAndDeep",
    "ColumnFeatureInfo", "Recommender", "SessionRecommender",
    "AnomalyDetector", "Seq2seq", "KNRM",
]
