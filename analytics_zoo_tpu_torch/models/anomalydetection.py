"""Anomaly detection (port of ``analytics_zoo_tpu.models.anomalydetection``;
ref models/anomalydetection/AnomalyDetector.scala:40).

buildModel:46-62: stacked LSTMs (the hidden sizes, dropout after each)
ending in Dense(output_dim), a next-step regressor. ``unroll`` windows a
series into (unroll_length, feature) samples (ref FeatureLabelIndex:66);
``detect_anomalies`` flags the top-N absolute prediction errors. The data
utilities are numpy, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
from analytics_zoo_tpu_torch.keras.layers import LSTM, Dense, Dropout
from analytics_zoo_tpu_torch.models.common import ZooModel


@dataclasses.dataclass
class FeatureLabelIndex:
    """Ref FeatureLabelIndex (pyzoo anomaly_detector.py): one unrolled
    window with its label and source index, for order-preserving splits."""

    feature: "np.ndarray"
    label: float
    index: int


class AnomalyDetector(ZooModel):
    """Stacked-LSTM next-step regressor over (unroll_length, features)
    windows."""

    def __init__(self, feature_shape: Tuple[int, int],
                 hidden_layers: Sequence[int] = (8, 32, 15),
                 dropouts: Sequence[float] = (0.2, 0.2, 0.2),
                 output_dim: int = 1):
        super().__init__()
        self.feature_shape = tuple(feature_shape)
        self.hidden_layers = tuple(hidden_layers)
        self.dropouts = tuple(dropouts)
        self.output_dim = output_dim
        self.model = self.build_model()

    def build_model(self) -> Sequential:
        m = Sequential(name="anomaly_detector")
        n = len(self.hidden_layers)
        for i, (units, drop) in enumerate(zip(self.hidden_layers,
                                              self.dropouts)):
            kw = {"input_shape": self.feature_shape} if i == 0 else {}
            m.add(LSTM(units, return_sequences=(i < n - 1), **kw))
            m.add(Dropout(drop))
        m.add(Dense(self.output_dim))
        return m

    def config(self):
        return {"feature_shape": list(self.feature_shape),
                "hidden_layers": list(self.hidden_layers),
                "dropouts": list(self.dropouts),
                "output_dim": self.output_dim}

    # -- data utilities (ref AnomalyDetector.unroll / FeatureLabelIndex) --

    @staticmethod
    def unroll(data: np.ndarray, unroll_length: int,
               predict_step: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """Window a (T, features) series into samples: x[i] = data[i:i+L],
        y[i] = data[i+L+step-1, 0]."""
        data = np.asarray(data, dtype=np.float32)
        if data.ndim == 1:
            data = data[:, None]
        n = len(data) - unroll_length - predict_step + 1
        x = np.stack([data[i:i + unroll_length] for i in range(n)])
        y = data[unroll_length + predict_step - 1:, 0][:n]
        return x, y.astype(np.float32)

    @staticmethod
    def unroll_indexed(data: np.ndarray, unroll_length: int,
                       predict_step: int = 1):
        """Like :meth:`unroll`, as reference-style
        :class:`FeatureLabelIndex` records."""
        x, y = AnomalyDetector.unroll(data, unroll_length, predict_step)
        return [FeatureLabelIndex(f, float(l), i)
                for i, (f, l) in enumerate(zip(x, y))]

    def detect_anomalies(self, y_true: np.ndarray, y_pred: np.ndarray,
                         anomaly_size: int = 5) -> List[int]:
        """Ref AnomalyDetector.detectAnomalies: the indices of the
        ``anomaly_size`` largest |error| points."""
        err = np.abs(np.asarray(y_true).ravel() - np.asarray(y_pred).ravel())
        return list(np.argsort(-err)[:anomaly_size])
