"""ZooModel base (port of ``analytics_zoo_tpu.models.common``): ref
models/common/ZooModel.scala:38 (buildModel, saveModel:78, loadModel:149,
predict).

A zoo model wraps a KerasNet built by :meth:`build_model`; persistence is
the architecture config (``model.json``) and the weights (a ``weights``
checkpoint directory from ``save_weights``), as in the JAX package, so
``load_model`` also reads a directory that the JAX package's
``save_model`` wrote.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from analytics_zoo_tpu_torch.keras.engine.topology import KerasNet
from analytics_zoo_tpu_torch.predictor import Predictable


class ZooModel(Predictable):
    """Base: subclasses set ``self.model`` in ``build_model()`` and are
    registered by class name for ``load_model``."""

    _REGISTRY: Dict[str, type] = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        ZooModel._REGISTRY[cls.__name__] = cls

    def __init__(self):
        self.model: Optional[KerasNet] = None

    def build_model(self) -> KerasNet:
        raise NotImplementedError

    def config(self) -> Dict[str, Any]:
        """JSON-serializable constructor arguments (the save/load round
        trip)."""
        raise NotImplementedError

    # -- training surface (delegates to the wrapped KerasNet) -------------

    def compile(self, *a, **kw):
        self.model.compile(*a, **kw)
        return self

    def fit(self, *a, **kw):
        self.model.fit(*a, **kw)
        return self

    def evaluate(self, *a, **kw):
        return self.model.evaluate(*a, **kw)

    def predict(self, *a, **kw):
        return self.model.predict(*a, **kw)

    def predict_classes(self, *a, **kw):
        return self.model.predict_classes(*a, **kw)

    def set_tensorboard(self, *a, **kw):
        self.model.set_tensorboard(*a, **kw)
        return self

    def set_checkpoint(self, *a, **kw):
        self.model.set_checkpoint(*a, **kw)
        return self

    def summary(self):
        return self.model.summary()

    # -- persistence (ref ZooModel.saveModel:78 / loadModel:149) ----------

    def save_model(self, path: str, overwrite: bool = True) -> None:
        """``path/model.json`` (class and config) and ``path/weights``."""
        os.makedirs(path, exist_ok=True)
        meta = {"class": type(self).__name__, "config": self.config()}
        with open(os.path.join(path, "model.json"), "w") as f:
            json.dump(meta, f, indent=2)
        self.model.save_weights(os.path.join(path, "weights"),
                                overwrite=overwrite)

    @staticmethod
    def load_model(path: str) -> "ZooModel":
        """Rebuild the saved class from its config and load its weights
        (leaves matched by name, counter names by order)."""
        with open(os.path.join(path, "model.json")) as f:
            meta = json.load(f)
        cls = ZooModel._REGISTRY[meta["class"]]
        if hasattr(cls, "_from_config"):
            inst = cls._from_config(meta["config"])
        else:
            inst = cls(**meta["config"])
        inst.model.load_weights(os.path.join(path, "weights"))
        return inst


class Ranker:
    """Ranking evaluation mixin (ref Ranker.evaluateMAP:80 /
    evaluateNDCG:98): ``evaluate_*`` take an iterable of (scores, labels)
    per query group."""

    def evaluate_map(self, grouped, threshold: float = 0.0) -> float:
        from analytics_zoo_tpu_torch.keras.metrics import evaluate_map

        return evaluate_map(grouped, threshold)

    def evaluate_ndcg(self, grouped, k: int = 10,
                      threshold: float = 0.0) -> float:
        from analytics_zoo_tpu_torch.keras.metrics import evaluate_ndcg

        return evaluate_ndcg(grouped, k, threshold)
