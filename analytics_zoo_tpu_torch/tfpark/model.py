"""tfpark.KerasModel (port of ``analytics_zoo_tpu.tfpark.model``; ref
pyzoo/zoo/tfpark/model.py:31): the reference's fit/evaluate/predict
surface (model.py:84-215) over the engine, for a zoo ``KerasNet``, which
passes through unchanged. A foreign tf.keras / Keras model needs the
converter (``keras_convert``), which waits for ROADMAP A6, TensorFlow
importers: it raises.
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.tfpark.tf_dataset import TFDataset


def _is_foreign_keras_model(obj) -> bool:
    """A live tf.keras / keras object (a keras class anywhere in its
    MRO, user subclasses of keras.Model included)."""
    return any((getattr(c, "__module__", "") or "").startswith(
        ("keras", "tensorflow")) for c in type(obj).__mro__)


class KerasModel:
    """A zoo model behind the reference's tfpark.KerasModel surface."""

    def __init__(self, model):
        if _is_foreign_keras_model(model):
            raise NotImplementedError(
                f"KerasModel({type(model).__name__}): converting a foreign "
                "tf.keras model waits for the Keras converter (ROADMAP A6, "
                "TensorFlow importers); pass a zoo KerasNet")
        self.source_model = None
        self.model = model

    @property
    def metrics_names(self):
        """Ref KerasModel.metrics_names (['loss', 'acc', ...])."""
        names = ["loss"]
        for m in getattr(self.model, "validation_metrics", None) or []:
            names.append(getattr(m, "name", str(m)))
        return names

    def fit(self, x=None, y=None, batch_size: int = 32, epochs: int = 1,
            validation_data=None, distributed: bool = True):
        """Train on arrays or a TFDataset (ref KerasModel.fit)."""
        val_batch = None
        if isinstance(validation_data, TFDataset):
            val_batch = validation_data.batch_size
            validation_data = validation_data.feature_set
        if isinstance(x, TFDataset):
            return self.model.fit(x.feature_set, batch_size=x.batch_size,
                                  nb_epoch=epochs,
                                  validation_data=validation_data,
                                  validation_batch_size=val_batch)
        return self.model.fit(x, y, batch_size=batch_size, nb_epoch=epochs,
                              validation_data=validation_data,
                              validation_batch_size=val_batch)

    def evaluate(self, x=None, y=None, batch_size: int = 32,
                 distributed: bool = True):
        """Loss and metrics over arrays or a TFDataset (ref
        KerasModel.evaluate)."""
        if isinstance(x, TFDataset):
            return self.model.evaluate(x.feature_set,
                                       batch_size=x.batch_size)
        return self.model.evaluate(x, y, batch_size=batch_size)

    def predict(self, x, batch_size: int = 32, distributed: bool = True):
        """Forward pass -> host ndarray (ref KerasModel.predict)."""
        if isinstance(x, TFDataset):
            return self.model.predict(x.feature_set, batch_size=x.batch_size)
        return self.model.predict(x, batch_size=batch_size)

    def save_weights(self, path: str):
        """Write the model's weights (a ``save_weights`` checkpoint)."""
        self.model.save_weights(path)

    def load_weights(self, path: str):
        """Load weights that save_weights wrote."""
        self.model.load_weights(path)
        return self
