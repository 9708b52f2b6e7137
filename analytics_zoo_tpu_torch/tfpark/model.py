"""tfpark.KerasModel (port of ``analytics_zoo_tpu.tfpark.model``; ref
pyzoo/zoo/tfpark/model.py:31).

Reference behavior: wrap a live, COMPILED tf.keras model and dispatch
fit/evaluate/predict either locally (driver TF session) or distributed
(TFOptimizer over BigDL, model.py:84-215) — the user brings a foreign
model object, and the platform trains it on its own engine.

Here a foreign tf.keras / Keras-3 model is CONVERTED on construction —
architecture via :mod:`analytics_zoo_tpu_torch.keras_convert` (config graph
-> zoo layers), weights copied layer by layer, and the source model's
compile state (optimizer, loss, metrics) translated to the engine's
vocabulary — after which fit/evaluate/predict run the engine's training
loop as any native model does. A zoo KerasNet is also accepted and passed
through unchanged, so both worlds enter the engine by the same door.
"""

from __future__ import annotations

import logging
import re
from typing import Sequence

from analytics_zoo_tpu_torch.tfpark.tf_dataset import TFDataset

logger = logging.getLogger("analytics_zoo_tpu_torch")


def _camel_to_snake(name: str) -> str:
    return re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "_", name).lower()


def _translate_optimizer(spec):
    """Serialized keras optimizer (or name string) -> engine optimizer.

    The analogue of the reference's ``to_bigdl_optim_method``
    (tf_optimizer.py:276-373): class + hyperparameters map to the
    matching factory in keras.optimizers; learning-rate schedules that
    don't serialize to a float fall back to the factory default with a
    warning (the reference table drops schedule state the same way).
    """
    from analytics_zoo_tpu_torch.keras import optimizers as kopt

    if spec is None or isinstance(spec, str):
        return kopt.get(spec or "adam")
    cls = spec.get("class_name", "Adam")
    cfg = spec.get("config", {})

    def num(key, default):
        v = cfg.get(key, default)
        if key == "learning_rate" and "learning_rate" not in cfg:
            v = cfg.get("lr", default)  # classic Keras-2 serialization
        if v is None:
            return float(default)
        if isinstance(v, (int, float)):
            return float(v)
        logger.warning("KerasModel: optimizer %s.%s is a schedule/object; "
                       "using default %s", cls, key, default)
        return float(default)

    lr = num("learning_rate", 0.001)
    name = cls.lower()
    if cfg.get("amsgrad"):
        logger.warning("KerasModel: amsgrad=True has no engine equivalent; "
                       "using plain %s", cls)
    if name == "adam":
        if cfg.get("weight_decay"):
            # Keras-3 Adam(weight_decay=...) applies decoupled decay == AdamW
            return kopt.AdamWeightDecay(
                lr=lr, beta_1=num("beta_1", 0.9),
                beta_2=num("beta_2", 0.999), epsilon=num("epsilon", 1e-7),
                weight_decay=num("weight_decay", 0.0))
        return kopt.Adam(lr=lr, beta_1=num("beta_1", 0.9),
                         beta_2=num("beta_2", 0.999),
                         epsilon=num("epsilon", 1e-7),
                         decay=num("decay", 0.0))
    if name == "adamw":
        return kopt.AdamWeightDecay(lr=lr, beta_1=num("beta_1", 0.9),
                                    beta_2=num("beta_2", 0.999),
                                    epsilon=num("epsilon", 1e-7),
                                    weight_decay=num("weight_decay", 0.004))
    if cfg.get("weight_decay"):
        logger.warning("KerasModel: %s weight_decay has no engine "
                       "equivalent; dropped", cls)
    if name == "sgd":
        return kopt.SGD(lr=num("learning_rate", 0.01),
                        momentum=num("momentum", 0.0),
                        decay=num("decay", 0.0),
                        nesterov=bool(cfg.get("nesterov", False)))
    if name == "rmsprop":
        return kopt.RMSprop(lr=lr, rho=num("rho", 0.9),
                            epsilon=num("epsilon", 1e-7),
                            decay=num("decay", 0.0),
                            momentum=num("momentum", 0.0),
                            centered=bool(cfg.get("centered", False)))
    if name == "adagrad":
        return kopt.Adagrad(lr=num("learning_rate", 0.01),
                            epsilon=num("epsilon", 1e-7))
    if name == "adadelta":
        return kopt.Adadelta(lr=lr, rho=num("rho", 0.95),
                             epsilon=num("epsilon", 1e-7))
    if name == "adamax":
        return kopt.Adamax(lr=lr, beta_1=num("beta_1", 0.9),
                           beta_2=num("beta_2", 0.999),
                           epsilon=num("epsilon", 1e-7))
    logger.warning("KerasModel: unknown optimizer class %s; using Adam(%g)",
                   cls, lr)
    return kopt.Adam(lr=lr)


def _translate_loss(spec):
    """Serialized keras loss (name string or object config) -> criterion."""
    from analytics_zoo_tpu_torch.keras import objectives

    if spec is None:
        return None
    if isinstance(spec, (list, tuple, dict)) and not (
            isinstance(spec, dict) and "class_name" in spec):
        raise NotImplementedError(
            "KerasModel: per-output loss lists/dicts are not supported — "
            "compile the converted model with a single criterion")
    aliases = {"kldivergence": "kld", "kl_divergence": "kld",
               "cosine_similarity": "cosine_proximity"}
    if isinstance(spec, str):
        name = _camel_to_snake(spec)
        return objectives.get(aliases.get(name, name))
    name = _camel_to_snake(spec.get("class_name", ""))
    cfg = spec.get("config", {})
    if not isinstance(cfg, dict):
        # function-form serialization ({"class_name": "function",
        # "config": "mean_squared_error"}): config IS the name
        name, cfg = _camel_to_snake(str(cfg)), {}
    name = aliases.get(name, name)
    if cfg.get("from_logits"):
        logits_name = name + "_from_logits"
        try:
            return objectives.get(logits_name)
        except ValueError:
            raise NotImplementedError(
                f"KerasModel: loss {spec.get('class_name')} with "
                "from_logits=True has no engine equivalent — add a softmax/"
                "sigmoid head or use the probability form") from None
    return objectives.get(name)


def _translate_metrics(specs) -> Sequence:
    from analytics_zoo_tpu_torch.keras import metrics as kmetrics

    out = []
    for m in specs or []:
        if isinstance(m, dict):
            c = m.get("config")
            if isinstance(c, str):   # function-form: config IS the name
                m = c
            else:
                m = (c or {}).get("name") or m.get("class_name", "")
        try:
            out.append(kmetrics.get(_camel_to_snake(str(m))))
        except ValueError:
            logger.warning("KerasModel: skipping metric %r (no engine "
                           "equivalent)", m)
    return out


def _compile_spec_of(kmodel):
    """Pull (optimizer, loss, metrics) off a keras model, tolerating both
    the Keras-3 ``get_compile_config`` and older attribute layouts."""
    get_cc = getattr(kmodel, "get_compile_config", None)
    cc = None
    if callable(get_cc):
        try:
            cc = get_cc()
        except Exception:
            cc = None
    if cc:
        return (_translate_optimizer(cc.get("optimizer")),
                _translate_loss(cc.get("loss")),
                _translate_metrics(cc.get("metrics")))
    loss = getattr(kmodel, "loss", None)
    if loss is None:
        return None
    opt = getattr(kmodel, "optimizer", None)
    opt_spec = None
    if opt is not None:
        opt_spec = {"class_name": type(opt).__name__,
                    "config": {k: v for k, v in
                               (opt.get_config() or {}).items()}}
    if isinstance(loss, (str, list, tuple)) or (
            isinstance(loss, dict) and "class_name" not in loss):
        loss_spec = loss  # strings translate; lists/dicts raise per-output
    elif callable(loss) and not hasattr(loss, "get_config"):
        loss_spec = getattr(loss, "__name__", "")  # bare keras loss function
    else:
        loss_spec = {"class_name": type(loss).__name__,
                     "config": getattr(loss, "get_config", dict)()}
    return (_translate_optimizer(opt_spec), _translate_loss(loss_spec), [])


class KerasModel:
    """Train someone else's tf.keras model on the engine.

    ``KerasModel(tf_keras_model)`` converts architecture + weights +
    compile state; ``KerasModel(zoo_model)`` passes through. Either way
    the instance exposes the reference's fit/evaluate/predict surface
    (model.py:84-215) over the engine.
    """

    def __init__(self, model):
        from analytics_zoo_tpu_torch.keras_convert import (
            convert_keras_model,
            is_foreign_keras_model,
        )

        self.source_model = None
        if is_foreign_keras_model(model):
            self.source_model = model
            self.model = convert_keras_model(model)
            try:
                spec = _compile_spec_of(model)
            except (ValueError, NotImplementedError) as e:
                # architecture+weights converted fine; a loss/optimizer
                # outside the engine table shouldn't brick the wrapper —
                # predict() works uncompiled, and the user can call
                # .model.compile(...) with an engine criterion themselves
                logger.warning(
                    "KerasModel: could not inherit compile state (%s); "
                    "call .model.compile(optimizer, loss) before fit()", e)
                spec = None
            if spec is not None:
                optimizer, loss, metrics = spec
                if loss is not None:
                    self.model.compile(optimizer, loss, metrics=metrics)
                    logger.info("KerasModel: inherited compile state from "
                                "%s", type(model).__name__)
        else:
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
