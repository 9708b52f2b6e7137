"""Loss functions (port of ``analytics_zoo_tpu.keras.objectives``, the
subset the training slice needs).

Each objective is a function ``(y_true, y_pred) -> scalar`` (mean over the
batch); its per-sample form ``(y_true, y_pred) -> (batch,)`` lets the train
step and the ``Loss`` metric mask wrap-padded tail rows exactly. Class
labels for the sparse losses are 0-based ints. Probabilities are clipped at
``_EPS`` as in the JAX package. The other objectives of the JAX package
(mae, mape, msle, the binary, hinge, rank, KL, poisson and cosine losses)
are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

_EPS = 1e-7


def _labels(y_true, y_pred):
    labels = y_true.long()
    if labels.dim() == y_pred.dim():
        labels = labels.squeeze(-1)
    return labels


def _rowmean(v):
    """Collapse everything but the batch dim to a per-sample mean."""
    return v.reshape(v.shape[0], -1).mean(dim=-1)


def mean_squared_error(y_true, y_pred):
    """Ref MeanSquaredError — mean((y_pred - y_true)^2)."""
    return torch.square(y_pred - y_true).mean()


def categorical_crossentropy(y_true, y_pred):
    """Ref CategoricalCrossEntropy — one-hot labels, probability inputs."""
    p = torch.clamp(y_pred, _EPS, 1.0)
    return -(y_true * torch.log(p)).sum(dim=-1).mean()


def categorical_crossentropy_from_logits(y_true, y_pred):
    """One-hot labels over raw logits (log_softmax inside)."""
    logp = torch.log_softmax(y_pred, dim=-1)
    return -(y_true * logp).sum(dim=-1).mean()


def sparse_categorical_crossentropy(y_true, y_pred):
    """Ref SparseCategoricalCrossEntropy — int labels, probability inputs."""
    p = torch.clamp(y_pred, _EPS, 1.0)
    ll = torch.log(p).gather(-1, _labels(y_true, y_pred)[..., None])[..., 0]
    return -ll.mean()


def sparse_categorical_crossentropy_from_logits(y_true, y_pred):
    """Int labels over raw logits (log_softmax inside)."""
    logp = torch.log_softmax(y_pred, dim=-1)
    ll = logp.gather(-1, _labels(y_true, y_pred)[..., None])[..., 0]
    return -ll.mean()


_LOSSES = {
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "categorical_crossentropy": categorical_crossentropy,
    "categorical_crossentropy_from_logits":
        categorical_crossentropy_from_logits,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "sparse_categorical_crossentropy_from_logits":
        sparse_categorical_crossentropy_from_logits,
}


def get(loss: Union[str, Callable]) -> Callable:
    """Resolve a loss spec — a name from the table or any callable
    ``(y_true, y_pred) -> scalar`` — to the function."""
    if callable(loss):
        return loss
    try:
        return _LOSSES[loss]
    except KeyError:
        raise ValueError(f"Unknown loss '{loss}'. Known: {sorted(_LOSSES)}"
                         ) from None


# Per-sample forms: the train step and the Loss metric weight them by the
# wrap-pad mask, so duplicated tail samples never count twice.


def _ps_mse(y_true, y_pred):
    return _rowmean(torch.square(y_pred - y_true))


def _ps_cce(y_true, y_pred):
    p = torch.clamp(y_pred, _EPS, 1.0)
    return _rowmean(-(y_true * torch.log(p)).sum(dim=-1))


def _ps_cce_logits(y_true, y_pred):
    return _rowmean(-(y_true * torch.log_softmax(y_pred, dim=-1)).sum(dim=-1))


def _ps_scce(y_true, y_pred):
    p = torch.clamp(y_pred, _EPS, 1.0)
    ll = torch.log(p).gather(-1, _labels(y_true, y_pred)[..., None])[..., 0]
    return _rowmean(-ll)


def _ps_scce_logits(y_true, y_pred):
    logp = torch.log_softmax(y_pred, dim=-1)
    ll = logp.gather(-1, _labels(y_true, y_pred)[..., None])[..., 0]
    return _rowmean(-ll)


_PER_SAMPLE = {
    mean_squared_error: _ps_mse,
    categorical_crossentropy: _ps_cce,
    categorical_crossentropy_from_logits: _ps_cce_logits,
    sparse_categorical_crossentropy: _ps_scce,
    sparse_categorical_crossentropy_from_logits: _ps_scce_logits,
}


def get_per_sample(loss_fn: Callable):
    """Per-sample form of a loss, or None if only the scalar form exists."""
    return _PER_SAMPLE.get(loss_fn)
