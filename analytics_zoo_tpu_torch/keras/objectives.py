"""Loss functions (port of ``analytics_zoo_tpu.keras.objectives``).

Each objective is a function ``(y_true, y_pred) -> scalar`` (mean over the
batch); its per-sample form ``(y_true, y_pred) -> (batch,)`` lets the train
step and the ``Loss`` metric mask wrap-padded tail rows exactly. Class
labels for the sparse losses are 0-based ints. Probabilities are clipped at
``_EPS`` as in the JAX package, and each loss keeps its arithmetic.
``rank_hinge`` takes interleaved (positive, negative) rows; its per-sample
form writes each pair's hinge to both rows.
"""

from __future__ import annotations

from typing import Callable, Union

import torch
import torch.nn.functional as F

_EPS = 1e-7


def _labels(y_true, y_pred):
    labels = y_true.long()
    if labels.dim() == y_pred.dim():
        labels = labels.squeeze(-1)
    return labels


def _rowmean(v):
    """Collapse everything but the batch dim to a per-sample mean."""
    return v.reshape(v.shape[0], -1).mean(dim=-1)


def _norm(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + _EPS)


def mean_squared_error(y_true, y_pred):
    """Ref MeanSquaredError — mean((y_pred - y_true)^2)."""
    return torch.square(y_pred - y_true).mean()


def mean_absolute_error(y_true, y_pred):
    """Ref MeanAbsoluteError — mean|y_pred - y_true|."""
    return torch.abs(y_pred - y_true).mean()


def mean_absolute_percentage_error(y_true, y_pred):
    """Ref MeanAbsolutePercentageError — 100 * mean|rel error|."""
    diff = torch.abs((y_true - y_pred) / torch.clamp(torch.abs(y_true),
                                                     min=_EPS))
    return 100.0 * diff.mean()


def mean_squared_logarithmic_error(y_true, y_pred):
    """Ref MeanSquaredLogarithmicError — MSE in log1p space."""
    a = torch.log(torch.clamp(y_pred, min=_EPS) + 1.0)
    b = torch.log(torch.clamp(y_true, min=_EPS) + 1.0)
    return torch.square(a - b).mean()


def binary_crossentropy(y_true, y_pred):
    """Ref BinaryCrossEntropy — probabilities in, clipped at 1e-7."""
    p = torch.clamp(y_pred, _EPS, 1.0 - _EPS)
    return -(y_true * torch.log(p)
             + (1.0 - y_true) * torch.log(1.0 - p)).mean()


def binary_crossentropy_from_logits(y_true, y_pred):
    """Sigmoid BCE over raw logits (the stable log1p(exp) form)."""
    return (torch.clamp(y_pred, min=0) - y_pred * y_true
            + torch.log1p(torch.exp(-torch.abs(y_pred)))).mean()


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


def hinge(y_true, y_pred):
    """Ref HingeCriterion — labels in {-1, +1}, mean margin loss."""
    return torch.clamp(1.0 - y_true * y_pred, min=0.0).mean()


def squared_hinge(y_true, y_pred):
    """Squared hinge over {-1, +1} labels."""
    return torch.square(torch.clamp(1.0 - y_true * y_pred, min=0.0)).mean()


def rank_hinge(y_true, y_pred, margin: float = 1.0):
    """Ref RankHinge — pairwise ranking loss over interleaved (pos, neg)
    rows: even rows positive, odd negative."""
    return F.relu(margin + y_pred[1::2] - y_pred[0::2]).mean()


def kullback_leibler_divergence(y_true, y_pred):
    """Ref KullbackLeiblerDivergence — KL(t || p) over distributions."""
    t = torch.clamp(y_true, _EPS, 1.0)
    p = torch.clamp(y_pred, _EPS, 1.0)
    return (t * torch.log(t / p)).sum(dim=-1).mean()


def poisson(y_true, y_pred):
    """Ref PoissonCriterion — mean(pred - true*log(pred))."""
    return (y_pred - y_true * torch.log(y_pred + _EPS)).mean()


def cosine_proximity(y_true, y_pred):
    """Ref CosineProximityCriterion — negative mean cosine similarity."""
    return -(_norm(y_true) * _norm(y_pred)).sum(dim=-1).mean()


_LOSSES = {
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
    "mape": mean_absolute_percentage_error,
    "mean_absolute_percentage_error": mean_absolute_percentage_error,
    "msle": mean_squared_logarithmic_error,
    "mean_squared_logarithmic_error": mean_squared_logarithmic_error,
    "binary_crossentropy": binary_crossentropy,
    "binary_crossentropy_from_logits": binary_crossentropy_from_logits,
    "categorical_crossentropy": categorical_crossentropy,
    "categorical_crossentropy_from_logits":
        categorical_crossentropy_from_logits,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "sparse_categorical_crossentropy_from_logits":
        sparse_categorical_crossentropy_from_logits,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "rank_hinge": rank_hinge,
    "kld": kullback_leibler_divergence,
    "kullback_leibler_divergence": kullback_leibler_divergence,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
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


def _ps_mae(y_true, y_pred):
    return _rowmean(torch.abs(y_pred - y_true))


def _ps_mape(y_true, y_pred):
    diff = torch.abs((y_true - y_pred) / torch.clamp(torch.abs(y_true),
                                                     min=_EPS))
    return 100.0 * _rowmean(diff)


def _ps_msle(y_true, y_pred):
    a = torch.log(torch.clamp(y_pred, min=_EPS) + 1.0)
    b = torch.log(torch.clamp(y_true, min=_EPS) + 1.0)
    return _rowmean(torch.square(a - b))


def _ps_bce(y_true, y_pred):
    p = torch.clamp(y_pred, _EPS, 1.0 - _EPS)
    return _rowmean(-(y_true * torch.log(p)
                      + (1.0 - y_true) * torch.log(1.0 - p)))


def _ps_bce_logits(y_true, y_pred):
    return _rowmean(torch.clamp(y_pred, min=0) - y_pred * y_true
                    + torch.log1p(torch.exp(-torch.abs(y_pred))))


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


def _ps_hinge(y_true, y_pred):
    return _rowmean(torch.clamp(1.0 - y_true * y_pred, min=0.0))


def _ps_squared_hinge(y_true, y_pred):
    return _rowmean(torch.square(torch.clamp(1.0 - y_true * y_pred,
                                             min=0.0)))


def _ps_kld(y_true, y_pred):
    t = torch.clamp(y_true, _EPS, 1.0)
    p = torch.clamp(y_pred, _EPS, 1.0)
    return _rowmean((t * torch.log(t / p)).sum(dim=-1))


def _ps_poisson(y_true, y_pred):
    return _rowmean(y_pred - y_true * torch.log(y_pred + _EPS))


def _ps_cosine(y_true, y_pred):
    return -_rowmean((_norm(y_true) * _norm(y_pred)).sum(dim=-1))


def _ps_rank_hinge(y_true, y_pred, margin: float = 1.0):
    """Per-PAIR hinge, written back to both interleaved rows, so that
    ``sum(ps * mask) / sum(mask)`` is the mean over unmasked pairs (pair
    padding masks both members together)."""
    return _rowmean(F.relu(margin + y_pred[1::2] - y_pred[0::2])
                    ).repeat_interleave(2, dim=0)


_PER_SAMPLE = {
    mean_squared_error: _ps_mse,
    mean_absolute_error: _ps_mae,
    mean_absolute_percentage_error: _ps_mape,
    mean_squared_logarithmic_error: _ps_msle,
    binary_crossentropy: _ps_bce,
    categorical_crossentropy: _ps_cce,
    categorical_crossentropy_from_logits: _ps_cce_logits,
    sparse_categorical_crossentropy: _ps_scce,
    sparse_categorical_crossentropy_from_logits: _ps_scce_logits,
    binary_crossentropy_from_logits: _ps_bce_logits,
    hinge: _ps_hinge,
    squared_hinge: _ps_squared_hinge,
    kullback_leibler_divergence: _ps_kld,
    poisson: _ps_poisson,
    cosine_proximity: _ps_cosine,
    rank_hinge: _ps_rank_hinge,
}


def get_per_sample(loss_fn: Callable):
    """Per-sample form of a loss, or None if only the scalar form exists."""
    return _PER_SAMPLE.get(loss_fn)


# Class-style aliases matching reference objective names
MeanSquaredError = mean_squared_error
MeanAbsoluteError = mean_absolute_error
SparseCategoricalCrossEntropy = sparse_categorical_crossentropy
CategoricalCrossEntropy = categorical_crossentropy
BinaryCrossEntropy = binary_crossentropy
RankHinge = rank_hinge
