"""Validation metrics (port of ``analytics_zoo_tpu.keras.metrics``:
``Metric``, ``Accuracy``, ``SparseCategoricalAccuracy``, ``Loss``, ``get``).

A metric computes per-batch ``(sum, count)`` statistics on the device and
the caller sums them across batches. Every metric takes an optional
per-sample ``mask``: the engine wrap-pads final partial batches to a fixed
shape, and the mask removes the padding from the statistics. The other
metrics of the JAX package (binary/categorical/top-k accuracy, MAE, MSE,
AUC, the ranking metrics) are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch


def _masked_sum(values: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """values: per-sample (or per-element) statistic, batch on dim 0."""
    if mask is None:
        return values.sum(), torch.tensor(float(values.numel()),
                                          device=values.device)
    m = mask.reshape((-1,) + (1,) * (values.dim() - 1)).to(values.dtype)
    weights = m.expand(values.shape)
    return (values * weights).sum(), weights.sum()


class Metric:
    """Base validation metric: per-batch partial sums (masked), merged by
    the caller."""
    name = "metric"

    def batch_stats(self, y_true, y_pred, mask=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-batch partial sums (masked) for this metric."""
        raise NotImplementedError

    def finalize(self, total: float, count: float) -> float:
        """Merge partial sums into the final scalar value."""
        return float(total) / max(float(count), 1e-12)


class Accuracy(Metric):
    """Ref Accuracy — auto-detects sparse vs one-hot vs binary targets."""

    name = "accuracy"

    def batch_stats(self, y_true, y_pred, mask=None):
        if y_pred.dim() > 1 and y_pred.shape[-1] > 1:
            pred = y_pred.argmax(dim=-1)
            if (y_true.dim() == y_pred.dim()
                    and y_true.shape[-1] == y_pred.shape[-1]):
                true = y_true.argmax(dim=-1)
            else:
                true = y_true.long()
                if true.dim() == pred.dim() + 1:
                    true = true.squeeze(-1)
        else:
            p = y_pred if y_pred.dim() == 1 else y_pred[..., 0]
            pred = (p > 0.5).long()
            true = torch.round(y_true.reshape(p.shape)).long()
        correct = (pred == true).float()
        return _masked_sum(correct, mask)


class SparseCategoricalAccuracy(Accuracy):
    name = "sparse_categorical_accuracy"


class Loss(Metric):
    """A loss as a validation metric, through its per-sample form when it
    has one, so wrap-padding does not bias the value."""

    name = "loss"

    def __init__(self, loss_fn: Callable,
                 per_sample_fn: Optional[Callable] = None):
        from analytics_zoo_tpu_torch.keras import objectives

        self.loss_fn = loss_fn
        self.per_sample_fn = per_sample_fn or objectives.get_per_sample(
            loss_fn)

    def batch_stats(self, y_true, y_pred, mask=None):
        if self.per_sample_fn is not None:
            return _masked_sum(self.per_sample_fn(y_true, y_pred), mask)
        v = self.loss_fn(y_true, y_pred)
        if v.dim():
            # reference-style per-sample loss: one value per row
            return _masked_sum(v.reshape(v.shape[0], -1).mean(dim=-1), mask)
        n = torch.tensor(float(y_pred.shape[0]), device=v.device)
        return v * n, n


_METRICS = {
    "accuracy": Accuracy,
    "acc": Accuracy,
    "sparse_categorical_accuracy": SparseCategoricalAccuracy,
}


def get(metric: Union[str, Metric]) -> Metric:
    """Resolve a metric spec (name or Metric instance) to a Metric."""
    if isinstance(metric, Metric):
        return metric
    try:
        return _METRICS[metric]()
    except KeyError:
        raise ValueError(f"Unknown metric '{metric}'. Known: "
                         f"{sorted(_METRICS)}") from None
