"""Validation metrics (port of ``analytics_zoo_tpu.keras.metrics``).

A metric computes per-batch ``(sum, count)`` statistics on the device and
the caller sums them across batches (AUC's sum is a vector of per-threshold
counts). Every metric takes an optional per-sample ``mask``: the engine
wrap-pads final partial batches to a fixed shape, and the mask removes the
padding from the statistics. The ranking metrics (``evaluate_map``,
``evaluate_ndcg``, ref Ranker.scala:80,98) run on the host over grouped
``(scores, labels)`` lists, in numpy as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
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


class BinaryAccuracy(Metric):
    """Fraction of correct {0,1} predictions at a threshold (ref
    BinaryAccuracy)."""
    name = "binary_accuracy"

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold

    def batch_stats(self, y_true, y_pred, mask=None):
        pred = (y_pred > self.threshold).int().reshape(y_pred.shape[0], -1)
        true = torch.round(y_true).int().reshape(pred.shape)
        return _masked_sum((pred == true).float(), mask)


class CategoricalAccuracy(Metric):
    """Argmax accuracy over one-hot labels (ref CategoricalAccuracy)."""
    name = "categorical_accuracy"

    def batch_stats(self, y_true, y_pred, mask=None):
        correct = (y_pred.argmax(dim=-1) == y_true.argmax(dim=-1)).float()
        return _masked_sum(correct, mask)


class TopKAccuracy(Metric):
    """The label among the k highest predictions (ref Top1Accuracy /
    Top5Accuracy). The JAX package takes the last k of a stable argsort,
    so among tied scores the higher class index counts as in the top k;
    a stable descending sort of the reversed classes keeps that rule."""
    name = "topkaccuracy"
    k = 5

    def __init__(self, k: int = 5):
        self.k = k
        self.name = f"top{k}accuracy"

    def batch_stats(self, y_true, y_pred, mask=None):
        true = y_true.long()
        if true.dim() == y_pred.dim():
            true = (true.argmax(dim=-1) if true.shape[-1] > 1
                    else true.squeeze(-1))
        n = y_pred.shape[-1]
        order = torch.sort(y_pred.flip(-1), dim=-1, descending=True,
                           stable=True).indices[..., :self.k]
        topk = n - 1 - order
        correct = (topk == true[..., None]).any(dim=-1).float()
        return _masked_sum(correct, mask)


class Top5Accuracy(TopKAccuracy):
    """TopKAccuracy at k=5 (ref Top5Accuracy)."""

    def __init__(self):
        super().__init__(5)
        self.name = "top5accuracy"


class MAE(Metric):
    """Mean absolute error (ref MAE validation method)."""
    name = "mae"

    def batch_stats(self, y_true, y_pred, mask=None):
        return _masked_sum(torch.abs(y_pred - y_true), mask)


class MSE(Metric):
    """Mean squared error (ref MSE validation method)."""
    name = "mse"

    def batch_stats(self, y_true, y_pred, mask=None):
        return _masked_sum(torch.square(y_pred - y_true), mask)


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


class AUC(Metric):
    """Ref AUC — the threshold-bucketed ROC approximation: per threshold
    the true and false positive counts, summed over batches, then the
    trapezoid under (fpr, tpr)."""

    name = "auc"

    def __init__(self, num_thresholds: int = 200):
        self.num_thresholds = num_thresholds

    def batch_stats(self, y_true, y_pred, mask=None):
        t = torch.linspace(0.0, 1.0, self.num_thresholds,
                           device=y_pred.device)
        yp = y_pred
        if yp.dim() >= 2 and yp.shape[-1] == 2:
            # binary softmax head: the positive-class probability is the
            # ranking score
            yp = yp[..., 1]
        yt = y_true
        if yt.dim() >= 2 and yt.shape[-1] == 2:
            # matching one-hot targets (their rows mean to exactly 0.5)
            yt = yt[..., 1]
        score = yp.reshape(yp.shape[0], -1).float().mean(dim=-1)
        label = torch.round(yt.reshape(score.shape[0], -1).float()
                            .mean(dim=-1))
        w = (torch.ones_like(score) if mask is None
             else mask.to(torch.float32))
        pred_pos = (score[None, :] >= t[:, None]).float()
        pos_w = (label == 1) * w
        neg_w = (label == 0) * w
        tp = (pred_pos * pos_w[None, :]).sum(dim=1)
        fp = (pred_pos * neg_w[None, :]).sum(dim=1)
        packed = torch.cat([tp, fp, torch.stack([pos_w.sum(),
                                                 neg_w.sum()])])
        return packed, torch.tensor(1.0, device=y_pred.device)

    def finalize(self, total, count):
        arr = np.asarray(total)
        k = self.num_thresholds
        tp, fp, pos, neg = arr[:k], arr[k:2 * k], arr[2 * k], arr[2 * k + 1]
        tpr = tp / max(float(pos), 1e-12)
        fpr = fp / max(float(neg), 1e-12)
        trapz = getattr(np, "trapezoid", None) or np.trapz
        return float(-trapz(tpr, fpr))


# Host-side ranking metrics (ref Ranker.evaluateMAP/evaluateNDCG:80,98):
# grouped (scores, labels) lists per query, not batches.


def evaluate_map(grouped, threshold: float = 0.0) -> float:
    """Mean average precision over grouped (scores, labels) ranking
    lists (ref evaluateMAP, Ranker.scala)."""
    aps = []
    for scores, labels in grouped:
        order = np.argsort(-np.asarray(scores))
        rels = np.asarray(labels)[order] > threshold
        if rels.sum() == 0:
            aps.append(0.0)
            continue
        prec = np.cumsum(rels) / (np.arange(len(rels)) + 1)
        aps.append(float((prec * rels).sum() / rels.sum()))
    return float(np.mean(aps)) if aps else 0.0


def evaluate_ndcg(grouped, k: int = 10, threshold: float = 0.0) -> float:
    """NDCG@k over grouped ranking lists (ref evaluateNDCG,
    Ranker.scala)."""
    ndcgs = []
    for scores, labels in grouped:
        labels = np.asarray(labels, dtype=np.float64)
        order = np.argsort(-np.asarray(scores))[:k]
        gains = (2.0 ** labels[order] - 1) / np.log2(
            np.arange(2, len(order) + 2))
        ideal_order = np.argsort(-labels)[:k]
        ideal = (2.0 ** labels[ideal_order] - 1) / np.log2(
            np.arange(2, len(ideal_order) + 2))
        ndcgs.append(float(gains.sum() / ideal.sum())
                     if ideal.sum() > 0 else 0.0)
    return float(np.mean(ndcgs)) if ndcgs else 0.0


_METRICS = {
    "accuracy": Accuracy,
    "acc": Accuracy,
    "sparse_categorical_accuracy": SparseCategoricalAccuracy,
    "binary_accuracy": BinaryAccuracy,
    "categorical_accuracy": CategoricalAccuracy,
    "top5accuracy": Top5Accuracy,
    "top5": Top5Accuracy,
    "mae": MAE,
    "mse": MSE,
    "auc": AUC,
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
