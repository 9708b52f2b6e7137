"""MultiBox loss (port of
``analytics_zoo_tpu.models.image.objectdetection.loss``; ref
models/image/objectdetection/common/loss/MultiBoxLoss).

Matching, encoding and hard-negative mining are fixed-shape tensor ops
batched over the images (the JAX package vmaps one image at a time):
sort-based mining in place of the reference's mutable priority queues.

Ground-truth convention (static shapes): each image carries a padded
``(G, 5)`` array of rows ``[label, xmin, ymin, xmax, ymax]``, label 0
meaning "padding slot" (real classes are 1-based, background is class 0).

Mining ranks each image's negatives by their background cross-entropy
(-log p(background)) with a stable sort, equal scores keeping the lower
prior index first, as ``jnp.argsort`` does. Ties are common: the
prediction arrives in bf16 and is only then cast to float32, so many
priors share a background score, and another order among them picks other
negatives and moves the gradient. The rank of each prior is the inverse
permutation of that order, one scatter of ``arange``.
"""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.ops.bbox import encode_boxes, match_priors


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    """Huber (delta=1), the SSD localisation loss."""
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def descending_ranks(score: torch.Tensor) -> torch.Tensor:
    """Each element's position in the descending order of ``score`` along
    the last dim, equal scores ranked by index (a stable sort)."""
    order = torch.argsort(-score, dim=-1, stable=True)
    ar = torch.arange(score.shape[-1], device=score.device)
    return torch.empty_like(order).scatter_(-1, order, ar.expand_as(order))


class MultiBoxLoss:
    """Callable ``(y_true, y_pred) -> scalar`` usable as a compile() loss.

    ``y_pred`` is the SSD graph output (B, P, 4 + C): loc || conf logits.
    ``y_true`` is the padded ground truth (B, G, 5) described above. The
    sum over images is normalised by the positives of the whole batch,
    with a floor of 1; each image mines at most ``neg_pos_ratio`` times its
    own positives.
    """

    def __init__(self, priors: np.ndarray, num_classes: int,
                 iou_threshold: float = 0.5, neg_pos_ratio: float = 3.0,
                 variances=(0.1, 0.1, 0.2, 0.2), loc_weight: float = 1.0):
        self.priors = np.asarray(priors, np.float32)
        self._priors = {}
        self.num_classes = int(num_classes)
        self.iou_threshold = float(iou_threshold)
        self.neg_pos_ratio = float(neg_pos_ratio)
        self.variances = tuple(variances)
        self.loc_weight = float(loc_weight)

    def priors_on(self, device) -> torch.Tensor:
        """``priors`` (the float32 array, as in the JAX package) as a
        tensor on ``device``, copied once per device."""
        key = str(device)
        if key not in self._priors:
            self._priors[key] = torch.tensor(self.priors, device=device)
        return self._priors[key]

    def __call__(self, y_true: torch.Tensor,
                 y_pred: torch.Tensor) -> torch.Tensor:
        y_pred = y_pred.float()
        y_true = y_true.float()
        priors = self.priors_on(y_pred.device)
        loc = y_pred[..., :4]
        conf = y_pred[..., 4:4 + self.num_classes]
        labels, boxes = y_true[..., 0].long(), y_true[..., 1:]
        assign, _ = match_priors(priors, boxes, labels > 0,
                                 self.iou_threshold)           # (B, P)
        pos = assign >= 0
        num_pos = pos.sum(dim=-1)                              # (B,)
        a = assign.clamp(min=0)

        # -- localisation: smooth-L1 on positives ------------------------
        matched = torch.gather(boxes, 1, a[..., None].expand(-1, -1, 4))
        targets = encode_boxes(priors, matched, self.variances)
        loc_l = torch.sum(smooth_l1(loc - targets), dim=-1)    # (B, P)
        loc_loss = torch.sum(torch.where(pos, loc_l, 0.0), dim=-1)

        # -- confidence: CE with sort-based hard-negative mining ---------
        cls_t = torch.where(pos, torch.gather(labels, 1, a), 0)
        logp = torch.log_softmax(conf, dim=-1)                 # (B, P, C)
        ce = -torch.gather(logp, -1, cls_t[..., None])[..., 0]
        neg_score = torch.where(pos, float("-inf"), -logp[..., 0])
        rank = descending_ranks(neg_score)
        num_neg = torch.minimum((self.neg_pos_ratio * num_pos).long(),
                                (~pos).sum(dim=-1))
        neg = rank < num_neg[:, None]
        conf_loss = torch.sum(torch.where(pos | neg, ce, 0.0), dim=-1)
        denom = torch.clamp(num_pos.sum().float(), min=1.0)
        return (self.loc_weight * loc_loss.sum() + conf_loss.sum()) / denom
