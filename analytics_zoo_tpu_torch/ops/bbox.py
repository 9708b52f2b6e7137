"""Bounding-box geometry for object detection (port of
``analytics_zoo_tpu.ops.bbox``; ref models/image/objectdetection/common/
BboxUtil: IoU, center-size encode/decode with variances, clipping,
class-wise NMS).

Every function is a torch function over fixed-size tensors with leading
batch dims where the JAX package vmaps: variable-length results (NMS
keep-lists) are a fixed ``max_out`` slot array plus a validity mask. Nothing
here syncs with the host (no ``.item()``, no ``nonzero``, no boolean-mask
indexing, no shape that depends on values), so the post-processing runs
inside a CUDA graph capture.

Tie rules, the JAX package's made explicit:

- an ``argmax`` (NMS's pick, ``match_priors``' best box and favourite
  prior) takes the first index of the maximum, as ``jnp.argmax``;
- a top-k (the final merge of ``multiclass_nms``) is a stable descending
  sort and a slice, so equal scores keep the lower index first, as
  ``lax.top_k`` (``torch.topk`` gives no order among ties on CUDA);
- the forced bipartite match of ``match_priors``: where two valid boxes
  share a favourite prior, the higher box index wins (a ``scatter_reduce``
  with ``amax`` over box ids). The JAX package leaves the winner
  unspecified; an ``index_put_`` with duplicate indices is
  nondeterministic on CUDA.

Box convention: ``(xmin, ymin, xmax, ymax)``, normalised to [0, 1] unless
stated otherwise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_NEG_INF = float("-inf")


def bbox_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of (..., 4) corner boxes; degenerate boxes clamp to 0."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def bbox_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: a (..., N, 4) x b (..., M, 4) -> (..., N, M), the
    leading dims broadcast."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = bbox_area(a)[..., :, None] + bbox_area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def corner_to_center(boxes: torch.Tensor) -> torch.Tensor:
    """(xmin,ymin,xmax,ymax) -> (cx,cy,w,h)."""
    wh = boxes[..., 2:] - boxes[..., :2]
    c = boxes[..., :2] + 0.5 * wh
    return torch.cat([c, wh], dim=-1)


def center_to_corner(boxes: torch.Tensor) -> torch.Tensor:
    """(cx,cy,w,h) -> (xmin,ymin,xmax,ymax)."""
    half = 0.5 * boxes[..., 2:]
    return torch.cat([boxes[..., :2] - half, boxes[..., :2] + half], dim=-1)


def _variances(variances, like: torch.Tensor) -> torch.Tensor:
    """The four variances as a float32 tensor on ``like``'s device, each
    filled by a kernel: a tensor made from host values would be copied from
    the host, which a CUDA graph capture does not allow."""
    v = like.new_empty(4, dtype=torch.float32)
    for i, x in enumerate(variances):
        v[i].fill_(x)
    return v


def encode_boxes(priors: torch.Tensor, boxes: torch.Tensor,
                 variances=(0.1, 0.1, 0.2, 0.2)) -> torch.Tensor:
    """SSD center-size encoding of ground-truth ``boxes`` against ``priors``
    (ref BboxUtil.encodeBBox). Both are (..., 4) corner boxes; the output
    is the regression target."""
    v = _variances(variances, priors)
    p, g = corner_to_center(priors), corner_to_center(boxes)
    txy = (g[..., :2] - p[..., :2]) / torch.clamp(p[..., 2:], min=1e-8) \
        / v[:2]
    twh = torch.log(torch.clamp(g[..., 2:], min=1e-8)
                    / torch.clamp(p[..., 2:], min=1e-8)) / v[2:]
    return torch.cat([txy, twh], dim=-1)


def decode_boxes(priors: torch.Tensor, loc: torch.Tensor,
                 variances=(0.1, 0.1, 0.2, 0.2)) -> torch.Tensor:
    """Inverse of :func:`encode_boxes` (ref BboxUtil.decodeBBox). A bf16
    ``loc`` is promoted to float32 by the float32 variances, as in the JAX
    package."""
    v = _variances(variances, loc)
    p = corner_to_center(priors)
    cxy = loc[..., :2] * v[:2] * p[..., 2:] + p[..., :2]
    wh = torch.exp(loc[..., 2:] * v[2:]) * p[..., 2:]
    return center_to_corner(torch.cat([cxy, wh], dim=-1))


def clip_boxes(boxes: torch.Tensor, lo: float = 0.0,
               hi: float = 1.0) -> torch.Tensor:
    """Clamp corners into [lo, hi] (ref BboxUtil.clipBoxes)."""
    return torch.clamp(boxes, lo, hi)


def match_priors(priors: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_valid: torch.Tensor, iou_threshold: float = 0.5
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign each prior a ground-truth index (or -1 for background).

    Ref BboxUtil.matchBbox: (1) bipartite pass, every valid box claims its
    best-IoU prior regardless of the threshold, so no box goes unmatched;
    (2) a per-prior pass matching any prior whose best IoU >= threshold.

    Args:
      priors: (P, 4). gt_boxes: (..., G, 4) padded. gt_valid: (..., G) bool.
    Returns:
      (assignment (..., P) int64 in [-1, G), best_iou (..., P) float32).

    The bipartite pass is a scatter into P + 1 slots: padding boxes go to
    slot P, which is dropped (the JAX package's ``mode="drop"``), so a
    padding box's argmax over its all(-1) column cannot clobber prior 0.
    Where two valid boxes share a favourite prior, the higher box index
    wins.
    """
    iou = bbox_iou(priors, gt_boxes)                               # (.., P, G)
    iou = torch.where(gt_valid[..., None, :], iou, -1.0)
    best_gt = torch.argmax(iou, dim=-1)                            # (.., P)
    best_iou = torch.amax(iou, dim=-1)
    assignment = torch.where(best_iou >= iou_threshold, best_gt, -1)

    num_p, num_g = iou.shape[-2], iou.shape[-1]
    fav_prior = torch.argmax(iou, dim=-2)                          # (.., G)
    fav_prior = torch.where(gt_valid, fav_prior, num_p)
    g_ids = torch.arange(num_g, device=iou.device).expand(fav_prior.shape)
    forced = torch.full(fav_prior.shape[:-1] + (num_p + 1,), -1,
                        dtype=torch.int64, device=iou.device)
    forced = forced.scatter_reduce(-1, fav_prior, g_ids, "amax")[..., :num_p]
    assignment = torch.where(forced >= 0, forced, assignment)
    best_iou = torch.where(
        forced >= 0,
        torch.gather(iou, -1, forced.clamp(min=0)[..., None])[..., 0],
        best_iou)
    return assignment, best_iou


def nms(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
        iou_threshold: float = 0.45, score_threshold: float = _NEG_INF
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded greedy NMS over leading batch dims: boxes (..., N, 4),
    scores (..., N) -> (indices (..., max_out) int64, valid (..., max_out)
    bool). The boxes' batch dims broadcast against the scores': SSD's
    classes share their image's boxes, and so one IoU matrix.

    Ref BboxUtil.nms builds a growing keep-list; here ``max_out`` fixed
    trips, each selecting the highest-scoring live box (the first index
    among equal scores), emitting it and suppressing its neighbours. Slots
    past the live set get index 0 and valid=False."""
    n = scores.shape[-1]
    live = scores > score_threshold
    iou = bbox_iou(boxes, boxes)
    ar = torch.arange(n, device=scores.device)
    out_idx, out_valid = [], []
    for _ in range(max_out):
        masked = torch.where(live, scores, _NEG_INF)
        best = torch.argmax(masked, dim=-1)                        # (...,)
        ok = torch.gather(masked, -1, best[..., None])[..., 0] > _NEG_INF
        out_idx.append(torch.where(ok, best, 0))
        out_valid.append(ok)
        row = torch.take_along_dim(iou, best[..., None, None], dim=-2)
        suppress = (row[..., 0, :] >= iou_threshold) | (ar == best[..., None])
        live = live & torch.where(ok[..., None], ~suppress, live)
    return torch.stack(out_idx, dim=-1), torch.stack(out_valid, dim=-1)


def descending_order(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest scores along the last dim, in
    descending order, equal scores keeping the lower index first (a stable
    sort, the order ``lax.top_k`` gives)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :k]


def top_detections(scores: torch.Tensor, boxes: torch.Tensor,
                   valid: torch.Tensor, max_total: int):
    """The global top-k merge of per-class NMS results: scores (..., K, S),
    boxes (..., K, S, 4) and valid (..., K, S) for K foreground classes
    (class id k + 1) and S slots -> (boxes (..., max_total, 4), scores,
    classes int32, valid), sorted by descending score, ties to the lower
    flat index; padded when K * S < max_total."""
    slots = scores.shape[-1]
    flat_sc = torch.where(valid, scores, _NEG_INF).flatten(-2)
    flat_b = boxes.flatten(-3, -2)
    k = min(max_total, flat_sc.shape[-1])
    top_i = descending_order(flat_sc, k)
    top_sc = torch.gather(flat_sc, -1, top_i)
    out_valid = torch.isfinite(top_sc)
    out_boxes = torch.gather(
        flat_b, -2, top_i[..., None].expand(top_i.shape + (4,))) \
        * out_valid[..., None]
    out_scores = torch.where(out_valid, top_sc, 0.0)
    out_cls = torch.where(out_valid, top_i // slots + 1, 0).to(torch.int32)
    if k < max_total:  # pad (only when K * S < max_total)
        pad = max_total - k
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        out_scores = torch.nn.functional.pad(out_scores, (0, pad))
        out_cls = torch.nn.functional.pad(out_cls, (0, pad))
        out_valid = torch.nn.functional.pad(out_valid, (0, pad))
    return out_boxes, out_scores, out_cls, out_valid


def multiclass_nms(boxes: torch.Tensor, cls_scores: torch.Tensor,
                   score_threshold: float = 0.01,
                   iou_threshold: float = 0.45,
                   max_per_class: int = 100,
                   max_total: int = 200):
    """Class-wise NMS + global top-k merge (the SSD post-processing core;
    ref SSD postprocessing, BboxUtil + DetectionOutput): per
    non-background class, threshold scores, run NMS, then keep the
    ``max_total`` best detections across classes.

    Args:
      boxes: (..., P, 4) decoded corner boxes, shared across classes.
      cls_scores: (..., P, C) softmax scores, class 0 = background.
    Returns:
      (boxes (..., max_total, 4), scores (..., max_total), classes
      (..., max_total) int32, valid (..., max_total) bool), sorted by
      descending score.

    Every (image, class) pair runs in one batched loop; the classes share
    their image's one IoU matrix."""
    fg = cls_scores[..., 1:].transpose(-1, -2)             # (..., C-1, P)
    idx, valid = nms(boxes[..., None, :, :], fg, max_per_class,
                     iou_threshold, score_threshold)
    sc = torch.gather(fg, -1, idx)                          # (..., C-1, K)
    slot_boxes = torch.gather(
        boxes[..., None, :, :].expand(fg.shape + (4,)), -2,
        idx[..., None].expand(idx.shape + (4,)))
    return top_detections(sc, slot_boxes, valid, max_total)


def scale_detections(boxes: np.ndarray, width: int, height: int) -> np.ndarray:
    """Normalised [0,1] boxes -> pixel coordinates (ref ScaleDetection)."""
    return np.asarray(boxes) * np.array([width, height, width, height],
                                        dtype=np.float32)
