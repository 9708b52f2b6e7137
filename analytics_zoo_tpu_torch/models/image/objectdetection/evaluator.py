"""Detection evaluation (a copy of the JAX package's numpy module
``analytics_zoo_tpu.models.image.objectdetection.evaluator``; ref the
objectdetection evaluators, PascalVocEvaluator / MeanAveragePrecision over
decoded detections).

A host-side metric: the VOC protocol, greedy matching of score-ranked
detections to ground truth at an IoU threshold, difficult boxes ignored, AP
per class by 11-point interpolation (VOC2007 ``use_07_metric``), area under
the PR curve (VOC2010+) or 101 points (COCO), mAP = the mean over classes
with at least one ground-truth box.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _iou_single(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    if boxes.size == 0:
        return np.zeros((0,), np.float32)
    lt = np.maximum(box[:2], boxes[:, :2])
    rb = np.minimum(box[2:], boxes[:, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    area = lambda b: np.clip(b[..., 2] - b[..., 0], 0, None) * \
        np.clip(b[..., 3] - b[..., 1], 0, None)
    union = area(box) + area(boxes) - inter
    return np.where(union > 0, inter / union, 0.0)


def average_precision(recall: np.ndarray, precision: np.ndarray,
                      use_07_metric: bool = False,
                      interpolation: Optional[str] = None) -> float:
    """AP from a PR curve. ``interpolation``: "area" (VOC2010+ default),
    "11point" (VOC2007), or "101point" (the COCO protocol: mean of the
    interpolated precision at 101 evenly spaced recall points)."""
    if recall.size == 0:
        return 0.0
    if interpolation is None:
        interpolation = "11point" if use_07_metric else "area"
    if interpolation == "11point":
        ap = 0.0
        for t in np.arange(0.0, 1.01, 0.1):
            p = precision[recall >= t]
            ap += (p.max() if p.size else 0.0) / 11.0
        return float(ap)
    if interpolation == "101point":
        # interpolated precision: max precision at any recall >= t
        mpre = np.maximum.accumulate(precision[::-1])[::-1]
        pts = np.searchsorted(recall, np.linspace(0.0, 1.0, 101), side="left")
        return float(np.mean(np.where(pts < len(mpre), mpre[np.minimum(
            pts, len(mpre) - 1)], 0.0)))
    # "area": append sentinels, make precision monotone, integrate
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


class MeanAveragePrecision:
    """Accumulating mAP metric. Feed per-image (detections, ground truth);
    ``result()`` returns {"mAP": float, "ap_per_class": {cls: ap}}."""

    def __init__(self, num_classes: int, iou_threshold: float = 0.5,
                 use_07_metric: bool = False,
                 interpolation: Optional[str] = None):
        self.num_classes = int(num_classes)
        self.iou_threshold = float(iou_threshold)
        self.use_07_metric = use_07_metric
        self.interpolation = interpolation
        self.reset()

    def reset(self) -> None:
        """Clear accumulated detections/ground truth."""
        # per class: list of (score, tp) over all images + GT count
        self._records: Dict[int, List] = {c: [] for c in range(1, self.num_classes)}
        self._gt_count = {c: 0 for c in range(1, self.num_classes)}

    def add(self, det_boxes: np.ndarray, det_scores: np.ndarray,
            det_classes: np.ndarray, gt_boxes: np.ndarray,
            gt_classes: np.ndarray,
            gt_difficult: Optional[np.ndarray] = None) -> None:
        """One image. Boxes are (N, 4) corners in any consistent unit."""
        det_boxes = np.asarray(det_boxes, np.float32).reshape(-1, 4)
        det_scores = np.asarray(det_scores, np.float32).reshape(-1)
        det_classes = np.asarray(det_classes).reshape(-1).astype(int)
        gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
        gt_classes = np.asarray(gt_classes).reshape(-1).astype(int)
        if gt_difficult is None:
            gt_difficult = np.zeros(len(gt_classes), bool)
        gt_difficult = np.asarray(gt_difficult, bool).reshape(-1)

        for c in range(1, self.num_classes):
            gmask = gt_classes == c
            g_boxes = gt_boxes[gmask]
            g_diff = gt_difficult[gmask]
            self._gt_count[c] += int(np.sum(~g_diff))
            dmask = det_classes == c
            d_boxes, d_scores = det_boxes[dmask], det_scores[dmask]
            order = np.argsort(-d_scores)
            taken = np.zeros(len(g_boxes), bool)
            for di in order:
                ious = _iou_single(d_boxes[di], g_boxes)
                best = int(np.argmax(ious)) if ious.size else -1
                if best >= 0 and ious[best] >= self.iou_threshold:
                    if g_diff[best]:
                        continue  # difficult GT: detection ignored entirely
                    if not taken[best]:
                        taken[best] = True
                        self._records[c].append((float(d_scores[di]), 1))
                    else:
                        self._records[c].append((float(d_scores[di]), 0))
                else:
                    self._records[c].append((float(d_scores[di]), 0))

    def result(self) -> Dict[str, object]:
        """Compute mAP (and per-class AP) from the accumulated detections."""
        aps: Dict[int, float] = {}
        for c in range(1, self.num_classes):
            npos = self._gt_count[c]
            if npos == 0:
                continue
            recs = sorted(self._records[c], key=lambda r: -r[0])
            tp = np.array([r[1] for r in recs], np.float32)
            if tp.size == 0:
                aps[c] = 0.0
                continue
            ctp = np.cumsum(tp)
            cfp = np.cumsum(1.0 - tp)
            recall = ctp / npos
            precision = ctp / np.maximum(ctp + cfp, 1e-9)
            aps[c] = average_precision(recall, precision, self.use_07_metric,
                                       self.interpolation)
        mAP = float(np.mean(list(aps.values()))) if aps else 0.0
        return {"mAP": mAP, "ap_per_class": aps}


class PascalVocEvaluator(MeanAveragePrecision):
    """Ref PascalVocEvaluator — VOC2007 protocol (11-point AP, IoU 0.5)."""

    def __init__(self, num_classes: int = 21, iou_threshold: float = 0.5,
                 use_07_metric: bool = True):
        super().__init__(num_classes, iou_threshold, use_07_metric)

    def evaluate(self, detections: Sequence[Dict[str, np.ndarray]],
                 ground_truths: Sequence[Dict[str, np.ndarray]]) -> Dict[str, object]:
        """Batch convenience: lists of per-image dicts with keys
        boxes/scores/classes (det) and boxes/classes[/difficult] (gt)."""
        self.reset()
        for det, gt in zip(detections, ground_truths):
            self.add(det["boxes"], det["scores"], det["classes"],
                     gt["boxes"], gt["classes"], gt.get("difficult"))
        return self.result()


class CocoEvaluator:
    """COCO-protocol detection mAP — AP@[.5:.95]: the per-class AP
    (101-point interpolation) averaged over the 10 IoU thresholds
    0.50:0.05:0.95, plus the AP50/AP75 slices (ref the reference's COCO
    dataset support, objectdetection/common/dataset/Coco.scala; protocol
    per cocodataset.org#detection-eval). Crowd ground truth is treated
    like VOC difficult boxes: detections matching a crowd region are
    ignored (not false positives) — the ignore-region simplification of
    COCO's crowd IoU.
    """

    IOU_THRESHOLDS = tuple(np.round(np.arange(0.5, 1.0, 0.05), 2))

    def __init__(self, num_classes: int,
                 iou_thresholds: Optional[Sequence[float]] = None):
        self.thresholds = tuple(iou_thresholds or self.IOU_THRESHOLDS)
        self._per_t = [MeanAveragePrecision(num_classes, t,
                                            interpolation="101point")
                       for t in self.thresholds]

    def reset(self) -> None:
        """Clear accumulated detections/ground truth."""
        for m in self._per_t:
            m.reset()

    def add(self, det_boxes, det_scores, det_classes, gt_boxes, gt_classes,
            gt_crowd: Optional[np.ndarray] = None) -> None:
        """Accumulate one image's detections + ground truth."""
        for m in self._per_t:
            m.add(det_boxes, det_scores, det_classes, gt_boxes, gt_classes,
                  gt_difficult=gt_crowd)

    def evaluate(self, detections: Sequence[Dict[str, np.ndarray]],
                 ground_truths: Sequence[Dict[str, np.ndarray]]
                 ) -> Dict[str, object]:
        """Batch convenience mirroring PascalVocEvaluator.evaluate; gt
        dicts may carry a "crowd" bool vector."""
        self.reset()
        for det, gt in zip(detections, ground_truths):
            self.add(det["boxes"], det["scores"], det["classes"],
                     gt["boxes"], gt["classes"], gt.get("crowd"))
        return self.result()

    def result(self) -> Dict[str, object]:
        """COCO-protocol AP@[.5:.95] / AP50 / AP75 from the accumulation."""
        per_t = {t: m.result() for t, m in zip(self.thresholds, self._per_t)}
        maps = [r["mAP"] for r in per_t.values()]
        out = {
            "mAP": float(np.mean(maps)) if maps else 0.0,  # AP@[.5:.95]
            "per_threshold": {t: r["mAP"] for t, r in per_t.items()},
        }
        for name, t in (("AP50", 0.5), ("AP75", 0.75)):
            if t in per_t:
                out[name] = per_t[t]["mAP"]
        return out
