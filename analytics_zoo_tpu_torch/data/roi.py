"""Box-aware (roi) transforms, the detection-training data path (a copy
of the JAX package's host module ``analytics_zoo_tpu.data.roi`` over the
port's ``data.image_set``).

Ref: feature/image/RoiTransformer.scala (ImageRoiNormalize / ImageRoiHFlip /
ImageRoiResize / ImageRoiProject wrapping BigDL's label.roi ops) and
feature/image/RandomSampler.scala (ImageRandomSampler = the Caffe-SSD
BatchSampler recipe), composed into the canonical SSD train chain by
models/image/objectdetection/ssd/SSDDataSet.scala:43-54.

Ground truth rides on the ImageFeature as ``f["roi"]``: a float32 ``(G, 5)``
array of rows ``[label, x1, y1, x2, y2]`` (labels 1-based, 0 = padding,
the convention MultiBoxLoss consumes). Coordinates are pixels after decode;
``ImageRoiNormalize`` moves them to [0, 1] where the geometric ops compose
cleanly (the reference chain normalizes right after decode too).

Everything here is host-side numpy; ``to_detection_feature_set`` returns a
statically shaped (image, gt) ``ArrayFeatureSet`` for the train step. OpenCV
(``cv2``) is imported only by the readers, ``read_voc`` and ``read_coco``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.data.image_set import (
    ImageFeature,
    ImageProcessing,
    ImageSet,
)


def _roi(f: ImageFeature) -> Optional[np.ndarray]:
    r = f.get("roi")
    if r is None:
        return None
    return np.asarray(r, np.float32).reshape(-1, 5)


class ImageRoiNormalize(ImageProcessing):
    """Normalize roi coords to [0, 1] (ref RoiTransformer.scala:25)."""

    def apply(self, f: ImageFeature) -> ImageFeature:
        r = _roi(f)
        if r is not None and not f.get("roi_normalized", False):
            h, w = f["image"].shape[:2]
            r = r.copy()
            r[:, 1:] /= np.array([w, h, w, h], np.float32)
            f["roi"] = r
            f["roi_normalized"] = True
        return f


class ImageRoiHFlip(ImageProcessing):
    """Horizontally flip the roi (ref RoiTransformer.scala:40). Pair with
    ImageHFlip under one ImageRandomPreprocessing so image and boxes flip
    together."""

    def __init__(self, normalized: bool = True):
        self.normalized = normalized

    def apply(self, f: ImageFeature) -> ImageFeature:
        r = _roi(f)
        if r is not None:
            width = 1.0 if self.normalized else float(f["image"].shape[1])
            r = r.copy()
            x1 = r[:, 1].copy()
            r[:, 1] = width - r[:, 3]
            r[:, 3] = width - x1
            f["roi"] = r
        return f


class ImageRoiResize(ImageProcessing):
    """Rescale pixel-coord rois after an ImageResize (ref
    RoiTransformer.scala:55). Normalized rois are resize-invariant; for the
    pixel path this reads the pre-resize size ImageResize records."""

    def __init__(self, normalized: bool = False):
        self.normalized = normalized

    def apply(self, f: ImageFeature) -> ImageFeature:
        r = _roi(f)
        if r is None or self.normalized or f.get("roi_normalized", False):
            return f
        before = f.get("size_before_resize")
        if before is None:
            return f
        oh, ow = before
        nh, nw = f["image"].shape[:2]
        r = r.copy()
        r[:, 1:] *= np.array([nw / ow, nh / oh, nw / ow, nh / oh], np.float32)
        f["roi"] = r
        return f


class ImageRoiProject(ImageProcessing):
    """Project gt boxes onto the image window: clip to [0, 1] and (by
    default) drop boxes whose center left the window (ref
    RoiTransformer.scala:71). Dropped rows become label-0 padding so the
    array shape stays static."""

    def __init__(self, need_meet_center_constraint: bool = True):
        self.center = need_meet_center_constraint

    def apply(self, f: ImageFeature) -> ImageFeature:
        r = _roi(f)
        if r is None:
            return f
        r = r.copy()
        boxes = r[:, 1:]
        if self.center:
            cx = 0.5 * (boxes[:, 0] + boxes[:, 2])
            cy = 0.5 * (boxes[:, 1] + boxes[:, 3])
            inside = (cx >= 0) & (cx <= 1) & (cy >= 0) & (cy <= 1)
        else:
            inside = (boxes[:, 2] > 0) & (boxes[:, 0] < 1) & \
                     (boxes[:, 3] > 0) & (boxes[:, 1] < 1)
        np.clip(boxes, 0.0, 1.0, out=boxes)
        degenerate = (boxes[:, 2] <= boxes[:, 0]) | (boxes[:, 3] <= boxes[:, 1])
        keep = inside & ~degenerate
        r[~keep, 0] = 0.0   # padding label
        r[~keep, 1:] = 0.0
        # compact: real boxes first (stable), padding after
        order = np.argsort(~keep, kind="stable")
        f["roi"] = r[order]
        return f


# ---------------------------------------------------------------------------
# SSD batch sampler (ref RandomSampler.scala → BigDL BatchSampler; the
# Caffe-SSD data-augmentation recipe)
# ---------------------------------------------------------------------------


@dataclass
class BatchSampler:
    """One constrained patch sampler (a Caffe ``batch_sampler`` block)."""

    min_scale: float = 0.3
    max_scale: float = 1.0
    min_aspect: float = 0.5
    max_aspect: float = 2.0
    min_overlap: Optional[float] = None
    max_overlap: Optional[float] = None
    max_trials: int = 50

    def sample(self, rng: np.random.Generator,
               gt_boxes: np.ndarray) -> Optional[np.ndarray]:
        """Return a satisfying normalized patch [x1,y1,x2,y2] or None."""
        for _ in range(self.max_trials):
            scale = rng.uniform(self.min_scale, self.max_scale)
            # aspect constrained so w,h stay <= 1 (Caffe semantics)
            lo = max(self.min_aspect, scale ** 2)
            hi = min(self.max_aspect, 1.0 / scale ** 2)
            if lo > hi:
                continue
            aspect = rng.uniform(lo, hi)
            w = scale * np.sqrt(aspect)
            h = scale / np.sqrt(aspect)
            x = rng.uniform(0.0, 1.0 - w)
            y = rng.uniform(0.0, 1.0 - h)
            patch = np.array([x, y, x + w, y + h], np.float32)
            if self._satisfies(patch, gt_boxes):
                return patch
        return None

    def _satisfies(self, patch: np.ndarray, gt: np.ndarray) -> bool:
        if self.min_overlap is None and self.max_overlap is None:
            return True
        if gt.size == 0:
            return True
        lt = np.maximum(patch[:2], gt[:, :2])
        rb = np.minimum(patch[2:], gt[:, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[:, 0] * wh[:, 1]
        area = lambda b: np.clip(b[..., 2] - b[..., 0], 0, None) * \
            np.clip(b[..., 3] - b[..., 1], 0, None)
        union = area(patch) + area(gt) - inter
        iou = np.where(union > 0, inter / union, 0.0)
        ok = np.ones_like(iou, bool)
        if self.min_overlap is not None:
            ok &= iou >= self.min_overlap
        if self.max_overlap is not None:
            ok &= iou <= self.max_overlap
        return bool(ok.any())


def ssd_default_samplers() -> List[BatchSampler]:
    """The canonical 7-sampler SSD block: whole image + min-IoU
    {0.1,0.3,0.5,0.7,0.9} + a max-IoU 1.0 sampler."""
    samplers = [BatchSampler(min_scale=1.0, max_scale=1.0, min_aspect=1.0,
                             max_aspect=1.0, max_trials=1)]
    for t in (0.1, 0.3, 0.5, 0.7, 0.9):
        samplers.append(BatchSampler(min_overlap=t))
    samplers.append(BatchSampler(max_overlap=1.0))
    return samplers


class ImageRandomSampler(ImageProcessing):
    """Random constrained crop for SSD training (ref RandomSampler.scala:31).

    Requires normalized rois. Gathers one satisfying patch per sampler,
    picks uniformly among them, crops the image and projects the boxes
    (center constraint) onto the patch. If no sampler succeeds the image
    passes through untouched."""

    def __init__(self, samplers: Optional[Sequence[BatchSampler]] = None,
                 seed: Optional[int] = None):
        self.samplers = list(samplers) if samplers is not None \
            else ssd_default_samplers()
        self.rng = np.random.default_rng(seed)

    def apply(self, f: ImageFeature) -> ImageFeature:
        r = _roi(f)
        gt = r[r[:, 0] > 0, 1:] if r is not None else np.zeros((0, 4))
        candidates = []
        for s in self.samplers:
            patch = s.sample(self.rng, gt)
            if patch is not None:
                candidates.append(patch)
        if not candidates:
            return f
        patch = candidates[int(self.rng.integers(len(candidates)))]
        img = f["image"]
        h, w = img.shape[:2]
        x1, y1, x2, y2 = patch
        px1, py1 = int(round(x1 * w)), int(round(y1 * h))
        px2, py2 = max(px1 + 1, int(round(x2 * w))), max(py1 + 1, int(round(y2 * h)))
        f["image"] = img[py1:py2, px1:px2]
        if r is not None:
            r = r.copy()
            pw, ph = x2 - x1, y2 - y1
            r[:, 1:] = (r[:, 1:] - np.array([x1, y1, x1, y1], np.float32)) / \
                np.array([pw, ph, pw, ph], np.float32)
            f["roi"] = r
            f = ImageRoiProject(need_meet_center_constraint=True).apply(f)
        return f


# ---------------------------------------------------------------------------
# Batching (ref RoiImageToSSDBatch / SSDMiniBatch)
# ---------------------------------------------------------------------------


def pad_roi(roi: Optional[np.ndarray], max_boxes: int) -> np.ndarray:
    """Pad/truncate an (G, 5) roi to exactly ``max_boxes`` rows."""
    out = np.zeros((max_boxes, 5), np.float32)
    if roi is not None and len(roi):
        r = np.asarray(roi, np.float32).reshape(-1, 5)
        r = r[r[:, 0] > 0][:max_boxes]
        out[:len(r)] = r
    return out


def read_voc(directory: str,
             class_names: Optional[Sequence[str]] = None,
             include_difficult: bool = True
             ) -> Tuple[ImageSet, List[str]]:
    """Read a Pascal-VOC-layout detection dataset
    (``JPEGImages/*.jpg`` + ``Annotations/*.xml``) into an ImageSet whose
    features carry ``roi`` ground truth (ref ImageSet.read + the roi
    parsing BigDL's SSDDataSet/PascalVoc loaders do).

    ``class_names``: foreground classes in label order (label = index + 1;
    0 stays background/padding). Defaults to the sorted set found in the
    annotations. Returns (image_set, class_names).
    """
    import os
    import xml.etree.ElementTree as ET

    import cv2

    ann_dir = os.path.join(directory, "Annotations")
    img_dir = os.path.join(directory, "JPEGImages")
    if not os.path.isdir(ann_dir) or not os.path.isdir(img_dir):
        raise FileNotFoundError(
            f"{directory} is not VOC-layout (needs Annotations/ and "
            "JPEGImages/)")
    records = []
    seen = set()
    for fname in sorted(os.listdir(ann_dir)):
        if not fname.endswith(".xml"):
            continue
        root = ET.parse(os.path.join(ann_dir, fname)).getroot()
        img_name = root.findtext("filename")
        if not img_name:
            stem = fname[:-4]
            for ext in (".jpg", ".jpeg", ".png"):
                if os.path.exists(os.path.join(img_dir, stem + ext)):
                    img_name = stem + ext
                    break
            else:
                img_name = stem + ".jpg"
        objs = []
        for ob in root.findall("object"):
            if not include_difficult and ob.findtext("difficult") == "1":
                continue
            bb = ob.find("bndbox")
            objs.append((ob.findtext("name"),
                         float(bb.findtext("xmin")),
                         float(bb.findtext("ymin")),
                         float(bb.findtext("xmax")),
                         float(bb.findtext("ymax"))))
            seen.add(objs[-1][0])
        records.append((os.path.join(img_dir, img_name), objs))
    if class_names is None:
        class_names = sorted(seen)
    label = {c: i + 1 for i, c in enumerate(class_names)}
    feats = []
    skipped = 0
    for path, objs in records:
        img = cv2.imread(path)  # BGR, the chain's decode convention
        if img is None:
            skipped += 1  # one corrupt JPEG must not kill a large dataset
            continue
        roi = np.asarray(
            [[label[c], x1, y1, x2, y2] for c, x1, y1, x2, y2 in objs
             if c in label], np.float32).reshape(-1, 5)
        feats.append(ImageFeature(image=img, roi=roi, uri=path))
    if skipped:
        import logging

        logging.getLogger("analytics_zoo_tpu_torch").warning(
            "read_voc: skipped %d unreadable image(s) under %s",
            skipped, img_dir)
    if not feats:
        raise FileNotFoundError(f"no readable annotated images in {directory}")
    return ImageSet(feats), list(class_names)


def to_detection_feature_set(image_set: ImageSet, max_boxes: int = 32):
    """Materialize an ImageSet (with its transform chain) into an
    ArrayFeatureSet of (image, padded-gt) pairs — the SSDMiniBatch analogue.
    Images must come out of the chain uniformly sized (resize in-chain)."""
    from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet

    xs, ys = [], []
    for f in image_set.features:
        out = image_set._apply(f)
        xs.append(np.asarray(out.get("sample", out["image"]), np.float32))
        ys.append(pad_roi(out.get("roi"), max_boxes))
    return ArrayFeatureSet(np.stack(xs), np.stack(ys))


def read_coco(images_dir: str, annotation_file: str,
              class_names: Optional[Sequence[str]] = None
              ) -> Tuple[ImageSet, List[str]]:
    """Read a COCO-layout detection dataset (an images directory + an
    ``instances_*.json`` annotation file) into an ImageSet whose features
    carry ``roi`` ground truth — the COCO counterpart of :func:`read_voc`
    (ref objectdetection/common/dataset/Coco.scala).

    COCO ``bbox`` is [x, y, w, h]; converted to corner form here. Category
    ids (sparse in COCO) map to contiguous labels 1..C in ``class_names``
    order (default: categories sorted by COCO id). ``iscrowd`` regions are
    kept with the per-feature ``"crowd"`` bool vector — evaluators ignore
    detections matching them, the same treatment as VOC difficult boxes.
    Returns (image_set, class_names).
    """
    import json
    import os

    import cv2

    with open(annotation_file) as f:
        coco = json.load(f)
    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    if class_names is None:
        class_names = [c["name"] for c in cats]
    name_of = {c["id"]: c["name"] for c in cats}
    label = {n: i + 1 for i, n in enumerate(class_names)}
    by_image: Dict[int, list] = {}
    for ann in coco.get("annotations", []):
        by_image.setdefault(ann["image_id"], []).append(ann)

    feats = []
    skipped = 0
    for im in sorted(coco.get("images", []), key=lambda i: i["id"]):
        path = os.path.join(images_dir, im["file_name"])
        img = cv2.imread(path)  # BGR, the chain's decode convention
        if img is None:
            skipped += 1  # one corrupt image must not kill a large dataset
            continue
        rows, crowd = [], []
        for ann in by_image.get(im["id"], []):
            cname = name_of.get(ann["category_id"])
            if cname not in label:
                continue
            x, y, w, h = ann["bbox"]
            rows.append([label[cname], x, y, x + w, y + h])
            crowd.append(bool(ann.get("iscrowd", 0)))
        f = ImageFeature(image=img, uri=path,
                         roi=np.asarray(rows, np.float32).reshape(-1, 5))
        f["crowd"] = np.asarray(crowd, bool)
        feats.append(f)
    if skipped:
        import logging

        logging.getLogger("analytics_zoo_tpu_torch").warning(
            "read_coco: skipped %d unreadable image(s) under %s",
            skipped, images_dir)
    if not feats:
        raise FileNotFoundError(
            f"no readable annotated images for {annotation_file}")
    return ImageSet(feats), list(class_names)
