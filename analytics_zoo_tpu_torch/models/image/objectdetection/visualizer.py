"""Label maps and the transform-chain visualizer (port of
``analytics_zoo_tpu.models.image.objectdetection.visualizer``; ref
objectdetection/{LabelReader.scala, Visualizer.scala} and the pascal/coco
classname resources).

Drawing itself lives in :class:`..detector.Visualizer` (PIL, dict input);
this module adds the reference's two other surfaces: the label maps
(LabelReader) and the ImageProcessing-chain form of the visualizer that
consumes the (N, 6) roi array attached to an ImageFeature by prediction
(Visualizer.scala:30-44). The Pascal map is the detector's
``PASCAL_CLASSES``; the COCO map below is the one the port ships as
``resources/coco_classname.txt`` (``models/image/labels.py``), with the
background class first.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from analytics_zoo_tpu_torch.data.image_set import ImageFeature, ImageProcessing
from analytics_zoo_tpu_torch.models.image import labels
from analytics_zoo_tpu_torch.models.image.objectdetection.detector import (
    PASCAL_CLASSES,
    Visualizer,
)

# The COCO-80 class list, background first, from the port's resources
COCO_CLASSES = tuple(labels.LabelReader.read_coco().values())


class LabelReader:
    """Ref LabelReader.scala: label maps for the detection model catalog.
    ``LabelReader("pascal")`` / ``LabelReader("coco")`` return
    {class_id: name}."""

    @staticmethod
    def read_pascal_label_map() -> Dict[int, str]:
        """id -> Pascal VOC class name map (bundled public list)."""
        return dict(enumerate(PASCAL_CLASSES))

    @staticmethod
    def read_coco_label_map() -> Dict[int, str]:
        """id -> COCO category name map (bundled public list)."""
        return dict(enumerate(COCO_CLASSES))

    def __new__(cls, dataset: str) -> Dict[int, str]:
        key = dataset.lower()
        if key == "pascal":
            return cls.read_pascal_label_map()
        if key == "coco":
            return cls.read_coco_label_map()
        raise ValueError(
            "currently only pascal and coco label maps are bundled "
            f"(got '{dataset}')")


class VisualizeDetections(ImageProcessing):
    """Transform-chain visualizer (ref Visualizer.scala): reads the (N, 6)
    roi array — rows (class_id, score, xmin, ymin, xmax, ymax) — from
    ``predict_key``, draws boxes above ``thresh`` onto the image, stores the
    annotated HWC uint8 array under ``out_key``."""

    def __init__(self, label_map=PASCAL_CLASSES, thresh: float = 0.3,
                 predict_key: str = "predict", out_key: str = "visualized"):
        self._viz = Visualizer(label_map=label_map, threshold=thresh)
        self.predict_key = predict_key
        self.out_key = out_key

    def apply(self, f: ImageFeature) -> ImageFeature:
        rois = np.asarray(f.get(self.predict_key, np.zeros((0, 6))))
        if rois.ndim != 2 or (len(rois) and rois.shape[1] != 6):
            raise ValueError(
                "rois must be (N, 6): class, score, xmin, ymin, xmax, ymax")
        dets = {"classes": rois[:, 0], "scores": rois[:, 1],
                "boxes": rois[:, 2:6]}
        f[self.out_key] = self._viz.visualize(np.asarray(f["image"]), dets)
        return f
