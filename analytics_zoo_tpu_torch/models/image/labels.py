"""Bundled dataset label maps (port of
``analytics_zoo_tpu.models.image.labels``; ref LabelReader.scala:24,
ModelLabelReader.scala): the public class-name lists of ImageNet-1k (in
the canonical training order, index 0 = "tench", as keras.applications
outputs), Pascal VOC and COCO, so that "model name -> readable
prediction" needs no network. The port reads its own copies under
``analytics_zoo_tpu_torch/resources``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

_RES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "resources")


def _read_names(fname: str):
    with open(os.path.join(_RES, fname)) as f:
        return [line.rstrip("\n") for line in f if line.strip()]


class LabelReader:
    """Dataset label id -> class name maps (ref LabelReader.scala)."""

    @staticmethod
    def read_imagenet(model_name: Optional[str] = None) -> Dict[int, str]:
        """The 1000-class ImageNet map (0-based, keras.applications
        order); inception-v3 uses the 2015 class-name spelling, as the
        reference does (LabelReader.scala:26)."""
        fname = ("imagenet_2015_classname.txt"
                 if model_name == "inception-v3" else
                 "imagenet_classname.txt")
        return dict(enumerate(_read_names(fname)))

    @staticmethod
    def read_pascal() -> Dict[int, str]:
        return dict(enumerate(_read_names("pascal_classname.txt")))

    @staticmethod
    def read_coco() -> Dict[int, str]:
        return dict(enumerate(_read_names("coco_classname.txt")))
