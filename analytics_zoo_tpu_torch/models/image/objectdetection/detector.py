"""ObjectDetector (port of
``analytics_zoo_tpu.models.image.objectdetection.detector``; ref
models/image/objectdetection/{ObjectDetector, ObjectDetectionConfig.scala:
31-143}) plus the Visualizer.

The reference pairs each zoo model name with a preprocessing and
postprocessing config; predict runs the graph, then a DetectionOutput
layer. Here the graph emits (B, P, 4 + C) logits (Faster-RCNN: its packed
per-RoI rows) and the post-processing is a torch function of that raw
output on the device: a float32 softmax, a top-k of the best foreground
score (equal scores keep the lower prior index), decode and clip, and
``ops.bbox.multiclass_nms``. ``predict_detections`` runs the forward as an
``InferenceModel`` predict bucket and the post-process as one of its
programs (``compile_program``): on the card one CUDA graph each per batch
shape, which the post-process can be because nothing in it syncs with the
host. The host keeps what the JAX package keeps on the host: the ``valid &
score >= threshold`` filter, ``scale_detections`` and the label lookup.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dc_replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.models.image import labels
from analytics_zoo_tpu_torch.models.image.objectdetection import ssd as ssd_lib
from analytics_zoo_tpu_torch.ops.bbox import (
    clip_boxes,
    decode_boxes,
    descending_order,
    multiclass_nms,
    scale_detections,
)

# The Pascal VOC classes, background first, from the port's resources
PASCAL_CLASSES = tuple(labels.LabelReader.read_pascal().values())


@dataclass
class ObjectDetectionConfig:
    """Pre/post-processing bundle per catalog entry
    (ref ObjectDetectionConfig.scala:31-143)."""

    model_name: str
    img_size: int
    num_classes: int = 21
    mean: Tuple[float, float, float] = (123.0, 117.0, 104.0)  # RGB pixel mean
    scale: float = 1.0
    score_threshold: float = 0.01
    iou_threshold: float = 0.45
    max_per_class: int = 100
    max_total: int = 200
    # Priors kept per image before class-wise NMS (ranked by best foreground
    # score). NMS builds a (K, K) IoU matrix, so this bounds post-processing
    # memory at K^2 instead of P^2 (P=8732 for SSD300): the same top-k
    # pre-selection the reference's DetectionOutput performs.
    pre_nms_topk: int = 1000
    label_map: Sequence[str] = PASCAL_CLASSES

    def preprocess(self, images: np.ndarray) -> np.ndarray:
        """uint8/float RGB (B, H, W, 3) -> network input. Images of another
        size are resized with PIL, imported only then."""
        x = np.asarray(images, np.float32)
        if x.ndim == 3:
            x = x[None]
        if x.shape[1] != self.img_size or x.shape[2] != self.img_size:
            from PIL import Image

            out = np.empty((x.shape[0], self.img_size, self.img_size, 3),
                           np.float32)
            for i, img in enumerate(x):
                pil = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
                out[i] = np.asarray(
                    pil.resize((self.img_size, self.img_size)), np.float32)
            x = out
        return (x - np.asarray(self.mean, np.float32)) * self.scale


_CATALOG: Dict[str, Tuple[Callable, ObjectDetectionConfig]] = {
    "ssd-vgg16-300x300": (
        ssd_lib.ssd_vgg16_300,
        ObjectDetectionConfig("ssd-vgg16-300x300", 300)),
    "ssd-vgg16-512x512": (
        ssd_lib.ssd_vgg16_512,
        ObjectDetectionConfig("ssd-vgg16-512x512", 512)),
    "ssd-mobilenet-300x300": (
        ssd_lib.ssd_mobilenet_300,
        ObjectDetectionConfig("ssd-mobilenet-300x300", 300,
                              mean=(127.5, 127.5, 127.5), scale=1 / 127.5)),
    "ssd-tiny-64x64": (
        ssd_lib.ssd_tiny,
        ObjectDetectionConfig("ssd-tiny-64x64", 64,
                              mean=(127.5, 127.5, 127.5), scale=1 / 127.5)),
}


def _register_frcnn():
    from analytics_zoo_tpu_torch.models.image.objectdetection import (
        frcnn as _f,
    )

    def build(num_classes=21, img_size=608, **kw):
        return _f.frcnn_vgg16(num_classes=num_classes, img_size=img_size, **kw)

    def build_pva(num_classes=21, img_size=608, **kw):
        return _f.frcnn_pvanet(num_classes=num_classes, img_size=img_size,
                               **kw)

    # ref ObjectDetectionConfig.scala:38-46 catalog names
    _CATALOG["frcnn-vgg16"] = (
        build, ObjectDetectionConfig("frcnn-vgg16", 608))
    _CATALOG["frcnn-pvanet"] = (
        build_pva, ObjectDetectionConfig("frcnn-pvanet", 608))


_register_frcnn()


def ssd_postprocess(priors: np.ndarray, cfg: ObjectDetectionConfig):
    """The SSD post-process as a torch function of the raw (B, P, 4 + C)
    output -> (boxes (B, max_total, 4), scores, classes int32, valid):
    float32 softmax, the ``pre_nms_topk`` priors by best foreground score
    (a stable top-k: equal scores keep the lower prior index, as
    ``lax.top_k``), decode and clip, ``multiclass_nms``."""
    topk = min(cfg.pre_nms_topk, priors.shape[0])
    on_device = {}

    def post(raw):
        key = str(raw.device)
        if key not in on_device:
            on_device[key] = torch.tensor(priors, device=raw.device)
        loc = raw[..., :4].float()
        conf = torch.softmax(raw[..., 4:].float(), dim=-1)
        keep = descending_order(torch.amax(conf[..., 1:], dim=-1), topk)
        loc = torch.gather(loc, 1, keep[..., None].expand(-1, -1, 4))
        conf = torch.gather(conf, 1,
                            keep[..., None].expand(-1, -1, conf.shape[-1]))
        boxes = clip_boxes(decode_boxes(on_device[key][keep], loc))
        return multiclass_nms(
            boxes, conf, score_threshold=cfg.score_threshold,
            iou_threshold=cfg.iou_threshold,
            max_per_class=cfg.max_per_class, max_total=cfg.max_total)

    return post


class ObjectDetector(ZooModel):
    """Catalog-driven detector with decode + NMS post-processing.

    ``predict_detections`` returns, per image, a dict of numpy arrays
    ``{"boxes" (N,4) pixel coords, "scores" (N,), "classes" (N,),
    "labels" [str]}``, the reference's VisualizedOutput/DetectionOutput
    analogue with the padding already stripped.
    """

    def __init__(self, model_name: str = "ssd-vgg16-300x300",
                 num_classes: int = 21,
                 config: Optional[ObjectDetectionConfig] = None,
                 weights: Optional[str] = None):
        super().__init__()
        if model_name not in _CATALOG:
            raise ValueError(
                f"Unknown detector '{model_name}'. Catalog: {sorted(_CATALOG)}")
        self.model_name = model_name
        self.num_classes = int(num_classes)
        builder, default_cfg = _CATALOG[model_name]
        # Copy the catalog config (it is shared module state) and keep its
        # num_classes in sync with the graph being built.
        self.det_config = dc_replace(config if config is not None
                                     else default_cfg,
                                     num_classes=self.num_classes)
        self._builder = builder
        self.model = self.build_model()
        self._post = None
        self._served = None  # (InferenceModel, the params, compute dtype)
        if weights:
            # local pretrained weights: the framework's own format, or a
            # Keras .h5 weight file poured by layer name
            from analytics_zoo_tpu_torch.models.image.imageclassification import (
                load_pretrained_weights,
            )

            load_pretrained_weights(self.model, weights)

    def build_model(self):
        if self.model_name.startswith("frcnn"):
            return self._builder(num_classes=self.num_classes,
                                 img_size=self.det_config.img_size)
        return self._builder(num_classes=self.num_classes)

    def config(self):
        return {"model_name": self.model_name, "num_classes": self.num_classes}

    # -- loss wiring -------------------------------------------------------

    def multibox_loss(self, **kw):
        """A MultiBoxLoss bound to this model's priors, for compile()."""
        from analytics_zoo_tpu_torch.models.image.objectdetection.loss import (
            MultiBoxLoss,
        )

        return MultiBoxLoss(self.model.ssd_config.priors(),
                            self.num_classes, **kw)

    # -- inference ---------------------------------------------------------

    def postprocess_fn(self):
        """The post-process, a torch function of the raw model output ->
        (boxes (B, max_total, 4) normalized, scores, classes int32, valid)
        on the raw output's device."""
        if self._post is None:
            cfg = self.det_config
            if hasattr(self.model, "frcnn_config"):
                from analytics_zoo_tpu_torch.models.image.objectdetection.frcnn import (
                    frcnn_postprocess,
                )

                self._post = frcnn_postprocess(
                    self.model.frcnn_config, self.num_classes,
                    score_threshold=cfg.score_threshold,
                    iou_threshold=cfg.iou_threshold,
                    max_per_class=cfg.max_per_class,
                    max_total=cfg.max_total)
            else:
                self._post = ssd_postprocess(self.model.ssd_config.priors(),
                                             cfg)
        return self._post

    def inference_model(self):
        """The ``InferenceModel`` serving this detector's current weights
        (loaded again when the model's parameters or compute dtype
        changed, as after ``fit``)."""
        from analytics_zoo_tpu_torch.inference import InferenceModel

        self.model.ensure_params()
        params, dtype = self.model.params, self.model.compute_dtype
        if (self._served is None or self._served[1] is not params
                or self._served[2] != dtype):
            # the params dict is held, not its id: a freed dict's id could
            # come back for newer weights
            self._served = (InferenceModel().do_load_keras(self.model),
                            params, dtype)
        return self._served[0]

    def postprocess_program(self, raw: torch.Tensor):
        """``(program, params, state)`` of the post-process at ``raw``'s
        signature, an ``InferenceModel`` program (on the card a CUDA
        graph); its float32 input is not cast to the compute dtype. Call
        ``program(params, state, raw)``."""
        post = self.postprocess_fn()
        return self.inference_model().compile_program(
            "detection_postprocess", lambda p, s, r: post(r), (raw,),
            cast=False)

    def detect_raw(self, x) -> Tuple[torch.Tensor, ...]:
        """One preprocessed batch ``x`` through the forward (a predict
        bucket) and the post-process (a program): the post-process's
        device tensors."""
        raw = self.inference_model().do_dispatch(x)
        prog, params, state = self.postprocess_program(raw)
        return prog(params, state, raw)

    def predict_detections(self, images: np.ndarray,
                           original_sizes: Optional[Sequence[Tuple[int, int]]] = None,
                           score_threshold: Optional[float] = None,
                           batch_size: int = 32) -> List[Dict[str, np.ndarray]]:
        """Decoded, NMS-filtered (label, score, box) lists per image, run
        in batches of ``batch_size`` (the last may be smaller)."""
        cfg = self.det_config
        x = cfg.preprocess(images)
        chunks = [[t.cpu().numpy() for t in self.detect_raw(x[i:i + batch_size])]
                  for i in range(0, len(x), batch_size)]
        boxes, scores, classes, valid = (
            np.concatenate([c[k] for c in chunks]) for k in range(4))
        thr = cfg.score_threshold if score_threshold is None else score_threshold
        out = []
        for i in range(boxes.shape[0]):
            keep = valid[i] & (scores[i] >= thr)
            w, h = ((cfg.img_size, cfg.img_size) if original_sizes is None
                    else original_sizes[i])
            b = scale_detections(boxes[i][keep], w, h)
            c = classes[i][keep]
            out.append({
                "boxes": b,
                "scores": scores[i][keep],
                "classes": c,
                "labels": [cfg.label_map[int(ci)]
                           if int(ci) < len(cfg.label_map) else str(int(ci))
                           for ci in c],
            })
        return out


class Visualizer:
    """Draw detections onto images (ref the objectdetection Visualizer,
    OpenCV putText/rectangle there; PIL here, imported in ``visualize``)."""

    def __init__(self, label_map: Sequence[str] = PASCAL_CLASSES,
                 threshold: float = 0.3):
        self.label_map = label_map
        self.threshold = threshold

    def visualize(self, image: np.ndarray, detections: Dict[str, np.ndarray]):
        """Draw detection boxes + class/score labels onto the image
        (PIL); returns the annotated array."""
        from PIL import Image, ImageDraw

        img = Image.fromarray(np.clip(image, 0, 255).astype(np.uint8))
        draw = ImageDraw.Draw(img)
        palette = ["#e6194b", "#3cb44b", "#4363d8", "#f58231", "#911eb4",
                   "#46f0f0", "#f032e6", "#bcf60c", "#fabebe", "#008080"]
        for box, score, cls in zip(detections["boxes"], detections["scores"],
                                   detections["classes"]):
            if score < self.threshold:
                continue
            color = palette[int(cls) % len(palette)]
            draw.rectangle([float(box[0]), float(box[1]),
                            float(box[2]), float(box[3])],
                           outline=color, width=2)
            name = (self.label_map[int(cls)]
                    if int(cls) < len(self.label_map) else str(int(cls)))
            draw.text((float(box[0]) + 2, float(box[1]) + 2),
                      f"{name}:{score:.2f}", fill=color)
        return np.asarray(img)
