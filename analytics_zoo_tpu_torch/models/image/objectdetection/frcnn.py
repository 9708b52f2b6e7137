"""Faster-RCNN, VGG16 and PVANet (port of
``analytics_zoo_tpu.models.image.objectdetection.frcnn``; ref the
"frcnn-vgg16"/"frcnn-pvanet" entries of ObjectDetectionConfig.scala:38-46).

Every stage that is dynamic in the classic implementation (proposal
selection, NMS, RoI gathering) has static shapes, so the whole detector
(backbone -> RPN -> proposals -> RoI-align -> head) is one forward with no
host sync, which ``InferenceModel`` captures as one CUDA graph:

- proposals: decode and clip the anchors, a stable top-k of the
  objectness (equal scores keep the lower anchor index, as ``lax.top_k``),
  the padded NMS of ``ops.bbox`` at 0.7; invalid slots ride along with
  score 0 instead of being dropped;
- RoI-align: bilinear sampling as batched gathers (advanced indexing over
  batch, RoI and grid), with the JAX package's floor/clip order;
- the head runs on all ``post_nms_top_n`` slots every time, padded RoIs
  included.

Dtypes under bf16 compute follow the JAX package's type promotion: the
proposals and the RoI sampling weights are float32 (the float32 anchors
promote the decode), so the bilinear blend of the bf16 features is float32,
and fc6, fc7, ``cls_score`` and ``bbox_pred`` multiply it by their bf16
kernels upcast to float32 (``Dense`` promotes as ``jnp.matmul`` does); the
packed output is float32.

Box regression uses the Faster-RCNN parameterization = the SSD
center-size codec with unit variances (``decode_boxes(variances=(1, 1, 1,
1))``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.autograd.variable import Variable, apply_layer
from analytics_zoo_tpu_torch.keras.engine.base import Lambda, unique_name
from analytics_zoo_tpu_torch.keras.engine.topology import Input, Model
from analytics_zoo_tpu_torch.keras.layers import (
    Activation,
    Convolution2D,
    Dense,
    MaxPooling2D,
    Merge,
    UpSampling2D,
)
from analytics_zoo_tpu_torch.ops.bbox import (
    clip_boxes,
    decode_boxes,
    descending_order,
    nms,
    top_detections,
)

_UNIT_VAR = (1.0, 1.0, 1.0, 1.0)


@dataclass(frozen=True)
class FrcnnConfig:
    img_size: int = 600
    stride: int = 16
    anchor_scales: Tuple[int, ...] = (8, 16, 32)   # x stride -> 128/256/512 px
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    pre_nms_top_n: int = 1000
    post_nms_top_n: int = 100
    rpn_nms_iou: float = 0.7
    roi_size: int = 7
    fc_dim: int = 4096

    @property
    def feat_size(self) -> int:
        return self.img_size // self.stride

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_scales) * len(self.anchor_ratios)

    def anchors(self) -> np.ndarray:
        """(Hf*Wf*A, 4) corner anchors, normalized to [0,1] image coords."""
        f, s = self.feat_size, self.stride
        cy, cx = np.meshgrid(np.arange(f), np.arange(f), indexing="ij")
        centers = (np.stack([cx, cy], -1) + 0.5) * s          # pixel coords
        boxes = []
        for scale in self.anchor_scales:
            for ratio in self.anchor_ratios:
                area = (scale * s) ** 2
                w = np.sqrt(area / ratio)
                h = w * ratio
                half = np.array([w, h]) / 2.0
                boxes.append(np.concatenate(
                    [centers - half, centers + half], axis=-1))
        out = np.stack(boxes, axis=2).reshape(-1, 4)          # (f*f*A, 4)
        return (out / self.img_size).astype(np.float32)


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t`` (B, N, D) rows ``idx`` (B, K) -> (B, K, D)."""
    return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))


def _proposals(cfg: FrcnnConfig):
    """Proposal generation over the batch: decode the anchors, clip, a
    stable top-k of the objectness, NMS; (B, post, 5) rows [x1, y1, x2, y2,
    score], padded slots all 0."""
    anchors_host = cfg.anchors()
    pre = min(cfg.pre_nms_top_n, anchors_host.shape[0])
    post = cfg.post_nms_top_n
    anchors = {}

    def fn(obj_map, delta_map):
        key = str(obj_map.device)
        if key not in anchors:
            anchors[key] = torch.tensor(anchors_host, device=obj_map.device)
        b = obj_map.shape[0]
        obj = obj_map.reshape(b, -1)
        deltas = delta_map.reshape(b, -1, 4)
        boxes = clip_boxes(decode_boxes(anchors[key], deltas, _UNIT_VAR))
        keep = descending_order(obj, pre)
        scores = torch.gather(obj, 1, keep)
        boxes = _gather_rows(boxes, keep)
        idx, valid = nms(boxes, scores, post, iou_threshold=cfg.rpn_nms_iou)
        rois = torch.where(valid[..., None], _gather_rows(boxes, idx), 0.0)
        rscore = torch.where(valid, torch.gather(scores, 1, idx), 0.0)
        return torch.cat([rois, rscore[..., None].to(rois.dtype)], dim=-1)

    return fn


def _roi_align(cfg: FrcnnConfig):
    """(features (B,Hf,Wf,C), rois (B,N,5)) -> (B, N, r, r, C) bilinear
    samples at the bin centres (align_corners=False), in the promoted
    dtype of the features and the float32 weights."""
    r = cfg.roi_size

    def fn(feat, rois):
        b, hf, wf = feat.shape[0], feat.shape[1], feat.shape[2]
        t = (torch.arange(r, dtype=torch.float32, device=rois.device)
             + 0.5) / r
        x1, y1, x2, y2 = (rois[..., i:i + 1] for i in range(4))  # (B, N, 1)
        ys = (y1 + t * (y2 - y1)) * hf - 0.5                     # (B, N, r)
        xs = (x1 + t * (x2 - x1)) * wf - 0.5
        y0 = torch.clamp(torch.floor(ys), 0, hf - 1)
        x0 = torch.clamp(torch.floor(xs), 0, wf - 1)
        y1i = torch.clamp(y0 + 1, 0, hf - 1).long()
        x1i = torch.clamp(x0 + 1, 0, wf - 1).long()
        wy = torch.clamp(ys - y0, 0.0, 1.0)
        wx = torch.clamp(xs - x0, 0.0, 1.0)
        y0, x0 = y0.long(), x0.long()
        bi = torch.arange(b, device=feat.device)[:, None, None, None]

        def at(yi, xi):  # (B, N, r) rows x (B, N, r) cols -> (B, N, r, r, C)
            return feat[bi, yi[..., :, None], xi[..., None, :]]

        f00, f01 = at(y0, x0), at(y0, x1i)
        f10, f11 = at(y1i, x0), at(y1i, x1i)
        wy_ = wy[..., :, None, None]
        wx_ = wx[..., None, :, None]
        out = ((1 - wy_) * (1 - wx_) * f00 + (1 - wy_) * wx_ * f01
               + wy_ * (1 - wx_) * f10 + wy_ * wx_ * f11)
        return out

    return fn


def _vgg_conv5(inp: Variable) -> Variable:
    """VGG16 through conv5_3, stride 16 (no pool5, the Faster-RCNN
    layout)."""

    def block(x, filters, kernel, name):
        c = Convolution2D(filters, kernel, border_mode="same",
                          dim_ordering="tf", name=name)
        return Activation("relu")(c(x))

    x = inp
    for b, (reps, filters) in enumerate([(2, 64), (2, 128), (3, 256), (3, 512)]):
        for i in range(reps):
            x = block(x, filters, (3, 3), f"conv{b + 1}_{i + 1}")
        x = MaxPooling2D((2, 2), border_mode="same", dim_ordering="tf")(x)
    for i in range(3):
        x = block(x, 512, (3, 3), f"conv5_{i + 1}")
    return x


def _crelu_block(x, filters, name, stride=1):
    """PVANet's C.ReLU: conv (no activation) -> concat(x, -x) -> ReLU,
    half the conv cost of a plain conv+relu at equal output width."""
    c = Convolution2D(filters, (3, 3), subsample=stride, border_mode="same",
                      dim_ordering="tf", name=f"{name}_conv")(x)
    neg = apply_layer(Lambda(lambda t: -t,
                             output_shape_fn=lambda s: s,
                             name=unique_name(f"{name}_neg")), c)
    cat = Merge(mode="concat", concat_axis=-1, name=f"{name}_cat")([c, neg])
    return Activation("relu")(cat)


def _inception_block(x, ch1, ch3, ch5, name):
    """PVANet's lightweight Inception: 1x1 | 1x1->3x3 | 1x1->3x3->3x3."""

    def conv(t, f, k, nm):
        c = Convolution2D(f, k, border_mode="same", dim_ordering="tf",
                          name=nm)(t)
        return Activation("relu")(c)

    b1 = conv(x, ch1, (1, 1), f"{name}_1x1")
    b3 = conv(conv(x, ch3 // 2, (1, 1), f"{name}_3r"), ch3, (3, 3),
              f"{name}_3x3")
    b5 = conv(conv(conv(x, ch5 // 2, (1, 1), f"{name}_5r"), ch5, (3, 3),
                   f"{name}_5a"), ch5, (3, 3), f"{name}_5b")
    return Merge(mode="concat", concat_axis=-1, name=f"{name}_cat")(
        [b1, b3, b5])


def _pvanet_feat(inp: Variable) -> Variable:
    """PVANet-style backbone at stride 16: C.ReLU early stages, Inception
    middle stages, and the HyperNet multi-scale feature (downscaled conv3
    || conv4 || upscaled conv5 -> 1x1)."""
    x = _crelu_block(inp, 16, "pva1", stride=2)              # /2
    x = MaxPooling2D((2, 2), border_mode="same", dim_ordering="tf")(x)  # /4
    for i in range(2):
        x = _crelu_block(x, 32, f"pva2_{i}")
    conv3 = _crelu_block(x, 48, "pva3_0", stride=2)          # /8
    conv3 = _crelu_block(conv3, 48, "pva3_1")
    x = MaxPooling2D((2, 2), border_mode="same",
                     dim_ordering="tf")(conv3)               # /16
    conv4 = x
    for i in range(2):
        conv4 = _inception_block(conv4, 48, 64, 24, f"pva4_{i}")
    conv5 = MaxPooling2D((2, 2), border_mode="same",
                         dim_ordering="tf")(conv4)           # /32
    for i in range(2):
        conv5 = _inception_block(conv5, 48, 64, 24, f"pva5_{i}")
    # HyperNet fusion at /16
    down3 = MaxPooling2D((2, 2), border_mode="same",
                         dim_ordering="tf")(conv3)
    up5 = UpSampling2D(size=(2, 2), dim_ordering="tf")(conv5)
    hyper = Merge(mode="concat", concat_axis=-1, name="pva_hyper")(
        [down3, conv4, up5])
    fused = Convolution2D(512, (1, 1), dim_ordering="tf",
                          name="pva_fuse")(hyper)
    return Activation("relu")(fused)


def _build_frcnn(backbone, num_classes: int, cfg: FrcnnConfig,
                 name: str) -> Model:
    """The whole Faster-RCNN graph over any stride-16, 512-channel
    backbone. Output: packed (B, N, C + 4C + 5) per RoI, [class softmax
    (C) | box deltas (4C) | roi x1, y1, x2, y2, score] with N =
    post_nms_top_n; decode with :func:`frcnn_postprocess`."""
    if cfg.img_size % cfg.stride != 0:
        raise ValueError("img_size must be a multiple of the stride (16)")
    C, N, r = num_classes, cfg.post_nms_top_n, cfg.roi_size
    A = cfg.num_anchors

    inp = Input(shape=(cfg.img_size, cfg.img_size, 3), name="image")
    feat = backbone(inp)

    # RPN
    rpn = Activation("relu")(Convolution2D(
        512, (3, 3), border_mode="same", dim_ordering="tf",
        name="rpn_conv")(feat))
    rpn_obj = Convolution2D(A, (1, 1), activation="sigmoid",
                            dim_ordering="tf", name="rpn_cls")(rpn)
    rpn_box = Convolution2D(4 * A, (1, 1), dim_ordering="tf",
                            name="rpn_bbox")(rpn)

    rois = apply_layer(Lambda(
        _proposals(cfg), arity=2,
        output_shape_fn=lambda s: (None, N, 5),
        name=unique_name("proposal")), [rpn_obj, rpn_box])

    pooled = apply_layer(Lambda(
        _roi_align(cfg), arity=2,
        output_shape_fn=lambda s: (None, N, r, r, 512),
        name=unique_name("roi_align")), [feat, rois])

    flat = apply_layer(Lambda(
        lambda t: t.reshape((-1, r * r * 512)),
        output_shape_fn=lambda s: (None, r * r * 512),
        name=unique_name("roi_flatten")), pooled)
    h = Dense(cfg.fc_dim, activation="relu", name="fc6")(flat)
    h = Dense(cfg.fc_dim, activation="relu", name="fc7")(h)
    cls = Dense(C, activation="softmax", name="cls_score")(h)
    box = Dense(4 * C, name="bbox_pred")(h)

    def pack(cls_f, box_f, rois_b):
        b, dt = rois_b.shape[0], rois_b.dtype
        return torch.cat([cls_f.reshape((b, N, C)).to(dt),
                          box_f.reshape((b, N, 4 * C)).to(dt), rois_b],
                         dim=-1)

    out = apply_layer(Lambda(
        pack, arity=3,
        output_shape_fn=lambda s: (None, N, C + 4 * C + 5),
        name=unique_name("frcnn_pack")), [cls, box, rois])

    model = Model(inp, out, name=name)
    model.compute_dtype = "bfloat16"
    model.frcnn_config = cfg
    model.frcnn_num_classes = C
    return model


def _resolve_cfg(config, img_size):
    cfg = config or FrcnnConfig()
    if img_size is not None:
        cfg = replace(cfg, img_size=img_size)
    return cfg


def frcnn_vgg16(num_classes: int = 21, config: FrcnnConfig = None,
                img_size: int = None) -> Model:
    """Faster-RCNN over the VGG16 conv5 backbone (frcnn-vgg16 catalog)."""
    cfg = _resolve_cfg(config, img_size)
    return _build_frcnn(_vgg_conv5, num_classes, cfg, "frcnn_vgg16")


def frcnn_pvanet(num_classes: int = 21, config: FrcnnConfig = None,
                 img_size: int = None) -> Model:
    """Faster-RCNN over the PVANet backbone (frcnn-pvanet catalog): C.ReLU
    + Inception + HyperNet fusion."""
    cfg = _resolve_cfg(config, img_size)
    if cfg.img_size % 32 != 0:
        # the HyperNet fusion pools to /32 and upsamples back: a /16-only
        # size would reach the concat with mismatched spatial dims
        raise ValueError("frcnn-pvanet needs img_size % 32 == 0 "
                         f"(got {cfg.img_size})")
    return _build_frcnn(_pvanet_feat, num_classes, cfg, "frcnn_pvanet")


def frcnn_postprocess(cfg: FrcnnConfig, num_classes: int,
                      score_threshold: float = 0.01,
                      iou_threshold: float = 0.45,
                      max_per_class: int = 100, max_total: int = 200):
    """A torch function (B, N, C+4C+5) -> (boxes, scores, classes int32,
    valid), the SSD post-process's contract (normalized corner boxes).
    Unlike SSD (one shared box per prior), Faster-RCNN regresses a box per
    class, so each (image, class) pair runs NMS on its class's own decoded
    boxes, all pairs in one batched loop."""
    C = num_classes

    def post(packed):
        packed = packed.float()
        b, n = packed.shape[0], packed.shape[1]
        cls = packed[..., :C]
        deltas = packed[..., C:C + 4 * C].reshape(b, n, C, 4)
        rois = packed[..., 4 * C + C:4 * C + C + 4]
        roi_score = packed[..., -1]
        # kill padded rois (score 0) before NMS
        scores = torch.where(roi_score[..., None] > 0, cls, 0.0)
        fg_deltas = deltas[:, :, 1:, :].transpose(1, 2)     # (B, C-1, N, 4)
        boxes = clip_boxes(decode_boxes(rois[:, None], fg_deltas, _UNIT_VAR))
        sc = scores[..., 1:].transpose(1, 2)                # (B, C-1, N)
        idx, valid = nms(boxes, sc, max_per_class, iou_threshold,
                         score_threshold)
        slot_boxes = torch.gather(boxes, -2,
                                  idx[..., None].expand(idx.shape + (4,)))
        return top_detections(torch.gather(sc, -1, idx), slot_boxes, valid,
                              max_total)

    return post
