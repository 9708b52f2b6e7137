"""SSD detection graphs (port of
``analytics_zoo_tpu.models.image.objectdetection.ssd``; ref
models/image/objectdetection/ssd/SSDGraph.scala and the SSDVGG /
SSDMobileNet variants).

The whole detector is one functional Keras graph: backbone, extra feature
layers and every multibox head; the per-map loc and conf tensors are
reshaped and concatenated inside the graph, so the model emits one
``(B, P, 4 + num_classes)`` tensor (loc || conf logits). Priors are a
numpy constant made when the model is built (``priorbox.py``).

NHWC layout ("tf" ordering), bfloat16 compute (``compute_dtype``); the
L2Norm on conv4_3 keeps the reference's learned-scale normalisation
(init 20). Layer names are the JAX graph's, so ``interop.load_jax_params``
carries a JAX tree over leaf by leaf.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.autograd.variable import Variable
from analytics_zoo_tpu_torch.keras.engine.base import KerasLayer, Shape
from analytics_zoo_tpu_torch.keras.engine.topology import Input, Model
from analytics_zoo_tpu_torch.keras.layers import (
    Activation,
    AtrousConvolution2D,
    BatchNormalization,
    Convolution2D,
    MaxPooling2D,
    Merge,
    Reshape,
    SeparableConvolution2D,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.priorbox import (
    PriorBoxSpec,
    generate_priors,
)


class L2Norm2D(KerasLayer):
    """Channel-wise L2 normalisation with a learned per-channel scale
    ``gamma`` (init 20).

    Ref: the NormalizeScale layer applied to VGG conv4_3 in SSDVGG;
    conv4_3 activations are much larger than deeper maps, so they are
    rescaled before the head. The sum of squares runs in float32 with
    1e-10 inside the square root, and the norm is cast to x's dtype before
    the division, as in the JAX package.
    """

    def __init__(self, scale_init: float = 20.0, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.scale_init = float(scale_init)

    def build(self, input_shape: Shape) -> None:
        def init(generator, shape, dtype=torch.float32):
            return torch.full(shape, self.scale_init, dtype=dtype)

        self.add_weight("gamma", (input_shape[-1],), init=init)

    def call(self, params, x, **kw):
        norm = torch.sqrt(torch.sum(torch.square(x.float()), dim=-1,
                                    keepdim=True) + 1e-10)
        return (x / norm.to(x.dtype)) * params["gamma"].to(x.dtype)


@dataclass
class SSDConfig:
    """Static shape/prior description of one SSD variant."""

    name: str
    img_size: int
    num_classes: int               # INCLUDING background class 0
    specs: Tuple[PriorBoxSpec, ...]

    @property
    def num_priors(self) -> int:
        """Total anchor count across every feature-map scale."""
        return sum(s.feature_size ** 2 * s.boxes_per_cell() for s in self.specs)

    def priors(self) -> np.ndarray:
        """The concatenated (P, 4) corner prior boxes of every scale."""
        return generate_priors(self.specs, self.img_size)


def _head(x: Variable, spec: PriorBoxSpec, num_classes: int,
          name: str) -> Tuple[Variable, Variable]:
    """Multibox head: 3x3 loc + conf convs, flattened to (B, P_i, ·)."""
    k = spec.boxes_per_cell()
    f = spec.feature_size
    loc = Convolution2D(k * 4, (3, 3), border_mode="same", dim_ordering="tf",
                        name=f"{name}_loc")(x)
    conf = Convolution2D(k * num_classes, (3, 3), border_mode="same",
                         dim_ordering="tf", name=f"{name}_conf")(x)
    loc = Reshape((f * f * k, 4), name=f"{name}_loc_flat")(loc)
    conf = Reshape((f * f * k, num_classes), name=f"{name}_conf_flat")(conf)
    return loc, conf


def _assemble(inp: Variable, sources: Sequence[Variable], cfg: SSDConfig,
              name: str) -> Model:
    """Attach heads to source maps and concat into (B, P, 4 + C)."""
    locs, confs = [], []
    for i, (src, spec) in enumerate(zip(sources, cfg.specs)):
        loc, conf = _head(src, spec, cfg.num_classes, f"head{i}")
        locs.append(loc)
        confs.append(conf)
    loc_all = Merge(mode="concat", concat_axis=1, name="loc_concat")(locs) \
        if len(locs) > 1 else locs[0]
    conf_all = Merge(mode="concat", concat_axis=1, name="conf_concat")(confs) \
        if len(confs) > 1 else confs[0]
    out = Merge(mode="concat", concat_axis=-1, name="detections")(
        [loc_all, conf_all])
    model = Model(inp, out, name=name)
    model.compute_dtype = "bfloat16"
    model.ssd_config = cfg
    return model


def _conv_block(x, filters, kernel, name, stride=1, padding="same",
                dilation=1):
    if dilation != 1:
        conv = AtrousConvolution2D(filters, kernel[0], kernel[1],
                                   atrous_rate=(dilation, dilation),
                                   border_mode=padding, dim_ordering="tf",
                                   name=name)
    else:
        conv = Convolution2D(filters, kernel, subsample=stride,
                             border_mode=padding, dim_ordering="tf", name=name)
    return Activation("relu")(conv(x))


def _vgg_base(inp: Variable) -> Tuple[Variable, Variable]:
    """VGG16 through conv4_3 and fc7 (fc6/fc7 as atrous/1x1 convs)."""
    x = inp
    for b, (reps, filters) in enumerate([(2, 64), (2, 128), (3, 256)]):
        for i in range(reps):
            x = _conv_block(x, filters, (3, 3), f"conv{b + 1}_{i + 1}")
        # ceil-mode pooling (SAME; 75 -> 38 pads one side with -inf) keeps
        # 300 -> 150 -> 75 -> 38
        x = MaxPooling2D((2, 2), border_mode="same", dim_ordering="tf")(x)
    for i in range(3):
        x = _conv_block(x, 512, (3, 3), f"conv4_{i + 1}")
    conv4_3 = x
    x = MaxPooling2D((2, 2), border_mode="same", dim_ordering="tf")(x)
    for i in range(3):
        x = _conv_block(x, 512, (3, 3), f"conv5_{i + 1}")
    x = MaxPooling2D((3, 3), strides=(1, 1), border_mode="same",
                     dim_ordering="tf")(x)
    x = _conv_block(x, 1024, (3, 3), "fc6", dilation=6)   # atrous fc6
    fc7 = _conv_block(x, 1024, (1, 1), "fc7")
    return conv4_3, fc7


def _extra(x: Variable, mid: int, out: int, name: str, stride: int = 2,
           padding: str = "same") -> Variable:
    x = _conv_block(x, mid, (1, 1), f"{name}_1")
    return _conv_block(x, out, (3, 3), f"{name}_2", stride=stride,
                       padding=padding)


SSD_VGG16_300 = SSDConfig(
    "ssd-vgg16-300x300", 300, 21, (
        PriorBoxSpec(38, 8, 30, 60, (2.0,)),
        PriorBoxSpec(19, 16, 60, 111, (2.0, 3.0)),
        PriorBoxSpec(10, 32, 111, 162, (2.0, 3.0)),
        PriorBoxSpec(5, 64, 162, 213, (2.0, 3.0)),
        PriorBoxSpec(3, 100, 213, 264, (2.0,)),
        PriorBoxSpec(1, 300, 264, 315, (2.0,)),
    ))

SSD_VGG16_512 = SSDConfig(
    "ssd-vgg16-512x512", 512, 21, (
        PriorBoxSpec(64, 8, 35.84, 76.8, (2.0,)),
        PriorBoxSpec(32, 16, 76.8, 153.6, (2.0, 3.0)),
        PriorBoxSpec(16, 32, 153.6, 230.4, (2.0, 3.0)),
        PriorBoxSpec(8, 64, 230.4, 307.2, (2.0, 3.0)),
        PriorBoxSpec(4, 128, 307.2, 384.0, (2.0, 3.0)),
        PriorBoxSpec(2, 256, 384.0, 460.8, (2.0,)),
        PriorBoxSpec(1, 512, 460.8, 537.6, (2.0,)),
    ))

SSD_MOBILENET_300 = SSDConfig(
    "ssd-mobilenet-300x300", 300, 21, (
        PriorBoxSpec(19, 16, 60, 105, (2.0, 3.0)),
        PriorBoxSpec(10, 32, 105, 150, (2.0, 3.0)),
        PriorBoxSpec(5, 64, 150, 195, (2.0, 3.0)),
        PriorBoxSpec(3, 100, 195, 240, (2.0, 3.0)),
        PriorBoxSpec(2, 150, 240, 285, (2.0, 3.0)),
        PriorBoxSpec(1, 300, 285, 330, (2.0, 3.0)),
    ))


SSD_TINY_64 = SSDConfig(
    "ssd-tiny-64x64", 64, 21, (
        PriorBoxSpec(8, 8, 12, 28, (2.0,)),
        PriorBoxSpec(4, 16, 28, 48, (2.0,)),
    ))


def ssd_tiny(num_classes: int = 21) -> Model:
    """Tiny 64x64 two-map SSD through the same graph/head/prior machinery
    as the full variants (the CI-speed detector; not in the reference
    catalog, everything it exercises is)."""
    cfg = SSDConfig(SSD_TINY_64.name, 64, num_classes, SSD_TINY_64.specs)
    inp = Input(shape=(64, 64, 3), name="image")
    x = _conv_block(inp, 16, (3, 3), "tiny1", stride=2)    # 32
    x = _conv_block(x, 32, (3, 3), "tiny2", stride=2)      # 16
    x = _conv_block(x, 64, (3, 3), "tiny3", stride=2)      # 8
    src1 = _conv_block(x, 64, (3, 3), "tiny4")             # 8x8
    src2 = _conv_block(src1, 128, (3, 3), "tiny5", stride=2)  # 4x4
    return _assemble(inp, [src1, src2], cfg, cfg.name)


def ssd_vgg16_300(num_classes: int = 21) -> Model:
    """SSD300-VGG16 (ref SSDVGG, 300x300 variant)."""
    cfg = SSDConfig(SSD_VGG16_300.name, 300, num_classes, SSD_VGG16_300.specs)
    inp = Input(shape=(300, 300, 3), name="image")
    conv4_3, fc7 = _vgg_base(inp)
    src1 = L2Norm2D(name="conv4_3_norm")(conv4_3)          # 38x38
    c6 = _extra(fc7, 256, 512, "conv6")                    # 10x10
    c7 = _extra(c6, 128, 256, "conv7")                     # 5x5
    c8 = _extra(c7, 128, 256, "conv8", stride=1, padding="valid")  # 3x3
    c9 = _extra(c8, 128, 256, "conv9", stride=1, padding="valid")  # 1x1
    return _assemble(inp, [src1, fc7, c6, c7, c8, c9], cfg, cfg.name)


def ssd_vgg16_512(num_classes: int = 21) -> Model:
    """SSD512-VGG16 (ref SSDVGG 512 variant)."""
    cfg = SSDConfig(SSD_VGG16_512.name, 512, num_classes, SSD_VGG16_512.specs)
    inp = Input(shape=(512, 512, 3), name="image")
    conv4_3, fc7 = _vgg_base(inp)                          # 64x64, 32x32
    src1 = L2Norm2D(name="conv4_3_norm")(conv4_3)
    c6 = _extra(fc7, 256, 512, "conv6")                    # 16
    c7 = _extra(c6, 128, 256, "conv7")                     # 8
    c8 = _extra(c7, 128, 256, "conv8")                     # 4
    c9 = _extra(c8, 128, 256, "conv9")                     # 2
    c10 = _extra(c9, 128, 256, "conv10")                   # 1
    return _assemble(inp, [src1, fc7, c6, c7, c8, c9, c10], cfg, cfg.name)


def ssd_mobilenet_300(num_classes: int = 21, alpha: float = 1.0) -> Model:
    """SSD300-MobileNetV1 (ref SSDMobileNet)."""
    cfg = SSDConfig(SSD_MOBILENET_300.name, 300, num_classes,
                    SSD_MOBILENET_300.specs)

    def dw(x, filters, stride, name):
        x = SeparableConvolution2D(int(filters * alpha), 3, 3,
                                   subsample=(stride, stride),
                                   border_mode="same", dim_ordering="tf",
                                   bias=False, name=name)(x)
        x = BatchNormalization(dim_ordering="tf")(x)
        return Activation("relu")(x)

    inp = Input(shape=(300, 300, 3), name="image")
    x = Convolution2D(int(32 * alpha), (3, 3), subsample=2,
                      border_mode="same", dim_ordering="tf", bias=False,
                      name="stem")(inp)
    x = BatchNormalization(dim_ordering="tf")(x)
    x = Activation("relu")(x)
    plan = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2)] \
        + [(512, 1)] * 5
    for i, (f, s) in enumerate(plan):
        x = dw(x, f, s, f"dw{i}")
    conv11 = x                                             # 19x19
    x = dw(x, 1024, 2, "dw12")
    conv13 = dw(x, 1024, 1, "dw13")                        # 10x10
    c6 = _extra(conv13, 256, 512, "conv14")                # 5
    c7 = _extra(c6, 128, 256, "conv15")                    # 3
    c8 = _extra(c7, 128, 256, "conv16")                    # 2
    c9 = _extra(c8, 64, 128, "conv17")                     # 1
    return _assemble(inp, [conv11, conv13, c6, c7, c8, c9], cfg, cfg.name)
