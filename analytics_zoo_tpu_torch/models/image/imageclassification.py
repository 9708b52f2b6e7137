"""Image-classification model catalog (port of
``analytics_zoo_tpu.models.image.imageclassification``): every catalog
architecture (lenet, alexnet, vgg-16/19, resnet-50, inception-v1/v3,
densenet-161, squeezenet, mobilenet-v1/v2, and their ``-quantize`` names),
``build_model``, ``load_pretrained_weights``, ``LabelOutput``,
``imagenet_preprocess`` and the ``ImageClassifier`` zoo model, with the
same layers, layer names and parameter trees as the JAX package.

NHWC ("tf" ordering) throughout. The functional graphs (ResNet-50, the
Inceptions, DenseNet-161, SqueezeNet, the MobileNets) compute in bf16
over float32 master weights; LeNet-5, AlexNet and the VGGs are
``Sequential`` stacks in float32, as in the JAX package. Convolutions,
pooling and matmuls run on PyTorch's cuDNN/cuBLAS calls (the depthwise
convolution as a ``groups=C`` convolution); no architecture here reaches
a hand-written kernel.

``load_pretrained_weights`` pours a Keras ``.h5`` weight file by layer
name (``Net.load_keras``). Left out, raising ``NotImplementedError``:
``ImageClassifier.from_pretrained`` with a Keras file, which needs the Keras
architecture converter (ROADMAP A6, TensorFlow importers). A ``-quantize``
name builds
the float graph; it serves int8 through ``InferenceModel.do_quantize``, as
in the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.autograd.variable import Variable
from analytics_zoo_tpu_torch.keras.engine.topology import (
    Input,
    Model,
    Sequential,
)
from analytics_zoo_tpu_torch.keras.layers import (
    Activation,
    AveragePooling2D,
    BatchNormalization,
    Convolution2D,
    Dense,
    DepthwiseConvolution2D,
    Dropout,
    Flatten,
    GlobalAveragePooling2D,
    MaxPooling2D,
    Merge,
    SeparableConvolution2D,
)
from analytics_zoo_tpu_torch.models.common import ZooModel


def _conv_bn(x: Variable, filters: int, kernel, stride=1, padding="same",
             activation: Optional[str] = "relu", name=None,
             momentum: float = 0.99) -> Variable:
    """Convolution (no bias), batch norm and an optional activation.
    ``momentum`` is the Keras-1 moving-average retain factor."""
    x = Convolution2D(filters, kernel, subsample=stride, border_mode=padding,
                      dim_ordering="tf", bias=False,
                      name=None if name is None else f"{name}_conv")(x)
    x = BatchNormalization(dim_ordering="tf", momentum=momentum,
                           name=None if name is None else f"{name}_bn")(x)
    if activation:
        x = Activation(activation)(x)
    return x


def _bottleneck(x: Variable, filters: int, stride: int, downsample: bool,
                name: str, momentum: float = 0.99) -> Variable:
    """1x1 (strided) -> 3x3 -> 1x1 x4, plus the shortcut (a strided 1x1
    projection when ``downsample``), then ReLU."""
    shortcut = x
    if downsample:
        shortcut = _conv_bn(x, filters * 4, (1, 1), stride=stride,
                            activation=None, name=f"{name}_proj",
                            momentum=momentum)
    y = _conv_bn(x, filters, (1, 1), stride=stride, name=f"{name}_a",
                 momentum=momentum)
    y = _conv_bn(y, filters, (3, 3), name=f"{name}_b", momentum=momentum)
    y = _conv_bn(y, filters * 4, (1, 1), activation=None, name=f"{name}_c",
                 momentum=momentum)
    out = Merge(mode="sum", name=f"{name}_add")([y, shortcut])
    return Activation("relu")(out)


def resnet_50(num_classes: int = 1000,
              input_shape: Tuple[int, int, int] = (224, 224, 3),
              include_top: bool = True,
              classifier_activation: Optional[str] = "softmax",
              bn_momentum: Optional[float] = None) -> Model:
    """ResNet-50 as the JAX package builds it: a 7x7/2 stem, a 3x3/2 max
    pool, stages of 3, 4, 6 and 3 bottlenecks (the stride in each stage's
    first 1x1), global average pooling and ``fc1000``.

    ``classifier_activation=None`` leaves the head as raw logits, for the
    from-logits losses; ``bn_momentum`` overrides the moving-average retain
    factor (0.99)."""
    bn_momentum = 0.99 if bn_momentum is None else float(bn_momentum)
    inp = Input(shape=input_shape, name="image")
    x = _conv_bn(inp, 64, (7, 7), stride=2, name="stem",
                 momentum=bn_momentum)
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same",
                     dim_ordering="tf")(x)
    blocks = [(64, 3), (128, 4), (256, 6), (512, 3)]
    for stage, (filters, reps) in enumerate(blocks):
        for i in range(reps):
            stride = 2 if (stage > 0 and i == 0) else 1
            x = _bottleneck(x, filters, stride=stride, downsample=(i == 0),
                            name=f"res{stage + 2}{chr(ord('a') + i)}",
                            momentum=bn_momentum)
    x = GlobalAveragePooling2D(dim_ordering="tf")(x)
    if include_top:
        x = Dense(num_classes, activation=classifier_activation,
                  name="fc1000")(x)
    model = Model(inp, x, name="resnet50")
    model.compute_dtype = "bfloat16"
    return model


def lenet(num_classes: int = 10, input_shape=(28, 28, 1)) -> Sequential:
    """LeNet-5: two tanh convolutions with max pooling, then three dense
    layers."""
    m = Sequential(name="lenet")
    m.add(Convolution2D(6, (5, 5), activation="tanh", border_mode="same",
                        dim_ordering="tf", input_shape=input_shape))
    m.add(MaxPooling2D((2, 2), dim_ordering="tf"))
    m.add(Convolution2D(16, (5, 5), activation="tanh", dim_ordering="tf"))
    m.add(MaxPooling2D((2, 2), dim_ordering="tf"))
    m.add(Flatten())
    m.add(Dense(120, activation="tanh"))
    m.add(Dense(84, activation="tanh"))
    m.add(Dense(num_classes, activation="softmax"))
    return m


# ---------------------------------------------------------------------------
# AlexNet / VGG / MobileNet-v1
# ---------------------------------------------------------------------------


def alexnet(num_classes: int = 1000, input_shape=(227, 227, 3)) -> Sequential:
    """AlexNet (catalog name "alexnet")."""
    m = Sequential(name="alexnet")
    m.add(Convolution2D(96, (11, 11), subsample=4, activation="relu",
                        dim_ordering="tf", input_shape=input_shape))
    m.add(MaxPooling2D((3, 3), strides=(2, 2), dim_ordering="tf"))
    m.add(Convolution2D(256, (5, 5), activation="relu", border_mode="same",
                        dim_ordering="tf"))
    m.add(MaxPooling2D((3, 3), strides=(2, 2), dim_ordering="tf"))
    for filters in (384, 384, 256):
        m.add(Convolution2D(filters, (3, 3), activation="relu",
                            border_mode="same", dim_ordering="tf"))
    m.add(MaxPooling2D((3, 3), strides=(2, 2), dim_ordering="tf"))
    _classifier_head(m, num_classes)
    return m


def _classifier_head(m: Sequential, num_classes: int) -> None:
    """Flatten, two 4096-wide ReLU layers each followed by Dropout(0.5),
    and the softmax classifier (AlexNet's and the VGGs' head)."""
    m.add(Flatten())
    for _ in range(2):
        m.add(Dense(4096, activation="relu"))
        m.add(Dropout(0.5))
    m.add(Dense(num_classes, activation="softmax"))


def _vgg(cfg, num_classes, input_shape, name) -> Sequential:
    m = Sequential(name=name)
    first = True
    for convs in cfg:
        for filters in convs:
            kw = dict(border_mode="same", activation="relu",
                      dim_ordering="tf")
            if first:
                kw["input_shape"] = input_shape
                first = False
            m.add(Convolution2D(filters, (3, 3), **kw))
        m.add(MaxPooling2D((2, 2), dim_ordering="tf"))
    _classifier_head(m, num_classes)
    return m


def vgg16(num_classes=1000, input_shape=(224, 224, 3)) -> Sequential:
    """VGG-16 (catalog name "vgg-16")."""
    return _vgg([[64, 64], [128, 128], [256, 256, 256],
                 [512, 512, 512], [512, 512, 512]], num_classes,
                input_shape, "vgg16")


def vgg19(num_classes=1000, input_shape=(224, 224, 3)) -> Sequential:
    """VGG-19 (catalog name "vgg-19")."""
    return _vgg([[64, 64], [128, 128], [256, 256, 256, 256],
                 [512, 512, 512, 512], [512, 512, 512, 512]],
                num_classes, input_shape, "vgg19")


def mobilenet_v1(num_classes=1000, input_shape=(224, 224, 3),
                 alpha=1.0) -> Model:
    """MobileNet-v1 (catalog name "mobilenet-v1"): a 3x3/2 stem and 13
    depthwise-separable blocks, each followed by an unnamed batch norm
    and ReLU, with width multiplier ``alpha``."""

    def dw_block(x, filters, stride, name):
        x = SeparableConvolution2D(int(filters * alpha), 3, 3,
                                   subsample=(stride, stride),
                                   border_mode="same", dim_ordering="tf",
                                   bias=False, name=f"{name}_sep")(x)
        x = BatchNormalization(dim_ordering="tf")(x)
        return Activation("relu")(x)

    inp = Input(shape=input_shape, name="image")
    x = _conv_bn(inp, int(32 * alpha), (3, 3), stride=2, name="stem")
    cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2)] \
        + [(512, 1)] * 5 + [(1024, 2), (1024, 1)]
    for i, (f, s) in enumerate(cfg):
        x = dw_block(x, f, s, f"dw{i}")
    x = GlobalAveragePooling2D(dim_ordering="tf")(x)
    x = Dense(num_classes, activation="softmax")(x)
    model = Model(inp, x, name="mobilenet_v1")
    model.compute_dtype = "bfloat16"
    return model


# ---------------------------------------------------------------------------
# Inception-v1 / v3
# ---------------------------------------------------------------------------


def _inception_v1_block(x: Variable, n1x1, n3x3r, n3x3, n5x5r, n5x5,
                        pool_proj, name: str,
                        momentum: float = 0.99) -> Variable:
    """Four branches concatenated on channels: 1x1; 1x1 -> 3x3; 1x1 ->
    5x5; a 3x3/1 SAME max pool -> 1x1."""
    b1 = _conv_bn(x, n1x1, (1, 1), name=f"{name}_1x1", momentum=momentum)
    b2 = _conv_bn(x, n3x3r, (1, 1), name=f"{name}_3x3r", momentum=momentum)
    b2 = _conv_bn(b2, n3x3, (3, 3), name=f"{name}_3x3", momentum=momentum)
    b3 = _conv_bn(x, n5x5r, (1, 1), name=f"{name}_5x5r", momentum=momentum)
    b3 = _conv_bn(b3, n5x5, (5, 5), name=f"{name}_5x5", momentum=momentum)
    b4 = MaxPooling2D((3, 3), strides=(1, 1), border_mode="same",
                      dim_ordering="tf")(x)
    b4 = _conv_bn(b4, pool_proj, (1, 1), name=f"{name}_pool",
                  momentum=momentum)
    return Merge(mode="concat", concat_axis=-1,
                 name=f"{name}_out")([b1, b2, b3, b4])


def inception_v1(num_classes: int = 1000,
                 input_shape: Tuple[int, int, int] = (224, 224, 3),
                 bn_momentum: Optional[float] = None) -> Model:
    """GoogLeNet / Inception-v1 (catalog name "inception-v1") in its
    batch-norm form, without the auxiliary classifiers: a 7x7/2 stem,
    nine inception blocks, global average pooling, Dropout(0.4) and the
    ``logits`` classifier. ``bn_momentum`` overrides the moving-average
    retain factor (0.99); short recipes use 0.9 so that eval-mode
    statistics leave their initial values."""
    m = 0.99 if bn_momentum is None else float(bn_momentum)

    def pool(v):
        return MaxPooling2D((3, 3), strides=(2, 2), border_mode="same",
                            dim_ordering="tf")(v)

    inp = Input(shape=input_shape, name="image")
    x = _conv_bn(inp, 64, (7, 7), stride=2, name="conv1", momentum=m)
    x = pool(x)
    x = _conv_bn(x, 64, (1, 1), name="conv2r", momentum=m)
    x = _conv_bn(x, 192, (3, 3), name="conv2", momentum=m)
    x = pool(x)
    x = _inception_v1_block(x, 64, 96, 128, 16, 32, 32, "mixed3a", m)
    x = _inception_v1_block(x, 128, 128, 192, 32, 96, 64, "mixed3b", m)
    x = pool(x)
    x = _inception_v1_block(x, 192, 96, 208, 16, 48, 64, "mixed4a", m)
    x = _inception_v1_block(x, 160, 112, 224, 24, 64, 64, "mixed4b", m)
    x = _inception_v1_block(x, 128, 128, 256, 24, 64, 64, "mixed4c", m)
    x = _inception_v1_block(x, 112, 144, 288, 32, 64, 64, "mixed4d", m)
    x = _inception_v1_block(x, 256, 160, 320, 32, 128, 128, "mixed4e", m)
    x = pool(x)
    x = _inception_v1_block(x, 256, 160, 320, 32, 128, 128, "mixed5a", m)
    x = _inception_v1_block(x, 384, 192, 384, 48, 128, 128, "mixed5b", m)
    x = GlobalAveragePooling2D(dim_ordering="tf")(x)
    x = Dropout(0.4)(x)
    x = Dense(num_classes, activation="softmax", name="logits")(x)
    model = Model(inp, x, name="inception_v1")
    model.compute_dtype = "bfloat16"
    return model


def _avg_pool_same(x):
    """The 3x3/1 SAME average pool of the Inception-v3 blocks (each
    window divided by its count of real elements)."""
    return AveragePooling2D((3, 3), strides=(1, 1), border_mode="same",
                            dim_ordering="tf")(x)


def _concat(xs):
    return Merge(mode="concat", concat_axis=-1)(xs)


def _inc3_a(x, pool_filters, name):
    b1 = _conv_bn(x, 64, (1, 1), name=f"{name}_1x1")
    b2 = _conv_bn(x, 48, (1, 1), name=f"{name}_5x5r")
    b2 = _conv_bn(b2, 64, (5, 5), name=f"{name}_5x5")
    b3 = _conv_bn(x, 64, (1, 1), name=f"{name}_dbl_r")
    b3 = _conv_bn(b3, 96, (3, 3), name=f"{name}_dbl_1")
    b3 = _conv_bn(b3, 96, (3, 3), name=f"{name}_dbl_2")
    b4 = _conv_bn(_avg_pool_same(x), pool_filters, (1, 1),
                  name=f"{name}_pool")
    return _concat([b1, b2, b3, b4])


def _inc3_b(x, name):
    """Grid reduction 35 -> 17."""
    b1 = _conv_bn(x, 384, (3, 3), stride=2, padding="valid",
                  name=f"{name}_3x3")
    b2 = _conv_bn(x, 64, (1, 1), name=f"{name}_dbl_r")
    b2 = _conv_bn(b2, 96, (3, 3), name=f"{name}_dbl_1")
    b2 = _conv_bn(b2, 96, (3, 3), stride=2, padding="valid",
                  name=f"{name}_dbl_2")
    b3 = MaxPooling2D((3, 3), strides=(2, 2), dim_ordering="tf")(x)
    return _concat([b1, b2, b3])


def _inc3_c(x, c7, name):
    """The factorized 7x7 (1x7 and 7x1) block."""
    b1 = _conv_bn(x, 192, (1, 1), name=f"{name}_1x1")
    b2 = _conv_bn(x, c7, (1, 1), name=f"{name}_7x7r")
    b2 = _conv_bn(b2, c7, (1, 7), name=f"{name}_7x7_1")
    b2 = _conv_bn(b2, 192, (7, 1), name=f"{name}_7x7_2")
    b3 = _conv_bn(x, c7, (1, 1), name=f"{name}_dbl_r")
    b3 = _conv_bn(b3, c7, (7, 1), name=f"{name}_dbl_1")
    b3 = _conv_bn(b3, c7, (1, 7), name=f"{name}_dbl_2")
    b3 = _conv_bn(b3, c7, (7, 1), name=f"{name}_dbl_3")
    b3 = _conv_bn(b3, 192, (1, 7), name=f"{name}_dbl_4")
    b4 = _conv_bn(_avg_pool_same(x), 192, (1, 1), name=f"{name}_pool")
    return _concat([b1, b2, b3, b4])


def _inc3_d(x, name):
    """Grid reduction 17 -> 8."""
    b1 = _conv_bn(x, 192, (1, 1), name=f"{name}_3x3r")
    b1 = _conv_bn(b1, 320, (3, 3), stride=2, padding="valid",
                  name=f"{name}_3x3")
    b2 = _conv_bn(x, 192, (1, 1), name=f"{name}_7x7r")
    b2 = _conv_bn(b2, 192, (1, 7), name=f"{name}_7x7_1")
    b2 = _conv_bn(b2, 192, (7, 1), name=f"{name}_7x7_2")
    b2 = _conv_bn(b2, 192, (3, 3), stride=2, padding="valid",
                  name=f"{name}_7x7_3")
    b3 = MaxPooling2D((3, 3), strides=(2, 2), dim_ordering="tf")(x)
    return _concat([b1, b2, b3])


def _inc3_e(x, name):
    """The expanded filter-bank output block."""
    b1 = _conv_bn(x, 320, (1, 1), name=f"{name}_1x1")
    b2 = _conv_bn(x, 384, (1, 1), name=f"{name}_3x3r")
    b2 = _concat([_conv_bn(b2, 384, (1, 3), name=f"{name}_3x3a"),
                  _conv_bn(b2, 384, (3, 1), name=f"{name}_3x3b")])
    b3 = _conv_bn(x, 448, (1, 1), name=f"{name}_dbl_r")
    b3 = _conv_bn(b3, 384, (3, 3), name=f"{name}_dbl_1")
    b3 = _concat([_conv_bn(b3, 384, (1, 3), name=f"{name}_dbl_a"),
                  _conv_bn(b3, 384, (3, 1), name=f"{name}_dbl_b")])
    b4 = _conv_bn(_avg_pool_same(x), 192, (1, 1), name=f"{name}_pool")
    return _concat([b1, b2, b3, b4])


def inception_v3(num_classes: int = 1000,
                 input_shape: Tuple[int, int, int] = (299, 299, 3)) -> Model:
    """Inception-v3 (catalog name "inception-v3")."""
    inp = Input(shape=input_shape, name="image")
    x = _conv_bn(inp, 32, (3, 3), stride=2, padding="valid", name="conv1a")
    x = _conv_bn(x, 32, (3, 3), padding="valid", name="conv2a")
    x = _conv_bn(x, 64, (3, 3), name="conv2b")
    x = MaxPooling2D((3, 3), strides=(2, 2), dim_ordering="tf")(x)
    x = _conv_bn(x, 80, (1, 1), padding="valid", name="conv3b")
    x = _conv_bn(x, 192, (3, 3), padding="valid", name="conv4a")
    x = MaxPooling2D((3, 3), strides=(2, 2), dim_ordering="tf")(x)
    x = _inc3_a(x, 32, "mixed0")
    x = _inc3_a(x, 64, "mixed1")
    x = _inc3_a(x, 64, "mixed2")
    x = _inc3_b(x, "mixed3")
    for i, c7 in enumerate((128, 160, 160, 192)):
        x = _inc3_c(x, c7, f"mixed{4 + i}")
    x = _inc3_d(x, "mixed8")
    x = _inc3_e(x, "mixed9")
    x = _inc3_e(x, "mixed10")
    x = GlobalAveragePooling2D(dim_ordering="tf")(x)
    x = Dropout(0.5)(x)
    x = Dense(num_classes, activation="softmax", name="logits")(x)
    model = Model(inp, x, name="inception_v3")
    model.compute_dtype = "bfloat16"
    return model


# ---------------------------------------------------------------------------
# DenseNet-161 / SqueezeNet / MobileNet-v2
# ---------------------------------------------------------------------------


def densenet_161(num_classes: int = 1000,
                 input_shape: Tuple[int, int, int] = (224, 224, 3),
                 growth_rate: int = 48) -> Model:
    """DenseNet-161 (catalog name "densenet-161"): blocks of 6, 12, 36 and
    24 pre-activation (BN-ReLU-Conv) layers, growth 48, a 96-channel
    stem, halving transitions with a 2x2 average pool."""

    def dense_layer(x, name):
        y = BatchNormalization(dim_ordering="tf", name=f"{name}_bn1")(x)
        y = Activation("relu")(y)
        y = Convolution2D(4 * growth_rate, (1, 1), dim_ordering="tf",
                          bias=False, name=f"{name}_conv1")(y)
        y = BatchNormalization(dim_ordering="tf", name=f"{name}_bn2")(y)
        y = Activation("relu")(y)
        y = Convolution2D(growth_rate, (3, 3), border_mode="same",
                          dim_ordering="tf", bias=False,
                          name=f"{name}_conv2")(y)
        return _concat([x, y])

    def transition(x, out_ch, name):
        x = BatchNormalization(dim_ordering="tf", name=f"{name}_bn")(x)
        x = Activation("relu")(x)
        x = Convolution2D(out_ch, (1, 1), dim_ordering="tf", bias=False,
                          name=f"{name}_conv")(x)
        return AveragePooling2D((2, 2), dim_ordering="tf")(x)

    inp = Input(shape=input_shape, name="image")
    x = Convolution2D(96, (7, 7), subsample=2, border_mode="same",
                      dim_ordering="tf", bias=False, name="stem_conv")(inp)
    x = BatchNormalization(dim_ordering="tf", name="stem_bn")(x)
    x = Activation("relu")(x)
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same",
                     dim_ordering="tf")(x)
    channels = 96
    for bi, reps in enumerate((6, 12, 36, 24)):
        for li in range(reps):
            x = dense_layer(x, f"dense{bi + 1}_{li + 1}")
            channels += growth_rate
        if bi < 3:
            channels //= 2
            x = transition(x, channels, f"trans{bi + 1}")
    x = BatchNormalization(dim_ordering="tf", name="final_bn")(x)
    x = Activation("relu")(x)
    x = GlobalAveragePooling2D(dim_ordering="tf")(x)
    x = Dense(num_classes, activation="softmax", name="logits")(x)
    model = Model(inp, x, name="densenet_161")
    model.compute_dtype = "bfloat16"
    return model


def squeezenet(num_classes: int = 1000,
               input_shape: Tuple[int, int, int] = (227, 227, 3)) -> Model:
    """SqueezeNet v1.1 (catalog name "squeezenet")."""

    def fire(x, squeeze, expand, name):
        s = Convolution2D(squeeze, (1, 1), activation="relu",
                          dim_ordering="tf", name=f"{name}_squeeze")(x)
        e1 = Convolution2D(expand, (1, 1), activation="relu",
                           dim_ordering="tf", name=f"{name}_e1x1")(s)
        e3 = Convolution2D(expand, (3, 3), activation="relu",
                           border_mode="same", dim_ordering="tf",
                           name=f"{name}_e3x3")(s)
        return _concat([e1, e3])

    def pool(v):
        return MaxPooling2D((3, 3), strides=(2, 2), dim_ordering="tf")(v)

    inp = Input(shape=input_shape, name="image")
    x = Convolution2D(64, (3, 3), subsample=2, activation="relu",
                      dim_ordering="tf", name="conv1")(inp)
    x = pool(x)
    x = fire(x, 16, 64, "fire2")
    x = fire(x, 16, 64, "fire3")
    x = pool(x)
    x = fire(x, 32, 128, "fire4")
    x = fire(x, 32, 128, "fire5")
    x = pool(x)
    x = fire(x, 48, 192, "fire6")
    x = fire(x, 48, 192, "fire7")
    x = fire(x, 64, 256, "fire8")
    x = fire(x, 64, 256, "fire9")
    x = Dropout(0.5)(x)
    x = Convolution2D(num_classes, (1, 1), activation="relu",
                      dim_ordering="tf", name="conv10")(x)
    x = GlobalAveragePooling2D(dim_ordering="tf")(x)
    x = Activation("softmax")(x)
    model = Model(inp, x, name="squeezenet")
    model.compute_dtype = "bfloat16"
    return model


def mobilenet_v2(num_classes=1000, input_shape=(224, 224, 3),
                 alpha: float = 1.0) -> Model:
    """MobileNet-v2 (catalog name "mobilenet-v2"): inverted residuals
    (1x1 expand, 3x3 depthwise, 1x1 linear projection, each with batch
    norm; ReLU6 after the first two) with width multiplier ``alpha``."""

    def _ch(v):
        v = v * alpha
        new_v = max(8, (int(v) + 4) // 8 * 8)
        if new_v < 0.9 * v:  # make_divisible: never round down by >10%
            new_v += 8
        return new_v

    def inverted_residual(x, in_ch, out_ch, stride, expand, name):
        y = x
        if expand != 1:
            y = Convolution2D(in_ch * expand, (1, 1), dim_ordering="tf",
                              bias=False, name=f"{name}_expand")(y)
            y = BatchNormalization(dim_ordering="tf",
                                   name=f"{name}_expand_bn")(y)
            y = Activation("relu6")(y)
        y = DepthwiseConvolution2D(3, subsample=(stride, stride),
                                   border_mode="same", dim_ordering="tf",
                                   bias=False, name=f"{name}_dw")(y)
        y = BatchNormalization(dim_ordering="tf", name=f"{name}_dw_bn")(y)
        y = Activation("relu6")(y)
        y = Convolution2D(out_ch, (1, 1), dim_ordering="tf", bias=False,
                          name=f"{name}_project")(y)
        y = BatchNormalization(dim_ordering="tf",
                               name=f"{name}_project_bn")(y)
        if stride == 1 and in_ch == out_ch:
            y = Merge(mode="sum")([x, y])
        return y

    inp = Input(shape=input_shape, name="image")
    x = Convolution2D(_ch(32), (3, 3), subsample=2, border_mode="same",
                      dim_ordering="tf", bias=False, name="stem")(inp)
    x = BatchNormalization(dim_ordering="tf", name="stem_bn")(x)
    x = Activation("relu6")(x)
    cfg = [  # (expand, out, reps, first_stride)
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    in_ch = _ch(32)
    for bi, (t, c, n, s) in enumerate(cfg):
        for i in range(n):
            out_ch = _ch(c)
            x = inverted_residual(x, in_ch, out_ch, s if i == 0 else 1, t,
                                  f"block{bi}_{i}")
            in_ch = out_ch
    last = _ch(1280) if alpha > 1.0 else 1280
    x = Convolution2D(last, (1, 1), dim_ordering="tf", bias=False,
                      name="head_conv")(x)
    x = BatchNormalization(dim_ordering="tf", name="head_bn")(x)
    x = Activation("relu6")(x)
    x = GlobalAveragePooling2D(dim_ordering="tf")(x)
    x = Dense(num_classes, activation="softmax", name="logits")(x)
    model = Model(inp, x, name="mobilenet_v2")
    model.compute_dtype = "bfloat16"
    return model


_CATALOG = {
    "lenet": lenet,
    "alexnet": alexnet,
    "vgg-16": vgg16,
    "vgg-19": vgg19,
    "resnet-50": resnet_50,
    "inception-v1": inception_v1,
    "inception-v3": inception_v3,
    "densenet-161": densenet_161,
    "squeezenet": squeezenet,
    "mobilenet-v1": mobilenet_v1,
    "mobilenet-v2": mobilenet_v2,
}

# "<arch>-quantize" names (ref ImageClassificationConfig.scala:33-52): the
# same float graph; int8 weights are applied at serving time by
# InferenceModel.do_quantize.
QUANTIZED_SUFFIX = "-quantize"


def build_model(name: str, num_classes: int = 1000, **kw):
    """The catalog architecture ``name`` (ref
    ImageClassificationConfig.scala:57); a "<arch>-quantize" name builds
    the same graph as "<arch>", served int8 through
    ``InferenceModel.do_quantize``."""
    key = name.lower()
    if key.endswith(QUANTIZED_SUFFIX):
        key = key[: -len(QUANTIZED_SUFFIX)]
    if key not in _CATALOG:
        raise ValueError(
            f"Unknown model '{name}'. Catalog: {sorted(_CATALOG)}")
    return _CATALOG[key](num_classes=num_classes, **kw)


def _no_keras_h5(what: str):
    raise NotImplementedError(
        f"{what}: a Keras model file needs the Keras architecture converter "
        "(keras_convert.py, or tf.keras.applications), which waits for "
        "ROADMAP A6, TensorFlow importers; pass a save_weights checkpoint "
        "(directory, .npz or prefix)")


def load_pretrained_weights(model, path: str):
    """Load local pretrained weights into a catalog model from the
    framework's own format: the atomic checkpoint directory
    ``save_weights`` writes, a legacy ``.npz`` file, or the prefix
    ``save_weights`` was called with (leaves matched by name, counter
    names by order, so weights the JAX package wrote load too); returns
    the names of the layers that carry weights. Or a Keras HDF5 weight
    file (classic or ``.weights.h5``), poured by layer name through
    ``Net.load_keras`` (unmatched layers skipped, so partial backbones
    pour too); returns the imported layer names."""
    if path.endswith((".h5", ".hdf5")):
        from analytics_zoo_tpu_torch.net import Net

        return Net.load_keras(path, model, by_name=True, strict=False)
    base = path[:-4] if path.endswith(".npz") else path
    if (os.path.isdir(base) or os.path.exists(path)
            or os.path.exists(path + ".npz")):
        model.load_weights(path)
        return [l.name for l in model.layers() if l.weight_specs]
    raise ValueError(
        f"unrecognized weights path '{path}' (expected a save_weights "
        "checkpoint [directory, .npz, or its prefix] or a Keras .h5 file)")


class LabelOutput:
    """Class probabilities to top-N (label, confidence) lists (ref
    LabelOutput.scala)."""

    def __init__(self, label_map=None, top_k: int = 1):
        self.label_map = label_map
        self.top_k = top_k

    def __call__(self, probs):
        probs = np.asarray(probs)
        idx = np.argsort(-probs, axis=-1)[:, :self.top_k]
        return [[(self.label_map[int(i)] if self.label_map else int(i),
                  float(probs[r, i])) for i in ids]
                for r, ids in enumerate(idx)]


# catalog name -> the keras imagenet_utils preprocessing its published
# ImageNet weights were trained with: "caffe" = RGB->BGR + mean
# subtraction, "tf" = scale to [-1, 1] ("torch" = /255 + ImageNet mean/std
# is the third mode imagenet_preprocess knows)
_PREPROCESS = {
    "resnet-50": "caffe",
    "vgg-16": "caffe",
    "vgg-19": "caffe",
    "inception-v3": "tf",
    "mobilenet-v1": "tf",
    "mobilenet-v2": "tf",
}


def imagenet_preprocess(images, mode: Optional[str]):
    """The keras imagenet_utils preprocessing that published weights
    expect; ``images`` an RGB HWC float or uint8 batch."""
    x = np.asarray(images, np.float32)
    if mode is None:
        return x
    if mode == "tf":
        return x / 127.5 - 1.0
    if mode == "torch":
        x = x / 255.0
        return (x - np.array([0.485, 0.456, 0.406], np.float32)) / \
            np.array([0.229, 0.224, 0.225], np.float32)
    if mode == "caffe":
        return x[..., ::-1] - np.array([103.939, 116.779, 123.68],
                                       np.float32)
    raise ValueError(f"unknown preprocess mode {mode!r}")


class ImageClassifier(ZooModel):
    """A catalog architecture as a zoo model (ref
    models/image/imageclassification/ImageClassifier.scala): ``predict``
    returns class probabilities, ``predict_labels`` top-k (class name,
    confidence) lists through the bundled ImageNet label map. ``weights``:
    an optional local weights path (see :func:`load_pretrained_weights`).
    ``save_model``/``ZooModel.load_model`` round-trip it."""

    def __init__(self, model_name: str = "resnet-50",
                 num_classes: int = 1000, weights: str = None, **build_kw):
        super().__init__()
        self.model_name = model_name
        self.num_classes = num_classes
        self._build_kw = build_kw
        self.preprocess_mode = None
        self.model = self.build_model()
        if weights:
            load_pretrained_weights(self.model, weights)

    @classmethod
    def from_pretrained(cls, model_name: str, weights: str,
                        input_shape=None) -> "ImageClassifier":
        """``model_name`` with pretrained ImageNet weights from a local
        framework checkpoint (1000 classes), preprocessing as the
        published weights expect. A Keras ``.h5``/``.keras`` file raises
        ``NotImplementedError`` (ROADMAP A6, TensorFlow importers: the
        architecture comes from the Keras converter)."""
        if weights.endswith((".h5", ".hdf5", ".keras")):
            _no_keras_h5("ImageClassifier.from_pretrained")
        key = model_name.lower()
        self = cls.__new__(cls)
        ZooModel.__init__(self)
        self.model_name = key
        self.num_classes = 1000
        self._build_kw = {}
        self.preprocess_mode = _PREPROCESS.get(key)
        self.model = build_model(key)
        load_pretrained_weights(self.model, weights)
        return self

    def predict_labels(self, images, top_k: int = 5, batch_size: int = 32,
                       label_map=None):
        """Images (RGB, HWC, the architecture's input size) to top-k
        (class name, confidence) per image, through the bundled ImageNet
        label map and the preprocessing of the weights."""
        from analytics_zoo_tpu_torch.models.image.labels import LabelReader

        x = imagenet_preprocess(images, self.preprocess_mode)
        probs = np.asarray(self.model.predict(x, batch_size=batch_size))
        if label_map is None:
            label_map = LabelReader.read_imagenet(self.model_name)
        return self.label_output(probs, label_map, top_k)

    def build_model(self):
        return build_model(self.model_name, num_classes=self.num_classes,
                           **self._build_kw)

    def config(self):
        return {"model_name": self.model_name,
                "num_classes": self.num_classes, **self._build_kw}

    def label_output(self, probs, label_map=None, top_k: int = 1):
        """Probabilities to (label, confidence) lists (ref LabelOutput)."""
        return LabelOutput(label_map, top_k)(probs)
