"""Image classifiers (port of
``analytics_zoo_tpu.models.image.imageclassification``: ``resnet_50`` and
``lenet``, with the same layers and layer names).

NHWC ("tf" ordering) throughout; ResNet-50 is a functional ``Model`` with
bf16 compute and float32 master weights, LeNet-5 a ``Sequential``. The
``ImageClassifier`` wrapper and the rest of the catalog are not ported
yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

from analytics_zoo_tpu_torch.autograd.variable import Variable
from analytics_zoo_tpu_torch.keras.engine.topology import (
    Input,
    Model,
    Sequential,
)
from analytics_zoo_tpu_torch.keras.layers import (
    Activation,
    BatchNormalization,
    Convolution2D,
    Dense,
    Flatten,
    GlobalAveragePooling2D,
    MaxPooling2D,
    Merge,
)


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
