"""Keras-2-style layers (port of ``analytics_zoo_tpu.keras2.layers``):
Keras-2 argument names (``units``, ``filters``, ``kernel_size``,
``strides``, ``padding``, ``data_format``, ``kernel_initializer``,
``bias_initializer``, ``kernel_regularizer``, ``use_bias``, ``rate``)
over the Keras-1 layers, the merge layers ``Maximum``, ``Minimum``,
``Average``, ``Add``, ``Multiply`` and ``Concatenate`` and their
functions. Keras-2's channels-last default holds for ``Conv2D``, the 2-D
pools and the global pools. Initializer names pass to the Keras-1 table
(``keras.engine.base``), but for the two Keras-2 names that differ
(``random_uniform``, ``random_normal``).
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.keras import layers as k1
from analytics_zoo_tpu_torch.keras.layers.convolutional import _ConvND

__all__ = [
    "Activation", "Dense", "Dropout", "Flatten", "Softmax", "Reshape",
    "Conv1D", "Conv2D", "Cropping1D", "LocallyConnected1D",
    "MaxPooling1D", "AveragePooling1D", "MaxPooling2D", "AveragePooling2D",
    "GlobalMaxPooling1D", "GlobalMaxPooling2D", "GlobalMaxPooling3D",
    "GlobalAveragePooling1D", "GlobalAveragePooling2D", "GlobalAveragePooling3D",
    "Maximum", "Minimum", "Average", "Add", "Multiply", "Concatenate",
    "maximum", "minimum", "average", "add", "multiply", "concatenate",
]

# the Keras-2 initializer names that differ from the Keras-1 ones
_INIT_MAP = {"random_uniform": "uniform", "random_normal": "normal"}


def _init(spec):
    if callable(spec) or spec is None:
        return spec
    return _INIT_MAP.get(spec, spec)


class Dense(k1.Dense):
    """Keras-2 ``Dense``."""

    def __init__(self, units, activation=None, use_bias=True,
                 kernel_initializer="glorot_uniform", bias_initializer="zeros",
                 kernel_regularizer=None, bias_regularizer=None,
                 input_shape=None, name=None, **kw):
        super().__init__(units, init=_init(kernel_initializer),
                         activation=activation, W_regularizer=kernel_regularizer,
                         b_regularizer=bias_regularizer, bias=use_bias,
                         input_shape=input_shape, name=name, **kw)
        self.bias_init = _init(bias_initializer)


class Activation(k1.Activation):
    pass


class Softmax(k1.Activation):
    """Softmax over the last axis as a layer."""

    def __init__(self, input_shape=None, name=None):
        super().__init__("softmax", input_shape=input_shape, name=name)


class Dropout(k1.Dropout):
    def __init__(self, rate, input_shape=None, name=None, **kw):
        super().__init__(rate, input_shape=input_shape, name=name)


class Flatten(k1.Flatten):
    pass


class Reshape(k1.Reshape):
    def __init__(self, target_shape, input_shape=None, name=None):
        super().__init__(target_shape, input_shape=input_shape, name=name)


class Conv1D(k1.Convolution1D):
    """Keras-2 ``Conv1D``: channels-last."""

    def __init__(self, filters, kernel_size, strides=1, padding="valid",
                 activation=None, use_bias=True, dilation_rate=1,
                 kernel_initializer="glorot_uniform", bias_initializer="zeros",
                 kernel_regularizer=None, bias_regularizer=None,
                 input_shape=None, name=None):
        super().__init__(filters, kernel_size, subsample_length=strides,
                         activation=activation, border_mode=padding,
                         init=_init(kernel_initializer), dilation=dilation_rate,
                         bias=use_bias, W_regularizer=kernel_regularizer,
                         b_regularizer=bias_regularizer,
                         input_shape=input_shape, name=name)


class Conv2D(_ConvND):
    """Keras-2 ``Conv2D``: NHWC by default (``data_format=
    'channels_last'``), kernel (kh, kw, cin, cout)."""

    rank = 2

    def __init__(self, filters, kernel_size, strides=1, padding="valid",
                 data_format="channels_last", dilation_rate=1, activation=None,
                 use_bias=True, kernel_initializer="glorot_uniform",
                 bias_initializer="zeros", kernel_regularizer=None,
                 bias_regularizer=None, input_shape=None, name=None):
        ordering = "tf" if data_format == "channels_last" else "th"
        super().__init__(filters, kernel_size, subsample=strides,
                         activation=activation, border_mode=padding,
                         dim_ordering=ordering, init=_init(kernel_initializer),
                         dilation=dilation_rate, bias=use_bias,
                         W_regularizer=kernel_regularizer,
                         b_regularizer=bias_regularizer,
                         input_shape=input_shape, name=name)


class Cropping1D(k1.Cropping1D):
    def __init__(self, cropping=(1, 1), input_shape=None, name=None):
        super().__init__(cropping, input_shape=input_shape, name=name)


class LocallyConnected1D(k1.LocallyConnected1D):
    def __init__(self, filters, kernel_size, strides=1, padding="valid",
                 activation=None, use_bias=True, input_shape=None, name=None):
        if padding != "valid":
            raise ValueError("LocallyConnected1D only supports padding='valid'")
        super().__init__(filters, kernel_size, activation=activation,
                         subsample_length=strides, bias=use_bias,
                         input_shape=input_shape, name=name)


def _pool1d(base):
    class _P(base):
        def __init__(self, pool_size=2, strides=None, padding="valid",
                     input_shape=None, name=None):
            super().__init__(pool_size, strides, border_mode=padding,
                             input_shape=input_shape, name=name)

    _P.__name__ = base.__name__
    return _P


def _pool2d(base):
    class _P(base):
        def __init__(self, pool_size=(2, 2), strides=None, padding="valid",
                     data_format="channels_last", input_shape=None, name=None):
            ordering = "th" if data_format == "channels_first" else "tf"
            super().__init__(pool_size, strides, border_mode=padding,
                             dim_ordering=ordering, input_shape=input_shape,
                             name=name)

    _P.__name__ = base.__name__
    return _P


MaxPooling1D = _pool1d(k1.MaxPooling1D)
AveragePooling1D = _pool1d(k1.AveragePooling1D)
MaxPooling2D = _pool2d(k1.MaxPooling2D)
AveragePooling2D = _pool2d(k1.AveragePooling2D)


def _global_pool(base):
    class _G(base):
        # Keras-2's default is channels_last, unlike the Keras-1 bases'
        # "th"; None (the backend default) is channels_last too
        def __init__(self, data_format="channels_last", input_shape=None,
                     name=None):
            ordering = "th" if data_format == "channels_first" else "tf"
            super().__init__(dim_ordering=ordering, input_shape=input_shape,
                             name=name)

    _G.__name__ = base.__name__
    return _G


GlobalMaxPooling1D = _global_pool(k1.GlobalMaxPooling1D)
GlobalAveragePooling1D = _global_pool(k1.GlobalAveragePooling1D)
GlobalMaxPooling2D = _global_pool(k1.GlobalMaxPooling2D)
GlobalAveragePooling2D = _global_pool(k1.GlobalAveragePooling2D)
GlobalMaxPooling3D = _global_pool(k1.GlobalMaxPooling3D)
GlobalAveragePooling3D = _global_pool(k1.GlobalAveragePooling3D)


class _MergeN(k1.Merge):
    """Keras-2 n-ary merge layers: a ``Merge`` of mode ``MODE``."""

    MODE = "sum"

    def __init__(self, input_shape=None, name=None):
        super().__init__(mode=self.MODE, input_shape=input_shape, name=name)


class Maximum(_MergeN):
    MODE = "max"


class Minimum(_MergeN):
    MODE = "min"


class Average(_MergeN):
    MODE = "ave"


class Add(_MergeN):
    MODE = "sum"


class Multiply(_MergeN):
    MODE = "mul"


class Concatenate(k1.Merge):
    def __init__(self, axis=-1, input_shape=None, name=None):
        super().__init__(mode="concat", concat_axis=axis,
                         input_shape=input_shape, name=name)


def maximum(inputs, **kwargs):
    """keras2 functional merge: elementwise maximum of a tensor list."""
    return Maximum(**kwargs)(inputs)


def minimum(inputs, **kwargs):
    """keras2 functional merge: elementwise minimum of a tensor list."""
    return Minimum(**kwargs)(inputs)


def average(inputs, **kwargs):
    """keras2 functional merge: elementwise mean of a tensor list."""
    return Average(**kwargs)(inputs)


def add(inputs, **kwargs):
    """keras2 functional merge: elementwise sum of a tensor list."""
    return Add(**kwargs)(inputs)


def multiply(inputs, **kwargs):
    """keras2 functional merge: elementwise product of a tensor
    list."""
    return Multiply(**kwargs)(inputs)


def concatenate(inputs, axis=-1, **kwargs):
    """keras2 functional merge: concatenation along ``axis``."""
    return Concatenate(axis=axis, **kwargs)(inputs)
