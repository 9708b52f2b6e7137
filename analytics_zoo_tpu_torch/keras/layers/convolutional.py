"""Convolution and pooling layers (port of
``analytics_zoo_tpu.keras.layers.convolutional``: ``Convolution1D``,
``Convolution2D`` and ``Convolution3D`` (aliases ``Conv1D``/``Conv2D``/
``Conv3D``), ``AtrousConvolution2D`` (dilated), ``Deconvolution2D``,
``SeparableConvolution2D`` and ``DepthwiseConvolution2D``, 1-D, 2-D and
3-D max and average pooling, global pooling (``GlobalAveragePooling1D``
with its masked mean over the valid steps of an ``[x, mask]`` pair),
``ZeroPadding1D``/``2D``/``3D``, ``Cropping1D``/``2D``,
``UpSampling1D``/``2D``/``3D`` and ``LocallyConnected1D``).

Operands of two float dtypes are promoted to one before a convolution,
as ``jnp.matmul`` promotes (``core.promoted``; ``lax.conv_general_dilated``
itself raises on them): under bf16 compute a float32 activation (a
recurrent layer's float32 carry, ``ConvLSTM2D``'s output) meets a bf16
kernel in float32.

``Deconvolution2D`` stores its kernel as the JAX package does, (kh, kw,
out, in), and is ``lax.conv_transpose(..., transpose_kernel=True)``
there: the gradient of the VALID convolution whose HWIO kernel that is.
``F.conv_transpose2d`` is the gradient of ``F.conv2d`` with weight
(in, out, kh, kw), so the kernel goes to it permuted (3, 2, 0, 1), with
no flip of its own; the output is (h - 1) * stride + k.

1-D layers take (batch, steps, dim) ("tf", the default of the 1-D layers
as in the JAX package) or (batch, dim, steps) ("th"); they run as
``F.conv1d``/``F.max_pool1d`` on the channels-first view, with the kernel
leaf in the JAX package's (k, in, out) shape.

Both orderings: "th" is NCHW, "tf" is NHWC. On the card a "tf" tensor
stays NHWC and contiguous between layers; for a convolution or a pooling it
is viewed as NCHW by ``permute(0, 3, 1, 2)``, which is a channels-last NCHW
tensor without a copy, so cuDNN runs its NHWC kernels and the output
permutes back to a contiguous NHWC tensor, again without a copy. The kernel
leaf keeps the JAX package's HWIO shape (the weight map stays 1:1) and is
laid out as OIHW inside ``call``, channels-last where the activations are.
On the CPU a "tf" convolution runs on contiguous NCHW copies instead:
PyTorch's CPU convolution with a channels-last input or weight returns a
wrong weight gradient for a strided 1x1 kernel (torch 2.13, oneDNN; the
gradient is off by units and memory is corrupted), which
``tests/test_torch_conv_layers.py`` would catch.

"same" follows XLA's SAME padding: the total padding of a spatial dim is
``max((out - 1) * stride + k_eff - in, 0)`` with ``out = ceil(in /
stride)``, and the low side gets ``total // 2``. Where the two sides differ
(a 7x7/2 convolution or a 3x3/2 pooling on an even size) the input is
padded explicitly: PyTorch's symmetric ``padding=`` would give the same
output shape with windows shifted by one. Max pooling pads with -inf;
average pooling divides each window by its count of real elements.

The depthwise convolution keeps the JAX package's weight layout too:
``depthwise`` is (kh, kw, 1, C*m) for C input channels and depth
multiplier m, ``pointwise`` (1, 1, C*m, F). XLA's ``feature_group_count=C``
gives output channel ``o`` the group ``o // m``, and so does PyTorch's
``groups=C`` convolution over the weight permuted to (C*m, 1, kh, kw).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.keras.engine.base import (
    KerasLayer,
    Shape,
    mask_pair_main_shape,
)
from analytics_zoo_tpu_torch.keras.layers.core import get_activation, promoted

# kernel dims may arrive as numpy ints (computed from array shapes/configs)
_Int = (int, np.integer)


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) != n:
            raise ValueError(f"expected length-{n}, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _conv_out_dim(size, k, stride, border_mode, dilation=1):
    if size is None:
        return None
    eff_k = (k - 1) * dilation + 1
    if border_mode == "same":
        return -(-size // stride)
    return -(-(size - eff_k + 1) // stride)


def _same_pads(sizes, kernel, strides, dilation) -> List[Tuple[int, int]]:
    """XLA's SAME padding, (low, high) per spatial dim."""
    pads = []
    for size, k, s, d in zip(sizes, kernel, strides, dilation):
        out = -(-size // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _spatial(x, ordering: str):
    return tuple(x.shape[2:] if ordering == "th" else x.shape[1:-1])


def _pad(x, pads, ordering: str, value: float = 0.0):
    """Pad the spatial dims of ``x`` by ``pads`` ((low, high) per dim, in
    order) in its own layout."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if ordering == "tf":
        flat = [0, 0] + flat  # the channel dim is last
    return F.pad(x, flat, value=value)


def _as_nchw(x, ordering: str):
    """Channels-first view of ``x`` (NCHW, or NCW for a 1-D tensor)."""
    if ordering == "th":
        return x
    return x.movedim(-1, 1)


def _conv_input(x, ordering: str):
    """``x`` as the NCHW (NCDHW) input of a convolution, and the memory
    format its weight takes: channels-last on the card for a "tf" 2-D
    input, contiguous channels-first otherwise (see the module docstring
    for the CPU)."""
    if ordering == "th":
        return x, torch.contiguous_format
    if x.is_cuda and x.dim() == 4:
        return x.permute(0, 3, 1, 2), torch.channels_last
    return x.movedim(-1, 1).contiguous(), torch.contiguous_format


def _from_nchw(y, ordering: str):
    if ordering == "th":
        return y
    return y.movedim(1, -1)


def _conv_weight(kernel, fmt):
    """A (spatial..., in, out) kernel as the (out, in, spatial...) weight
    of ``F.conv1d``/``2d``/``3d`` in memory format ``fmt``."""
    r = kernel.dim() - 2
    w = kernel.permute(r + 1, r, *range(r))
    return w.contiguous(memory_format=fmt) if r == 2 else w


def _padding(x, border_mode, kernel, strides, dilation, ordering,
             value=0.0):
    """``(x, padding)`` for a 1-D or 2-D op: a symmetric padding goes to
    the op as ``padding``; an asymmetric one is applied to ``x`` here."""
    zero = (0,) * len(kernel)
    if border_mode != "same":
        return x, zero
    pads = _same_pads(_spatial(x, ordering), kernel, strides, dilation)
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads)
    return _pad(x, pads, ordering, value), zero


class _ConvND(KerasLayer):
    rank = 2

    def __init__(self, nb_filter: int, kernel_size, subsample=1,
                 activation=None, border_mode="valid", dim_ordering="th",
                 init="glorot_uniform", dilation=1, bias=True,
                 W_regularizer=None, b_regularizer=None, input_shape=None,
                 name=None):
        super().__init__(input_shape, name)
        self.nb_filter = int(nb_filter)
        self.kernel_size = _tuple(kernel_size, self.rank)
        self.subsample = _tuple(subsample, self.rank)
        self.dilation = _tuple(dilation, self.rank)
        self.activation = get_activation(activation)
        if border_mode not in ("valid", "same"):
            raise ValueError(
                f"border_mode must be valid|same, got {border_mode}")
        self.border_mode = border_mode
        self.dim_ordering = dim_ordering
        self.init = init
        self.bias = bias
        self.W_regularizer = W_regularizer
        self.b_regularizer = b_regularizer

    def _in_channels(self, input_shape: Shape) -> int:
        return input_shape[1] if self.dim_ordering == "th" else \
            input_shape[-1]

    def build(self, input_shape: Shape):
        in_ch = self._in_channels(input_shape)
        self.add_weight("kernel", self.kernel_size + (in_ch, self.nb_filter),
                        self.init, regularizer=self.W_regularizer)
        if self.bias:
            self.add_weight("bias", (self.nb_filter,), "zeros",
                            regularizer=self.b_regularizer)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        spatial = (input_shape[2:] if self.dim_ordering == "th"
                   else input_shape[1:-1])
        out_spatial = tuple(
            _conv_out_dim(s, k, st, self.border_mode, d)
            for s, k, st, d in zip(spatial, self.kernel_size, self.subsample,
                                   self.dilation))
        if self.dim_ordering == "th":
            return (input_shape[0], self.nb_filter) + out_spatial
        return (input_shape[0],) + out_spatial + (self.nb_filter,)

    def call(self, params, x, **kw):
        x, kernel = promoted(x, params["kernel"])
        bias = params["bias"].to(x.dtype) if self.bias else None
        x, padding = _padding(x, self.border_mode, self.kernel_size,
                              self.subsample, self.dilation,
                              self.dim_ordering)
        if self.rank == 1:
            # (k, in, out) -> (out, in, k)
            y = F.conv1d(_as_nchw(x, self.dim_ordering),
                         _conv_weight(kernel, None), bias,
                         stride=self.subsample, padding=padding,
                         dilation=self.dilation)
            return self.activation(_from_nchw(y, self.dim_ordering))
        x, fmt = _conv_input(x, self.dim_ordering)
        # HWIO -> OIHW (DHWIO -> OIDHW), in the activations' memory format
        conv = F.conv2d if self.rank == 2 else F.conv3d
        y = conv(x, _conv_weight(kernel, fmt), bias, stride=self.subsample,
                 padding=padding, dilation=self.dilation)
        return self.activation(_from_nchw(y, self.dim_ordering))


class Convolution1D(_ConvND):
    """Ref Convolution1D.scala — input (batch, steps, dim), "tf"-ordered
    by default."""
    rank = 1

    def __init__(self, nb_filter, filter_length, subsample_length=1, **kw):
        kw.setdefault("dim_ordering", "tf")
        super().__init__(nb_filter, filter_length, subsample_length, **kw)


class Convolution2D(_ConvND):
    """2-D convolution. Accepts the Keras-1 signature
    ``Convolution2D(nb_filter, nb_row, nb_col, ...)`` and the tuple form
    ``Convolution2D(nb_filter, (rows, cols), ...)``; with three int
    positionals the third is ``nb_col``, never ``subsample``: pass
    ``subsample`` and every later option by keyword."""
    rank = 2

    def __init__(self, nb_filter, nb_row, nb_col=None, **kw):
        if nb_col is None:
            kernel = nb_row
        elif isinstance(nb_row, _Int) and isinstance(nb_col, _Int):
            kernel = (int(nb_row), int(nb_col))
        else:
            raise TypeError(
                "Convolution2D takes either (nb_filter, nb_row, nb_col) with "
                "int rows/cols or (nb_filter, kernel_size); pass subsample "
                f"and later options by keyword (got nb_row={nb_row!r}, "
                f"nb_col={nb_col!r})")
        super().__init__(nb_filter, kernel, **kw)


class Convolution3D(_ConvND):
    """3-D convolution over NCDHW ("th") or NDHWC ("tf") input, kernel
    leaf (kd, kh, kw, in, out). Accepts ``Convolution3D(nb_filter,
    kernel_dim1, kernel_dim2, kernel_dim3, ...)`` and the tuple form."""
    rank = 3

    def __init__(self, nb_filter, kernel_dim1, kernel_dim2=None,
                 kernel_dim3=None, **kw):
        dims = (kernel_dim2, kernel_dim3)
        if all(d is None for d in dims):
            kernel = kernel_dim1
        elif all(isinstance(d, _Int) for d in (kernel_dim1, *dims)):
            kernel = (int(kernel_dim1), int(kernel_dim2), int(kernel_dim3))
        else:
            raise TypeError(
                "Convolution3D takes either (nb_filter, d1, d2, d3) with int "
                "dims or (nb_filter, kernel_size); pass subsample and later "
                "options by keyword")
        super().__init__(nb_filter, kernel, **kw)


Conv1D = Convolution1D
Conv2D = Convolution2D
Conv3D = Convolution3D


class AtrousConvolution2D(Convolution2D):
    """Ref AtrousConvolution2D: a ``Convolution2D`` with dilation
    ``atrous_rate``. SAME padding counts the dilated kernel, (k - 1) * d +
    1 taps wide (``_same_pads``): SSD's fc6, 3x3 at dilation 6 on 19x19,
    pads 6 on each side."""

    def __init__(self, nb_filter, nb_row, nb_col, atrous_rate=(1, 1), **kw):
        super().__init__(nb_filter, (nb_row, nb_col), dilation=atrous_rate,
                         **kw)


class Deconvolution2D(KerasLayer):
    """Transposed convolution (VALID), kernel leaf (kh, kw, out, in): the
    gradient of the convolution whose HWIO kernel that is (see the module
    docstring); output (h - 1) * stride + k."""

    def __init__(self, nb_filter, nb_row, nb_col, subsample=(1, 1),
                 activation=None, dim_ordering="th", init="glorot_uniform",
                 bias=True, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.nb_filter = int(nb_filter)
        self.kernel_size = (int(nb_row), int(nb_col))
        self.subsample = _tuple(subsample, 2)
        self.activation = get_activation(activation)
        self.dim_ordering = dim_ordering
        self.init = init
        self.bias = bias

    def build(self, input_shape: Shape):
        in_ch = (input_shape[1] if self.dim_ordering == "th"
                 else input_shape[-1])
        self.add_weight("kernel", self.kernel_size + (self.nb_filter, in_ch),
                        self.init)
        if self.bias:
            self.add_weight("bias", (self.nb_filter,), "zeros")

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        axes = (2, 3) if self.dim_ordering == "th" else (1, 2)
        out = list(input_shape)
        for ax, s, k in zip(axes, self.subsample, self.kernel_size):
            out[ax] = None if out[ax] is None else (out[ax] - 1) * s + k
        out[1 if self.dim_ordering == "th" else 3] = self.nb_filter
        return tuple(out)

    def call(self, params, x, **kw):
        x, kernel = promoted(x, params["kernel"])
        x, _ = _conv_input(x, self.dim_ordering)
        # (kh, kw, out, in) -> (in, out, kh, kw)
        y = F.conv_transpose2d(x, kernel.permute(3, 2, 0, 1).contiguous(),
                               params["bias"].to(x.dtype) if self.bias
                               else None, stride=self.subsample)
        return self.activation(_from_nchw(y, self.dim_ordering))


def _depthwise_apply(x, kernel, bias, strides, border_mode, ordering,
                     in_ch):
    """Grouped convolution with one group per input channel: the shared
    depthwise core of SeparableConvolution2D and DepthwiseConvolution2D.
    ``kernel`` is (kh, kw, 1, in_ch * m); ``bias`` (in_ch * m,) or None."""
    k = tuple(kernel.shape[:2])
    x, padding = _padding(x, border_mode, k, strides, (1, 1), ordering)
    x, fmt = _conv_input(x, ordering)
    # (kh, kw, 1, C*m) -> (C*m, 1, kh, kw), in the activations' format
    w = kernel.permute(3, 2, 0, 1).contiguous(memory_format=fmt)
    y = F.conv2d(x, w, bias, stride=strides, padding=padding, groups=in_ch)
    return _from_nchw(y, ordering)


class _DepthwiseBase(KerasLayer):
    """What the two depthwise layers share: options, the input channels
    and the output's spatial shape."""

    def __init__(self, kernel_size, subsample, depth_multiplier, activation,
                 border_mode, dim_ordering, init, bias, input_shape, name):
        super().__init__(input_shape, name)
        self.kernel_size = _tuple(kernel_size, 2)
        self.subsample = _tuple(subsample, 2)
        self.depth_multiplier = int(depth_multiplier)
        self.activation = get_activation(activation)
        if border_mode not in ("valid", "same"):
            raise ValueError(
                f"border_mode must be valid|same, got {border_mode}")
        self.border_mode = border_mode
        self.dim_ordering = dim_ordering
        self.init = init
        self.bias = bias

    def _in_channels(self, input_shape: Shape) -> int:
        return input_shape[1] if self.dim_ordering == "th" else \
            input_shape[-1]

    def _output_shape(self, input_shape: Shape, channels: int) -> Shape:
        spatial = (input_shape[2:] if self.dim_ordering == "th"
                   else input_shape[1:-1])
        out = tuple(_conv_out_dim(s, k, st, self.border_mode)
                    for s, k, st in zip(spatial, self.kernel_size,
                                        self.subsample))
        if self.dim_ordering == "th":
            return (input_shape[0], channels) + out
        return (input_shape[0],) + out + (channels,)

    def _depthwise(self, params, x, bias=None):
        return _depthwise_apply(x, params["depthwise"], bias, self.subsample,
                                self.border_mode, self.dim_ordering,
                                self.in_ch)


class SeparableConvolution2D(_DepthwiseBase):
    """Depthwise then pointwise convolution (ref
    SeparableConvolution2D.scala): leaves ``depthwise`` (kh, kw, 1, C*m),
    ``pointwise`` (1, 1, C*m, nb_filter) and ``bias``."""

    def __init__(self, nb_filter, nb_row, nb_col, subsample=(1, 1),
                 depth_multiplier=1, activation=None, border_mode="valid",
                 dim_ordering="th", init="glorot_uniform", bias=True,
                 input_shape=None, name=None):
        super().__init__((nb_row, nb_col), subsample, depth_multiplier,
                         activation, border_mode, dim_ordering, init, bias,
                         input_shape, name)
        self.nb_filter = int(nb_filter)

    def build(self, input_shape: Shape):
        self.in_ch = self._in_channels(input_shape)
        mid = self.in_ch * self.depth_multiplier
        self.add_weight("depthwise", self.kernel_size + (1, mid), self.init)
        self.add_weight("pointwise", (1, 1, mid, self.nb_filter), self.init)
        if self.bias:
            self.add_weight("bias", (self.nb_filter,), "zeros")

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return self._output_shape(input_shape, self.nb_filter)

    def call(self, params, x, **kw):
        y, fmt = _conv_input(self._depthwise(params, x), self.dim_ordering)
        # the pointwise (1, 1, C*m, F) -> (F, C*m, 1, 1)
        w = params["pointwise"].permute(3, 2, 0, 1).contiguous(
            memory_format=fmt)
        y = F.conv2d(y, w, params["bias"] if self.bias else None)
        return self.activation(_from_nchw(y, self.dim_ordering))


class DepthwiseConvolution2D(_DepthwiseBase):
    """Depthwise-only convolution (one filter stack per input channel):
    MobileNet-v2's inverted residuals put batch norm and ReLU6 between the
    depthwise and the projecting convolution. Leaves ``depthwise`` (kh, kw,
    1, C*m) and ``bias`` (C*m,)."""

    def __init__(self, kernel_size=3, subsample=(1, 1), depth_multiplier=1,
                 activation=None, border_mode="valid", dim_ordering="th",
                 init="glorot_uniform", bias=True, input_shape=None,
                 name=None):
        super().__init__(kernel_size, subsample, depth_multiplier,
                         activation, border_mode, dim_ordering, init, bias,
                         input_shape, name)

    def build(self, input_shape: Shape):
        self.in_ch = self._in_channels(input_shape)
        self.out_ch = self.in_ch * self.depth_multiplier
        self.add_weight("depthwise", self.kernel_size + (1, self.out_ch),
                        self.init)
        if self.bias:
            self.add_weight("bias", (self.out_ch,), "zeros")

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return self._output_shape(
            input_shape, self._in_channels(input_shape)
            * self.depth_multiplier)

    def call(self, params, x, **kw):
        return self.activation(self._depthwise(
            params, x, params["bias"] if self.bias else None))


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------


class _PoolND(KerasLayer):
    rank = 2
    op = "max"

    def __init__(self, pool_size=2, strides=None, border_mode="valid",
                 dim_ordering="th", input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.pool_size = _tuple(pool_size, self.rank)
        self.strides = (_tuple(strides, self.rank) if strides is not None
                        else self.pool_size)
        self.border_mode = border_mode
        self.dim_ordering = dim_ordering

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        spatial = (input_shape[2:] if self.dim_ordering == "th"
                   else input_shape[1:-1])
        out = tuple(_conv_out_dim(s, k, st, self.border_mode)
                    for s, k, st in zip(spatial, self.pool_size,
                                        self.strides))
        if self.dim_ordering == "th":
            return tuple(input_shape[:2]) + out
        return (input_shape[0],) + out + (input_shape[-1],)

    def call(self, params, x, **kw):
        k, s, order = self.pool_size, self.strides, self.dim_ordering
        ones = (1,) * self.rank
        if self.op == "max":
            max_pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[
                self.rank - 1]
            x, padding = _padding(x, self.border_mode, k, s, ones, order,
                                  value=float("-inf"))
            return _from_nchw(max_pool(_as_nchw(x, order), k, s,
                                       padding), order)
        if self.rank == 1:
            # avg_pool1d has no divisor_override: the 2-D op over a unit
            # height
            return _from_nchw(self._avg(
                _as_nchw(x, order)[:, :, None], (1,) + k, (1,) + s,
                (1, 1))[:, :, 0], order)
        return _from_nchw(self._avg(_as_nchw(x, order), k, s, ones),
                          order)

    def _avg(self, x, k, s, ones):
        """Average pooling of an NCHW (NCDHW) tensor, SAME dividing each
        window by its count of real elements."""
        avg_pool = F.avg_pool2d if len(k) == 2 else F.avg_pool3d
        if self.border_mode != "same":
            return avg_pool(x, k, s)
        count = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                           device=x.device)
        count, c_pad = _padding(count, "same", k, s, ones, "th")
        count = avg_pool(count, k, s, c_pad, divisor_override=1)
        x, padding = _padding(x, "same", k, s, ones, "th")
        return avg_pool(x, k, s, padding, divisor_override=1) / count


class MaxPooling1D(_PoolND):
    rank = 1
    op = "max"

    def __init__(self, pool_length=2, stride=None, **kw):
        kw.setdefault("dim_ordering", "tf")
        super().__init__(pool_length, stride, **kw)


class AveragePooling1D(MaxPooling1D):
    op = "avg"


class MaxPooling2D(_PoolND):
    rank = 2
    op = "max"


class AveragePooling2D(_PoolND):
    rank = 2
    op = "avg"


class MaxPooling3D(_PoolND):
    rank = 3
    op = "max"


class AveragePooling3D(_PoolND):
    rank = 3
    op = "avg"


class _GlobalPool(KerasLayer):
    rank = 2
    op = "max"

    def __init__(self, dim_ordering="th", input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.dim_ordering = dim_ordering

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        ch = input_shape[1] if self.dim_ordering == "th" else input_shape[-1]
        return (input_shape[0], ch)

    def call(self, params, x, **kw):
        if self.dim_ordering == "th":
            dims = tuple(range(2, x.dim()))
        else:
            dims = tuple(range(1, x.dim() - 1))
        return x.amax(dim=dims) if self.op == "max" else x.mean(dim=dims)


class GlobalMaxPooling1D(_GlobalPool):
    rank = 1

    def __init__(self, **kw):
        kw.setdefault("dim_ordering", "tf")
        super().__init__(**kw)


class GlobalAveragePooling1D(GlobalMaxPooling1D):
    """The mean over the steps; with an ``[x, mask]`` input pair ((B, T)
    mask, 1 = valid) the mean over the valid steps only (tf.keras
    timestep-mask semantics)."""
    op = "avg"

    def build(self, input_shape):
        super().build(mask_pair_main_shape(input_shape))

    def compute_output_shape(self, input_shape):
        return super().compute_output_shape(
            mask_pair_main_shape(input_shape))

    def call(self, params, x, **kw):
        if isinstance(x, (list, tuple)):
            if len(x) != 2:
                raise ValueError(
                    f"GlobalAveragePooling1D takes x or [x, mask]; "
                    f"got {len(x)} inputs")
            x, mask = x
            m = mask.to(x.dtype)[:, :, None]
            return ((x * m).sum(dim=1)
                    / torch.clamp(m.sum(dim=1), min=1.0))
        return super().call(params, x, **kw)


class GlobalMaxPooling2D(_GlobalPool):
    rank = 2


class GlobalAveragePooling2D(_GlobalPool):
    op = "avg"


class GlobalMaxPooling3D(_GlobalPool):
    rank = 3


class GlobalAveragePooling3D(_GlobalPool):
    rank = 3
    op = "avg"


# ---------------------------------------------------------------------------
# Padding, cropping, upsampling
# ---------------------------------------------------------------------------


def _plus(size, n):
    return None if size is None else size + n


class ZeroPadding1D(KerasLayer):
    """Zero padding of the steps of (B, T, C): ``padding`` an int or
    (left, right)."""

    def __init__(self, padding=1, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.padding = (_tuple(padding, 2)
                        if isinstance(padding, (tuple, list))
                        else (padding, padding))

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return (input_shape[0], _plus(input_shape[1], sum(self.padding)),
                input_shape[2])

    def call(self, params, x, **kw):
        return F.pad(x, (0, 0) + tuple(self.padding))


class ZeroPadding2D(KerasLayer):
    """Zero padding of the two spatial dims: ``padding`` is an int, (rows,
    cols), (top, bottom, left, right) or ((top, bottom), (left, right))."""

    def __init__(self, padding=(1, 1), dim_ordering="th", input_shape=None,
                 name=None):
        super().__init__(input_shape, name)
        if isinstance(padding, int):
            padding = (padding, padding)
        if len(padding) == 2 and isinstance(padding[0], (tuple, list)):
            self.padding = (tuple(padding[0]), tuple(padding[1]))
        elif len(padding) == 2:
            self.padding = ((padding[0], padding[0]),
                            (padding[1], padding[1]))
        else:
            self.padding = ((padding[0], padding[1]),
                            (padding[2], padding[3]))
        self.dim_ordering = dim_ordering

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        (t, b), (l, r) = self.padding
        if self.dim_ordering == "th":
            h = None if input_shape[2] is None else input_shape[2] + t + b
            w = None if input_shape[3] is None else input_shape[3] + l + r
            return (input_shape[0], input_shape[1], h, w)
        h = None if input_shape[1] is None else input_shape[1] + t + b
        w = None if input_shape[2] is None else input_shape[2] + l + r
        return (input_shape[0], h, w, input_shape[3])

    def call(self, params, x, **kw):
        return _pad(x, self.padding, self.dim_ordering)


class UpSampling2D(KerasLayer):
    """Nearest-neighbour upsampling: each row repeated ``size[0]`` times
    and each column ``size[1]`` times (PVANet's HyperNet fusion)."""

    def __init__(self, size=(2, 2), dim_ordering="th", input_shape=None,
                 name=None):
        super().__init__(input_shape, name)
        self.size = _tuple(size, 2)
        self.dim_ordering = dim_ordering

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        axes = (2, 3) if self.dim_ordering == "th" else (1, 2)
        out = list(input_shape)
        for ax, m in zip(axes, self.size):
            out[ax] = None if out[ax] is None else out[ax] * m
        return tuple(out)

    def call(self, params, x, **kw):
        axes = (2, 3) if self.dim_ordering == "th" else (1, 2)
        for ax, m in zip(axes, self.size):
            x = torch.repeat_interleave(x, m, dim=ax)
        return x


class ZeroPadding3D(KerasLayer):
    """Zero padding of the three spatial dims, ``padding[i]`` on both
    sides of dim i."""

    def __init__(self, padding=(1, 1, 1), dim_ordering="th",
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.padding = tuple((p, p) for p in padding)
        self.dim_ordering = dim_ordering

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        axes = (2, 3, 4) if self.dim_ordering == "th" else (1, 2, 3)
        out = list(input_shape)
        for ax, (p, _) in zip(axes, self.padding):
            out[ax] = _plus(out[ax], 2 * p)
        return tuple(out)

    def call(self, params, x, **kw):
        return _pad(x, self.padding, self.dim_ordering)


class Cropping1D(KerasLayer):
    """Crop (left, right) steps of (B, T, C)."""

    def __init__(self, cropping=(1, 1), input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.cropping = tuple(cropping)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return (input_shape[0], _plus(input_shape[1], -sum(self.cropping)),
                input_shape[2])

    def call(self, params, x, **kw):
        a, b = self.cropping
        return x[:, a:x.shape[1] - b, :]


class Cropping2D(KerasLayer):
    """Crop ((top, bottom), (left, right)) of the two spatial dims."""

    def __init__(self, cropping=((0, 0), (0, 0)), dim_ordering="th",
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.cropping = tuple(tuple(c) for c in cropping)
        self.dim_ordering = dim_ordering

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        axes = (2, 3) if self.dim_ordering == "th" else (1, 2)
        out = list(input_shape)
        for ax, (lo, hi) in zip(axes, self.cropping):
            out[ax] = _plus(out[ax], -lo - hi)
        return tuple(out)

    def call(self, params, x, **kw):
        (t, b), (l, r) = self.cropping
        if self.dim_ordering == "th":
            return x[:, :, t:x.shape[2] - b, l:x.shape[3] - r]
        return x[:, t:x.shape[1] - b, l:x.shape[2] - r, :]


class UpSampling1D(KerasLayer):
    """Repeat each step of (B, T, C) ``length`` times."""

    def __init__(self, length=2, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.length = int(length)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        steps = None if input_shape[1] is None else \
            input_shape[1] * self.length
        return (input_shape[0], steps, input_shape[2])

    def call(self, params, x, **kw):
        return torch.repeat_interleave(x, self.length, dim=1)


class UpSampling3D(KerasLayer):
    """Nearest-neighbour upsampling of the three spatial dims."""

    def __init__(self, size=(2, 2, 2), dim_ordering="th", input_shape=None,
                 name=None):
        super().__init__(input_shape, name)
        self.size = _tuple(size, 3)
        self.dim_ordering = dim_ordering

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        axes = (2, 3, 4) if self.dim_ordering == "th" else (1, 2, 3)
        out = list(input_shape)
        for ax, m in zip(axes, self.size):
            out[ax] = None if out[ax] is None else out[ax] * m
        return tuple(out)

    def call(self, params, x, **kw):
        axes = (2, 3, 4) if self.dim_ordering == "th" else (1, 2, 3)
        for ax, m in zip(axes, self.size):
            x = torch.repeat_interleave(x, m, dim=ax)
        return x


class LocallyConnected1D(KerasLayer):
    """A 1-D convolution with a kernel per output step (unshared): leaves
    ``kernel`` (out_steps, filter_length * dim, nb_filter) over the
    flattened (filter_length, dim) window and ``bias`` (out_steps,
    nb_filter); VALID, stride ``subsample_length``."""

    def __init__(self, nb_filter, filter_length, activation=None,
                 subsample_length=1, bias=True, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.nb_filter = int(nb_filter)
        self.filter_length = int(filter_length)
        self.subsample = int(subsample_length)
        self.activation = get_activation(activation)
        self.bias = bias

    def build(self, input_shape: Shape):
        steps, dim = input_shape[1], input_shape[2]
        self.out_steps = (steps - self.filter_length) // self.subsample + 1
        self.add_weight("kernel", (self.out_steps,
                                   self.filter_length * dim, self.nb_filter),
                        "glorot_uniform")
        if self.bias:
            self.add_weight("bias", (self.out_steps, self.nb_filter),
                            "zeros")

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return (input_shape[0], self.out_steps, self.nb_filter)

    def call(self, params, x, **kw):
        x, kernel = promoted(x, params["kernel"])
        # (B, S, dim, k) windows -> (S, B, k * dim), row-major (k, dim)
        patches = x.unfold(1, self.filter_length, self.subsample)
        patches = patches.permute(1, 0, 3, 2).reshape(
            self.out_steps, x.shape[0], -1)
        y = torch.bmm(patches, kernel).transpose(0, 1)
        if self.bias:
            y = y + params["bias"]
        return self.activation(y)
