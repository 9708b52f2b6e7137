"""The layer library's long tail (port of
``analytics_zoo_tpu.keras.layers.extras``): elementwise layers (``Exp``,
``Log``, ``Sqrt``, ``Square``, ``Power``, ``Negative``, ...), thresholds
(``HardShrink``, ``SoftShrink``, ``Threshold``, ``BinaryThreshold``,
``HardTanh``, ``RReLU``), learnable broadcast affine (``CAdd``, ``CMul``,
``Mul``, ``Scale``), shape utilities (``Expand``, ``GetShape``,
``SelectTable``, ``split_tensor``), ``GaussianSampler``,
``ResizeBilinear``, ``LRN2D``, ``Cropping3D``, ``AtrousConvolution1D``,
``ShareConvolution2D``, ``LocallyConnected2D``, ``ConvLSTM3D``,
``SpatialDropout3D``, the sparse-input layers and ``ComputeMask``.

Where the JAX layer's arithmetic is not a torch call's, it is written out
as the JAX package writes it:

- ``ResizeBilinear`` without ``align_corners`` is ``jax.image.resize(...,
  "bilinear")``, which widens its triangle kernel by the scale when it
  shrinks an axis (antialiasing) and renormalises the weights at the
  borders: ``F.interpolate(..., antialias=True)`` computes that, growing
  and shrinking (``F.interpolate``'s default does not antialias). The
  ``align_corners`` path keeps the JAX package's explicit float32 sample
  grid ``i * (n - 1) / (out - 1)`` and its blend, so a bf16 input comes
  out float32 there, as in JAX.
- ``LRN2D`` sums ``n`` channels around each one with JAX's window (``n //
  2`` before, ``n - 1 - n // 2`` after) and scales by ``alpha / n``;
  ``F.local_response_norm`` is not used.
- ``LocallyConnected2D``'s patches are ``F.unfold``'s (channel, row,
  column) order, which is ``lax.conv_general_dilated_patches``'s.

The random layers (``RReLU``, ``GaussianSampler``, ``SpatialDropout3D``)
draw from the generator passed as ``rng`` and are deterministic without
one (eval): ``RReLU`` takes the midpoint slope, ``GaussianSampler``
returns the mean.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.keras.engine.base import (
    KerasLayer,
    Lambda,
    Shape,
    unique_name,
)
from analytics_zoo_tpu_torch.keras.layers.convolutional import (
    Convolution1D,
    Convolution2D,
    _conv_out_dim,
)
from analytics_zoo_tpu_torch.keras.layers.core import (
    Dense,
    get_activation,
    promoted,
)
from analytics_zoo_tpu_torch.keras.layers.embeddings import Embedding
from analytics_zoo_tpu_torch.keras.layers.recurrent import ConvLSTM2D


class _Elementwise(KerasLayer):
    """Shape-preserving parameter-free op."""

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return tuple(input_shape)


class Identity(_Elementwise):
    def call(self, params, x, **kw):
        return x


class Exp(_Elementwise):
    def call(self, params, x, **kw):
        return torch.exp(x)


class Log(_Elementwise):
    def call(self, params, x, **kw):
        return torch.log(x)


class Sqrt(_Elementwise):
    def call(self, params, x, **kw):
        return torch.sqrt(x)


class Square(_Elementwise):
    def call(self, params, x, **kw):
        return torch.square(x)


class Negative(_Elementwise):
    def call(self, params, x, **kw):
        return -x


class AddConstant(_Elementwise):
    """``x + constant``."""

    def __init__(self, constant: float, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.constant = float(constant)

    def call(self, params, x, **kw):
        return x + self.constant


class MulConstant(_Elementwise):
    """``x * constant``."""

    def __init__(self, constant: float, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.constant = float(constant)

    def call(self, params, x, **kw):
        return x * self.constant


class Power(_Elementwise):
    """``(shift + scale * x) ** power``."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.power, self.scale, self.shift = (float(power), float(scale),
                                              float(shift))

    def call(self, params, x, **kw):
        return (self.shift + self.scale * x) ** self.power


class Softmax(_Elementwise):
    """Softmax over the last axis."""

    def call(self, params, x, **kw):
        return torch.softmax(x, dim=-1)


class HardTanh(_Elementwise):
    """``clip(x, min_value, max_value)``."""

    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.min_value, self.max_value = float(min_value), float(max_value)

    def call(self, params, x, **kw):
        return torch.clamp(x, self.min_value, self.max_value)


class HardShrink(_Elementwise):
    """``x`` where ``|x| > value``, else 0."""

    def __init__(self, value: float = 0.5, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.value = float(value)

    def call(self, params, x, **kw):
        return torch.where(torch.abs(x) > self.value, x, 0.0)


class SoftShrink(_Elementwise):
    """``sign(x) * max(|x| - value, 0)``."""

    def __init__(self, value: float = 0.5, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.value = float(value)

    def call(self, params, x, **kw):
        return torch.sign(x) * torch.clamp_min(torch.abs(x) - self.value,
                                               0.0)


class Threshold(_Elementwise):
    """``x`` where ``x > th``, else ``value``."""

    def __init__(self, th: float = 1e-6, value: float = 0.0,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.th, self.value = float(th), float(value)

    def call(self, params, x, **kw):
        return torch.where(x > self.th, x, self.value)


class BinaryThreshold(_Elementwise):
    """1 where ``x > value``, else 0, in ``x``'s dtype."""

    def __init__(self, value: float = 1e-6, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.value = float(value)

    def call(self, params, x, **kw):
        return (x > self.value).to(x.dtype)


class RReLU(_Elementwise):
    """Randomized leaky ReLU: the negative slope drawn per element from
    U[lower, upper) in training, their midpoint otherwise."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.lower, self.upper = float(lower), float(upper)

    def call(self, params, x, training=False, rng=None, **kw):
        if training and rng is not None:
            a = torch.empty(x.shape, dtype=x.dtype, device=x.device).uniform_(
                self.lower, self.upper, generator=rng)
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, a * x)


class Max(KerasLayer):
    """The max over ``dim`` (dim 0 is the batch)."""

    def __init__(self, dim: int, return_indices: bool = False,
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        if return_indices:
            raise NotImplementedError("return_indices is not supported")
        self.dim = int(dim)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        out = list(input_shape)
        del out[self.dim]
        return tuple(out)

    def call(self, params, x, **kw):
        return torch.amax(x, dim=self.dim)


# -- learnable broadcast affine ---------------------------------------------


class CMul(KerasLayer):
    """Learnable componentwise scale ``W`` of broadcastable ``size`` (1
    for the batch dim, e.g. (1, C, 1, 1)), initialised to 1."""

    def __init__(self, size: Sequence[int], input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.size = tuple(int(s) for s in size)

    def build(self, input_shape: Shape):
        self.add_weight("W", self.size, "ones")

    def call(self, params, x, **kw):
        return x * params["W"]


class CAdd(KerasLayer):
    """Learnable componentwise bias ``b`` of broadcastable ``size``."""

    def __init__(self, size: Sequence[int], input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.size = tuple(int(s) for s in size)

    def build(self, input_shape: Shape):
        self.add_weight("b", self.size, "zeros")

    def call(self, params, x, **kw):
        return x + params["b"]


class Mul(KerasLayer):
    """One learnable scalar multiplier ``w`` (shape (1,))."""

    def build(self, input_shape: Shape):
        self.add_weight("w", (1,), "ones")

    def call(self, params, x, **kw):
        return x * params["w"]


class Scale(KerasLayer):
    """``x * gamma + beta`` over broadcastable ``size``."""

    def __init__(self, size: Sequence[int], input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.size = tuple(int(s) for s in size)

    def build(self, input_shape: Shape):
        self.add_weight("gamma", self.size, "ones")
        self.add_weight("beta", self.size, "zeros")

    def call(self, params, x, **kw):
        return x * params["gamma"] + params["beta"]


# -- shape / structural ------------------------------------------------------


class Expand(KerasLayer):
    """Broadcast size-1 dims to ``shape`` (without the batch)."""

    def __init__(self, shape: Sequence[int], input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.target = tuple(int(s) for s in shape)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return (input_shape[0],) + self.target

    def call(self, params, x, **kw):
        return x.expand((x.shape[0],) + self.target)


class GetShape(KerasLayer):
    """The input's shape as an int32 row per sample, (B, ndim); the batch
    entry is the batch the call runs at. Made by fill kernels, not a copy
    from the host, so a CUDA graph can hold it."""

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return (input_shape[0], len(input_shape))

    def call(self, params, x, **kw):
        return torch.stack([torch.full((x.shape[0],), d, dtype=torch.int32,
                                       device=x.device) for d in x.shape],
                           dim=1)


class SelectTable(KerasLayer):
    """The ``index``-th tensor of a multi-input list."""

    def __init__(self, index: int, input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.index = int(index)

    def compute_output_shape(self, input_shape) -> Shape:
        return tuple(input_shape[self.index])

    def call(self, params, xs, **kw):
        return xs[self.index]


def split_tensor(variable, dim: int, num: int) -> List:
    """``num`` Variables, each an equal slice of ``variable`` along
    ``dim`` (a graph node has one output, so each slice is a Lambda)."""
    from analytics_zoo_tpu_torch.autograd.variable import apply_layer

    size = variable.shape[dim]
    if size is None or size % num != 0:
        raise ValueError(f"dim {dim} (size {size}) not divisible by {num}")
    step = size // num
    return [apply_layer(Lambda(lambda x, i=i: x.narrow(dim, i * step, step),
                               name=unique_name("split")), variable)
            for i in range(num)]


class GaussianSampler(KerasLayer):
    """Reparameterised sample from a ``[mean, log_var]`` pair: ``mean +
    exp(log_var / 2) * eps``, eps drawn from ``rng``; the mean without
    one."""

    def compute_output_shape(self, input_shape) -> Shape:
        return tuple(input_shape[0])

    def call(self, params, xs, training=False, rng=None, **kw):
        mean, log_var = xs
        if rng is None:
            return mean
        eps = torch.randn(mean.shape, generator=rng, device=mean.device,
                          dtype=mean.dtype)
        return mean + torch.exp(log_var * 0.5) * eps


# -- image / conv family -----------------------------------------------------


class ResizeBilinear(KerasLayer):
    """Bilinear resize of NCHW ("th") or NHWC ("tf") input to
    (output_height, output_width); see the module docstring for the two
    sample grids."""

    def __init__(self, output_height: int, output_width: int,
                 align_corners: bool = False, dim_ordering: str = "th",
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.oh, self.ow = int(output_height), int(output_width)
        self.align_corners = align_corners
        self.dim_ordering = dim_ordering

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        if self.dim_ordering == "th":
            return (input_shape[0], input_shape[1], self.oh, self.ow)
        return (input_shape[0], self.oh, self.ow, input_shape[3])

    def call(self, params, x, **kw):
        h_axis, w_axis = (2, 3) if self.dim_ordering == "th" else (1, 2)
        if self.align_corners:
            return self._interp(self._interp(x, h_axis, self.oh), w_axis,
                                self.ow)
        nchw = x if self.dim_ordering == "th" else x.permute(0, 3, 1, 2)
        # in float32 at least (the CPU has no bf16 antialiased kernel),
        # returned in the input's dtype as jax.image.resize returns it
        y = F.interpolate(nchw.to(torch.promote_types(x.dtype,
                                                      torch.float32)),
                          size=(self.oh, self.ow), mode="bilinear",
                          align_corners=False, antialias=True).to(x.dtype)
        return y if self.dim_ordering == "th" else y.permute(0, 2, 3, 1)

    @staticmethod
    def _interp(arr, axis: int, out_size: int):
        """Corner-aligned linear interpolation along ``axis``."""
        n = arr.shape[axis]
        if out_size == 1 or n == 1:
            idx = torch.zeros(out_size, dtype=torch.long, device=arr.device)
            return arr.index_select(axis, idx)
        coords = (torch.arange(out_size, dtype=torch.float32,
                               device=arr.device) * (n - 1) / (out_size - 1))
        lo = torch.clamp(torch.floor(coords).long(), 0, n - 2)
        frac = coords - lo.to(torch.float32)
        a = arr.index_select(axis, lo)
        b = arr.index_select(axis, lo + 1)
        bshape = [1] * arr.dim()
        bshape[axis] = out_size
        frac = frac.reshape(bshape)
        return a * (1.0 - frac) + b * frac


class LRN2D(KerasLayer):
    """Cross-channel local response normalisation: ``x / (k + alpha / n *
    sum of x^2 over n channels) ** beta`` with JAX's window."""

    def __init__(self, alpha: float = 1e-4, k: float = 1.0,
                 beta: float = 0.75, n: int = 5, dim_ordering: str = "th",
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.alpha, self.k, self.beta, self.n = alpha, k, beta, int(n)
        self.dim_ordering = dim_ordering

    def call(self, params, x, **kw):
        ch = 1 if self.dim_ordering == "th" else x.dim() - 1
        half = self.n // 2
        pad = [0, 0] * (x.dim() - 1 - ch) + [half, self.n - 1 - half]
        padded = F.pad(torch.square(x), pad)
        total = 0
        for i in range(self.n):
            total = total + padded.narrow(ch, i, x.shape[ch])
        norm = self.k + self.alpha / self.n * total
        return x / norm ** self.beta


class Cropping3D(KerasLayer):
    """Crop ((d0, d1), (h0, h1), (w0, w1)) of channel-first (B, C, D, H,
    W) input."""

    def __init__(self, cropping=((1, 1), (1, 1), (1, 1)), input_shape=None,
                 name=None):
        super().__init__(input_shape, name)
        self.cropping = tuple(tuple(int(v) for v in pair)
                              for pair in cropping)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        b, c = input_shape[:2]
        return (b, c) + tuple(s - lo - hi for s, (lo, hi)
                              in zip(input_shape[2:], self.cropping))

    def call(self, params, x, **kw):
        (d0, d1), (h0, h1), (w0, w1) = self.cropping
        return x[:, :, d0:x.shape[2] - d1, h0:x.shape[3] - h1,
                 w0:x.shape[4] - w1]


class AtrousConvolution1D(Convolution1D):
    """A ``Convolution1D`` dilated by ``atrous_rate``."""

    def __init__(self, nb_filter, filter_length, atrous_rate: int = 1, **kw):
        super().__init__(nb_filter, filter_length, dilation=atrous_rate, **kw)


class ShareConvolution2D(Convolution2D):
    """BigDL's buffer-sharing convolution of the Faster-RCNN graphs: a
    ``Convolution2D`` (the allocator shares buffers here)."""


class LocallyConnected2D(KerasLayer):
    """A 2-D convolution with a kernel per output position (unshared),
    VALID: leaves ``kernel`` (oh * ow, kh * kw * C, nb_filter) over the
    (channel, row, column) patch and ``bias`` (oh, ow, nb_filter)."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, border_mode="valid", subsample=(1, 1),
                 dim_ordering="th", bias=True, input_shape=None, name=None):
        super().__init__(input_shape, name)
        if border_mode != "valid":
            raise ValueError("LocallyConnected2D supports only border_mode="
                             "'valid' (as Keras 1)")
        self.nb_filter = int(nb_filter)
        self.kernel_size = (int(nb_row), int(nb_col))
        self.activation = get_activation(activation)
        self.subsample = tuple(int(s) for s in subsample)
        self.dim_ordering = dim_ordering
        self.bias = bias

    def _spatial(self, input_shape):
        if self.dim_ordering == "th":
            c, h, w = input_shape[1], input_shape[2], input_shape[3]
        else:
            h, w, c = input_shape[1], input_shape[2], input_shape[3]
        oh = _conv_out_dim(h, self.kernel_size[0], self.subsample[0],
                           "valid")
        ow = _conv_out_dim(w, self.kernel_size[1], self.subsample[1],
                           "valid")
        return c, oh, ow

    def build(self, input_shape: Shape):
        c, oh, ow = self._spatial(input_shape)
        kh, kw = self.kernel_size
        self.add_weight("kernel", (oh * ow, kh * kw * c, self.nb_filter),
                        "glorot_uniform")
        if self.bias:
            self.add_weight("bias", (oh, ow, self.nb_filter), "zeros")

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        _, oh, ow = self._spatial(input_shape)
        if self.dim_ordering == "th":
            return (input_shape[0], self.nb_filter, oh, ow)
        return (input_shape[0], oh, ow, self.nb_filter)

    def call(self, params, x, **kw):
        x, kernel = promoted(x, params["kernel"])
        if self.dim_ordering == "tf":
            x = x.permute(0, 3, 1, 2)
        b, (kh, kw) = x.shape[0], self.kernel_size
        oh = _conv_out_dim(x.shape[2], kh, self.subsample[0], "valid")
        ow = _conv_out_dim(x.shape[3], kw, self.subsample[1], "valid")
        # (B, C * kh * kw, oh * ow) -> (oh * ow, B, C * kh * kw)
        patches = F.unfold(x, (kh, kw), stride=self.subsample).permute(
            2, 0, 1)
        y = torch.bmm(patches, kernel).transpose(0, 1).reshape(
            b, oh, ow, self.nb_filter)
        if self.bias:
            y = y + params["bias"]
        y = self.activation(y)
        return y.permute(0, 3, 1, 2) if self.dim_ordering == "th" else y


class ConvLSTM3D(ConvLSTM2D):
    """Volumetric ConvLSTM over (batch, time, C, D, H, W): the 2-D layer's
    recurrence with 3-D gate convolutions, leaves ``W`` (k, k, k, C, 4F),
    ``U`` (k, k, k, F, 4F), ``b`` (4F,); its carry is float32 too."""
    rank = 3


class SpatialDropout3D(KerasLayer):
    """Drops whole channels of a 5-D volume, scaling the kept ones by
    ``1 / (1 - p)``."""

    def __init__(self, p: float = 0.5, dim_ordering: str = "th",
                 input_shape=None, name=None):
        super().__init__(input_shape, name)
        self.p = float(p)
        self.dim_ordering = dim_ordering

    def call(self, params, x, training=False, rng=None, **kw):
        if not training or rng is None or self.p <= 0.0:
            return x
        if self.dim_ordering == "th":
            shape = (x.shape[0], x.shape[1], 1, 1, 1)
        else:
            shape = (x.shape[0], 1, 1, 1, x.shape[-1])
        keep = torch.rand(shape, generator=rng, device=x.device) \
            < 1.0 - self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)


class SparseDense(Dense):
    """``Dense`` under the reference's name: sparse input is densified on
    the host."""


class SparseEmbedding(Embedding):
    """``Embedding`` under the reference's name: sparse input is densified
    on the host."""


class ComputeMask(KerasLayer):
    """A (B, T) float32 timestep mask: ``ids != pad_value`` over (B, T)
    ids, or ``any(x != mask_value)`` over the features of (B, T, D)."""

    def __init__(self, pad_value=None, mask_value=None, input_shape=None,
                 name=None):
        super().__init__(input_shape, name)
        if (pad_value is None) == (mask_value is None):
            raise ValueError("give exactly one of pad_value / mask_value")
        self.pad_value = pad_value
        self.mask_value = mask_value

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:2])

    def call(self, params, x, **kw):
        if self.pad_value is not None:
            return (x != self.pad_value).to(torch.float32)
        return torch.any(x != self.mask_value, dim=-1).to(torch.float32)
