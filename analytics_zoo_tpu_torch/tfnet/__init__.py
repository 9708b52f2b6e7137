"""TFNet (port of ``analytics_zoo_tpu.tfnet``): run someone else's trained
TensorFlow graph on PyTorch.

Ref: pipeline/api/net/TFNet.scala:52 (frozen-graph forward inference over
the libtensorflow JNI) and pyzoo tfnet.py:50. A frozen ``GraphDef`` is
interpreted once into a function of PyTorch ops (weights baked in as
constants, the frozen-graph semantics): no TF runtime on the serving path.
On the card its convolutions and matmuls are cuDNN and cuBLAS calls, and
:meth:`InferenceModel.do_load_tf
<analytics_zoo_tpu_torch.inference.inference_model.InferenceModel.do_load_tf>`
captures each bucket in one CUDA graph.

**No TensorFlow for a frozen graph.** A ``.pb`` is parsed by the in-repo
reader (:mod:`.graphdef`, on the wire codec the ONNX and Caffe importers
share). TensorFlow is imported, at call time only, to freeze a SavedModel
or a live tf.keras model (:func:`load_saved_model`,
:func:`freeze_keras_model`); without it those raise ``ImportError``.

**Shape chains stay on the host.** A value is *static* when it is a numpy
array or a Python number: the integer constants, and what the shape ops
(``Shape``, ``StridedSlice``, ``Pack``, ``ConcatV2``, ``Prod``, ``Cast``,
...) derive from them and from tensor shapes. ``Reshape``, ``Fill``,
``Tile``, ``Pad`` and the rest read their shape operands as host arrays,
so no shape op synchronises with the card and a bucket's forward captures
whole (the JAX package's ``_traced`` split).

**Constants reach the device once.** Constants stay host arrays in the
graph. One that meets a tensor is placed on that tensor's device the
first time (by a bucket's eager warm-up, before the capture) and kept,
per device, in the :class:`GraphFunction`'s
:class:`~analytics_zoo_tpu_torch.common.consts.ConstCache` (by node name);
a convolution kernel is kept in the layout the convolution takes (HWIO
made OIHW, channels-last on the card). Nothing is uploaded again at a
later call.

**Layout and precision.** Everything is NHWC, as the graph declares:
``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is a channels-last
NCHW view, which cuDNN takes with no copy; on the CPU the input is made
contiguous NCHW (oneDNN's strided 1x1 weight gradient on channels-last
tensors is wrong, ``keras.layers.convolutional``). The graph runs in IEEE
float32 on the card (:func:`analytics_zoo_tpu_torch.onnx._ieee_f32`), so
TF32 does not move its outputs.

Supported: the JAX package's op set (the inference ops of CNN/MLP
exports: Conv2D, DepthwiseConv2dNative, Conv2DBackpropInput,
FusedBatchNorm, pooling, matmuls, activations, reductions, shape ops,
pads, concat/split, strided slices). An unsupported op raises
``NotImplementedError`` naming it.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common.consts import (
    ConstCache,
    as_tensor,
    running,
)
from analytics_zoo_tpu_torch.keras.engine.base import KerasLayer, Shape
from analytics_zoo_tpu_torch.keras.layers.convolutional import _same_pads
from analytics_zoo_tpu_torch.onnx import _ieee_f32, _slice_axis
from analytics_zoo_tpu_torch.tfnet.graphdef import GraphDef, parse_graph_def

_OPS: Dict[str, Callable] = {}


def _op(*names):
    def deco(fn):
        for n in names:
            _OPS[n] = fn
        return fn
    return deco


def _is_static(*xs) -> bool:
    return all(isinstance(x, (np.ndarray, np.generic, int, float, bool))
               for x in xs)


def _ints(x):
    """A static operand (a shape, axes, sizes) as Python ints."""
    return [int(v) for v in np.atleast_1d(np.asarray(x))]


_t = as_tensor  # a static value on the running forward's device, once


def _attr_list(attr, field):
    return list(getattr(attr.list, field))


def _padding(attrs) -> str:
    return attrs["padding"].s.decode()


def _nhwc(attrs) -> None:
    fmt = attrs["data_format"].s.decode() if "data_format" in attrs else "NHWC"
    if fmt not in ("NHWC", ""):
        raise NotImplementedError(f"data_format {fmt} (NHWC only)")


# -- arithmetic / activations ------------------------------------------------


def _binary(fn, np_fn=None):
    def run(attrs, a, b):
        if _is_static(a, b):  # folded on the host, as numpy
            return (np_fn or fn)(a, b)
        return fn(_t(a), _t(b))
    return run


def _unary(fn):
    return lambda attrs, x, *rest: fn(_t(x))


_op("Add", "AddV2")(_binary(lambda a, b: a + b))
_op("Sub")(_binary(lambda a, b: a - b))
_op("Mul")(_binary(lambda a, b: a * b))
_op("RealDiv", "Div")(_binary(lambda a, b: a / b))
_op("Maximum")(_binary(torch.maximum, np.maximum))
_op("Minimum")(_binary(torch.minimum, np.minimum))
_op("Pow")(_binary(torch.pow, np.power))
_op("Neg")(lambda attrs, x: -x)
_op("Square")(_unary(torch.square))
_op("Sqrt")(_unary(torch.sqrt))
_op("Rsqrt")(_unary(torch.rsqrt))
_op("Exp")(_unary(torch.exp))
_op("Log")(_unary(torch.log))
_op("Erf")(_unary(torch.erf))
_op("Relu")(_unary(torch.relu))
_op("Relu6")(_unary(lambda x: torch.clamp(x, 0.0, 6.0)))
_op("Elu")(_unary(F.elu))
_op("Selu")(_unary(F.selu))
_op("Sigmoid")(_unary(torch.sigmoid))
_op("Tanh")(_unary(torch.tanh))
# jax.nn.softplus: log(1 + exp(x)) for every x (no linear threshold)
_op("Softplus")(_unary(lambda x: torch.logaddexp(x, torch.zeros_like(x))))
_op("Softmax")(_unary(lambda x: torch.softmax(x, dim=-1)))
_op("ZerosLike")(_unary(torch.zeros_like))
_op("Identity", "StopGradient", "PreventGradient", "CheckNumerics",
    "EnsureShape", "Snapshot")(lambda attrs, x, *rest: x)
_op("BiasAdd")(lambda attrs, x, b: _t(x) + _t(b))


@_op("LeakyRelu")
def _leaky_relu(attrs, x):
    return F.leaky_relu(_t(x), attrs["alpha"].f if "alpha" in attrs else 0.2)


@_op("AddN")
def _add_n(attrs, *xs):
    if _is_static(*xs):
        return functools.reduce(np.add, xs)
    return functools.reduce(torch.add, [_t(x) for x in xs])


@_op("Cast")
def _cast(attrs, x):
    code = attrs["DstT"].type
    if _is_static(x):
        return np.asarray(x).astype(_NP_DTYPES[code])
    return x.to(_TORCH_DTYPES[code])


# -- matmul / conv / pooling -------------------------------------------------


@_op("MatMul")
def _matmul(attrs, a, b):
    a, b = _t(a), _t(b)
    if "transpose_a" in attrs and attrs["transpose_a"].b:
        a = a.T
    if "transpose_b" in attrs and attrs["transpose_b"].b:
        b = b.T
    return a @ b


@_op("BatchMatMul", "BatchMatMulV2")
def _batch_matmul(attrs, a, b):
    a, b = _t(a), _t(b)
    if "adj_x" in attrs and attrs["adj_x"].b:
        a = a.transpose(-1, -2)
    if "adj_y" in attrs and attrs["adj_y"].b:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def _pads(attrs, hw, k_hw, strides, dilations):
    """(low, high) per spatial dim for SAME, VALID or EXPLICIT."""
    pad = _padding(attrs)
    if pad == "EXPLICIT":
        p = _attr_list(attrs["explicit_paddings"], "i")
        return [(p[2], p[3]), (p[4], p[5])]
    if pad == "SAME":  # XLA's SAME is TF's
        return _same_pads(hw, k_hw, strides, dilations)
    return [(0, 0), (0, 0)]


def _to_nchw(x):
    """An NHWC tensor as a convolution's NCHW input and the memory format
    its weight takes: channels-last on the card, contiguous on the CPU."""
    if x.is_cuda:
        return x.permute(0, 3, 1, 2), torch.channels_last
    return x.permute(0, 3, 1, 2).contiguous(), torch.contiguous_format


def _hwio_to_oihw(k):
    return k.transpose(3, 2, 0, 1)


def _hwcm_to_grouped(k):
    """A depthwise (h, w, c, m) kernel as the (c*m, 1, h, w) weight of a
    ``groups=c`` convolution (TF's output channel c*m + j)."""
    h, w, c, m = k.shape
    return k.transpose(2, 3, 0, 1).reshape(c * m, 1, h, w)


def _weight(k, layout, fmt):
    """A kernel operand in the convolution's layout: a constant is placed
    (and laid out) once per device and format; a tensor each call."""
    fn = _hwio_to_oihw if layout == "oihw" else _hwcm_to_grouped
    if _is_static(k):
        return _t(k, transform=fn, fmt=fmt)
    if layout == "oihw":
        return k.permute(3, 2, 0, 1).contiguous(memory_format=fmt)
    h, w, c, m = k.shape
    return k.permute(2, 3, 0, 1).reshape(c * m, 1, h, w)


def _conv(attrs, x, k, layout):
    _nhwc(attrs)
    x = _t(x)
    s = _attr_list(attrs["strides"], "i")[1:3]
    d = (_attr_list(attrs["dilations"], "i")[1:3] if "dilations" in attrs
         else [1, 1])
    xc, fmt = _to_nchw(x)
    w = _weight(k, layout, fmt)
    pads = _pads(attrs, x.shape[1:3], w.shape[2:], s, d)
    groups = x.shape[3] if layout == "grouped" else 1
    if all(lo == hi for lo, hi in pads):
        y = F.conv2d(xc, w, None, tuple(s), tuple(lo for lo, _ in pads),
                     tuple(d), groups)
    else:
        (hl, hh), (wl, wh) = pads
        y = F.conv2d(F.pad(xc, (wl, wh, hl, hh)), w, None, tuple(s), 0,
                     tuple(d), groups)
    return y.permute(0, 2, 3, 1)


@_op("Conv2D")
def _conv2d(attrs, x, k):
    return _conv(attrs, x, k, "oihw")


@_op("DepthwiseConv2dNative")
def _depthwise(attrs, x, k):
    return _conv(attrs, x, k, "grouped")


@_op("Conv2DBackpropInput")
def _conv2d_transpose(attrs, out_shape, k, x):
    """TF deconv = the gradient of the forward convolution: the full
    transposed convolution, cropped by the padding the *forward*
    convolution's SAME/VALID gives on the recorded output shape, so
    ``out_shape`` is honoured exactly."""
    _nhwc(attrs)
    if not _is_static(out_shape):
        raise NotImplementedError("Conv2DBackpropInput with traced shape")
    x = _t(x)
    s = _attr_list(attrs["strides"], "i")[1:3]
    d = (_attr_list(attrs["dilations"], "i")[1:3]
         if "dilations" in attrs else [1, 1])
    out_hw = _ints(out_shape)[1:3]
    xc, fmt = _to_nchw(x)
    w = _weight(k, "oihw", fmt)  # (C_x, C_out, kh, kw): conv_transpose's
    y = F.conv_transpose2d(xc, w, None, tuple(s), dilation=tuple(d))
    pad = _padding(attrs)
    for ax, (ksz, stride, dil, out, inp) in enumerate(zip(
            w.shape[2:], s, d, out_hw, x.shape[1:3])):
        k_eff = (ksz - 1) * dil + 1
        total = (max((inp - 1) * stride + k_eff - out, 0) if pad == "SAME"
                 else 0)
        lo = total // 2
        y = y.narrow(2 + ax, lo, y.shape[2 + ax] - total)
    if list(y.shape[2:]) != out_hw:  # pragma: no cover — formula guard
        raise NotImplementedError(
            f"Conv2DBackpropInput shape mismatch: got {list(y.shape[2:])}, "
            f"graph records {out_hw}")
    return y.permute(0, 2, 3, 1)


def _pool_geometry(attrs, x):
    _nhwc(attrs)
    ks = _attr_list(attrs["ksize"], "i")
    s = _attr_list(attrs["strides"], "i")
    if ks[0] != 1 or ks[3] != 1 or s[0] != 1 or s[3] != 1:
        raise NotImplementedError(
            f"pooling over the batch or channel axis (ksize {ks}, strides "
            f"{s})")
    return ks[1:3], s[1:3], _pads(attrs, x.shape[1:3], ks[1:3], s[1:3],
                                  [1, 1])


def _spatial_pad(xc, pads, value=0.0):
    (hl, hh), (wl, wh) = pads
    if not (hl or hh or wl or wh):
        return xc
    return F.pad(xc, (wl, wh, hl, hh), value=value)


@_op("MaxPool")
def _maxpool(attrs, x):
    x = _t(x)
    k, s, pads = _pool_geometry(attrs, x)
    xc = _to_nchw(x)[0]
    return F.max_pool2d(_spatial_pad(xc, pads, -float("inf")), tuple(k),
                        tuple(s)).permute(0, 2, 3, 1)


@_op("AvgPool")
def _avgpool(attrs, x):
    # TF excludes padding from the divisor (the count of in-bounds cells)
    x = _t(x)
    k, s, pads = _pool_geometry(attrs, x)
    xc = _to_nchw(x)[0]
    sums = F.avg_pool2d(_spatial_pad(xc, pads), tuple(k), tuple(s),
                        divisor_override=1)
    ones = torch.ones((1, 1) + tuple(x.shape[1:3]), dtype=x.dtype,
                      device=x.device)
    cnt = F.avg_pool2d(_spatial_pad(ones, pads), tuple(k), tuple(s),
                       divisor_override=1)
    return (sums / cnt).permute(0, 2, 3, 1)


@_op("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3")
def _fused_bn(attrs, x, scale, offset, mean, var):
    _nhwc(attrs)
    if "is_training" in attrs and attrs["is_training"].b:
        raise NotImplementedError("FusedBatchNorm with is_training=True "
                                  "(freeze the graph for inference first)")
    eps = attrs["epsilon"].f if "epsilon" in attrs else 1e-3
    inv = torch.rsqrt(_t(var) + eps) * _t(scale)
    return _t(x) * inv + (_t(offset) - _t(mean) * inv)


# -- shape / layout ----------------------------------------------------------


@_op("Reshape")
def _reshape(attrs, x, shape):
    if not _is_static(shape):
        raise NotImplementedError(
            "Reshape with a data-dependent target shape cannot be captured "
            "(shape-metadata subgraph was not constant-foldable)")
    shape = _ints(shape)
    if _is_static(x):
        return np.reshape(x, shape)
    return x.reshape(shape)


@_op("Squeeze")
def _squeeze(attrs, x):
    dims = (_attr_list(attrs["squeeze_dims"], "i") if "squeeze_dims" in attrs
            else None)
    if _is_static(x):
        return np.squeeze(x, axis=tuple(dims) if dims else None)
    return torch.squeeze(x, tuple(dims)) if dims else torch.squeeze(x)


@_op("ExpandDims")
def _expand_dims(attrs, x, axis):
    ax = int(np.asarray(axis))
    if _is_static(x):
        return np.expand_dims(x, ax)
    return torch.unsqueeze(x, ax if ax >= 0 else ax + x.dim() + 1)


@_op("Transpose")
def _transpose(attrs, x, perm):
    perm = _ints(perm)
    if _is_static(x):
        return np.transpose(x, perm)
    return x.permute(*perm)


@_op("Shape")
def _shape(attrs, x):
    # a host array: the shape chain downstream (StridedSlice, Pack,
    # ConcatV2, Prod -> Reshape: the Flatten/GlobalPool pattern) stays
    # static, so the ops that read it never read the device
    return np.asarray(tuple(np.shape(x)), np.int32)


@_op("Pack")
def _pack(attrs, *xs):
    axis = attrs["axis"].i if "axis" in attrs else 0
    if _is_static(*xs):
        return np.stack([np.asarray(v) for v in xs], axis=axis)
    return torch.stack([_t(v) for v in xs], dim=axis)


@_op("Unpack")
def _unpack(attrs, x):
    axis = attrs["axis"].i if "axis" in attrs else 0
    if _is_static(x):
        return tuple(np.moveaxis(np.asarray(x), axis, 0))
    return tuple(torch.unbind(x, dim=axis))


@_op("ConcatV2")
def _concat(attrs, *args):
    *xs, axis = args
    ax = int(np.asarray(axis))
    if _is_static(*xs):
        return np.concatenate([np.asarray(v) for v in xs], axis=ax)
    return torch.cat([_t(v) for v in xs], dim=ax)


@_op("Split")
def _split(attrs, axis, x):
    n = attrs["num_split"].i
    x = _t(x)
    ax = int(np.asarray(axis)) % x.dim()
    return tuple(torch.split(x, x.shape[ax] // n, dim=ax))


@_op("SplitV")
def _splitv(attrs, x, sizes, axis):
    x = _t(x)
    ax = int(np.asarray(axis)) % x.dim()
    sizes = _ints(sizes)
    if sizes.count(-1) > 1:
        raise NotImplementedError("SplitV with multiple -1 sizes")
    if -1 in sizes:   # one inferred section
        sizes[sizes.index(-1)] = x.shape[ax] - (sum(sizes) + 1)
    return tuple(torch.split(x, sizes, dim=ax))


def _pad_rows(paddings):
    return [tuple(int(v) for v in row) for row in np.asarray(paddings)]


@_op("Pad", "PadV2")
def _pad(attrs, x, paddings, *const):
    rows = _pad_rows(paddings)
    if _is_static(x, *const):
        val = float(np.asarray(const[0])) if const else 0.0
        return np.pad(np.asarray(x), rows, constant_values=val)
    x = _t(x)
    flat = [p for row in reversed(rows) for p in row]  # last axis first
    if const and not _is_static(const[0]):
        # a device pad value: pad with 0, then fill the border from it,
        # with no read of the value on the host
        inside = F.pad(torch.ones_like(x, dtype=torch.bool), flat,
                       value=False)
        return torch.where(inside, F.pad(x, flat, value=0.0),
                           const[0].reshape(()).to(x.dtype))
    val = float(np.asarray(const[0])) if const else 0.0
    return F.pad(x, flat, value=val)


@_op("MirrorPad")
def _mirror_pad(attrs, x, paddings):
    mode = attrs["mode"].s.decode().lower()
    np_mode = "reflect" if mode == "reflect" else "symmetric"
    x = _t(x)
    for ax, (lo, hi) in enumerate(_pad_rows(paddings)):
        if lo or hi:  # numpy's index pattern of the mode along this axis
            idx = np.pad(np.arange(x.shape[ax]), (lo, hi), mode=np_mode)
            x = torch.index_select(x, ax, _t(idx))
    return x


@_op("Fill")
def _fill(attrs, shape, value):
    if not _is_static(shape):
        raise NotImplementedError("Fill with traced shape")
    shape = _ints(shape)
    if _is_static(value):
        v = np.asarray(value)
        return np.full(shape, v.item(), v.dtype)
    return value.reshape(()).expand(shape).clone()


@_op("Tile")
def _tile(attrs, x, multiples):
    reps = _ints(multiples)
    if _is_static(x):
        return np.tile(x, reps)
    return torch.tile(x, reps)


@_op("GatherV2")
def _gather(attrs, params, indices, axis):
    if "batch_dims" in attrs and attrs["batch_dims"].i != 0:
        raise NotImplementedError(
            f"GatherV2 with batch_dims={attrs['batch_dims'].i}")
    ax = int(np.asarray(axis))
    if _is_static(params, indices):
        return np.take(np.asarray(params), np.asarray(indices), axis=ax)
    x = _t(params)
    ax %= x.dim()
    n = x.shape[ax]
    if _is_static(indices):
        idx = np.asarray(indices).astype(np.int64)
        shape = idx.shape
        flat = _t(np.where(idx < 0, idx + n, idx).reshape(-1))
    else:
        shape = tuple(indices.shape)
        flat = indices.reshape(-1).long()
        flat = torch.where(flat < 0, flat + n, flat)
    out = torch.index_select(x, ax, flat)
    return out.reshape(tuple(x.shape[:ax]) + tuple(shape)
                       + tuple(x.shape[ax + 1:]))


@_op("StridedSlice")
def _strided_slice(attrs, x, begin, end, strides):
    begin, end, strides = _ints(begin), _ints(end), _ints(strides)
    bm = attrs["begin_mask"].i if "begin_mask" in attrs else 0
    em = attrs["end_mask"].i if "end_mask" in attrs else 0
    sm = attrs["shrink_axis_mask"].i if "shrink_axis_mask" in attrs else 0
    nm = attrs["new_axis_mask"].i if "new_axis_mask" in attrs else 0
    elm = attrs["ellipsis_mask"].i if "ellipsis_mask" in attrs else 0
    if nm or elm:
        raise NotImplementedError("StridedSlice new_axis/ellipsis masks")
    idx = []
    for i in range(len(begin)):
        if sm & (1 << i):
            idx.append(begin[i])
            continue
        b = None if bm & (1 << i) else begin[i]
        e = None if em & (1 << i) else end[i]
        idx.append(slice(b, e, strides[i]))
    if _is_static(x):
        return np.asarray(x)[tuple(idx)]
    shrink = []
    for ax, sl in enumerate(idx):
        if isinstance(sl, int):
            shrink.append(ax)
            sl = slice(sl, sl + 1 if sl != -1 else None)
        x = _slice_axis(x, ax, sl)
    return x.squeeze(tuple(shrink)) if shrink else x


def _reduction(kind):
    np_fn = {"mean": np.mean, "sum": np.sum, "max": np.max, "min": np.min,
             "prod": np.prod}[kind]

    def fn(attrs, x, axes):
        keep = attrs["keep_dims"].b if "keep_dims" in attrs else False
        ax = tuple(_ints(axes))
        if not ax:  # no axes: nothing reduced (jnp's axis=())
            return x
        if _is_static(x):
            return np_fn(np.asarray(x), axis=ax, keepdims=keep)
        dims = tuple(a % x.dim() for a in ax)
        if kind == "prod":
            for d in sorted(dims, reverse=True):
                x = torch.prod(x, dim=d, keepdim=keep)
            return x
        if kind in ("max", "min"):
            return (torch.amax if kind == "max" else torch.amin)(
                x, dim=dims, keepdim=keep)
        return (torch.mean if kind == "mean" else torch.sum)(
            x, dim=dims, keepdim=keep)
    return fn


for _name in ("Mean", "Sum", "Max", "Min", "Prod"):
    _OPS[_name] = _reduction(_name.lower())


@_op("ArgMax")
def _argmax(attrs, x, axis):
    return torch.argmax(_t(x), dim=int(np.asarray(axis)))


# ---------------------------------------------------------------------------
# GraphDef interpretation
# ---------------------------------------------------------------------------

# DataType enum -> numpy (host values) and torch (tensors); float64 tensors
# are float32, as the JAX package's x64-off arrays
_NP_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
              5: np.int16, 6: np.int8, 9: np.int64, 10: np.bool_,
              14: np.float32, 19: np.float16, 22: np.uint32, 23: np.uint64}
_TORCH_DTYPES = {1: torch.float32, 2: torch.float32, 3: torch.int32,
                 4: torch.uint8, 5: torch.int16, 6: torch.int8, 9: torch.int64,
                 10: torch.bool, 14: torch.bfloat16, 19: torch.float16,
                 22: torch.uint32, 23: torch.uint64}

_SOURCE_OPS = ("Const", "Placeholder", "PlaceholderWithDefault", "NoOp",
               "ReadVariableOp")


def _split_ref(ref: str) -> Tuple[str, int]:
    ref = ref.lstrip("^")
    if ":" in ref:
        name, k = ref.rsplit(":", 1)
        return name, int(k)
    return ref, 0


def _as_graph_def(graph_def) -> GraphDef:
    """The reader's GraphDef of ``graph_def``: one already, its bytes, or a
    ``tf.compat.v1.GraphDef`` (re-read from its serialization)."""
    if isinstance(graph_def, GraphDef):
        return graph_def
    if isinstance(graph_def, (bytes, bytearray)):
        return parse_graph_def(bytes(graph_def))
    return parse_graph_def(graph_def.SerializeToString())


class GraphFunction:
    """A frozen TF ``GraphDef`` interpreted as a function of PyTorch ops.

    ``apply(*inputs)`` maps positional tensors onto ``input_names`` and
    returns the ``output_names`` values (a single value if one output);
    ``__call__`` also takes host arrays, which it places on the context's
    device. ``graph_def`` is the reader's :class:`~.graphdef.GraphDef`, its
    serialized bytes, or a TensorFlow ``GraphDef``.
    """

    def __init__(self, graph_def, input_names: Sequence[str],
                 output_names: Sequence[str]):
        graph_def = _as_graph_def(graph_def)
        self.input_names = [_split_ref(n)[0] for n in input_names]
        self.output_refs = [_split_ref(n) for n in output_names]
        self._nodes = {}
        self._consts: Dict[str, np.ndarray] = {}
        for node in graph_def.node:
            self._nodes[node.name] = node
            if node.op == "Const":
                self._consts[node.name] = node.attr["value"].tensor.ndarray()
        unknown = sorted({n.op for n in graph_def.node
                          if n.op not in _OPS and n.op not in _SOURCE_OPS})
        if unknown:
            raise NotImplementedError(
                f"Unsupported TF ops in graph: {unknown}. Supported: "
                f"{sorted(_OPS)}")
        # the constants placed on a device, kept by node name
        self.cache = ConstCache(self._consts)

    @property
    def input_shapes(self):
        """Declared placeholder shapes, one tuple per input; unknown dims
        (including a -1/unset batch dim) are ``None``; a placeholder with
        no shape attr at all yields ``None`` instead of a tuple — callers
        must not confuse it with a declared scalar ``()``."""
        out = []
        for name in self.input_names:
            attr = self._nodes[name].attr.get("shape")
            if attr is None or not attr.HasField("shape"):
                out.append(None)
                continue
            out.append(tuple(None if d.size < 0 else int(d.size)
                             for d in attr.shape.dim))
        return out

    def device_of(self, inputs) -> torch.device:
        for x in inputs:
            if isinstance(x, torch.Tensor):
                return x.device
        from analytics_zoo_tpu_torch.common.nncontext import get_nncontext

        return get_nncontext().device

    def apply(self, *inputs):
        """The graph's outputs for ``inputs`` (tensors, or host arrays that
        join the shape chains), in IEEE float32 on the card. Runs under no
        grad mode of its own, so a frozen graph can sit under a trained
        head."""
        if len(inputs) != len(self.input_names):
            raise ValueError(f"expected {len(self.input_names)} inputs "
                             f"({self.input_names}), got {len(inputs)}")
        device = self.device_of(inputs)
        with running(device, self.cache), _ieee_f32(device):
            return self._run(inputs)

    def _run(self, inputs):
        values: Dict[str, Any] = {
            name: (x,) for name, x in zip(self.input_names, inputs)}

        def eval_node(name: str):
            if name in values:
                return
            # iterative post-order DFS (graphs can exceed recursion depth)
            stack = [(name, False)]
            while stack:
                cur, ready = stack.pop()
                if cur in values:
                    continue
                node = self._nodes[cur]
                deps = [_split_ref(i)[0] for i in node.input
                        if not i.startswith("^")]
                if not ready:
                    stack.append((cur, True))
                    stack.extend((d, False) for d in deps
                                 if d not in values)
                    continue
                values[cur] = self._eval(node, values)

        outs = []
        for name, k in self.output_refs:
            eval_node(name)
            outs.append(values[name][k])
        return outs[0] if len(outs) == 1 else tuple(outs)

    def _eval(self, node, values) -> Tuple:
        if node.op == "Const":
            return (self._consts[node.name],)
        if node.op == "Placeholder":
            raise ValueError(f"Placeholder '{node.name}' not bound — pass it "
                             "in input_names")
        if node.op == "PlaceholderWithDefault":
            name, k = _split_ref(node.input[0])
            return (values[name][k],)
        if node.op in ("NoOp", "ReadVariableOp"):
            return (None,)
        args = []
        for ref in node.input:
            if ref.startswith("^"):
                continue
            name, k = _split_ref(ref)
            args.append(values[name][k])
        out = _OPS[node.op](node.attr, *args)
        return out if isinstance(out, tuple) else (out,)

    def __call__(self, *inputs):
        """``apply`` of tensors or host arrays; host arrays are placed on
        the device of the tensors among them, or the context's."""
        from analytics_zoo_tpu_torch.common.nncontext import host_to_device

        dev = self.device_of(inputs)
        xs = [x if isinstance(x, torch.Tensor) else host_to_device(x, dev)
              for x in inputs]
        return self.apply(*xs)


# ---------------------------------------------------------------------------
# Loaders (ref TFNet.apply(folder):786, net_load.py:70-160)
# ---------------------------------------------------------------------------


def _tensorflow(what: str):
    """TensorFlow, imported at call time; without it an ``ImportError``
    that names the TF-free route."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(
            f"TensorFlow is required to {what} (load-time only); a frozen "
            "GraphDef (.pb) loads without it: load_frozen_graph / "
            "Net.load_tf(pb, input_names, output_names), or convert the "
            "model to ONNX and use Net.load_onnx") from e
    return tf


def _freeze_saved_model(path: str):
    _tensorflow("load a SavedModel (to freeze its variables)")
    import tensorflow as tf
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    loaded = tf.saved_model.load(path)
    sigs = getattr(loaded, "signatures", {})
    if "serving_default" in sigs:
        concrete = sigs["serving_default"]
    elif sigs:
        concrete = next(iter(sigs.values()))
    else:
        raise ValueError(f"SavedModel at {path} has no signatures")
    frozen = convert_variables_to_constants_v2(concrete)
    gd = _as_graph_def(frozen.graph.as_graph_def())
    inputs = [t.name for t in frozen.inputs]
    outputs = [t.name for t in frozen.outputs]
    return gd, inputs, outputs


def freeze_keras_model(model) -> GraphFunction:
    """Freeze a live tf.keras model into a GraphFunction (the in-process
    analogue of export_tf + TFNet, util/tf.py:42-296)."""
    tf = _tensorflow("freeze a live tf.keras model")
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    specs = [tf.TensorSpec(i.shape, i.dtype) for i in model.inputs]
    concrete = tf.function(lambda *a: model(list(a) if len(a) > 1 else a[0])) \
        .get_concrete_function(*specs)
    frozen = convert_variables_to_constants_v2(concrete)
    return GraphFunction(frozen.graph.as_graph_def(),
                         [t.name for t in frozen.inputs],
                         [t.name for t in frozen.outputs])


def load_frozen_graph(pb_path: str, input_names: Sequence[str],
                      output_names: Sequence[str]) -> GraphFunction:
    """Load a frozen ``.pb`` GraphDef (the reference's primary TFNet input,
    TFNet.scala:786), parsed without TensorFlow."""
    with open(pb_path, "rb") as f:
        return GraphFunction(f.read(), input_names, output_names)


def load_saved_model(path: str) -> GraphFunction:
    """Load + freeze a TF2 SavedModel directory (TensorFlow at call
    time)."""
    return GraphFunction(*_freeze_saved_model(path))


KERAS_FILES = (".h5", ".hdf5", ".keras")


def load(path: str, input_names: Sequence[str] = None,
         output_names: Sequence[str] = None,
         caller: str = "load") -> GraphFunction:
    """A TF model file as a :class:`GraphFunction`, by the kind of path: a
    SavedModel directory, a Keras ``.h5``/``.hdf5``/``.keras`` file (both
    frozen through TensorFlow, imported at call time), or else a frozen
    ``.pb`` GraphDef, which needs ``input_names`` and ``output_names`` and
    no TensorFlow. ``caller`` names the entry point in the errors."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"{caller}: no such path '{path}'")
    if os.path.isdir(path):
        return load_saved_model(path)
    if path.endswith(KERAS_FILES):
        tf = _tensorflow("load a Keras model file as a TF graph")
        return freeze_keras_model(tf.keras.models.load_model(path))
    if input_names is None or output_names is None:
        raise ValueError("frozen .pb import needs input_names and "
                         "output_names (e.g. ['input:0'], ['output:0'])")
    return load_frozen_graph(path, input_names, output_names)


class TFNet(KerasLayer):
    """A frozen TF graph as a layer — stack zoo layers on top for transfer
    learning (the reference's TFNet-as-first-layer pattern). Weights are
    frozen constants (forward-only, exactly TFNet.scala's contract)."""

    def __init__(self, fn: GraphFunction, input_shape=None, name=None,
                 input_dtype=torch.float32):
        super().__init__(input_shape, name or "tfnet")
        if len(fn.input_names) != 1:
            # fail at load, not deep inside the first shape probe
            raise ValueError(
                f"TFNet wraps single-input graphs; this one has inputs "
                f"{fn.input_names}. Call the GraphFunction directly for "
                "multi-input models.")
        self.fn = fn
        self.input_dtype = input_dtype

    @staticmethod
    def from_saved_model(path: str, **kw) -> "TFNet":
        """Load a TF SavedModel directory (ref TFNet.fromSavedModel)."""
        return TFNet(load_saved_model(path), **kw)

    @staticmethod
    def from_frozen(pb_path: str, input_names: Sequence[str],
                    output_names: Sequence[str], **kw) -> "TFNet":
        """Load a frozen GraphDef .pb (ref TFNet.fromFrozen)."""
        return TFNet(load_frozen_graph(pb_path, input_names, output_names),
                     **kw)

    @staticmethod
    def from_keras(model, **kw) -> "TFNet":
        """Wrap a live tf.keras model via the converter (ref TFNet.fromKeras).
        """
        return TFNet(freeze_keras_model(model), **kw)

    def build(self, input_shape: Shape) -> None:
        pass  # frozen: no trainable weights

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        """By a probe of batch 1 on the meta device (shapes, no data)."""
        out = self.fn.apply(torch.empty((1,) + tuple(input_shape[1:]),
                                        dtype=self.input_dtype,
                                        device="meta"))
        first = out[0] if isinstance(out, tuple) else out
        return (None,) + tuple(np.shape(first)[1:])

    def call(self, params, x, **kw):
        out = self.fn.apply(x)
        return out[0] if isinstance(out, tuple) else out
