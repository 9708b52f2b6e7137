"""ONNX importer (port of ``analytics_zoo_tpu.onnx``) — ref
pyzoo/zoo/pipeline/api/onnx (onnx_loader.py + 42 mapper classes under
mapper/).

Each ONNX node maps to a PyTorch expression, and the graph runs as one
function ``apply(params, *inputs)``: eagerly, or as one CUDA graph per
input signature when :meth:`InferenceModel.do_load_onnx
<analytics_zoo_tpu_torch.inference.inference_model.InferenceModel.do_load_onnx>`
serves it. Convolutions and pools run natively in ONNX's NCHW layout with
OIHW kernels (cuDNN on the card); nothing is transposed into the Keras
layers' NHWC.

**Shape chains stay on the host.** A value is *static* when it is a numpy
array or a Python number: the integer initializers, and whatever the
shape ops (``Shape``, ``Gather``, ``Concat``, ``Reshape``, ``Slice``,
``Unsqueeze``, ``ConstantOfShape``, ``Range``, ...) derive from them and
from tensor shapes. Those ops fold static inputs in numpy and read a
tensor's ``shape`` only, never its values, so no shape op synchronises
with the card and a bucket's forward can be captured in a CUDA graph.
A static value that meets a tensor in device arithmetic becomes a device
tensor once per model, device and value (:func:`_t`, cached on the
model; the first, eager call of a bucket creates it before the capture).

**Precision.** ``precision="highest"`` (the default) means IEEE float32
in the imported graph's matmuls and convolutions, as the JAX package's
``jax.default_matmul_precision("highest")``. PyTorch has no per-call
precision: TF32 is governed by the process-wide flags
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``. ``init_nncontext`` turns both off,
and then this module touches nothing. Where a caller has turned either on,
:func:`_ieee_f32` turns them off for the duration of the graph's forward
on the card only, under a lock, and restores them after; a CUDA graph
captured inside that window keeps the IEEE kernels at every replay
whatever the flags later say. Another thread's work launched during that
window also runs IEEE float32 (more precise, never less).
``precision="default"`` leaves the flags as they are.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.onnx.proto import DTYPES, Graph, parse_model

_OPS: Dict[str, Callable] = {}

# the running forward's device and constant cache (per thread: two
# threads may run two models at once)
_ACTIVE = threading.local()
_TF32_LOCK = threading.RLock()


def register(name: str):
    """Decorator registering an ONNX op implementation under its
    operator name in the importer's dispatch table."""
    def deco(fn):
        _OPS[name] = fn
        return fn

    return deco


def _is_static(*xs) -> bool:
    return all(isinstance(x, (np.ndarray, np.generic, int, float)) or x is None
               for x in xs)


def _np(x):
    """A host array of ``x`` (a tensor's values are read from the device:
    never on a shape chain, which stays static)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _t(x, device=None, cache=None):
    """``x`` as a tensor: tensors as they are; a static value as a tensor
    on the running forward's device (float64 made float32, as the JAX
    package's x64-off arrays are), created once per value and device and
    kept in the model's constant cache (``cache``, or the running
    forward's), outside inference mode so that a
    fine-tuning forward may save it for backward."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    dev = device if device is not None else getattr(
        _ACTIVE, "device", torch.device("cpu"))
    if cache is None:
        cache = getattr(_ACTIVE, "consts", None)
    key = (str(dev), arr.dtype.str, arr.shape, arr.tobytes())
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            return hit
    with torch.inference_mode(False):
        out = torch.tensor(arr, device=dev)
    if cache is not None:
        cache[key] = out
    return out


def _pair(a, b):
    """Two operands as tensors, a static one on the other's device."""
    dev = next((v.device for v in (a, b) if isinstance(v, torch.Tensor)),
               None)
    return _t(a, dev), _t(b, dev)


# -- elementwise / math ------------------------------------------------------


def _binary(fn):
    def run(node, ins):
        a, b = ins[0], ins[1]
        if _is_static(a, b):  # folded on the host, as numpy
            return fn(a, b)
        return fn(*_pair(a, b))
    return run


for _op, _fn in [
    ("Add", lambda a, b: a + b), ("Sub", lambda a, b: a - b),
    ("Mul", lambda a, b: a * b), ("Div", lambda a, b: a / b),
    ("Pow", lambda a, b: a ** b),
    ("Equal", lambda a, b: a == b), ("Greater", lambda a, b: a > b),
    ("Less", lambda a, b: a < b),
    ("And", lambda a, b: (np.logical_and(a, b) if _is_static(a, b)
                          else torch.logical_and(a, b))),
    ("Or", lambda a, b: (np.logical_or(a, b) if _is_static(a, b)
                         else torch.logical_or(a, b))),
]:
    _OPS[_op] = _binary(_fn)

for _op, _fn in [
    ("Relu", torch.relu), ("Sigmoid", torch.sigmoid), ("Tanh", torch.tanh),
    ("Exp", torch.exp), ("Log", torch.log), ("Sqrt", torch.sqrt),
    ("Abs", torch.abs), ("Neg", lambda x: -x), ("Floor", torch.floor),
    ("Ceil", torch.ceil), ("Erf", torch.erf),
    ("Softplus", F.softplus), ("Softsign", F.softsign),
    ("Not", torch.logical_not),
    ("Reciprocal", lambda x: 1.0 / x), ("Sign", torch.sign),
    ("Sin", torch.sin), ("Cos", torch.cos),
]:
    _OPS[_op] = (lambda f: lambda node, ins: f(_t(ins[0])))(_fn)


@register("Identity")
def _identity(node, ins):
    return ins[0]


@register("LeakyRelu")
def _leaky(node, ins):
    return F.leaky_relu(_t(ins[0]), node.attrs.get("alpha", 0.01))


@register("Elu")
def _elu(node, ins):
    return F.elu(_t(ins[0]), node.attrs.get("alpha", 1.0))


@register("Selu")
def _selu(node, ins):
    return F.selu(_t(ins[0]))


@register("PRelu")
def _prelu(node, ins):
    x, slope = _pair(ins[0], ins[1])
    return torch.where(x > 0, x, x * slope)


@register("HardSigmoid")
def _hard_sigmoid(node, ins):
    a, b = node.attrs.get("alpha", 0.2), node.attrs.get("beta", 0.5)
    return torch.clamp(a * _t(ins[0]) + b, 0.0, 1.0)


@register("Clip")
def _clip(node, ins):
    x = _t(ins[0])
    lo = node.attrs.get("min", ins[1] if len(ins) > 1 and ins[1] is not None
                        else None)
    hi = node.attrs.get("max", ins[2] if len(ins) > 2 and ins[2] is not None
                        else None)

    def bound(v):  # an attribute's float, or a (static or device) tensor
        if isinstance(v, float):
            return torch.full((), v, dtype=x.dtype, device=x.device)
        return _t(v, x.device).to(x.dtype)

    # max(x, lo), then min(., hi): the jnp.clip order
    if lo is not None:
        x = torch.maximum(x, bound(lo))
    if hi is not None:
        x = torch.minimum(x, bound(hi))
    return x


@register("Softmax")
def _softmax(node, ins):
    return torch.softmax(_t(ins[0]), dim=node.attrs.get("axis", -1))


@register("LogSoftmax")
def _log_softmax(node, ins):
    return torch.log_softmax(_t(ins[0]), dim=node.attrs.get("axis", -1))


def _tensors(ins):
    dev = next((v.device for v in ins if isinstance(v, torch.Tensor)), None)
    return [_t(v, dev) for v in ins]


@register("Max")
def _max(node, ins):
    return functools.reduce(torch.maximum, _tensors(ins))


@register("Min")
def _min(node, ins):
    return functools.reduce(torch.minimum, _tensors(ins))


@register("Sum")
def _sum(node, ins):
    return functools.reduce(lambda a, b: a + b, _tensors(ins))


@register("Mean")
def _mean(node, ins):
    return functools.reduce(lambda a, b: a + b, _tensors(ins)) / len(ins)


@register("Where")
def _where(node, ins):
    c, a, b = _tensors(ins)
    return torch.where(c, a, b)


def _torch_dtype(code: int) -> torch.dtype:
    dt = np.dtype(DTYPES[code])
    if dt == np.float64:
        return torch.float32  # as the JAX package's x64-off arrays
    return torch.from_numpy(np.zeros(0, dt)).dtype


@register("Cast")
def _cast(node, ins):
    if _is_static(ins[0]):
        return _np(ins[0]).astype(DTYPES[node.attrs["to"]])
    return ins[0].to(_torch_dtype(node.attrs["to"]))


# -- reductions --------------------------------------------------------------


def _reduce(kind):
    def run(node, ins):
        axes = node.attrs.get("axes")
        if axes is None and len(ins) > 1 and ins[1] is not None:
            axes = [int(a) for a in _np(ins[1])]
        keep = bool(node.attrs.get("keepdims", 1))
        x = _t(ins[0])
        dims = (tuple(range(x.dim())) if axes is None
                else tuple(a % x.dim() for a in axes))
        if kind == "prod":
            for d in sorted(dims, reverse=True):
                x = torch.prod(x, dim=d, keepdim=keep)
            return x
        if kind == "mean":
            return torch.mean(x, dim=dims, keepdim=keep)
        if kind == "sum":
            return torch.sum(x, dim=dims, keepdim=keep)
        fn = torch.amax if kind == "max" else torch.amin
        return fn(x, dim=dims, keepdim=keep)

    return run


_OPS["ReduceMean"] = _reduce("mean")
_OPS["ReduceSum"] = _reduce("sum")
_OPS["ReduceMax"] = _reduce("max")
_OPS["ReduceMin"] = _reduce("min")
_OPS["ReduceProd"] = _reduce("prod")


def _arg(fn):
    def run(node, ins):
        ax = node.attrs.get("axis", 0)
        return fn(_t(ins[0]), dim=ax,
                  keepdim=bool(node.attrs.get("keepdims", 1)))
    return run


_OPS["ArgMax"] = _arg(torch.argmax)
_OPS["ArgMin"] = _arg(torch.argmin)


# -- shape ops (folded on the host where their inputs are static) ------------


@register("Shape")
def _shape(node, ins):
    return np.asarray(tuple(ins[0].shape), np.int64)


@register("Reshape")
def _reshape(node, ins):
    shape = node.attrs.get("shape")
    if shape is None:
        shape = [int(s) for s in _np(ins[1])]
    x = ins[0]
    # ONNX semantics: 0 means "copy input dim"
    shape = [x.shape[i] if s == 0 else int(s) for i, s in enumerate(shape)]
    return (x.reshape(shape) if not _is_static(x)
            else _np(x).reshape(shape))


@register("Flatten")
def _flatten(node, ins):
    ax = node.attrs.get("axis", 1)
    x = ins[0]
    lead = int(np.prod(x.shape[:ax])) if ax else 1
    return x.reshape(lead, -1)


@register("Transpose")
def _transpose(node, ins):
    perm = node.attrs.get("perm")
    x = ins[0]
    if perm is None:
        perm = list(range(x.ndim))[::-1]
    return x.permute(*perm) if not _is_static(x) else _np(x).transpose(perm)


@register("Concat")
def _concat(node, ins):
    ax = node.attrs["axis"]
    if _is_static(*ins):
        return np.concatenate([_np(i) for i in ins], axis=ax)
    return torch.cat(_tensors(ins), dim=ax)


@register("Split")
def _split(node, ins):
    ax = node.attrs.get("axis", 0)
    splits = node.attrs.get("split")
    if splits is None and len(ins) > 1 and ins[1] is not None:
        splits = [int(s) for s in _np(ins[1])]
    x = _t(ins[0])
    if splits is None:
        n = len(node.outputs)
        if x.shape[ax] % n:
            raise ValueError(
                f"Split: axis {ax} of size {x.shape[ax]} does not divide "
                f"into {n} equal parts")
        return tuple(torch.split(x, x.shape[ax] // n, dim=ax))
    return tuple(torch.split(x, [int(s) for s in splits], dim=ax))


@register("Squeeze")
def _squeeze(node, ins):
    axes = node.attrs.get("axes")
    if axes is None and len(ins) > 1 and ins[1] is not None:
        axes = [int(a) for a in _np(ins[1])]
    x = ins[0]
    if _is_static(x):
        return np.squeeze(_np(x), axis=tuple(axes) if axes else None)
    return torch.squeeze(x, tuple(axes)) if axes else torch.squeeze(x)


@register("Unsqueeze")
def _unsqueeze(node, ins):
    axes = node.attrs.get("axes")
    if axes is None:
        axes = [int(a) for a in _np(ins[1])]
    x = ins[0]
    for a in sorted(axes):
        x = (np.expand_dims(x, a) if _is_static(x)
             else torch.unsqueeze(x, a))
    return x


def _slice_axis(x, ax: int, sl: slice):
    """``x`` sliced along ``ax`` by a Python slice, a negative step
    included (PyTorch's indexing takes positive steps only)."""
    n = x.shape[ax]
    r = range(*sl.indices(n))
    if r.step > 0:
        return x[(slice(None),) * ax + (slice(r.start, r.stop, r.step),)]
    if not len(r):
        return x.narrow(ax, 0, 0)
    start = n - 1 - r.start  # the same elements on the flipped axis
    return x.flip(ax)[(slice(None),) * ax
                      + (slice(start, start + len(r) * -r.step, -r.step),)]


@register("Slice")
def _slice(node, ins):
    x = ins[0]
    if "starts" in node.attrs:   # opset-9 style
        starts = node.attrs["starts"]
        ends = node.attrs["ends"]
        axes = node.attrs.get("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    else:                        # opset-10+: tensor inputs
        starts = [int(v) for v in _np(ins[1])]
        ends = [int(v) for v in _np(ins[2])]
        axes = ([int(v) for v in _np(ins[3])] if len(ins) > 3
                and ins[3] is not None else list(range(len(starts))))
        steps = ([int(v) for v in _np(ins[4])] if len(ins) > 4
                 and ins[4] is not None else [1] * len(starts))
    if _is_static(x):
        sl = [slice(None)] * np.ndim(x)
        for st, en, ax, sp in zip(starts, ends, axes, steps):
            sl[ax] = slice(st, None if en >= 2 ** 31 - 1 else en, sp)
        return _np(x)[tuple(sl)]
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        x = _slice_axis(x, ax % x.dim(),
                        slice(st, None if en >= 2 ** 31 - 1 else en, sp))
    return x


@register("Gather")
def _gather(node, ins):
    ax = node.attrs.get("axis", 0)
    x, idx = ins
    if _is_static(x, idx):
        return np.take(_np(x), _np(idx).astype(np.int64), axis=ax)
    x = _t(x)
    ax %= x.dim()
    n = x.shape[ax]
    if _is_static(idx):
        flat = _np(idx).astype(np.int64)
        shape = flat.shape
        flat = _t(np.where(flat < 0, flat + n, flat).reshape(-1), x.device)
    else:
        shape = tuple(idx.shape)
        flat = idx.reshape(-1).long()
        flat = torch.where(flat < 0, flat + n, flat)
    out = torch.index_select(x, ax, flat)
    return out.reshape(tuple(x.shape[:ax]) + tuple(shape)
                       + tuple(x.shape[ax + 1:]))


@register("Expand")
def _expand(node, ins):
    shape = [int(s) for s in _np(ins[1])]
    x = _t(ins[0])
    # ONNX Expand broadcasts; shape entries of 1 keep the input dim
    tgt = list(np.broadcast_shapes(tuple(x.shape), tuple(shape)))
    return torch.broadcast_to(x, tgt)


@register("Tile")
def _tile(node, ins):
    reps = [int(r) for r in _np(ins[1])]
    return torch.tile(_t(ins[0]), reps)


@register("Pad")
def _pad(node, ins):
    mode = node.attrs.get("mode", b"constant").decode() \
        if isinstance(node.attrs.get("mode"), bytes) else "constant"
    pads = node.attrs.get("pads")
    if pads is None:
        pads = [int(v) for v in _np(ins[1])]
    value = node.attrs.get("value", 0.0)
    if len(ins) > 2 and ins[2] is not None:
        value = (ins[2].reshape(()) if isinstance(ins[2], torch.Tensor)
                 else float(_np(ins[2])))
    x = _t(ins[0])
    half = len(pads) // 2
    width = [(int(pads[i]), int(pads[i + half])) for i in range(half)]
    if mode == "constant":
        flat = [p for w in reversed(width) for p in w]  # last axis first
        if isinstance(value, torch.Tensor):
            # a device pad value: pad with 0, then fill the border, with
            # no read of the value on the host
            inside = F.pad(torch.ones_like(x, dtype=torch.bool), flat,
                           value=False)
            return torch.where(inside, F.pad(x, flat, value=0.0),
                               value.to(x.dtype))
        return F.pad(x, flat, value=float(value))
    np_mode = {"reflect": "reflect", "edge": "edge"}[mode]
    for ax, (lo, hi) in enumerate(width):
        if lo or hi:  # numpy's index pattern of the mode along this axis
            idx = np.pad(np.arange(x.shape[ax]), (lo, hi), mode=np_mode)
            x = torch.index_select(x, ax, _t(idx, x.device))
    return x


@register("Constant")
def _constant(node, ins):
    for key in ("value", "value_float", "value_int", "value_floats",
                "value_ints"):
        if key in node.attrs:
            return np.asarray(node.attrs[key])
    raise ValueError("Constant node with no value attribute")


@register("ConstantOfShape")
def _constant_of_shape(node, ins):
    shape = [int(s) for s in _np(ins[0])]
    val = node.attrs.get("value")
    if val is None:
        return np.zeros(shape, np.float32)
    return np.full(shape, _np(val).ravel()[0], _np(val).dtype)


@register("Range")
def _range(node, ins):
    start, limit, delta = (_np(i).ravel()[0] for i in ins)
    return np.arange(start, limit, delta)


@register("Dropout")
def _dropout(node, ins):
    return ins[0]   # inference semantics


# -- linear / matmul ---------------------------------------------------------


@register("MatMul")
def _matmul(node, ins):
    a, b = _pair(ins[0], ins[1])
    return torch.matmul(a, b)


@register("Gemm")
def _gemm(node, ins):
    a, b = _pair(ins[0], ins[1])
    if node.attrs.get("transA", 0):
        a = a.T
    if node.attrs.get("transB", 0):
        b = b.T
    out = node.attrs.get("alpha", 1.0) * (a @ b)
    if len(ins) > 2 and ins[2] is not None:
        out = out + node.attrs.get("beta", 1.0) * _t(ins[2], out.device)
    return out


# -- conv / pool / norm (NCHW native) ----------------------------------------


def _conv_pads(node, spatial_rank: int, x_shape, k_shape, strides, dilations):
    auto = node.attrs.get("auto_pad", b"NOTSET")
    auto = auto.decode() if isinstance(auto, bytes) else auto
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        pads = []
        for i in range(spatial_rank):
            in_dim = x_shape[2 + i]
            eff_k = (k_shape[i] - 1) * dilations[i] + 1
            out_dim = -(-in_dim // strides[i])
            total = max(0, (out_dim - 1) * strides[i] + eff_k - in_dim)
            a, b = total // 2, total - total // 2
            pads.append((b, a) if auto == "SAME_LOWER" else (a, b))
        return pads
    p = node.attrs.get("pads", [0] * (2 * spatial_rank))
    return [(p[i], p[i + spatial_rank]) for i in range(spatial_rank)]


def _spatial_pad(x, pads, value=0.0):
    """``x`` (N, C, spatial...) padded by per-axis (before, after)."""
    if not any(a or b for a, b in pads):
        return x
    return F.pad(x, [p for w in reversed(pads) for p in w], value=value)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _bias(out, b, rank):
    return out + _t(b, out.device).reshape((1, -1) + (1,) * rank)


@register("Conv")
def _conv(node, ins):
    x, w = _pair(ins[0], ins[1])
    rank = w.dim() - 2
    strides = node.attrs.get("strides", [1] * rank)
    dilations = node.attrs.get("dilations", [1] * rank)
    group = node.attrs.get("group", 1)
    pads = _conv_pads(node, rank, x.shape, w.shape[2:], strides, dilations)
    if all(a == b for a, b in pads):
        out = _CONV[rank](x, w, None, stride=tuple(strides),
                          padding=tuple(a for a, _ in pads),
                          dilation=tuple(dilations), groups=group)
    else:
        out = _CONV[rank](_spatial_pad(x, pads), w, None,
                          stride=tuple(strides), dilation=tuple(dilations),
                          groups=group)
    if len(ins) > 2 and ins[2] is not None:
        out = _bias(out, ins[2], rank)
    return out


@register("ConvTranspose")
def _conv_transpose(node, ins):
    x, w = _pair(ins[0], ins[1])   # w: (C_in, C_out/group, k...)
    rank = w.dim() - 2
    strides = node.attrs.get("strides", [1] * rank)
    pads = node.attrs.get("pads", [0] * (2 * rank))
    group = node.attrs.get("group", 1)
    if group != 1:
        raise NotImplementedError("grouped ConvTranspose")
    if node.attrs.get("output_shape"):
        raise NotImplementedError("ConvTranspose output_shape attribute")
    out_pad = node.attrs.get("output_padding", [0] * rank)
    # the full transposed convolution, then the ONNX crop: ``pads`` off
    # each side, ``output_padding`` back on the high side (zeros past the
    # full output; the JAX package's lhs-dilated form computes the same)
    out = _CONV_T[rank](x, w, None, stride=tuple(strides))
    for i in range(rank):
        ax = 2 + i
        lo, hi = pads[i], pads[i + rank] - out_pad[i]
        if hi < 0:
            out = F.pad(out, [0, 0] * (rank - 1 - i) + [0, -hi])
            hi = 0
        out = out.narrow(ax, lo, out.shape[ax] - lo - hi)
    if len(ins) > 2 and ins[2] is not None:
        out = _bias(out, ins[2], rank)
    return out


def _window_sum(x, k, strides):
    """Sums over (k, strides) windows of (N, C, spatial...) ``x``."""
    rank = len(k)
    if rank == 1:
        return F.avg_pool2d(x.unsqueeze(2), (1, k[0]), (1, strides[0]),
                            divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if rank == 2 else F.avg_pool3d
    return pool(x, tuple(k), tuple(strides), divisor_override=1)


def _pool(node, ins, average=False):
    x = _t(ins[0])
    k = node.attrs["kernel_shape"]
    rank = len(k)
    strides = node.attrs.get("strides", [1] * rank)
    pads = _conv_pads(node, rank, x.shape, k, strides, [1] * rank)
    if not average:
        pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[rank]
        return pool(_spatial_pad(x, pads, -float("inf")), tuple(k),
                    tuple(strides))
    sums = _window_sum(_spatial_pad(x, pads), k, strides)
    if not node.attrs.get("count_include_pad", 0):
        return sums / _window_sum(_spatial_pad(torch.ones_like(x), pads), k,
                                  strides)
    return sums / float(np.prod(k))


@register("MaxPool")
def _maxpool(node, ins):
    return _pool(node, ins)


@register("AveragePool")
def _avgpool(node, ins):
    return _pool(node, ins, average=True)


@register("GlobalAveragePool")
def _gap(node, ins):
    x = _t(ins[0])
    return torch.mean(x, dim=tuple(range(2, x.dim())), keepdim=True)


@register("GlobalMaxPool")
def _gmp(node, ins):
    x = _t(ins[0])
    return torch.amax(x, dim=tuple(range(2, x.dim())), keepdim=True)


@register("BatchNormalization")
def _batchnorm(node, ins):
    x, scale, bias, mean, var = _tensors(ins[:5])
    eps = node.attrs.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = 1.0 / torch.sqrt(var + eps)
    return (x - mean.reshape(shape)) * (scale * inv).reshape(shape) + \
        bias.reshape(shape)


@register("InstanceNormalization")
def _instancenorm(node, ins):
    x, scale, bias = _tensors(ins)
    eps = node.attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, unbiased=False, keepdim=True)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mean) / torch.sqrt(var + eps) * scale.reshape(shape) + \
        bias.reshape(shape)


@register("LRN")
def _lrn(node, ins):
    x = _t(ins[0])
    size = node.attrs["size"]
    alpha = node.attrs.get("alpha", 1e-4)
    beta = node.attrs.get("beta", 0.75)
    bias = node.attrs.get("bias", 1.0)
    sq = torch.square(x)
    half = size // 2
    # channel-window sums: zero-pad the channel axis, sum each window
    padded = F.pad(sq.movedim(1, -1), (half, size - 1 - half))
    summed = padded.unfold(-1, size, 1).sum(-1).movedim(-1, 1)
    return x / (bias + alpha / size * summed) ** beta


# -- model -------------------------------------------------------------------


@contextlib.contextmanager
def _ieee_f32(device: torch.device):
    """IEEE float32 matmuls and convolutions on the card for the duration
    of the block (see the module docstring): nothing is touched when the
    TF32 flags are already off or the device is not a card."""
    if device.type != "cuda" or not (torch.backends.cuda.matmul.allow_tf32
                                     or torch.backends.cudnn.allow_tf32):
        yield
        return
    with _TF32_LOCK:
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved


class OnnxModel:
    """Executable imported graph: ``model(x, ...)`` or ``model.predict``.

    ``params`` (the ONNX initializers, host arrays) are exposed so the
    imported network can be fine-tuned: ``apply(params, *inputs)`` takes
    tensors that require grad and is differentiable.
    """

    def __init__(self, graph: Graph, precision: str = "highest"):
        # "highest": IEEE float32 in matmuls and convolutions (see the
        # module docstring) — an importer's first job is output fidelity;
        # "default" trades that back for speed where TF32 is allowed.
        self.precision = precision
        self.graph = graph
        missing = sorted({n.op_type for n in graph.nodes} - set(_OPS))
        if missing:
            raise NotImplementedError(
                f"unsupported ONNX ops: {missing} (supported: {len(_OPS)})")
        self.params = {k: np.asarray(v) for k, v in graph.initializers.items()}
        self.input_names = [name for name, _ in graph.inputs
                            if name not in graph.initializers]
        self.output_names = list(graph.outputs)
        self._consts: Dict = {}  # static values placed on a device
        self._placed: Dict[str, Dict[str, Any]] = {}  # device -> params

    def _device_of(self, params, inputs) -> torch.device:
        for v in list(inputs) + list(params.values()):
            if isinstance(v, torch.Tensor):
                return v.device
        return torch.device("cpu")

    def apply(self, params: Dict[str, Any], *inputs):
        """Forward over the imported graph: ``(params, *inputs) ->
        outputs``. ``params`` maps initializer names to tensors (trained
        or served) or host arrays (static)."""
        device = self._device_of(params, inputs)
        prev = (getattr(_ACTIVE, "device", None),
                getattr(_ACTIVE, "consts", None))
        _ACTIVE.device, _ACTIVE.consts = device, self._consts
        try:
            with (_ieee_f32(device) if self.precision == "highest"
                  else contextlib.nullcontext()):
                values: Dict[str, Any] = dict(params)
                for name, x in zip(self.input_names, inputs):
                    values[name] = x
                for node in self.graph.nodes:
                    ins = [values[i] if i else None for i in node.inputs]
                    out = _OPS[node.op_type](node, ins)
                    outs = out if isinstance(out, tuple) else (out,)
                    for name, val in zip(node.outputs, outs):
                        if name:
                            values[name] = val
                res = tuple(values[o] for o in self.output_names)
        finally:
            _ACTIVE.device, _ACTIVE.consts = prev
        return res if len(res) > 1 else res[0]

    def device_params(self, device) -> Dict[str, Any]:
        """The initializers for a forward on ``device``: floating ones as
        tensors there (made once), integer ones as host arrays, so the
        shape chains they drive stay static."""
        key = str(torch.device(device))
        placed = self._placed.get(key)
        if placed is None:
            placed = {k: (v if not np.issubdtype(v.dtype, np.floating)
                          else torch.tensor(
                              v.astype(np.float32) if v.dtype == np.float64
                              else v, device=device))
                      for k, v in self.params.items()}
            self._placed[key] = placed
        return placed

    def __call__(self, *inputs):
        """Forward of device tensors (or host arrays, placed on the
        context's device) with the model's own initializers."""
        from analytics_zoo_tpu_torch.common.nncontext import (
            get_nncontext,
            host_to_device,
        )

        dev = next((x.device for x in inputs if isinstance(x, torch.Tensor)),
                   None) or get_nncontext().device
        xs = [x if isinstance(x, torch.Tensor) else host_to_device(x, dev)
              for x in inputs]
        with torch.inference_mode():
            return self.apply(self.device_params(dev), *xs)

    def predict(self, *inputs):
        """Host-convenience forward: ndarrays in, ndarrays out."""
        out = self(*inputs)
        if isinstance(out, tuple):
            return tuple(_np(o) for o in out)
        return _np(out)


def load_model_bytes(buf: bytes) -> OnnxModel:
    """Parse serialized ONNX ModelProto bytes into an OnnxModel (own
    proto parser — no onnx package dependency)."""
    return OnnxModel(parse_model(buf))


def load_model(path: str) -> OnnxModel:
    """Ref onnx_loader.py load entry — path to a .onnx file."""
    with open(path, "rb") as f:
        return load_model_bytes(f.read())


def supported_ops() -> List[str]:
    """Sorted list of the ONNX operator types the importer handles."""
    return sorted(_OPS)
