"""Post-training static (activation) int8 quantization (port of
``analytics_zoo_tpu.inference.calibration``).

A calibration pass records each Dense/Conv2D input's absmax over
representative batches; inference then runs

    y_i32 = dot/conv(int8(x / s_x), int8(W / s_w))      # integer MACs
    y     = y_i32 * (s_x * s_w) + b                     # one rescale

with per-tensor activation scales and per-output-channel weight scales.
The integer products are :mod:`analytics_zoo_tpu_torch.ops.int8`'s
(``torch._int_mm``: cuBLASLt's int8 GEMM on the card), never a float
matmul or convolution.

Mechanism, as in the JAX package: target layers are instrumented in
place with a conditional ``call``. With float kernels (the original
model) the wrapper delegates to the layer's own ``call``, so the float
path is untouched. With a calibrated qleaf kernel (the
``InferenceModel``'s copy of the params) it runs the integer path. One
layer object serves both the f32 model and the calibrated
InferenceModel, whatever the topology; the activation scale rides in the
params (the qleaf's ``act_scale``), so two InferenceModels calibrated on
different data keep their own scales.

A calibration pass records only its own forwards: the wrapper reads the
absmax table of the thread that runs :func:`calibrate_activations`, so
another model's predict or fit through the same layer objects meanwhile
(an eager call in the port, which has no trace to tell it apart) leaves
this model's scales alone.

Dtypes follow JAX's promotion: under bf16 compute an integer layer's f32
rescale meets a bf16 bias and returns float32, so the layers after it
(a ResNet's batch norms) run in float32.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Sequence

import torch

from analytics_zoo_tpu_torch.common.tree import tree_leaves
from analytics_zoo_tpu_torch.inference.inference_model import (
    _is_qleaf,
    _quantize_leaf,
    _to_device_tree,
)
from analytics_zoo_tpu_torch.ops.int8 import int8_conv2d, int8_dense


def _quantizable(layer) -> bool:
    from analytics_zoo_tpu_torch.keras.layers.convolutional import _ConvND
    from analytics_zoo_tpu_torch.keras.layers.core import Dense

    # Dense (any rank: the integer dot contracts the last dim like the
    # float path) and 2-D convolutions, Atrous included. 1-D/3-D and
    # depthwise convolutions stay float, as in the JAX package.
    return isinstance(layer, Dense) or (
        isinstance(layer, _ConvND) and layer.rank == 2)


def _quantize_input(x, s_x):
    """``int8(clip(round(f32(x) / s_x), -127, 127))``, rounding half to
    even as ``jnp.round`` does."""
    return torch.clamp(torch.round(x.float() / s_x), -127,
                       127).to(torch.int8)


def _int_dense(layer, params, x, record=None):
    q = params["kernel"]
    s_x = q["act_scale"]
    xq = _quantize_input(x, s_x)
    acc = int8_dense(xq, q["__q8__"])
    if record is not None:
        record[layer.name] = (x, xq, acc)
    # the weight scale is keepdims (1, out): it collapses onto the last dim
    y = acc.float() * (s_x * q["scale"].reshape(-1))
    if layer.bias:
        y = y + params["bias"]
    return layer.activation(y)


def _int_conv2d(layer, params, x, record=None):
    from analytics_zoo_tpu_torch.keras.layers.convolutional import (
        _same_pads,
        _spatial,
    )

    q = params["kernel"]
    s_x = q["act_scale"]
    xq = _quantize_input(x, s_x)
    kernel = tuple(q["__q8__"].shape[:2])
    pads = (_same_pads(_spatial(x, layer.dim_ordering), kernel,
                       layer.subsample, layer.dilation)
            if layer.border_mode == "same" else [(0, 0), (0, 0)])
    acc = int8_conv2d(xq, q["__q8__"], layer.subsample, layer.dilation, pads,
                      layer.dim_ordering)
    if record is not None:
        record[layer.name] = (x, xq, acc)
    scale = s_x * q["scale"].reshape(-1)  # per output channel
    cshape = ((1, -1, 1, 1) if layer.dim_ordering == "th" else (1, 1, 1, -1))
    y = acc.float() * scale.reshape(cshape)
    if layer.bias:
        b = params["bias"]
        y = y + (b.reshape(cshape) if layer.dim_ordering == "th" else b)
    return layer.activation(y)


# The absmax table of the calibration pass running in this thread (unset
# outside calibrate_activations).
_RECORDING = threading.local()


def _install_wrapper(layer) -> None:
    """Instance-level conditional call: the integer path iff the kernel
    arrives as a calibrated qleaf; otherwise the layer's own ``call``, its
    input's absmax first recorded when this thread runs a calibration
    pass. The activation scale rides in the params (the qleaf's
    ``act_scale``), not in this wrapper: several InferenceModels may
    calibrate the same layer objects against different data, and each
    one's params carry its own scales. ``layer._int8_record``, when a
    dict, receives each integer call's float input, int8 input and int32
    accumulator under the layer's name (the probe that tests and the
    card-against-CPU check read). Installed once per layer."""
    from analytics_zoo_tpu_torch.keras.layers.core import Dense

    if getattr(layer, "_calib_orig_call", None) is not None:
        return
    orig = layer.call
    int_fn = _int_dense if isinstance(layer, Dense) else _int_conv2d

    def call(params, x, **kw):
        k = params.get("kernel")
        if _is_qleaf(k) and "act_scale" in k:
            return int_fn(layer, params, x,
                          getattr(layer, "_int8_record", None))
        absmax = getattr(_RECORDING, "absmax", None)
        if absmax is not None and layer.name in absmax:
            m = float(x.abs().max())
            if m > absmax[layer.name]:
                absmax[layer.name] = m
        return orig(params, x, **kw)

    layer._calib_orig_call = orig
    layer.call = call


def calibrate_activations(model, params, model_state,
                          batches: Sequence[Any]) -> Dict[str, float]:
    """Run representative batches through ``model.apply`` on the given
    (uncast float32) params, recording each quantizable layer's input
    absmax. Returns ``{layer_name: scale}``: ``absmax / 127`` in Python
    float (1.0 for an all-zero input)."""
    targets = [l for l in model.layers() if _quantizable(l)]
    if not targets:
        raise ValueError("calibration: model has no Dense/Convolution2D "
                         "layers to quantize")
    absmax: Dict[str, float] = {l.name: 0.0 for l in targets}
    device = next(iter(tree_leaves(params)), torch.empty(0)).device
    for l in targets:
        _install_wrapper(l)
    _RECORDING.absmax = absmax
    try:
        with torch.inference_mode():
            for batch in batches:
                x = _to_device_tree(
                    list(batch) if isinstance(batch, (list, tuple))
                    else batch, device)
                model.apply(params, model_state, x, training=False, rng=None)
    finally:
        _RECORDING.absmax = None
    # symmetric per-tensor scale, computed in Python float from the f32
    # absmax; an all-zero calibration set falls back to 1.0
    return {name: (m / 127.0 if m > 0 else 1.0)
            for name, m in absmax.items()}


def apply_calibration(model, params, scales: Dict[str, float]):
    """Install the integer-path wrappers and return params with the target
    kernels quantized per output channel, each carrying its layer's
    activation scale as a float32 scalar."""
    new_params = dict(params)
    for layer in model.layers():
        if not _quantizable(layer) or layer.name not in scales:
            continue
        _install_wrapper(layer)
        p = dict(new_params.get(layer.name, {}))
        if "kernel" in p and not _is_qleaf(p["kernel"]):
            q = dict(_quantize_leaf(p["kernel"], -1))
            q["act_scale"] = torch.tensor(scales[layer.name],
                                          dtype=torch.float32,
                                          device=q["scale"].device)
            p["kernel"] = q
        new_params[layer.name] = p
    return new_params
