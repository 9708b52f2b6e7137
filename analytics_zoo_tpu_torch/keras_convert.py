"""tf.keras / Keras-3 model -> zoo model ARCHITECTURE conversion (port of
``analytics_zoo_tpu.keras_convert``).

Ref: the reference's TFPark ``KerasModel`` (pyzoo/zoo/tfpark/model.py:31)
wraps a live, compiled **tf.keras model** and trains it on the BigDL engine
— the user brings someone else's model object, not a zoo one. The weight
half of that story is :func:`analytics_zoo_tpu_torch.keras_import.
load_keras_weights` (HDF5 weights poured into a built zoo model); this
module is the architecture half: parse ``model.get_config()`` (or a
``to_json()`` file, or a whole-model HDF5's ``model_config``) into the
equivalent zoo ``Sequential``/``Model`` graph and copy the live weights
over, so ``tfpark.KerasModel(tf_keras_model)`` is a real converter.

The conversion needs neither TensorFlow nor h5py: a config is plain JSON.
Only :func:`convert_keras_model` and :func:`copy_keras_weights` read a live
keras model (its ``get_config()`` and its weights).

Both config dialects in the wild are handled:

- classic tf.keras / Keras 2: ``batch_input_shape``, inbound nodes as
  ``[[name, node_idx, tensor_idx, kwargs], ...]``;
- Keras 3: ``batch_shape``, inbound nodes as call ``args`` trees with
  ``__keras_tensor__`` markers carrying ``keras_history``.

Scope: the Sequential and functional graphs the reference's tfpark
examples use (dense/conv/pool/BN/embedding/recurrent/merge cores), plus
shared layers (tied weights — one zoo instance applied per call site),
timestep-masked models, and self/cross MultiHeadAttention (the zoo layer,
whose attention runs on the flash kernels on the card). Multi-output
layers and Lambda layers raise — a Lambda's python body is not
recoverable from a config. Where Keras and the JAX package differ (the
``gelu`` activation is the tanh approximation in both packages, the exact
erf form in Keras), the port follows the JAX package.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.keras_import import _convert, apply_weight_imports

logger = logging.getLogger("analytics_zoo_tpu_torch")


# ---------------------------------------------------------------------------
# config helpers (both dialects)
# ---------------------------------------------------------------------------


def _cfg_activation(cfg: Dict, key: str = "activation") -> Optional[str]:
    a = cfg.get(key, "linear")
    if isinstance(a, dict):  # serialized Activation object
        a = (a.get("config") or {}).get("name") or a.get("class_name", "linear")
    if a is None:
        return None
    a = str(a).lower()
    return None if a == "linear" else a


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return int(v[0]), int(v[1] if len(v) > 1 else v[0])
    return int(v), int(v)


def _scalar(v) -> int:
    if isinstance(v, (list, tuple)):
        return int(v[0])
    return int(v)


def _channels_last(cfg: Dict, what: str) -> None:
    df = cfg.get("data_format") or "channels_last"
    if df != "channels_last":
        raise NotImplementedError(
            f"{what} '{cfg.get('name')}': data_format={df!r} is not "
            "supported (convert the source model to channels_last)")


def _bn_axis_ok(cfg: Dict, what: str = "BatchNormalization") -> None:
    ax = cfg.get("axis", -1)
    if isinstance(ax, (list, tuple)):
        ax = ax[0] if len(ax) == 1 else ax
    if ax not in (-1, 3, None):  # 3 == last on NHWC
        raise NotImplementedError(
            f"{what} '{cfg.get('name')}': axis={ax} — only the "
            "channels_last axis (-1) is supported")


def _input_shape_of(cfg: Dict) -> Optional[Tuple]:
    bs = cfg.get("batch_shape") or cfg.get("batch_input_shape")
    if bs is None:
        return None
    return tuple(bs[1:])


# ---------------------------------------------------------------------------
# per-class builders: keras layer config -> zoo layer
# ---------------------------------------------------------------------------


def _mk_dense(cfg, L):
    return L.Dense(int(cfg["units"]), activation=_cfg_activation(cfg),
                   bias=bool(cfg.get("use_bias", True)), name=cfg["name"])


def _mk_conv2d(cfg, L):
    _channels_last(cfg, "Conv2D")
    kh, kw = _pair(cfg["kernel_size"])
    lay = L.Convolution2D(
        int(cfg["filters"]), kh, kw, subsample=_pair(cfg.get("strides", 1)),
        border_mode=cfg.get("padding", "valid"), dim_ordering="tf",
        activation=_cfg_activation(cfg), bias=bool(cfg.get("use_bias", True)),
        dilation=_pair(cfg.get("dilation_rate", 1)), name=cfg["name"])
    return lay


def _mk_conv1d(cfg, L):
    _channels_last(cfg, "Conv1D")
    return L.Convolution1D(
        int(cfg["filters"]), _scalar(cfg["kernel_size"]),
        subsample_length=_scalar(cfg.get("strides", 1)),
        border_mode=cfg.get("padding", "valid"),
        activation=_cfg_activation(cfg), bias=bool(cfg.get("use_bias", True)),
        dilation=_scalar(cfg.get("dilation_rate", 1)), name=cfg["name"])


def _mk_conv3d(cfg, L):
    _channels_last(cfg, "Conv3D")
    ks = [int(k) for k in cfg["kernel_size"]]
    st = cfg.get("strides", 1)
    st = [int(s) for s in st] if isinstance(st, (list, tuple)) else [int(st)] * 3
    return L.Convolution3D(
        int(cfg["filters"]), *ks, subsample=tuple(st),
        border_mode=cfg.get("padding", "valid"), dim_ordering="tf",
        activation=_cfg_activation(cfg), bias=bool(cfg.get("use_bias", True)),
        name=cfg["name"])


def _mk_dwconv2d(cfg, L):
    _channels_last(cfg, "DepthwiseConv2D")
    return L.DepthwiseConvolution2D(
        kernel_size=_pair(cfg["kernel_size"]),
        subsample=_pair(cfg.get("strides", 1)),
        depth_multiplier=int(cfg.get("depth_multiplier", 1)),
        border_mode=cfg.get("padding", "valid"), dim_ordering="tf",
        activation=_cfg_activation(cfg), bias=bool(cfg.get("use_bias", True)),
        name=cfg["name"])


def _mk_sepconv2d(cfg, L):
    _channels_last(cfg, "SeparableConv2D")
    kh, kw = _pair(cfg["kernel_size"])
    return L.SeparableConvolution2D(
        int(cfg["filters"]), kh, kw, subsample=_pair(cfg.get("strides", 1)),
        depth_multiplier=int(cfg.get("depth_multiplier", 1)),
        border_mode=cfg.get("padding", "valid"), dim_ordering="tf",
        activation=_cfg_activation(cfg), bias=bool(cfg.get("use_bias", True)),
        name=cfg["name"])


def _mk_pool2d(kind):
    def make(cfg, L):
        _channels_last(cfg, kind)
        cls = L.MaxPooling2D if kind == "MaxPooling2D" else L.AveragePooling2D
        strides = cfg.get("strides")
        return cls(pool_size=_pair(cfg.get("pool_size", 2)),
                   strides=None if strides is None else _pair(strides),
                   border_mode=cfg.get("padding", "valid"),
                   dim_ordering="tf", name=cfg["name"])
    return make


def _mk_pool1d(kind):
    def make(cfg, L):
        _channels_last(cfg, kind)
        cls = L.MaxPooling1D if kind == "MaxPooling1D" else L.AveragePooling1D
        stride = cfg.get("strides")
        return cls(pool_length=_scalar(cfg.get("pool_size", 2)),
                   stride=None if stride is None else _scalar(stride),
                   border_mode=cfg.get("padding", "valid"), name=cfg["name"])
    return make


def _mk_global_pool(zoo_name):
    def make(cfg, L):
        if cfg.get("keepdims"):
            raise NotImplementedError(
                f"{zoo_name} '{cfg.get('name')}': keepdims=True")
        _channels_last(cfg, zoo_name)
        kw = {"name": cfg["name"]}
        if zoo_name.endswith("2D") or zoo_name.endswith("3D"):
            kw["dim_ordering"] = "tf"
        return getattr(L, zoo_name)(**kw)
    return make


def _mk_any(cfg, L):
    """keras-3 ops-as-layer Any — the mask-reduction half of the explicit
    NotEqual/Any mask derivation in functional configs."""
    from analytics_zoo_tpu_torch.keras.engine.base import Lambda

    axis = cfg.get("axis")
    keep = bool(cfg.get("keepdims", False))
    def any_(a):
        if axis is None:
            return torch.any(a)
        dims = tuple(axis) if isinstance(axis, (list, tuple)) else axis
        return torch.any(a, dim=dims, keepdim=keep)

    return Lambda(any_, name=cfg["name"])


def _mk_expand_dims(cfg, L):
    """keras-3 ops-as-layer ExpandDims — the mask-broadcast half of the
    explicit Concatenate compute_mask graph (expand_dims(mask, -1) |
    zeros_like(value) -> concat -> Any)."""
    from analytics_zoo_tpu_torch.keras.engine.base import Lambda

    axis = int(cfg.get("axis", -1))
    return Lambda(lambda a: torch.unsqueeze(
        a, axis if axis >= 0 else axis + a.dim() + 1), name=cfg["name"])


def _mk_zeros_like(cfg, L):
    from analytics_zoo_tpu_torch.keras.engine.base import Lambda

    dtype = cfg.get("dtype")
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else None
    return Lambda(lambda a: torch.zeros_like(a, dtype=dtype),
                  name=cfg["name"])


def _mk_logical_or(cfg, L):
    from analytics_zoo_tpu_torch.keras.engine.base import Lambda

    return Lambda(lambda a, b: torch.logical_or(a, b), arity=2,
                  name=cfg["name"])


def _mk_bn(cfg, L):
    _bn_axis_ok(cfg)
    return L.BatchNormalization(
        epsilon=float(cfg.get("epsilon", 1e-3)),
        momentum=float(cfg.get("momentum", 0.99)),
        dim_ordering="tf", name=cfg["name"])


def _mk_embedding(cfg, L):
    # mask_zero does NOT zero the embedding row in keras — it attaches a
    # timestep mask, which the converter wires explicitly (ComputeMask /
    # the keras-3 NotEqual graph) into each consumer. The row stays real
    # so unmasked consumers (e.g. Flatten heads) also match exactly.
    return L.Embedding(int(cfg["input_dim"]), int(cfg["output_dim"]),
                       name=cfg["name"])


def _rnn_common_guard(cfg, what):
    for k in ("return_state", "stateful", "unroll"):
        if cfg.get(k):
            raise NotImplementedError(
                f"{what} '{cfg.get('name')}': {k}=True is not supported")
    if cfg.get("dropout") or cfg.get("recurrent_dropout"):
        logger.warning("%s '%s': dropout inside the recurrence is ignored "
                       "(inference-equivalent)", what, cfg.get("name"))


def _mk_lstm(cfg, L):
    _rnn_common_guard(cfg, "LSTM")
    return L.LSTM(int(cfg["units"]),
                  activation=_cfg_activation(cfg) or "linear",
                  inner_activation=_cfg_activation(
                      cfg, "recurrent_activation") or "linear",
                  return_sequences=bool(cfg.get("return_sequences")),
                  go_backwards=bool(cfg.get("go_backwards")),
                  name=cfg["name"])


def _mk_gru(cfg, L):
    _rnn_common_guard(cfg, "GRU")
    return L.GRU(int(cfg["units"]),
                 reset_after=bool(cfg.get("reset_after", False)),
                 activation=_cfg_activation(cfg) or "linear",
                 inner_activation=_cfg_activation(
                     cfg, "recurrent_activation") or "linear",
                 return_sequences=bool(cfg.get("return_sequences")),
                 go_backwards=bool(cfg.get("go_backwards")),
                 name=cfg["name"])


def _mk_simplernn(cfg, L):
    _rnn_common_guard(cfg, "SimpleRNN")
    return L.SimpleRNN(int(cfg["units"]),
                       activation=_cfg_activation(cfg) or "linear",
                       return_sequences=bool(cfg.get("return_sequences")),
                       go_backwards=bool(cfg.get("go_backwards")),
                       name=cfg["name"])


def _mk_bidirectional(cfg, L):
    inner_spec = cfg["layer"]
    inner = _build_layer(inner_spec["class_name"], inner_spec["config"], L)
    return L.Bidirectional(inner, merge_mode=cfg.get("merge_mode", "concat"),
                           name=cfg["name"])


def _mk_time_distributed(cfg, L):
    inner_spec = cfg["layer"]
    if inner_spec["class_name"] == "BatchNormalization":
        # zoo TimeDistributed.call doesn't plumb layer state, so inner BN
        # would silently run with init stats (mean 0, var 1) — refuse
        # (keras_import.py's BN policy: refusing beats silently serving)
        raise NotImplementedError(
            f"TimeDistributed '{cfg.get('name')}': stateful inner layer "
            "BatchNormalization is not supported — apply BN outside the "
            "TimeDistributed wrapper (it already broadcasts over time)")
    inner = _build_layer(inner_spec["class_name"], inner_spec["config"], L)
    return L.TimeDistributed(inner, name=cfg["name"])


def _mk_zero_pad2d(cfg, L):
    _channels_last(cfg, "ZeroPadding2D")
    pad = cfg.get("padding", 1)
    if isinstance(pad, (list, tuple)) and pad and \
            isinstance(pad[0], (list, tuple)):
        pad = (tuple(int(x) for x in pad[0]), tuple(int(x) for x in pad[1]))
    else:
        pad = _pair(pad)
    return L.ZeroPadding2D(padding=pad, dim_ordering="tf", name=cfg["name"])


def _mk_cropping2d(cfg, L):
    _channels_last(cfg, "Cropping2D")
    cr = cfg.get("cropping", ((0, 0), (0, 0)))
    if not (isinstance(cr, (list, tuple)) and cr
            and isinstance(cr[0], (list, tuple))):
        cr = (_pair(cr), _pair(cr))
    return L.Cropping2D(cropping=(tuple(cr[0]), tuple(cr[1])),
                        dim_ordering="tf", name=cfg["name"])


def _mk_upsampling2d(cfg, L):
    _channels_last(cfg, "UpSampling2D")
    interp = cfg.get("interpolation", "nearest")
    if interp != "nearest":
        raise NotImplementedError(
            f"UpSampling2D '{cfg.get('name')}': interpolation={interp!r} "
            "(use ResizeBilinear for bilinear)")
    return L.UpSampling2D(size=_pair(cfg.get("size", 2)), dim_ordering="tf",
                          name=cfg["name"])


def _mk_conv2d_transpose(cfg, L):
    _channels_last(cfg, "Conv2DTranspose")
    if cfg.get("padding", "valid") != "valid":
        raise NotImplementedError(
            f"Conv2DTranspose '{cfg.get('name')}': only padding='valid' "
            "converts (the zoo Deconvolution2D is VALID-semantics)")
    if _pair(cfg.get("dilation_rate", 1)) != (1, 1):
        raise NotImplementedError(
            f"Conv2DTranspose '{cfg.get('name')}': dilation_rate != 1")
    if cfg.get("output_padding") is not None:
        raise NotImplementedError(
            f"Conv2DTranspose '{cfg.get('name')}': output_padding")
    kh, kw = _pair(cfg["kernel_size"])
    return L.Deconvolution2D(int(cfg["filters"]), kh, kw,
                             subsample=_pair(cfg.get("strides", 1)),
                             activation=_cfg_activation(cfg),
                             dim_ordering="tf",
                             bias=bool(cfg.get("use_bias", True)),
                             name=cfg["name"])


def _mk_dot(cfg, L):
    axes = cfg.get("axes", -1)
    # rank-3+ inputs are refused at the graph walk, so surviving inputs are
    # rank-2 (batch, d) where axis 1 IS the last axis
    axes_ok = axes in (-1, 1) or (isinstance(axes, (list, tuple))
                                  and all(a in (-1, 1) for a in axes))
    if not axes_ok:
        raise NotImplementedError(
            f"Dot '{cfg.get('name')}': axes={axes} — only last-axis "
            "dot products convert")
    mode = "cosine" if cfg.get("normalize") else "dot"
    return L.Merge(mode=mode, name=cfg["name"])


class _HostAffine:
    """``(t - sub) / div * mul + add`` with float32 host-array operands,
    each placed once per device (a capture must not upload them) and
    promoted as jnp promotes a numpy operand: the result is float32 for
    a bf16 ``t``."""

    def __init__(self, sub=0.0, div=1.0, mul=1.0, add=0.0):
        self.ops = tuple(np.asarray(v, np.float32)
                         for v in (sub, div, mul, add))
        self._placed: Dict[str, Tuple[torch.Tensor, ...]] = {}

    def __call__(self, t):
        key = str(t.device)
        ops = self._placed.get(key)
        if ops is None:
            with torch.inference_mode(False):
                ops = tuple(torch.tensor(v, device=t.device)
                            for v in self.ops)
            self._placed[key] = ops
        sub, div, mul, add = ops
        t = t.to(torch.promote_types(t.dtype, torch.float32))
        return (t - sub) / div * mul + add


def _mk_rescaling(cfg, L):
    scale = np.asarray(cfg.get("scale", 1.0), np.float32)
    offset = np.asarray(cfg.get("offset", 0.0), np.float32)
    lay = L.Lambda(_HostAffine(mul=scale, add=offset), name=cfg["name"])
    # per-channel affine, kept for an exporter (SCALE_SHIFT)
    lay._affine_scale_shift = (scale, offset)
    return lay


def _mk_normalization(cfg, L):
    # keras Normalization(axis=-1): (x - mean) / sqrt(var); the adapted
    # mean/variance arrive as layer weights at copy time — the builder
    # wires a placeholder normalizer the weight pass then specializes
    if cfg.get("invert"):
        raise NotImplementedError(
            f"Normalization '{cfg.get('name')}': invert=True")
    _bn_axis_ok(cfg, "Normalization")
    lay = L.Lambda(lambda t: t, name=cfg["name"])
    lay._is_keras_normalization = True
    return lay


def _mk_multi_head_attention(cfg, L):
    n = int(cfg["num_heads"])
    kd = int(cfg["key_dim"])
    vd = int(cfg.get("value_dim") or kd)
    if vd != kd:
        raise NotImplementedError(
            f"MultiHeadAttention '{cfg.get('name')}': value_dim != key_dim")
    if cfg.get("output_shape") is not None:
        raise NotImplementedError(
            f"MultiHeadAttention '{cfg.get('name')}': custom output_shape")
    ax = cfg.get("attention_axes")
    if ax not in (None, [1], (1,)):
        raise NotImplementedError(
            f"MultiHeadAttention '{cfg.get('name')}': attention_axes={ax} "
            "— only the default (sequence axis of rank-3 input) converts")
    lay = L.MultiHeadAttention(n_head=n, hidden_size=n * kd,
                               attn_dropout=float(cfg.get("dropout", 0.0)),
                               name=cfg["name"])
    lay._keras_mha = True
    return lay


def _mk_softmax(cfg, L):
    ax = cfg.get("axis", -1)
    if ax != -1:
        raise NotImplementedError(
            f"Softmax '{cfg.get('name')}': axis={ax} — only the last axis "
            "(-1) is supported")
    return L.Softmax(name=cfg["name"])


def _mk_relu(cfg, L):
    max_value = cfg.get("max_value")
    slope = float(cfg.get("negative_slope", cfg.get("alpha", 0.0)) or 0.0)
    threshold = float(cfg.get("threshold", 0.0) or 0.0)
    if threshold:
        raise NotImplementedError(
            f"ReLU '{cfg.get('name')}': threshold={threshold} is not "
            "supported")
    if max_value is not None:
        if float(max_value) != 6.0 or slope:
            raise NotImplementedError(
                f"ReLU '{cfg.get('name')}': only max_value=6 (relu6) or "
                "plain/leaky ReLU convert")
        return L.Activation("relu6", name=cfg["name"])
    if slope:
        return L.LeakyReLU(slope, name=cfg["name"])
    return L.Activation("relu", name=cfg["name"])


_MERGE_MODES = {"Add": "sum", "Multiply": "mul", "Average": "ave",
                "Maximum": "max", "Minimum": "min"}


_BUILDERS: Dict[str, Callable] = {}


def _builders() -> Dict[str, Callable]:
    if _BUILDERS:
        return _BUILDERS
    _BUILDERS.update({
        "Dense": _mk_dense,
        "Conv2D": _mk_conv2d,
        "Convolution2D": _mk_conv2d,
        "Conv1D": _mk_conv1d,
        "Convolution1D": _mk_conv1d,
        "Conv3D": _mk_conv3d,
        "DepthwiseConv2D": _mk_dwconv2d,
        "SeparableConv2D": _mk_sepconv2d,
        "MaxPooling2D": _mk_pool2d("MaxPooling2D"),
        "AveragePooling2D": _mk_pool2d("AveragePooling2D"),
        "MaxPooling1D": _mk_pool1d("MaxPooling1D"),
        "AveragePooling1D": _mk_pool1d("AveragePooling1D"),
        "GlobalMaxPooling1D": _mk_global_pool("GlobalMaxPooling1D"),
        "GlobalAveragePooling1D": _mk_global_pool("GlobalAveragePooling1D"),
        "GlobalMaxPooling2D": _mk_global_pool("GlobalMaxPooling2D"),
        "GlobalAveragePooling2D": _mk_global_pool("GlobalAveragePooling2D"),
        "BatchNormalization": _mk_bn,
        "Embedding": _mk_embedding,
        "LSTM": _mk_lstm,
        "GRU": _mk_gru,
        "SimpleRNN": _mk_simplernn,
        "Bidirectional": _mk_bidirectional,
        "TimeDistributed": _mk_time_distributed,
        "ZeroPadding2D": _mk_zero_pad2d,
        "Cropping2D": _mk_cropping2d,
        "UpSampling2D": _mk_upsampling2d,
        "Activation": lambda cfg, L: L.Activation(
            _cfg_activation(cfg) or "linear", name=cfg["name"]),
        "Dropout": lambda cfg, L: L.Dropout(float(cfg.get("rate", 0.5)),
                                            name=cfg["name"]),
        "SpatialDropout1D": lambda cfg, L: L.SpatialDropout1D(
            float(cfg.get("rate", 0.5)), name=cfg["name"]),
        "SpatialDropout2D": lambda cfg, L: L.SpatialDropout2D(
            float(cfg.get("rate", 0.5)), dim_ordering="tf",
            name=cfg["name"]),
        "Flatten": lambda cfg, L: L.Flatten(name=cfg["name"]),
        "Reshape": lambda cfg, L: L.Reshape(
            tuple(int(d) for d in cfg["target_shape"]), name=cfg["name"]),
        "Permute": lambda cfg, L: L.Permute(
            tuple(int(d) for d in cfg["dims"]), name=cfg["name"]),
        "RepeatVector": lambda cfg, L: L.RepeatVector(int(cfg["n"]),
                                                      name=cfg["name"]),
        "Any": _mk_any,
        "ExpandDims": _mk_expand_dims,
        "ZerosLike": _mk_zeros_like,
        "LogicalOr": _mk_logical_or,
        "Masking": lambda cfg, L: L.Masking(
            float(cfg.get("mask_value", 0.0)), name=cfg["name"]),
        "LeakyReLU": lambda cfg, L: L.LeakyReLU(
            float(cfg.get("negative_slope", cfg.get("alpha", 0.3))),
            name=cfg["name"]),
        "PReLU": lambda cfg, L: L.PReLU(name=cfg["name"]),
        "ELU": lambda cfg, L: L.ELU(float(cfg.get("alpha", 1.0)),
                                    name=cfg["name"]),
        "ThresholdedReLU": lambda cfg, L: L.ThresholdedReLU(
            float(cfg.get("theta", 1.0)), name=cfg["name"]),
        "ReLU": _mk_relu,
        "Softmax": _mk_softmax,
        "Rescaling": _mk_rescaling,
        "Normalization": _mk_normalization,
        "MultiHeadAttention": _mk_multi_head_attention,
        "LayerNormalization": lambda cfg, L: L.LayerNorm(
            epsilon=float(cfg.get("epsilon", 1e-3)), name=cfg["name"]),
        "Concatenate": lambda cfg, L: L.Merge(
            mode="concat", concat_axis=int(cfg.get("axis", -1)),
            name=cfg["name"]),
        "Conv2DTranspose": _mk_conv2d_transpose,
        "Dot": _mk_dot,
        "ZeroPadding1D": lambda cfg, L: L.ZeroPadding1D(
            cfg.get("padding", 1), name=cfg["name"]),
        "Cropping1D": lambda cfg, L: L.Cropping1D(
            tuple(cfg.get("cropping", (1, 1)))
            if isinstance(cfg.get("cropping", (1, 1)), (list, tuple))
            else (_scalar(cfg.get("cropping", 1)),) * 2, name=cfg["name"]),
        "UpSampling1D": lambda cfg, L: L.UpSampling1D(
            _scalar(cfg.get("size", 2)), name=cfg["name"]),
        "GaussianNoise": lambda cfg, L: L.GaussianNoise(
            float(cfg.get("stddev", cfg.get("sigma", 0.1))),
            name=cfg["name"]),
        "GaussianDropout": lambda cfg, L: L.GaussianDropout(
            float(cfg.get("rate", cfg.get("p", 0.5))), name=cfg["name"]),
        **{k: (lambda mode: lambda cfg, L: L.Merge(mode=mode,
                                                   name=cfg["name"]))(v)
           for k, v in _MERGE_MODES.items()},
    })
    return _BUILDERS


def _build_layer(class_name: str, cfg: Dict, L):
    if class_name == "Lambda":
        raise NotImplementedError(
            f"Lambda '{cfg.get('name')}': a Lambda's python body cannot be "
            "recovered from a model config — rebuild it as a zoo "
            "layers.Lambda on the converted model")
    builders = _builders()
    if class_name not in builders:
        raise NotImplementedError(
            f"no converter for keras layer type {class_name} "
            f"('{cfg.get('name')}')")
    return builders[class_name](cfg, L)


# ---------------------------------------------------------------------------
# inbound-node parsing (both dialects)
# ---------------------------------------------------------------------------


def _history_refs(node) -> List[Tuple[str, int, int]]:
    """Flatten one inbound node into [(layer, node_idx, tensor_idx), ...]."""
    refs: List[Tuple[str, int, int]] = []

    def walk(obj):
        if isinstance(obj, dict):
            if obj.get("class_name") == "__keras_tensor__":
                h = obj["config"]["keras_history"]
                refs.append((str(h[0]), int(h[1]), int(h[2])))
            else:
                walk(obj.get("args", []))
                walk(list((obj.get("kwargs") or {}).values()))
        elif isinstance(obj, (list, tuple)):
            # classic dialect: [name, node_idx, tensor_idx, kwargs]
            if (len(obj) >= 3 and isinstance(obj[0], str)
                    and isinstance(obj[1], int) and isinstance(obj[2], int)):
                refs.append((str(obj[0]), int(obj[1]), int(obj[2])))
            else:
                for v in obj:
                    walk(v)

    walk(node)
    return refs


def _normalize_io(spec) -> List[Tuple[str, int, int]]:
    """input_layers/output_layers: ['n',0,0], [['n',0,0]], or keras-tensor
    dicts."""
    if isinstance(spec, (list, tuple)) and len(spec) == 3 \
            and isinstance(spec[0], str):
        return [(str(spec[0]), int(spec[1]), int(spec[2]))]
    out: List[Tuple[str, int, int]] = []
    for item in spec:
        refs = _history_refs(item)
        if refs:
            out.extend(refs)
        elif isinstance(item, (list, tuple)):
            out.extend(_normalize_io(item))
        else:
            raise ValueError(f"unparseable model io entry {item!r}")
    return out


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------


# tf.keras timestep-mask semantics (Embedding(mask_zero=True) / Masking)
# are reproduced STRUCTURALLY: the converter synthesizes an explicit
# ComputeMask variable and wires it as the second input of each consumer —
# RNNs hold state across padded steps (layers/recurrent.py run(mask=)),
# GlobalAveragePooling1D averages valid steps only, MultiHeadAttention
# folds the mask into its attention bias. Masks survive the layers below
# (tf.keras supports_masking pass-through set); anything else stops them.
_MASK_TRANSPARENT = {
    "Dropout", "SpatialDropout1D", "Activation", "Dense", "TimeDistributed",
    "LayerNormalization", "BatchNormalization", "Lambda", "LeakyReLU",
    "PReLU", "ELU", "ThresholdedReLU", "ReLU", "Softmax", "Masking",
    "Add", "Subtract", "Multiply", "Average", "Maximum", "Minimum",
    "Concatenate", "GaussianNoise", "GaussianDropout", "AlphaDropout",
}
# Consumers the converter wires an [x, mask] pair into. RNNs with
# return_sequences=True propagate the mask onward (keras contract);
# pooling consumes it.
_MASK_RNNS = {"LSTM", "GRU", "SimpleRNN", "Bidirectional"}


def _is_mask_producer(cn: str, cfg: Dict) -> bool:
    return cn == "Masking" or (cn == "Embedding" and bool(cfg.get("mask_zero")))


def _masked_rnn_error(cn: str, name) -> NotImplementedError:
    return NotImplementedError(
        f"{cn} '{name}' receives a timestep mask (Embedding(mask_zero=True)"
        " or Masking upstream), and masked semantics for this layer type "
        "are not reproduced by the converter — the converted model would "
        "silently diverge from the source. Retrain without mask_zero, or "
        "truncate padding outside the model")


def _make_mask_var(cn: str, cfg: Dict, src_var, L, suffix: str = ""):
    """The explicit mask variable a producer layer implies (from the
    producer's INPUT: ids for Embedding, features for Masking)."""
    mname = f"{cfg['name']}_mask{suffix}"
    if cn == "Embedding":
        lay = L.ComputeMask(pad_value=0, name=mname)
    else:
        lay = L.ComputeMask(mask_value=float(cfg.get("mask_value", 0.0)),
                            name=mname)
    return lay(src_var)


def _merge_masks(masks_in, cn=None, cfg=None, srcs=None, L=None):
    """keras 3 merge-mask rule (base_merge.compute_mask): the mask is
    DROPPED (None) when any input is unmasked, else the logical OR of the
    masks (a step is valid if valid in any branch).

    Concatenate OVERRIDES the base rule (keras merging/concatenate.py
    ``compute_mask``): masks are aligned to the value rank, concatenated
    along the layer's axis, and reduced with ALL over the last dim — so a
    time-axis concat CONCATENATES the masks (the (B,T) OR would no longer
    match the (B,2T) value) and a feature-axis concat ANDs them."""
    if not masks_in:
        return None
    if cn == "Concatenate" and any(m is not None for m in masks_in):
        return _concat_masks(masks_in, cfg, srcs, L)
    if any(m is None for m in masks_in):
        return None
    out = masks_in[0]
    for m in masks_in[1:]:
        out = out + m - out * m  # float OR over {0, 1}
    return out


def _concat_masks(masks_in, cfg, srcs, L):
    name = (cfg or {}).get("name", "concat")
    rank = len(getattr(srcs[0], "shape", ()))  # includes batch dim
    axis = int((cfg or {}).get("axis", -1))
    if axis < 0:
        axis += rank
    if axis == rank - 1:
        # feature-axis concat: keras pads unmasked branches with ones and
        # reduce_all's the stacked masks — the AND of the present ones
        out = None
        for m in masks_in:
            if m is not None:
                out = m if out is None else out * m  # float AND over {0, 1}
        return out
    if axis == 1 and rank == 3:
        if any(m is None for m in masks_in):
            raise NotImplementedError(
                f"Concatenate '{name}': time-axis concatenation of a masked "
                "input with an unmasked one does not convert (keras itself "
                "shape-errors here unless the unmasked branch has feature "
                "dim 1)")
        lay = L.Merge(mode="concat", concat_axis=1, name=f"{name}_mask")
        return lay(list(masks_in))
    raise NotImplementedError(
        f"Concatenate '{name}': masked concatenation along axis {axis} of "
        f"rank-{rank} inputs is not supported (feature- or time-axis only)")


def _rnn_returns_sequences(cn: str, cfg: Dict) -> bool:
    if cn == "Bidirectional":
        inner = (cfg.get("layer") or {}).get("config") or {}
        return bool(inner.get("return_sequences"))
    return bool(cfg.get("return_sequences"))


def _apply_masked_layer(cn: str, cfg: Dict, var, mask, L, lay=None,
                        mask_suffix: str = ""):
    """One layer application with the running (value, mask) pair — the
    linear form of the functional walk's mask wiring. ``lay`` lets
    shared-layer call sites reuse one built layer instance."""
    if cn == "Sequential":
        # nested Sequential sub-model: INLINE its stack into the parent
        # graph (layer names come from the nested config, so weight copy
        # matches them after the recursive flatten in copy_keras_weights)
        if lay is not None:
            raise NotImplementedError(
                f"Sequential sub-model '{cfg.get('name')}' shared across "
                "call sites is not supported")
        for spec in cfg["layers"]:
            scn, scfg = spec["class_name"], dict(spec["config"])
            if scn == "InputLayer":
                continue
            var, mask = _apply_masked_layer(scn, scfg, var, mask, L)
        return var, mask
    if cn in ("Functional", "Model"):
        # nested functional sub-model (backbone-as-layer): inline its
        # graph, seeding its InputLayer with the call-site operand
        if lay is not None:
            raise NotImplementedError(
                f"functional sub-model '{cfg.get('name')}' shared across "
                "call sites is not supported")
        return _inline_functional(cfg, [(var, mask)], L)
    if cn == "ConvLSTM2D" and mask is not None:
        raise _masked_rnn_error(cn, cfg.get("name"))
    lay = lay if lay is not None else _build_layer(cn, cfg, L)
    if mask is not None and cn in _MASK_RNNS:
        out = lay([var, mask])
        return out, (mask if _rnn_returns_sequences(cn, cfg) else None)
    if mask is not None and cn == "GlobalAveragePooling1D":
        return lay([var, mask]), None
    out = lay(var)
    if _is_mask_producer(cn, cfg):
        return out, _make_mask_var(cn, cfg, var, L, suffix=mask_suffix)
    return out, (mask if cn in _MASK_TRANSPARENT else None)


def _inline_functional(cfg: Dict, arg_pairs: List[Tuple], L):
    """Inline a nested functional sub-model: its InputLayers are seeded
    with the call-site (var, mask) operands (positional, the keras call
    convention) and its single output becomes the call-site's value."""
    if "input_layers" not in cfg or "output_layers" not in cfg:
        raise NotImplementedError(
            f"nested model '{cfg.get('name')}': config carries no "
            "functional graph")
    in_refs = _normalize_io(cfg["input_layers"])
    if len(in_refs) != len(arg_pairs):
        raise NotImplementedError(
            f"nested model '{cfg.get('name')}': {len(in_refs)} inputs, "
            f"called with {len(arg_pairs)} operands")
    seed = {r[0]: pair for r, pair in zip(in_refs, arg_pairs)}
    _, produced, masks = _walk_functional_graph(cfg, L, seed=seed)
    out_refs = _normalize_io(cfg["output_layers"])
    if len(out_refs) != 1:
        raise NotImplementedError(
            f"nested model '{cfg.get('name')}': multi-output sub-models "
            "are not supported")
    r = out_refs[0]
    if r[2] != 0 or (r[0], r[1], 0) not in produced:
        raise NotImplementedError(
            f"nested model '{cfg.get('name')}': output ref {r} not "
            "resolvable")
    return produced[(r[0], r[1], 0)], masks.get((r[0], r[1], 0))


def _flatten_seq_specs(layers_cfg: List[Dict]) -> List[Dict]:
    """Inline nested Sequential sub-models into their parent's layer list
    (their layer names are preserved, so weight matching still works)."""
    flat: List[Dict] = []
    for spec in layers_cfg:
        if spec["class_name"] == "Sequential":
            inner = (spec.get("config") or {}).get("layers", [])
            flat.extend(s for s in _flatten_seq_specs(inner)
                        if s["class_name"] != "InputLayer")
        else:
            flat.append(spec)
    return flat


def _convert_masked_sequential(config: Dict, layers_cfg: List[Dict], L):
    """Sequential config whose stack carries a timestep mask → the
    equivalent functional Model with the mask as an explicit side-chain."""
    from analytics_zoo_tpu_torch.keras.engine.topology import Input, Model

    bis = config.get("build_input_shape")
    pending = tuple(bis[1:]) if bis else None
    specs = []
    for spec in layers_cfg:
        cn, cfg = spec["class_name"], dict(spec["config"])
        if cn == "InputLayer":
            pending = _input_shape_of(cfg)
            continue
        if not specs:
            pending = _input_shape_of(cfg) or pending
        specs.append((cn, cfg))
    if pending is None:
        raise ValueError(
            "Sequential conversion needs an input shape — build the source "
            "model (or give its first layer an input_shape) before "
            "converting")
    inp = Input(shape=tuple(pending),
                name=(config.get("name") or "seq") + "_input")
    var, mask = inp, None
    for cn, cfg in specs:
        var, mask = _apply_masked_layer(cn, cfg, var, mask, L)
    return Model(input=inp, output=var, name=config.get("name"))


def convert_keras_architecture(config: Dict, class_name: Optional[str] = None):
    """Build an (unweighted) zoo model from a keras model config dict.

    ``class_name`` is 'Sequential' or 'Functional'/'Model'; inferred from
    the config shape when omitted.
    """
    import analytics_zoo_tpu_torch.keras.layers as L
    from analytics_zoo_tpu_torch.keras.engine.topology import Model, Sequential

    layers_cfg = config["layers"]
    if class_name is None:
        class_name = "Functional" if "output_layers" in config else "Sequential"

    if class_name == "Sequential":
        layers_cfg = _flatten_seq_specs(layers_cfg)
        if any(_is_mask_producer(s["class_name"], s.get("config") or {})
               or s["class_name"] in ("Functional", "Model")
               for s in layers_cfg):
            # a timestep mask (explicit side-variables) or a nested
            # functional sub-model (graph inlining) — neither fits a
            # linear Sequential; build the equivalent functional graph
            return _convert_masked_sequential(config, layers_cfg, L)
        seq = Sequential(name=config.get("name"))
        bis = config.get("build_input_shape")
        pending_shape = tuple(bis[1:]) if bis else None
        first = True
        for spec in layers_cfg:
            cn, cfg = spec["class_name"], dict(spec["config"])
            if cn == "InputLayer":
                pending_shape = _input_shape_of(cfg)
                continue
            shape_here = _input_shape_of(cfg)
            lay = _build_layer(cn, cfg, L)
            if first and lay._user_input_shape is None:
                ish = shape_here or pending_shape
                if ish is None:
                    raise ValueError(
                        "Sequential conversion needs an input shape — build "
                        "the source model (or give its first layer an "
                        "input_shape) before converting")
                lay._user_input_shape = tuple(ish)
            seq.add(lay)
            first = False
        return seq

    # functional graph
    inputs, produced, masks = _walk_functional_graph(config, L)
    out_refs = _normalize_io(config["output_layers"])
    in_refs = _normalize_io(config["input_layers"])
    for r in out_refs + in_refs:
        if (r[0], r[1], r[2]) not in produced or r[2] != 0:
            raise NotImplementedError(
                f"model io ref {r}: multi-output tensor indices are not "
                "supported")
    outs = [produced[(r[0], r[1], 0)] for r in out_refs]
    ins = [produced[(r[0], r[1], 0)] for r in in_refs]
    return Model(input=ins if len(ins) > 1 else ins[0],
                 output=outs if len(outs) > 1 else outs[0],
                 name=config.get("name"))


def _walk_functional_graph(config: Dict, L, seed: Optional[Dict] = None):
    """Wire a functional keras config into zoo Variables. ``seed`` maps
    an InputLayer NAME to a (var, mask) pair — used when inlining a
    nested functional sub-model onto its call-site operands. Returns
    (fresh_input_vars, produced, masks) keyed by (name, node_idx, 0)."""
    from analytics_zoo_tpu_torch.keras.engine.topology import Input

    layers_cfg = config["layers"]
    produced: Dict[Tuple[str, int, int], Any] = {}
    masks: Dict[Tuple[str, int, int], Any] = {}  # timestep-mask side vars
    inputs: List[Any] = []

    # keras node indices are LAYER-GLOBAL: a nested sub-model's internal
    # creation counts as its node 0, so the outer graph's call to it is
    # node 1. Map the node indices THIS config references (inbound refs +
    # io lists) onto our call-site order, so produced keys match refs.
    referenced: Dict[str, List[int]] = {}

    def _note_ref(r):
        referenced.setdefault(r[0], []).append(r[1])

    for spec_ in layers_cfg:
        for node_ in spec_.get("inbound_nodes", []):
            try:
                for r_ in _history_refs(node_):
                    _note_ref(r_)
            except Exception:
                pass
    for io_key in ("input_layers", "output_layers"):
        if io_key in config:
            for r_ in _normalize_io(config[io_key]):
                _note_ref(r_)

    def out_key(name_: str, site: int) -> Tuple[str, int, int]:
        ids = sorted(set(referenced.get(name_, ())))
        return (name_, ids[site] if site < len(ids) else site, 0)

    for spec in layers_cfg:
        name, cn, cfg = spec["name"], spec["class_name"], dict(spec["config"])
        nodes = spec.get("inbound_nodes", [])
        if cn == "InputLayer":
            if seed is not None and name in seed:
                var, m = seed[name]
                produced[out_key(name, 0)] = var
                masks[out_key(name, 0)] = m
                continue
            shape = _input_shape_of(cfg)
            if shape is None:
                raise ValueError(f"InputLayer '{name}' has no batch_shape")
            var = Input(shape=shape, name=name)
            produced[out_key(name, 0)] = var
            inputs.append(var)
            continue
        if not nodes:
            continue  # orphan layer (never called) — nothing to wire
        if len(nodes) > 1:
            # SHARED layer (siamese / tied weights): ONE zoo layer instance
            # applied at every call site — the graph collects it once, so
            # its parameters are naturally shared. The layer builds on the
            # first application; every site must present the same
            # (batch-free) input shape.
            if cn in ("MultiHeadAttention", "Dot", "Subtract", "NotEqual"):
                raise NotImplementedError(
                    f"layer '{name}' ({cn}) shared across {len(nodes)} "
                    "call sites is not supported")
            if cn in ("Functional", "Model", "Sequential"):
                raise NotImplementedError(
                    f"sub-model '{name}' shared across {len(nodes)} call "
                    "sites (twin-tower weight tying) is not supported — "
                    "inlining cannot tie parameters across copies; call "
                    "the block once or share the individual layers")
            shared_lay = _build_layer(cn, cfg, L)
            site_shapes = set()
            for node_idx, node in enumerate(nodes):
                refs = _history_refs(node)
                if not refs:
                    raise ValueError(
                        f"could not parse inbound node {node_idx} of "
                        f"'{name}'")
                for r in refs:
                    if r not in produced:
                        raise ValueError(
                            f"layer '{name}' consumes {r} which is not "
                            "produced yet (non-topological config order?)")
                srcs = [produced[r] for r in refs]
                in_mask = _merge_masks([masks.get(r) for r in refs],
                                       cn, cfg, srcs, L)
                site_shapes.add(
                    tuple(getattr(srcs[0], "shape", ())[1:]))
                if len(site_shapes) > 1:
                    raise NotImplementedError(
                        f"shared layer '{name}': call sites have different "
                        f"input shapes {sorted(site_shapes)} — a zoo layer "
                        "builds one weight shape")
                if len(srcs) == 1:
                    out, m_out = _apply_masked_layer(
                        cn, cfg, srcs[0], in_mask, L, lay=shared_lay,
                        mask_suffix=f"_{node_idx}" if node_idx else "")
                else:
                    out = shared_lay(srcs)
                    m_out = in_mask if cn in _MASK_TRANSPARENT else None
                produced[out_key(name, node_idx)] = out
                masks[out_key(name, node_idx)] = m_out
            continue
        refs = _history_refs(nodes[0])
        if not refs:
            raise ValueError(f"could not parse inbound node of '{name}'")
        for r in refs:
            if r not in produced:
                raise ValueError(
                    f"layer '{name}' consumes {r} which is not produced yet "
                    "(non-topological config order?)")
        srcs = [produced[r] for r in refs]
        in_mask = _merge_masks([masks.get(r) for r in refs], cn, cfg, srcs, L)
        if cn == "MultiHeadAttention":
            node = nodes[0]
            if isinstance(node, dict):  # keras-3 dialect
                kwargs = node.get("kwargs") or {}
                arg_refs = _history_refs({"args": node.get("args", [])})
            else:  # classic dialect: kwargs ride in each ref's 4th slot
                kwargs = {}
                for ref in node if isinstance(node, (list, tuple)) else ():
                    if (isinstance(ref, (list, tuple)) and len(ref) >= 4
                            and isinstance(ref[3], dict)):
                        kwargs.update(ref[3])
                arg_refs = refs
            # value/key passed as KEYWORDS are still attention operands —
            # fold them into the identity check, or cross-attention written
            # as mha(q, value=kv) would silently convert as self-attention
            for opname in ("value", "key"):
                kw_refs = _history_refs(kwargs.get(opname))
                arg_refs = list(arg_refs) + kw_refs
            if kwargs.get("attention_mask") is not None:
                raise NotImplementedError(
                    f"MultiHeadAttention '{name}': attention_mask is not "
                    "supported (only use_causal_mask converts)")
            if kwargs.get("return_attention_scores"):
                raise NotImplementedError(
                    f"MultiHeadAttention '{name}': "
                    "return_attention_scores=True (tuple outputs)")
            uniq = list(dict.fromkeys(arg_refs))
            if len(uniq) == 2:
                # CROSS-attention mha(q, kv): converts to the zoo layer's
                # cross mode (separate q / fused-kv projections) as long as
                # key is value — a distinct key operand has no fused form
                q_ref, kv_ref = uniq[0], uniq[1]
                others = [r for r in arg_refs if r != q_ref]
                if any(r != others[0] for r in others):
                    raise NotImplementedError(
                        f"MultiHeadAttention '{name}': distinct key and "
                        "value operands are not supported")
                if (masks.get(q_ref) is not None
                        or masks.get(kv_ref) is not None):
                    raise NotImplementedError(
                        f"MultiHeadAttention '{name}': masked "
                        "cross-attention is not supported")
                lay = _build_layer(cn, cfg, L)
                lay.cross = True
                if kwargs.get("use_causal_mask"):
                    lay.causal = True
                produced[out_key(name, 0)] = lay(
                    [produced[q_ref], produced[kv_ref]])
                masks[out_key(name, 0)] = None
                continue
            if len(uniq) != 1:
                raise NotImplementedError(
                    f"MultiHeadAttention '{name}': {len(uniq)} distinct "
                    "operands — only self- and (key is value) "
                    "cross-attention convert")
            src = produced[arg_refs[0]]
            if len(getattr(src, "shape", ())) != 3:
                raise NotImplementedError(
                    f"MultiHeadAttention '{name}': rank-"
                    f"{len(getattr(src, 'shape', ()))} input — only "
                    "(batch, seq, features) attention converts")
            lay = _build_layer(cn, cfg, L)
            if kwargs.get("use_causal_mask"):
                lay.causal = True
            op_mask = masks.get(arg_refs[0])
            if op_mask is not None:
                # keras auto-derives the attention padding mask from the
                # operands' _keras_mask; the zoo layer takes it explicitly
                lay._keras_mask_mode = True
                produced[out_key(name, 0)] = lay([src, op_mask])
            else:
                produced[out_key(name, 0)] = lay(src)
            masks[out_key(name, 0)] = op_mask  # MHA propagates the query mask
            continue
        if cn == "Dot" and any(len(getattr(s, "shape", ())) > 2
                               for s in srcs):
            # keras Dot on rank-3+ is a batched matmul; Merge('dot') is a
            # last-axis inner product — refuse rather than silently diverge
            raise NotImplementedError(
                f"Dot '{name}': rank-3+ inputs (batched matmul semantics) "
                "are not supported — only rank-2 last-axis dot products "
                "convert")
        if cn == "Subtract":
            # no 'sub' Merge mode; Variables overload arithmetic directly
            if len(srcs) != 2:
                raise ValueError(f"Subtract '{name}' needs exactly 2 inputs")
            produced[out_key(name, 0)] = srcs[0] - srcs[1]
            masks[out_key(name, 0)] = in_mask
            continue
        if cn == "NotEqual":
            # keras-3 materializes mask derivation as op layers: the mask
            # kwarg of downstream RNN/pooling nodes references this output
            from analytics_zoo_tpu_torch.keras.engine.base import Lambda

            node = nodes[0]
            lit = None
            if isinstance(node, dict):
                for a in node.get("args", []):
                    if not (isinstance(a, dict)
                            and a.get("class_name") == "__keras_tensor__"):
                        lit = a
            if lit is None and len(srcs) == 2:
                out = Lambda(lambda a, b: torch.ne(a, b), arity=2,
                             name=name)(srcs)
            elif lit is not None:
                out = Lambda(
                    lambda a, lit=lit: torch.ne(a, lit),
                    name=name)(srcs[0])
            else:
                raise NotImplementedError(
                    f"NotEqual '{name}': could not resolve operands")
            produced[out_key(name, 0)] = out
            masks[out_key(name, 0)] = None
            continue
        if len(srcs) == 1:
            # ONE mask-wiring policy for both config forms: the sequential
            # converter and this walk share _apply_masked_layer
            out, m_out = _apply_masked_layer(cn, cfg, srcs[0], in_mask, L)
            produced[out_key(name, 0)] = out
            masks[out_key(name, 0)] = m_out
            continue
        # multi-src: merges, and keras-3 explicit [x, mask-kwarg] consumer
        # nodes (the mask rides as its own graph edge there, so no dict
        # propagation is needed)
        if cn in ("Functional", "Model"):
            node = nodes[0]
            arg_refs = (_history_refs({"args": node.get("args", [])})
                        if isinstance(node, dict) else refs) or refs
            # keras-3 serializes the operands' timestep masks as EXTRA
            # mask-kwarg edges on the call node and re-feeds them into the
            # sub-model's graph — pair them positionally with the operands
            kw_mask_refs = [r for r in refs if r not in set(arg_refs)]
            pairs = []
            for i, r in enumerate(arg_refs):
                m = (produced.get(kw_mask_refs[i])
                     if i < len(kw_mask_refs) else masks.get(r))
                pairs.append((produced[r], m))
            out, m_out = _inline_functional(cfg, pairs, L)
            produced[out_key(name, 0)] = out
            masks[out_key(name, 0)] = m_out
            continue
        lay = _build_layer(cn, cfg, L)
        produced[out_key(name, 0)] = lay(srcs)
        masks[out_key(name, 0)] = in_mask if cn in _MASK_TRANSPARENT else None

    return inputs, produced, masks


def _short(name: str) -> str:
    return str(name).split("/")[-1].split(":")[0]


def _keras_layer_weights(kl) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for w in kl.weights:
        out[_short(getattr(w, "path", None) or w.name)] = np.asarray(w)
    return out


def _split_bidirectional(kl) -> Tuple[Dict[str, np.ndarray],
                                      Dict[str, np.ndarray]]:
    fwd: Dict[str, np.ndarray] = {}
    bwd: Dict[str, np.ndarray] = {}
    for w in kl.weights:
        path = str(getattr(w, "path", None) or w.name)
        target = bwd if "backward" in path else fwd
        target[_short(path)] = np.asarray(w)
    return fwd, bwd


def _convert_mha_weights(lay, kl) -> Dict[str, np.ndarray]:
    """keras MultiHeadAttention einsum kernels -> the zoo layer's fused
    qkv/proj params. keras: q/k/v kernels (d, n, dh) + biases (n, dh),
    output kernel (n, dh, d_out) + bias (d_out); zoo: qkv_kernel (d, 3h),
    qkv_bias (3h,), proj_kernel (h, h), proj_bias (h,) with h = n*dh —
    the head reshape orders (n, dh) exactly like the zoo heads() split."""
    parts: Dict[str, np.ndarray] = {}
    for w in kl.weights:
        path = str(getattr(w, "path", None) or w.name)
        kind = _short(path)
        if "attention_output" in path:
            parts["o_" + kind] = np.asarray(w)
        elif "/query" in path or "query/" in path:
            parts["q_" + kind] = np.asarray(w)
        elif "/key" in path or "key/" in path:
            parts["k_" + kind] = np.asarray(w)
        elif "/value" in path or "value/" in path:
            parts["v_" + kind] = np.asarray(w)
    try:
        qw, kw, vw, ow = (parts["q_kernel"], parts["k_kernel"],
                          parts["v_kernel"], parts["o_kernel"])
    except KeyError as e:
        raise NotImplementedError(
            f"{lay.name}: MultiHeadAttention weights not identified "
            f"({sorted(parts)})") from e
    d, n, dh = qw.shape
    h = n * dh
    d_out = ow.shape[-1]
    if h != lay.hidden_size or d_out != h:
        raise NotImplementedError(
            f"{lay.name}: num_heads*key_dim ({h}) must equal the output "
            f"feature dim ({d_out}) — the zoo projection is square")
    z = np.zeros(h, np.float32)
    if getattr(lay, "cross", False):
        d_kv = kw.shape[0]
        return {
            "q_kernel": qw.reshape(d, h),
            "q_bias": parts.get("q_bias", z).reshape(h),
            "kv_kernel": np.concatenate(
                [a.reshape(d_kv, h) for a in (kw, vw)], axis=-1),
            "kv_bias": np.concatenate(
                [parts.get(p + "_bias", z).reshape(h) for p in "kv"]),
            "proj_kernel": ow.reshape(h, d_out),
            "proj_bias": parts.get("o_bias", np.zeros(d_out, np.float32)),
        }
    return {
        "qkv_kernel": np.concatenate(
            [a.reshape(d, h) for a in (qw, kw, vw)], axis=-1),
        "qkv_bias": np.concatenate(
            [parts.get(p + "_bias", z).reshape(h) for p in "qkv"]),
        "proj_kernel": ow.reshape(h, d_out),
        "proj_bias": parts.get("o_bias", np.zeros(d_out, np.float32)),
    }


def _flatten_keras_layers(kmodel, out: Optional[Dict] = None) -> Dict:
    """Name → layer over the whole model TREE: nested Sequential
    sub-models are inlined by the converter, so their layers' weights
    must be addressable by name at the top level."""
    if out is None:
        out = {}
    for kl in kmodel.layers:
        if (type(kl).__name__ in ("Sequential", "Functional", "Model")
                and getattr(kl, "layers", None)):
            _flatten_keras_layers(kl, out)
            continue
        if kl.name in out and out[kl.name] is not kl:
            raise NotImplementedError(
                f"duplicate layer name '{kl.name}' across nested models — "
                "weight matching is by name; rename the layers")
        out[kl.name] = kl
    return out


def copy_keras_weights(zoo_model, kmodel, strict: bool = True) -> List[str]:
    """Copy weights from a live keras model into the converted zoo model,
    matching layers by name (conversion preserves names)."""
    klayers = _flatten_keras_layers(kmodel)
    pairs = []
    nested_updates: Dict[str, Dict] = {}
    special_imported: List[str] = []
    for lay in zoo_model.layers():
        kl = klayers.get(lay.name)
        if kl is None:
            continue
        if getattr(lay, "_is_keras_normalization", False):
            pass  # handled below even when kl.weights is empty
        elif not kl.weights:
            continue
        if type(lay).__name__ == "Bidirectional":
            fwd_w, bwd_w = _split_bidirectional(kl)
            fp, fs_ = _convert(lay.forward_layer, fwd_w)
            bp, bs_ = _convert(lay.backward_layer, bwd_w)
            if fs_ or bs_:
                raise NotImplementedError(
                    f"{lay.name}: stateful inner layer in Bidirectional — "
                    "layer state cannot be nested")
            nested_updates[lay.name] = {"forward": fp, "backward": bp}
            continue
        if getattr(lay, "_is_keras_normalization", False):
            # adapt() stores mean/variance as weights; the constructor form
            # (Normalization(mean=, variance=)) keeps them as plain attrs
            w = _keras_layer_weights(kl)
            mean, var = w.get("mean"), w.get("variance")
            if mean is None:
                mean = getattr(kl, "mean", None)
                var = getattr(kl, "variance", None)
            if mean is None or var is None:
                if strict:
                    raise NotImplementedError(
                        f"{lay.name}: Normalization mean/variance not "
                        f"identified (weights {sorted(w)})")
                logger.warning("convert_keras_model: skipping '%s' "
                               "(Normalization stats not identified)",
                               lay.name)
                continue
            mean32 = np.asarray(mean, np.float32)
            std32 = np.maximum(np.sqrt(np.asarray(var, np.float32)), 1e-7)
            lay.function = _HostAffine(sub=mean32, div=std32)
            # (x-m)/s == x*(1/s) + (-m/s): exportable as SCALE_SHIFT
            lay._affine_scale_shift = (1.0 / std32, -mean32 / std32)
            special_imported.append(lay.name)
            continue
        if getattr(lay, "_keras_mha", False):
            nested_updates[lay.name] = _convert_mha_weights(lay, kl)
            continue
        if type(lay).__name__ == "TimeDistributed":
            # params nest under 'inner' (no flat weight_specs) — convert
            # against the inner layer like the Bidirectional case
            ip, is_ = _convert(lay.layer, _keras_layer_weights(kl))
            if is_:
                raise NotImplementedError(
                    f"{lay.name}: stateful inner layer in TimeDistributed "
                    "— layer state cannot be nested")
            nested_updates[lay.name] = {"inner": ip}
            continue
        pairs.append((lay, _keras_layer_weights(kl)))
    imported = apply_weight_imports(zoo_model, pairs, _convert, strict=strict,
                                    kind="convert_keras_model")
    if nested_updates:
        zoo_model.set_weights(nested_updates)
        imported.extend(nested_updates)
    imported.extend(special_imported)
    return imported


def convert_keras_model(kmodel, strict: bool = True):
    """Live tf.keras / Keras-3 model -> zoo model with the same weights.

    The converted model predicts identically (parity pinned in
    tests/test_torch_keras_convert.py) and trains on the engine like any
    native zoo model.
    """
    class_name = type(kmodel).__name__
    if class_name not in ("Sequential", "Functional", "Model"):
        class_name = None
    reason = None
    try:
        config = kmodel.get_config()
    except Exception as e:
        config = None
        reason = e
    if not isinstance(config, dict) or "layers" not in config:
        raise NotImplementedError(
            f"{type(kmodel).__name__}: subclassed keras models have no "
            "convertible layer graph (get_config() yields no 'layers') — "
            "rebuild with the functional/Sequential API, or use "
            "TFNet.from_keras for inference-only import"
            + (f" [{reason}]" if reason is not None else ""))
    zoo_model = convert_keras_architecture(config, class_name)
    copy_keras_weights(zoo_model, kmodel, strict=strict)
    return zoo_model


def is_foreign_keras_model(obj) -> bool:
    """True for live tf.keras / keras objects (vs zoo models) — including
    user SUBCLASSES of keras.Model, whose own ``__module__`` is the user's
    script; anything with a keras class in its MRO is foreign."""
    return any((getattr(c, "__module__", "") or "").startswith(
        ("keras", "tensorflow")) for c in type(obj).__mro__)
