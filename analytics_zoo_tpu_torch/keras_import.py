"""Keras-HDF5 weight import (port of ``analytics_zoo_tpu.keras_import``):
pour pretrained Keras weights into zoo models.

Ref: ``Net.load_keras(json_path, hdf5_path)`` (net_load.py:103-118) — the
reference parses Keras-1.2.2 model files into its module graph so published
pretrained backbones can seed transfer learning (``new_graph`` /
``freeze_up_to``). Here the architectures come from the zoo catalog (or any
hand-built Model) and this module maps an HDF5 *weight* file onto them:
layer-name matching (or positional), with per-layer-type layout converters
between Keras conventions and ours.

Supports both HDF5 layouts in the wild:
- classic Keras 1/2 ``save_weights``: root (or ``model_weights/``) group
  with ``layer_names`` attr, per-layer ``weight_names`` attrs;
- Keras 3 ``.weights.h5``: nested ``layers/<name>/vars/<i>`` datasets.

``h5py`` is required only at call time. Weight mapping covers the layer
types the model-zoo catalog uses: Dense, Conv1D/2D, SeparableConv2D,
BatchNorm (incl. moving stats → model state), Embedding, LSTM (i,f,c,o gate
order matches), GRU (both layouts: keras-1 reset_after=False and the
tf.keras-default reset_after=True — build the zoo GRU with the matching
flag), SimpleRNN, PReLU.
Anything else falls back to exact-shape
assignment and otherwise raises (or skips with ``strict=False``).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger("analytics_zoo_tpu_torch")


def _read_classic(g) -> Dict[str, Dict[str, np.ndarray]]:
    """Keras 1/2 layout: layer_names / weight_names attrs."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    layer_names = [n.decode() if isinstance(n, bytes) else str(n)
                   for n in g.attrs["layer_names"]]
    for lname in layer_names:
        grp = g[lname]
        weights = {}
        for wn in grp.attrs.get("weight_names", []):
            wn = wn.decode() if isinstance(wn, bytes) else str(wn)
            # "dense_1/kernel:0" -> "kernel"
            short = wn.split("/")[-1].split(":")[0]
            weights[short] = np.asarray(grp[wn])
        if weights:
            out[lname] = weights
    return out


# Keras 3 drops variable names; positions are canonical per layer type.
_KERAS3_VAR_NAMES = {
    "dense": ["kernel", "bias"],
    "conv1d": ["kernel", "bias"],
    "conv2d": ["kernel", "bias"],
    "conv3d": ["kernel", "bias"],
    "depthwise_conv2d": ["depthwise_kernel", "bias"],
    "separable_conv2d": ["depthwise_kernel", "pointwise_kernel", "bias"],
    "batch_normalization": ["gamma", "beta", "moving_mean",
                            "moving_variance"],
    "embedding": ["embeddings"],
    "lstm": ["kernel", "recurrent_kernel", "bias"],
    "gru": ["kernel", "recurrent_kernel", "bias"],
    "simple_rnn": ["kernel", "recurrent_kernel", "bias"],
    "p_re_lu": ["alpha"],
}


def _read_keras3(g) -> Dict[str, Dict[str, np.ndarray]]:
    """Keras 3 ``.weights.h5``: ``layers/<type>[_<n>]/[cell/]vars/<i>``, with
    the user-facing layer name in the vars group's ``name`` attr. Variable
    names are not stored; they are re-derived positionally per layer type
    (falling back to ``var<i>`` + shape matching)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    layers = g["layers"] if "layers" in g \
        else g["_layer_checkpoint_dependencies"]
    for key in layers:
        grp = layers[key]
        vars_grp, name_grp = None, None
        if "vars" in grp:
            name_grp = grp["vars"]          # carries the user layer name,
            if len(grp["vars"]):            # even when weights live in cell/
                vars_grp = grp["vars"]
        if vars_grp is None and "cell" in grp and "vars" in grp["cell"]:
            vars_grp = grp["cell"]["vars"]
        if vars_grp is None:
            continue
        lname = (name_grp if name_grp is not None else vars_grp) \
            .attrs.get("name", key)
        if isinstance(lname, bytes):
            lname = lname.decode()
        type_key = key.rstrip("0123456789").rstrip("_")
        names = _KERAS3_VAR_NAMES.get(type_key, [])
        weights = {}
        for i, k in enumerate(sorted(vars_grp, key=int)):
            name = names[i] if i < len(names) else f"var{i}"
            weights[name] = np.asarray(vars_grp[k])
        if weights:
            out[str(lname)] = weights
    return out


def _read_hdf5(path: str):
    """Returns ({layer_name: {weight_name: array}}, model_ordered) —
    model_ordered is False for the Keras-3 layout, whose HDF5 group
    iteration is alphabetical, not model layer order."""
    import h5py

    with h5py.File(path, "r") as f:
        g = f["model_weights"] if "model_weights" in f else f
        if "layer_names" in g.attrs:
            return _read_classic(g), True
        if "layers" in g or "_layer_checkpoint_dependencies" in g:
            return _read_keras3(g), False
        raise ValueError(
            f"{path}: unrecognized Keras HDF5 layout (no layer_names attr, "
            "no layers/ group)")


def read_keras_hdf5(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Parse an HDF5 weight file into {layer_name: {weight_name: array}}."""
    return _read_hdf5(path)[0]


# ---------------------------------------------------------------------------
# Per-layer-type converters: keras weight dict -> (params, states)
# ---------------------------------------------------------------------------


def _convert(layer, weights: Dict[str, np.ndarray]):
    """Returns (params_update, state_update) for one zoo layer."""
    cls = type(layer).__name__
    specs = {s.name: tuple(s.shape) for s in layer.weight_specs}
    used: set = set()   # ids of source arrays already bound — a shape
    # fallback must never hand the same array to two targets (e.g. LSTM
    # kernel/recurrent_kernel both (u, 4u) when input_dim == units)

    def _by_shape(shape):
        for k, v in weights.items():
            if id(v) not in used and tuple(v.shape) == tuple(shape):
                return v
        return None

    def named(keras_name, ours, transform=None):
        v = weights.get(keras_name)
        if v is None:
            v = _by_shape(specs[ours]) if transform is None else None
        if v is None:
            raise KeyError(f"{layer.name}: missing '{keras_name}' "
                           f"(have {sorted(weights)})")
        used.add(id(v))
        v = np.asarray(v)
        if transform:
            v = transform(v)
        if tuple(v.shape) != specs[ours]:
            raise ValueError(
                f"{layer.name}.{ours}: shape {v.shape} != {specs[ours]}")
        return v

    if cls in ("Dense", "TimeDistributedDense"):
        p = {"kernel": named("kernel", "kernel")}
        if "bias" in specs:
            p["bias"] = named("bias", "bias")
        return p, {}

    if cls in ("Convolution2D", "Convolution1D", "Convolution3D",
               "AtrousConvolution2D", "AtrousConvolution1D"):
        p = {"kernel": named("kernel", "kernel")}
        if "bias" in specs:
            p["bias"] = named("bias", "bias")
        return p, {}

    if cls == "DepthwiseConvolution2D":
        dw = weights.get("depthwise_kernel", weights.get("kernel"))
        if dw is None or np.asarray(dw).ndim != 4:
            raise KeyError(f"{layer.name}: missing depthwise_kernel")
        dw = np.asarray(dw)
        h, w, c, m = dw.shape
        # validate the SOURCE (h,w,c,m) against the layer's in_ch/multiplier
        # — the flat (h,w,1,c*m) spec alone can't distinguish c=8,m=1 from
        # c=4,m=2, and a grouping mismatch scrambles channels silently
        want = (layer.kernel_size[0], layer.kernel_size[1], layer.in_ch,
                layer.depth_multiplier)
        if (h, w, c, m) != want:
            raise ValueError(
                f"{layer.name}.depthwise: source (h,w,c,m)={dw.shape} != "
                f"layer {want}")
        p = {"depthwise": dw.reshape(h, w, 1, c * m)}
        if "bias" in specs:
            p["bias"] = named("bias", "bias")
        return p, {}

    if cls == "SeparableConvolution2D":
        dw = weights.get("depthwise_kernel")
        if dw is None or np.asarray(dw).ndim != 4:
            raise KeyError(f"{layer.name}: missing depthwise_kernel")
        dw = np.asarray(dw)
        h, w, c, m = dw.shape
        p = {"depthwise": dw.reshape(h, w, 1, c * m),
             "pointwise": named("pointwise_kernel", "pointwise")}
        if "bias" in specs:
            p["bias"] = named("bias", "bias")
        return p, {}

    if cls == "BatchNormalization":
        # All four arrays share shape (C,), so shape fallback is ambiguous —
        # match strictly by name/suffix across the layouts in the wild:
        # short names (gamma/moving_mean), Keras-1 prefixed names
        # (batchnormalization_1_running_mean; running_std holds the
        # VARIANCE in Keras 1 despite its name), and the Keras-3 renamed-
        # layer positional fallback (var0..var3 = gamma,beta,mean,var).
        matched = set()

        def suffix(*cands):
            for key in weights:
                for c in cands:
                    if key == c or key.endswith("_" + c) or key.endswith(c):
                        matched.add(key)
                        return np.asarray(weights[key])
            return None

        gamma = suffix("gamma")
        beta = suffix("beta")
        mean = suffix("moving_mean", "running_mean")
        var = suffix("moving_variance", "running_var", "running_variance",
                     "running_std")
        if gamma is None and sorted(weights) == ["var0", "var1", "var2",
                                                 "var3"]:
            gamma, beta = weights["var0"], weights["var1"]
            mean, var = weights["var2"], weights["var3"]
            matched.update(weights)
        # keras BN(scale=False) stores no gamma (fixed 1); BN(center=False)
        # stores no beta (fixed 0) — synthesize the constant, but ONLY when
        # every source array was identified: fabricating affine params while
        # unrecognized arrays remain would silently drop a real scale/offset
        ref_arr = next((a for a in (gamma, beta, mean, var)
                        if a is not None), None)
        if ref_arr is not None and len(matched) == len(weights):
            if gamma is None:
                gamma = np.ones_like(np.asarray(ref_arr))
            if beta is None:
                beta = np.zeros_like(np.asarray(ref_arr))
        if gamma is None or beta is None:
            raise KeyError(f"{layer.name}: cannot identify gamma/beta in "
                           f"{sorted(weights)}")
        if (mean is None) != (var is None):
            raise KeyError(f"{layer.name}: found only one of moving mean/"
                           f"variance in {sorted(weights)}")
        if mean is None and len(weights) > 2:
            # stats are present under an unrecognized name: refusing beats
            # silently serving with init stats (mean 0, var 1)
            raise KeyError(f"{layer.name}: BN stats not identified in "
                           f"{sorted(weights)}")
        p = {"gamma": np.asarray(gamma), "beta": np.asarray(beta)}
        s = {}
        if mean is not None:
            s["moving_mean"] = np.asarray(mean)
            s["moving_var"] = np.asarray(var)
        return p, s

    if cls in ("Embedding", "WordEmbedding"):
        key = "embeddings" if "embeddings" in weights else \
            next(iter(weights))
        return {"embeddings": named(key, "embeddings")}, {}

    if cls == "LSTM":
        # keras gate order i,f,c,o == ours (recurrent.py LSTM docstring)
        return {"W": named("kernel", "W"),
                "U": named("recurrent_kernel", "U"),
                "b": named("bias", "b")}, {}

    if cls == "SimpleRNN":
        return {"W": named("kernel", "W"),
                "U": named("recurrent_kernel", "U"),
                "b": named("bias", "b")}, {}

    if cls == "GRU":
        # Keras-1 GRU == tf.keras GRU(reset_after=False): gate order z,r,h,
        # recurrent kernel (u, 3u) splitting into U=[z,r] and U_h, one 1-D
        # bias. reset_after=True (the tf.keras default) keeps separate
        # input/recurrent biases (bias shape (2, 3u)) and applies the reset
        # gate after the recurrent matmul — build the zoo layer with
        # GRU(reset_after=True) to import that layout.
        # bind W first so the shape fallback (Keras-3 renamed vars: var0=
        # kernel, var1=recurrent_kernel, var2=bias in creation order) cannot
        # hand the recurrent kernel to W when input_dim == units
        W = named("kernel", "W")
        u = specs["U"][0]
        rk_src = weights.get("recurrent_kernel")
        if rk_src is None:
            rk_src = _by_shape((u, 3 * u))
        b_src = weights.get("bias")
        if b_src is None:
            b_src = (_by_shape((2, 3 * u))
                     if getattr(layer, "reset_after", False)
                     else _by_shape(specs["b"]))
        if getattr(layer, "reset_after", False):
            if (rk_src is None or b_src is None
                    or tuple(np.asarray(b_src).shape) != (2, 3 * u)
                    or tuple(np.asarray(rk_src).shape) != (u, 3 * u)):
                raise NotImplementedError(
                    f"{layer.name}: GRU(reset_after=True) import needs the "
                    "tf.keras-default layout (recurrent kernel (u, 3u), "
                    "bias (2, 3u))")
            used.add(id(rk_src))
            used.add(id(b_src))
            b2 = np.asarray(b_src)
            return {"W": W, "U": np.asarray(rk_src),
                    "b": np.ascontiguousarray(b2[0]),
                    "b_rec": np.ascontiguousarray(b2[1])}, {}
        if (rk_src is None or b_src is None
                or np.asarray(b_src).ndim != 1
                or tuple(np.asarray(rk_src).shape) != (u, 3 * u)):
            raise NotImplementedError(
                f"{layer.name}: GRU import needs the reset_after=False "
                "layout (recurrent kernel (u, 3u), 1-D bias); build the zoo "
                "GRU with reset_after=True for the tf.keras-default layout")
        used.add(id(rk_src))
        used.add(id(b_src))
        rk = np.asarray(rk_src)
        return {"W": W,
                "U": np.ascontiguousarray(rk[:, :2 * u]),
                "U_h": np.ascontiguousarray(rk[:, 2 * u:]),
                "b": np.asarray(b_src)}, {}

    if cls == "PReLU":
        return {"alpha": named("alpha", "alpha")}, {}

    # generic fallback: match every weight spec by exact shape (each source
    # array consumed at most once via `used`)
    p = {}
    for name, shape in specs.items():
        v = _by_shape(shape)
        if v is None:
            raise NotImplementedError(
                f"no converter for layer type {cls} ('{layer.name}') and "
                f"no exact-shape match for '{name}' {shape}")
        used.add(id(v))
        p[name] = np.asarray(v)
    return p, {}


def apply_weight_imports(model, pairs, convert_fn, strict: bool = True,
                         kind: str = "import"):
    """Shared tail of every weight importer: convert each (layer, weights)
    pair, accumulate, install via set_weights/set_states. Skips (warning)
    or raises per ``strict`` on conversion failures. Returns imported layer
    names."""
    params_update, states_update, imported = {}, {}, []
    for layer, weights in pairs:
        try:
            p, s = convert_fn(layer, weights)
        except (KeyError, ValueError, NotImplementedError):
            if strict:
                raise
            logger.warning("%s: skipping '%s' (no conversion)", kind,
                           layer.name)
            continue
        params_update[layer.name] = p
        if s:
            states_update[layer.name] = s
        imported.append(layer.name)

    model.set_weights(params_update)
    if states_update:
        model.set_states(states_update)
    logger.info("%s: imported %d layer(s)", kind, len(imported))
    return imported


def load_keras_weights(model, path: str, by_name: bool = True,
                       strict: bool = True):
    """Pour an HDF5 Keras weight file into a built zoo model.

    ``by_name=True`` matches source layers to zoo layers by layer name
    (rename your zoo layers to the published names — the reference's
    convention too); ``by_name=False`` zips weighted layers positionally.
    With ``strict=False``, unmatched/unconvertible layers are skipped with a
    warning instead of raising — the transfer-learning case where only the
    backbone overlaps. Returns the list of layer names imported.
    """
    source, model_ordered = _read_hdf5(path)
    target_layers = [l for l in model.layers() if l.weight_specs]
    if not by_name and not model_ordered:
        raise ValueError(
            "positional import (by_name=False) is unsafe for the Keras-3 "
            ".weights.h5 layout: HDF5 iterates layer groups alphabetically, "
            "not in model order. Name your layers and use by_name=True.")

    pairs: List[Tuple[object, Dict[str, np.ndarray]]] = []
    if by_name:
        by = {l.name: l for l in target_layers}
        for lname, weights in source.items():
            if lname in by:
                pairs.append((by[lname], weights))
            elif strict:
                raise KeyError(
                    f"source layer '{lname}' has no zoo layer with that "
                    f"name (zoo layers: {sorted(by)}); use by_name=False "
                    "for positional matching or strict=False to skip")
            else:
                logger.warning("load_keras_weights: skipping '%s' (no "
                               "matching layer)", lname)
    else:
        src_items = list(source.items())
        if strict and len(src_items) != len(target_layers):
            raise ValueError(
                f"positional import: {len(src_items)} source layers vs "
                f"{len(target_layers)} weighted zoo layers")
        for (lname, weights), layer in zip(src_items, target_layers):
            pairs.append((layer, weights))

    return apply_weight_imports(model, pairs, _convert, strict=strict,
                                kind="load_keras_weights")
