"""Torch state-dict weight import (port of ``analytics_zoo_tpu.torch_import``):
pour pretrained torch weights into zoo models.

Ref: ``Net.load_torch`` (net_load.py:120-135) — the reference embeds a
torch runtime to run saved torch models. Here the architecture comes from
the zoo (or a hand-built Model) and this module maps a ``state_dict``
checkpoint onto it, converting torch layouts to ours:

- ``nn.Linear``: weight (out, in) -> kernel (in, out) [transpose];
- ``nn.Conv1d/2d``: weight (out, in, k...) -> kernel (k..., in, out);
- depthwise ``nn.Conv2d(groups=C)``: (C*M, 1, kh, kw) -> (kh, kw, 1, C*M)
  (torch's group-major output-channel order == our flattening);
- ``nn.BatchNorm``: weight/bias -> gamma/beta, running stats -> model state;
- ``nn.Embedding``: weight as-is;
- ``nn.LSTM`` (single layer, unidirectional): weight_ih/hh -> W/U
  transposed, the two torch biases summed (zeros when torch ran bias-free
  — our init's forget-gate 1.0 must not leak in); torch gate order
  i,f,g,o == ours.

Default-hyperparameter traps (the converter warns): torch LSTM gates use
sigmoid while the zoo LSTM defaults to Keras-1 hard_sigmoid — build with
``inner_activation="sigmoid"``; torch BatchNorm eps is 1e-5 vs the zoo
default 1e-3 — build with ``epsilon=1e-5``.

A state dict may come from a module living on the card, or in bf16: every
tensor is read through ``.detach().cpu()`` and made float32, the JAX
package's dtype rule. Full-module exports (TorchScript) should go through
ONNX instead (torch.onnx.export on a machine with the onnx package, then
``Net.load_onnx``).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

import numpy as np
import torch

logger = logging.getLogger("analytics_zoo_tpu_torch")


def read_torch_state_dict(path_or_sd) -> Dict[str, Dict[str, np.ndarray]]:
    """Load a torch checkpoint and group tensors by module prefix:
    {"features.3": {"weight": ..., "bias": ...}, ...}. Accepts a path or an
    in-memory state dict / {"state_dict": ...} checkpoint wrapper."""
    if isinstance(path_or_sd, (str, bytes)):
        sd = torch.load(path_or_sd, map_location="cpu", weights_only=True)
    else:
        sd = path_or_sd
    if isinstance(sd, dict) and "state_dict" in sd and all(
            not hasattr(v, "numpy") for k, v in sd.items()
            if k != "state_dict"):
        sd = sd["state_dict"]

    grouped: Dict[str, Dict[str, np.ndarray]] = {}
    for full_name, tensor in sd.items():
        if "." in full_name:
            prefix, short = full_name.rsplit(".", 1)
        else:
            prefix, short = "", full_name
        if hasattr(tensor, "detach"):
            # covers bf16 checkpoints and tensors living on the card
            arr = tensor.detach().cpu().float().numpy()
        else:
            arr = np.asarray(tensor)
        grouped.setdefault(prefix, {})[short] = arr
    return grouped


def _convert_torch(layer, weights: Dict[str, np.ndarray]):
    """(params_update, state_update) for one zoo layer from torch tensors."""
    cls = type(layer).__name__
    specs = {s.name: tuple(s.shape) for s in layer.weight_specs}

    def check(name, v):
        if tuple(v.shape) != specs[name]:
            raise ValueError(
                f"{layer.name}.{name}: converted shape {v.shape} != "
                f"{specs[name]}")
        return np.ascontiguousarray(v, np.float32)

    def maybe_bias(p, key="bias"):
        # a torch bias with nowhere to go must not vanish silently
        if key in weights and key not in specs:
            raise ValueError(
                f"{layer.name}: torch checkpoint has a '{key}' but the zoo "
                "layer was built with bias=False")
        if key in specs and key in weights:
            p[key] = check("bias", weights[key])
        return p

    if cls in ("Dense", "TimeDistributedDense"):
        return maybe_bias({"kernel": check("kernel", weights["weight"].T)}), {}

    if cls in ("Convolution2D", "AtrousConvolution2D"):
        w = weights["weight"]                      # (out, in, kh, kw)
        return maybe_bias(
            {"kernel": check("kernel", w.transpose(2, 3, 1, 0))}), {}

    if cls in ("Convolution1D", "AtrousConvolution1D"):
        w = weights["weight"]                      # (out, in, k)
        return maybe_bias(
            {"kernel": check("kernel", w.transpose(2, 1, 0))}), {}

    if cls == "DepthwiseConvolution2D":
        w = weights["weight"]                      # (C*M, 1, kh, kw)
        return maybe_bias(
            {"depthwise": check("depthwise", w.transpose(2, 3, 1, 0))}), {}

    if cls == "BatchNormalization":
        if abs(getattr(layer, "epsilon", 1e-3) - 1e-5) > 1e-12:
            logger.warning(
                "%s: torch BatchNorm uses eps=1e-5 but this layer has "
                "epsilon=%g — outputs will differ; build with epsilon=1e-5",
                layer.name, layer.epsilon)
        p = {"gamma": check("gamma", weights["weight"]),
             "beta": check("beta", weights["bias"])}
        s = {}
        if "running_mean" in weights:
            s["moving_mean"] = np.asarray(weights["running_mean"], np.float32)
            s["moving_var"] = np.asarray(weights["running_var"], np.float32)
        return p, s

    if cls in ("Embedding", "WordEmbedding"):
        return {"embeddings": check("embeddings", weights["weight"])}, {}

    if cls == "LSTM":
        # torch gate order i,f,g,o == ours (i,f,c,o); two biases sum
        extra = [k for k in weights
                 if not k.endswith("_l0") or "reverse" in k]
        if extra:
            raise NotImplementedError(
                f"{layer.name}: only single-layer unidirectional torch "
                f"LSTMs import (found {sorted(extra)}); split multi-layer "
                "stacks into one zoo LSTM per torch layer")
        from analytics_zoo_tpu_torch.keras.layers.core import _ACTIVATIONS

        if layer.inner_activation is not _ACTIVATIONS.get("sigmoid"):
            logger.warning(
                "%s: torch LSTM gates use sigmoid but this layer's "
                "inner_activation differs (zoo default is Keras-1 "
                "hard_sigmoid) — build with inner_activation='sigmoid'",
                layer.name)
        w = {"W": check("W", weights["weight_ih_l0"].T),
             "U": check("U", weights["weight_hh_l0"].T)}
        if "bias_ih_l0" in weights:
            w["b"] = check("b", weights["bias_ih_l0"] + weights["bias_hh_l0"])
        else:
            # torch ran bias-free; our init sets forget-gate bias 1.0 and
            # set_weights merges per-weight, so it would leak through
            w["b"] = np.zeros(specs["b"], np.float32)
        return w, {}

    raise NotImplementedError(
        f"no torch converter for layer type {cls} ('{layer.name}'); "
        "export the torch model to ONNX and use Net.load_onnx")


def load_torch_weights(model, path_or_sd, name_map: Dict[str, str] = None,
                       strict: bool = True) -> List[str]:
    """Pour a torch ``state_dict`` into a built zoo model.

    Matching: torch module prefixes -> zoo layer names, identity by default
    or through ``name_map`` ({torch_prefix: zoo_layer_name}). With
    ``strict=False`` unmatched/unconvertible prefixes are skipped with a
    warning (partial-backbone transfer). Returns imported layer names.
    """
    from analytics_zoo_tpu_torch.keras_import import apply_weight_imports

    source = read_torch_state_dict(path_or_sd)
    by_name = {l.name: l for l in model.layers() if l.weight_specs}
    name_map = name_map or {}

    pairs = []
    for prefix, weights in source.items():
        target = name_map.get(prefix, prefix)
        layer = by_name.get(target)
        if layer is None:
            if strict:
                raise KeyError(
                    f"torch module '{prefix}' has no zoo layer named "
                    f"'{target}' (layers: {sorted(by_name)}); pass name_map "
                    "or strict=False")
            logger.warning("load_torch_weights: skipping '%s'", prefix)
            continue
        pairs.append((layer, weights))
    return apply_weight_imports(model, pairs, _convert_torch, strict=strict,
                                kind="load_torch_weights")
