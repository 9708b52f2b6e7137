"""Caffe ``.caffemodel`` weight import (port of
``analytics_zoo_tpu.caffe_import``) — the last of the reference's
``Net.load_*`` loader family (ref net_load.py:88-101, Module.loadCaffeModel).

A ``.caffemodel`` is a protobuf ``NetParameter``; the wire-level walker from
the ONNX codec (onnx/proto.py — no ``caffe``/protobuf package needed) reads
the subset that carries weights:

- ``NetParameter``: layer = field 100 (LayerParameter, new format) or
  layers = field 2 (legacy V1LayerParameter);
- ``LayerParameter``: name=1, type=2, blobs=7;
- ``V1LayerParameter``: name=4, type=5 (enum), blobs=6;
- ``BlobProto``: shape=7 (BlobShape.dim=1), data=5 (packed float), legacy
  num/channels/height/width = 1..4.

Layout conversions mirror the torch importer (caffe is also OIHW /
(out, in)): Convolution -> HWIO kernel, InnerProduct -> transposed kernel.
Caffe splits batch norm across two layers — ``BatchNorm`` (mean, var,
scale_factor) and ``Scale`` (gamma, beta); map BOTH caffe names to the one
zoo BatchNormalization via ``name_map`` and the converter stitches them.

No caffe runtime exists in this image, so tests golden against manual
numpy math over hand-encoded NetParameter bytes (the format is fixed).
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np

from analytics_zoo_tpu_torch.onnx.proto import parse_fields

logger = logging.getLogger("analytics_zoo_tpu_torch")


def _varint_list(payloads) -> list:
    """Decode a repeated varint field that may arrive packed (one
    length-delimited bytes blob of consecutive varints — what caffe's
    ``[packed = true]`` fields produce) or unpacked (individual ints)."""
    from analytics_zoo_tpu_torch.onnx.proto import _read_varint

    out = []
    for item in payloads:
        if isinstance(item, (bytes, bytearray)):
            pos = 0
            while pos < len(item):
                v, pos = _read_varint(item, pos)
                out.append(v)
        else:
            out.append(int(item))
    return out


def _parse_blob(buf: bytes) -> np.ndarray:
    f = parse_fields(buf)
    vals = []
    for item in f.get(5, []):         # repeated float data [packed = true]
        if isinstance(item, (bytes, bytearray)):
            vals.append(np.frombuffer(item, "<f4"))  # packed OR single f32
        else:
            raise ValueError(
                "BlobProto.data arrived as varint — not a float field")
    arr = np.concatenate(vals) if vals else np.zeros(0, np.float32)
    if 7 in f:                        # BlobShape { repeated int64 dim = 1 }
        dims = _varint_list(parse_fields(f[7][0]).get(1, []))
    else:                             # legacy NCHW fields
        dims = [int(f.get(i, [1])[0]) for i in (1, 2, 3, 4)]
        while len(dims) > 1 and dims[0] == 1:
            dims = dims[1:]
    return arr.reshape(dims) if dims else arr


def read_caffemodel(path_or_bytes) -> Dict[str, Dict]:
    """Parse a .caffemodel into {layer_name: {"type": str, "blobs": [...]}}"""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as fh:
            buf = fh.read()
    net = parse_fields(buf)
    out: Dict[str, Dict] = {}
    for raw in net.get(100, []):                      # new-format layers
        f = parse_fields(raw)
        name = f.get(1, [b""])[0].decode()
        ltype = f.get(2, [b""])[0].decode()
        blobs = [_parse_blob(b) for b in f.get(7, [])]
        if blobs:
            out[name] = {"type": ltype, "blobs": blobs}
    for raw in net.get(2, []):                        # legacy V1 layers
        f = parse_fields(raw)
        name = f.get(4, [b""])[0].decode()
        ltype = str(f.get(5, [0])[0])                 # enum code as string
        blobs = [_parse_blob(b) for b in f.get(6, [])]
        if blobs and name not in out:
            out[name] = {"type": ltype, "blobs": blobs}
    return out


def _convert_caffe(layer, entries: List[Dict]):
    """(params, states) for one zoo layer from its caffe blob entries
    (usually one entry; two for the BatchNorm+Scale pair)."""
    cls = type(layer).__name__
    specs = {s.name: tuple(s.shape) for s in layer.weight_specs}

    def check(name, v):
        if tuple(v.shape) != specs[name]:
            raise ValueError(
                f"{layer.name}.{name}: converted shape {v.shape} != "
                f"{specs[name]}")
        return np.ascontiguousarray(v, np.float32)

    blobs = [b for e in entries for b in e["blobs"]]

    if cls in ("Dense", "TimeDistributedDense"):
        w = blobs[0].reshape(blobs[0].shape[-2], blobs[0].shape[-1])
        p = {"kernel": check("kernel", w.T)}
        if "bias" in specs and len(blobs) > 1:
            p["bias"] = check("bias", blobs[1].reshape(-1))
        return p, {}

    if cls in ("Convolution2D", "AtrousConvolution2D"):
        w = blobs[0]                                  # (out, in, kh, kw)
        p = {"kernel": check("kernel", w.transpose(2, 3, 1, 0))}
        if "bias" in specs and len(blobs) > 1:
            p["bias"] = check("bias", blobs[1].reshape(-1))
        return p, {}

    if cls == "BatchNormalization":
        if abs(getattr(layer, "epsilon", 1e-3) - 1e-5) > 1e-12:
            logger.warning(
                "%s: caffe BatchNorm uses eps=1e-5 but this layer has "
                "epsilon=%g — outputs will differ; build with epsilon=1e-5",
                layer.name, layer.epsilon)
        # caffe splits BN: BatchNorm layer blobs = [mean, var, scale_factor]
        # and Scale layer blobs = [gamma] or [gamma, beta] — dispatch on the
        # parsed type, falling back to a blob-shape heuristic for legacy V1
        # files whose type is an enum code
        mean = var = gamma = beta = None
        for e in entries:
            bs = e["blobs"]
            t = e.get("type", "")
            is_bn = t == "BatchNorm" or (t not in ("Scale",)
                                         and len(bs) == 3 and bs[2].size == 1)
            if is_bn and len(bs) >= 2:
                sf = float(bs[2].reshape(-1)[0]) if len(bs) > 2 else 1.0
                sf = sf or 1.0
                mean, var = bs[0].reshape(-1) / sf, bs[1].reshape(-1) / sf
            else:                      # Scale: gamma [, beta]
                gamma = bs[0].reshape(-1)
                beta = (bs[1].reshape(-1) if len(bs) > 1
                        else np.zeros_like(gamma))   # bias_term=false
        if mean is None or gamma is None:
            raise KeyError(
                f"{layer.name}: caffe BN needs both the BatchNorm "
                "(mean/var/factor) and Scale (gamma/beta) layers — map both "
                "caffe names to this layer via name_map")
        return ({"gamma": check("gamma", gamma), "beta": check("beta", beta)},
                {"moving_mean": mean.astype(np.float32),
                 "moving_var": var.astype(np.float32)})

    if cls in ("Embedding", "WordEmbedding"):
        return {"embeddings": check("embeddings", blobs[0])}, {}

    raise NotImplementedError(
        f"no caffe converter for layer type {cls} ('{layer.name}'); convert "
        "the model to ONNX and use Net.load_onnx")


def load_caffe_weights(model, path_or_bytes, name_map: Dict[str, str] = None,
                       strict: bool = True) -> List[str]:
    """Pour a .caffemodel into a built zoo model. ``name_map`` maps caffe
    layer names to zoo layer names (identity by default); map a caffe
    BatchNorm AND its Scale layer to the same zoo layer."""
    from analytics_zoo_tpu_torch.keras_import import apply_weight_imports

    source = read_caffemodel(path_or_bytes)
    by_name = {l.name: l for l in model.layers() if l.weight_specs}
    name_map = name_map or {}

    grouped: Dict[str, List[Dict]] = {}
    for cname, entry in source.items():
        target = name_map.get(cname, cname)
        layer = by_name.get(target)
        if layer is None:
            if strict:
                raise KeyError(
                    f"caffe layer '{cname}' has no zoo layer named "
                    f"'{target}' (layers: {sorted(by_name)}); pass name_map "
                    "or strict=False")
            logger.warning("load_caffe_weights: skipping '%s'", cname)
            continue
        grouped.setdefault(target, []).append(entry)

    pairs = [(by_name[t], entries) for t, entries in grouped.items()]
    return apply_weight_imports(model, pairs, _convert_caffe, strict=strict,
                                kind="load_caffe_weights")
